// What the two demapping kernels share: K4 (demap_planes.cu, weights
// apply + demap into the decoder's bit-planes) and K5 (demap_llrs.cu, the
// float path's demap into the codeword-order LLR stream).
//
// * Pam<M>: the PAM levels and Gray labels of one axis of a square QAM, as
//   compile-time tables, so every min tree unrolls into a fixed sequence
//   of fminf.
// * axis_llrs<M>: one axis's closed-form max-log LLRs (m1 - m0 per bit
//   label) and its squared distance to the nearest level.
// * GoldBits<NB>: NB bytes of the Gold sequence (or any byte stream),
//   packed four to a word, loaded with the widest aligned vector; and
//   store_bytes<NB>, its store of NB packed bytes.
// * load_lanes / store_lanes: L consecutive floats as one vector where L
//   allows.
//
// Numerics: every subtraction and square is rounded on its own (the
// libraries are built with --fmad=false), and fminf over non-negative
// squares is exact and does not depend on the order.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace demap {

// Per square QAM of 2M bits a symbol: the PAM levels of one axis, ascending,
// and their Gray labels (bit t of a label is axis bit t), exactly as float32
// values of ops/modulation/mapper.pam_levels.  Keep each table on its line:
// tests/test_torch_demap_planes.py parses them and compares them with
// pam_levels.
template <int M>
struct Pam;
template <>
struct Pam<1> {  // QPSK
  __device__ static float level(int k) {
    constexpr float kLevels[2] = {-0.707106769f, 0.707106769f};
    return kLevels[k];
  }
  __device__ static int label(int k) {
    constexpr int kLabels[2] = {1, 0};
    return kLabels[k];
  }
};
template <>
struct Pam<2> {  // 16QAM
  __device__ static float level(int k) {
    constexpr float kLevels[4] = {-0.948683321f, -0.316227764f, 0.316227764f, 0.948683321f};
    return kLevels[k];
  }
  __device__ static int label(int k) {
    constexpr int kLabels[4] = {3, 1, 0, 2};
    return kLabels[k];
  }
};
template <>
struct Pam<3> {  // 64QAM
  __device__ static float level(int k) {
    constexpr float kLevels[8] = {-1.08012342f, -0.77151674f, -0.462910056f, -0.154303357f, 0.154303357f, 0.462910056f, 0.77151674f, 1.08012342f};
    return kLevels[k];
  }
  __device__ static int label(int k) {
    constexpr int kLabels[8] = {7, 3, 1, 5, 4, 0, 2, 6};
    return kLabels[k];
  }
};
template <>
struct Pam<4> {  // 256QAM
  __device__ static float level(int k) {
    constexpr float kLevels[16] = {-1.15044749f, -0.997054458f, -0.843661487f, -0.690268517f, -0.536875486f, -0.383482486f, -0.230089501f, -0.0766965002f, 0.0766965002f, 0.230089501f, 0.383482486f, 0.536875486f, 0.690268517f, 0.843661487f, 0.997054458f, 1.15044749f};
    return kLevels[k];
  }
  __device__ static int label(int k) {
    constexpr int kLabels[16] = {15, 7, 3, 11, 9, 1, 5, 13, 12, 4, 0, 8, 10, 2, 6, 14};
    return kLabels[k];
  }
};

// Per-axis LLRs (m1 - m0 per bit label) of v into out; returns the squared
// distance to the nearest level.
template <int M>
__device__ __forceinline__ float axis_llrs(float v, float* out) {
  constexpr int kLevels = 1 << M;
  float d2[kLevels], dmin = 0.0f;
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const float t = __fsub_rn(v, Pam<M>::level(k));
    d2[k] = __fmul_rn(t, t);
  }
#pragma unroll
  for (int t = 0; t < M; ++t) {
    float m0 = 0.0f, m1 = 0.0f;
    bool have0 = false, have1 = false;  // resolved at compile time
#pragma unroll
    for (int k = 0; k < kLevels; ++k) {
      if ((Pam<M>::label(k) >> t) & 1) {
        m1 = have1 ? fminf(m1, d2[k]) : d2[k];
        have1 = true;
      } else {
        m0 = have0 ? fminf(m0, d2[k]) : d2[k];
        have0 = true;
      }
    }
    out[t] = __fsub_rn(m1, m0);
    // Bit 0's two trees cover every level between them: their smaller
    // minimum is the nearest level's distance, exactly (min is exact).
    if (t == 0) dmin = fminf(m0, m1);
  }
  return dmin;
}

// The widest vector (bytes) that NB consecutive bytes at a multiple of NB
// allow; NB is always even (qm is).
template <int NB>
constexpr int kByteVec = NB % 16 == 0 ? 16 : NB % 8 == 0 ? 8 : NB % 4 == 0 ? 4 : 2;

// NB bytes, packed four to a word, loaded with the widest aligned vector.
template <int NB>
struct GoldBits {
  static constexpr int kVec = kByteVec<NB>;
  uint32_t word[(NB + 3) / 4];

  __device__ __forceinline__ explicit GoldBits(const uint8_t* c) {
    if constexpr (kVec == 16) {
#pragma unroll
      for (int i = 0; i < NB / 16; ++i) {
        const uint4 v = reinterpret_cast<const uint4*>(c)[i];
        word[4 * i] = v.x;
        word[4 * i + 1] = v.y;
        word[4 * i + 2] = v.z;
        word[4 * i + 3] = v.w;
      }
    } else if constexpr (kVec == 8) {
#pragma unroll
      for (int i = 0; i < NB / 8; ++i) {
        const uint2 v = reinterpret_cast<const uint2*>(c)[i];
        word[2 * i] = v.x;
        word[2 * i + 1] = v.y;
      }
    } else if constexpr (kVec == 4) {
#pragma unroll
      for (int i = 0; i < NB / 4; ++i) word[i] = reinterpret_cast<const uint32_t*>(c)[i];
    } else {
#pragma unroll
      for (int i = 0; i < (NB + 3) / 4; ++i) word[i] = 0;
#pragma unroll
      for (int i = 0; i < NB / 2; ++i) {
        const uint32_t v = reinterpret_cast<const uint16_t*>(c)[i];
        word[i / 2] |= v << (16 * (i % 2));
      }
    }
  }

  __device__ __forceinline__ bool operator()(int k) const {
    return (word[k / 4] >> (8 * (k % 4))) & 1u;
  }
};

// NB bytes packed four to a word (byte k in word k / 4 at bit 8 (k % 4)),
// stored with the same vectors GoldBits<NB> loads.
template <int NB>
__device__ __forceinline__ void store_bytes(uint8_t* dst, const uint32_t* word) {
  constexpr int kVec = kByteVec<NB>;
  if constexpr (kVec == 16) {
#pragma unroll
    for (int i = 0; i < NB / 16; ++i) {
      reinterpret_cast<uint4*>(dst)[i] =
          make_uint4(word[4 * i], word[4 * i + 1], word[4 * i + 2], word[4 * i + 3]);
    }
  } else if constexpr (kVec == 8) {
#pragma unroll
    for (int i = 0; i < NB / 8; ++i) {
      reinterpret_cast<uint2*>(dst)[i] = make_uint2(word[2 * i], word[2 * i + 1]);
    }
  } else if constexpr (kVec == 4) {
#pragma unroll
    for (int i = 0; i < NB / 4; ++i) reinterpret_cast<uint32_t*>(dst)[i] = word[i];
  } else {
#pragma unroll
    for (int i = 0; i < NB / 2; ++i) {
      reinterpret_cast<uint16_t*>(dst)[i] =
          static_cast<uint16_t>(word[i / 2] >> (16 * (i % 2)));
    }
  }
}

// L consecutive floats, as one vector where L allows.
template <int L>
__device__ __forceinline__ void load_lanes(const float* src, float* v) {
  if constexpr (L == 4) {
    const float4 x = *reinterpret_cast<const float4*>(src);
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else if constexpr (L == 2) {
    const float2 x = *reinterpret_cast<const float2*>(src);
    v[0] = x.x, v[1] = x.y;
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) v[l] = src[l];
  }
}

template <int L>
__device__ __forceinline__ void store_lanes(float* dst, const float* v) {
  if constexpr (L == 4) {
    *reinterpret_cast<float4*>(dst) = make_float4(v[0], v[1], v[2], v[3]);
  } else if constexpr (L == 2) {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0], v[1]);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) dst[l] = v[l];
  }
}

}  // namespace demap
