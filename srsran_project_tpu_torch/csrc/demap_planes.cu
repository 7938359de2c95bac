// K4: MMSE apply + closed-form max-log demap + int8 quantize + descramble,
// written straight into the LDPC decoder's de-interleave bit-planes.
//
// Replaces the TPU kernel demap_planes_pallas
// (srsran_project_tpu/ops/demap_pallas.py).  Plain torch version and
// wrapper: srsran_project_tpu_torch/ops/demap_planes.py (demap_planes).
//
// Design.  One thread per lane (slot b, data symbol s, subcarrier n,
// layer l).  The thread forms x = sum_p w[b, n, l, p] y[b, p, s, n] with
// the P-port complex multiply-adds in registers, evaluates per axis the
// squared distances to the 2^m PAM levels and the min trees per bit label,
// and writes each LLR, quantized (round half to even, clip +-120) and
// multiplied by its +-1 descrambling sign, to plane bit at position
// (s*nsc + n)*L + l, which is its de-interleave plane index.  It also
// writes the lane's squared distance to the nearest constellation point,
// from which the caller forms the decision-directed post-equalization
// SINR.  The TPU kernel's lane expansion (y repeated L times, re/im split
// into planes) was a Mosaic layout workaround and is left out: neighbouring
// threads read neighbouring layers of one subcarrier's weights and share
// one y value through L1.
//
// What bounds it: memory.  Per lane it reads 8P + 4 + 4 qm bytes (y once
// per L lanes) and writes qm + 4; the arithmetic is some hundred float
// operations, far below the card's rate.
//
// Numerics (bit-exact with the plain version): every multiply and add is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, and the library is
// built with --fmad=false), in the plain version's order; 1/eq_nvar is an
// IEEE division; rintf rounds half to even as torch.round does.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr float kLlrMax = 120.0f;

struct Args {
  const float2* y;        // (B, P, nsym, nsc) complex64
  const float2* w;        // (B, nsc, L, P) complex64
  const float* eq_nvar;   // (B, nsc, L)
  const float* signs;     // (B, qm, nsym * nsc * L)
  const float* levels;    // (2^m,) PAM levels, ascending
  const int* labels;      // (2^m,) bit labels, bit t of label = axis bit t
  int batch, p, nsym, nsc, l, qm;
  float scale;            // LLR_MAX / range_limit
  int8_t* planes;         // (B, qm, nsym * nsc * L)
  float* err2;            // (B, nsym, nsc * L)
};

template <int M>
__device__ inline float axis_llrs(float v, const float* lv, const int* lab, float* out) {
  constexpr int kLevels = 1 << M;
  float d2[kLevels];
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    const float t = __fsub_rn(v, lv[k]);
    d2[k] = __fmul_rn(t, t);
  }
#pragma unroll
  for (int t = 0; t < M; ++t) {
    float m0 = 0.0f, m1 = 0.0f;
    bool have0 = false, have1 = false;
#pragma unroll
    for (int k = 0; k < kLevels; ++k) {
      if ((lab[k] >> t) & 1) {
        m1 = have1 ? fminf(m1, d2[k]) : d2[k];
        have1 = true;
      } else {
        m0 = have0 ? fminf(m0, d2[k]) : d2[k];
        have0 = true;
      }
    }
    out[t] = __fsub_rn(m1, m0);
  }
  float dmin = d2[0];
#pragma unroll
  for (int k = 1; k < kLevels; ++k) dmin = fminf(dmin, d2[k]);
  return dmin;
}

template <int M>
__global__ void demap_planes_kernel(Args a) {
  constexpr int kLevels = 1 << M;
  const long long width = static_cast<long long>(a.nsc) * a.l;  // lanes per symbol
  const long long per_slot = a.nsym * width;
  const long long lane = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (lane >= a.batch * per_slot) return;
  const int b = static_cast<int>(lane / per_slot);
  const long long pos = lane % per_slot;  // (s*nsc + n)*L + l
  const int s = static_cast<int>(pos / width);
  const int n = static_cast<int>((pos % width) / a.l);
  const int l = static_cast<int>(pos % a.l);

  float lv[kLevels];
  int lab[kLevels];
#pragma unroll
  for (int k = 0; k < kLevels; ++k) {
    lv[k] = a.levels[k];
    lab[k] = a.labels[k];
  }

  const float2* wl = a.w + ((static_cast<long long>(b) * a.nsc + n) * a.l + l) * a.p;
  const float2* yb = a.y + static_cast<long long>(b) * a.p * a.nsym * a.nsc +
                     static_cast<long long>(s) * a.nsc + n;
  const long long y_port = static_cast<long long>(a.nsym) * a.nsc;
  float2 wv = wl[0];
  float2 yv = yb[0];
  float xr = __fsub_rn(__fmul_rn(wv.x, yv.x), __fmul_rn(wv.y, yv.y));
  float xi = __fadd_rn(__fmul_rn(wv.x, yv.y), __fmul_rn(wv.y, yv.x));
  for (int p = 1; p < a.p; ++p) {
    wv = wl[p];
    yv = yb[p * y_port];
    xr = __fsub_rn(__fadd_rn(xr, __fmul_rn(wv.x, yv.x)), __fmul_rn(wv.y, yv.y));
    xi = __fadd_rn(__fadd_rn(xi, __fmul_rn(wv.x, yv.y)), __fmul_rn(wv.y, yv.x));
  }
  const float inv = 1.0f / fmaxf(a.eq_nvar[(static_cast<long long>(b) * a.nsc + n) * a.l + l],
                                 1e-12f);

  float li[M], lq[M];
  const float di = axis_llrs<M>(xr, lv, lab, li);
  const float dq = axis_llrs<M>(xi, lv, lab, lq);
  a.err2[lane] = __fadd_rn(di, dq);

  const long long plane_len = per_slot;
  const float* sg = a.signs + static_cast<long long>(b) * a.qm * plane_len + pos;
  int8_t* out = a.planes + static_cast<long long>(b) * a.qm * plane_len + pos;
#pragma unroll
  for (int t = 0; t < M; ++t) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int bit = 2 * t + h;
      const float llr = h ? lq[t] : li[t];
      float q = rintf(__fmul_rn(__fmul_rn(llr, inv), a.scale));
      q = fminf(fmaxf(q, -kLlrMax), kLlrMax);
      out[bit * plane_len] = static_cast<int8_t>(__fmul_rn(q, sg[bit * plane_len]));
    }
  }
}

}  // namespace

extern "C" int demap_planes(const void* y, const void* w, const void* eq_nvar,
                            const void* signs, const void* levels, const void* labels,
                            int batch, int p, int nsym, int nsc, int l, int qm, float scale,
                            void* planes, void* err2, void* stream) {
  Args a;
  a.y = static_cast<const float2*>(y);
  a.w = static_cast<const float2*>(w);
  a.eq_nvar = static_cast<const float*>(eq_nvar);
  a.signs = static_cast<const float*>(signs);
  a.levels = static_cast<const float*>(levels);
  a.labels = static_cast<const int*>(labels);
  a.batch = batch;
  a.p = p;
  a.nsym = nsym;
  a.nsc = nsc;
  a.l = l;
  a.qm = qm;
  a.scale = scale;
  a.planes = static_cast<int8_t*>(planes);
  a.err2 = static_cast<float*>(err2);
  const long long lanes = static_cast<long long>(batch) * nsym * nsc * l;
  const int threads = 256;
  const unsigned blocks = static_cast<unsigned>((lanes + threads - 1) / threads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (qm) {
    case 2: demap_planes_kernel<1><<<blocks, threads, 0, s>>>(a); break;
    case 4: demap_planes_kernel<2><<<blocks, threads, 0, s>>>(a); break;
    case 6: demap_planes_kernel<3><<<blocks, threads, 0, s>>>(a); break;
    case 8: demap_planes_kernel<4><<<blocks, threads, 0, s>>>(a); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
