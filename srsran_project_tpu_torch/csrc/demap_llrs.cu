// K5: the float PUSCH path's demap stage in one launch: closed-form max-log
// LLRs, int8 quantization, descrambling into the codeword-order LLR stream,
// and each lane's squared distance to the nearest constellation point.
//
// Plain torch version and wrapper: srsran_project_tpu_torch/ops/demap_llrs.py
// (demap_llrs).  It replaces, for square QAM, the eager composition of
// ops/modulation/demapper.demap_soft, the (B, L, ., qm) -> (B, G) re-layout,
// quantize_llr, the sign flip of scrambling.descramble_llrs and the
// per-lane distance of modulation/evm.evm that phy/pusch._demap_stage ran.
//
// Design.  One thread per (slot b, data RE r) handles the L layers of that
// RE: its lanes j = (b * ndata + r) * L + l are contiguous in x_hat and
// eq_nvar, and its L * qm LLR bytes and Gold bits are contiguous in the
// stream (bit t of lane j at j * qm + t).  Neighbouring threads take
// neighbouring REs, so every load and store of a warp is one contiguous
// span: x as float4 pairs (L = 4), a float4 (L = 2) or float2s, eq_nvar
// and err2 as one vector where L allows, the Gold bits and the LLR bytes
// with the widest aligned vector that L * qm allows (16 bytes at 256QAM x
// 4 layers).  The constellation is a template parameter: its PAM levels
// and Gray labels are compile-time tables (Pam<M> in demap_common.cuh,
// shared with K4), so every min tree unrolls into a fixed sequence of
// fminf.
//
// What bounds it: memory.  Per lane it reads 8 bytes of x, 4 of eq_nvar and
// qm Gold bytes, and writes qm LLR bytes and 4 of err2: at the flagship
// (157,248 lanes a slot, 256QAM) 5.03 MB a slot.
//
// Numerics (bit-exact with the plain version, which follows the float
// path's own formulas, not K4's): every multiply and add is rounded on its
// own (__fmul_rn / __fadd_rn / __fsub_rn, and the library is built with
// --fmad=false).  16/64/256QAM: (m1 - m0) * (1 / eq_nvar), eq_nvar not
// clamped, 1 / eq_nvar an IEEE division, as torch's reciprocal; QPSK: (2
// sqrt(2) x) / eq_nvar, an IEEE division.  Then * (120 / range_limit),
// rintf (half to even, as torch.round), clamp to +-120, and a negation
// where the Gold bit is 1 (|q| <= 120, so it equals the plain version's
// saturating flip).  The squares are d * d, as torch's pow(d, 2); fminf over
// non-negative squares is exact and does not depend on the tree's order.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "demap_common.cuh"

namespace {

using demap::axis_llrs;
using demap::GoldBits;
using demap::load_lanes;
using demap::store_bytes;
using demap::store_lanes;

constexpr float kLlrMax = 120.0f;
constexpr float kQpskScale = 2.82842708f;  // float32(2 sqrt(2)), demap_soft's QPSK factor
constexpr int kThreads = 128;

struct Args {
  const float2* x;       // (rows, L) complex64, rows = B * ndata
  const float* eq_nvar;  // (rows, L)
  const uint8_t* c;      // (rows, L * qm) Gold bits, stream order
  long long rows;
  float scale;           // LLR_MAX / range_limit
  uint8_t* llr;          // (rows, L * qm) int8 LLRs, stream order
  float* err2;           // (rows, L)
};

// The L complex values of one RE as real and imaginary parts.
template <int L>
__device__ __forceinline__ void load_complex(const float2* src, float* re, float* im) {
  if constexpr (L % 2 == 0) {
#pragma unroll
    for (int i = 0; i < L / 2; ++i) {
      const float4 v = reinterpret_cast<const float4*>(src)[i];
      re[2 * i] = v.x, im[2 * i] = v.y, re[2 * i + 1] = v.z, im[2 * i + 1] = v.w;
    }
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float2 v = src[l];
      re[l] = v.x, im[l] = v.y;
    }
  }
}

template <int M, int L>
__global__ void __launch_bounds__(kThreads) demap_llrs_kernel(Args a) {
  constexpr int kQm = 2 * M;
  constexpr int kBytes = L * kQm;
  const long long row = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (row >= a.rows) return;
  float xr[L], xi[L], nv[L];
  load_complex<L>(a.x + row * L, xr, xi);
  load_lanes<L>(a.eq_nvar + row * L, nv);
  const GoldBits<kBytes> gold(a.c + row * kBytes);
  uint32_t packed[(kBytes + 3) / 4];
#pragma unroll
  for (int i = 0; i < (kBytes + 3) / 4; ++i) packed[i] = 0;
  float err[L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float li[M], lq[M];
    err[l] = __fadd_rn(axis_llrs<M>(xr[l], li), axis_llrs<M>(xi[l], lq));
    if constexpr (M == 1) {
      // QPSK: demap_soft's linear LLR replaces the min trees' (only the
      // distances above are kept).
      li[0] = __fdiv_rn(__fmul_rn(kQpskScale, xr[l]), nv[l]);
      lq[0] = __fdiv_rn(__fmul_rn(kQpskScale, xi[l]), nv[l]);
    } else {
      const float inv = __fdiv_rn(1.0f, nv[l]);
#pragma unroll
      for (int t = 0; t < M; ++t) {
        li[t] = __fmul_rn(li[t], inv);
        lq[t] = __fmul_rn(lq[t], inv);
      }
    }
#pragma unroll
    for (int bit = 0; bit < kQm; ++bit) {
      const int k = l * kQm + bit;
      float q = rintf(__fmul_rn(bit & 1 ? lq[bit / 2] : li[bit / 2], a.scale));
      q = fminf(fmaxf(q, -kLlrMax), kLlrMax);
      if (gold(k)) q = -q;
      packed[k / 4] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)))
                       << (8 * (k % 4));
    }
  }
  store_bytes<kBytes>(a.llr + row * kBytes, packed);
  store_lanes<L>(a.err2 + row * L, err);
}

using Kernel = void (*)(Args);

// The instance for (qm, L), or nullptr.
Kernel pick(int qm, int l) {
  static const Kernel kTable[4][4] = {
      {demap_llrs_kernel<1, 1>, demap_llrs_kernel<1, 2>, demap_llrs_kernel<1, 3>,
       demap_llrs_kernel<1, 4>},
      {demap_llrs_kernel<2, 1>, demap_llrs_kernel<2, 2>, demap_llrs_kernel<2, 3>,
       demap_llrs_kernel<2, 4>},
      {demap_llrs_kernel<3, 1>, demap_llrs_kernel<3, 2>, demap_llrs_kernel<3, 3>,
       demap_llrs_kernel<3, 4>},
      {demap_llrs_kernel<4, 1>, demap_llrs_kernel<4, 2>, demap_llrs_kernel<4, 3>,
       demap_llrs_kernel<4, 4>}};
  if (qm < 2 || qm > 8 || qm % 2 || l < 1 || l > 4) return nullptr;
  return kTable[qm / 2 - 1][l - 1];
}

}  // namespace

extern "C" int demap_llrs(const void* x, const void* eq_nvar, const void* c, long long rows,
                          int l, int qm, float scale, void* llr, void* err2, void* stream) {
  const Kernel kernel = pick(qm, l);
  const long long blocks = (rows + kThreads - 1) / kThreads;
  if (kernel == nullptr || rows < 1 || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.x = static_cast<const float2*>(x);
  a.eq_nvar = static_cast<const float*>(eq_nvar);
  a.c = static_cast<const uint8_t*>(c);
  a.rows = rows;
  a.scale = scale;
  a.llr = static_cast<uint8_t*>(llr);
  a.err2 = static_cast<float*>(err2);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel),
                                           dim3(static_cast<unsigned>(blocks)),
                                           dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// Registers a thread and resident blocks per SM of the (qm, L) instance.
extern "C" int demap_llrs_occupancy(int qm, int l, int* registers, int* blocks) {
  const Kernel kernel = pick(qm, l);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(kernel), kThreads, 0));
}
