// K3: 4x4 MMSE equalizer weights, a quad of threads per subcarrier.
//
// Replaces the TPU kernel equalize_weights_pallas
// (srsran_project_tpu/ops/equalizer_pallas.py, body _weights_kernel).
// Plain torch version and wrapper: srsran_project_tpu_torch/ops/equalizer.py.
//
// Per subcarrier: G = H^H H, C = G + nv I (nv >= 1e-12), blocked 2x2 Schur
// inverse of C, mu_l = Re sum_m Cinv[l][m] G[m][l] clipped to
// [1e-9, 1 - 1e-9], W = Cinv H^H / mu, eq_nvar = (1 - mu) / mu — the
// same algebra, in the same order, as the TPU kernel and the plain version:
// every output element comes out of the same sequence of separately rounded
// operations (the library is built with --fmad=false), so the kernel equals
// the plain version bitwise.
//
// What bounds it on Hopper.  Each subcarrier reads 128 B (16 complex64) and
// writes 144 B; the work is a few hundred dependent complex operations per
// subcarrier in registers.  A slot has only 3276 subcarriers, so the kernel
// is latency-bound: what counts is how many threads share the work and how
// long each thread's dependent chain is.
//
// Design.  Four lanes of a warp (a quad) share a subcarrier; lane r owns
// layer row r (mmse::quad_weights in mmse_common.cuh, which K8 shares).
//  1. Lane r loads column r of H (its four ports) through the caller's
//     strides, and the quad exchanges the 16 entries with __shfl_sync.
//     Consecutive quads take consecutive subcarriers, so a warp reads 8
//     neighbouring subcarriers.  The channel estimate lies in memory as
//     (B, L, P, nsc), subcarriers innermost (the caller hands the (B, nsc,
//     P, L) view of it): each of a warp's four loads then reads four runs
//     of 8 x 8 = 64 contiguous bytes, every sector fully used.  A
//     contiguous (B, nsc, P, L) input is read 128 contiguous bytes a quad.
//  2. Lane r forms row r of G (4 of its 16 entries), and the quad exchanges
//     the rows.
//  3. Every lane forms the shared part of the inverse (A^-1, Bh A^-1 and
//     the Schur complement's inverse S^-1), then only row r of C^-1: rows
//     0-1 from A^-1 + (A^-1 B S^-1) Bh A^-1 and -(A^-1 B S^-1), rows 2-3
//     from -(S^-1 Bh A^-1) and S^-1.
//  4. Lane r forms mu_r, row r of W and eq_nvar[r]; a quad stores W's 128
//     contiguous bytes (two float4 a lane) and eq_nvar's 16.
// Against one thread per subcarrier this runs four times the threads, and
// each thread's chain is about a third as long: the gram and the outputs
// are split four ways, the inverse's rows two ways.

#include <cuda_runtime.h>
#include <stddef.h>

#include "mmse_common.cuh"

namespace {

using mmse::cf;

constexpr int kThreads = 256;
constexpr int kScPerBlock = kThreads / 4;

// h: (batch, nsc, P=4, L=4) complex64 read through element strides
// (sb, sn, sp, sl); nv (batch,); w (batch, nsc, L, P) and ev (batch, nsc, L)
// contiguous.  Grid (subcarrier blocks, batch blocks).
__global__ void __launch_bounds__(kThreads)
    mmse_weights_4x4_kernel(const float2* __restrict__ h, long long sb, long long sn,
                            long long sp, long long sl, const float* __restrict__ nv_in,
                            int batch, int nsc, float2* __restrict__ w, float* __restrict__ ev) {
  const int r = threadIdx.x & 3;
  const int n = blockIdx.x * kScPerBlock + (threadIdx.x >> 2);
  // A quad past the last subcarrier computes on subcarrier 0 and stores
  // nothing: every lane stays in the shuffles.
  const bool live = n < nsc;
  for (int b = blockIdx.y; b < batch; b += gridDim.y) {
    const float nv = fmaxf(nv_in[b], 1e-12f);
    const float2* hc = h + b * sb + (live ? n : 0) * sn + r * sl;
    cf col[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 x = hc[p * sp];
      col[p] = {x.x, x.y};
    }
    cf wr[4];
    float e;
    mmse::quad_weights(col, nv, r, wr, e);
    if (live) {
      const size_t sc = static_cast<size_t>(b) * nsc + n;
      float4* out = reinterpret_cast<float4*>(w + sc * 16 + r * 4);
      out[0] = make_float4(wr[0].re, wr[0].im, wr[1].re, wr[1].im);
      out[1] = make_float4(wr[2].re, wr[2].im, wr[3].re, wr[3].im);
      ev[sc * 4 + r] = e;
    }
  }
}

constexpr int kMaxGridY = 65535;

}  // namespace

extern "C" int mmse_weights_4x4(const void* h, long long sb, long long sn, long long sp,
                                long long sl, const void* nv, int batch, int nsc, void* w,
                                void* ev, void* stream) {
  const dim3 grid((nsc + kScPerBlock - 1) / kScPerBlock, batch < kMaxGridY ? batch : kMaxGridY);
  mmse_weights_4x4_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), sb, sn, sp, sl, static_cast<const float*>(nv), batch, nsc,
      static_cast<float2*>(w), static_cast<float*>(ev));
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks per SM of the kernel.
extern "C" int mmse_weights_4x4_occupancy(int* registers, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, mmse_weights_4x4_kernel);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, mmse_weights_4x4_kernel, kThreads, 0));
}
