// K8: the PUSCH MMSE equalizer of full data rows in one launch: the
// per-subcarrier weights of 1, 2 or 4 layers from 4 receive ports, applied
// to every data symbol of each grant, written in the data-RE order the
// demapper reads.
//
// No TPU kernel: it replaces the eager composition of
// phy/pusch._equalize_stage (the data-row gather, K3 or the general
// equalize_weights, the weight apply as 16 complex products, 16 adds and a
// stack, and the copy of eq_nvar to every data symbol).  Plain torch
// version and wrapper: srsran_project_tpu_torch/ops/equalizer.py
// (mmse_equalize, mmse_equalize_plain).
//
// Per subcarrier n of grant b:
//   G = H^H H, C = G + nv I (nv >= 1e-12), Cinv, mu_l = Re sum_m Cinv[l][m]
//   G[m][l] clipped to [1e-9, 1 - 1e-9], W = Cinv H^H / mu,
//   eq_nvar = (1 - mu) / mu;
// and per data symbol s: x[s][n][l] = sum_p W[l][p] y[p][s][n], p = 0..3,
// with eq_nvar[s][n][l] = eq_nvar[l].
//
// Numerics.  L = 4: the weights are K3's (mmse::quad_weights in
// mmse_common.cuh), bitwise the plain version's.  L = 1, 2: the closed
// forms of equalize_weights (1 / c; the 2x2 adjugate over the
// determinant) in separately rounded real algebra, the reciprocal scaled
// as torch's complex division scales it (Smith: divide by the larger of
// |re| and |im| first), so that a determinant anywhere in float32's range
// keeps its inverse (an unscaled conj(d) / |d|^2 leaves the range once
// |d| passes 1.8e19 or falls below 1e-19: channels of about 3e4 or 3e-5
// at 2 layers).  The plain version's torch complex products round in
// their own way, so these weights agree with it to a few units in the
// last place, not bitwise.
// The apply rounds each complex product as torch's strided elementwise
// product does, re = fma(w.re, y.re, -(w.im y.im)) and im = fma(w.re, y.im,
// w.im y.re), and sums the ports from 0 in the order p = 0..3 with
// separately rounded adds, as Python's sum over the four products does.
//
// What bounds it.  Per subcarrier it reads H (32 B a layer) and 4 ports x
// nsym_d data REs (8 B each), and writes nsym_d x L complex64 and as many
// float32: at one flagship slot (3,276 subcarriers, 12 data symbols, 4
// layers) 3.57 MB, 1.07 us at 3.35 TB/s; 8.5 us at 8 slots.  The weights
// are a few hundred dependent operations a subcarrier, and a slot has
// only 3,276 subcarriers, so the kernel is latency-bound: what counts is
// how many threads share the work and how long each thread's chain is.
//
// Design.
//  * L = 4: a quad of lanes a subcarrier, lane r owning layer r, as K3:
//    the quad forms the weights, then for each data symbol lane r reads
//    port r's RE, the quad exchanges the four with __shfl_sync, and lane r
//    writes layer r's x (8 B) and eq_nvar (4 B).  Consecutive quads take
//    consecutive subcarriers, so a warp reads four runs of 64 contiguous
//    bytes and writes 256 contiguous bytes of x and 128 of eq_nvar a
//    symbol.  The data symbols go four at a time, all four loads in
//    flight before any is used.
//  * L = 1, 2: a thread a (subcarrier, data symbol, grant); the grid's y
//    axis runs over the data symbols, so the 8-80-PRB groups of a
//    multi-UE slot spread over 12 times the blocks.  Each thread forms its
//    subcarrier's weights (about 30 and 130 operations, cheaper than a
//    trip through shared memory) and writes its RE's L complex values (a
//    float2 or a float4) and eq_nvar.  Consecutive threads take
//    consecutive subcarriers: every load and store of a warp is one
//    contiguous run.

#include <cuda_runtime.h>
#include <stddef.h>

#include "mmse_common.cuh"

namespace {

using mmse::cadd;
using mmse::cconj;
using mmse::cf;
using mmse::cmul;

constexpr int kMaxSyms = 14;
constexpr int kQuadThreads = 256;
constexpr int kQuadSc = kQuadThreads / 4;
constexpr int kChunk = 4;  // data symbols whose loads a quad has in flight at once
constexpr int kThreads = 128;
constexpr int kMaxGrid = 65535;

struct Args {
  const float2* grid;  // (B, P=4, nsym, nof_grid_sc) complex64, element strides below
  long long gb, gp, gs, gn;
  const float2* h;  // (B, P=4, nsc, L) complex64, element strides below
  long long hb, hp, hn, hl;
  const float* nv;  // (B,)
  int batch, nsc, sc_start, nsym_d;
  int sym[kMaxSyms];  // the data symbols, ascending
  float2* x;          // (B, nsym_d * nsc, L) complex64, contiguous
  float* ev;          // (B, nsym_d * nsc, L) float32, contiguous
};

// w * y as torch's strided elementwise complex product rounds it.
__device__ __forceinline__ cf cmul_apply(cf w, cf y) {
  return {__fmaf_rn(w.re, y.re, -(w.im * y.im)), __fmaf_rn(w.re, y.im, w.im * y.re)};
}

// 1 / a as torch's complex division forms it: Smith's scaling, the
// larger of |re| and |im| divided out first.
__device__ __forceinline__ cf crecip_scaled(cf a) {
  if (fabsf(a.re) >= fabsf(a.im)) {
    const float rat = a.im / a.re;
    const float scl = 1.0f / (a.re + a.im * rat);
    return {scl, -rat * scl};
  }
  const float rat = a.re / a.im;
  const float scl = 1.0f / (a.im + a.re * rat);
  return {rat * scl, -scl};
}

__device__ __forceinline__ cf load(const float2* p) {
  const float2 v = *p;
  return {v.x, v.y};
}

__global__ void __launch_bounds__(kQuadThreads) equalize4_kernel(const Args a) {
  const int r = threadIdx.x & 3;
  const int n = blockIdx.x * kQuadSc + (threadIdx.x >> 2);
  // A quad past the last subcarrier computes on subcarrier 0 and stores
  // nothing: every lane stays in the shuffles.
  const bool live = n < a.nsc;
  const int nc = live ? n : 0;
  const size_t ndata = static_cast<size_t>(a.nsym_d) * a.nsc;
  for (int b = blockIdx.y; b < a.batch; b += gridDim.y) {
    const float2* hc = a.h + b * a.hb + nc * a.hn + r * a.hl;
    cf col[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) col[p] = load(hc + p * a.hp);
    cf w[4];
    float e;
    mmse::quad_weights(col, fmaxf(a.nv[b], 1e-12f), r, w, e);

    const float2* yr = a.grid + b * a.gb + r * a.gp + (a.sc_start + nc) * a.gn;
    float2* xb = a.x + (b * ndata + nc) * 4 + r;
    float* eb = a.ev + (b * ndata + nc) * 4 + r;
    for (int k0 = 0; k0 < a.nsym_d; k0 += kChunk) {
      cf y[kChunk];
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        const int k = k0 + j;
        y[j] = k < a.nsym_d ? load(yr + a.sym[k] * a.gs) : cf{0.0f, 0.0f};
      }
#pragma unroll
      for (int j = 0; j < kChunk; ++j) {
        cf acc = {0.0f, 0.0f};
#pragma unroll
        for (int p = 0; p < 4; ++p) acc = cadd(acc, cmul_apply(w[p], mmse::from_lane(y[j], p)));
        const int k = k0 + j;
        if (live && k < a.nsym_d) {
          const size_t off = static_cast<size_t>(k) * a.nsc * 4;
          xb[off] = make_float2(acc.re, acc.im);
          eb[off] = e;
        }
      }
    }
  }
}

// One subcarrier's L x 4 weights (L = 1, 2): w[l][p], ev[l].
template <int L>
__device__ __forceinline__ void small_weights(const cf h[4][L], float nv, cf w[L][4],
                                              float ev[L]) {
  cf g[L][L];
#pragma unroll
  for (int l = 0; l < L; ++l) {
#pragma unroll
    for (int m = 0; m < L; ++m) {
      cf acc = {0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < 4; ++p) acc = cadd(acc, cmul(cconj(h[p][l]), h[p][m]));
      g[l][m] = acc;
    }
  }
  cf ci[L][L];
  if constexpr (L == 1) {
    ci[0][0] = crecip_scaled({g[0][0].re + nv, g[0][0].im});
  } else {
    // The adjugate over the determinant, as _inv2x2 forms it.
    const cf c00 = {g[0][0].re + nv, g[0][0].im}, c11 = {g[1][1].re + nv, g[1][1].im};
    const cf r = crecip_scaled(mmse::csub(cmul(c00, c11), cmul(g[0][1], g[1][0])));
    ci[0][0] = cmul(c11, r);
    ci[0][1] = mmse::cneg(cmul(g[0][1], r));
    ci[1][0] = mmse::cneg(cmul(g[1][0], r));
    ci[1][1] = cmul(c00, r);
  }
#pragma unroll
  for (int l = 0; l < L; ++l) {
    float mu = 0.0f;
#pragma unroll
    for (int m = 0; m < L; ++m) mu = mu + (ci[l][m].re * g[m][l].re - ci[l][m].im * g[m][l].im);
    mu = fminf(fmaxf(mu, 1e-9f), 1.0f - 1e-9f);
    const float inv_mu = 1.0f / mu;
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      cf acc = {0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < L; ++m) acc = cadd(acc, cmul(ci[l][m], cconj(h[p][m])));
      w[l][p] = {acc.re * inv_mu, acc.im * inv_mu};
    }
    ev[l] = (1.0f - mu) * inv_mu;
  }
}

template <int L>
__global__ void __launch_bounds__(kThreads) equalize_small_kernel(const Args a) {
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int k = blockIdx.y;
  if (n >= a.nsc) return;
  const size_t ndata = static_cast<size_t>(a.nsym_d) * a.nsc;
  for (int b = blockIdx.z; b < a.batch; b += gridDim.z) {
    cf h[4][L];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int l = 0; l < L; ++l) h[p][l] = load(a.h + b * a.hb + p * a.hp + n * a.hn + l * a.hl);
    }
    const float2* yn = a.grid + b * a.gb + a.sym[k] * a.gs + (a.sc_start + n) * a.gn;
    cf y[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) y[p] = load(yn + p * a.gp);
    cf w[L][4];
    float e[L];
    small_weights<L>(h, fmaxf(a.nv[b], 1e-12f), w, e);
    cf x[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      cf acc = {0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < 4; ++p) acc = cadd(acc, cmul_apply(w[l][p], y[p]));
      x[l] = acc;
    }
    const size_t re = b * ndata + static_cast<size_t>(k) * a.nsc + n;
    if constexpr (L == 1) {
      a.x[re] = make_float2(x[0].re, x[0].im);
      a.ev[re] = e[0];
    } else {
      reinterpret_cast<float4*>(a.x)[re] = make_float4(x[0].re, x[0].im, x[1].re, x[1].im);
      reinterpret_cast<float2*>(a.ev)[re] = make_float2(e[0], e[1]);
    }
  }
}

int min_grid(int v) { return v < kMaxGrid ? v : kMaxGrid; }

}  // namespace

// grid: (B, 4, nsym, nof_grid_sc) complex64 and its element strides; h: (B,
// 4, nsc, L) complex64 and its element strides; nv (B,) float32; the data
// symbols as a bit mask (bit s: symbol s, s < 14); x (B, nsym_d * nsc, L)
// complex64 and ev (B, nsym_d * nsc, L) float32, contiguous.
extern "C" int mmse_equalize(const void* grid, long long gb, long long gp, long long gs,
                             long long gn, const void* h, long long hb, long long hp,
                             long long hn, long long hl, const void* nv, int batch, int nsc,
                             int layers, int sc_start, int sym_mask, void* x, void* ev,
                             void* stream) {
  Args a = {static_cast<const float2*>(grid), gb, gp, gs, gn, static_cast<const float2*>(h),
            hb, hp, hn, hl, static_cast<const float*>(nv), batch, nsc, sc_start, 0, {},
            static_cast<float2*>(x), static_cast<float*>(ev)};
  for (int s = 0; s < kMaxSyms; ++s) {
    if (sym_mask >> s & 1) a.sym[a.nsym_d++] = s;
  }
  if (a.nsym_d == 0 || (sym_mask >> kMaxSyms) != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (layers == 4) {
    const dim3 blocks((nsc + kQuadSc - 1) / kQuadSc, min_grid(batch));
    equalize4_kernel<<<blocks, kQuadThreads, 0, st>>>(a);
  } else if (layers == 1 || layers == 2) {
    const dim3 blocks((nsc + kThreads - 1) / kThreads, a.nsym_d, min_grid(batch));
    if (layers == 1) {
      equalize_small_kernel<1><<<blocks, kThreads, 0, st>>>(a);
    } else {
      equalize_small_kernel<2><<<blocks, kThreads, 0, st>>>(a);
    }
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks per SM of the kernel for `layers`.
extern "C" int mmse_equalize_occupancy(int layers, int* registers, int* blocks) {
  const void* fn = layers == 4   ? reinterpret_cast<const void*>(equalize4_kernel)
                   : layers == 2 ? reinterpret_cast<const void*>(equalize_small_kernel<2>)
                   : layers == 1 ? reinterpret_cast<const void*>(equalize_small_kernel<1>)
                                 : nullptr;
  if (fn == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, layers == 4 ? kQuadThreads : kThreads, 0));
}
