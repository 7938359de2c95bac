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
// layer row r.
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

namespace {

constexpr int kThreads = 256;
constexpr int kScPerBlock = kThreads / 4;
constexpr unsigned kFullMask = 0xffffffffu;

struct cf {
  float re;
  float im;
};

__device__ __forceinline__ cf cmul(cf a, cf b) {
  return {a.re * b.re - a.im * b.im, a.re * b.im + a.im * b.re};
}
__device__ __forceinline__ cf cadd(cf a, cf b) { return {a.re + b.re, a.im + b.im}; }
__device__ __forceinline__ cf csub(cf a, cf b) { return {a.re - b.re, a.im - b.im}; }
__device__ __forceinline__ cf cneg(cf a) { return {-a.re, -a.im}; }
__device__ __forceinline__ cf cconj(cf a) { return {a.re, -a.im}; }
__device__ __forceinline__ cf crecip(cf a) {
  const float r = 1.0f / fmaxf(a.re * a.re + a.im * a.im, 1e-30f);
  return {a.re * r, -a.im * r};
}

// Lane `src` of this lane's quad holds v.
__device__ __forceinline__ cf from_lane(cf v, int src) {
  return {__shfl_sync(kFullMask, v.re, src, 4), __shfl_sync(kFullMask, v.im, src, 4)};
}

__device__ __forceinline__ cf pick(int r, cf a, cf b, cf c, cf d) {
  return r == 0 ? a : r == 1 ? b : r == 2 ? c : d;
}

struct m2 {
  cf a, b, c, d;  // row-major 2x2
};

__device__ __forceinline__ m2 inv2(m2 x) {
  const cf r = crecip(csub(cmul(x.a, x.d), cmul(x.b, x.c)));
  return {cmul(x.d, r), cneg(cmul(x.b, r)), cneg(cmul(x.c, r)), cmul(x.a, r)};
}

__device__ __forceinline__ m2 mm(m2 x, m2 y) {
  return {cadd(cmul(x.a, y.a), cmul(x.b, y.c)), cadd(cmul(x.a, y.b), cmul(x.b, y.d)),
          cadd(cmul(x.c, y.a), cmul(x.d, y.c)), cadd(cmul(x.c, y.b), cmul(x.d, y.d))};
}

__device__ __forceinline__ m2 msub(m2 x, m2 y) {
  return {csub(x.a, y.a), csub(x.b, y.b), csub(x.c, y.c), csub(x.d, y.d)};
}

// Row (x0, x1) of a 2x2 product x y, as mm forms it.
__device__ __forceinline__ void row_mm(cf x0, cf x1, m2 y, cf& o0, cf& o1) {
  o0 = cadd(cmul(x0, y.a), cmul(x1, y.c));
  o1 = cadd(cmul(x0, y.b), cmul(x1, y.d));
}

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

    // 1. Column r of H, then all of it: hh[p][l] from lane l.
    const float2* hc = h + b * sb + (live ? n : 0) * sn + r * sl;
    cf col[4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      const float2 x = hc[p * sp];
      col[p] = {x.x, x.y};
    }
    cf hh[4][4];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int l = 0; l < 4; ++l) hh[p][l] = from_lane(col[p], l);
    }

    // 2. Row r of G, then all of it: g[l][m] from lane l.
    cf grow[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      cf acc = {0.0f, 0.0f};
#pragma unroll
      for (int p = 0; p < 4; ++p) acc = cadd(acc, cmul(cconj(col[p]), hh[p][m]));
      grow[m] = acc;
    }
    cf g[4][4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
#pragma unroll
      for (int m = 0; m < 4; ++m) g[l][m] = from_lane(grow[m], l);
    }
    cf c[4][4];
#pragma unroll
    for (int l = 0; l < 4; ++l) {
#pragma unroll
      for (int m = 0; m < 4; ++m) c[l][m] = l == m ? cf{g[l][m].re + nv, g[l][m].im} : g[l][m];
    }

    // 3. The shared part of the blocked inverse, then row r of C^-1.
    const m2 A = {c[0][0], c[0][1], c[1][0], c[1][1]};
    const m2 B = {c[0][2], c[0][3], c[1][2], c[1][3]};
    const m2 Bh = {c[2][0], c[2][1], c[3][0], c[3][1]};
    const m2 D = {c[2][2], c[2][3], c[3][2], c[3][3]};
    const m2 Ai = inv2(A);
    const m2 BhAi = mm(Bh, Ai);
    const m2 Si = inv2(msub(D, mm(BhAi, B)));
    const int i = r & 1;
    cf ci[4];
    if (r < 2) {
      // Row i of TL = A^-1 + ((A^-1 B) S^-1) Bh A^-1 and TR = -(A^-1 B) S^-1.
      const cf a0 = i ? Ai.c : Ai.a, a1 = i ? Ai.d : Ai.b;
      cf u0, u1, v0, v1, t0, t1;
      row_mm(a0, a1, B, u0, u1);
      row_mm(u0, u1, Si, v0, v1);
      row_mm(v0, v1, BhAi, t0, t1);
      ci[0] = cadd(a0, t0);
      ci[1] = cadd(a1, t1);
      ci[2] = cneg(v0);
      ci[3] = cneg(v1);
    } else {
      // Row i of BL = -S^-1 Bh A^-1 and of S^-1.
      const cf s0 = i ? Si.c : Si.a, s1 = i ? Si.d : Si.b;
      cf t0, t1;
      row_mm(s0, s1, BhAi, t0, t1);
      ci[0] = cneg(t0);
      ci[1] = cneg(t1);
      ci[2] = s0;
      ci[3] = s1;
    }

    // 4. mu_r (column r of G), row r of W, eq_nvar[r].
    float mu = 0.0f;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const cf gm = pick(r, g[m][0], g[m][1], g[m][2], g[m][3]);
      mu = mu + (ci[m].re * gm.re - ci[m].im * gm.im);
    }
    mu = fminf(fmaxf(mu, 1e-9f), 1.0f - 1e-9f);
    const float inv_mu = 1.0f / mu;
    float o[8];
#pragma unroll
    for (int p = 0; p < 4; ++p) {
      cf acc = {0.0f, 0.0f};
#pragma unroll
      for (int m = 0; m < 4; ++m) acc = cadd(acc, cmul(ci[m], cconj(hh[p][m])));
      o[2 * p] = acc.re * inv_mu;
      o[2 * p + 1] = acc.im * inv_mu;
    }
    if (live) {
      const size_t sc = static_cast<size_t>(b) * nsc + n;
      float4* wr = reinterpret_cast<float4*>(w + sc * 16 + r * 4);
      wr[0] = make_float4(o[0], o[1], o[2], o[3]);
      wr[1] = make_float4(o[4], o[5], o[6], o[7]);
      ev[sc * 4 + r] = (1.0f - mu) * inv_mu;
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
