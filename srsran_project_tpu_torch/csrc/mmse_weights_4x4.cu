// K3: 4x4 MMSE equalizer weights, one thread per subcarrier.
//
// Replaces the TPU kernel equalize_weights_pallas
// (srsran_project_tpu/ops/equalizer_pallas.py, body _weights_kernel).
// Plain torch version and wrapper: srsran_project_tpu_torch/ops/equalizer.py.
//
// Per subcarrier: G = H^H H, C = G + nv I (nv >= 1e-12), blocked 2x2 Schur
// inverse of C, mu_l = Re sum_m Cinv[l][m] G[m][l] clipped to
// [1e-9, 1 - 1e-9], W = Cinv H^H / mu, eq_nvar = (1 - mu) / mu — the
// same algebra, in the same order, as the TPU kernel.
//
// What bounds it on Hopper.  Each subcarrier reads 128 B (16 complex64)
// and writes 144 B, and does ~1.5k flops of dependent scalar complex
// algebra, held in registers.  At the flagship's 3276 subcarriers per slot
// the grid is only 13 blocks of 256 threads, so a single slot is
// latency-bound (one dependent chain per thread, a fraction of one wave);
// a slot batch fills the card.  The TPU kernel's (2*P*L, nsc) re/im plane
// repacking was a lane-layout workaround and is left out: each thread
// reads its own interleaved complex64 matrix directly.

#include <cuda_runtime.h>
#include <stddef.h>

namespace {

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

__device__ __forceinline__ m2 madd(m2 x, m2 y) {
  return {cadd(x.a, y.a), cadd(x.b, y.b), cadd(x.c, y.c), cadd(x.d, y.d)};
}
__device__ __forceinline__ m2 msub(m2 x, m2 y) {
  return {csub(x.a, y.a), csub(x.b, y.b), csub(x.c, y.c), csub(x.d, y.d)};
}
__device__ __forceinline__ m2 mneg(m2 x) { return {cneg(x.a), cneg(x.b), cneg(x.c), cneg(x.d)}; }

__global__ void mmse_weights_4x4_kernel(const float2* __restrict__ h,
                                        const float* __restrict__ nv_in, int n,
                                        int rows_per_nv, float2* __restrict__ w,
                                        float* __restrict__ ev) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float nv = fmaxf(nv_in[i / rows_per_nv], 1e-12f);

  cf hh[4][4];  // hh[p][l]
  for (int k = 0; k < 16; ++k) {
    const float2 x = h[static_cast<size_t>(i) * 16 + k];
    hh[k / 4][k % 4] = {x.x, x.y};
  }

  cf g[4][4];
  for (int l = 0; l < 4; ++l) {
    for (int m = 0; m < 4; ++m) {
      cf acc = {0.0f, 0.0f};
      for (int p = 0; p < 4; ++p) acc = cadd(acc, cmul(cconj(hh[p][l]), hh[p][m]));
      g[l][m] = acc;
    }
  }
  cf c[4][4];
  for (int l = 0; l < 4; ++l) {
    for (int m = 0; m < 4; ++m) c[l][m] = {g[l][m].re + (l == m ? nv : 0.0f), g[l][m].im};
  }

  const m2 A = {c[0][0], c[0][1], c[1][0], c[1][1]};
  const m2 B = {c[0][2], c[0][3], c[1][2], c[1][3]};
  const m2 Bh = {c[2][0], c[2][1], c[3][0], c[3][1]};
  const m2 D = {c[2][2], c[2][3], c[3][2], c[3][3]};
  const m2 Ai = inv2(A);
  const m2 Si = inv2(msub(D, mm(mm(Bh, Ai), B)));
  const m2 AiB = mm(Ai, B);
  const m2 BhAi = mm(Bh, Ai);
  const m2 TL = madd(Ai, mm(mm(AiB, Si), BhAi));
  const m2 TR = mneg(mm(AiB, Si));
  const m2 BL = mneg(mm(Si, BhAi));
  const cf ci[4][4] = {{TL.a, TL.b, TR.a, TR.b},
                       {TL.c, TL.d, TR.c, TR.d},
                       {BL.a, BL.b, Si.a, Si.b},
                       {BL.c, BL.d, Si.c, Si.d}};

  for (int l = 0; l < 4; ++l) {
    float mu = 0.0f;
    for (int m = 0; m < 4; ++m) mu = mu + (ci[l][m].re * g[m][l].re - ci[l][m].im * g[m][l].im);
    mu = fminf(fmaxf(mu, 1e-9f), 1.0f - 1e-9f);
    const float inv_mu = 1.0f / mu;
    for (int p = 0; p < 4; ++p) {
      cf acc = {0.0f, 0.0f};
      for (int m = 0; m < 4; ++m) acc = cadd(acc, cmul(ci[l][m], cconj(hh[p][m])));
      w[static_cast<size_t>(i) * 16 + l * 4 + p] = make_float2(acc.re * inv_mu, acc.im * inv_mu);
    }
    ev[static_cast<size_t>(i) * 4 + l] = (1.0f - mu) * inv_mu;
  }
}

}  // namespace

extern "C" int mmse_weights_4x4(const void* h, const void* nv, int n, int rows_per_nv,
                                void* w, void* ev, void* stream) {
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  mmse_weights_4x4_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float2*>(h), static_cast<const float*>(nv), n, rows_per_nv,
      static_cast<float2*>(w), static_cast<float*>(ev));
  return static_cast<int>(cudaGetLastError());
}
