// What the two MMSE kernels share: K3 (mmse_weights_4x4.cu, the 4x4 weights
// alone, for the plane path's K4) and K8 (mmse_equalize.cu, the weights of
// 1, 2 or 4 layers applied to every data symbol of a grant).
//
// * cf and its operations: complex float32 algebra on (re, im) pairs, each
//   multiply and add rounded on its own (the libraries are built with
//   --fmad=false), as the plain torch versions compute on float32 tensors.
// * m2, inv2, mm, msub, row_mm: 2x2 complex blocks and their closed-form
//   inverse, the pieces of the blocked Schur inverse.
// * quad_weights: K3's 4x4 MMSE algebra for one subcarrier, spread over a
//   quad of lanes, lane r owning layer row r.

#pragma once

#include <cuda_runtime.h>

namespace mmse {

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

// One subcarrier's 4x4 MMSE weights, a quad of lanes sharing it: lane r
// holds col[p] = H[p][r] (column r of H, its four ports) and gets row r of
// W (w[p] = W[r][p]) and eq_nvar[r].  nv is already clamped to >= 1e-12.
// Every lane of the quad must call it (it shuffles within the quad).
//  1. The quad exchanges H's columns: hh[p][l] from lane l.
//  2. Lane r forms row r of G = H^H H, and the quad exchanges the rows.
//  3. Every lane forms the shared part of the blocked inverse of
//     C = G + nv I (A^-1, Bh A^-1 and the Schur complement's inverse
//     S^-1), then only row r of C^-1: rows 0-1 from
//     A^-1 + (A^-1 B S^-1) Bh A^-1 and -(A^-1 B S^-1), rows 2-3 from
//     -(S^-1 Bh A^-1) and S^-1.
//  4. mu_r = Re sum_m Cinv[r][m] G[m][r] clipped to [1e-9, 1 - 1e-9],
//     row r of W = Cinv H^H / mu_r, eq_nvar[r] = (1 - mu_r) / mu_r.
// Against one thread a subcarrier this runs four times the threads, and
// each thread's chain is about a third as long: the gram and the outputs
// are split four ways, the inverse's rows two ways.
__device__ __forceinline__ void quad_weights(const cf col[4], float nv, int r, cf w[4],
                                             float& ev) {
  cf hh[4][4];
#pragma unroll
  for (int p = 0; p < 4; ++p) {
#pragma unroll
    for (int l = 0; l < 4; ++l) hh[p][l] = from_lane(col[p], l);
  }

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

  float mu = 0.0f;
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    const cf gm = pick(r, g[m][0], g[m][1], g[m][2], g[m][3]);
    mu = mu + (ci[m].re * gm.re - ci[m].im * gm.im);
  }
  mu = fminf(fmaxf(mu, 1e-9f), 1.0f - 1e-9f);
  const float inv_mu = 1.0f / mu;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    cf acc = {0.0f, 0.0f};
#pragma unroll
    for (int m = 0; m < 4; ++m) acc = cadd(acc, cmul(ci[m], cconj(hh[p][m])));
    w[p] = {acc.re * inv_mu, acc.im * inv_mu};
  }
  ev = (1.0f - mu) * inv_mu;
}

}  // namespace mmse
