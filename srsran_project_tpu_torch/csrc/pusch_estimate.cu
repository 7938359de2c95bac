// K7: the PUSCH DM-RS channel estimate of the fast estimator and its
// second-difference noise in one call (two launches): per (slot or grant
// b, layer l, receive port p) the pilot gather, LS, the CDM pair despread,
// the time mean over the DM-RS symbols, the bulk-delay slope, derotation,
// the 9-tap raised-cosine smoothing, linear interpolation to every
// subcarrier and re-rotation, and the (1, -2, 1) second differences of the
// derotated pair values; then per b the noise variance over its nl * P
// sequences.
//
// Plain torch version and wrapper: srsran_project_tpu_torch/ops/pusch_estimate.py
// (estimate).  It replaces no TPU kernel: the JAX package's
// ops/estimator.estimate_channel is plain jnp that XLA fuses.  It replaces
// the eager composition phy/pusch._estimate_fast ran (ops/estimator.estimate_h
// and the second-difference noise): about 65 launches a call whatever the
// batch, the slope computed twice on the same pair values.
//
// What bounds it: latency.  At the flagship (273 PRB, 4 x 4, one DM-RS
// symbol) a slot reads 4 ports x 1,638 pilot REs of each layer's CDM group
// and the pilot, OCC and interpolation tables (about 0.16 MB) and writes
// 0.42 MB of channel: 0.17 us at 3.35 TB/s, 1.4 us at 8 slots.  The work
// is a chain of short dependent steps, so the design keeps it in one block
// a sequence: the block holds its <= 1,024 pair values in shared memory
// (two arrays of float2), its 256 threads take the pairs and then the
// subcarriers in strides, and two block reductions in a fixed order give
// the slope and the sequence's sum of |second difference|^2.  The channel
// is written straight into the (B, nof_sc, P, nl) layout the equalizer
// reads, so no permute copy follows.  A second launch of one thread per b
// sums the nl * P partial sums in (layer, port) order: no atomics, so two
// runs on the same inputs give the same bits.
//
// Numerics: the plain version's formulas in its order; every multiply and
// add rounded on its own (__fmul_rn / __fadd_rn in the smoothing and the
// interpolation, and the library is built with --fmad=false), the mean
// as torch's CUDA mean (the sum times float(1 / count)), the division by 3
// as torch's division by a scalar on the card (times float(1 / 3)).  The
// slope's and the noise's sums reduce in another order than torch's, and
// atan2f / sincosf / hypotf round in the card's own last place, so h and
// the noise variance match the plain version to about 1e-6 relative, not
// bitwise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPairs = 1024;
constexpr int kTaps = 9;
constexpr int kFinishThreads = 128;

struct Args {
  const float2* grid;     // (B, P, nsym, nsc) complex64, read through its strides
  long long grid_b, grid_p, grid_s, grid_k;  // element strides of b, p, symbol, subcarrier
  int nsc;                // the grid's subcarriers
  const long long* idx;   // (nl, nsym_d * np) flat pilot RE s * nsc + k of a port's grid
  const float2* r;        // (rb, nl, nsym_d, np) pilot values, rb = 1 or B
  int r_batch;            // rb
  const float* wf;        // (nl, np) OCC, +-1
  const long long* li;    // (nof_sc,) left and right pair of each subcarrier
  const long long* ri;
  const float* fr;        // (nof_sc,) interpolation fraction
  const float* coord;     // (nof_sc,) pair-index coordinate of the re-rotation
  float taps[kTaps];      // raised-cosine taps
  int ports, layers, nsym_d, np, nof_sc;
  float beta2;            // the DM-RS boost squared, as float32
  float2* h;              // (B, nof_sc, P, nl)
  float* partial;         // (B, nl * P) sums of |d2|^2, in (layer, port) order
  float* noise_var;       // (B,)
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                     __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// Sum of the block's per-thread values (re, im) in a fixed tree order;
// every thread gets the result.
__device__ float2 block_sum(float2 v, float2* red) {
  const int tid = threadIdx.x;
  red[tid] = v;
  __syncthreads();
  for (int w = kThreads / 2; w > 0; w >>= 1) {
    if (tid < w) {
      red[tid] = make_float2(__fadd_rn(red[tid].x, red[tid + w].x),
                             __fadd_rn(red[tid].y, red[tid + w].y));
    }
    __syncthreads();
  }
  const float2 out = red[0];
  __syncthreads();
  return out;
}

__global__ void __launch_bounds__(kThreads) pusch_estimate_kernel(Args a) {
  const int seq = blockIdx.x;  // (b, l, p), p fastest
  const int p = seq % a.ports;
  const int l = (seq / a.ports) % a.layers;
  const int b = seq / (a.ports * a.layers);
  const int tid = threadIdx.x;
  const int np = a.np, npairs = np / 2, nsym_d = a.nsym_d;

  __shared__ float2 h_rot[kMaxPairs];  // time-mean pair values, then derotated
  __shared__ float2 h_sm[kMaxPairs];   // smoothed
  __shared__ float2 red[kThreads];

  const float2* y = a.grid + b * a.grid_b + p * a.grid_p;
  const long long* idx = a.idx + static_cast<long long>(l) * nsym_d * np;
  const float2* r = a.r + (static_cast<long long>(a.r_batch > 1 ? b : 0) * a.layers + l)
                              * nsym_d * np;
  const float* wf = a.wf + static_cast<long long>(l) * np;

  // 1-4. The pilot gather, LS y * conj(r) * wf, the pair mean, the mean
  //      over the DM-RS symbols.
  const float inv_nsym = 1.0f / static_cast<float>(nsym_d);
  for (int q = tid; q < npairs; q += kThreads) {
    float2 acc = make_float2(0.0f, 0.0f);
    for (int d = 0; d < nsym_d; ++d) {
      float2 ls[2];
      for (int k = 0; k < 2; ++k) {
        const int j = 2 * q + k;
        const float2 rr = r[d * np + j];
        const int re = static_cast<int>(idx[d * np + j]);  // < nsym * nsc
        const float2 t = cmul(y[(re / a.nsc) * a.grid_s + (re % a.nsc) * a.grid_k],
                              make_float2(rr.x, -rr.y));
        ls[k] = make_float2(__fmul_rn(t.x, wf[j]), __fmul_rn(t.y, wf[j]));
      }
      const float2 pm = make_float2(__fmul_rn(__fadd_rn(ls[0].x, ls[1].x), 0.5f),
                                    __fmul_rn(__fadd_rn(ls[0].y, ls[1].y), 0.5f));
      acc = make_float2(__fadd_rn(acc.x, pm.x), __fadd_rn(acc.y, pm.y));
    }
    h_rot[q] = make_float2(__fmul_rn(acc.x, inv_nsym), __fmul_rn(acc.y, inv_nsym));
  }
  __syncthreads();
  // 5. The bulk-delay slope: the angle of the sum of h[q] conj(h[q - 1]).
  float2 c = make_float2(0.0f, 0.0f);
  for (int q = tid + 1; q < npairs; q += kThreads) {
    const float2 hq = h_rot[q], hp = h_rot[q - 1];
    const float2 t = cmul(hq, make_float2(hp.x, -hp.y));
    c = make_float2(__fadd_rn(c.x, t.x), __fadd_rn(c.y, t.y));
  }
  c = block_sum(c, red);
  const float slope = atan2f(c.y, c.x);

  // 6. Derotation by the slope.
  for (int q = tid; q < npairs; q += kThreads) {
    float s, co;
    sincosf(__fmul_rn(-slope, static_cast<float>(q)), &s, &co);
    h_rot[q] = cmul(h_rot[q], make_float2(co, s));
  }
  __syncthreads();

  // 10. The second differences' |.|^2, summed; 7. the smoothing with the
  //     edges replicated.
  float n2 = 0.0f;
  for (int q = tid; q < npairs - 2; q += kThreads) {
    const float2 h0 = h_rot[q], h1 = h_rot[q + 1], h2 = h_rot[q + 2];
    const float dx = __fadd_rn(__fsub_rn(h2.x, __fmul_rn(2.0f, h1.x)), h0.x);
    const float dy = __fadd_rn(__fsub_rn(h2.y, __fmul_rn(2.0f, h1.y)), h0.y);
    const float m = hypotf(dx, dy);
    n2 = __fadd_rn(n2, __fmul_rn(m, m));
  }
  for (int q = tid; q < npairs; q += kThreads) {
    float2 s = make_float2(0.0f, 0.0f);
    for (int t = 0; t < kTaps; ++t) {
      const float2 v = h_rot[min(max(q + t - kTaps / 2, 0), npairs - 1)];
      s = make_float2(__fadd_rn(s.x, __fmul_rn(a.taps[t], v.x)),
                      __fadd_rn(s.y, __fmul_rn(a.taps[t], v.y)));
    }
    h_sm[q] = s;
  }
  const float2 n2_sum = block_sum(make_float2(n2, 0.0f), red);  // syncs h_sm too
  if (tid == 0) a.partial[(static_cast<long long>(b) * a.layers + l) * a.ports + p] = n2_sum.x;

  // 8-9. Linear interpolation to every subcarrier, then the re-rotation.
  float2* out = a.h + static_cast<long long>(b) * a.nof_sc * a.ports * a.layers
                + p * a.layers + l;
  for (int sc = tid; sc < a.nof_sc; sc += kThreads) {
    const float2 h0 = h_sm[a.li[sc]], h1 = h_sm[a.ri[sc]];
    const float f = a.fr[sc];
    const float w0 = __fsub_rn(1.0f, f);
    const float2 hi = make_float2(__fadd_rn(__fmul_rn(h0.x, w0), __fmul_rn(h1.x, f)),
                                  __fadd_rn(__fmul_rn(h0.y, w0), __fmul_rn(h1.y, f)));
    float s, co;
    sincosf(__fmul_rn(slope, a.coord[sc]), &s, &co);
    out[static_cast<long long>(sc) * a.ports * a.layers] = cmul(hi, make_float2(co, s));
  }
}

// Per b: the mean over (layer, port, pair) of |d2|^2, times nsym_d / 3 and
// beta^2, at least 1e-10.
__global__ void __launch_bounds__(kFinishThreads) pusch_estimate_noise_kernel(Args a, int batch) {
  const int b = blockIdx.x * kFinishThreads + threadIdx.x;
  if (b >= batch) return;
  const int n = a.layers * a.ports;
  const float* part = a.partial + static_cast<long long>(b) * n;
  float sum = 0.0f;
  for (int i = 0; i < n; ++i) sum = __fadd_rn(sum, part[i]);
  const float count = static_cast<float>(n * (a.np / 2 - 2));
  float nv = __fmul_rn(sum, 1.0f / count);
  nv = __fmul_rn(nv, static_cast<float>(a.nsym_d));
  nv = __fmul_rn(nv, 1.0f / 3.0f);
  nv = __fmul_rn(nv, a.beta2);
  a.noise_var[b] = fmaxf(nv, 1e-10f);
}

}  // namespace

extern "C" int pusch_estimate(const void* grid, long long grid_b, long long grid_p,
                              long long grid_s, long long grid_k, int nsc, const void* idx,
                              const void* r, int r_batch, const void* wf,
                              const void* li, const void* ri, const void* fr, const void* coord,
                              const void* taps, int batch, int ports, int layers, int nsym_d,
                              int np, int nof_sc, float beta2, void* h, void* partial,
                              void* noise_var, void* stream) {
  const long long blocks = static_cast<long long>(batch) * ports * layers;
  if (batch < 1 || ports < 1 || layers < 1 || nsym_d < 1 || nof_sc < 1 || nsc < 1 || np % 2
      || np / 2 < 3 || np / 2 > kMaxPairs || (r_batch != 1 && r_batch != batch)
      || blocks > 0x7fffffffLL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.grid = static_cast<const float2*>(grid);
  a.grid_b = grid_b;
  a.grid_p = grid_p;
  a.grid_s = grid_s;
  a.grid_k = grid_k;
  a.nsc = nsc;
  a.idx = static_cast<const long long*>(idx);
  a.r = static_cast<const float2*>(r);
  a.r_batch = r_batch;
  a.wf = static_cast<const float*>(wf);
  a.li = static_cast<const long long*>(li);
  a.ri = static_cast<const long long*>(ri);
  a.fr = static_cast<const float*>(fr);
  a.coord = static_cast<const float*>(coord);
  for (int t = 0; t < kTaps; ++t) a.taps[t] = static_cast<const float*>(taps)[t];
  a.ports = ports;
  a.layers = layers;
  a.nsym_d = nsym_d;
  a.np = np;
  a.nof_sc = nof_sc;
  a.beta2 = beta2;
  a.h = static_cast<float2*>(h);
  a.partial = static_cast<float*>(partial);
  a.noise_var = static_cast<float*>(noise_var);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  pusch_estimate_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, s>>>(a);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  pusch_estimate_noise_kernel<<<(batch + kFinishThreads - 1) / kFinishThreads, kFinishThreads, 0,
                                s>>>(a, batch);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks per SM of the estimate kernel.
extern "C" int pusch_estimate_occupancy(int* registers, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err =
      cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(pusch_estimate_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(pusch_estimate_kernel), kThreads, 0));
}
