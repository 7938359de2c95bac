// K1: fused LDPC rate dematch + layered normalized min-sum decode.
//
// Replaces the TPU kernel decode_dematch_pallas
// (srsran_project_tpu/ops/ldpc/decoder_pallas.py: body _iteration_body,
// stop rule _run_iterations, copy plan _dematch_plane_plan).  Plain torch
// version and wrapper: srsran_project_tpu_torch/ops/ldpc/decoder.py.
//
// Design.  One thread block per codeblock, one thread per circulant row z
// (blockDim = Z rounded up to a warp).  The layered schedule is
// sequential by nature, so a codeblock cannot be split across blocks; the
// block barrier between layers is __syncthreads().  For each edge
// (col, shift) of a check row, thread z owns a-posteriori position
// col*Z + (z + shift) mod Z; that map is a bijection per edge and a row
// touches each column once, so reads and write-backs inside a layer never
// collide between threads.
//
// What bounds it on Hopper.  The a-posteriori state (ncols*Z f32: 58 KB
// at the flagship's 38 columns) lives in dynamic shared memory for the
// whole decode.  The extrinsic messages R (one f32 per edge and z: 252 KB
// per codeblock at the flagship's 164 active edges) do not fit beside it
// in the 227 KB a block may use, so R lives in a global scratch buffer
// (35 MB for 141 codeblocks: L2-resident on the 50 MB L2), read and
// written once per edge per iteration, coalesced along z.  With one
// 384-thread block per codeblock and ~one block per SM, the kernel is
// latency-bound on the layer barriers and the L2 round trips of R; a
// compressed R (min1, min2, min mask, sign mask per row and z) in shared
// memory is the next step.
//
// Numerics (bit-exact with the plain version): f32 state; channel LLRs
// clamped to +-64; punctured prefix and erasures 0, fillers +64; the update
// r = (+-0.8) * mag is rounded, stored, then v + r is rounded on its own
// (__fmul_rn / __fadd_rn, and the library is built with --fmad=false).
//
// Early stop is per codeblock: the block leaves the iteration loop after
// a whole iteration in which the on-the-fly layered syndrome (parity of
// the hard decisions entering each layer) saw every check satisfied.  The
// TPU kernel stops per batch tile of codeblocks instead.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kMaxRowDegree = 32;  // ops/ldpc/decoder.py MAX_ROW_DEGREE
constexpr float kScaling = 0.8f;
constexpr float kClamp = 64.0f;
constexpr float kBig = 3.0e38f;

struct Args {
  const int8_t* llrs;  // (C, E) rate-matched LLRs, transmission order
  int e;
  int qm;
  const int* copies;  // (nof_copies, 4): plane b, lo, hi, buffer start
  int nof_copies;
  int f_start;  // filler range [f_start, f_end), buffer coordinates
  int f_end;
  const int* edges;      // (total_edges, 2): column, shift
  const int* layer_off;  // (nof_layers + 1,) edge offsets per check row
  int nof_layers;
  int total_edges;
  int z;
  int ncols;
  int kb;
  int nof_iterations;
  int early_stop;
  float* r;        // (C, total_edges * Z) scratch
  uint8_t* bits;   // (C, kb * Z)
  int* iters;      // (C,)
};

__global__ void decode_dematch_kernel(Args a) {
  extern __shared__ float smem[];
  float* app = smem;
  int* s_edges = reinterpret_cast<int*>(app + a.ncols * a.z);
  int* s_layer = s_edges + 2 * a.total_edges;

  const int cb = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int z = a.z;
  float* r = a.r + static_cast<size_t>(cb) * a.total_edges * z;

  for (int i = tid; i < 2 * a.total_edges; i += nt) s_edges[i] = a.edges[i];
  for (int i = tid; i <= a.nof_layers; i += nt) s_layer[i] = a.layer_off[i];
  for (int i = tid; i < a.ncols * z; i += nt) app[i] = 0.0f;
  for (int i = tid; i < a.total_edges * z; i += nt) r[i] = 0.0f;
  __syncthreads();

  // Circular-buffer assembly: plane b, element j is llr[j*qm + b]; copy
  // destinations are disjoint and skip the filler range.
  const int8_t* raw = a.llrs + static_cast<size_t>(cb) * a.e;
  for (int k = 0; k < a.nof_copies; ++k) {
    const int b = a.copies[4 * k];
    const int lo = a.copies[4 * k + 1];
    const int hi = a.copies[4 * k + 2];
    const int bs = a.copies[4 * k + 3];
    for (int t = tid; t < hi - lo; t += nt) {
      const float x = static_cast<float>(raw[static_cast<size_t>(lo + t) * a.qm + b]);
      app[2 * z + bs + t] = fminf(fmaxf(x, -kClamp), kClamp);
    }
  }
  for (int p = 2 * z + a.f_start + tid; p < 2 * z + a.f_end; p += nt) app[p] = kClamp;
  __syncthreads();

  const bool lane = tid < z;
  int it = 0;
  int unsatisfied = 1;
  while (it < a.nof_iterations && (!a.early_stop || unsatisfied)) {
    int odd_any = 0;
    for (int l = 0; l < a.nof_layers; ++l) {
      if (lane) {
        const int e0 = s_layer[l];
        const int deg = s_layer[l + 1] - e0;
        float v[kMaxRowDegree];
        float m1 = kBig;
        int hard_parity = 0;
        int neg_parity = 0;
        for (int j = 0; j < deg; ++j) {
          const int col = s_edges[2 * (e0 + j)];
          int zz = tid + s_edges[2 * (e0 + j) + 1];
          if (zz >= z) zz -= z;
          const float rot = app[col * z + zz];
          hard_parity ^= (rot < 0.0f);
          const float vj = __fsub_rn(rot, r[static_cast<size_t>(e0 + j) * z + tid]);
          v[j] = vj;
          neg_parity ^= (vj < 0.0f);
          m1 = fminf(m1, fabsf(vj));
        }
        float m2 = kBig;
        int nof_min = 0;
        for (int j = 0; j < deg; ++j) {
          const float aj = fabsf(v[j]);
          if (aj == m1) {
            ++nof_min;
          } else {
            m2 = fminf(m2, aj);
          }
        }
        // Duplicate minima: the second-smallest equals the smallest.
        if (nof_min > 1 || m2 >= kBig) m2 = m1;
        for (int j = 0; j < deg; ++j) {
          const float mag = (fabsf(v[j]) == m1) ? m2 : m1;
          // Sign over the other edges = total parity xor own sign.
          const bool neg_others = (neg_parity != 0) != (v[j] < 0.0f);
          const float rn = __fmul_rn(neg_others ? -kScaling : kScaling, mag);
          r[static_cast<size_t>(e0 + j) * z + tid] = rn;
          const int col = s_edges[2 * (e0 + j)];
          int zz = tid + s_edges[2 * (e0 + j) + 1];
          if (zz >= z) zz -= z;
          app[col * z + zz] = __fadd_rn(v[j], rn);
        }
        odd_any |= hard_parity;
      }
      __syncthreads();
    }
    ++it;
    if (a.early_stop) unsatisfied = __syncthreads_or(odd_any);
  }

  uint8_t* out = a.bits + static_cast<size_t>(cb) * a.kb * z;
  for (int p = tid; p < a.kb * z; p += nt) out[p] = app[p] < 0.0f ? 1 : 0;
  if (tid == 0) a.iters[cb] = it;
}

}  // namespace

extern "C" int ldpc_decode_dematch(const void* llrs, int c, int e, int qm,
                                   const void* copies, int nof_copies,
                                   int f_start, int f_end,
                                   const void* edges, const void* layer_off,
                                   int nof_layers, int total_edges,
                                   int z, int ncols, int kb,
                                   int nof_iterations, int early_stop,
                                   void* r, void* bits, void* iters,
                                   void* stream) {
  Args a;
  a.llrs = static_cast<const int8_t*>(llrs);
  a.e = e;
  a.qm = qm;
  a.copies = static_cast<const int*>(copies);
  a.nof_copies = nof_copies;
  a.f_start = f_start;
  a.f_end = f_end;
  a.edges = static_cast<const int*>(edges);
  a.layer_off = static_cast<const int*>(layer_off);
  a.nof_layers = nof_layers;
  a.total_edges = total_edges;
  a.z = z;
  a.ncols = ncols;
  a.kb = kb;
  a.nof_iterations = nof_iterations;
  a.early_stop = early_stop;
  a.r = static_cast<float*>(r);
  a.bits = static_cast<uint8_t*>(bits);
  a.iters = static_cast<int*>(iters);

  const int threads = ((z + 31) / 32) * 32;
  const size_t smem = sizeof(float) * static_cast<size_t>(ncols) * z +
                      sizeof(int) * (2 * static_cast<size_t>(total_edges) + nof_layers + 1);
  cudaError_t err = cudaFuncSetAttribute(
      decode_dematch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  decode_dematch_kernel<<<c, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
