// The layered normalized min-sum iteration shared by K1
// (ldpc_decode_dematch.cu) and K2 (ldpc_decode.cu): the body of
// _iteration_body and the stop rule of _run_iterations in
// srsran_project_tpu/ops/ldpc/decoder_pallas.py.  Plain torch version:
// layered_min_sum in srsran_project_tpu_torch/ops/ldpc/decoder.py.
//
// One thread block decodes one codeblock, one thread per circulant row z
// (blockDim = Z rounded up to a warp).  The layered schedule is sequential
// by nature, so a codeblock cannot be split across blocks; the barrier
// between layers is __syncthreads().  For each edge (col, shift) of a
// check row, thread z owns a-posteriori position col*Z + (z + shift) mod Z;
// that map is a bijection per edge and a row touches each column once, so
// reads and write-backs inside a layer never collide between threads.
//
// The a-posteriori state lives in shared memory for the whole decode (at
// most 68 columns x 384 x 4 B = 104 KB for an untruncated BG1 graph).  The
// extrinsic messages R (one f32 per edge and z: up to 316 edges x 384 x
// 4 B = 485 KB per codeblock) do not fit beside it in the 227 KB a block
// may use, so R lives in a global scratch, read and written once per edge
// per iteration, coalesced along z.  With about one 384-thread block per
// SM the decode is latency-bound on the layer barriers and on R's round
// trips through L2.
//
// Numerics (bit-exact with the plain version and with the reference's
// Pallas kernel run through XLA on the CPU): f32 state; the update stores
// r = (+-0.8) * mag rounded (__fmul_rn) and writes the a-posteriori LLR as
// one fused multiply-add, (+-0.8) * mag + v rounded once (__fmaf_rn), as
// XLA contracts it.  The library is built with --fmad=false, so no other
// multiply and add fuse.
//
// Early stop is per codeblock: the block leaves the iteration loop after
// a whole iteration in which the on-the-fly layered syndrome (parity of
// the hard decisions entering each layer) saw every check satisfied.  The
// TPU kernels stop per batch tile of codeblocks instead.

#pragma once

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

namespace ldpc {

constexpr int kMaxRowDegree = 32;  // ops/ldpc/decoder.py MAX_ROW_DEGREE
constexpr float kScaling = 0.8f;
constexpr float kClamp = 64.0f;
constexpr float kBig = 3.0e38f;

// The graph of the active check rows, as both kernels receive it.
struct Graph {
  const int* edges;      // (total_edges, 2): column, shift
  const int* layer_off;  // (nof_layers + 1,) edge offsets per check row
  int nof_layers;
  int total_edges;
  int z;
  int ncols;  // a-posteriori columns held in shared memory
  int kb;
};

// Shared memory a block needs: the a-posteriori state, then the graph.
inline size_t shared_bytes(const Graph& g) {
  return sizeof(float) * static_cast<size_t>(g.ncols) * g.z +
         sizeof(int) * (2 * static_cast<size_t>(g.total_edges) + g.nof_layers + 1);
}

// Copies the graph into shared memory, zeroes the a-posteriori state and
// this codeblock's R, and returns the shared edge table (the layer offsets
// follow it).  Ends with a barrier.
__device__ inline int* setup(const Graph& g, float* app, float* r) {
  int* s_edges = reinterpret_cast<int*>(app + g.ncols * g.z);
  int* s_layer = s_edges + 2 * g.total_edges;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < 2 * g.total_edges; i += nt) s_edges[i] = g.edges[i];
  for (int i = tid; i <= g.nof_layers; i += nt) s_layer[i] = g.layer_off[i];
  for (int i = tid; i < g.ncols * g.z; i += nt) app[i] = 0.0f;
  for (int i = tid; i < g.total_edges * g.z; i += nt) r[i] = 0.0f;
  __syncthreads();
  return s_edges;
}

// Runs the iterations on the assembled a-posteriori state in shared memory
// and returns how many ran.  Every thread of the block must call it.
__device__ inline int layered_min_sum(const Graph& g, const int* s_edges, float* app,
                                      float* r, int nof_iterations, int early_stop) {
  const int* s_layer = s_edges + 2 * g.total_edges;
  const int tid = threadIdx.x;
  const int z = g.z;
  const bool lane = tid < z;
  int it = 0;
  int unsatisfied = 1;
  while (it < nof_iterations && (!early_stop || unsatisfied)) {
    int odd_any = 0;
    for (int l = 0; l < g.nof_layers; ++l) {
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
          const float sign = neg_others ? -kScaling : kScaling;
          r[static_cast<size_t>(e0 + j) * z + tid] = __fmul_rn(sign, mag);
          const int col = s_edges[2 * (e0 + j)];
          int zz = tid + s_edges[2 * (e0 + j) + 1];
          if (zz >= z) zz -= z;
          app[col * z + zz] = __fmaf_rn(sign, mag, v[j]);
        }
        odd_any |= hard_parity;
      }
      __syncthreads();
    }
    ++it;
    if (early_stop) unsatisfied = __syncthreads_or(odd_any);
  }
  return it;
}

// Sets a kernel's dynamic shared memory and launches it: one block per
// codeblock, Z rounded up to a warp threads.  Returns the CUDA error code.
template <typename Kernel, typename Args>
int launch(Kernel kernel, const Args& a, const Graph& g, int c, void* stream) {
  const int threads = ((g.z + 31) / 32) * 32;
  const size_t smem = shared_bytes(g);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<c, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ldpc
