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
// Check messages, compressed and exact.  Thread z owns check row z of
// every layer, and for each (layer, z) keeps only what rebuilds the row's
// extrinsic messages R bit for bit: the smallest and second-smallest input
// magnitudes m1 and m2 (f32, after the duplicate-minimum rule) and one
// word holding the sign of every outgoing message (bit j, degree <= 27)
// and the first index of the minimum (bits 27-31).  The old message of
// edge j is then r_j = +-0.8 * (j == argmin ? m2 : m1), rounded (the sign
// flips the rounded product exactly).  The initial state m1 = m2 = 0 with
// no sign bit gives +0.0, as a zeroed R does.  Per layer, a thread runs
// two passes over the row's edges and keeps no per-edge message or v:
// the first rebuilds r_j, forms v_j = APP - r_j and keeps the running two
// smallest |v| (duplicates counted: a duplicated minimum leaves m2 == m1,
// so every edge gets m1), the first argmin, the signs (v < 0, never
// signbit: -0.0 counts as non-negative) and the hard-decision parity; the
// second recomputes v_j the same way (only this thread touches those APP
// positions in this layer) and writes APP = (+-0.8) * mag + v.  Each row
// degree of BG1 and BG2 (3-10, 19; the wrapper's plan admits no other)
// has its own unrolled instance, update_row<D>.
//
// Where the state lives: one 16-byte record per (layer, z) in a global
// scratch, loaded one layer ahead into registers while the current layer
// computes and stored once after it: one coalesced load and store per
// layer and thread, held by the 50 MB L2 (a flagship slot's 141
// codeblocks: 14 MB).  Nothing is zeroed: iteration 0 starts from the
// initial state in registers, and a record is read only after this
// thread wrote it.  Shared memory holds only the graph and the
// a-posteriori state, so a 384-thread block at the flagship (16 LBRM
// rows) takes 59,760 bytes and registers allow two per SM.  Why not keep
// the state in shared memory where it fits: at the flagship it would take
// 133,488 bytes, so one block per SM, and measured 10 % slower on an H100
// (PERF.md section 6).
//
// What bounds it: instruction issue on the serial layer chain of each
// codeblock (164 edges an iteration at the flagship, each one edge-table
// and one APP read, one APP write and some 25 integer and float
// instructions per thread), the barrier per layer, and the warps in
// flight: one block per codeblock, 12 warps of a 384-thread block, two
// blocks per SM at Z = 384 (cudaOccupancyMaxActiveBlocksPerMultiprocessor,
// bound by the registers), so a slot's 141 codeblocks fit the 132 SMs in
// one wave.  Not memory: a block reads its 4-16 KB of LLRs once.  On an
// H100 80GB HBM3 at 700 W, ptxas gave 63 (K1) and 71 (K2) registers and
// no spills, and one flagship slot took about 0.10 ms of device time,
// some 27x its float32-operation bound (PERF.md section 6 keeps the runs).

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

constexpr int kArgShift = 27;  // the argmin's bits above the signs of up to 27 edges
constexpr float kScaling = 0.8f;
constexpr float kClamp = 64.0f;
constexpr float kBig = 3.0e38f;
constexpr size_t kMaxSharedBytes = 232448;  // a block's limit on sm_90

// The graph of the active check rows, as both kernels receive it.
struct Graph {
  const int* edges;      // (total_edges, 2): column * Z, shift
  const int* layer_off;  // (nof_layers + 1,) edge offsets per check row
  int nof_layers;
  int total_edges;
  int z;
  int ncols;  // a-posteriori columns held in shared memory
  int kb;
};

__host__ __device__ inline size_t round16(size_t n) { return (n + 15) & ~static_cast<size_t>(15); }

// Dynamic shared memory, in this order: the edge table (8 bytes an
// edge), the layer offsets, then the a-posteriori state.  Mirrored by
// decoder.LayeredPlan.shared_bytes.
__host__ __device__ inline size_t app_offset(const Graph& g) {
  return round16(8 * static_cast<size_t>(g.total_edges) + 4 * (static_cast<size_t>(g.nof_layers) + 1));
}

__host__ __device__ inline size_t shared_bytes(const Graph& g) {
  return app_offset(g) + round16(4 * static_cast<size_t>(g.ncols) * g.z);
}

// The exact check-message state of one check row.
struct RowState {
  float m1;
  float m2;
  uint32_t w;  // bit j: r_j < 0; bits 27-31: the first index of the minimum
};

// This codeblock's (layer, z) 16-byte state records in global memory.
struct GlobalState {
  int4* rec;
  int z;
  __device__ RowState load(int l, int t) const {
    const int4 v = rec[l * z + t];
    return {__int_as_float(v.x), __int_as_float(v.y), static_cast<uint32_t>(v.z)};
  }
  __device__ void store(int l, int t, const RowState& s) const {
    rec[l * z + t] = make_int4(__float_as_int(s.m1), __float_as_int(s.m2), static_cast<int>(s.w), 0);
  }
};

// Copies the graph into shared memory and zeroes the a-posteriori state;
// returns the shared edge table (the layer offsets follow it).  Ends with
// a barrier.
__device__ inline const int2* setup(const Graph& g, unsigned char* smem, float* app) {
  int* s_edges = reinterpret_cast<int*>(smem);
  int* s_layer = s_edges + 2 * g.total_edges;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  for (int i = tid; i < 2 * g.total_edges; i += nt) s_edges[i] = g.edges[i];
  for (int i = tid; i <= g.nof_layers; i += nt) s_layer[i] = g.layer_off[i];
  for (int i = tid; i < g.ncols * g.z; i += nt) app[i] = 0.0f;
  __syncthreads();
  return reinterpret_cast<const int2*>(s_edges);
}

// The old message of edge j, rebuilt from the state: a1 = 0.8 * m1 and
// a2 = 0.8 * m2 rounded, the sign from bit j of w.
__device__ __forceinline__ float old_message(const RowState& s, float a1, float a2, int j) {
  const float mag = j == static_cast<int>(s.w >> kArgShift) ? a2 : a1;
  return __uint_as_float(__float_as_uint(mag) ^ ((s.w << (31 - j)) & 0x80000000u));
}

// One check row of one layer for this thread: the two passes, from the
// row's old state to its new one.  With the degree a compile-time
// constant both passes unroll, so every j is a constant, the row's loads
// issue together, and the first pass's APP positions and values stay in
// registers (arrays indexed by constants only), from which the second
// pass recomputes v_j with no shared-memory read between its stores.
template <int kDeg>
__device__ __forceinline__ RowState update_row(const int2* __restrict__ edges, int tid, int z,
                                               float* __restrict__ app, const RowState& old,
                                               int& hard_parity) {
  int pos[kDeg];
  float rots[kDeg];
  const float a1 = __fmul_rn(kScaling, old.m1);
  const float a2 = __fmul_rn(kScaling, old.m2);
  float m1 = kBig;
  float m2 = kBig;
  int arg = 0;
  uint32_t neg = 0;
#pragma unroll
  for (int j = 0; j < kDeg; ++j) {
    const int2 e = edges[j];
    int zz = tid + e.y;
    if (zz >= z) zz -= z;
    pos[j] = e.x + zz;
    rots[j] = app[pos[j]];
    hard_parity ^= (rots[j] < 0.0f);
    const float v = __fsub_rn(rots[j], old_message(old, a1, a2, j));
    neg |= static_cast<uint32_t>(v < 0.0f) << j;
    const float a = fabsf(v);
    m2 = fminf(m2, fmaxf(m1, a));  // the two smallest, duplicates counted
    if (a < m1) arg = j;
    m1 = fminf(m1, a);
  }
  // A single edge (no second magnitude): every message takes m1.
  if (m2 >= kBig) m2 = m1;
  // Sign over the other edges = total parity xor own sign.
  const uint32_t sgn = (__popc(neg) & 1) ? (~neg & ((1u << kDeg) - 1u)) : neg;
#pragma unroll
  for (int j = 0; j < kDeg; ++j) {
    const float v = __fsub_rn(rots[j], old_message(old, a1, a2, j));
    const float sign = ((sgn >> j) & 1u) ? -kScaling : kScaling;
    app[pos[j]] = __fmaf_rn(sign, j == arg ? m2 : m1, v);
  }
  return {m1, m2, sgn | (static_cast<uint32_t>(arg) << kArgShift)};
}

// Runs the iterations on the assembled a-posteriori state in shared memory
// and returns how many ran.  Every thread of the block must call it.
__device__ inline int layered_min_sum(const Graph& g, const int2* s_edges, float* app,
                                      const GlobalState& st, int nof_iterations, int early_stop) {
  const int* s_layer = reinterpret_cast<const int*>(s_edges + g.total_edges);
  const int tid = threadIdx.x;
  const int z = g.z;
  const int nl = g.nof_layers;
  const bool lane = tid < z;
  const RowState initial = {0.0f, 0.0f, 0u};
  RowState next = initial;  // layer 0's state on entry to iteration 0
  int it = 0;
  int unsatisfied = 1;
  while (it < nof_iterations && (!early_stop || unsatisfied)) {
    int odd_any = 0;
    for (int l = 0; l < nl; ++l) {
      if (lane) {
        const RowState old = next;
        // Fetch the state the next layer starts from (the next iteration's
        // layer 0 after the last layer): this thread wrote it earlier.
        const bool wrap = l + 1 == nl;
        next = (it > 0 || wrap) ? st.load(wrap ? 0 : l + 1, tid) : initial;

        const int e0 = s_layer[l];
        const int deg = s_layer[l + 1] - e0;
        const int2* edges = s_edges + e0;
        int hard_parity = 0;
        RowState row;
        switch (deg) {  // decoder.ROW_DEGREES
#define LDPC_ROW(D)                                                \
  case D:                                                          \
    row = update_row<D>(edges, tid, z, app, old, hard_parity);    \
    break;
          LDPC_ROW(3) LDPC_ROW(4) LDPC_ROW(5) LDPC_ROW(6) LDPC_ROW(7) LDPC_ROW(8)
          LDPC_ROW(9) LDPC_ROW(10) LDPC_ROW(19)
#undef LDPC_ROW
          default:
            __trap();  // the plan admits no other degree
        }
        st.store(l, tid, row);
        odd_any |= hard_parity;
      }
      __syncthreads();
    }
    ++it;
    if (early_stop) unsatisfied = __syncthreads_or(odd_any);
  }
  return it;
}

// Sets a kernel's dynamic shared memory and launches it: nof_blocks
// blocks, Z rounded up to a warp threads.  A refused launch returns its
// CUDA error code; so does a layout above the card's limit.
template <typename Kernel, typename Args>
int launch(Kernel kernel, const Args& a, const Graph& g, int nof_blocks, void* stream) {
  const int threads = ((g.z + 31) / 32) * 32;
  const size_t smem = shared_bytes(g);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<nof_blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Resident blocks per SM for the launch configuration above.
template <typename Kernel>
int blocks_per_sm(Kernel kernel, const Graph& g, int* blocks) {
  const int threads = ((g.z + 31) / 32) * 32;
  const size_t smem = shared_bytes(g);
  if (smem > kMaxSharedBytes) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kernel, threads, smem));
}

}  // namespace ldpc
