// K2: layered normalized min-sum decode of rate-dematched codeword buffers.
//
// Replaces the TPU kernel decode_pallas
// (srsran_project_tpu/ops/ldpc/decoder_pallas.py).  Plain torch version
// and wrapper: srsran_project_tpu_torch/ops/ldpc/decoder.py (decode).  It
// carries the HARQ, repetition and multi-UE decodes (phy/sch.py two-stage
// path, phy/ul_slot._decode_group).  The layer loop, the exact compressed
// check messages, their storage and the numerics are in ldpc_layered.cuh,
// shared with K1.
//
// Input: one row of int8 or f32 LLRs per codeblock (the buffer without the
// punctured 2Z prefix); the first width_in of them are clamped to +-64
// behind a zero prefix.  With an LBRM n_cb only the rows that reach the
// message bits run (the wrapper's plan), so ncols may be below the graph's
// n.  Output: the hard message bits, or the whole a-posteriori row of n*Z
// f32 with the columns the truncated graph leaves out at 0.
//
// The check-message state sits in one 16-byte record per (layer, z) in a
// global scratch (ldpc_layered.cuh), about 282 KB a codeblock on the
// untruncated BG1 graph at Z = 384, so 23 MB for the 8-UE slot's 82
// codeblocks, held by the 50 MB L2.  Shared memory holds the graph and the
// a-posteriori state: 107 KB a block for group A (46 rows, Z = 384), 60 KB
// at the flagship.  What bounds it is the serial layer chain of each
// codeblock (46 layers, 316 edges an iteration on the full graph) and the
// SMs it leaves idle: 41-82 blocks for 132 SMs, whatever the 2 blocks per
// SM that group A's shared memory would allow.  ptxas (-Xptxas -v, printed
// by chip_smoke.py): 71 registers, no spills (H100 build, sm_90a).

#include "ldpc_layered.cuh"

namespace {

struct Args {
  const void* llrs;  // (C, row_stride) int8 or f32
  int in_f32;
  long long row_stride;
  int width_in;
  ldpc::Graph g;
  int n;  // a-posteriori output columns (of Z)
  int nof_iterations;
  int early_stop;
  int bits_only;
  int4* rec;   // (C, L, Z) check-message state records
  void* out;   // bits (C, kb * Z) uint8, or a-posteriori (C, n * Z) f32
  int* iters;  // (C,)
};

__global__ void decode_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* app = reinterpret_cast<float*>(smem + ldpc::app_offset(a.g));
  const int cb = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int z = a.g.z;
  const int2* s_edges = ldpc::setup(a.g, smem, app);

  if (a.in_f32) {
    const float* row = static_cast<const float*>(a.llrs) + cb * a.row_stride;
    for (int t = tid; t < a.width_in; t += nt)
      app[2 * z + t] = fminf(fmaxf(row[t], -ldpc::kClamp), ldpc::kClamp);
  } else {
    const int8_t* row = static_cast<const int8_t*>(a.llrs) + cb * a.row_stride;
    for (int t = tid; t < a.width_in; t += nt)
      app[2 * z + t] = fminf(fmaxf(static_cast<float>(row[t]), -ldpc::kClamp), ldpc::kClamp);
  }
  __syncthreads();

  const ldpc::GlobalState st = {a.rec + static_cast<size_t>(cb) * a.g.nof_layers * z, z};
  const int it = ldpc::layered_min_sum(a.g, s_edges, app, st, a.nof_iterations, a.early_stop);

  if (a.bits_only) {
    uint8_t* out = static_cast<uint8_t*>(a.out) + static_cast<size_t>(cb) * a.g.kb * z;
    for (int p = tid; p < a.g.kb * z; p += nt) out[p] = app[p] < 0.0f ? 1 : 0;
  } else {
    float* out = static_cast<float*>(a.out) + static_cast<size_t>(cb) * a.n * z;
    const int held = a.g.ncols * z;
    for (int p = tid; p < a.n * z; p += nt) out[p] = p < held ? app[p] : 0.0f;
  }
  if (tid == 0) a.iters[cb] = it;
}

}  // namespace

// rec: the (C, L, Z) state scratch, 16 bytes a record.  Returns a CUDA
// error code.
extern "C" int ldpc_decode(const void* llrs, int in_f32, int c, long long row_stride,
                           int width_in, const void* edges, const void* layer_off,
                           int nof_layers, int total_edges, int z, int ncols, int kb,
                           int n, int nof_iterations, int early_stop, int bits_only,
                           void* rec, void* out, void* iters, void* stream) {
  Args a;
  a.llrs = llrs;
  a.in_f32 = in_f32;
  a.row_stride = row_stride;
  a.width_in = width_in;
  a.g = {static_cast<const int*>(edges), static_cast<const int*>(layer_off), nof_layers,
         total_edges, z, ncols, kb};
  a.n = n;
  a.nof_iterations = nof_iterations;
  a.early_stop = early_stop;
  a.bits_only = bits_only;
  a.rec = static_cast<int4*>(rec);
  a.out = out;
  a.iters = static_cast<int*>(iters);
  return ldpc::launch(decode_kernel, a, a.g, c, stream);
}

// Resident blocks per SM of the kernel for this graph.
extern "C" int ldpc_decode_blocks_per_sm(int nof_layers, int total_edges, int z, int ncols,
                                         int* blocks) {
  const ldpc::Graph g = {nullptr, nullptr, nof_layers, total_edges, z, ncols, 0};
  return ldpc::blocks_per_sm(decode_kernel, g, blocks);
}
