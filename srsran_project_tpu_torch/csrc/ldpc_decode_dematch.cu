// K1: fused LDPC rate dematch + layered normalized min-sum decode.
//
// Replaces the TPU kernel decode_dematch_pallas
// (srsran_project_tpu/ops/ldpc/decoder_pallas.py: body _iteration_body,
// stop rule _run_iterations, copy plan _dematch_plane_plan).  Plain torch
// version and wrapper: srsran_project_tpu_torch/ops/ldpc/decoder.py
// (decode_dematch_groups, decode_dematch).  The layer loop, the exact
// compressed check messages, their storage and the numerics are in
// ldpc_layered.cuh, shared with K2.
//
// One launch covers every E-group of a batch of transport blocks: the
// grid is one block per codeblock, group after group, and a small table
// passed by value (at most kMaxGroups rows) gives each group its first
// block, its codeblocks per transport block, their first index inside the
// transport block, its copy plan and where and how to read its LLRs.
// Block o*per + i of a group is codeblock i of transport block o; it
// takes plane b, element j from llrs[o*s_outer + b*s_plane + i*s_inner +
// j*s_elem] and writes bits row o*cbs_per_tb + start + i.  So one kernel
// reads the (B, G) LLR stream (plane b, element j = stream[j*qm + b]) and
// the (B, qm, G/qm) plane layout that K4 writes, with no copy or
// transpose, and the output is already in transport-block order.  The
// circular buffer is assembled in shared memory from the group's static
// copy plan: punctured prefix and erasures read 0, fillers +64, copies
// are clamped to +-64.
//
// What bounds it on the H100 (ldpc_layered.cuh): the serial layer chain
// of each codeblock, not memory.  At the flagship (16 LBRM rows, Z = 384,
// 38 a-posteriori columns) a block takes 59,760 bytes of shared memory and
// the check-message state sits in global records, so two 384-thread blocks
// per SM: a slot's 141 codeblocks fit the 132 SMs in one wave, batch 8
// takes about 4.3.  ptxas (-Xptxas -v, printed by chip_smoke.py): 63
// registers, no spills (H100 build, sm_90a).

#include "ldpc_layered.cuh"

namespace {

constexpr int kMaxGroups = 2;  // a TB has at most two distinct E (TS 38.212 5.4.2.1)

struct Group {
  const int8_t* llrs;  // element (0, 0, 0, 0) of the group's view
  long long s_outer, s_plane, s_inner, s_elem;
  int blk0;       // first block of the group
  int per;        // codeblocks per transport block
  int start;      // index of its first codeblock inside a transport block
  int copy_off;   // first row of its copy plan
  int nof_copies;
};

struct Args {
  Group groups[kMaxGroups];
  int nof_groups;
  int cbs_per_tb;
  const int* copies;  // (rows, 4): plane b, lo, hi, buffer start
  int f_start;  // filler range [f_start, f_end), buffer coordinates
  int f_end;
  ldpc::Graph g;
  int nof_iterations;
  int early_stop;
  int4* rec;      // (blocks, L, Z) check-message state records
  uint8_t* bits;  // (B * cbs_per_tb, kb * Z)
  int* iters;     // (B * cbs_per_tb,)
};

__global__ void decode_dematch_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* app = reinterpret_cast<float*>(smem + ldpc::app_offset(a.g));
  const int blk = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int z = a.g.z;
  Group grp = a.groups[0];
#pragma unroll
  for (int k = 1; k < kMaxGroups; ++k)
    if (k < a.nof_groups && blk >= a.groups[k].blk0) grp = a.groups[k];
  const int local = blk - grp.blk0;
  const int o = local / grp.per;
  const int i = local % grp.per;
  const int row = o * a.cbs_per_tb + grp.start + i;
  const int2* s_edges = ldpc::setup(a.g, smem, app);

  // Circular-buffer assembly; copy destinations are disjoint and skip the
  // filler range.
  const int8_t* raw = grp.llrs + o * grp.s_outer + i * grp.s_inner;
  const int* copies = a.copies + 4 * grp.copy_off;
  for (int k = 0; k < grp.nof_copies; ++k) {
    const int b = copies[4 * k];
    const int lo = copies[4 * k + 1];
    const int hi = copies[4 * k + 2];
    const int bs = copies[4 * k + 3];
    const int8_t* plane = raw + b * grp.s_plane;
    for (int t = tid; t < hi - lo; t += nt) {
      const float x = static_cast<float>(plane[(lo + t) * grp.s_elem]);
      app[2 * z + bs + t] = fminf(fmaxf(x, -ldpc::kClamp), ldpc::kClamp);
    }
  }
  for (int p = 2 * z + a.f_start + tid; p < 2 * z + a.f_end; p += nt) app[p] = ldpc::kClamp;
  __syncthreads();

  const ldpc::GlobalState st = {a.rec + static_cast<size_t>(blk) * a.g.nof_layers * z, z};
  const int it = ldpc::layered_min_sum(a.g, s_edges, app, st, a.nof_iterations, a.early_stop);

  uint8_t* out = a.bits + static_cast<size_t>(row) * a.g.kb * z;
  for (int p = tid; p < a.g.kb * z; p += nt) out[p] = app[p] < 0.0f ? 1 : 0;
  if (tid == 0) a.iters[row] = it;
}

Args make_args(const long long* groups, int nof_groups, int cbs_per_tb, const void* copies,
               int f_start, int f_end, const void* edges, const void* layer_off, int nof_layers,
               int total_edges, int z, int ncols, int kb, int nof_iterations, int early_stop,
               void* rec, void* bits, void* iters) {
  Args a = {};
  for (int k = 0; k < nof_groups; ++k) {
    const long long* r = groups + 10 * k;
    a.groups[k] = {reinterpret_cast<const int8_t*>(r[0]), r[1], r[2], r[3], r[4],
                   static_cast<int>(r[5]), static_cast<int>(r[6]), static_cast<int>(r[7]),
                   static_cast<int>(r[8]), static_cast<int>(r[9])};
  }
  a.nof_groups = nof_groups;
  a.cbs_per_tb = cbs_per_tb;
  a.copies = static_cast<const int*>(copies);
  a.f_start = f_start;
  a.f_end = f_end;
  a.g = {static_cast<const int*>(edges), static_cast<const int*>(layer_off), nof_layers,
         total_edges, z, ncols, kb};
  a.nof_iterations = nof_iterations;
  a.early_stop = early_stop;
  a.rec = static_cast<int4*>(rec);
  a.bits = static_cast<uint8_t*>(bits);
  a.iters = static_cast<int*>(iters);
  return a;
}

}  // namespace

// groups: (nof_groups, 10) int64 rows on the host: llrs address, the four
// strides, first block, codeblocks per TB, first codeblock in the TB,
// copy-plan row, copy-plan length.  rec: the (blocks, L, Z) state
// scratch, 16 bytes a record.  Returns a CUDA error code.
extern "C" int ldpc_decode_dematch(const long long* groups, int nof_groups, int nof_blocks,
                                   int cbs_per_tb, const void* copies, int f_start, int f_end,
                                   const void* edges, const void* layer_off, int nof_layers,
                                   int total_edges, int z, int ncols, int kb,
                                   int nof_iterations, int early_stop, void* rec, void* bits,
                                   void* iters, void* stream) {
  if (nof_groups < 1 || nof_groups > kMaxGroups) return static_cast<int>(cudaErrorInvalidValue);
  const Args a = make_args(groups, nof_groups, cbs_per_tb, copies, f_start, f_end, edges,
                           layer_off, nof_layers, total_edges, z, ncols, kb, nof_iterations,
                           early_stop, rec, bits, iters);
  return ldpc::launch(decode_dematch_kernel, a, a.g, nof_blocks, stream);
}

// Resident blocks per SM of the kernel for this graph.
extern "C" int ldpc_decode_dematch_blocks_per_sm(int nof_layers, int total_edges, int z,
                                                 int ncols, int* blocks) {
  const ldpc::Graph g = {nullptr, nullptr, nof_layers, total_edges, z, ncols, 0};
  return ldpc::blocks_per_sm(decode_dematch_kernel, g, blocks);
}
