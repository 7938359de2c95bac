// K1: fused LDPC rate dematch + layered normalized min-sum decode.
//
// Replaces the TPU kernel decode_dematch_pallas
// (srsran_project_tpu/ops/ldpc/decoder_pallas.py: body _iteration_body,
// stop rule _run_iterations, copy plan _dematch_plane_plan).  Plain torch
// version and wrapper: srsran_project_tpu_torch/ops/ldpc/decoder.py
// (decode_dematch).  The layer loop, its design, its bound on Hopper and
// its numerics are in ldpc_layered.cuh, shared with K2.
//
// What this kernel adds is the circular-buffer assembly in shared memory
// from the static copy plan, read through four strides: codeblock
// o*per + i takes plane b, element j from llrs[o*s_outer + b*s_plane +
// i*s_inner + j*s_elem].  The same kernel thus reads the (C, E) LLR stream
// (plane b, element j = stream[j*qm + b]) and the (B, qm, G/qm) plane
// layout that K4 writes, with no transpose between them.  Punctured prefix
// and erasures read 0, fillers +64, copies are clamped to +-64.

#include "ldpc_layered.cuh"

namespace {

struct Args {
  const int8_t* llrs;
  int per;  // codeblocks per outer index
  long long s_outer, s_plane, s_inner, s_elem;
  const int* copies;  // (nof_copies, 4): plane b, lo, hi, buffer start
  int nof_copies;
  int f_start;  // filler range [f_start, f_end), buffer coordinates
  int f_end;
  ldpc::Graph g;
  int nof_iterations;
  int early_stop;
  float* r;        // (C, total_edges * Z) scratch
  uint8_t* bits;   // (C, kb * Z)
  int* iters;      // (C,)
};

__global__ void decode_dematch_kernel(Args a) {
  extern __shared__ float smem[];
  float* app = smem;
  const int cb = blockIdx.x;
  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int z = a.g.z;
  float* r = a.r + static_cast<size_t>(cb) * a.g.total_edges * z;
  const int* s_edges = ldpc::setup(a.g, app, r);

  // Circular-buffer assembly; copy destinations are disjoint and skip the
  // filler range.
  const int8_t* raw = a.llrs + (cb / a.per) * a.s_outer + (cb % a.per) * a.s_inner;
  for (int k = 0; k < a.nof_copies; ++k) {
    const int b = a.copies[4 * k];
    const int lo = a.copies[4 * k + 1];
    const int hi = a.copies[4 * k + 2];
    const int bs = a.copies[4 * k + 3];
    const int8_t* plane = raw + b * a.s_plane;
    for (int t = tid; t < hi - lo; t += nt) {
      const float x = static_cast<float>(plane[(lo + t) * a.s_elem]);
      app[2 * z + bs + t] = fminf(fmaxf(x, -ldpc::kClamp), ldpc::kClamp);
    }
  }
  for (int p = 2 * z + a.f_start + tid; p < 2 * z + a.f_end; p += nt) app[p] = ldpc::kClamp;
  __syncthreads();

  const int it = ldpc::layered_min_sum(a.g, s_edges, app, r, a.nof_iterations, a.early_stop);

  uint8_t* out = a.bits + static_cast<size_t>(cb) * a.g.kb * z;
  for (int p = tid; p < a.g.kb * z; p += nt) out[p] = app[p] < 0.0f ? 1 : 0;
  if (tid == 0) a.iters[cb] = it;
}

}  // namespace

extern "C" int ldpc_decode_dematch(const void* llrs, int c, int per,
                                   long long s_outer, long long s_plane,
                                   long long s_inner, long long s_elem,
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
  a.per = per;
  a.s_outer = s_outer;
  a.s_plane = s_plane;
  a.s_inner = s_inner;
  a.s_elem = s_elem;
  a.copies = static_cast<const int*>(copies);
  a.nof_copies = nof_copies;
  a.f_start = f_start;
  a.f_end = f_end;
  a.g = {static_cast<const int*>(edges), static_cast<const int*>(layer_off), nof_layers,
         total_edges, z, ncols, kb};
  a.nof_iterations = nof_iterations;
  a.early_stop = early_stop;
  a.r = static_cast<float*>(r);
  a.bits = static_cast<uint8_t*>(bits);
  a.iters = static_cast<int*>(iters);
  return ldpc::launch(decode_dematch_kernel, a, a.g, c, stream);
}
