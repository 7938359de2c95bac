// K4: MMSE apply + closed-form max-log demap + int8 quantize + descramble,
// written straight into the LDPC decoder's de-interleave bit-planes.
//
// Replaces the TPU kernel demap_planes_pallas
// (srsran_project_tpu/ops/demap_pallas.py).  Plain torch version and
// wrapper: srsran_project_tpu_torch/ops/demap_planes.py (demap_planes).
//
// Design.  One thread per (slot b, data symbol s, subcarrier n) handles the
// L layers of that subcarrier.  The grid is (subcarrier blocks, data
// symbols, slots), so a thread finds its indices without any division, and
// offsets inside a slot are 32-bit.  (A thread that walked several symbols
// of its subcarrier, keeping its weights in L1, was timed on an H100 and
// lost at one slot; see PERF.md.)  The thread loads the P
// values of y once (neighbouring threads, neighbouring subcarriers:
// coalesced), the subcarrier's L x P weights (as float4 pairs when P is
// even) and L noise values once, forms x_l = sum_p w[l][p] y[p] for every
// layer, evaluates per axis the squared distances to the PAM levels and the
// min tree of each bit label, and quantizes each LLR.  The constellation is
// a template parameter:
// its PAM levels and Gray labels are compile-time tables (Pam<M> in
// demap_common.cuh, shared with K5), so
// every min tree unrolls into a fixed sequence of fminf, as the TPU kernel
// unrolls them over Python constants.  It descrambles from the Gold
// sequence c itself (uint8, stream order): plane bit t of lane j = (s*nsc +
// n)*L + l is flipped where c[j*qm + t] is 1, and a subcarrier's L*qm bits
// are contiguous in c, read with the widest aligned vector loads.  Negating
// q equals the plain version's multiply by -1 exactly (|q| <= 120).  It
// stores each plane's L int8 values as one word when L = 4 (a half word at
// L = 2), and the lanes' squared distances to the nearest point (for the
// decision-directed SINR) as one float4 when L = 4.
//
// What bounds it: memory.  Per subcarrier and symbol it reads 8P bytes of y,
// 8LP of weights and 4L of noise (both from cache after the first symbol) and L*qm
// Gold bytes, and writes L*qm plane bytes and 4L of err2.  The arithmetic
// is not small beside that: at 256QAM each axis of a lane takes 16
// subtractions, 16 squares and 57 fminf for its distances and min trees.
//
// Numerics (bit-exact with the plain version): every multiply and add is
// rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, and the library is
// built with --fmad=false), in the plain version's order; 1/eq_nvar is an
// IEEE division; rintf rounds half to even as torch.round does; fminf over
// non-negative squares is exact and does not depend on the order.

#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "demap_common.cuh"

namespace {

using demap::axis_llrs;
using demap::GoldBits;
using demap::load_lanes;
using demap::store_lanes;

constexpr float kLlrMax = 120.0f;
constexpr int kThreads = 128;
constexpr int kMaxGrid = 65535;  // largest gridDim.y and gridDim.z

struct Args {
  const float2* y;        // (B, P, nsym, nsc) complex64
  const float2* w;        // (B, nsc, L, P) complex64
  const float* eq_nvar;   // (B, nsc, L)
  const uint8_t* c;       // (B, nsym * nsc * L * qm) Gold bits, stream order
  int batch, p, nsym, nsc;
  float scale;            // LLR_MAX / range_limit
  int8_t* planes;         // (B, qm, nsym * nsc * L)
  float* err2;            // (B, nsym, nsc * L)
};

// x += w y as the plain version forms it: port 0 sets x, later ports add
// each part's two products in turn.
__device__ __forceinline__ void apply_port(float& xr, float& xi, float2 wv, float2 yv,
                                           bool first) {
  if (first) {
    xr = __fsub_rn(__fmul_rn(wv.x, yv.x), __fmul_rn(wv.y, yv.y));
    xi = __fadd_rn(__fmul_rn(wv.x, yv.y), __fmul_rn(wv.y, yv.x));
  } else {
    xr = __fsub_rn(__fadd_rn(xr, __fmul_rn(wv.x, yv.x)), __fmul_rn(wv.y, yv.y));
    xi = __fadd_rn(__fadd_rn(xi, __fmul_rn(wv.x, yv.y)), __fmul_rn(wv.y, yv.x));
  }
}

// The L int8 values of one plane, byte l of `packed` for layer l.
template <int L>
__device__ __forceinline__ void store_bytes(int8_t* dst, uint32_t packed) {
  if constexpr (L == 4) {
    *reinterpret_cast<uint32_t*>(dst) = packed;
  } else if constexpr (L == 2) {
    *reinterpret_cast<uint16_t*>(dst) = static_cast<uint16_t>(packed);
  } else {
#pragma unroll
    for (int l = 0; l < L; ++l) dst[l] = static_cast<int8_t>(packed >> (8 * l));
  }
}

template <int M, int L>
__global__ void __launch_bounds__(kThreads) demap_planes_kernel(Args a) {
  constexpr int kQm = 2 * M;
  const int n = blockIdx.x * kThreads + threadIdx.x;
  if (n >= a.nsc) return;
  const int np = a.p, nsc = a.nsc;
  const int y_port = a.nsym * nsc;
  const int plane_len = a.nsym * nsc * L;
  const int s = blockIdx.y;
  const int row = s * nsc + n;  // (symbol, subcarrier) in the slot
  for (int b = blockIdx.z; b < a.batch; b += gridDim.z) {
    // Slot bases in 64 bits, offsets inside a slot in 32.
    const size_t sc = static_cast<size_t>(b) * nsc + n;
    const float2* y = a.y + static_cast<size_t>(b) * np * y_port + s * nsc + n;
    const float2* w = a.w + sc * L * np;
    const uint8_t* cb = a.c + static_cast<size_t>(b) * plane_len * kQm;
    int8_t* out = a.planes + static_cast<size_t>(b) * kQm * plane_len;
    float* err2 = a.err2 + static_cast<size_t>(b) * plane_len;
    float inv[L];
    load_lanes<L>(a.eq_nvar + sc * L, inv);
#pragma unroll
    for (int l = 0; l < L; ++l) inv[l] = 1.0f / fmaxf(inv[l], 1e-12f);

    float xr[L], xi[L];
#pragma unroll
    for (int l = 0; l < L; ++l) xr[l] = xi[l] = 0.0f;
    if ((np & 1) == 0) {
      // An even P puts each pair of ports of a layer on 16 aligned bytes.
      const float4* w4 = reinterpret_cast<const float4*>(w);
      for (int p = 0; p < np; p += 2) {
        const float2 y0 = y[p * y_port], y1 = y[(p + 1) * y_port];
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float4 wv = w4[(l * np + p) / 2];
          apply_port(xr[l], xi[l], make_float2(wv.x, wv.y), y0, p == 0);
          apply_port(xr[l], xi[l], make_float2(wv.z, wv.w), y1, false);
        }
      }
    } else {
      for (int p = 0; p < np; ++p) {
        const float2 yv = y[p * y_port];
#pragma unroll
        for (int l = 0; l < L; ++l) apply_port(xr[l], xi[l], w[l * np + p], yv, p == 0);
      }
    }

    const GoldBits<L * kQm> gold(cb + row * L * kQm);
    uint32_t packed[kQm];
#pragma unroll
    for (int t = 0; t < kQm; ++t) packed[t] = 0;
    float err[L];
#pragma unroll
    for (int l = 0; l < L; ++l) {
      float li[M], lq[M];
      err[l] = __fadd_rn(axis_llrs<M>(xr[l], li), axis_llrs<M>(xi[l], lq));
#pragma unroll
      for (int bit = 0; bit < kQm; ++bit) {
        const float llr = bit & 1 ? lq[bit / 2] : li[bit / 2];
        float q = rintf(__fmul_rn(__fmul_rn(llr, inv[l]), a.scale));
        q = fminf(fmaxf(q, -kLlrMax), kLlrMax);
        if (gold(l * kQm + bit)) q = -q;
        packed[bit] |= static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)))
                       << (8 * l);
      }
    }
#pragma unroll
    for (int bit = 0; bit < kQm; ++bit) {
      store_bytes<L>(out + bit * plane_len + row * L, packed[bit]);
    }
    store_lanes<L>(err2 + row * L, err);
  }
}

using Kernel = void (*)(Args);

// The instance for (qm, L), or nullptr.
Kernel pick(int qm, int l) {
  static const Kernel kTable[4][4] = {
      {demap_planes_kernel<1, 1>, demap_planes_kernel<1, 2>, demap_planes_kernel<1, 3>,
       demap_planes_kernel<1, 4>},
      {demap_planes_kernel<2, 1>, demap_planes_kernel<2, 2>, demap_planes_kernel<2, 3>,
       demap_planes_kernel<2, 4>},
      {demap_planes_kernel<3, 1>, demap_planes_kernel<3, 2>, demap_planes_kernel<3, 3>,
       demap_planes_kernel<3, 4>},
      {demap_planes_kernel<4, 1>, demap_planes_kernel<4, 2>, demap_planes_kernel<4, 3>,
       demap_planes_kernel<4, 4>}};
  if (qm < 2 || qm > 8 || qm % 2 || l < 1 || l > 4) return nullptr;
  return kTable[qm / 2 - 1][l - 1];
}

}  // namespace

extern "C" int demap_planes(const void* y, const void* w, const void* eq_nvar, const void* c,
                            int batch, int p, int nsym, int nsc, int l, int qm, float scale,
                            void* planes, void* err2, void* stream) {
  const Kernel kernel = pick(qm, l);
  if (kernel == nullptr || nsym < 1 || nsym > kMaxGrid) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.y = static_cast<const float2*>(y);
  a.w = static_cast<const float2*>(w);
  a.eq_nvar = static_cast<const float*>(eq_nvar);
  a.c = static_cast<const uint8_t*>(c);
  a.batch = batch;
  a.p = p;
  a.nsym = nsym;
  a.nsc = nsc;
  a.scale = scale;
  a.planes = static_cast<int8_t*>(planes);
  a.err2 = static_cast<float*>(err2);
  const dim3 grid((nsc + kThreads - 1) / kThreads, nsym,
                  batch < kMaxGrid ? batch : kMaxGrid);
  void* args[] = {&a};
  return static_cast<int>(cudaLaunchKernel(reinterpret_cast<const void*>(kernel), grid,
                                           dim3(kThreads), args, 0,
                                           static_cast<cudaStream_t>(stream)));
}

// Registers a thread and resident blocks per SM of the (qm, L) instance.
extern "C" int demap_planes_occupancy(int qm, int l, int* registers, int* blocks) {
  const Kernel kernel = pick(qm, l);
  if (kernel == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(kernel), kThreads, 0));
}
