// K6: every PUCCH format 2 occasion of a call received in one launch: the
// DM-RS channel estimate, MRC over the ports, QPSK max-log LLRs, the Gold
// sign flip and the UCI decode (the short-block ML detection for K <= 11,
// else the UL channel de-interleaver, the polar rate dematch, the SSC walk
// with the mod-5 parity-check accumulators and the CRC6 / CRC11 check).
//
// Plain torch version and wrapper: srsran_project_tpu_torch/ops/pucch_f2_rx.py
// (receive).  It replaces no TPU kernel: the JAX package leaves this chain
// to XLA.  It replaces the eager chain phy/pucch_f2.process ran an occasion
// at a time (ops/estimator.estimate_channel, demap_soft, uci.decode_uci
// with polar/decoder.decode walking the SSC tree node by node): about 340
// launches for a polar occasion and 117 for a Reed-Muller one, for some 6 KB
// of input a slot.
//
// What bounds it: latency.  An occasion reads at most 4 ports x 2 symbols x
// 16 PRB of the grid (12 KB) and its parameters, and its SSC walk is a
// chain of dependent steps (one __syncthreads each).  The design: one block
// of 256 threads an occasion, so every occasion of the call runs side by
// side; every intermediate (LS samples, pair values, smoothed channel, the
// LLRs and the polar LLR tree of at most 2 N = 1024 floats, partial sums,
// the short-block scores) stays in shared memory; the host flattens each
// occasion's plans (pilots, interpolation, Gold bits, dematch, the SSC walk
// as (op, lo, size) instructions, the short-block basis) into one int32
// buffer that is uploaded once per tuple of configurations.  Polar and
// Reed-Muller occasions, hopping or not, of any size, share the launch:
// each block reads its own geometry and code from its header.
//
// Numerics: the plain version's formulas in its order, every multiply and
// add rounded on its own (the library is built with --fmad=false).  The
// sums the plain version reduces with torch's own order (the slope, the
// noise and RSRP means, the MRC over ports, the short-block scores) run
// here in index order, and atan2f / cosf / sinf / log10f may differ from
// the host's in the last place, so the LLRs match to a few ulps and the
// SNR to about 1e-6 relative; the decisions on them (signs, minima, sums
// of the polar tree, the CRC) are exact.  Ties of the short-block scores
// go to the first maximum, as torch.argmax.  Every reduction runs in one
// fixed order, so the kernel is deterministic.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPorts = 4;
constexpr int kMaxSymbols = 2;
constexpr int kMaxRb = 16;
constexpr int kMaxPilots = 4 * kMaxRb;  // a symbol's DM-RS REs
constexpr int kMaxPairs = 2 * kMaxRb;
constexpr int kMaxE = 2 * 8 * kMaxRb * kMaxSymbols;  // QPSK bits on the data REs
constexpr int kMaxN = 512;
constexpr int kTaps = 9;
constexpr int kGlobalWords = 16;
constexpr int kHdrWords = 24;
constexpr float kQpskScale = 2.82842708f;  // float32(2 sqrt(2)), demap_soft's QPSK factor
constexpr float kShortBlockOk = 0.2f;       // uci.decode_uci's metric threshold

// Header words of an occasion (ops/pucch_f2_rx.py, H_*).
enum {
  H_NSC, H_SYM0, H_NSYM, H_RBS, H_RB0, H_RB1, H_HOP, H_PORTS, H_K, H_E, H_POLAR, H_N, H_REPS,
  H_CRC_LEN, H_CRC_POLY, H_NOPS, H_PILOTS, H_GOLD, H_INTERP, H_PROG, H_DEMATCH, H_INFO
};
// The SSC walk's instructions (ops/pucch_f2_rx.py, OP_*).
enum { OP_F, OP_G, OP_ZERO, OP_PC, OP_INFO, OP_RATE1, OP_COMBINE };
// The data REs of a PRB (k mod 3 != 1).
__constant__ int kDataRe[8] = {0, 2, 3, 5, 6, 8, 9, 11};

struct Args {
  const float2* grid;    // complex64, read as (P, numel / P) by an occasion of P ports
  long long grid_numel;  // complex elements
  const int* tab;        // the parameter buffer
  int k_max;
  uint8_t* bits;         // (O, k_max)
  uint8_t* ok;           // (O,) bool
  float* snr_db;         // (O,)
};

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
  return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 conj2(float2 a) { return make_float2(a.x, -a.y); }

// |z|^2 as torch's abs(z) ** 2.
__device__ __forceinline__ float abs2(float2 a) {
  const float m = sqrtf(a.x * a.x + a.y * a.y);
  return m * m;
}

__device__ __forceinline__ float sgn(float a) { return a > 0.0f ? 1.0f : (a < 0.0f ? -1.0f : 0.0f); }

__global__ void __launch_bounds__(kThreads) pucch_f2_rx_kernel(Args a) {
  const int o = blockIdx.x;
  const int tid = threadIdx.x;
  const int* tab = a.tab;
  const float* tabf = reinterpret_cast<const float*>(tab);
  const int* hd = tab + kGlobalWords + o * kHdrWords;
  const int nsc_grid = hd[H_NSC], sym0 = hd[H_SYM0], nsym = hd[H_NSYM], rbs = hd[H_RBS];
  const int rb_of[2] = {hd[H_RB0], hd[H_RB1]};
  const int ports = hd[H_PORTS], k = hd[H_K], e_bits = hd[H_E];
  const int np = 4 * rbs, npairs = 2 * rbs, nd = 8 * rbs * nsym;
  // A second hop estimates each symbol on its own; else both together.
  const int nest = hd[H_HOP] ? nsym : 1;
  const int sym_per_est = nsym / nest;
  const long long port_stride = a.grid_numel / ports;
  const float2* pilots = reinterpret_cast<const float2*>(tab + hd[H_PILOTS]);
  const uint32_t* gold = reinterpret_cast<const uint32_t*>(tab + hd[H_GOLD]);
  const int* interp = tab + hd[H_INTERP];  // per subcarrier: left, right, fraction, coordinate

  __shared__ float2 ls[kMaxPorts * kMaxSymbols * kMaxPilots];
  __shared__ float2 h_pair[kMaxPorts * kMaxSymbols * kMaxPairs];
  __shared__ float2 h_raw[kMaxPorts * kMaxSymbols * kMaxPairs];  // per (port, estimate)
  __shared__ float2 h_rot[kMaxPorts * kMaxSymbols * kMaxPairs];
  __shared__ float2 h_t[kMaxPorts * kMaxSymbols * kMaxPairs];
  __shared__ float slope[kMaxPorts * kMaxSymbols];
  __shared__ float nvar_e[kMaxPorts * kMaxSymbols];
  __shared__ float snr_e[kMaxPorts * kMaxSymbols];
  __shared__ float nvar_mean;
  __shared__ float llr[kMaxE];
  __shared__ float tree[2 * kMaxN];  // the SSC walk's LLRs: a node of size s at [s, 2s)
  __shared__ uint8_t part[kMaxN];    // partial sums X
  __shared__ uint8_t u[kMaxN];       // decided bits U
  __shared__ float red_score[kThreads];
  __shared__ int red_index[kThreads];
  __shared__ int acc;                // the five PC accumulators, bit r

  // 1. LS at the DM-RS: y * conj(pilot).
  for (int i = tid; i < ports * nsym * np; i += kThreads) {
    const int p = i / (nsym * np), s = (i / np) % nsym, j = i % np;
    const long long re = static_cast<long long>(sym0 + s) * nsc_grid
                         + (rb_of[s] + j / 4) * 12 + 1 + 3 * (j % 4);
    ls[i] = cmul(a.grid[p * port_stride + re], conj2(pilots[s * np + j]));
  }
  __syncthreads();
  // 2. Pair means.
  for (int i = tid; i < ports * nsym * npairs; i += kThreads) {
    const int row = i / npairs, q = i % npairs;
    const float2 x0 = ls[row * np + 2 * q], x1 = ls[row * np + 2 * q + 1];
    h_pair[i] = make_float2((x0.x + x1.x) * 0.5f, (x0.y + x1.y) * 0.5f);
  }
  __syncthreads();
  // 3. The time mean over an estimate's symbols.
  for (int i = tid; i < ports * nest * npairs; i += kThreads) {
    const int p = i / (nest * npairs), e = (i / npairs) % nest, q = i % npairs;
    if (sym_per_est == 2) {
      const float2 x0 = h_pair[(p * nsym) * npairs + q], x1 = h_pair[(p * nsym + 1) * npairs + q];
      h_raw[i] = make_float2((x0.x + x1.x) * 0.5f, (x0.y + x1.y) * 0.5f);
    } else {
      h_raw[i] = h_pair[(p * nsym + e) * npairs + q];
    }
  }
  __syncthreads();
  // 4. Per (port, estimate): the bulk-delay slope, the pilot-residual noise
  //    variance and the SNR (RSRP over it).
  if (tid < ports * nest) {
    const int p = tid / nest, e = tid % nest;
    const float2* h = h_raw + tid * npairs;
    float sl = 0.0f;
    if (npairs > 1) {
      float2 c = make_float2(0.0f, 0.0f);
      for (int q = 1; q < npairs; ++q) {
        const float2 t = cmul(h[q], conj2(h[q - 1]));
        c = make_float2(c.x + t.x, c.y + t.y);
      }
      sl = atan2f(c.y, c.x);
    }
    slope[tid] = sl;
    float noise = 0.0f, rsrp = 0.0f;
    for (int s = e * sym_per_est; s < (e + 1) * sym_per_est; ++s) {
      const int row = p * nsym + s;
      float pw = 0.0f;
      for (int j = 0; j < np; ++j) {
        const float2 x = ls[row * np + j], hp = h_pair[row * npairs + j / 2];
        noise += abs2(make_float2(x.x - hp.x, x.y - hp.y));
      }
      for (int q = 0; q < npairs; ++q) pw += abs2(h_pair[row * npairs + q]);
      rsrp += pw / static_cast<float>(npairs);
    }
    rsrp = rsrp / static_cast<float>(sym_per_est);
    const float nv = fmaxf(noise / static_cast<float>(sym_per_est * np) * 2.0f, 1e-10f);
    nvar_e[tid] = nv;
    snr_e[tid] = rsrp / nv;
  }
  __syncthreads();
  // 5. Derotation by the slope, then the 9-tap raised-cosine smoothing with
  //    the edges replicated (one pair: neither slope nor rotation).
  for (int i = tid; i < ports * nest * npairs; i += kThreads) {
    const int row = i / npairs, q = i % npairs;
    if (npairs > 1) {
      const float ph = -slope[row] * static_cast<float>(q);
      h_rot[i] = cmul(h_raw[i], make_float2(cosf(ph), sinf(ph)));
    } else {
      h_rot[i] = h_raw[i];
    }
  }
  __syncthreads();
  for (int i = tid; i < ports * nest * npairs; i += kThreads) {
    const int row = i / npairs, q = i % npairs;
    float2 c = make_float2(0.0f, 0.0f);
    for (int t = 0; t < kTaps; ++t) {
      const int src = min(max(q + t - kTaps / 2, 0), npairs - 1);
      const float2 v = h_rot[row * npairs + src];
      c = make_float2(c.x + tabf[t] * v.x, c.y + tabf[t] * v.y);
    }
    h_t[i] = c;
  }
  if (tid == 0) {
    // The noise variance a port: its estimates' mean; then over the ports.
    // The SNR: the last estimate's, over the ports.
    float nv_sum = 0.0f, snr_sum = 0.0f;
    for (int p = 0; p < ports; ++p) {
      const float nv = nest == 2 ? (nvar_e[p * 2] + nvar_e[p * 2 + 1]) * 0.5f : nvar_e[p];
      nv_sum += nv;
      snr_sum += snr_e[p * nest + nest - 1];
    }
    nvar_mean = nv_sum / static_cast<float>(ports);
    a.snr_db[o] = 10.0f * log10f(fmaxf(snr_sum / static_cast<float>(ports), 1e-12f));
  }
  __syncthreads();
  // 6. Per data RE: the channel interpolated and re-rotated at its
  //    subcarrier, MRC over the ports, the QPSK LLRs and the Gold sign flip.
  for (int d = tid; d < nd; d += kThreads) {
    const int s = d / (8 * rbs), j = d % (8 * rbs);
    const int sc = (j / 8) * 12 + kDataRe[j % 8];
    const int e = nest == 2 ? s : 0;
    const int li = interp[4 * sc], ri = interp[4 * sc + 1];
    const float fr = __int_as_float(interp[4 * sc + 2]), xc = __int_as_float(interp[4 * sc + 3]);
    const float w0 = 1.0f - fr;
    const long long re = static_cast<long long>(sym0 + s) * nsc_grid + rb_of[s] * 12 + sc;
    float den = 0.0f;
    float2 num = make_float2(0.0f, 0.0f);
    for (int p = 0; p < ports; ++p) {
      const int row = p * nest + e;
      const float2 h0 = h_t[row * npairs + li], h1 = h_t[row * npairs + ri];
      float2 h = make_float2(h0.x * w0 + h1.x * fr, h0.y * w0 + h1.y * fr);
      if (npairs > 1) {
        const float ph = slope[row] * xc;
        h = cmul(h, make_float2(cosf(ph), sinf(ph)));
      }
      den += abs2(h);
      const float2 t = cmul(conj2(h), a.grid[p * port_stride + re]);
      num = make_float2(num.x + t.x, num.y + t.y);
    }
    den = den + 1e-12f;
    const float eq_nvar = nvar_mean / den;
    const float xi = num.x / den, xq = num.y / den;
    float llr_i = (kQpskScale * xi) / eq_nvar, llr_q = (kQpskScale * xq) / eq_nvar;
    if ((gold[(2 * d) >> 5] >> ((2 * d) & 31)) & 1u) llr_i = -llr_i;
    if ((gold[(2 * d + 1) >> 5] >> ((2 * d + 1) & 31)) & 1u) llr_q = -llr_q;
    llr[2 * d] = llr_i;
    llr[2 * d + 1] = llr_q;
  }
  __syncthreads();

  uint8_t* bits_out = a.bits + static_cast<long long>(o) * a.k_max;
  if (!hd[H_POLAR]) {
    // Short block: fold the repetitions onto the mother codeword, score
    // every message by its codeword's correlation, take the first maximum.
    const int n = hd[H_N];
    const uint32_t* basis = reinterpret_cast<const uint32_t*>(tab + hd[H_PROG]);
    float* folded = tree;
    if (tid < n) {
      const int reps = (e_bits + n - 1) / n;
      float f = tid < e_bits ? llr[tid] : 0.0f;
      for (int r = 1; r < reps; ++r) {
        const int idx = r * n + tid;
        f = f + (idx < e_bits ? llr[idx] : 0.0f);
      }
      folded[tid] = f;
    }
    __syncthreads();
    float best = -INFINITY;
    int best_m = 0;
    for (int m = tid; m < (1 << k); m += kThreads) {
      uint32_t cw = 0;
      for (int t = 0; t < k; ++t) {
        if ((m >> t) & 1) cw ^= basis[t];
      }
      float score = 0.0f;
      for (int j = 0; j < n; ++j) score = score + ((cw >> j) & 1u ? -folded[j] : folded[j]);
      if (score > best) {
        best = score;
        best_m = m;
      }
    }
    red_score[tid] = best;
    red_index[tid] = best_m;
    __syncthreads();
    for (int w = kThreads / 2; w > 0; w >>= 1) {
      if (tid < w) {
        const float s1 = red_score[tid + w];
        const int m1 = red_index[tid + w];
        if (s1 > red_score[tid] || (s1 == red_score[tid] && m1 < red_index[tid])) {
          red_score[tid] = s1;
          red_index[tid] = m1;
        }
      }
      __syncthreads();
    }
    if (tid == 0) {
      float denom = 0.0f;
      for (int j = 0; j < n; ++j) denom += fabsf(folded[j]);
      denom = denom + 1e-9f;
      a.ok[o] = red_score[0] / denom > kShortBlockOk;
    }
    for (int t = tid; t < a.k_max; t += kThreads) {
      bits_out[t] = t < k ? static_cast<uint8_t>((red_index[0] >> t) & 1) : 0;
    }
    return;
  }

  // Polar: the de-interleaved, rate-dematched LLRs into the tree's root.
  const int nval = hd[H_N], reps = hd[H_REPS];
  const int* dematch = tab + hd[H_DEMATCH];
  for (int pos = tid; pos < nval; pos += kThreads) {
    const int i0 = dematch[pos];
    float v = i0 >= 0 ? llr[i0] : 0.0f;
    for (int r = 1; r < reps; ++r) {
      const int i = dematch[r * nval + pos];
      v = v + (i >= 0 ? llr[i] : 0.0f);
    }
    tree[nval + pos] = i0 == -2 ? 1e9f : v;
  }
  if (tid == 0) acc = 0;
  __syncthreads();
  // The SSC walk.
  const int* prog = tab + hd[H_PROG];
  for (int pc = 0; pc < hd[H_NOPS]; ++pc) {
    const int op = prog[3 * pc], lo = prog[3 * pc + 1], size = prog[3 * pc + 2];
    const int half = size / 2;
    switch (op) {
      case OP_F:
        for (int j = tid; j < half; j += kThreads) {
          const float x0 = tree[size + j], x1 = tree[size + half + j];
          tree[half + j] = sgn(x0) * sgn(x1) * fminf(fabsf(x0), fabsf(x1));
        }
        break;
      case OP_G:
        for (int j = tid; j < half; j += kThreads) {
          const float x0 = tree[size + j], x1 = tree[size + half + j];
          tree[half + j] = part[lo + j] ? x1 - x0 : x1 + x0;
        }
        break;
      case OP_ZERO:
        for (int j = tid; j < size; j += kThreads) part[lo + j] = u[lo + j] = 0;
        break;
      case OP_PC:
        if (tid == 0) part[lo] = u[lo] = static_cast<uint8_t>((acc >> (lo % 5)) & 1);
        break;
      case OP_INFO:
        if (tid == 0) {
          const uint8_t b = tree[1] < 0.0f;
          part[lo] = u[lo] = b;
          acc ^= b << (lo % 5);
        }
        break;
      case OP_RATE1:
        // Hard decisions, then the polar transform (its own inverse) gives
        // the bits; the accumulators take their parities by residue.
        for (int j = tid; j < size; j += kThreads) part[lo + j] = u[lo + j] = tree[size + j] < 0.0f;
        for (int step = 1; step < size; step *= 2) {
          __syncthreads();
          for (int t = tid; t < size / 2; t += kThreads) {
            const int i = (t / step) * 2 * step + t % step;
            u[lo + i] ^= u[lo + i + step];
          }
        }
        __syncthreads();
        if (tid == 0) {
          for (int j = 0; j < size; ++j) acc ^= u[lo + j] << ((lo + j) % 5);
        }
        break;
      case OP_COMBINE:
        for (int j = tid; j < half; j += kThreads) part[lo + j] ^= part[lo + half + j];
        break;
    }
    __syncthreads();
  }
  // The message (info positions, CRC last) and its CRC check.
  const int* info = tab + hd[H_INFO];
  if (tid == 0) {
    const int crc_len = hd[H_CRC_LEN], poly = hd[H_CRC_POLY];
    uint32_t reg = 0;
    for (int i = 0; i < k + crc_len + crc_len; ++i) {
      reg = (reg << 1) | (i < k + crc_len ? u[info[i]] : 0u);
      if (reg >> crc_len) reg ^= static_cast<uint32_t>(poly);
    }
    a.ok[o] = reg == 0;
  }
  for (int t = tid; t < a.k_max; t += kThreads) bits_out[t] = t < k ? u[info[t]] : 0;
}

}  // namespace

extern "C" int pucch_f2_rx(const void* grid, long long grid_numel, const void* tab,
                           int nof_occasions, int k_max, void* bits, void* ok, void* snr_db,
                           void* stream) {
  if (nof_occasions < 1 || k_max < 1 || grid_numel < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Args a;
  a.grid = static_cast<const float2*>(grid);
  a.grid_numel = grid_numel;
  a.tab = static_cast<const int*>(tab);
  a.k_max = k_max;
  a.bits = static_cast<uint8_t*>(bits);
  a.ok = static_cast<uint8_t*>(ok);
  a.snr_db = static_cast<float*>(snr_db);
  pucch_f2_rx_kernel<<<nof_occasions, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// Registers a thread and resident blocks per SM.
extern "C" int pucch_f2_rx_occupancy(int* registers, int* blocks) {
  cudaFuncAttributes attr;
  cudaError_t err = cudaFuncGetAttributes(&attr, reinterpret_cast<const void*>(pucch_f2_rx_kernel));
  if (err != cudaSuccess) return static_cast<int>(err);
  *registers = attr.numRegs;
  return static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, reinterpret_cast<const void*>(pucch_f2_rx_kernel), kThreads, 0));
}
