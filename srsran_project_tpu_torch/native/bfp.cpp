// The port's copy of native/bfp.cpp, built by srsran_project_tpu_torch/support/native.py
// with native/Makefile's flags; keep the two byte for byte below this header.
// Block-floating-point IQ compression (O-RAN WG4 CUS Annex A.1 style).
//
// TPU-native counterpart of the reference's OFH compression pipeline
// (lib/ofh/compression/iq_compression_bfp_avx512.cpp): the NIC-facing
// byte work stays on the host CPU in native code; the device only ever
// sees resource grids.
//
// Layout per compression block (one PRB = 12 complex samples = 24 int16):
//   1 byte exponent e, then 24 mantissas of `width` bits, big-endian packed.
// Compression: e = max(0, ceil(log2(max|x|+1)) - (width-1)); mantissa =
// x >> e (arithmetic), reconstruct x~ = m << e.

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

inline int required_bits(int32_t maxabs, int width) {
  // Smallest shift e so that (maxabs >> e) fits in signed `width` bits.
  int e = 0;
  while ((maxabs >> e) >= (1 << (width - 1)))
    ++e;
  return e;
}

class BitWriter {
 public:
  explicit BitWriter(uint8_t* out) : out_(out) {}
  void put(uint32_t value, int bits) {
    for (int i = bits - 1; i >= 0; --i) {
      acc_ = (acc_ << 1) | ((value >> i) & 1u);
      if (++nbits_ == 8) {
        *out_++ = static_cast<uint8_t>(acc_);
        acc_ = 0;
        nbits_ = 0;
      }
    }
  }
  void flush() {
    if (nbits_) {
      *out_++ = static_cast<uint8_t>(acc_ << (8 - nbits_));
      acc_ = 0;
      nbits_ = 0;
    }
  }
  uint8_t* pos() const { return out_; }

 private:
  uint8_t* out_;
  uint32_t acc_ = 0;
  int nbits_ = 0;
};

class BitReader {
 public:
  explicit BitReader(const uint8_t* in) : in_(in) {}
  uint32_t get(int bits) {
    uint32_t v = 0;
    for (int i = 0; i < bits; ++i) {
      if (nbits_ == 0) {
        acc_ = *in_++;
        nbits_ = 8;
      }
      v = (v << 1) | ((acc_ >> (nbits_ - 1)) & 1u);
      --nbits_;
    }
    return v;
  }
  void align() { nbits_ = 0; }

 private:
  const uint8_t* in_;
  uint32_t acc_ = 0;
  int nbits_ = 0;
};

}  // namespace

extern "C" {

// Bytes per compressed PRB for a given mantissa width.
int bfp_compressed_prb_bytes(int width) { return 1 + (24 * width + 7) / 8; }

// samples: int16 interleaved IQ, nof_prb * 24 values.
// out: nof_prb * bfp_compressed_prb_bytes(width) bytes.
void bfp_compress(const int16_t* samples, int nof_prb, int width, uint8_t* out) {
  const int prb_bytes = bfp_compressed_prb_bytes(width);
  for (int p = 0; p < nof_prb; ++p) {
    const int16_t* blk = samples + p * 24;
    int32_t maxabs = 0;
    for (int i = 0; i < 24; ++i)
      maxabs = std::max<int32_t>(maxabs, blk[i] < 0 ? -(int32_t)blk[i] : blk[i]);
    int e = required_bits(maxabs, width);
    uint8_t* dst = out + p * prb_bytes;
    dst[0] = static_cast<uint8_t>(e);
    BitWriter w(dst + 1);
    const uint32_t mask = (1u << width) - 1;
    for (int i = 0; i < 24; ++i) {
      int32_t m = blk[i] >> e;  // arithmetic shift
      w.put(static_cast<uint32_t>(m) & mask, width);
    }
    w.flush();
  }
}

void bfp_decompress(const uint8_t* in, int nof_prb, int width, int16_t* samples) {
  const int prb_bytes = bfp_compressed_prb_bytes(width);
  for (int p = 0; p < nof_prb; ++p) {
    const uint8_t* src = in + p * prb_bytes;
    int e = src[0];
    BitReader r(src + 1);
    for (int i = 0; i < 24; ++i) {
      uint32_t raw = r.get(width);
      // Sign-extend `width`-bit value.
      int32_t m = static_cast<int32_t>(raw << (32 - width)) >> (32 - width);
      samples[p * 24 + i] = static_cast<int16_t>(m << e);
    }
  }
}

}  // extern "C"
