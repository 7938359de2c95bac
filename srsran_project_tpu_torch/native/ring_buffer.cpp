// The port's copy of native/ring_buffer.cpp, built by srsran_project_tpu_torch/support/native.py
// with native/Makefile's flags; keep the two byte for byte below this header.
// Lock-free SPSC ring buffer for baseband samples.
//
// TPU-native counterpart of the reference's rigtorp SPSC queue usage in the
// lower-PHY baseband pipeline (lib/phy/lower/lower_phy_baseband_processor):
// the host-side producer (IQ transport / RU emulator) and consumer (device
// feeder) exchange fixed-size sample blocks without locks.

#include <atomic>
#include <cstdint>
#include <cstring>
#include <new>

namespace {

struct Ring {
  int16_t* data;
  size_t capacity;       // in samples (int16 count)
  size_t block;          // samples per block
  size_t nof_blocks;
  alignas(64) std::atomic<uint64_t> head{0};  // producer writes
  alignas(64) std::atomic<uint64_t> tail{0};  // consumer reads
};

}  // namespace

extern "C" {

void* ring_create(int nof_blocks, int block_samples) {
  Ring* r = new (std::nothrow) Ring();
  if (!r) return nullptr;
  r->block = static_cast<size_t>(block_samples);
  r->nof_blocks = static_cast<size_t>(nof_blocks);
  r->capacity = r->block * r->nof_blocks;
  r->data = new (std::nothrow) int16_t[r->capacity];
  if (!r->data) {
    delete r;
    return nullptr;
  }
  return r;
}

void ring_destroy(void* h) {
  Ring* r = static_cast<Ring*>(h);
  delete[] r->data;
  delete r;
}

// Returns 1 on success, 0 if full.
int ring_push(void* h, const int16_t* block) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t head = r->head.load(std::memory_order_relaxed);
  uint64_t tail = r->tail.load(std::memory_order_acquire);
  if (head - tail >= r->nof_blocks) return 0;
  std::memcpy(r->data + (head % r->nof_blocks) * r->block, block,
              r->block * sizeof(int16_t));
  r->head.store(head + 1, std::memory_order_release);
  return 1;
}

// Returns 1 on success, 0 if empty.
int ring_pop(void* h, int16_t* block) {
  Ring* r = static_cast<Ring*>(h);
  uint64_t tail = r->tail.load(std::memory_order_relaxed);
  uint64_t head = r->head.load(std::memory_order_acquire);
  if (head == tail) return 0;
  std::memcpy(block, r->data + (tail % r->nof_blocks) * r->block,
              r->block * sizeof(int16_t));
  r->tail.store(tail + 1, std::memory_order_release);
  return 1;
}

int ring_size(void* h) {
  Ring* r = static_cast<Ring*>(h);
  return static_cast<int>(r->head.load(std::memory_order_acquire) -
                          r->tail.load(std::memory_order_acquire));
}

}  // extern "C"
