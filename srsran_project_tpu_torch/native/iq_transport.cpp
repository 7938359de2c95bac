// The port's copy of native/iq_transport.cpp, built by srsran_project_tpu_torch/support/native.py
// with native/Makefile's flags; keep the two byte for byte below this header.
// IQ sample frame transport over UDP — the simulated-RF boundary.
//
// TPU-native counterpart of the reference's ZMQ radio
// (lib/radio/zmq/: simulated RF over REQ/REP sample streaming) and the raw
// socket side of the OFH Ethernet transceiver (lib/ofh/ethernet/): frames
// of complex int16 IQ samples with a (slot, symbol, port) header travel
// over a datagram socket so an external UE/RU emulator can exchange
// baseband with the framework without any radio hardware.
//
// Frame layout (little endian):
//   u32 magic 'TIQ1' | u32 slot | u16 symbol | u16 port | u32 nof_samples
//   then nof_samples * 2 * int16 (I,Q).

#include <arpa/inet.h>
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <netinet/in.h>
#include <sys/socket.h>
#include <sys/time.h>
#include <unistd.h>

namespace {
constexpr uint32_t kMagic = 0x31514954;  // "TIQ1"
struct Header {
  uint32_t magic;
  uint32_t slot;
  uint16_t symbol;
  uint16_t port;
  uint32_t nof_samples;
};
constexpr int kMaxDatagram = 60000;
}  // namespace

extern "C" {

// Returns fd >= 0, or -1.
int iq_open_rx(const char* bind_addr, int port) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  int reuse = 1;
  setsockopt(fd, SOL_SOCKET, SO_REUSEADDR, &reuse, sizeof(reuse));
  int rcvbuf = 1 << 22;
  setsockopt(fd, SOL_SOCKET, SO_RCVBUF, &rcvbuf, sizeof(rcvbuf));
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = bind_addr ? inet_addr(bind_addr) : INADDR_ANY;
  if (bind(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

int iq_open_tx(const char* dest_addr, int port) {
  int fd = socket(AF_INET, SOCK_DGRAM, 0);
  if (fd < 0) return -1;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  addr.sin_addr.s_addr = inet_addr(dest_addr);
  if (connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) < 0) {
    close(fd);
    return -1;
  }
  return fd;
}

// Send one symbol's IQ (possibly fragmented). samples: interleaved int16 IQ.
// Returns total samples sent or -1.
int iq_send(int fd, uint32_t slot, int symbol, int port_id, const int16_t* samples,
            int nof_samples) {
  const int max_samples = (kMaxDatagram - static_cast<int>(sizeof(Header))) / 4;
  int sent = 0;
  while (sent < nof_samples) {
    int chunk = std::min(nof_samples - sent, max_samples);
    uint8_t buf[kMaxDatagram];
    Header h{kMagic, slot, static_cast<uint16_t>(symbol), static_cast<uint16_t>(port_id),
             static_cast<uint32_t>(chunk)};
    std::memcpy(buf, &h, sizeof(h));
    std::memcpy(buf + sizeof(h), samples + 2 * sent, chunk * 4);
    if (send(fd, buf, sizeof(h) + chunk * 4, 0) < 0) return -1;
    sent += chunk;
  }
  return sent;
}

// Receive one datagram; fills header fields and up to max_samples samples.
// Returns nof_samples, 0 on timeout, -1 on error.
int iq_recv(int fd, uint32_t* slot, int* symbol, int* port_id, int16_t* samples,
            int max_samples, int timeout_ms) {
  if (timeout_ms >= 0) {
    timeval tv{timeout_ms / 1000, (timeout_ms % 1000) * 1000};
    setsockopt(fd, SOL_SOCKET, SO_RCVTIMEO, &tv, sizeof(tv));
  }
  uint8_t buf[kMaxDatagram];
  ssize_t n = recv(fd, buf, sizeof(buf), 0);
  if (n < 0) return 0;  // timeout
  if (n < static_cast<ssize_t>(sizeof(Header))) return -1;
  Header h;
  std::memcpy(&h, buf, sizeof(h));
  if (h.magic != kMagic) return -1;
  int ns = static_cast<int>(h.nof_samples);
  if (ns > max_samples || sizeof(Header) + ns * 4 > static_cast<size_t>(n)) return -1;
  *slot = h.slot;
  *symbol = h.symbol;
  *port_id = h.port;
  std::memcpy(samples, buf + sizeof(h), ns * 4);
  return ns;
}

void iq_close(int fd) { close(fd); }

}  // extern "C"
