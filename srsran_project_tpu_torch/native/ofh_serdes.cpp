// The port's copy of native/ofh_serdes.cpp, built by srsran_project_tpu_torch/support/native.py
// with native/Makefile's flags; keep the two byte for byte below this header.
// Open Fronthaul U-plane message (de)serialization: eCPRI framing + O-RAN
// CUS-style radio application/section headers + BFP-compressed PRB payload.
//
// TPU-native counterpart of the reference's lib/ofh/{ecpri,serdes}
// (eCPRI packet builder/decoder, ORAN U-plane packet (de)builders): the
// host NIC-facing byte work stays native; the device only sees grids.
//
// Message layout (big-endian on the wire):
//   eCPRI common header (4B): 0x10 | msgtype(0=IQ data) | payload size
//   eCPRI PC_ID (2B) | SEQ_ID (2B)
//   Radio app header (4B): dataDirection(1b) payloadVersion(3b)
//     filterIndex(4b) | frameId(8b) | subframeId(4b) slotId(6b) symbolId(6b)
//   Section header (4B): sectionId(12b) rb(1b) symInc(1b) startPrb(10b)
//     numPrb(8b)
//   udCompHdr (1B): iqWidth(4b) compMeth(4b; 1 = BFP) + 1B reserved
//   numPrb x BFP-compressed PRB blocks (1B exponent + 24 mantissas)

#include <cstdint>
#include <cstring>

extern "C" {
int bfp_compressed_prb_bytes(int width);
void bfp_compress(const int16_t* samples, int nof_prb, int width, uint8_t* out);
void bfp_decompress(const uint8_t* in, int nof_prb, int width, int16_t* samples);
}

namespace {

inline void put16(uint8_t* p, uint16_t v) {
  p[0] = static_cast<uint8_t>(v >> 8);
  p[1] = static_cast<uint8_t>(v & 0xFF);
}
inline uint16_t get16(const uint8_t* p) {
  return static_cast<uint16_t>((p[0] << 8) | p[1]);
}

constexpr int kEcpriHdr = 8;
constexpr int kRadioHdr = 4;
constexpr int kSectionHdr = 4;
constexpr int kCompHdr = 2;

}  // namespace

extern "C" {

// Total serialized size for numPrb PRBs at iq width `width`.
int ofh_uplane_size(int nof_prb, int width) {
  return kEcpriHdr + kRadioHdr + kSectionHdr + kCompHdr +
         nof_prb * bfp_compressed_prb_bytes(width);
}

// Build one U-plane message.  iq: int16 interleaved, nof_prb*24 values.
// Returns bytes written, or -1.
int ofh_uplane_build(uint8_t* out, int out_cap, uint16_t pc_id, uint16_t seq_id,
                     int direction, int frame_id, int subframe_id, int slot_id,
                     int symbol_id, int start_prb, int nof_prb, int width,
                     const int16_t* iq) {
  const int total = ofh_uplane_size(nof_prb, width);
  if (out_cap < total || nof_prb > 255 || width < 1 || width > 16) return -1;
  uint8_t* p = out;
  // eCPRI common header.
  p[0] = 0x10;  // protocol revision 1, C = 0
  p[1] = 0x00;  // message type 0: IQ data
  put16(p + 2, static_cast<uint16_t>(total - 4));
  put16(p + 4, pc_id);
  put16(p + 6, seq_id);
  p += kEcpriHdr;
  // Radio application header.
  p[0] = static_cast<uint8_t>(((direction & 1) << 7) | (1 << 4));  // payloadVersion=1
  p[1] = static_cast<uint8_t>(frame_id & 0xFF);
  p[2] = static_cast<uint8_t>(((subframe_id & 0xF) << 4) | ((slot_id >> 2) & 0xF));
  p[3] = static_cast<uint8_t>(((slot_id & 0x3) << 6) | (symbol_id & 0x3F));
  p += kRadioHdr;
  // Section header (sectionId = 0, rb = 0, symInc = 0).
  p[0] = 0;
  p[1] = static_cast<uint8_t>((start_prb >> 8) & 0x3);
  p[2] = static_cast<uint8_t>(start_prb & 0xFF);
  p[3] = static_cast<uint8_t>(nof_prb & 0xFF);
  p += kSectionHdr;
  // udCompHdr: iqWidth | compMeth = 1 (BFP).
  p[0] = static_cast<uint8_t>(((width & 0xF) << 4) | 0x1);
  p[1] = 0;
  p += kCompHdr;
  bfp_compress(iq, nof_prb, width, p);
  return total;
}

// Parse one U-plane message.  Outputs scalars via pointers; decompresses the
// IQ into `iq` (caller provides nof_prb*24 int16 capacity; pass the value
// from a first parse with iq == nullptr to size it).
// Returns number of PRBs, or -1 on malformed input.
int ofh_uplane_parse(const uint8_t* in, int in_len, uint16_t* pc_id, uint16_t* seq_id,
                     int* direction, int* frame_id, int* subframe_id, int* slot_id,
                     int* symbol_id, int* start_prb, int* width, int16_t* iq) {
  if (in_len < kEcpriHdr + kRadioHdr + kSectionHdr + kCompHdr) return -1;
  if ((in[0] & 0xF0) != 0x10 || in[1] != 0x00) return -1;
  const int payload = get16(in + 2);
  if (payload + 4 > in_len) return -1;
  *pc_id = get16(in + 4);
  *seq_id = get16(in + 6);
  const uint8_t* p = in + kEcpriHdr;
  *direction = (p[0] >> 7) & 1;
  *frame_id = p[1];
  *subframe_id = (p[2] >> 4) & 0xF;
  *slot_id = ((p[2] & 0xF) << 2) | ((p[3] >> 6) & 0x3);
  *symbol_id = p[3] & 0x3F;
  p += kRadioHdr;
  *start_prb = ((p[1] & 0x3) << 8) | p[2];
  const int nof_prb = p[3];
  p += kSectionHdr;
  *width = (p[0] >> 4) & 0xF;
  const int comp_meth = p[0] & 0xF;
  if (comp_meth != 1) return -1;  // only BFP supported
  p += kCompHdr;
  const int need = nof_prb * bfp_compressed_prb_bytes(*width);
  if (p + need > in + in_len) return -1;
  if (iq != nullptr) bfp_decompress(p, nof_prb, *width, iq);
  return nof_prb;
}

// Static-compression U-plane variant: the IQ width/method are fixed by
// M-plane-style configuration, so sections carry NO udCompHdr on the wire
// (reference ofh_uplane_message_builder_static_compression_impl.cpp — the
// serializer writes nothing where the dynamic builder writes width|method).
int ofh_uplane_size_static(int nof_prb, int width) {
  return kEcpriHdr + kRadioHdr + kSectionHdr +
         nof_prb * bfp_compressed_prb_bytes(width);
}

int ofh_uplane_build_static(uint8_t* out, int out_cap, uint16_t pc_id,
                            uint16_t seq_id, int direction, int frame_id,
                            int subframe_id, int slot_id, int symbol_id,
                            int start_prb, int nof_prb, int width,
                            const int16_t* iq) {
  const int total = ofh_uplane_size_static(nof_prb, width);
  if (out_cap < total || nof_prb > 255 || width < 1 || width > 16) return -1;
  uint8_t* p = out;
  p[0] = 0x10;
  p[1] = 0x00;
  put16(p + 2, static_cast<uint16_t>(total - 4));
  put16(p + 4, pc_id);
  put16(p + 6, seq_id);
  p += kEcpriHdr;
  p[0] = static_cast<uint8_t>(((direction & 1) << 7) | (1 << 4));
  p[1] = static_cast<uint8_t>(frame_id & 0xFF);
  p[2] = static_cast<uint8_t>(((subframe_id & 0xF) << 4) | ((slot_id >> 2) & 0xF));
  p[3] = static_cast<uint8_t>(((slot_id & 0x3) << 6) | (symbol_id & 0x3F));
  p += kRadioHdr;
  p[0] = 0;
  p[1] = static_cast<uint8_t>((start_prb >> 8) & 0x3);
  p[2] = static_cast<uint8_t>(start_prb & 0xFF);
  p[3] = static_cast<uint8_t>(nof_prb & 0xFF);
  p += kSectionHdr;
  bfp_compress(iq, nof_prb, width, p);
  return total;
}

// `width` comes from configuration, not the wire.
int ofh_uplane_parse_static(const uint8_t* in, int in_len, int width,
                            uint16_t* pc_id, uint16_t* seq_id, int* direction,
                            int* frame_id, int* subframe_id, int* slot_id,
                            int* symbol_id, int* start_prb, int16_t* iq) {
  if (in_len < kEcpriHdr + kRadioHdr + kSectionHdr) return -1;
  if ((in[0] & 0xF0) != 0x10 || in[1] != 0x00) return -1;
  const int payload = get16(in + 2);
  if (payload + 4 > in_len) return -1;
  *pc_id = get16(in + 4);
  *seq_id = get16(in + 6);
  const uint8_t* p = in + kEcpriHdr;
  *direction = (p[0] >> 7) & 1;
  *frame_id = p[1];
  *subframe_id = (p[2] >> 4) & 0xF;
  *slot_id = ((p[2] & 0xF) << 2) | ((p[3] >> 6) & 0x3);
  *symbol_id = p[3] & 0x3F;
  p += kRadioHdr;
  *start_prb = ((p[1] & 0x3) << 8) | p[2];
  const int nof_prb = p[3];
  p += kSectionHdr;
  const int need = nof_prb * bfp_compressed_prb_bytes(width);
  if (p + need > in + in_len) return -1;
  if (iq != nullptr) bfp_decompress(p, nof_prb, width, iq);
  return nof_prb;
}

}  // extern "C"

// ---------------------------------------------------------------------------
// C-plane: O-RAN control-plane messages (scheduling commands), the native
// counterpart of the reference's ofh_data_flow_cplane_scheduling_commands +
// C-plane (de)builders in lib/ofh/serdes.
//
// Layout (big-endian):
//   eCPRI common header (4B): 0x10 | msgtype(2 = real-time control) | size
//   eCPRI RTC_ID (2B) | SEQ_ID (2B)
//   Radio app header (8B): dataDirection|payloadVersion|filterIndex,
//     frameId, subframeId|slotId[5:2], slotId[1:0]|startSymbolId,
//     numberOfSections, sectionType, udCompHdr (type 1) / timeOffset hi
//     (type 3), reserved
//   numberOfSections x section (8B, type 1):
//     sectionId(12b) rb(1b) symInc(1b) startPrbc(10b) | numPrbc(8b) |
//     reMask(12b) numSymbol(4b) | ef(1b) beamId(15b)
//   type 3 sections append: frequencyOffset(3B) + reserved(1B)

extern "C" {

struct ofh_cplane_section {
  uint16_t section_id;   // 12 bits
  uint16_t start_prbc;   // 10 bits
  uint8_t num_prbc;      // 0 = "all PRBs"
  uint16_t re_mask;      // 12 bits
  uint8_t num_symbol;    // 4 bits
  uint16_t beam_id;      // 15 bits
  int32_t freq_offset;   // type 3 only (24-bit signed)
};

constexpr int kCpRadioHdr = 8;
constexpr int kCpSection1 = 8;
constexpr int kCpSection3Extra = 4;

int ofh_cplane_size(int section_type, int nof_sections) {
  const int per = kCpSection1 + (section_type == 3 ? kCpSection3Extra : 0);
  return kEcpriHdr + kCpRadioHdr + nof_sections * per;
}

int ofh_cplane_build(uint8_t* out, int out_cap, uint16_t rtc_id, uint16_t seq_id,
                     int direction, int frame_id, int subframe_id, int slot_id,
                     int start_symbol, int section_type, int time_offset,
                     const ofh_cplane_section* sections, int nof_sections) {
  const int total = ofh_cplane_size(section_type, nof_sections);
  if (out_cap < total || nof_sections < 1 || nof_sections > 255) return -1;
  if (section_type != 1 && section_type != 3) return -1;
  uint8_t* p = out;
  p[0] = 0x10;
  p[1] = 0x02;  // real-time control data
  put16(p + 2, static_cast<uint16_t>(total - 4));
  put16(p + 4, rtc_id);
  put16(p + 6, seq_id);
  p += kEcpriHdr;
  p[0] = static_cast<uint8_t>(((direction & 1) << 7) | (1 << 4));
  p[1] = static_cast<uint8_t>(frame_id & 0xFF);
  p[2] = static_cast<uint8_t>(((subframe_id & 0xF) << 4) | ((slot_id >> 2) & 0xF));
  p[3] = static_cast<uint8_t>(((slot_id & 0x3) << 6) | (start_symbol & 0x3F));
  p[4] = static_cast<uint8_t>(nof_sections);
  p[5] = static_cast<uint8_t>(section_type);
  put16(p + 6, static_cast<uint16_t>(time_offset));  // type 3; see _comp below
  p += kCpRadioHdr;
  for (int i = 0; i < nof_sections; ++i) {
    const ofh_cplane_section& s = sections[i];
    p[0] = static_cast<uint8_t>((s.section_id >> 4) & 0xFF);
    p[1] = static_cast<uint8_t>(((s.section_id & 0xF) << 4) |
                                ((s.start_prbc >> 8) & 0x3));
    p[2] = static_cast<uint8_t>(s.start_prbc & 0xFF);
    p[3] = s.num_prbc;
    p[4] = static_cast<uint8_t>((s.re_mask >> 4) & 0xFF);
    p[5] = static_cast<uint8_t>(((s.re_mask & 0xF) << 4) | (s.num_symbol & 0xF));
    p[6] = static_cast<uint8_t>((s.beam_id >> 8) & 0x7F);
    p[7] = static_cast<uint8_t>(s.beam_id & 0xFF);
    p += kCpSection1;
    if (section_type == 3) {
      p[0] = static_cast<uint8_t>((s.freq_offset >> 16) & 0xFF);
      p[1] = static_cast<uint8_t>((s.freq_offset >> 8) & 0xFF);
      p[2] = static_cast<uint8_t>(s.freq_offset & 0xFF);
      p[3] = 0;
      p += kCpSection3Extra;
    }
  }
  return total;
}

// Type-1 builder with an explicit udCompHdr byte in the radio-app header
// (reference radio-app layout: ..., numberOfSections, sectionType,
// udCompHdr, reserved).  The static-compression C-plane builder always
// writes 0 there; the dynamic one encodes iqWidth<<4|compMeth for uplink
// (ofh_cplane_message_builder_{static,dynamic}_compression_impl.cpp).
int ofh_cplane_build_comp(uint8_t* out, int out_cap, uint16_t rtc_id,
                          uint16_t seq_id, int direction, int frame_id,
                          int subframe_id, int slot_id, int start_symbol,
                          int ud_comp_hdr, const ofh_cplane_section* sections,
                          int nof_sections) {
  const int n = ofh_cplane_build(out, out_cap, rtc_id, seq_id, direction,
                                 frame_id, subframe_id, slot_id, start_symbol,
                                 /*section_type=*/1, /*time_offset=*/0,
                                 sections, nof_sections);
  if (n < 0) return n;
  out[kEcpriHdr + 6] = static_cast<uint8_t>(ud_comp_hdr);
  return n;
}

// Returns the udCompHdr byte of a type-1 message (-1 if not type 1).
int ofh_cplane_comp_hdr(const uint8_t* in, int in_len) {
  if (in_len < kEcpriHdr + kCpRadioHdr) return -1;
  if (in[kEcpriHdr + 5] != 1) return -1;
  return in[kEcpriHdr + 6];
}

// ---------------------------------------------------------------------------
// C-plane section type 0: idle/guard-period indication (O-RAN CUS 7.5.2;
// reference build_idle_guard_period_message,
// ofh_cplane_message_builder_impl.cpp:222-263).  Exactly one section;
// radio-app header carries timeOffset, frameStructure and cpLength.
// ---------------------------------------------------------------------------

constexpr int kCpType0Hdr = 12;   // 4B common + numSections/type + TO/FS/CP/res
constexpr int kCpSection0 = 8;    // 6B common fields + ef/reserved + reserved

int ofh_cplane_size_type0() { return kEcpriHdr + kCpType0Hdr + kCpSection0; }

int ofh_cplane_build_type0(uint8_t* out, int out_cap, uint16_t rtc_id,
                           uint16_t seq_id, int direction, int frame_id,
                           int subframe_id, int slot_id, int start_symbol,
                           int time_offset, int frame_structure, int cp_length,
                           const ofh_cplane_section* section) {
  const int total = ofh_cplane_size_type0();
  if (out_cap < total) return -1;
  uint8_t* p = out;
  p[0] = 0x10;
  p[1] = 0x02;  // real-time control data
  put16(p + 2, static_cast<uint16_t>(total - 4));
  put16(p + 4, rtc_id);
  put16(p + 6, seq_id);
  p += kEcpriHdr;
  p[0] = static_cast<uint8_t>(((direction & 1) << 7) | (1 << 4));
  p[1] = static_cast<uint8_t>(frame_id & 0xFF);
  p[2] = static_cast<uint8_t>(((subframe_id & 0xF) << 4) | ((slot_id >> 2) & 0xF));
  p[3] = static_cast<uint8_t>(((slot_id & 0x3) << 6) | (start_symbol & 0x3F));
  p[4] = 1;  // exactly one section
  p[5] = 0;  // sectionType = 0
  put16(p + 6, static_cast<uint16_t>(time_offset));
  p[8] = static_cast<uint8_t>(frame_structure);
  put16(p + 9, static_cast<uint16_t>(cp_length));
  p[11] = 0;  // reserved
  p += kCpType0Hdr;
  const ofh_cplane_section& s = *section;
  p[0] = static_cast<uint8_t>((s.section_id >> 4) & 0xFF);
  p[1] = static_cast<uint8_t>(((s.section_id & 0xF) << 4) |
                              ((s.start_prbc >> 8) & 0x3));
  p[2] = static_cast<uint8_t>(s.start_prbc & 0xFF);
  p[3] = s.num_prbc;
  p[4] = static_cast<uint8_t>((s.re_mask >> 4) & 0xFF);
  p[5] = static_cast<uint8_t>(((s.re_mask & 0xF) << 4) | (s.num_symbol & 0xF));
  p[6] = 0;  // EF + reserved (no extensions)
  p[7] = 0;  // reserved
  return total;
}

int ofh_cplane_parse_type0(const uint8_t* in, int in_len, uint16_t* rtc_id,
                           uint16_t* seq_id, int* direction, int* frame_id,
                           int* subframe_id, int* slot_id, int* start_symbol,
                           int* time_offset, int* frame_structure,
                           int* cp_length, ofh_cplane_section* section) {
  if (in_len < ofh_cplane_size_type0()) return -1;
  if ((in[0] & 0xF0) != 0x10 || in[1] != 0x02) return -1;
  *rtc_id = get16(in + 4);
  *seq_id = get16(in + 6);
  const uint8_t* p = in + kEcpriHdr;
  if (p[5] != 0) return -1;  // not a type-0 message
  *direction = (p[0] >> 7) & 1;
  *frame_id = p[1];
  *subframe_id = (p[2] >> 4) & 0xF;
  *slot_id = ((p[2] & 0xF) << 2) | ((p[3] >> 6) & 0x3);
  *start_symbol = p[3] & 0x3F;
  *time_offset = get16(p + 6);
  *frame_structure = p[8];
  *cp_length = get16(p + 9);
  p += kCpType0Hdr;
  section->section_id = static_cast<uint16_t>((p[0] << 4) | (p[1] >> 4));
  section->start_prbc = static_cast<uint16_t>(((p[1] & 0x3) << 8) | p[2]);
  section->num_prbc = p[3];
  section->re_mask = static_cast<uint16_t>((p[4] << 4) | (p[5] >> 4));
  section->num_symbol = p[5] & 0xF;
  section->beam_id = 0;
  section->freq_offset = 0;
  return 1;
}

int ofh_cplane_parse(const uint8_t* in, int in_len, uint16_t* rtc_id,
                     uint16_t* seq_id, int* direction, int* frame_id,
                     int* subframe_id, int* slot_id, int* start_symbol,
                     int* section_type, int* time_offset,
                     ofh_cplane_section* sections, int max_sections) {
  if (in_len < kEcpriHdr + kCpRadioHdr) return -1;
  if ((in[0] & 0xF0) != 0x10 || in[1] != 0x02) return -1;
  *rtc_id = get16(in + 4);
  *seq_id = get16(in + 6);
  const uint8_t* p = in + kEcpriHdr;
  *direction = (p[0] >> 7) & 1;
  *frame_id = p[1];
  *subframe_id = (p[2] >> 4) & 0xF;
  *slot_id = ((p[2] & 0xF) << 2) | ((p[3] >> 6) & 0x3);
  *start_symbol = p[3] & 0x3F;
  const int nof_sections = p[4];
  *section_type = p[5];
  *time_offset = get16(p + 6);
  if (*section_type != 1 && *section_type != 3) return -1;
  const int per = kCpSection1 + (*section_type == 3 ? kCpSection3Extra : 0);
  if (kEcpriHdr + kCpRadioHdr + nof_sections * per > in_len) return -1;
  p += kCpRadioHdr;
  const int n = nof_sections < max_sections ? nof_sections : max_sections;
  for (int i = 0; i < n; ++i) {
    ofh_cplane_section& s = sections[i];
    s.section_id = static_cast<uint16_t>((p[0] << 4) | (p[1] >> 4));
    s.start_prbc = static_cast<uint16_t>(((p[1] & 0x3) << 8) | p[2]);
    s.num_prbc = p[3];
    s.re_mask = static_cast<uint16_t>((p[4] << 4) | (p[5] >> 4));
    s.num_symbol = p[5] & 0xF;
    s.beam_id = static_cast<uint16_t>(((p[6] & 0x7F) << 8) | p[7]);
    s.freq_offset = 0;
    p += kCpSection1;
    if (*section_type == 3) {
      int32_t fo = (p[0] << 16) | (p[1] << 8) | p[2];
      if (fo & 0x800000) fo -= 1 << 24;  // sign-extend 24-bit
      s.freq_offset = fo;
      p += kCpSection3Extra;
    }
  }
  return nof_sections;
}

}  // extern "C"
