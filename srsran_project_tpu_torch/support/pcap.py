"""pcap capture writers — counterpart of the reference's lib/pcap/.

A copy of ``srsran_project_tpu/support/pcap.py``.

The reference ships MAC/RLC/NGAP pcap writers (lib/pcap/mac_pcap_impl.cpp,
dlt_pcap_impl.cpp) that dump PDUs into libpcap files Wireshark can open:
a DLT_USER link type plus, for MAC-NR, the Wireshark UDP-framing context
header (signature ``mac-nr``, radio/direction/rnti-type fields, tagged
optional fields, then the payload tag and the raw MAC PDU).

Here: ``PcapWriter`` emits the classic libpcap container, ``MacNrPcapWriter``
adds the MAC-NR context framing, and ``read_pcap`` parses files back for
tests.  Writers buffer in memory and flush on ``close()`` so captures never
block a slot loop.
"""

from __future__ import annotations

import struct
import time

DLT_USER_0 = 147  # Wireshark "user 0" link types used for xAP captures
DLT_USER_2 = 149  # conventionally carries udp-framed MAC-NR

_GLOBAL_HDR = struct.Struct("<IHHiIII")
_PKT_HDR = struct.Struct("<IIII")

# Wireshark packet-mac-nr UDP-framing constants (public dissector contract).
MAC_NR_START_STRING = b"mac-nr"
MAC_NR_PAYLOAD_TAG = 0x01
MAC_NR_RNTI_TAG = 0x02
MAC_NR_UEID_TAG = 0x03
MAC_NR_HARQID = 0x06
MAC_NR_FRAME_SLOT_TAG = 0x07

# radioType / direction / rntiType field values
FDD_RADIO, TDD_RADIO = 1, 2
DIRECTION_UPLINK, DIRECTION_DOWNLINK = 0, 1
NO_RNTI, P_RNTI, RA_RNTI, C_RNTI, SI_RNTI = 0, 1, 2, 3, 4


class PcapWriter:
    """Classic libpcap file writer (magic 0xa1b2c3d4, version 2.4)."""

    def __init__(self, path: str, dlt: int = DLT_USER_0, snaplen: int = 65535):
        self.path = path
        self._buf = bytearray(
            _GLOBAL_HDR.pack(0xA1B2C3D4, 2, 4, 0, 0, snaplen, dlt))
        self._closed = False
        self.nof_packets = 0

    def write_packet(self, payload: bytes, ts: float | None = None) -> None:
        if self._closed:
            raise ValueError("pcap writer closed")
        t = time.time() if ts is None else ts
        sec, usec = int(t), int((t % 1) * 1e6)
        self._buf += _PKT_HDR.pack(sec, usec, len(payload), len(payload))
        self._buf += payload
        self.nof_packets += 1

    def close(self) -> None:
        if not self._closed:
            with open(self.path, "wb") as f:
                f.write(self._buf)
            self._closed = True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# Per-protocol DLT_USER assignments, identical to the reference's
# (lib/pcap/dlt_pcap_impl.cpp:30-34) so Wireshark decode-as rules carry over.
PCAP_NGAP_DLT = 152
PCAP_E1AP_DLT = 153
PCAP_F1AP_DLT = 154
PCAP_E2AP_DLT = 155
PCAP_GTPU_DLT = 156


def ngap_pcap(path: str) -> "PcapWriter":
    return PcapWriter(path, dlt=PCAP_NGAP_DLT)


def e1ap_pcap(path: str) -> "PcapWriter":
    return PcapWriter(path, dlt=PCAP_E1AP_DLT)


def f1ap_pcap(path: str) -> "PcapWriter":
    return PcapWriter(path, dlt=PCAP_F1AP_DLT)


def e2ap_pcap(path: str) -> "PcapWriter":
    return PcapWriter(path, dlt=PCAP_E2AP_DLT)


def gtpu_pcap(path: str) -> "PcapWriter":
    return PcapWriter(path, dlt=PCAP_GTPU_DLT)


class MacNrPcapWriter(PcapWriter):
    """MAC-NR pcap: Wireshark udp-framed context header + MAC PDU."""

    def __init__(self, path: str, radio_type: int = TDD_RADIO):
        super().__init__(path, dlt=DLT_USER_2)
        self.radio_type = radio_type

    def write_pdu(self, pdu: bytes, *, rnti: int, direction: int,
                  rnti_type: int = C_RNTI, ueid: int = 0,
                  harq_id: int | None = None,
                  sfn: int | None = None, slot: int | None = None,
                  ts: float | None = None) -> None:
        ctx = bytearray(MAC_NR_START_STRING)
        ctx += bytes((self.radio_type, direction, rnti_type))
        ctx += bytes((MAC_NR_RNTI_TAG,)) + struct.pack(">H", rnti)
        ctx += bytes((MAC_NR_UEID_TAG,)) + struct.pack(">H", ueid)
        if harq_id is not None:
            ctx += bytes((MAC_NR_HARQID, harq_id))
        if sfn is not None and slot is not None:
            ctx += bytes((MAC_NR_FRAME_SLOT_TAG,)) + struct.pack(">HH", sfn, slot)
        ctx += bytes((MAC_NR_PAYLOAD_TAG,)) + pdu
        self.write_packet(bytes(ctx), ts=ts)


def read_pcap(path: str):
    """Parse a libpcap file -> (dlt, [(ts, payload), ...]). Test helper."""
    data = open(path, "rb").read()
    magic, vmaj, vmin, _, _, _, dlt = _GLOBAL_HDR.unpack_from(data, 0)
    if magic != 0xA1B2C3D4:
        raise ValueError(f"bad pcap magic {magic:#x}")
    off = _GLOBAL_HDR.size
    pkts = []
    while off < len(data):
        sec, usec, incl, _orig = _PKT_HDR.unpack_from(data, off)
        off += _PKT_HDR.size
        pkts.append((sec + usec * 1e-6, data[off:off + incl]))
        off += incl
    return dlt, pkts


def parse_mac_nr_context(payload: bytes):
    """Invert MacNrPcapWriter framing -> (context dict, MAC PDU bytes)."""
    if not payload.startswith(MAC_NR_START_STRING):
        raise ValueError("missing mac-nr signature")
    off = len(MAC_NR_START_STRING)
    ctx = {"radio_type": payload[off], "direction": payload[off + 1],
           "rnti_type": payload[off + 2]}
    off += 3
    while off < len(payload):
        tag = payload[off]
        off += 1
        if tag == MAC_NR_PAYLOAD_TAG:
            return ctx, payload[off:]
        if tag == MAC_NR_RNTI_TAG:
            ctx["rnti"] = struct.unpack_from(">H", payload, off)[0]
            off += 2
        elif tag == MAC_NR_UEID_TAG:
            ctx["ueid"] = struct.unpack_from(">H", payload, off)[0]
            off += 2
        elif tag == MAC_NR_HARQID:
            ctx["harq_id"] = payload[off]
            off += 1
        elif tag == MAC_NR_FRAME_SLOT_TAG:
            ctx["sfn"], ctx["slot"] = struct.unpack_from(">HH", payload, off)
            off += 4
        else:
            raise ValueError(f"unknown mac-nr tag {tag:#x}")
    raise ValueError("no payload tag")
