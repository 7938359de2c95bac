"""GTP-U v1 — TS 29.281: tunnel framing for NG-U / F1-U transport.

Counterpart of the reference's lib/gtpu (gtpu_tunnel_ngu_{tx,rx}_impl.cpp,
gtpu_demux_impl.cpp; SURVEY.md section 2.4): G-PDU encode/decode with
E/S/PN flags, extension headers (PDU Session Container, TS 38.415, carrying
QFI both directions), echo request/response, error indication, end marker,
and a TEID demux.

A copy of ``srsran_project_tpu/l2/gtpu.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

MSG_ECHO_REQUEST = 1
MSG_ECHO_RESPONSE = 2
MSG_ERROR_INDICATION = 26
MSG_END_MARKER = 254
MSG_GPDU = 255

EXT_PDU_SESSION_CONTAINER = 0x85

PDU_SESSION_DL = 0  # container PDU type
PDU_SESSION_UL = 1


@dataclasses.dataclass(frozen=True)
class GtpuPdu:
    msg_type: int
    teid: int
    payload: bytes
    seq: int | None = None
    qfi: int | None = None  # from/for the PDU Session Container ext header
    pdu_session_dl: bool = True


# GTP-U pcap capture hook (reference: gtpu dlt_pcap, DLT 156).  Captures
# every encoded tunnel PDU; rx capture opt-in (loopback links double up).
_PCAP: tuple[object, bool] | None = None


def attach_pcap(writer, capture_rx: bool = False) -> None:
    global _PCAP
    _PCAP = (writer, capture_rx)


def detach_pcap() -> None:
    global _PCAP
    _PCAP = None


def _pdu_session_container(qfi: int, downlink: bool) -> bytes:
    """TS 38.415 DL/UL PDU SESSION INFORMATION (minimal 2-byte body)."""
    t = PDU_SESSION_DL if downlink else PDU_SESSION_UL
    return bytes([(t << 4), qfi & 0x3F])


def encode(pdu: GtpuPdu) -> bytes:
    flags = 0x30  # version 1, PT=1
    if pdu.seq is not None:
        flags |= 0x02  # S
    if pdu.qfi is not None:
        flags |= 0x04  # E
    opt = b""
    if flags & 0x07:
        # seq(2) + N-PDU(1) + next-ext-type(1) are all present whenever any
        # of E/S/PN is set (TS 29.281 5.1)
        next_type = EXT_PDU_SESSION_CONTAINER if pdu.qfi is not None else 0
        opt = (pdu.seq or 0).to_bytes(2, "big") + bytes([0, next_type])
        if pdu.qfi is not None:
            body = _pdu_session_container(pdu.qfi, pdu.pdu_session_dl)
            pad = (4 - (len(body) + 2) % 4) % 4
            # ext length is in 4-byte units and covers len+content+pad+next
            opt += bytes([(len(body) + 2 + pad) // 4]) + body + bytes(pad) + bytes([0])
    body = opt + pdu.payload
    hdr = bytes([flags, pdu.msg_type]) + len(body).to_bytes(2, "big") + pdu.teid.to_bytes(4, "big")
    frame = hdr + body
    if _PCAP is not None:
        _PCAP[0].write_packet(frame)
    return frame


def decode(data: bytes) -> GtpuPdu:
    if _PCAP is not None and _PCAP[1]:
        _PCAP[0].write_packet(bytes(data))
    flags = data[0]
    assert (flags >> 5) == 1, "GTP version must be 1"
    msg_type = data[1]
    length = int.from_bytes(data[2:4], "big")
    teid = int.from_bytes(data[4:8], "big")
    i = 8
    end = 8 + length
    seq = None
    qfi = None
    dl = True
    if flags & 0x07:  # any of E/S/PN present: all three optional fields exist
        seq = int.from_bytes(data[i : i + 2], "big") if flags & 0x02 else None
        next_ext = data[i + 3]
        i += 4
        while next_ext:
            ext_len = data[i] * 4
            content = data[i + 1 : i + ext_len - 1]
            if next_ext == EXT_PDU_SESSION_CONTAINER and len(content) >= 2:
                dl = (content[0] >> 4) == PDU_SESSION_DL
                qfi = content[1] & 0x3F
            next_ext = data[i + ext_len - 1]
            i += ext_len
    return GtpuPdu(msg_type=msg_type, teid=teid, payload=bytes(data[i:end]), seq=seq, qfi=qfi, pdu_session_dl=dl)


def encode_gpdu(teid: int, payload: bytes, qfi: int | None = None, downlink: bool = True) -> bytes:
    return encode(GtpuPdu(MSG_GPDU, teid, payload, qfi=qfi, pdu_session_dl=downlink))


def encode_echo_request(seq: int) -> bytes:
    return encode(GtpuPdu(MSG_ECHO_REQUEST, 0, b"", seq=seq))


def encode_echo_response(seq: int) -> bytes:
    # mandatory Recovery IE (type 14, value 0)
    return encode(GtpuPdu(MSG_ECHO_RESPONSE, 0, bytes([14, 0]), seq=seq))


def encode_end_marker(teid: int) -> bytes:
    return encode(GtpuPdu(MSG_END_MARKER, teid, b""))


class GtpuDemux:
    """TEID -> tunnel callback dispatch (gtpu_demux_impl counterpart)."""

    def __init__(self):
        self._tunnels: dict[int, Callable[[GtpuPdu], None]] = {}
        self.unknown_teid_count = 0
        self.echo_responder: Callable[[bytes], None] | None = None

    def add_tunnel(self, teid: int, cb: Callable[[GtpuPdu], None]) -> None:
        self._tunnels[teid] = cb

    def remove_tunnel(self, teid: int) -> None:
        self._tunnels.pop(teid, None)

    def rx(self, data: bytes) -> None:
        pdu = decode(data)
        if pdu.msg_type == MSG_ECHO_REQUEST:
            if self.echo_responder:
                self.echo_responder(encode_echo_response(pdu.seq or 0))
            return
        cb = self._tunnels.get(pdu.teid)
        if cb is None:
            self.unknown_teid_count += 1
            return
        cb(pdu)
