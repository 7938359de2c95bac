"""Ethernet + 802.1Q VLAN framing for eCPRI (reference: lib/ofh/ethernet).

A copy of ``srsran_project_tpu/ofh/ethernet.py``.

eCPRI ethertype 0xAEFE; frames carry one eCPRI message each.  Pure byte
work (the NIC role is out of scope; socket/DPDK transceivers map here).
"""

from __future__ import annotations

import struct

ETH_TYPE_ECPRI = 0xAEFE
ETH_TYPE_VLAN = 0x8100
MIN_FRAME = 64


def build_frame(dst_mac: bytes, src_mac: bytes, payload: bytes,
                vlan_id: int | None = None, pcp: int = 7) -> bytes:
    """Ethernet II frame (+optional 802.1Q tag), zero-padded to 64 bytes."""
    assert len(dst_mac) == 6 and len(src_mac) == 6
    hdr = dst_mac + src_mac
    if vlan_id is not None:
        tci = ((pcp & 0x7) << 13) | (vlan_id & 0xFFF)
        hdr += struct.pack("!HH", ETH_TYPE_VLAN, tci)
    hdr += struct.pack("!H", ETH_TYPE_ECPRI)
    frame = hdr + payload
    if len(frame) < MIN_FRAME:
        frame += bytes(MIN_FRAME - len(frame))
    return frame


def parse_frame(frame: bytes):
    """Returns (dst, src, vlan_id | None, payload) or None if not eCPRI."""
    dst, src = frame[:6], frame[6:12]
    ethertype = struct.unpack_from("!H", frame, 12)[0]
    off = 14
    vlan_id = None
    if ethertype == ETH_TYPE_VLAN:
        tci = struct.unpack_from("!H", frame, 14)[0]
        vlan_id = tci & 0xFFF
        ethertype = struct.unpack_from("!H", frame, 16)[0]
        off = 18
    if ethertype != ETH_TYPE_ECPRI:
        return None
    return bytes(dst), bytes(src), vlan_id, bytes(frame[off:])
