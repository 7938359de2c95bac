"""RLC TM/UM/AM entities — TS 38.322.

Counterpart of the reference's lib/rlc (rlc_tx_am_entity.cpp,
rlc_rx_am_entity.cpp, rlc_{tx,rx}_um_entity.cpp, rlc_tx_tm_entity.cpp;
SURVEY.md section 2.4 "RLC"): byte-level PDU framing plus the protocol
machines — UM segmentation/reassembly with 6/12-bit SNs, AM with 12/18-bit
SNs, segment offsets, status PDUs (NACK lists with SO ranges), poll-driven
status reporting and a retransmission queue.

Host-side protocol logic; the produced PDUs ride the MAC transport blocks
the PHY carries. Timers are virtual (advanced by the caller's slot
clock) so entities are deterministic in tests and simulators.

A copy of ``srsran_project_tpu/l2/rlc.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Callable


# ---------------------------------------------------------------------------
# TM
# ---------------------------------------------------------------------------


class RlcTmEntity:
    """Transparent mode: pass-through with a FIFO (rlc_tx_tm_entity.cpp)."""

    def __init__(self, on_rx_sdu: Callable[[bytes], None] | None = None):
        self._queue: list[bytes] = []
        self.on_rx_sdu = on_rx_sdu or (lambda s: None)

    def tx_sdu(self, sdu: bytes) -> None:
        self._queue.append(sdu)

    def pull_pdu(self, max_size: int) -> bytes | None:
        if self._queue and len(self._queue[0]) <= max_size:
            return self._queue.pop(0)
        return None

    def rx_pdu(self, pdu: bytes) -> None:
        self.on_rx_sdu(pdu)


# ---------------------------------------------------------------------------
# UM
# ---------------------------------------------------------------------------

SI_FULL, SI_FIRST, SI_LAST, SI_MID = 0, 1, 2, 3


def _um_header(si: int, sn: int, so: int | None, sn_bits: int) -> bytes:
    if si == SI_FULL:
        return bytes([0])  # SI=00 | R(6)
    if sn_bits == 6:
        hdr = bytes([(si << 6) | (sn & 0x3F)])
    else:
        hdr = bytes([(si << 6) | ((sn >> 8) & 0x0F), sn & 0xFF])
    if si in (SI_LAST, SI_MID):
        assert so is not None
        hdr += bytes([(so >> 8) & 0xFF, so & 0xFF])
    return hdr


def _um_parse(pdu: bytes, sn_bits: int) -> tuple[int, int, int, bytes]:
    si = (pdu[0] >> 6) & 0x3
    if si == SI_FULL:
        return si, 0, 0, pdu[1:]
    if sn_bits == 6:
        sn = pdu[0] & 0x3F
        i = 1
    else:
        sn = ((pdu[0] & 0x0F) << 8) | pdu[1]
        i = 2
    so = 0
    if si in (SI_LAST, SI_MID):
        so = (pdu[i] << 8) | pdu[i + 1]
        i += 2
    return si, sn, so, pdu[i:]


class RlcUmEntity:
    """UM: unacknowledged mode with segmentation (6/12-bit SN)."""

    def __init__(self, sn_bits: int = 12, on_rx_sdu: Callable[[bytes], None] | None = None,
                 t_reassembly_slots: int = 35):
        assert sn_bits in (6, 12)
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.on_rx_sdu = on_rx_sdu or (lambda s: None)
        self._tx_next = 0
        self._queue: list[bytes] = []
        self._seg: tuple[bytes, int] | None = None  # (sdu, offset) mid-segmentation
        # rx: per-SN segment store {sn: {so: bytes}}, total length when last seen
        self._rx: dict[int, dict] = {}
        self.t_reassembly = t_reassembly_slots
        self._reassembly_deadline: dict[int, int] = {}
        self._now = 0
        self.dropped_sdus = 0

    # -- tx ----------------------------------------------------------------
    def tx_sdu(self, sdu: bytes) -> None:
        self._queue.append(sdu)

    def pull_pdu(self, max_size: int) -> bytes | None:
        if self._seg is None:
            if not self._queue:
                return None
            sdu = self._queue.pop(0)
            hdr_len = 1
            if len(sdu) + hdr_len <= max_size:
                return _um_header(SI_FULL, 0, None, self.sn_bits) + sdu
            self._seg = (sdu, 0)
            hdr = _um_header(SI_FIRST, self._tx_next, None, self.sn_bits)
            take = max_size - len(hdr)
            if take <= 0:
                self._seg = None
                self._queue.insert(0, sdu)
                return None
            self._seg = (sdu, take)
            return hdr + sdu[:take]
        sdu, off = self._seg
        rem = len(sdu) - off
        hdr_last = _um_header(SI_LAST, self._tx_next, off, self.sn_bits)
        if rem + len(hdr_last) <= max_size:
            self._seg = None
            sn = self._tx_next
            self._tx_next = (self._tx_next + 1) % self.mod
            return _um_header(SI_LAST, sn, off, self.sn_bits) + sdu[off:]
        hdr = _um_header(SI_MID, self._tx_next, off, self.sn_bits)
        take = max_size - len(hdr)
        if take <= 0:
            return None
        self._seg = (sdu, off + take)
        return hdr + sdu[off : off + take]

    # -- rx ----------------------------------------------------------------
    def rx_pdu(self, pdu: bytes) -> None:
        si, sn, so, data = _um_parse(pdu, self.sn_bits)
        if si == SI_FULL:
            self.on_rx_sdu(data)
            return
        store = self._rx.setdefault(sn, {"segs": {}, "total": None})
        store["segs"][so] = data
        if si == SI_LAST:
            store["total"] = so + len(data)
        self._reassembly_deadline.setdefault(sn, self._now + self.t_reassembly)
        self._try_reassemble(sn)

    def _try_reassemble(self, sn: int) -> None:
        store = self._rx.get(sn)
        if store is None or store["total"] is None:
            return
        buf = bytearray(store["total"])
        covered = 0
        for so in sorted(store["segs"]):
            seg = store["segs"][so]
            buf[so : so + len(seg)] = seg
            covered += len(seg)
        if covered >= store["total"]:
            del self._rx[sn]
            self._reassembly_deadline.pop(sn, None)
            self.on_rx_sdu(bytes(buf))

    def tick(self, now_slot: int) -> None:
        """Advance the virtual reassembly clock; drop expired partial SDUs."""
        self._now = now_slot
        for sn in [s for s, dl in self._reassembly_deadline.items() if now_slot >= dl]:
            self._rx.pop(sn, None)
            self._reassembly_deadline.pop(sn, None)
            self.dropped_sdus += 1


# ---------------------------------------------------------------------------
# AM
# ---------------------------------------------------------------------------


def _am_header(si: int, sn: int, so: int | None, sn_bits: int, poll: bool) -> bytes:
    dc_p = 0x80 | (0x40 if poll else 0)
    if sn_bits == 12:
        hdr = bytes([dc_p | (si << 4) | ((sn >> 8) & 0x0F), sn & 0xFF])
    else:  # 18-bit SN: D/C|P|SI|R|R then SN(18) over the remaining bits
        hdr = bytes([dc_p | (si << 4) | ((sn >> 16) & 0x03), (sn >> 8) & 0xFF, sn & 0xFF])
    if si in (SI_LAST, SI_MID):
        assert so is not None
        hdr += bytes([(so >> 8) & 0xFF, so & 0xFF])
    return hdr


def _am_parse(pdu: bytes, sn_bits: int) -> tuple[bool, int, int, int, bytes]:
    poll = bool(pdu[0] & 0x40)
    si = (pdu[0] >> 4) & 0x3
    if sn_bits == 12:
        sn = ((pdu[0] & 0x0F) << 8) | pdu[1]
        i = 2
    else:
        sn = ((pdu[0] & 0x03) << 16) | (pdu[1] << 8) | pdu[2]
        i = 3
    so = 0
    if si in (SI_LAST, SI_MID):
        so = (pdu[i] << 8) | pdu[i + 1]
        i += 2
    return poll, si, sn, so, pdu[i:]


@dataclasses.dataclass
class _TxPdu:
    sn: int
    sdu: bytes
    retx_count: int = 0
    acked: bool = False
    # pending retransmit byte ranges [(so, length)]; None = none pending
    retx_ranges: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class AmStatus:
    ack_sn: int
    # NACKs: (sn, so_start, so_end) with so range 0..0xFFFF; (sn, None, None)
    # nacks the whole SDU. so_end = 0xFFFF means "to the last byte".
    nacks: tuple = ()


def encode_status_pdu(status: AmStatus, sn_bits: int = 12) -> bytes:
    """STATUS PDU (6.2.2.5): D/C=0|CPT=000|ACK_SN|E1|R then NACK_SN blocks.

    12-bit SN: ACK part is 3 bytes (4 header bits + SN(12) + E1 + R(7));
    each NACK block is 2 bytes (SN(12)|E1|E2|E3|R) + optional SOstart/SOend.
    18-bit SN: ACK part 3 bytes (4 + 18 + E1 + R); NACK block 3 bytes.
    """
    nacks = list(status.nacks)
    ack = status.ack_sn
    if sn_bits == 12:
        out = bytearray([(ack >> 8) & 0x0F, ack & 0xFF, 0x80 if nacks else 0])
        for k, (sn, so_s, so_e) in enumerate(nacks):
            e1n = 0x8 if k + 1 < len(nacks) else 0
            e2 = 0x4 if so_s is not None else 0
            out += bytes([(sn >> 4) & 0xFF, ((sn & 0xF) << 4) | e1n | e2])
            if so_s is not None:
                out += bytes([(so_s >> 8) & 0xFF, so_s & 0xFF, (so_e >> 8) & 0xFF, so_e & 0xFF])
        return bytes(out)
    out = bytearray([(ack >> 14) & 0x0F, (ack >> 6) & 0xFF,
                     ((ack & 0x3F) << 2) | (0x2 if nacks else 0)])
    for k, (sn, so_s, so_e) in enumerate(nacks):
        e1n = 0x20 if k + 1 < len(nacks) else 0
        e2 = 0x10 if so_s is not None else 0
        out += bytes([(sn >> 10) & 0xFF, (sn >> 2) & 0xFF, ((sn & 0x3) << 6) | e1n | e2])
        if so_s is not None:
            out += bytes([(so_s >> 8) & 0xFF, so_s & 0xFF, (so_e >> 8) & 0xFF, so_e & 0xFF])
    return bytes(out)


def decode_status_pdu(data: bytes, sn_bits: int = 12) -> AmStatus:
    nacks = []
    if sn_bits == 12:
        ack_sn = ((data[0] & 0x0F) << 8) | data[1]
        e1 = bool(data[2] & 0x80)
        i = 3
        while e1:
            sn = (data[i] << 4) | (data[i + 1] >> 4)
            e1 = bool(data[i + 1] & 0x8)
            e2 = bool(data[i + 1] & 0x4)
            i += 2
            if e2:
                so_s = (data[i] << 8) | data[i + 1]
                so_e = (data[i + 2] << 8) | data[i + 3]
                i += 4
                nacks.append((sn, so_s, so_e))
            else:
                nacks.append((sn, None, None))
        return AmStatus(ack_sn=ack_sn, nacks=tuple(nacks))
    ack_sn = ((data[0] & 0x0F) << 14) | (data[1] << 6) | (data[2] >> 2)
    e1 = bool(data[2] & 0x2)
    i = 3
    while e1:
        sn = (data[i] << 10) | (data[i + 1] << 2) | (data[i + 2] >> 6)
        e1 = bool(data[i + 2] & 0x20)
        e2 = bool(data[i + 2] & 0x10)
        i += 3
        if e2:
            so_s = (data[i] << 8) | data[i + 1]
            so_e = (data[i + 2] << 8) | data[i + 3]
            i += 4
            nacks.append((sn, so_s, so_e))
        else:
            nacks.append((sn, None, None))
    return AmStatus(ack_sn=ack_sn, nacks=tuple(nacks))


class RlcAmEntity:
    """Acknowledged mode: segmentation + status-driven retransmission.

    Simulator-fidelity counterpart of rlc_tx_am_entity.cpp /
    rlc_rx_am_entity.cpp: tx window, poll every poll_pdu PDUs (or when the
    queue drains), status PDU generation on the rx side (cumulative ACK_SN +
    NACK list incl. segment-offset ranges), retx queue fed by NACKs,
    max_retx surfacing as a protocol failure flag.
    """

    STATUS_LCID_MARKER = 0x00  # D/C=0 in the first byte distinguishes status

    def __init__(self, sn_bits: int = 12, poll_pdu: int = 16, max_retx: int = 8,
                 on_rx_sdu: Callable[[bytes], None] | None = None):
        assert sn_bits in (12, 18)
        self.sn_bits = sn_bits
        self.mod = 1 << sn_bits
        self.win = self.mod // 2
        self.poll_pdu = poll_pdu
        self.max_retx = max_retx
        self.on_rx_sdu = on_rx_sdu or (lambda s: None)
        # tx state
        self._tx_next = 0
        self._tx_next_ack = 0
        self._queue: list[bytes] = []
        self._seg: tuple[_TxPdu, int] | None = None
        self._outstanding: OrderedDict[int, _TxPdu] = OrderedDict()
        self._pdu_since_poll = 0
        self.max_retx_reached = False
        # rx state
        self._rx_next = 0
        self._rx_store: dict[int, dict] = {}
        self._rx_done: set[int] = set()
        self._status_requested = False

    # -- tx ----------------------------------------------------------------
    def tx_sdu(self, sdu: bytes) -> None:
        self._queue.append(sdu)

    def _poll(self) -> bool:
        self._pdu_since_poll += 1
        if self._pdu_since_poll >= self.poll_pdu or (not self._queue and self._seg is None):
            self._pdu_since_poll = 0
            return True
        return False

    def _hdr_len(self, si: int) -> int:
        base = 2 if self.sn_bits == 12 else 3
        return base + (2 if si in (SI_LAST, SI_MID) else 0)

    def pull_pdu(self, max_size: int) -> bytes | None:
        # retransmissions take priority (as in the reference)
        for pdu in self._outstanding.values():
            if pdu.retx_ranges:
                so, ln = pdu.retx_ranges[0]
                # SO field is present exactly when the segment doesn't start
                # at the beginning of the SDU (SI_LAST / SI_MID)
                hdr_len = (2 if self.sn_bits == 12 else 3) + (2 if so > 0 else 0)
                take = min(ln, max_size - hdr_len)
                if take <= 0:
                    return None
                end = so + take
                if so == 0:
                    si = SI_FULL if end >= len(pdu.sdu) else SI_FIRST
                else:
                    si = SI_LAST if end >= len(pdu.sdu) else SI_MID
                if take == ln:
                    pdu.retx_ranges.pop(0)
                else:
                    pdu.retx_ranges[0] = (end, ln - take)
                return _am_header(si, pdu.sn, so if si in (SI_LAST, SI_MID) else None,
                                  self.sn_bits, self._poll()) + pdu.sdu[so:end]
        # continue an in-progress segmented SDU
        if self._seg is not None:
            pdu, off = self._seg
            rem = len(pdu.sdu) - off
            hdr_last = self._hdr_len(SI_LAST)
            if rem + hdr_last <= max_size:
                self._seg = None
                return _am_header(SI_LAST, pdu.sn, off, self.sn_bits, self._poll()) + pdu.sdu[off:]
            take = max_size - self._hdr_len(SI_MID)
            if take <= 0:
                return None
            self._seg = (pdu, off + take)
            return _am_header(SI_MID, pdu.sn, off, self.sn_bits, self._poll()) + pdu.sdu[off : off + take]
        # new SDU
        if not self._queue:
            return None
        # tx window stall check
        if (self._tx_next - self._tx_next_ack) % self.mod >= self.win:
            return None
        sdu = self._queue.pop(0)
        sn = self._tx_next
        self._tx_next = (self._tx_next + 1) % self.mod
        pdu = _TxPdu(sn=sn, sdu=sdu)
        self._outstanding[sn] = pdu
        if len(sdu) + self._hdr_len(SI_FULL) <= max_size:
            return _am_header(SI_FULL, sn, None, self.sn_bits, self._poll()) + sdu
        take = max_size - self._hdr_len(SI_FIRST)
        if take <= 0:
            self._queue.insert(0, sdu)
            del self._outstanding[sn]
            self._tx_next = sn
            return None
        self._seg = (pdu, take)
        return _am_header(SI_FIRST, sn, None, self.sn_bits, self._poll()) + sdu[:take]

    def rx_status(self, status: AmStatus) -> None:
        """Apply a peer status report: advance ACK state, queue retx."""
        nacked = {sn for sn, _, _ in status.nacks}
        for sn in list(self._outstanding):
            dist = (status.ack_sn - sn) % self.mod
            if 0 < dist <= self.win and sn not in nacked:
                self._outstanding[sn].acked = True
        nacked_sns = set()
        for sn, so_s, so_e in status.nacks:
            pdu = self._outstanding.get(sn)
            if pdu is None:
                continue
            if sn not in nacked_sns:
                # RETX_COUNT is per SDU per NACK event (TS 38.322 5.3.2)
                nacked_sns.add(sn)
                pdu.retx_count += 1
                if pdu.retx_count > self.max_retx:
                    self.max_retx_reached = True
            if so_s is None:
                pdu.retx_ranges = [(0, len(pdu.sdu))]
            else:
                end = len(pdu.sdu) if so_e == 0xFFFF else min(so_e + 1, len(pdu.sdu))
                pdu.retx_ranges.append((so_s, max(0, end - so_s)))
        # advance tx_next_ack over the contiguous acked prefix
        while self._tx_next_ack in self._outstanding and self._outstanding[self._tx_next_ack].acked:
            del self._outstanding[self._tx_next_ack]
            self._tx_next_ack = (self._tx_next_ack + 1) % self.mod

    # -- rx ----------------------------------------------------------------
    def rx_pdu(self, pdu: bytes) -> None:
        if not pdu[0] & 0x80:  # D/C=0: control (status) PDU for OUR tx side
            self.rx_status(decode_status_pdu(pdu, self.sn_bits))
            return
        poll, si, sn, so, data = _am_parse(pdu, self.sn_bits)
        if poll:
            self._status_requested = True
        dist = (sn - self._rx_next) % self.mod
        if sn in self._rx_done or dist >= self.win:
            return  # duplicate / outside window
        if si == SI_FULL:
            self._complete_rx(sn, data)
            return
        store = self._rx_store.setdefault(sn, {"segs": {}, "total": None})
        store["segs"][so] = data
        if si == SI_LAST:
            store["total"] = so + len(data)
        if store["total"] is not None:
            buf = bytearray(store["total"])
            got = [False] * store["total"]
            for s, seg in store["segs"].items():
                buf[s : s + len(seg)] = seg
                for j in range(s, min(s + len(seg), store["total"])):
                    got[j] = True
            if all(got):
                del self._rx_store[sn]
                self._complete_rx(sn, bytes(buf))

    def _complete_rx(self, sn: int, sdu: bytes) -> None:
        self._rx_done.add(sn)
        self.on_rx_sdu(sdu)
        while self._rx_next in self._rx_done:
            self._rx_done.discard(self._rx_next)
            self._rx_next = (self._rx_next + 1) % self.mod

    def build_status(self) -> bytes:
        """Cumulative status for everything seen so far (incl. segment holes).

        ACK_SN = one past the highest in-window SN seen; every incomplete SN
        below it is NACKed (whole-SDU, or SO byte ranges for partials).
        """
        self._status_requested = False
        seen = self._rx_done | set(self._rx_store)
        if not seen:
            return encode_status_pdu(AmStatus(ack_sn=self._rx_next), self.sn_bits)
        rel_max = max((sn - self._rx_next) % self.mod for sn in seen)
        ack_sn = (self._rx_next + rel_max + 1) % self.mod
        nacks = []
        for rel in range(rel_max + 1):
            sn = (self._rx_next + rel) % self.mod
            if sn in self._rx_done:
                continue
            store = self._rx_store.get(sn)
            if store is None:
                nacks.append((sn, None, None))
                continue
            total = store["total"]
            pos = 0
            for s in sorted(store["segs"]):
                if s > pos:
                    nacks.append((sn, pos, s - 1))
                pos = max(pos, s + len(store["segs"][s]))
            if total is None:
                nacks.append((sn, pos, 0xFFFF))  # tail length unknown yet
            elif pos < total:
                nacks.append((sn, pos, total - 1))
        return encode_status_pdu(AmStatus(ack_sn=ack_sn, nacks=tuple(nacks)), self.sn_bits)

    @property
    def status_requested(self) -> bool:
        return self._status_requested
