"""PDCP entities — TS 38.323.

Counterpart of the reference's lib/pdcp (pdcp_entity_tx.cpp,
pdcp_entity_rx.cpp; SURVEY.md section 2.4 "PDCP"): 12/18-bit SN data PDUs,
COUNT = HFN||SN with window-based HFN inference on RX, in-order delivery
with a t-Reordering window, integrity (MAC-I) + ciphering through the
SecurityEngine (security.py), status-report control PDUs (FMC + bitmap),
and discard of integrity-failed or duplicate PDUs.

Host-side byte logic over the RLC layer; timers are virtual (caller-driven
ticks) as in rlc.py.

A copy of ``srsran_project_tpu/l2/pdcp.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from .security import DIR_DOWNLINK, DIR_UPLINK, SecurityEngine

PDU_TYPE_STATUS = 0


def _data_header(sn: int, sn_bits: int, is_srb: bool) -> bytes:
    if is_srb:  # R|R|R|R|SN(12)
        return bytes([(sn >> 8) & 0x0F, sn & 0xFF])
    if sn_bits == 12:  # D/C=1|R|R|R|SN(12)
        return bytes([0x80 | ((sn >> 8) & 0x0F), sn & 0xFF])
    return bytes([0x80 | ((sn >> 16) & 0x03), (sn >> 8) & 0xFF, sn & 0xFF])


def _parse_data_header(pdu: bytes, sn_bits: int, is_srb: bool) -> tuple[int, bytes, bytes]:
    """Returns (sn, header_bytes, body)."""
    if is_srb:
        return ((pdu[0] & 0x0F) << 8) | pdu[1], pdu[:2], pdu[2:]
    if sn_bits == 12:
        return ((pdu[0] & 0x0F) << 8) | pdu[1], pdu[:2], pdu[2:]
    return ((pdu[0] & 0x03) << 16) | (pdu[1] << 8) | pdu[2], pdu[:3], pdu[3:]


def encode_status_report(fmc: int, missing: list[int], last_count: int | None = None) -> bytes:
    """Control PDU: D/C=0|PDU type=0|R, FMC(32), bitmap of COUNTs > FMC.

    Bitmap bit=1 means received (TS 38.323 6.3.10); it spans FMC+1..last_count
    (default: the highest missing COUNT) and byte-padding bits are set to 1 so
    they never read back as missing.
    """
    out = bytearray([0x00 | (PDU_TYPE_STATUS << 4)])
    out += fmc.to_bytes(4, "big")
    if missing:
        span = (last_count if last_count is not None else max(missing)) - fmc
        nbytes = (span + 7) // 8
        bitmap = bytearray(b"\xff" * nbytes)
        miss = set(missing)
        for c in range(fmc + 1, fmc + span + 1):
            if c in miss:
                bitmap[(c - fmc - 1) // 8] &= ~(0x80 >> ((c - fmc - 1) % 8)) & 0xFF
        out += bitmap
    return bytes(out)


def decode_status_report(pdu: bytes) -> tuple[int, list[int]]:
    fmc = int.from_bytes(pdu[1:5], "big")
    missing = [fmc]
    for i, byte in enumerate(pdu[5:]):
        for b in range(8):
            if not byte & (0x80 >> b):
                missing.append(fmc + 1 + 8 * i + b)
    return fmc, missing


@dataclasses.dataclass(frozen=True)
class PdcpConfig:
    sn_bits: int = 18  # 12 or 18
    is_srb: bool = False
    integrity: bool = True
    t_reordering_slots: int = 100
    discard_timer_slots: int | None = None


class PdcpEntity:
    """Bidirectional PDCP entity (one TX + one RX half, TS 38.323 5.1/5.2)."""

    def __init__(self, cfg: PdcpConfig, engine: SecurityEngine | None,
                 is_downlink_tx: bool, on_rx_sdu: Callable[[bytes], None] | None = None):
        assert cfg.sn_bits in (12, 18)
        if cfg.is_srb:
            assert cfg.sn_bits == 12
        self.cfg = cfg
        self.engine = engine
        self.tx_dir = DIR_DOWNLINK if is_downlink_tx else DIR_UPLINK
        self.rx_dir = DIR_UPLINK if is_downlink_tx else DIR_DOWNLINK
        self.on_rx_sdu = on_rx_sdu or (lambda s: None)
        self.mod = 1 << cfg.sn_bits
        self.window = self.mod // 2
        # tx state
        self.tx_next = 0
        # rx state (TS 38.323 5.2.2): RX_NEXT, RX_DELIV, RX_REORD
        self.rx_next = 0
        self.rx_deliv = 0
        self.rx_reord = 0
        self._reorder_buf: dict[int, bytes] = {}  # COUNT -> SDU
        self._t_reordering_deadline: int | None = None
        self._now = 0
        self.rx_integrity_failures = 0
        self.rx_dropped = 0

    # -- tx ------------------------------------------------------------------
    def tx_sdu(self, sdu: bytes) -> bytes:
        """SDU -> PDCP data PDU (header + ciphered payload [+ MAC-I])."""
        count = self.tx_next
        sn = count & (self.mod - 1)
        hdr = _data_header(sn, self.cfg.sn_bits, self.cfg.is_srb)
        if self.engine is not None:
            body = self.engine.protect(count, self.tx_dir, hdr, sdu) if self.cfg.integrity \
                else self.engine.protect(count, self.tx_dir, b"", sdu)
        else:
            body = sdu
        self.tx_next += 1
        return hdr + body

    # -- rx ------------------------------------------------------------------
    def _infer_count(self, rcvd_sn: int) -> int:
        # TS 38.323 5.2.2.1 (plain-integer comparisons; bounds may be negative)
        deliv_sn = self.rx_deliv & (self.mod - 1)
        deliv_hfn = self.rx_deliv >> self.cfg.sn_bits
        if rcvd_sn < deliv_sn - self.window:
            hfn = deliv_hfn + 1
        elif rcvd_sn >= deliv_sn + self.window:
            hfn = deliv_hfn - 1
        else:
            hfn = deliv_hfn
        return (hfn << self.cfg.sn_bits) | rcvd_sn

    def rx_pdu(self, pdu: bytes) -> None:
        if not self.cfg.is_srb and not pdu[0] & 0x80:
            return  # control PDU (status report handled by caller via decode)
        rcvd_sn, hdr, body = _parse_data_header(pdu, self.cfg.sn_bits, self.cfg.is_srb)
        count = self._infer_count(rcvd_sn)
        if self.engine is not None:
            if self.cfg.integrity:
                sdu, ok = self.engine.unprotect(count, self.rx_dir, hdr, body)
                if not ok:
                    self.rx_integrity_failures += 1
                    return
            else:
                sdu, _ = self.engine.unprotect(count, self.rx_dir, b"", body)
        else:
            sdu = body
        if count < self.rx_deliv or count in self._reorder_buf:
            self.rx_dropped += 1
            return  # duplicate / outside window
        self._reorder_buf[count] = sdu
        if count >= self.rx_next:
            self.rx_next = count + 1
        # in-order delivery from RX_DELIV
        while self.rx_deliv in self._reorder_buf:
            self.on_rx_sdu(self._reorder_buf.pop(self.rx_deliv))
            self.rx_deliv += 1
        # t-Reordering management (5.2.2.2)
        if self._t_reordering_deadline is not None and self.rx_deliv >= self.rx_reord:
            self._t_reordering_deadline = None
        if self._t_reordering_deadline is None and self.rx_deliv < self.rx_next:
            self.rx_reord = self.rx_next
            self._t_reordering_deadline = self._now + self.cfg.t_reordering_slots

    def tick(self, now_slot: int) -> None:
        """Advance the reordering clock; on expiry, deliver across the gap."""
        self._now = now_slot
        if self._t_reordering_deadline is not None and now_slot >= self._t_reordering_deadline:
            self._t_reordering_deadline = None
            # deliver all buffered with COUNT < RX_REORD, then in-order from there
            for count in sorted(c for c in self._reorder_buf if c < self.rx_reord):
                self.on_rx_sdu(self._reorder_buf.pop(count))
            self.rx_deliv = max(self.rx_deliv, self.rx_reord)
            while self.rx_deliv in self._reorder_buf:
                self.on_rx_sdu(self._reorder_buf.pop(self.rx_deliv))
                self.rx_deliv += 1
            if self.rx_deliv < self.rx_next:
                self.rx_reord = self.rx_next
                self._t_reordering_deadline = now_slot + self.cfg.t_reordering_slots

    def build_status_report(self) -> bytes:
        fmc = self.rx_deliv
        missing = [c for c in range(fmc + 1, self.rx_next) if c not in self._reorder_buf]
        return encode_status_report(fmc, missing, last_count=self.rx_next - 1 if missing else None)
