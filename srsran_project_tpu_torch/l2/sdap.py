"""SDAP — TS 37.324: QoS-flow to DRB mapping with 1-byte headers.

Counterpart of the reference's lib/sdap (SURVEY.md section 2.4, CU-UP row):
DL header = RDI|RQI|QFI(6), UL header = D/C|R|QFI(6); entities map QFI->DRB
and (de)frame SDUs.  Header presence is configurable per DRB as in RRC.

A copy of ``srsran_project_tpu/l2/sdap.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable


def encode_dl_header(qfi: int, rdi: bool = False, rqi: bool = False) -> bytes:
    return bytes([(0x80 if rdi else 0) | (0x40 if rqi else 0) | (qfi & 0x3F)])


def decode_dl_header(b: int) -> tuple[int, bool, bool]:
    return b & 0x3F, bool(b & 0x80), bool(b & 0x40)


def encode_ul_header(qfi: int, dc_data: bool = True) -> bytes:
    return bytes([(0x80 if dc_data else 0) | (qfi & 0x3F)])


def decode_ul_header(b: int) -> tuple[int, bool]:
    return b & 0x3F, bool(b & 0x80)


@dataclasses.dataclass(frozen=True)
class SdapConfig:
    dl_header: bool = True
    ul_header: bool = True
    default_drb: int = 1


class SdapEntity:
    """QFI->DRB mapping + header handling for one PDU session."""

    def __init__(self, cfg: SdapConfig, on_rx_sdu: Callable[[int, bytes], None] | None = None):
        self.cfg = cfg
        self.qfi_to_drb: dict[int, int] = {}
        self.on_rx_sdu = on_rx_sdu or (lambda qfi, s: None)

    def map_flow(self, qfi: int, drb: int) -> None:
        self.qfi_to_drb[qfi] = drb

    def tx_sdu(self, qfi: int, sdu: bytes, downlink: bool = True) -> tuple[int, bytes]:
        """Returns (drb_id, sdap_pdu)."""
        drb = self.qfi_to_drb.get(qfi, self.cfg.default_drb)
        if downlink and self.cfg.dl_header:
            return drb, encode_dl_header(qfi) + sdu
        if not downlink and self.cfg.ul_header:
            return drb, encode_ul_header(qfi) + sdu
        return drb, sdu

    def rx_pdu(self, pdu: bytes, downlink: bool = True) -> tuple[int, bytes]:
        """Returns (qfi, sdu) and notifies the callback."""
        has_hdr = self.cfg.dl_header if downlink else self.cfg.ul_header
        if has_hdr:
            qfi = pdu[0] & 0x3F
            sdu = pdu[1:]
        else:
            qfi, sdu = 0, pdu
        self.on_rx_sdu(qfi, sdu)
        return qfi, sdu
