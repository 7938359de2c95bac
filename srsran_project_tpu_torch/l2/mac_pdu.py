"""MAC PDU (DL-SCH / UL-SCH) subPDU framing and MAC CEs — TS 38.321 6.1/6.2.

Counterpart of the reference's MAC PDU assembly/decode
(lib/mac/mac_dl/dl_sch_pdu_assembler.cpp, lib/mac/mac_ul/ul_phy_pdu* and
mac_ul_sch_pdu decode; SURVEY.md section 2.4 "MAC"): byte-level encode and
decode of MAC subPDUs (R/F/LCID subheaders with 8- or 16-bit L fields),
the fixed/variable MAC CEs both directions, and the RAR PDU.

Pure-bytes host-side logic: MAC PDUs are the transport-block payloads the
PDSCH/PUSCH processors carry; nothing here touches the device.

Copy of ``srsran_project_tpu/l2/mac_pdu.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
import enum


class DlLcid(enum.IntEnum):
    """DL-SCH LCID values (TS 38.321 Table 6.2.1-1)."""

    CCCH = 0
    # 1..32 = logical channel identity
    RECOMMENDED_BIT_RATE = 47
    SP_CSI_ACTIVATION = 56
    LONG_DRX_CMD = 59
    DRX_CMD = 60
    TA_CMD = 61
    CON_RES_ID = 62
    PADDING = 63


class UlLcid(enum.IntEnum):
    """UL-SCH LCID values (TS 38.321 Table 6.2.1-2)."""

    CCCH64 = 0
    # 1..32 = logical channel identity
    CCCH48 = 52
    MULTI_PHR = 56
    SINGLE_PHR = 57
    CRNTI = 58
    SHORT_TRUNC_BSR = 59
    LONG_TRUNC_BSR = 60
    SHORT_BSR = 61
    LONG_BSR = 62
    PADDING = 63

MAX_LCID = 32  # logical-channel SDU LCID range is 1..32

# Fixed-size MAC CE payload lengths in bytes (subheader carries no L field).
_FIXED_CE_LEN_DL = {
    int(DlLcid.TA_CMD): 1,
    int(DlLcid.CON_RES_ID): 6,
    int(DlLcid.DRX_CMD): 0,
    int(DlLcid.LONG_DRX_CMD): 0,
    int(DlLcid.SP_CSI_ACTIVATION): 1,
}
_FIXED_CE_LEN_UL = {
    int(UlLcid.CRNTI): 2,
    int(UlLcid.SINGLE_PHR): 2,
    int(UlLcid.SHORT_BSR): 1,
    int(UlLcid.SHORT_TRUNC_BSR): 1,
    int(UlLcid.CCCH48): 6,
    int(UlLcid.CCCH64): 8,
}


@dataclasses.dataclass(frozen=True)
class MacSubPdu:
    lcid: int
    payload: bytes

    @property
    def is_padding(self) -> bool:
        return self.lcid == 63


def _subheader(lcid: int, length: int, fixed: bool) -> bytes:
    """R|F|LCID [+ L] subheader per TS 38.321 6.1.2."""
    if fixed:
        return bytes([lcid & 0x3F])
    if length < 256:
        return bytes([lcid & 0x3F, length])
    return bytes([0x40 | (lcid & 0x3F), (length >> 8) & 0xFF, length & 0xFF])


def _is_fixed(lcid: int, uplink: bool) -> bool:
    table = _FIXED_CE_LEN_UL if uplink else _FIXED_CE_LEN_DL
    return lcid in table or lcid == 63


def encode_mac_pdu(subpdus: list[MacSubPdu], tb_size: int | None = None, *, uplink: bool = False) -> bytes:
    """Assemble subPDUs into a MAC PDU, padding to tb_size if given.

    Padding uses a final LCID=63 subPDU (or 1-2 one-byte padding subheaders
    when <=2 bytes remain, per 38.321 6.1.2 note on short padding).
    """
    out = bytearray()
    for sp in subpdus:
        fixed = _is_fixed(sp.lcid, uplink)
        out += _subheader(sp.lcid, len(sp.payload), fixed)
        out += sp.payload
    if tb_size is not None:
        if len(out) > tb_size:
            raise ValueError(f"MAC PDU {len(out)}B exceeds TB {tb_size}B")
        rem = tb_size - len(out)
        if rem:
            # padding subPDU: one subheader byte + zero fill (its payload needs
            # no L field: padding extends to the end of the PDU)
            out += bytes([63]) * min(rem, 1)
            out += bytes(rem - 1)
    return bytes(out)


def decode_mac_pdu(data: bytes, *, uplink: bool = False) -> list[MacSubPdu]:
    """Parse a MAC PDU into subPDUs; padding terminates the walk."""
    table = _FIXED_CE_LEN_UL if uplink else _FIXED_CE_LEN_DL
    out: list[MacSubPdu] = []
    i = 0
    n = len(data)
    while i < n:
        hdr = data[i]
        lcid = hdr & 0x3F
        i += 1
        if lcid == 63:
            out.append(MacSubPdu(63, bytes(n - i)))
            break
        if lcid in table:
            ln = table[lcid]
            out.append(MacSubPdu(lcid, bytes(data[i : i + ln])))
            i += ln
            continue
        if hdr & 0x40:  # F=1: 16-bit L
            ln = (data[i] << 8) | data[i + 1]
            i += 2
        else:
            ln = data[i]
            i += 1
        out.append(MacSubPdu(lcid, bytes(data[i : i + ln])))
        i += ln
    return out


# ---------------------------------------------------------------------------
# MAC CE payload codecs
# ---------------------------------------------------------------------------


def ce_ta_command(tag_id: int, ta_cmd: int) -> bytes:
    """Timing Advance Command CE (6.1.3.4): TAG(2) | TA(6)."""
    return bytes([((tag_id & 0x3) << 6) | (ta_cmd & 0x3F)])


def parse_ta_command(b: bytes) -> tuple[int, int]:
    return (b[0] >> 6) & 0x3, b[0] & 0x3F


def ce_con_res_id(ccch_bits48: bytes) -> bytes:
    """UE Contention Resolution Identity CE (6.1.3.3): first 48 bits of CCCH SDU."""
    return bytes(ccch_bits48[:6]).ljust(6, b"\0")


def ce_crnti(rnti: int) -> bytes:
    return bytes([(rnti >> 8) & 0xFF, rnti & 0xFF])


def parse_crnti(b: bytes) -> int:
    return (b[0] << 8) | b[1]


def ce_short_bsr(lcg: int, bs_index: int) -> bytes:
    """Short BSR CE (6.1.3.1): LCG(3) | buffer-size index(5)."""
    return bytes([((lcg & 0x7) << 5) | (bs_index & 0x1F)])


def parse_short_bsr(b: bytes) -> tuple[int, int]:
    return (b[0] >> 5) & 0x7, b[0] & 0x1F


def ce_long_bsr(bs_by_lcg: dict[int, int]) -> bytes:
    """Long BSR CE (6.1.3.1): LCG bitmap byte + 8-bit BS index per set LCG."""
    bitmap = 0
    body = bytearray()
    for lcg in sorted(bs_by_lcg):
        bitmap |= 1 << lcg
        body.append(bs_by_lcg[lcg] & 0xFF)
    return bytes([bitmap]) + bytes(body)


def parse_long_bsr(b: bytes) -> dict[int, int]:
    bitmap = b[0]
    out = {}
    i = 1
    for lcg in range(8):
        if bitmap & (1 << lcg):
            out[lcg] = b[i]
            i += 1
    return out


def ce_single_phr(ph: int, pcmax: int) -> bytes:
    """Single-entry PHR CE (6.1.3.8): R|R|PH(6), R|R|Pcmax(6)."""
    return bytes([ph & 0x3F, pcmax & 0x3F])


def parse_single_phr(b: bytes) -> tuple[int, int]:
    return b[0] & 0x3F, b[1] & 0x3F


# Short BSR buffer-size table (TS 38.321 Table 6.1.3.1-1, 5-bit index): upper
# edge in bytes; index 0 = 0 bytes, 31 = > 150000.
BSR_5BIT_TABLE = (
    0, 10, 14, 20, 28, 38, 53, 74, 102, 142, 198, 276, 384, 535, 745, 1038,
    1446, 2014, 2806, 3909, 5446, 7587, 10570, 14726, 20516, 28581, 39818,
    55474, 77284, 107669, 150000, 1 << 62,
)


def bsr_index_from_bytes(nof_bytes: int) -> int:
    """Smallest 5-bit BSR index whose upper edge covers nof_bytes."""
    for idx, edge in enumerate(BSR_5BIT_TABLE):
        if nof_bytes <= edge:
            return idx
    return 31


# ---------------------------------------------------------------------------
# RAR PDU (TS 38.321 6.1.5 / 6.2.3)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class RarGrant:
    rapid: int
    ta: int  # 12-bit timing advance command
    ul_grant: int  # 27-bit UL grant field
    tc_rnti: int


def encode_rar_pdu(grants: list[RarGrant], backoff_ms_index: int | None = None) -> bytes:
    """MAC RAR PDU: optional BI subheader then E|T=1|RAPID + 7-byte RAR each."""
    out = bytearray()
    more_after_bi = bool(grants)
    if backoff_ms_index is not None:
        e = 0x80 if more_after_bi else 0
        out.append(e | 0x00 | (backoff_ms_index & 0x0F))  # T=0, R|R|BI
    for k, g in enumerate(grants):
        e = 0x80 if k + 1 < len(grants) else 0
        out.append(e | 0x40 | (g.rapid & 0x3F))  # T=1
        # 56-bit RAR: R(1) TA(12) UL grant(27) TC-RNTI(16)
        v = (g.ta & 0xFFF) << 43 | (g.ul_grant & 0x7FFFFFF) << 16 | (g.tc_rnti & 0xFFFF)
        out += v.to_bytes(7, "big")
    return bytes(out)


def decode_rar_pdu(data: bytes) -> tuple[int | None, list[RarGrant]]:
    grants: list[RarGrant] = []
    backoff = None
    i = 0
    while i < len(data):
        hdr = data[i]
        i += 1
        if not hdr & 0x40:  # BI subheader
            backoff = hdr & 0x0F
        else:
            rapid = hdr & 0x3F
            v = int.from_bytes(data[i : i + 7], "big")
            i += 7
            grants.append(
                RarGrant(rapid=rapid, ta=(v >> 43) & 0xFFF, ul_grant=(v >> 16) & 0x7FFFFFF, tc_rnti=v & 0xFFFF)
            )
        if not hdr & 0x80:
            break
    return backoff, grants
