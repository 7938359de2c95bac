"""NR-U (F1-U user plane) frames — TS 38.425.

Counterpart of the reference's lib/nru + lib/f1u (SURVEY.md section 2.4
"F1U / NR-U"): DL USER DATA (PDU type 0) carrying the NR-U sequence number
DU-ward, and DL DATA DELIVERY STATUS (PDU type 1) feeding flow control
back CU-ward (desired buffer size, highest delivered/transmitted NR PDCP
SN, lost-frame report).  These frames ride GTP-U G-PDUs on F1-U.

A copy of ``srsran_project_tpu/l2/nru.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses

PDU_TYPE_DL_USER_DATA = 0
PDU_TYPE_DL_DATA_DELIVERY_STATUS = 1


@dataclasses.dataclass(frozen=True)
class NruDlUserData:
    nru_sn: int  # NR-U sequence number (24-bit)
    payload: bytes  # one PDCP PDU
    report_polling: bool = False
    retransmission: bool = False
    user_data_exists: bool = True


def encode_dl_user_data(d: NruDlUserData) -> bytes:
    b0 = (PDU_TYPE_DL_USER_DATA << 4) | (0x04 if d.report_polling else 0)
    b1 = (0x40 if d.retransmission else 0)
    hdr = bytes([b0, b1]) + d.nru_sn.to_bytes(3, "big") + bytes(1)  # pad to 6
    return hdr + d.payload


def decode_dl_user_data(data: bytes) -> NruDlUserData:
    assert (data[0] >> 4) == PDU_TYPE_DL_USER_DATA
    return NruDlUserData(
        nru_sn=int.from_bytes(data[2:5], "big"),
        payload=bytes(data[6:]),
        report_polling=bool(data[0] & 0x04),
        retransmission=bool(data[1] & 0x40),
    )


@dataclasses.dataclass(frozen=True)
class NruDlStatus:
    desired_buffer_size: int
    highest_delivered_pdcp_sn: int | None = None
    highest_transmitted_pdcp_sn: int | None = None
    lost_sn_ranges: tuple = ()  # ((start, end), ...) NR-U SN ranges


def encode_dl_status(s: NruDlStatus) -> bytes:
    b0 = PDU_TYPE_DL_DATA_DELIVERY_STATUS << 4
    flags = 0
    if s.highest_transmitted_pdcp_sn is not None:
        flags |= 0x08
    if s.highest_delivered_pdcp_sn is not None:
        flags |= 0x04
    if s.lost_sn_ranges:
        flags |= 0x02
    out = bytearray([b0, flags])
    out += s.desired_buffer_size.to_bytes(4, "big")
    if s.highest_transmitted_pdcp_sn is not None:
        out += s.highest_transmitted_pdcp_sn.to_bytes(3, "big")
    if s.highest_delivered_pdcp_sn is not None:
        out += s.highest_delivered_pdcp_sn.to_bytes(3, "big")
    if s.lost_sn_ranges:
        out += bytes([len(s.lost_sn_ranges)])
        for a, b in s.lost_sn_ranges:
            out += a.to_bytes(3, "big") + b.to_bytes(3, "big")
    return bytes(out)


def decode_dl_status(data: bytes) -> NruDlStatus:
    assert (data[0] >> 4) == PDU_TYPE_DL_DATA_DELIVERY_STATUS
    flags = data[1]
    i = 2
    dbs = int.from_bytes(data[i : i + 4], "big")
    i += 4
    htx = hdl = None
    lost = []
    if flags & 0x08:
        htx = int.from_bytes(data[i : i + 3], "big")
        i += 3
    if flags & 0x04:
        hdl = int.from_bytes(data[i : i + 3], "big")
        i += 3
    if flags & 0x02:
        n = data[i]
        i += 1
        for _ in range(n):
            a = int.from_bytes(data[i : i + 3], "big")
            b = int.from_bytes(data[i + 3 : i + 6], "big")
            lost.append((a, b))
            i += 6
    return NruDlStatus(desired_buffer_size=dbs, highest_delivered_pdcp_sn=hdl,
                       highest_transmitted_pdcp_sn=htx, lost_sn_ranges=tuple(lost))
