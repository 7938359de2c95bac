"""DCI payload packing/unpacking — TS 38.212 section 7.3.1 (formats 0_0, 1_0).

Counterpart of the reference's DCI packing (lib/ran dci_packing.cpp and the
scheduler's pdcch assembly; SURVEY.md section 2.4 "Scheduler" PDCCH rows):
fallback formats as bit-exact field layouts, with the RIV (resource
indication value, TS 38.214 5.1.2.2.2) helpers and the common-search-space
size alignment rule (0_0 padded/truncated to the 1_0 size).

Fields are MSB-first on the wire, matching the spec tables' listing order.
A copy of ``srsran_project_tpu/ran/dci.py``.
"""

from __future__ import annotations

import dataclasses

import numpy as np


def riv_encode(rb_start: int, rb_count: int, bwp_rbs: int) -> int:
    """TS 38.214 5.1.2.2.2 resource indication value."""
    assert 1 <= rb_count <= bwp_rbs - rb_start
    if (rb_count - 1) <= bwp_rbs // 2:
        return bwp_rbs * (rb_count - 1) + rb_start
    return bwp_rbs * (bwp_rbs - rb_count + 1) + (bwp_rbs - 1 - rb_start)


def riv_decode(riv: int, bwp_rbs: int) -> tuple[int, int]:
    rb_count = riv // bwp_rbs + 1
    rb_start = riv % bwp_rbs
    if rb_start + rb_count > bwp_rbs:
        rb_count = bwp_rbs - rb_count + 2
        rb_start = bwp_rbs - 1 - rb_start
    return rb_start, rb_count


def _freq_bits(bwp_rbs: int) -> int:
    return int(np.ceil(np.log2(bwp_rbs * (bwp_rbs + 1) / 2)))


class _BitPacker:
    def __init__(self):
        self.bits: list[int] = []

    def put(self, value: int, width: int) -> None:
        self.bits += [(value >> (width - 1 - i)) & 1 for i in range(width)]

    def array(self) -> np.ndarray:
        return np.asarray(self.bits, np.uint8)


class _BitReader:
    def __init__(self, bits: np.ndarray):
        self.bits = [int(b) for b in bits]
        self.i = 0

    def take(self, width: int) -> int:
        v = 0
        for _ in range(width):
            v = (v << 1) | self.bits[self.i]
            self.i += 1
        return v


@dataclasses.dataclass(frozen=True)
class Dci10:
    """DCI format 1_0 (DL grant; common fields for C/SI/P/RA-RNTI scope)."""

    rb_start: int
    rb_count: int
    time_domain_assignment: int = 0
    vrb_to_prb_interleaved: bool = False
    mcs: int = 0
    new_data: bool = True
    rv: int = 0
    harq_id: int = 0
    dai: int = 0
    tpc: int = 0
    pucch_resource: int = 0
    harq_feedback_timing: int = 0


@dataclasses.dataclass(frozen=True)
class Dci00:
    """DCI format 0_0 (UL grant)."""

    rb_start: int
    rb_count: int
    time_domain_assignment: int = 0
    freq_hopping: bool = False
    mcs: int = 0
    new_data: bool = True
    rv: int = 0
    harq_id: int = 0
    tpc: int = 0


def dci_1_0_size(bwp_rbs: int) -> int:
    # id(1) + freq + time(4) + vrb(1) + mcs(5) + ndi(1) + rv(2) + harq(4)
    # + dai(2) + tpc(2) + pucch(3) + k1(3)
    return 1 + _freq_bits(bwp_rbs) + 4 + 1 + 5 + 1 + 2 + 4 + 2 + 2 + 3 + 3


def pack_dci_1_0(d: Dci10, bwp_rbs: int) -> np.ndarray:
    p = _BitPacker()
    p.put(1, 1)  # identifier: 1 = DL format
    p.put(riv_encode(d.rb_start, d.rb_count, bwp_rbs), _freq_bits(bwp_rbs))
    p.put(d.time_domain_assignment, 4)
    p.put(int(d.vrb_to_prb_interleaved), 1)
    p.put(d.mcs, 5)
    p.put(int(d.new_data), 1)
    p.put(d.rv, 2)
    p.put(d.harq_id, 4)
    p.put(d.dai, 2)
    p.put(d.tpc, 2)
    p.put(d.pucch_resource, 3)
    p.put(d.harq_feedback_timing, 3)
    return p.array()


def unpack_dci_1_0(bits: np.ndarray, bwp_rbs: int) -> Dci10:
    r = _BitReader(bits)
    assert r.take(1) == 1, "not a DL DCI"
    rb_start, rb_count = riv_decode(r.take(_freq_bits(bwp_rbs)), bwp_rbs)
    return Dci10(rb_start=rb_start, rb_count=rb_count,
                 time_domain_assignment=r.take(4),
                 vrb_to_prb_interleaved=bool(r.take(1)), mcs=r.take(5),
                 new_data=bool(r.take(1)), rv=r.take(2), harq_id=r.take(4),
                 dai=r.take(2), tpc=r.take(2), pucch_resource=r.take(3),
                 harq_feedback_timing=r.take(3))


def pack_dci_0_0(d: Dci00, bwp_rbs: int, target_size: int | None = None) -> np.ndarray:
    """0_0 is size-aligned to 1_0 in the same search space (7.3.1.0):
    zero-padded, or the frequency field truncated, to target_size."""
    p = _BitPacker()
    p.put(0, 1)  # identifier: 0 = UL format
    p.put(riv_encode(d.rb_start, d.rb_count, bwp_rbs), _freq_bits(bwp_rbs))
    p.put(d.time_domain_assignment, 4)
    p.put(int(d.freq_hopping), 1)
    p.put(d.mcs, 5)
    p.put(int(d.new_data), 1)
    p.put(d.rv, 2)
    p.put(d.harq_id, 4)
    p.put(d.tpc, 2)
    bits = p.array()
    if target_size is None:
        target_size = dci_1_0_size(bwp_rbs)
    if len(bits) < target_size:
        bits = np.concatenate([bits, np.zeros(target_size - len(bits), np.uint8)])
    elif len(bits) > target_size:
        # truncate the MSBs of the frequency-domain field (7.3.1.1.1)
        cut = len(bits) - target_size
        bits = np.concatenate([bits[:1], bits[1 + cut :]])
    return bits


def unpack_dci_0_0(bits: np.ndarray, bwp_rbs: int) -> Dci00:
    nfreq = _freq_bits(bwp_rbs)
    base = 1 + nfreq + 4 + 1 + 5 + 1 + 2 + 4 + 2
    r = _BitReader(bits)
    assert r.take(1) == 0, "not a UL DCI"
    if len(bits) > base:  # padded: ignore the tail
        pass
    elif len(bits) < base:  # truncated frequency field: re-widen
        nfreq -= base - len(bits)
    rb_start, rb_count = riv_decode(r.take(nfreq), bwp_rbs)
    return Dci00(rb_start=rb_start, rb_count=rb_count,
                 time_domain_assignment=r.take(4), freq_hopping=bool(r.take(1)),
                 mcs=r.take(5), new_data=bool(r.take(1)), rv=r.take(2),
                 harq_id=r.take(4), tpc=r.take(2))
