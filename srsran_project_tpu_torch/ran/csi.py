"""CSI report sizing and (un)packing (TS 38.212 §6.3.1.1.2 / §6.3.2.1.2).

Reference-exact counterpart of lib/ran/csi_report/ (csi_report_on_pusch_
helpers.cpp, csi_report_on_pucch_helpers.cpp, csi_report_on_puxch_
helpers.cpp), golden-tested against the reference binaries in
tests/vectors/test_golden_csi_report.py:

- PUSCH two-part reports: part 1 = CRI | RI | wideband CQI (rank-
  independent), part 2 = [CQI2] | [LI] | PMI sized by the decoded RI via
  the UCI part-2 correspondence (TS 38.212 Table 6.3.2.1.2-4).
- PUCCH single-part wideband reports: CRI | RI | [LI] | padding | PMI |
  CQI, padded to the max size over all ranks.
- Type-I single-panel codebooks for 1, 2 and 4 (mode 1, N1=2 N2=1 O1=4)
  CSI-RS ports; RI restriction maps the packed RI field onto allowed
  ranks (v-th set bit).

The port's own copy of ``srsran_project_tpu/ran/csi.py`` (the port imports
nothing of the JAX package); tests/test_torch_csi_two_step.py holds the
two equal value for value.
"""

from __future__ import annotations

import dataclasses
import math


def _log2_ceil(v: int) -> int:
    return max(0, math.ceil(math.log2(max(1, v))))


QUANTITIES = ("cri_ri_pmi_cqi", "cri_ri_cqi", "cri_ri_li_pmi_cqi")


@dataclasses.dataclass(frozen=True)
class CsiReportConfig:
    nof_csi_rs_ports: int = 4  # 1, 2, 4 (type-I single panel)
    nof_csi_rs_resources: int = 1  # for CRI width
    ri_restriction: int = 0b1111  # allowed-ranks bitmap (bit r-1 = rank r)
    quantities: str = "cri_ri_pmi_cqi"

    @classmethod
    def from_reference(cls, ref) -> "CsiReportConfig":
        """The port's ``CsiReportConfig`` with the fields of ``ref`` (the
        JAX package's class, which compares unequal to this one)."""
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    @property
    def allowed_ranks(self) -> tuple[int, ...]:
        mask = self.ri_restriction & ((1 << self.nof_csi_rs_ports) - 1)
        return tuple(r + 1 for r in range(self.nof_csi_rs_ports) if (mask >> r) & 1)

    @property
    def has_pmi(self) -> bool:
        return self.quantities in ("cri_ri_pmi_cqi", "cri_ri_li_pmi_cqi")

    @property
    def has_li(self) -> bool:
        return self.quantities == "cri_ri_li_pmi_cqi"


def cri_bitwidth(cfg: CsiReportConfig) -> int:
    return _log2_ceil(cfg.nof_csi_rs_resources)


def ri_bitwidth(cfg: CsiReportConfig) -> int:
    """min(cap, ceil(log2(nof allowed ranks))); cap 1 for 2 ports, 2 for 4
    (csi_report_on_puxch_helpers.cpp get_ri_li_cqi_cri_sizes)."""
    p = cfg.nof_csi_rs_ports
    if p == 1:
        return 0
    n = len(cfg.allowed_ranks)
    cap = 1 if p == 2 else 2
    return min(cap, _log2_ceil(n))


def li_bitwidth(cfg: CsiReportConfig, rank: int) -> int:
    p = cfg.nof_csi_rs_ports
    if p == 1:
        return 0
    if p == 2:
        return _log2_ceil(rank)
    return min(2, _log2_ceil(rank))


def pmi_bitwidth(cfg: CsiReportConfig, rank: int) -> int:
    """Type-I single-panel PMI widths (TS 38.212 Table 6.3.1.1.2-1).

    2 ports: 2 bits (rank 1), 1 bit (rank 2).  4 ports mode 1 (N1=2, N2=1,
    O1=4, O2=1): i11 3b (+ i13 1b at rank 2) + i2 (2b rank 1, else 1b).
    """
    p = cfg.nof_csi_rs_ports
    if p == 1:
        return 0
    if p == 2:
        return 2 if rank == 1 else 1
    if p == 4:
        return {1: 5, 2: 5, 3: 4, 4: 4}[rank]
    raise ValueError(f"unsupported port count {p}")


def _pmi_subfield_widths(cfg: CsiReportConfig, rank: int):
    """4-port mode-1 subfields (i11, i13 or None, i2)."""
    assert cfg.nof_csi_rs_ports == 4
    i11 = _log2_ceil(2 * 4)  # N1*O1
    if rank == 1:
        return i11, None, 2
    if rank == 2:
        return i11, 1, 1
    return i11, 0, 1  # rank 3/4: i13 present but zero-width


def cqi2_bitwidth(cfg: CsiReportConfig, rank: int) -> int:
    return 4 if rank > 4 else 0


def part1_bitwidth(cfg: CsiReportConfig) -> int:
    """CSI part 1: CRI + RI + wideband CQI (rank-independent size)."""
    return cri_bitwidth(cfg) + ri_bitwidth(cfg) + 4


def part2_bitwidth(cfg: CsiReportConfig, rank: int) -> int:
    """CSI part 2 for a given rank (TS 38.212 Table 6.3.2.1.2-4)."""
    size = cqi2_bitwidth(cfg, rank)
    if cfg.has_li:
        size += li_bitwidth(cfg, rank)
    if cfg.has_pmi:
        size += pmi_bitwidth(cfg, rank)
    return size


def part2_correspondence(cfg: CsiReportConfig):
    """UCI part-1-to-part-2 size mapping: (ri_offset, ri_width, map) where
    map[v] is the part-2 size for RI field value v (v-th allowed rank), or
    None when there is no part 2 (1 port, or no PMI/LI quantity)."""
    if cfg.nof_csi_rs_ports == 1 or not (cfg.has_pmi or cfg.has_li):
        return None
    sizes = tuple(part2_bitwidth(cfg, r) for r in cfg.allowed_ranks)
    return cri_bitwidth(cfg), ri_bitwidth(cfg), sizes


def part2_min_max(cfg: CsiReportConfig) -> tuple[int, int]:
    corr = part2_correspondence(cfg)
    if corr is None:
        return 0, 0
    return min(corr[2]), max(corr[2])


def pucch_bitwidth(cfg: CsiReportConfig) -> int:
    """PUCCH wideband report size: max over ranks 1..nof_ports of
    CRI+RI+[LI]+PMI+CQI (+CQI2) (get_csi_report_pucch_size)."""
    best = 0
    for rank in range(1, cfg.nof_csi_rs_ports + 1):
        size = cri_bitwidth(cfg) + ri_bitwidth(cfg)
        if cfg.has_li:
            size += li_bitwidth(cfg, rank)
        if cfg.has_pmi:
            size += pmi_bitwidth(cfg, rank)
        size += 4 + cqi2_bitwidth(cfg, rank)
        best = max(best, size)
    return best


# --- bit-field helpers (bounded_bitset::extract order: bit index i is the
# MSB-first i-th bit of the field) ---------------------------------------


def _extract(bits, pos: int, width: int) -> int:
    v = 0
    for i in range(width):
        v = (v << 1) | int(bits[pos + i])
    return v


def _deposit(bits, pos: int, width: int, value: int) -> None:
    for i in range(width):
        bits[pos + i] = (value >> (width - 1 - i)) & 1


def _unpack_ri(cfg: CsiReportConfig, value: int, width: int) -> int:
    """RI field value -> rank: v-th allowed rank (csi_report_unpack_ri);
    an empty field means rank 1."""
    if width == 0:
        return 1
    allowed = cfg.allowed_ranks
    if value >= len(allowed):
        raise ValueError(f"RI field {value} out of range for {allowed}")
    return allowed[value]


def _ri_field_value(cfg: CsiReportConfig, rank: int) -> int:
    return cfg.allowed_ranks.index(rank)


def unpack_part1(cfg: CsiReportConfig, bits):
    """Part 1 bits -> (cri, rank, wideband cqi)."""
    pos = 0
    cri = _extract(bits, pos, cri_bitwidth(cfg))
    pos += cri_bitwidth(cfg)
    ri = _unpack_ri(cfg, _extract(bits, pos, ri_bitwidth(cfg)), ri_bitwidth(cfg))
    pos += ri_bitwidth(cfg)
    cqi = _extract(bits, pos, 4)
    return cri, ri, cqi


def pack_part1(cfg: CsiReportConfig, cri: int, ri: int, cqi: int):
    import numpy as np

    bits = np.zeros(part1_bitwidth(cfg), np.uint8)
    pos = 0
    _deposit(bits, pos, cri_bitwidth(cfg), cri)
    pos += cri_bitwidth(cfg)
    _deposit(bits, pos, ri_bitwidth(cfg), _ri_field_value(cfg, ri))
    pos += ri_bitwidth(cfg)
    _deposit(bits, pos, 4, cqi)
    return bits


def unpack_part2(cfg: CsiReportConfig, rank: int, bits) -> dict:
    """Part 2 bits -> {li?, pmi? | i11/i13/i2?, cqi2?} for the given rank."""
    out: dict = {}
    pos = 0
    if cqi2_bitwidth(cfg, rank):
        out["cqi2"] = _extract(bits, pos, 4)
        pos += 4
    if cfg.has_li:
        w = li_bitwidth(cfg, rank)
        out["li"] = _extract(bits, pos, w)
        pos += w
    if cfg.has_pmi and cfg.nof_csi_rs_ports > 1:
        if cfg.nof_csi_rs_ports == 2:
            w = pmi_bitwidth(cfg, rank)
            out["pmi"] = _extract(bits, pos, w)
            pos += w
        else:
            w11, w13, w2 = _pmi_subfield_widths(cfg, rank)
            out["i11"] = _extract(bits, pos, w11)
            pos += w11
            if w13 is not None:
                out["i13"] = _extract(bits, pos, w13)
                pos += w13
            out["i2"] = _extract(bits, pos, w2)
            pos += w2
    assert pos == len(bits), (pos, len(bits))
    return out


def pack_part2(cfg: CsiReportConfig, rank: int, **fields):
    import numpy as np

    bits = np.zeros(part2_bitwidth(cfg, rank), np.uint8)
    pos = 0
    if cqi2_bitwidth(cfg, rank):
        _deposit(bits, pos, 4, fields.get("cqi2", 0))
        pos += 4
    if cfg.has_li:
        w = li_bitwidth(cfg, rank)
        _deposit(bits, pos, w, fields.get("li", 0))
        pos += w
    if cfg.has_pmi and cfg.nof_csi_rs_ports > 1:
        if cfg.nof_csi_rs_ports == 2:
            w = pmi_bitwidth(cfg, rank)
            _deposit(bits, pos, w, fields.get("pmi", 0))
            pos += w
        else:
            w11, w13, w2 = _pmi_subfield_widths(cfg, rank)
            _deposit(bits, pos, w11, fields.get("i11", 0))
            pos += w11
            if w13 is not None:
                _deposit(bits, pos, w13, fields.get("i13", 0))
                pos += w13
            _deposit(bits, pos, w2, fields.get("i2", 0))
            pos += w2
    return bits


def part2_size_from_part1(cfg: CsiReportConfig, part1_bits) -> int:
    """UCI part-2 size from a decoded part 1 (uci_part2_size_calculator
    role): the RI field indexes the correspondence map."""
    corr = part2_correspondence(cfg)
    if corr is None:
        return 0
    off, width, sizes = corr
    v = _extract(part1_bits, off, width) if width else 0
    return sizes[v]


def unpack_pucch(cfg: CsiReportConfig, bits):
    """PUCCH single-part report -> (cri, rank, li, pmi-fields dict, cqi).

    Layout CRI | RI | [LI] | padding | PMI | CQI (TS 38.212 Table
    6.3.1.1.2-7); padding stretches the rank-dependent size to the
    rank-max report size.
    """
    pos = 0
    cri = _extract(bits, pos, cri_bitwidth(cfg))
    pos += cri_bitwidth(cfg)
    rank = _unpack_ri(cfg, _extract(bits, pos, ri_bitwidth(cfg)), ri_bitwidth(cfg))
    pos += ri_bitwidth(cfg)
    li = None
    if cfg.has_li:
        w = li_bitwidth(cfg, rank)
        li = _extract(bits, pos, w)
        pos += w
    # Skip padding: total size minus this rank's unpadded size.
    unpadded = cri_bitwidth(cfg) + ri_bitwidth(cfg) + 4 + cqi2_bitwidth(cfg, rank)
    if cfg.has_li:
        unpadded += li_bitwidth(cfg, rank)
    if cfg.has_pmi:
        unpadded += pmi_bitwidth(cfg, rank)
    pos += len(bits) - unpadded
    pmi: dict = {}
    if cfg.has_pmi and cfg.nof_csi_rs_ports > 1:
        if cfg.nof_csi_rs_ports == 2:
            w = pmi_bitwidth(cfg, rank)
            pmi["pmi"] = _extract(bits, pos, w)
            pos += w
        else:
            w11, w13, w2 = _pmi_subfield_widths(cfg, rank)
            pmi["i11"] = _extract(bits, pos, w11)
            pos += w11
            if w13 is not None:
                pmi["i13"] = _extract(bits, pos, w13)
                pos += w13
            pmi["i2"] = _extract(bits, pos, w2)
            pos += w2
    cqi = _extract(bits, pos, 4)
    pos += 4
    if cqi2_bitwidth(cfg, rank):
        pos += 4  # second-TB CQI (rank > 4; not reachable for <=4 ports)
    return cri, rank, li, pmi, cqi
