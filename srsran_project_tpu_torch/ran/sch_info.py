"""Full UL-SCH / DL-SCH derived-parameter computation (TS 38.212 §6.3.2.4,
TS 38.214).

Counterpart of the reference's lib/ran/pusch/ulsch_info.cpp,
lib/ran/pdsch/dlsch_info.cpp and lib/ran/sch/sch_segmentation.cpp —
config-in / derived-numbers-out pure functions, conformance-tested against
reference goldens (tests/vectors/test_golden_ran.py).

Copy of ``srsran_project_tpu/ran/sch_info.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
import math

from ..ops.ldpc import graphs, segmenter
from . import ulsch_info as _uci_tables

NRE = 12

# DM-RS REs per PRB per CDM group: type 1 -> 6, type 2 -> 4 (TS 38.211 §6.4.1.1.3).
_DMRS_RE_PER_CDM_GROUP = {1: 6, 2: 4}
MAX_CDM_GROUPS = {1: 2, 2: 3}


@dataclasses.dataclass(frozen=True)
class SchInfo:
    """SCH segmentation numbers (reference sch_information)."""

    tb_crc_size: int
    base_graph: int
    nof_cb: int
    lifting_size: int
    nof_bits_per_cb: int  # K (full codeblock payload size incl. filler)
    nof_filler_bits_per_cb: int


def get_sch_segmentation_info(tbs: int, target_code_rate: float) -> SchInfo:
    """lib/ran/sch/sch_segmentation.cpp:30 — geometry from TBS + rate."""
    tb_crc = 16 if tbs <= 3824 else 24
    bg = graphs.select_base_graph(tbs, target_code_rate)
    params = segmenter.compute_segment_params_bg(tbs, bg)
    nof_payload_per_cb = (tbs + tb_crc) // params.nof_codeblocks
    if params.nof_codeblocks > 1:
        nof_payload_per_cb += 24
    return SchInfo(
        tb_crc_size=tb_crc,
        base_graph=bg,
        nof_cb=params.nof_codeblocks,
        lifting_size=params.lifting_size,
        nof_bits_per_cb=params.nof_cb_bits,
        nof_filler_bits_per_cb=params.nof_cb_bits - nof_payload_per_cb,
    )


@dataclasses.dataclass(frozen=True)
class UlschConfig:
    tbs: int  # bits; 0 = no SCH multiplexed
    qm: int
    target_code_rate: float  # normalized (0, 1)
    nof_harq_ack_bits: int
    nof_csi_part1_bits: int
    nof_csi_part2_bits: int
    alpha_scaling: float
    beta_offset_harq_ack: float
    beta_offset_csi_part1: float
    beta_offset_csi_part2: float
    nof_rb: int
    start_symbol_index: int
    nof_symbols: int
    dmrs_type: int  # 1 | 2
    dmrs_symbol_mask: int  # bitmask over slot symbols
    nof_cdm_groups_without_data: int
    nof_layers: int
    contains_dc: bool = False


@dataclasses.dataclass(frozen=True)
class UlschInformation:
    sch: SchInfo | None
    nof_ul_sch_bits: int  # G_ulsch
    nof_harq_ack_bits: int  # G_ack
    nof_harq_ack_rvd: int  # G_ack_rvd
    nof_csi_part1_bits: int  # G_csi1
    nof_csi_part2_bits: int  # G_csi2
    nof_harq_ack_re: int  # Q'_ack
    nof_csi_part1_re: int  # Q'_csi1
    nof_csi_part2_re: int  # Q'_csi2
    nof_dc_overlap_bits: int


def _uci_crc_bits(o: int) -> int:
    return _uci_tables._uci_crc_bits(o)


def _q_ack(o_ack, beta, nof_re_uci, sum_cb, alpha, nof_re_uci_l0):
    if o_ack == 0:
        return 0
    l = _uci_crc_bits(o_ack)
    left = math.ceil(float(o_ack + l) * beta * float(nof_re_uci) / float(sum_cb))
    right = math.ceil(alpha * float(nof_re_uci_l0))
    return min(left, right)


def _q_ack_no_sch(o_ack, beta, rate, qm, alpha, nof_re_uci_l0):
    if o_ack == 0:
        return 0
    l = _uci_crc_bits(o_ack)
    left = math.ceil(float(o_ack + l) * beta / (rate * float(qm)))
    right = math.ceil(alpha * float(nof_re_uci_l0))
    return min(left, right)


def _q_csi1(o_csi1, beta, nof_re_uci, q_ack, sum_cb, alpha):
    if o_csi1 == 0:
        return 0
    l = _uci_crc_bits(o_csi1)
    left = math.ceil(float(o_csi1 + l) * beta * float(nof_re_uci) / float(sum_cb))
    right = math.ceil(alpha * float(nof_re_uci)) - q_ack
    return min(left, right)


def _q_csi1_no_sch(o_csi1, o_csi2, nof_re_uci, q_ack, beta, rate, qm):
    if o_csi1 == 0:
        return 0
    if o_csi2 == 0:
        return nof_re_uci - q_ack
    l = _uci_crc_bits(o_csi1)
    left = math.ceil(float(o_csi1 + l) * beta / (rate * float(qm)))
    right = nof_re_uci - q_ack
    return min(left, right)


def _q_csi2(o_csi2, beta, nof_re_uci, q_ack, q_csi1, sum_cb, alpha):
    if o_csi2 == 0:
        return 0
    l = _uci_crc_bits(o_csi2)
    left = math.ceil(float(o_csi2 + l) * beta * float(nof_re_uci) / float(sum_cb))
    right = math.ceil(alpha * float(nof_re_uci)) - q_ack - q_csi1
    return min(left, right)


def get_ulsch_information(cfg: UlschConfig) -> UlschInformation:
    """Reference get_ulsch_information (ulsch_info.cpp:166-360), exact."""
    sch = get_sch_segmentation_info(cfg.tbs, cfg.target_code_rate) if cfg.tbs > 0 else None

    nof_symbols_dmrs = bin(cfg.dmrs_symbol_mask).count("1")
    nof_re_dmrs_per_rb = (
        nof_symbols_dmrs * cfg.nof_cdm_groups_without_data * _DMRS_RE_PER_CDM_GROUP[cfg.dmrs_type]
    )
    nof_re_total = cfg.nof_rb * (cfg.nof_symbols * NRE - nof_re_dmrs_per_rb)
    nof_re_uci = (cfg.nof_symbols - nof_symbols_dmrs) * cfg.nof_rb * NRE

    # REs after (and excluding) the first DM-RS symbol that don't carry DM-RS.
    first_dmrs = (cfg.dmrs_symbol_mask & -cfg.dmrs_symbol_mask).bit_length() - 1
    nof_re_uci_l0 = 0
    for sym in range(first_dmrs, cfg.start_symbol_index + cfg.nof_symbols):
        if cfg.dmrs_symbol_mask >> sym & 1:
            continue
        nof_re_uci_l0 += cfg.nof_rb * NRE

    sum_cb = sch.nof_cb * sch.nof_bits_per_cb if sch else 0

    if cfg.tbs > 0:
        q_ack = _q_ack(cfg.nof_harq_ack_bits, cfg.beta_offset_harq_ack, nof_re_uci, sum_cb,
                       cfg.alpha_scaling, nof_re_uci_l0)
    else:
        q_ack = _q_ack_no_sch(cfg.nof_harq_ack_bits, cfg.beta_offset_harq_ack,
                              cfg.target_code_rate, cfg.qm, cfg.alpha_scaling, nof_re_uci_l0)

    # Reserved-ACK REs when O_ack <= 2 (computed as if 2 bits).
    q_ack_rvd = 0
    if cfg.nof_harq_ack_bits < 2:
        if cfg.tbs > 0:
            q_ack_rvd = _q_ack(2, cfg.beta_offset_harq_ack, nof_re_uci, sum_cb,
                               cfg.alpha_scaling, nof_re_uci_l0)
        else:
            q_ack_rvd = _q_ack_no_sch(2, cfg.beta_offset_harq_ack, cfg.target_code_rate,
                                      cfg.qm, cfg.alpha_scaling, nof_re_uci_l0)
    elif cfg.nof_harq_ack_bits == 2:
        q_ack_rvd = q_ack

    q_ack_for_csi1 = q_ack_rvd if cfg.nof_harq_ack_bits <= 2 else q_ack
    if cfg.tbs > 0:
        q_csi1 = _q_csi1(cfg.nof_csi_part1_bits, cfg.beta_offset_csi_part1, nof_re_uci,
                         q_ack_for_csi1, sum_cb, cfg.alpha_scaling)
    else:
        q_csi1 = _q_csi1_no_sch(cfg.nof_csi_part1_bits, cfg.nof_csi_part2_bits, nof_re_uci,
                                q_ack_for_csi1, cfg.beta_offset_csi_part1,
                                cfg.target_code_rate, cfg.qm)

    q_ack_for_csi2 = 0 if cfg.nof_harq_ack_bits <= 2 else q_ack
    if cfg.tbs > 0:
        q_csi2 = _q_csi2(cfg.nof_csi_part2_bits, cfg.beta_offset_csi_part2, nof_re_uci,
                         q_ack_for_csi2, q_csi1, sum_cb, cfg.alpha_scaling)
    else:
        q_csi2 = (nof_re_uci - q_ack_for_csi2 - q_csi1) if cfg.nof_csi_part2_bits else 0

    q_ack_actual = q_ack if cfg.nof_harq_ack_bits > 2 else 0
    nof_re_ul_sch = (nof_re_total - q_ack_actual - q_csi1 - q_csi2) if cfg.tbs > 0 else 0

    bits_per_re = cfg.nof_layers * cfg.qm
    return UlschInformation(
        sch=sch,
        nof_ul_sch_bits=nof_re_ul_sch * bits_per_re,
        nof_harq_ack_bits=q_ack * bits_per_re,
        nof_harq_ack_rvd=q_ack_rvd * bits_per_re,
        nof_csi_part1_bits=q_csi1 * bits_per_re,
        nof_csi_part2_bits=q_csi2 * bits_per_re,
        nof_harq_ack_re=q_ack,
        nof_csi_part1_re=q_csi1,
        nof_csi_part2_re=q_csi2,
        nof_dc_overlap_bits=cfg.nof_symbols * cfg.qm if cfg.contains_dc else 0,
    )


@dataclasses.dataclass(frozen=True)
class DlschConfig:
    tbs: int
    qm: int
    target_code_rate: float
    nof_rb: int
    start_symbol_index: int
    nof_symbols: int
    dmrs_type: int
    dmrs_symbol_mask: int
    nof_cdm_groups_without_data: int
    nof_layers: int
    contains_dc: bool = False


def get_dlsch_information(cfg: DlschConfig):
    """Reference get_dlsch_information (lib/ran/pdsch/dlsch_info.cpp):
    returns (SchInfo, G_dlsch)."""
    sch = get_sch_segmentation_info(cfg.tbs, cfg.target_code_rate)
    nof_symbols_dmrs = bin(cfg.dmrs_symbol_mask).count("1")
    nof_re_dmrs_per_rb = (
        nof_symbols_dmrs * cfg.nof_cdm_groups_without_data * _DMRS_RE_PER_CDM_GROUP[cfg.dmrs_type]
    )
    nof_re_total = cfg.nof_rb * (cfg.nof_symbols * NRE - nof_re_dmrs_per_rb)
    g = nof_re_total * cfg.nof_layers * cfg.qm
    return sch, g
