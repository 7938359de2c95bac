"""PHY PDU validators: configuration invariants checked before processing.

Counterpart of the reference's validator family
(pdsch_processor_validator_impl.cpp, pusch_processor_validator_impl.cpp,
pucch_pdu_validator_impl in pucch_processor_impl.h, prach validator):
each returns None when valid or a human-readable error string, and the
upper PHY rejects the PDU with an FAPI error indication instead of
running a PDU of impossible shapes.

Port of ``srsran_project_tpu/phy/validators.py``.  One check differs: the
UCI-on-PUSCH sizes are read from ``nof_harq_ack_bits`` (the field of
``UciOnPuschConfig``; the reference reads ``nof_harq_bits``, which that
config does not have, and raises AttributeError on any grant with UCI).
"""

from __future__ import annotations

from typing import Optional

from ..ran.constants import NRE


def _check(cond: bool, msg: str) -> Optional[str]:
    return None if cond else msg


def _first(*errs: Optional[str]) -> Optional[str]:
    for e in errs:
        if e is not None:
            return e
    return None


def validate_allocation(alloc, nof_grid_symbols: int, nof_grid_sc: int) -> Optional[str]:
    nof_rb_grid = nof_grid_sc // NRE
    return _first(
        _check(0 < alloc.rb_count and alloc.rb_start + alloc.rb_count <= nof_rb_grid,
               f"PRB allocation [{alloc.rb_start}, {alloc.rb_start + alloc.rb_count}) "
               f"outside the {nof_rb_grid}-PRB grid"),
        _check(0 < alloc.sym_count and alloc.sym_start + alloc.sym_count <= nof_grid_symbols,
               f"symbol allocation [{alloc.sym_start}, {alloc.sym_start + alloc.sym_count}) "
               f"outside the {nof_grid_symbols}-symbol slot"),
        _check(len(alloc.dmrs_symbols) > 0, "empty DM-RS symbol set"),
        _check(all(alloc.sym_start <= s < alloc.sym_start + alloc.sym_count
                   for s in alloc.dmrs_symbols),
               f"DM-RS symbols {alloc.dmrs_symbols} outside the allocation"),
        _check(alloc.nof_cdm_groups_without_data in (1, 2),
               "nof_cdm_groups_without_data must be 1 or 2"),
    )


def validate_pdsch(cfg) -> Optional[str]:
    """PdschConfig invariants (reference pdsch_processor_validator_impl)."""
    return _first(
        validate_allocation(cfg.alloc, cfg.nof_grid_symbols, cfg.nof_grid_sc),
        _check(1 <= cfg.nof_layers <= 4, f"invalid number of layers {cfg.nof_layers}"),
        _check(cfg.nof_layers <= cfg.nof_ports,
               f"{cfg.nof_layers} layers exceed {cfg.nof_ports} ports"),
        _check(0 <= cfg.rv <= 3, f"invalid redundancy version {cfg.rv}"),
        _check(cfg.tbs > 0, "empty transport block"),
        _check(0.0 < cfg.target_code_rate < 1.0,
               f"target code rate {cfg.target_code_rate} out of (0, 1)"),
        _check(not (cfg.transform_precoding and cfg.nof_layers != 1),
               "transform precoding supports a single layer"),
        _check(not cfg.ptrs_enabled or cfg.ptrs_k in (2, 4),
               f"invalid K_PTRS {cfg.ptrs_k}"),
        _check(not cfg.ptrs_enabled or 0 <= cfg.ptrs_re_offset <= 3,
               f"invalid PT-RS resourceElementOffset {cfg.ptrs_re_offset}"),
    )


def validate_pusch(cfg) -> Optional[str]:
    """PuschConfig invariants (reference pusch_processor_validator_impl)."""
    base = _first(
        validate_allocation(cfg.alloc, cfg.nof_grid_symbols, cfg.nof_grid_sc),
        _check(1 <= cfg.nof_layers <= 4, f"invalid number of layers {cfg.nof_layers}"),
        _check(cfg.nof_rx_ports >= 1, "no receive ports"),
        _check(cfg.tbs > 0, "empty transport block"),
        _check(not (cfg.transform_precoding and cfg.nof_layers != 1),
               "transform precoding supports a single layer"),
    )
    if base is not None:
        return base
    if cfg.uci is not None:
        u = cfg.uci
        return _first(
            _check(u.nof_harq_ack_bits >= 0 and u.nof_csi1_bits >= 0 and u.nof_csi2_bits >= 0,
                   "negative UCI field size"),
            _check(u.nof_harq_ack_bits <= 1706, "HARQ-ACK payload too large"),
        )
    return None


def validate_pucch_f0(cfg) -> Optional[str]:
    return _first(
        _check(cfg.nof_symbols in (1, 2), f"F0 supports 1-2 symbols, got {cfg.nof_symbols}"),
        _check(0 <= cfg.initial_cyclic_shift < 12,
               f"invalid initial cyclic shift {cfg.initial_cyclic_shift}"),
        _check(0 <= cfg.nof_harq_bits <= 2, f"F0 carries 0-2 HARQ bits"),
        _check(cfg.nof_harq_bits > 0 or cfg.sr_opportunity,
               "F0 with no HARQ bits requires an SR opportunity"),
        _check(cfg.second_hop_prb is None or cfg.nof_symbols == 2,
               "F0 frequency hopping requires 2 symbols"),
        _check((cfg.prb + 1) * NRE <= cfg.nof_grid_sc, "F0 PRB outside the grid"),
    )


def validate_pucch_f1(cfg) -> Optional[str]:
    return _first(
        _check(4 <= cfg.nof_symbols <= 14, f"F1 supports 4-14 symbols"),
        _check(cfg.start_symbol + cfg.nof_symbols <= 14, "F1 allocation exceeds the slot"),
        _check(0 <= cfg.initial_cyclic_shift < 12, "invalid initial cyclic shift"),
        _check(0 <= cfg.occ_index < 7, f"invalid time-domain OCC index {cfg.occ_index}"),
        _check(1 <= cfg.nof_harq_bits <= 2, "F1 carries 1-2 HARQ bits"),
        _check((cfg.prb + 1) * NRE <= cfg.nof_grid_sc, "F1 PRB outside the grid"),
    )


def validate_pucch_f2(cfg) -> Optional[str]:
    return _first(
        _check(cfg.nof_symbols in (1, 2), "F2 supports 1-2 symbols"),
        _check(1 <= cfg.rb_count <= 16, f"F2 supports 1-16 PRB, got {cfg.rb_count}"),
        _check(cfg.nof_uci_bits >= 3, "F2 carries at least 3 UCI bits"),
        _check(cfg.second_hop_rb_start is None or cfg.nof_symbols == 2,
               "F2 frequency hopping requires 2 symbols"),
        _check((cfg.rb_start + cfg.rb_count) * NRE <= cfg.nof_grid_sc,
               "F2 allocation outside the grid"),
    )


_F34_VALID_PRB = (1, 2, 3, 4, 5, 6, 8, 9, 10, 12, 15, 16)


def validate_pucch_f34(cfg) -> Optional[str]:
    return _first(
        _check(4 <= cfg.nof_symbols <= 14, "F3/F4 supports 4-14 symbols"),
        _check(cfg.occ_length in (1, 2, 4), f"invalid OCC length {cfg.occ_length}"),
        _check(cfg.occ_length == 1 or cfg.nof_prb == 1,
               "F4 (OCC > 1) uses exactly one PRB"),
        _check(cfg.occ_length == 1 or cfg.occ_index < cfg.occ_length,
               "OCC index exceeds OCC length"),
        _check(cfg.occ_length > 1 or cfg.nof_prb in _F34_VALID_PRB,
               f"F3 PRB count {cfg.nof_prb} is not a valid DFT size (2^a 3^b 5^c)"),
        _check(cfg.nof_uci_bits >= 3, "F3/F4 carries at least 3 UCI bits"),
        _check((cfg.prb_start + cfg.nof_prb) * NRE <= cfg.nof_grid_sc,
               "allocation outside the grid"),
    )
