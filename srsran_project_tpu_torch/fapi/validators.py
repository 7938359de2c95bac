"""FAPI request validators (counterpart of the reference's lib/fapi
message_validators): structural checks on DL_TTI/UL_TTI requests before they
reach the PHY: allocation bounds, PDU overlaps, payload sizing.

Port of ``srsran_project_tpu/fapi/validators.py``.  One check differs: the
symbol range test reads ``not (0 <= start and start + count <= 14)``
(the reference's ``not 0 <= start and ...`` binds as ``(not 0 <= start)
and ...`` and passes every range).
"""

from __future__ import annotations

from . import messages as fapi


class ValidationError(ValueError):
    pass


def _check_alloc_bounds(alloc, nof_grid_sc: int, what: str, first_rb=None):
    rb0 = (first_rb if first_rb is not None else alloc.rb_start)
    sc_hi = (rb0 + alloc.rb_count) * 12
    grid_sc = nof_grid_sc
    if sc_hi > grid_sc:
        raise ValidationError(f"{what}: allocation [{rb0}, +{alloc.rb_count}) PRB exceeds grid")
    if not (0 <= alloc.sym_start and alloc.sym_start + alloc.sym_count <= 14):
        raise ValidationError(f"{what}: symbols out of range")
    for s in alloc.dmrs_symbols:
        if not alloc.sym_start <= s < alloc.sym_start + alloc.sym_count:
            raise ValidationError(f"{what}: DM-RS symbol {s} outside allocation")


def validate_dl_tti(req: fapi.DlTtiRequest, tx_data: fapi.TxDataRequest, nof_grid_sc: int) -> None:
    if req.slot != tx_data.slot:
        raise ValidationError("DL_TTI and TX_Data slots differ")
    from ..phy import validators as phy_validators

    occupied = []
    for pdu in req.pdsch:
        cfg = pdu.config
        grid_sc = nof_grid_sc if pdu.first_rb is not None else cfg.nof_grid_sc
        _check_alloc_bounds(cfg.alloc, grid_sc, f"PDSCH rnti={pdu.rnti:#x}", pdu.first_rb)
        err = phy_validators.validate_pdsch(cfg)
        if err is not None:
            raise ValidationError(f"PDSCH rnti={pdu.rnti:#x}: {err}")
        if pdu.tb_index >= len(tx_data.payloads):
            raise ValidationError(f"PDSCH rnti={pdu.rnti:#x}: tb_index out of range")
        if len(tx_data.payloads[pdu.tb_index]) != cfg.tbs:
            raise ValidationError(
                f"PDSCH rnti={pdu.rnti:#x}: payload {len(tx_data.payloads[pdu.tb_index])} != tbs {cfg.tbs}"
            )
        rb0 = pdu.first_rb if pdu.first_rb is not None else cfg.alloc.rb_start
        span = (rb0, rb0 + cfg.alloc.rb_count, cfg.alloc.sym_start,
                cfg.alloc.sym_start + cfg.alloc.sym_count)
        for other in occupied:
            if span[0] < other[1] and other[0] < span[1] and span[2] < other[3] and other[2] < span[3]:
                raise ValidationError(f"PDSCH rnti={pdu.rnti:#x}: overlaps another PDSCH PDU")
        occupied.append(span)
    for pdu in req.pdcch:
        cfg = pdu.config
        if (cfg.coreset_rb_start + cfg.coreset_rb_count) * 12 > cfg.nof_grid_sc:
            raise ValidationError("PDCCH: CORESET exceeds grid")
        if len(pdu.payload) != cfg.payload_bits:
            raise ValidationError("PDCCH: payload size mismatch")
        need = (cfg.cce_index + cfg.aggregation_level) * 6
        if need > cfg.nof_regs:
            raise ValidationError("PDCCH: CCEs exceed CORESET REGs")
    for pdu in req.ssb:
        if pdu.first_subcarrier + 240 > nof_grid_sc or pdu.first_symbol + 4 > 14:
            raise ValidationError("SSB: placement out of grid")
        if len(pdu.payload) != 32:
            raise ValidationError("SSB: payload must be 32 bits")


def validate_ul_tti(req: fapi.UlTtiRequest, nof_grid_sc: int) -> None:
    from ..phy import validators as phy_validators

    occupied = []
    for pdu in req.pusch:
        cfg = pdu.config
        grid_sc = nof_grid_sc if pdu.first_rb is not None else cfg.nof_grid_sc
        _check_alloc_bounds(cfg.alloc, grid_sc, f"PUSCH rnti={pdu.rnti:#x}", pdu.first_rb)
        err = phy_validators.validate_pusch(cfg)
        if err is not None:
            raise ValidationError(f"PUSCH rnti={pdu.rnti:#x}: {err}")
        rb0 = pdu.first_rb if pdu.first_rb is not None else cfg.alloc.rb_start
        span = (rb0, rb0 + cfg.alloc.rb_count, cfg.alloc.sym_start,
                cfg.alloc.sym_start + cfg.alloc.sym_count)
        for other in occupied:
            if span[0] < other[1] and other[0] < span[1] and span[2] < other[3] and other[2] < span[3]:
                raise ValidationError(f"PUSCH rnti={pdu.rnti:#x}: overlaps another PUSCH PDU")
        occupied.append(span)
        if not 0 <= pdu.harq_id < 16:
            raise ValidationError("PUSCH: harq_id out of range")


def _validate_pucch(pdu, nof_grid_sc: int) -> None:
    cfg = pdu.config
    name = type(cfg).__name__
    if name in ("PucchFormat0Config", "PucchFormat1Config"):
        if (cfg.prb + 1) * 12 > nof_grid_sc:
            raise ValidationError(f"PUCCH {name}: PRB {cfg.prb} outside grid")
        if not 0 <= cfg.initial_cyclic_shift < 12:
            raise ValidationError(f"PUCCH {name}: initial cyclic shift out of range")
        max_sym = 2 if name.endswith("0Config") else 14
        min_sym = 1 if name.endswith("0Config") else 4
        if not min_sym <= cfg.nof_symbols <= max_sym:
            raise ValidationError(f"PUCCH {name}: nof_symbols {cfg.nof_symbols} invalid")
        if cfg.start_symbol + cfg.nof_symbols > 14:
            raise ValidationError(f"PUCCH {name}: symbols exceed slot")
        if not 0 <= cfg.nof_harq_bits <= 2:
            raise ValidationError(f"PUCCH {name}: HARQ bits must be 0-2")
    elif name == "PucchFormat2Config":
        if (cfg.rb_start + cfg.rb_count) * 12 > nof_grid_sc:
            raise ValidationError("PUCCH F2: PRBs outside grid")
        if not 1 <= cfg.nof_symbols <= 2:
            raise ValidationError("PUCCH F2: nof_symbols must be 1-2")
        if not 1 <= cfg.rb_count <= 16:
            raise ValidationError("PUCCH F2: rb_count must be 1-16")
        if not 1 <= cfg.nof_uci_bits:
            raise ValidationError("PUCCH F2: needs at least 1 UCI bit")
    elif name in ("PucchFormat3Config", "PucchFormat4Config"):
        if (cfg.rb_start + getattr(cfg, "rb_count", 1)) * 12 > nof_grid_sc:
            raise ValidationError(f"PUCCH {name}: PRBs outside grid")
        if cfg.start_symbol + cfg.nof_symbols > 14:
            raise ValidationError(f"PUCCH {name}: symbols exceed slot")
    else:
        raise ValidationError(f"PUCCH: unknown format config {name}")


def _validate_prach(pdu) -> None:
    cfg = pdu.config
    if cfg.l_ra not in (839, 139):
        raise ValidationError(f"PRACH: invalid L_RA {cfg.l_ra}")
    if not 0 <= cfg.zero_correlation_zone < 16:
        raise ValidationError("PRACH: zeroCorrelationZone out of range")
    if not 0 <= cfg.root_sequence_index < (838 if cfg.l_ra == 839 else 138):
        raise ValidationError("PRACH: root sequence index out of range")


def _validate_srs(pdu, nof_grid_sc: int) -> None:
    cfg = pdu.config
    if getattr(cfg, "nof_symbols", 1) not in (1, 2, 4):
        raise ValidationError("SRS: nof_symbols must be 1, 2 or 4")
    if getattr(cfg, "comb_size", 2) not in (2, 4):
        raise ValidationError("SRS: comb size must be 2 or 4")


def validate_ul_tti_full(req: fapi.UlTtiRequest, nof_grid_sc: int) -> None:
    """Validators for every UL_TTI PDU type (PUSCH bounds/overlap + PUCCH
    per-format + PRACH + SRS), mirroring lib/fapi/validators breadth."""
    validate_ul_tti(req, nof_grid_sc)
    for pdu in req.pucch:
        _validate_pucch(pdu, nof_grid_sc)
    for pdu in req.prach:
        _validate_prach(pdu)
    for pdu in req.srs:
        _validate_srs(pdu, nof_grid_sc)


def validate_ul_dci(req: fapi.UlDciRequest) -> None:
    """UL_DCI.request: same PDCCH checks as in the DL direction."""
    for pdu in req.pdcch:
        cfg = pdu.config
        if (cfg.coreset_rb_start + cfg.coreset_rb_count) * 12 > cfg.nof_grid_sc:
            raise ValidationError("UL_DCI: CORESET exceeds grid")
        if len(pdu.payload) != cfg.payload_bits:
            raise ValidationError("UL_DCI: payload size mismatch")
        need = (cfg.cce_index + cfg.aggregation_level) * 6
        if need > cfg.nof_regs:
            raise ValidationError("UL_DCI: CCEs exceed CORESET REGs")


def validate_config_request(req: fapi.ConfigRequest) -> None:
    """CONFIG.request sanity (config_messages.h TLV bounds)."""
    if req.scs_khz not in (15, 30, 60, 120):
        raise ValidationError("CONFIG: invalid SCS")
    if not 1 <= req.nof_prb <= 275:
        raise ValidationError("CONFIG: nof_prb out of range")
    if not 1 <= req.nof_tx_ports <= 8 or not 1 <= req.nof_rx_ports <= 8:
        raise ValidationError("CONFIG: port counts out of range")
    if not 0 <= req.pci < 1008:
        raise ValidationError("CONFIG: PCI out of range")
