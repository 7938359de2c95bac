"""Downlink slot broadcast: every PDCCH, SSB and CSI-RS PDU of a slot onto
port 0 of its grid.

Port of ``srsran_project_tpu/phy/dl_slot.py``.  The reference traces the
slot's broadcast PDUs into one compiled program; the eager port runs the
same sequence of additions, in the reference's order (PDCCH, then SSB,
then CSI-RS, each in request order), so that the sums round alike.
"""

from __future__ import annotations

import torch

from . import csi_rs as csi_rs_mod
from . import pdcch as pdcch_mod
from . import ssb as ssb_mod


def _bits(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.uint8, device=device)


def csi_rs_config(pdu, slot_in_frame: int, phy_cfg) -> csi_rs_mod.CsiRsConfig:
    """The CsiRsConfig of a DL_TTI CSI-RS PDU on the cell's grid.  Like
    the reference, the slot carries the single-port density-3 row; a PDU
    that asks for another row raises ValueError instead of being sent as
    row 1."""
    if pdu.row != 1:
        raise ValueError(f"DL_TTI CSI-RS PDU: row {pdu.row} given, the slot carries row 1 only "
                         "(as the reference's DL slot does)")
    return csi_rs_mod.CsiRsConfig(
        rb_start=pdu.rb_start, rb_count=pdu.rb_count, symbol=pdu.symbol,
        scrambling_id=pdu.scrambling_id, slot_in_frame=slot_in_frame,
        nof_grid_symbols=phy_cfg.nof_grid_symbols, nof_grid_sc=phy_cfg.nof_grid_sc)


def add_pdcch(grid: torch.Tensor, cfgs: tuple, rntis: torch.Tensor, *payloads) -> torch.Tensor:
    """Each DCI (payload bits, its RNTI of ``rntis``, its config) added
    onto port 0 of the grid, in order, in place; returns the grid."""
    for cfg, rnti, payload in zip(cfgs, rntis, payloads):
        grid[0] += pdcch_mod.process(payload, rnti, cfg)
    return grid


def add_ssbs(grid: torch.Tensor, cfgs: tuple, places: tuple, *inputs) -> torch.Tensor:
    """Each SSB block added onto port 0 at its (first symbol, first
    subcarrier), in order, in place: ``inputs`` are the PBCH payloads, then
    their first scrambling masks (``ssb._first_scrambling_mask``); returns
    the grid."""
    n = len(cfgs)
    for cfg, (sym, sc), payload, mask in zip(cfgs, places, inputs[:n], inputs[n:]):
        grid[0, sym : sym + ssb_mod.SSB_NSYM, sc : sc + ssb_mod.SSB_NSC] += ssb_mod.assemble_ssb(
            payload, cfg, first_mask=mask)
    return grid


def add_csi_rs(grid: torch.Tensor, cfgs: tuple) -> torch.Tensor:
    """Each single-port CSI-RS resource added onto port 0, in order, in
    place; returns the grid."""
    for c in cfgs:
        grid[0] += csi_rs_mod.generate(c, device=grid.device)
    return grid


def assemble_broadcast(grid: torch.Tensor, request, phy_cfg) -> torch.Tensor:
    """(P, nsym, nsc) grid + request.pdcch / request.ssb / request.csi_rs
    -> a new grid with every broadcast PDU added onto port 0 (the grid
    itself when the request has none)."""
    if not (request.pdcch or request.ssb or request.csi_rs):
        return grid
    dev = grid.device
    csi_cfgs = tuple(csi_rs_config(p, request.slot.slot_in_frame, phy_cfg) for p in request.csi_rs)
    grid = grid.clone()
    add_pdcch(grid, tuple(p.config for p in request.pdcch),
              torch.tensor([p.rnti for p in request.pdcch], dtype=torch.int64, device=dev),
              *(_bits(p.payload, dev) for p in request.pdcch))
    add_ssbs(grid, tuple(p.config for p in request.ssb),
             tuple((p.first_symbol, p.first_subcarrier) for p in request.ssb),
             *(_bits(p.payload, dev) for p in request.ssb),
             *(_bits(ssb_mod._first_scrambling_mask(p.config), dev) for p in request.ssb))
    return add_csi_rs(grid, csi_cfgs)
