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


def assemble_broadcast(grid: torch.Tensor, request, phy_cfg) -> torch.Tensor:
    """(P, nsym, nsc) grid + request.pdcch / request.ssb / request.csi_rs
    -> a new grid with every broadcast PDU added onto port 0 (the grid
    itself when the request has none)."""
    if not (request.pdcch or request.ssb or request.csi_rs):
        return grid
    dev = grid.device
    csi_cfgs = [csi_rs_config(p, request.slot.slot_in_frame, phy_cfg) for p in request.csi_rs]
    grid = grid.clone()
    for p in request.pdcch:
        grid[0] += pdcch_mod.process(_bits(p.payload, dev), p.rnti, p.config)
    for p in request.ssb:
        block = ssb_mod.assemble_ssb(_bits(p.payload, dev), p.config)
        grid[0, p.first_symbol : p.first_symbol + ssb_mod.SSB_NSYM,
             p.first_subcarrier : p.first_subcarrier + ssb_mod.SSB_NSC] += block
    for c in csi_cfgs:
        grid[0] += csi_rs_mod.generate(c, device=dev)
    return grid
