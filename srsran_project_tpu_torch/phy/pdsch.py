"""PDSCH processor: transport block -> port grids.

Port of ``srsran_project_tpu/phy/pdsch.py``, flagship path: the bit chain
(encode + rate match + scramble) and the scatter-free grid assembly
(``_grid_rows_fast``: full data rows, type-1 DM-RS at stride 2) with exact
float32 precoding by scalar multiply-adds.  PT-RS, transform precoding,
other allocation shapes and ``process_multi`` are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling
from ..ops._tables import device_table
from ..ops.modulation import Modulation, map_bits
from ..ran import dmrs as dmrs_mod
from . import allocation as alloc_mod
from .sch import SchConfig, encode_transport_block


def uniform_data_rows(a: alloc_mod.Allocation) -> bool:
    """True when every data symbol of the allocation is a full row (DM-RS
    symbols carry no data: 2 CDM groups without data)."""
    dmask = dmrs_mod.data_subcarrier_mask(a.dmrs_config_type, a.nof_cdm_groups_without_data)
    dmrs_in_range = [s for s in a.dmrs_symbols if a.sym_start <= s < a.sym_start + a.sym_count]
    return not (bool(dmask.any()) and dmrs_in_range)


def check_flagship_alloc(a: alloc_mod.Allocation) -> None:
    if not (uniform_data_rows(a) and a.dmrs_config_type == 1):
        raise NotImplementedError("only full-row data symbols with type-1 DM-RS are "
                                  "ported (ROADMAP Q1.8 / Q1.9)")


@dataclasses.dataclass(frozen=True)
class PdschConfig:
    """Twin of the reference's ``PdschConfig`` (same fields and defaults)."""

    tbs: int
    target_code_rate: float
    modulation: Modulation
    alloc: alloc_mod.Allocation
    nof_layers: int = 1
    nof_ports: int = 1
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624
    n_id: int = 0
    rv: int = 0
    slot_in_frame: int = 0
    dmrs_scrambling_id: int = 0
    n_scid: int = 0
    ptrs_enabled: bool = False
    ptrs_k: int = 2
    ptrs_re_offset: int = 0
    ptrs_k_rb_ref: int = 0
    transform_precoding: bool = False
    n_rs_id: int = 0

    def __post_init__(self):
        if self.ptrs_enabled:
            raise NotImplementedError("PT-RS is not ported yet (ROADMAP Q1.9)")
        if self.transform_precoding:
            raise NotImplementedError("transform precoding is not ported yet (ROADMAP Q1.8)")

    @functools.cached_property
    def sch(self) -> SchConfig:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        return SchConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            qm=qm,
            nof_layers=self.nof_layers,
            nof_total_bits=alloc_mod.nof_data_re(self.alloc) * qm * self.nof_layers,
            rv=self.rv,
        )


def _pdsch_c_init(rnti: torch.Tensor, n_id: int, q: int = 0) -> torch.Tensor:
    return (rnti.to(torch.int64) << 15) + (q << 14) + n_id


def dmrs_pilots(cfg: PdschConfig, nof_pilots: int) -> np.ndarray:
    """(nsym_dmrs, nof_pilots) complex64 DM-RS QPSK values r(m) per symbol
    (c_init is static, so the Gold sequence is the host LFSR)."""
    outs = []
    for sym in cfg.alloc.dmrs_symbols:
        c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id, cfg.n_scid)
        c = scrambling.gold_ref(int(c_init), 2 * nof_pilots).astype(np.float32)
        outs.append(((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2))
    return np.stack(outs).astype(np.complex64)


def _dmrs_rows(cfg: PdschConfig) -> np.ndarray:
    """(nsym_dmrs, nl, nof_sc) complex64: each layer's pilots (x beta x OCC)
    interleaved with zeros at its CDM-group offset."""
    a = cfg.alloc
    beta = np.float32(dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data))
    out = np.zeros((len(a.dmrs_symbols), cfg.nof_layers, a.nof_sc), np.complex64)
    for layer in range(cfg.nof_layers):
        _idx, wf, _, seq_idx = alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)
        r = dmrs_pilots(cfg, int(seq_idx[-1]) + 1)[:, seq_idx]
        vals = beta * r * wf.astype(np.complex64)
        delta = int(dmrs_mod.cdm_group(1, layer))  # type-1 delta == CDM group
        out[:, layer, delta::2] = vals
    return out


_dmrs_rows_on = device_table(_dmrs_rows)


def _grid_rows_fast(layered: torch.Tensor, precoding: torch.Tensor,
                    cfg: PdschConfig) -> torch.Tensor:
    """(..., nl, ndata) symbol-major layer symbols -> (..., P, nsym, nsc)
    grids: data rows reshape straight into the grid, DM-RS rows come from
    the static pilot table, then exact f32 precoding."""
    a = cfg.alloc
    nl = cfg.nof_layers
    lead = layered.shape[:-2]
    dev = layered.device
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    data3 = layered.reshape(lead + (nl, len(data_syms), a.nof_sc))
    dmrs_rows = _dmrs_rows_on(dev, cfg)
    zero_row = torch.zeros(lead + (nl, a.nof_sc), dtype=torch.complex64, device=dev)
    rows = []
    for s in range(cfg.nof_grid_symbols):
        if s in data_syms:
            rows.append(data3[..., data_syms.index(s), :])
        elif s in a.dmrs_symbols and a.sym_start <= s < a.sym_start + a.sym_count:
            rows.append(dmrs_rows[list(a.dmrs_symbols).index(s)].expand(lead + (nl, a.nof_sc)))
        else:
            rows.append(zero_row)
    win = torch.stack(rows, dim=-2)  # (..., nl, S, nof_sc)
    if a.sc_start or a.nof_sc != cfg.nof_grid_sc:
        win = torch.nn.functional.pad(
            win, (a.sc_start, cfg.nof_grid_sc - a.sc_start - a.nof_sc))
    w = precoding.to(torch.complex64)
    return torch.stack([sum(w[l, p] * win[..., l, :, :] for l in range(nl))
                        for p in range(w.shape[1])], dim=-3)


def _bit_chain(tb_bits: torch.Tensor, rnti: torch.Tensor, cfg: PdschConfig) -> torch.Tensor:
    """Segment + LDPC encode + rate match + scramble: (..., A) -> (..., G)."""
    cw = encode_transport_block(tb_bits, cfg.sch)
    return scrambling.scramble_bits(cw, _pdsch_c_init(rnti, cfg.n_id))


def _grid_chain(cw: torch.Tensor, precoding: torch.Tensor, cfg: PdschConfig) -> torch.Tensor:
    """Modulate + layer map + DM-RS + precode: (..., G) bits -> (..., P,
    nsym, nsc) port grids."""
    check_flagship_alloc(cfg.alloc)
    syms = map_bits(cw, cfg.modulation)  # (..., G/Qm)
    nl = cfg.nof_layers
    layered = syms.reshape(syms.shape[:-1] + (-1, nl)).transpose(-1, -2)  # symbol i -> layer i%nl
    return _grid_rows_fast(layered, precoding, cfg)
