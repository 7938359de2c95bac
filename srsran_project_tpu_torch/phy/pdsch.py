"""PDSCH processor: transport block -> port grids.

Port of ``srsran_project_tpu/phy/pdsch.py``: ``process`` (one PDU, any
leading batch), the bit chain (encode + rate match + scramble), and the
grid chain: the scatter-free assembly (``_grid_rows_fast``: full data
rows, type-1 DM-RS at stride 2) where it applies, else the scatter
assembly of any allocation shape (data on the DM-RS symbols, DM-RS type
2, any first symbol and PRB), with PT-RS (``ptrs_layout``) and transform
precoding with the low-PAPR DM-RS; exact float32 precoding by scalar
multiply-adds.  ``process_multi`` encodes N equal-config grants of one
slot as one leading-batch pass through both chains, each grant with its
own DM-RS values (the Gold index follows its absolute CRB) and precoding.

A config's ``reserved`` RE patterns (``allocation.RePattern``, srsRAN's
``re_pattern`` list of the PDSCH PDU; e.g. a TRS on the grant's PRBs) take
REs out of the data: the codeword is rate matched to the REs left (TS
38.214 5.1.4), the data skip the reserved REs in mapping order, and the
scatter assembly leaves them empty on every port.  The DM-RS is not
rate matched around them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling, sequences, transform_precoding
from ..ops._tables import device_table
from ..ops.modulation import Modulation, map_bits
from ..ran import dmrs as dmrs_mod
from ..support.tracing import l1_tracer
from . import allocation as alloc_mod
from .sch import SchConfig, encode_transport_block


def uniform_data_rows(a: alloc_mod.Allocation) -> bool:
    """True when every data symbol of the allocation is a full row (DM-RS
    symbols carry no data: 2 CDM groups without data)."""
    dmask = dmrs_mod.data_subcarrier_mask(a.dmrs_config_type, a.nof_cdm_groups_without_data)
    dmrs_in_range = [s for s in a.dmrs_symbols if a.sym_start <= s < a.sym_start + a.sym_count]
    return not (bool(dmask.any()) and dmrs_in_range)


@dataclasses.dataclass(frozen=True)
class PdschConfig:
    """Twin of the reference's ``PdschConfig`` (same fields and defaults),
    with the port's own ``reserved``."""

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
    # REs the data are rate matched around (``allocation.RePattern``s on
    # this config's grid); the port's own, the reference has none.
    reserved: tuple[alloc_mod.RePattern, ...] = ()

    @classmethod
    def from_reference(cls, ref) -> "PdschConfig":
        """Copy a reference (JAX package) ``PdschConfig`` field by field, by
        attribute access only (the modulation by value, the allocation as
        the port's own ``Allocation``); ``reserved``, which the reference
        lacks, stays empty."""
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)
              if f.name != "reserved"}
        kw["modulation"] = Modulation(int(kw["modulation"]))
        kw["alloc"] = alloc_mod.Allocation.from_fields(kw["alloc"])
        return cls(**kw)

    @functools.cached_property
    def sch(self) -> SchConfig:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        return SchConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            qm=qm,
            nof_layers=self.nof_layers,
            nof_total_bits=self.nof_data_re * qm * self.nof_layers,
            rv=self.rv,
        )

    @functools.cached_property
    def nof_data_re(self) -> int:
        """Data REs of one layer: the allocation's less the reserved ones."""
        if not self.reserved:
            return alloc_mod.nof_data_re(self.alloc)
        return len(alloc_mod.data_re_indices(self.alloc, self.nof_grid_symbols,
                                             self.nof_grid_sc, self.reserved))

    @functools.cached_property
    def nof_reserved_re(self) -> int:
        """Data REs of one layer that the reserved patterns leave empty."""
        return alloc_mod.nof_data_re(self.alloc) - self.nof_data_re


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


def _pilot_weights(cfg: PdschConfig) -> np.ndarray:
    """(nl, Np) complex64: beta x each layer's OCC weight of its pilots."""
    a = cfg.alloc
    beta = np.float32(dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data))
    return np.stack([beta * alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)[1].astype(
        np.complex64) for layer in range(cfg.nof_layers)])


_pilot_w_on = device_table(_pilot_weights)


def _override_rows(r: torch.Tensor, cfg: PdschConfig) -> torch.Tensor:
    """Per-grant DM-RS pilot values (..., nl, nsym_d, Np) -> the DM-RS rows
    (..., nsym_d, nl, nof_sc) of ``_dmrs_rows``, each layer's values at its
    CDM-group offset."""
    vals = r * _pilot_w_on(r.device, cfg)[:, None, :]
    out = torch.zeros(r.shape[:-3] + (r.shape[-2], cfg.nof_layers, cfg.alloc.nof_sc),
                      dtype=torch.complex64, device=r.device)
    for layer in range(cfg.nof_layers):
        delta = int(dmrs_mod.cdm_group(1, layer))  # type-1 delta == CDM group
        out[..., layer, delta::2] = vals[..., layer, :, :]
    return out


def _grid_rows_fast(layered: torch.Tensor, precoding: torch.Tensor,
                    cfg: PdschConfig, dmrs_override: torch.Tensor | None = None) -> torch.Tensor:
    """(..., nl, ndata) symbol-major layer symbols -> (..., P, nsym, nsc)
    grids: data rows reshape straight into the grid, DM-RS rows come from
    the static pilot table (or from ``dmrs_override``, per-grant pilot
    values (..., nl, nsym_d, Np)), then exact f32 precoding."""
    a = cfg.alloc
    nl = cfg.nof_layers
    lead = layered.shape[:-2]
    dev = layered.device
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    data3 = layered.reshape(lead + (nl, len(data_syms), a.nof_sc))
    dmrs_rows = (_dmrs_rows_on(dev, cfg) if dmrs_override is None
                 else _override_rows(dmrs_override, cfg))
    zero_row = torch.zeros(lead + (nl, a.nof_sc), dtype=torch.complex64, device=dev)
    rows = []
    for s in range(cfg.nof_grid_symbols):
        if s in data_syms:
            rows.append(data3[..., data_syms.index(s), :])
        elif s in a.dmrs_symbols and a.sym_start <= s < a.sym_start + a.sym_count:
            rows.append(dmrs_rows[..., list(a.dmrs_symbols).index(s), :, :].expand(
                lead + (nl, a.nof_sc)))
        else:
            rows.append(zero_row)
    win = torch.stack(rows, dim=-2)  # (..., nl, S, nof_sc)
    if a.sc_start or a.nof_sc != cfg.nof_grid_sc:
        win = torch.nn.functional.pad(
            win, (a.sc_start, cfg.nof_grid_sc - a.sc_start - a.nof_sc))
    return _precode(win, precoding)


def _precode(grid_l: torch.Tensor, precoding: torch.Tensor) -> torch.Tensor:
    """(..., nl, nsym, nsc) layer grids and the (nl, P) precoding, or one
    (..., nl, P) per leading element -> (..., P, nsym, nsc) port grids,
    exact float32: one scalar multiply-add per (layer, port)."""
    w = precoding.to(torch.complex64)
    nl, nports = w.shape[-2:]
    return torch.stack([sum(w[..., l, p, None, None] * grid_l[..., l, :, :] for l in range(nl))
                        for p in range(nports)], dim=-3)


def _bit_chain(tb_bits: torch.Tensor, rnti: torch.Tensor, cfg: PdschConfig) -> torch.Tensor:
    """Segment + LDPC encode + rate match + scramble: (..., A) -> (..., G)."""
    with l1_tracer.span("pdsch.bit_chain"):
        cw = encode_transport_block(tb_bits, cfg.sch)
        return scrambling.scramble_bits(cw, _pdsch_c_init(rnti, cfg.n_id))


def _low_papr_pilots(cfg, nof_pilots: int) -> np.ndarray:
    """(nof_pilots,) complex64 low-PAPR DM-RS of a transform-precoded
    grant: one sequence on every DM-RS symbol, indexed from the allocation
    start (sequence group n_rs_id mod 30, base sequence 0)."""
    return np.asarray(sequences.base_sequence(cfg.n_rs_id % 30, 0, nof_pilots), np.complex64)


@functools.lru_cache(maxsize=None)
def _scatter_plan(cfg: PdschConfig):
    """Host plan of the scatter assembly on the flat (nl * nsym * nsc)
    layer grid: (data RE indices (nl * ndata,), DM-RS indices and values,
    PT-RS indices and values on layer 0)."""
    a = cfg.alloc
    nl = cfg.nof_layers
    n = cfg.nof_grid_symbols * cfg.nof_grid_sc
    didx = alloc_mod.data_re_indices(a, cfg.nof_grid_symbols, cfg.nof_grid_sc,
                                     cfg.reserved).astype(np.int64)
    data_idx = (np.arange(nl)[:, None] * n + didx[None]).reshape(-1)
    beta = np.float32(dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data))
    d_idx, d_val = [], []
    for layer in range(nl):
        idx, wf, _, seq_idx = alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)
        if cfg.transform_precoding:
            r = np.broadcast_to(_low_papr_pilots(cfg, len(seq_idx)),
                                (len(a.dmrs_symbols), len(seq_idx)))
        else:
            r = dmrs_pilots(cfg, int(seq_idx[-1]) + 1)[:, seq_idx]
        d_idx.append(layer * n + idx.reshape(-1).astype(np.int64))
        d_val.append((beta * r * wf.astype(np.complex64)).reshape(-1))
    if cfg.ptrs_enabled:
        p_idx, p_val, _ = ptrs_layout(cfg)
    else:
        p_idx, p_val = np.zeros(0, np.int32), np.zeros(0, np.complex64)
    return (data_idx, np.concatenate(d_idx), np.concatenate(d_val).astype(np.complex64),
            p_idx.astype(np.int64), p_val)


_scatter_on = device_table(lambda cfg, which: _scatter_plan(cfg)[which])


def _grid_scatter(layered: torch.Tensor, precoding: torch.Tensor,
                  cfg: PdschConfig, dmrs_override: torch.Tensor | None = None) -> torch.Tensor:
    """(..., nl, ndata) symbol-major layer symbols -> (..., P, nsym, nsc)
    grids by the reference's scatter assembly, in its order: data REs
    (DFT-precoded per symbol with transform precoding), then each layer's
    DM-RS (the per-grant pilot values of ``dmrs_override`` where given,
    except with transform precoding's low-PAPR sequence), then PT-RS on
    layer 0; exact f32 precoding."""
    a = cfg.alloc
    nl = cfg.nof_layers
    lead = layered.shape[:-2]
    dev = layered.device
    if cfg.transform_precoding:
        blocks = layered.reshape(lead + (nl, -1, a.nof_sc))
        layered = transform_precoding.precode(blocks).reshape(lead + (nl, -1))
    n = cfg.nof_grid_symbols * cfg.nof_grid_sc
    grid_l = torch.zeros(lead + (nl * n,), dtype=torch.complex64, device=dev)
    grid_l[..., _scatter_on(dev, cfg, 0)] = layered.reshape(lead + (-1,))
    if dmrs_override is None or cfg.transform_precoding:
        grid_l[..., _scatter_on(dev, cfg, 1)] = _scatter_on(dev, cfg, 2)
    else:
        vals = dmrs_override * _pilot_w_on(dev, cfg)[:, None, :]
        grid_l[..., _scatter_on(dev, cfg, 1)] = vals.reshape(lead + (-1,))
    if cfg.ptrs_enabled:
        grid_l[..., _scatter_on(dev, cfg, 3)] = _scatter_on(dev, cfg, 4)
    return _precode(grid_l.reshape(lead + (nl, cfg.nof_grid_symbols, cfg.nof_grid_sc)),
                    precoding)


def _grid_chain(cw: torch.Tensor, precoding: torch.Tensor, cfg: PdschConfig,
                dmrs_override: torch.Tensor | None = None) -> torch.Tensor:
    """Modulate + layer map + DM-RS (+ PT-RS) + precode: (..., G) bits ->
    (..., P, nsym, nsc) port grids.  The scatter-free rows where the
    reference takes them (full data rows, type-1 DM-RS, no PT-RS, no
    transform precoding, no reserved REs), else the scatter assembly.
    ``dmrs_override`` (..., nl, nsym_d, Np) replaces the config's DM-RS
    pilot values per leading element.  The span counts ``reserved_res``,
    the REs the reserved patterns leave empty, summed over the grants."""
    with l1_tracer.span("pdsch.grid") as span:
        span.count(reserved_res=cfg.nof_reserved_re * cw.shape[:-1].numel())
        syms = map_bits(cw, cfg.modulation)  # (..., G/Qm)
        nl = cfg.nof_layers
        # symbol i -> layer i % nl
        layered = syms.reshape(syms.shape[:-1] + (-1, nl)).transpose(-1, -2)
        if (uniform_data_rows(cfg.alloc) and not cfg.transform_precoding
                and not cfg.ptrs_enabled and cfg.alloc.dmrs_config_type == 1
                and not cfg.reserved):
            return _grid_rows_fast(layered, precoding, cfg, dmrs_override)
        return _grid_scatter(layered, precoding, cfg, dmrs_override)


# TS 38.211 Table 7.4.1.2.2-1 (DM-RS type 1): subcarrier k_RE_ref per
# (resourceElementOffset, PT-RS port); reference ptrs_pattern.cpp:36-38.
_PTRS_K_RE_TYPE1 = ((0, 2, 1, 3), (2, 4, 3, 5), (6, 8, 7, 9), (8, 10, 9, 11))


@functools.lru_cache(maxsize=None)
def ptrs_layout(cfg: PdschConfig):
    """(flat grid indices, pilot values, symbol index per RE) of the PT-RS
    REs of this PDU, as the reference lays them out: one DM-RS sequence,
    c_init from the first DM-RS symbol, feeds every PT-RS symbol; PRBs from
    rb_start + k_RB_ref at stride K_PTRS; the subcarrier is the Table
    7.4.1.2.2-1 k_RE_ref of port 0.  Symbol-major: every data symbol holds
    the same PRBs."""
    a = cfg.alloc
    k_re = _PTRS_K_RE_TYPE1[cfg.ptrs_re_offset][0]
    prbs = list(range(a.rb_start + cfg.ptrs_k_rb_ref, a.rb_start + a.rb_count, cfg.ptrs_k))
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, min(a.dmrs_symbols),
                                  cfg.dmrs_scrambling_id, cfg.n_scid)
    nseq = (a.crb_start + a.rb_start + a.rb_count) * 6
    c = scrambling.gold_ref(c_init, 2 * nseq).astype(np.float32)
    r = ((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)
    idx = [sym * cfg.nof_grid_sc + prb * 12 + k_re for sym in data_syms for prb in prbs]
    vals = [r[(a.crb_start + prb) * 6 + k_re // 2] for _sym in data_syms for prb in prbs]
    syms = [sym for sym in data_syms for _prb in prbs]
    return (np.asarray(idx, np.int32), np.asarray(vals, np.complex64),
            np.asarray(syms, np.int32))


def process(tb_bits: torch.Tensor, rnti, precoding: torch.Tensor,
            cfg: PdschConfig) -> torch.Tensor:
    """Encode one PDSCH PDU into port grids: (..., A) TB bits, an RNTI (an
    int, or a tensor of the leading shape) and the (nof_layers, P)
    precoding -> (..., P, nof_grid_symbols, nof_grid_sc) complex64, on the
    device of ``tb_bits``."""
    dev = tb_bits.device
    rnti = torch.as_tensor(rnti, dtype=torch.int64, device=dev)
    cw = _bit_chain(tb_bits, rnti, cfg)
    return _grid_chain(cw, torch.as_tensor(precoding, device=dev).to(torch.complex64), cfg)


@functools.lru_cache(maxsize=None)
def _multi_dmrs_bank(cfg: PdschConfig, first_rbs: tuple) -> np.ndarray:
    """(N, nl, nsym_d, Np) complex64 per-grant DM-RS pilot values: the only
    per-UE constant of equal-config grants at different PRBs (the Gold
    index follows the absolute CRB)."""
    banks = []
    for rb0 in first_rbs:
        a = dataclasses.replace(cfg.alloc, crb_start=int(rb0))
        per_layer = []
        for layer in range(cfg.nof_layers):
            seq_idx = alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)[3]
            ntot = int(seq_idx[-1]) + 1
            rows = []
            for sym in a.dmrs_symbols:
                c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id,
                                              cfg.n_scid)
                c = scrambling.gold_ref(int(c_init), 2 * ntot).astype(np.float32)
                r = ((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)
                rows.append(r[seq_idx])
            per_layer.append(np.stack(rows))
        banks.append(np.stack(per_layer))
    return np.stack(banks).astype(np.complex64)


_bank_on = device_table(_multi_dmrs_bank)


def multi_bit_chain(tbs: torch.Tensor, rntis: torch.Tensor, cfg: PdschConfig) -> torch.Tensor:
    """The bit chain of N equal-config grants as one leading batch: (N, A)
    payload bits and (N,) RNTIs -> (N, G) scrambled codewords."""
    return _bit_chain(tbs, rntis, cfg)


def add_multi_grid(grid: torch.Tensor, first_rbs: tuple, cfg: PdschConfig, cw: torch.Tensor,
                   precoding: torch.Tensor) -> torch.Tensor:
    """The grid chain of N equal-config grants: their (N, G) codewords and
    (N, nl, P) precoding through one batched pass, then each grant's
    window added into the slot grid (in place) at its first PRB, in grant
    order; returns the grid."""
    subs = _grid_chain(cw, precoding, cfg, dmrs_override=_bank_on(grid.device, cfg, first_rbs))
    width = subs.shape[-1]
    for i, rb in enumerate(first_rbs):
        grid[:, :, 12 * rb : 12 * rb + width] += subs[i]
    return grid


def process_multi(tbs: torch.Tensor, rntis, first_rbs, precoding, cfg: PdschConfig,
                  grid: torch.Tensor | None = None, nof_slot_sc: int | None = None
                  ) -> torch.Tensor:
    """Encode N equal-config PDSCH grants into one slot grid in one batched
    pass (the DL twin of ``pusch.process_multi``).

    tbs: (N, A) payload bits (on the device of ``grid`` when one is given);
    rntis: (N,); first_rbs: length-N PRB offsets of compact (rb_start = 0)
    windows sharing ``cfg``; precoding: (nl, P) shared or (N, nl, P) per
    grant; grid: an optional (P, nsym, nof_slot_sc) slot grid to add into
    (a new grid is returned; the given one is left as it was).  Without a
    grid the slot spans at least the config's width and the last grant's
    window.  The config's reserved REs lie on every grant's window."""
    if cfg.ptrs_enabled:
        raise ValueError("process_multi: PT-RS PDUs take the per-PDU path")
    first_rbs = tuple(int(r) for r in first_rbs)
    dev = grid.device if grid is not None else torch.as_tensor(tbs).device
    tbs = torch.as_tensor(tbs, dtype=torch.uint8).to(dev)
    rntis = torch.as_tensor(rntis, dtype=torch.int64).to(dev)
    if grid is None:
        if nof_slot_sc is None:
            nof_slot_sc = max(cfg.nof_grid_sc,
                              *(12 * (rb + cfg.alloc.rb_count) for rb in first_rbs))
        grid = torch.zeros((cfg.nof_ports, cfg.nof_grid_symbols, nof_slot_sc),
                           dtype=torch.complex64, device=dev)
    else:
        grid = grid.clone()
    w = torch.as_tensor(precoding).to(device=dev, dtype=torch.complex64)
    if w.dim() == 2:
        w = w.expand((tbs.shape[0],) + tuple(w.shape))
    return add_multi_grid(grid, first_rbs, cfg, multi_bit_chain(tbs, rntis, cfg), w)
