"""PDCCH processor: DCI payload -> resource grid, and the UE-side receiver.

Port of ``srsran_project_tpu/phy/pdcch.py``: CRC24C attach with RNTI
masking (TS 38.212 §7.3.2) -> input interleaving -> polar encode + rate
match -> scrambling -> QPSK -> CCE/REG mapping, with or without REG-bundle
interleaving, and the PDCCH DM-RS (TS 38.211 §7.3.2, §7.4.1.3).  The RE
layout and the DM-RS values are host plans per ``PdcchConfig``; the grid
is written by index assignment (the indices are unique).  ``receive`` is
the UE side: LS estimate per REG, ZF, QPSK LLRs, polar decode, RNTI-masked
CRC check.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import crc as crc_mod
from ..ops import polar, scrambling
from ..ops._tables import device_table
from ..ops.modulation import Modulation, map_bits
from ..ops.polar import tables as ptab
from ..ran.constants import NRE
from ..support.tracing import l1_tracer


@dataclasses.dataclass(frozen=True)
class PdcchConfig:
    """Twin of the reference's ``PdcchConfig`` (same fields and defaults)."""

    payload_bits: int  # DCI size A (without CRC)
    aggregation_level: int  # 1, 2, 4, 8, 16 (CCEs)
    cce_index: int
    coreset_rb_start: int
    coreset_rb_count: int  # multiple of 6 / duration
    symbol: int = 0  # first CORESET symbol
    duration: int = 1  # CORESET duration in symbols (1-3)
    interleaved: bool = False  # CCE-to-REG interleaving (TS 38.211 §7.3.2.2)
    reg_bundle_size: int = 6  # L: 2, 3 or 6
    interleaver_rows: int = 2  # R: 2, 3 or 6
    shift_index: int = 0  # n_shift
    n_id: int = 0  # pdcch-DMRS-ScramblingID / cell id
    n_rnti: int = 0  # data scrambling (UE-specific search space)
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624
    slot_in_frame: int = 0

    @classmethod
    def from_reference(cls, ref) -> "PdcchConfig":
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    @property
    def nof_regs(self) -> int:
        return self.coreset_rb_count * self.duration

    @property
    def nof_coded_bits(self) -> int:
        # L CCEs x 6 REGs x 9 data REs x 2 bits (QPSK).
        return self.aggregation_level * 6 * 9 * 2

    @functools.cached_property
    def code(self) -> polar.PolarCode:
        return polar.construct(self.payload_bits + 24, self.nof_coded_bits, n_max=9)


def _rnti_bits(rnti: torch.Tensor) -> torch.Tensor:
    """(...,) RNTIs -> (..., 16) uint8 bits, MSB first (int64 arithmetic)."""
    shifts = torch.arange(15, -1, -1, dtype=torch.int64, device=rnti.device)
    return ((rnti.to(torch.int64)[..., None] >> shifts) & 1).to(torch.uint8)


def _crc24c_with_rnti(payload: torch.Tensor, rnti: torch.Tensor) -> torch.Tensor:
    """TS 38.212 §7.3.2: prepend 24 ones, CRC24C, mask the last 16 CRC bits
    with the RNTI; returns payload + CRC (the ones dropped)."""
    payload = payload.to(torch.uint8)
    ones = torch.ones(payload.shape[:-1] + (24,), dtype=torch.uint8, device=payload.device)
    c = crc_mod.crc(torch.cat([ones, payload], dim=-1), "24C")
    c = torch.cat([c[..., :8], c[..., 8:] ^ _rnti_bits(rnti)], dim=-1)
    return torch.cat([payload, c], dim=-1)


@functools.lru_cache(maxsize=None)
def _cce_to_regs(cfg: PdcchConfig) -> list[int]:
    """REG indices of this PDU's CCEs, after optional REG-bundle
    interleaving (TS 38.211 §7.3.2.2).

    REGs are numbered time-first within the CORESET: REG j sits at symbol
    (j mod duration), PRB (j // duration).  CCE i consists of bundles
    f(6i/L + 0..6/L-1), where f is the block interleaver over
    N_bundle = N_REG / L with R rows: f(cR + r) = (rC + c + n_shift) mod N.
    """
    l = cfg.reg_bundle_size
    n_bundle = cfg.nof_regs // l
    if cfg.interleaved:
        r_rows = cfg.interleaver_rows
        c_cols = n_bundle // r_rows
        assert r_rows * c_cols == n_bundle, "N_bundle must divide by R"
        f = [0] * n_bundle
        for x in range(n_bundle):
            c, r = divmod(x, r_rows)
            f[x] = (r * c_cols + c + cfg.shift_index) % n_bundle
    else:
        f = list(range(n_bundle))
    regs = []
    bundles_per_cce = 6 // l
    for i in range(cfg.cce_index, cfg.cce_index + cfg.aggregation_level):
        for b in range(bundles_per_cce):
            bundle = f[i * bundles_per_cce + b]
            regs.extend(range(bundle * l, (bundle + 1) * l))
    return regs


@functools.lru_cache(maxsize=None)
def _re_indices(cfg: PdcchConfig):
    """(data_flat_idx (Nd,), dmrs_flat_idx (Np,), dmrs_seq_idx (Np,),
    dmrs_sym (Np,)), every array sorted by flat grid position: coded
    symbols fill the allocated REs in (symbol, frequency) order, as the
    reference's modulator does."""
    data, dmrs, seq, dsym = [], [], [], []
    for reg in _cce_to_regs(cfg):
        sym = cfg.symbol + (reg % cfg.duration)
        prb = cfg.coreset_rb_start + reg // cfg.duration
        base = sym * cfg.nof_grid_sc + prb * NRE
        for re in range(NRE):
            if re % 4 == 1:
                dmrs.append(base + re)
                # The DM-RS sequence index counts pilot triplets from CRB0.
                seq.append(prb * 3 + re // 4)
                dsym.append(sym)
            else:
                data.append(base + re)
    data = np.sort(np.asarray(data, np.int32))
    order = np.argsort(np.asarray(dmrs, np.int32), kind="stable")
    return (data, np.asarray(dmrs, np.int32)[order], np.asarray(seq, np.int32)[order],
            np.asarray(dsym, np.int32)[order])


def _dmrs_values(cfg: PdcchConfig) -> np.ndarray:
    """(Np,) complex64 DM-RS values in ``_re_indices`` order: per symbol
    the Gold sequence of c_init = (2^17 (14 n_s + l + 1)(2 n_id + 1) +
    2 n_id) mod 2^31, QPSK-mapped."""
    _, _, seq_idx, dmrs_sym = _re_indices(cfg)
    nseq = int(seq_idx.max()) + 1
    out = np.zeros(len(seq_idx), np.complex64)
    for sym in sorted(set(int(s) for s in dmrs_sym)):
        ci = ((1 << 17) * (14 * cfg.slot_in_frame + sym + 1) * (2 * cfg.n_id + 1)
              + 2 * cfg.n_id) % (1 << 31)
        c = scrambling.gold_ref(ci, 2 * nseq).astype(np.float32)
        pilots = (((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)
                  ).astype(np.complex64)
        mask = dmrs_sym == sym
        out[mask] = pilots[seq_idx[mask]]
    return out


_plan_on = device_table(lambda cfg, which: _re_indices(cfg)[which].astype(np.int64))
_dmrs_on = device_table(_dmrs_values)


_c_init_on = device_table(lambda cfg: np.asarray([(cfg.n_rnti << 16) + cfg.n_id], np.int64))


def _data_c_init(cfg: PdcchConfig, device: torch.device) -> torch.Tensor:
    """The data scrambling's c_init, 0-d int64 on the device (a table
    uploaded once per config)."""
    return _c_init_on(device, cfg)[0]


def process(payload: torch.Tensor, rnti, cfg: PdcchConfig) -> torch.Tensor:
    """Encode one DCI into a single-port grid: (..., A) payload bits and an
    RNTI (int or tensor of the leading shape) -> (..., nsym, nsc)
    complex64 on the payload's device.  The span ``pdcch.encode`` counts
    ``pdus``, the DCIs encoded."""
    lead = payload.shape[:-1]
    with l1_tracer.span("pdcch.encode") as span:
        span.count(pdus=lead.numel())
        dev = payload.device
        rnti = torch.as_tensor(rnti, dtype=torch.int64, device=dev)
        coded = polar.encode(_crc24c_with_rnti(payload, rnti), cfg.code, interleave_input=True)
        coded = scrambling.scramble_bits(coded, _data_c_init(cfg, dev))
        syms = map_bits(coded, Modulation.QPSK)
        grid = torch.zeros(lead + (cfg.nof_grid_symbols * cfg.nof_grid_sc,),
                           dtype=torch.complex64, device=dev)
        grid[..., _plan_on(dev, cfg, 0)] = syms
        grid[..., _plan_on(dev, cfg, 1)] = _dmrs_on(dev, cfg)
        return grid.reshape(lead + (cfg.nof_grid_symbols, cfg.nof_grid_sc))


@functools.lru_cache(maxsize=None)
def _re_groups(cfg: PdcchConfig):
    """Group ids mapping every data / DM-RS RE to its (symbol, PRB) REG, for
    the LS channel estimate on receive: (data groups, DM-RS groups, number
    of groups)."""
    data_idx, dmrs_idx, _, _ = _re_indices(cfg)

    def group_of(flat):
        sym = flat // cfg.nof_grid_sc
        prb = (flat % cfg.nof_grid_sc) // NRE
        return sym * (cfg.nof_grid_sc // NRE) + prb

    groups = sorted({int(group_of(i)) for i in dmrs_idx})
    gid = {g: k for k, g in enumerate(groups)}
    data_g = np.asarray([gid[int(group_of(i))] for i in data_idx], np.int64)
    dmrs_g = np.asarray([gid[int(group_of(i))] for i in dmrs_idx], np.int64)
    return data_g, dmrs_g, len(groups)


_groups_on = device_table(lambda cfg, which: _re_groups(cfg)[which])
_deint_on = device_table(lambda k: ptab.input_interleaver(k).astype(np.int64))


def receive(grid: torch.Tensor, rnti, cfg: PdcchConfig):
    """UE-side PDCCH reception of one candidate: (nsym, nsc) grid ->
    (dci_bits (payload_bits,) uint8, crc_ok bool tensor).

    LS channel estimate per REG from the PDCCH DM-RS (``index_add_``),
    ZF, QPSK soft demap, descramble, polar rate dematch + SC decode, and
    CRC24C with the RNTI mask (the blind-decode candidate check)."""
    dev = grid.device
    rnti = torch.as_tensor(rnti, dtype=torch.int64, device=dev)
    flat = grid.reshape(-1)
    n_groups = _re_groups(cfg)[2]
    dmrs_g, data_g = _groups_on(dev, cfg, 1), _groups_on(dev, cfg, 0)
    rx_p = flat[_plan_on(dev, cfg, 1)]
    num = torch.zeros(n_groups, dtype=torch.complex64, device=dev).index_add_(
        0, dmrs_g, rx_p * _dmrs_on(dev, cfg).conj())
    cnt = torch.zeros(n_groups, dtype=torch.float32, device=dev).index_add_(
        0, dmrs_g, torch.ones_like(rx_p.real))
    h = num / (cnt + 1e-12)

    rx_d = flat[_plan_on(dev, cfg, 0)]
    hd = h[data_g]
    eq = rx_d * hd.conj() / (hd.abs() ** 2 + 1e-9)
    # QPSK LLRs (positive = bit 0), re/im interleaved.
    scale = 2.0 * np.sqrt(2.0)
    llrs = torch.stack([scale * eq.real, scale * eq.imag], dim=-1).reshape(-1)
    seq = scrambling.gold_sequence(_data_c_init(cfg, dev), cfg.nof_coded_bits)
    llrs = torch.where(seq == 1, -llrs, llrs)
    u = polar.decode(polar.rate_dematch_llrs(llrs, cfg.code), cfg.code).to(torch.uint8)
    # Undo the DL input interleaver.
    deint = torch.empty_like(u)
    deint[..., _deint_on(dev, cfg.payload_bits + 24)] = u
    payload, crc_rx = deint[..., : cfg.payload_bits], deint[..., cfg.payload_bits :]
    crc_rx = torch.cat([crc_rx[..., :8], crc_rx[..., 8:] ^ _rnti_bits(rnti)], dim=-1)
    ones = torch.ones(payload.shape[:-1] + (24,), dtype=torch.uint8, device=dev)
    expected = crc_mod.crc(torch.cat([ones, payload], dim=-1), "24C")
    return payload, (expected == crc_rx).all(dim=-1)
