"""PUCCH formats 0 and 1: generation (UE side, for loopback) and detection
(gNB side).

Port of ``srsran_project_tpu/phy/pucch.py``: format 0 detection correlates
the received REs against every candidate cyclic shift (SR candidates and a
second hop included); format 1 despreads the DM-RS and data symbols of
each hop with their time-domain OCC and combines them coherently, with the
DTX statistic rho.  The sequences and shifts are static per config: each
detector builds its reference sequences once per (config, device) with
``sequences.generate`` (float32 phase ramp on the device, as the
reference) and then runs batched tensor algebra on the grid.
``format1_detect_batch`` detects every multiplexed F1 transmission of one
resource at once: a 12-point DFT over the subcarriers despreads every
cyclic shift, the OCCs of Table 6.3.2.4.1-2 over each hop's symbols every
OCC.
``format1_detect_all`` is what a slot calls: occasions that share a
resource go through the batch detector, a lone occasion through
``format1_detect``.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling, sequences
from ..ops._tables import device_table
from ..ran.constants import NRE
from ..support.tracing import l1_tracer


@dataclasses.dataclass(frozen=True)
class PucchFormat0Config:
    prb: int  # PRB index in the grid
    start_symbol: int
    nof_symbols: int  # 1 or 2
    initial_cyclic_shift: int  # m0
    n_id: int  # hopping id
    slot_in_frame: int = 0
    nof_harq_bits: int = 1  # 0 (SR only), 1 or 2
    # Intra-slot frequency hopping: PRB of the second symbol (TS 38.213
    # 9.2.1; reference format0_configuration.second_hop_prb).
    second_hop_prb: int | None = None
    # True when this PUCCH occasion coincides with an SR opportunity: the
    # UE signals positive SR by shifting m_cs (+3 for 1 HARQ bit, +1 for 2;
    # TS 38.213 9.2.4 / 38.211 Table 6.3.2.3.1-1), doubling the candidate
    # set the detector searches.
    sr_opportunity: bool = False
    nof_grid_sc: int = 624


@dataclasses.dataclass(frozen=True)
class PucchFormat1Config:
    prb: int
    start_symbol: int
    nof_symbols: int  # 4..14
    initial_cyclic_shift: int
    occ_index: int  # time-domain OCC index
    n_id: int
    slot_in_frame: int = 0
    nof_harq_bits: int = 1
    nof_grid_sc: int = 624
    # Intra-slot frequency hopping: PRB of the second hop (symbols
    # nof_symbols//2 onward); OCC spreading restarts per hop (TS 38.211
    # 6.3.2.4.2; reference format1_configuration.second_hop_prb).
    second_hop_prb: int | None = None


def _ncs_values(n_id: int, slot: int, symbols) -> list[int]:
    """n_cs(n_s, l) per TS 38.211 §6.3.2.2.2 from the cell PRN sequence."""
    out = []
    seq = scrambling.gold_ref(n_id % (1 << 31), 8 * 14 * (slot + 1))
    for l in symbols:
        bits = seq[8 * (14 * slot + l) : 8 * (14 * slot + l) + 8]
        out.append(int(sum(int(b) << m for m, b in enumerate(bits))))
    return out


def _alpha(m0: int, m_cs: int, n_cs: int) -> float:
    return 2.0 * np.pi / NRE * ((m0 + m_cs + n_cs) % NRE)


# m_cs per HARQ value (TS 38.213 Table 9.2.3-3/9.2.3-4; golden-tested
# against the reference detector dictionaries,
# pucch_detector_format0.cpp:45-52).
_MCS_1BIT = {0: 0, 1: 6}
# value = b0 + 2*b1: (0,0)->0, (1,0)->9, (0,1)->3, (1,1)->6.
_MCS_2BIT = {0: 0, 1: 9, 3: 6, 2: 3}


def _f0_candidates(cfg: PucchFormat0Config):
    if cfg.nof_harq_bits == 0:
        return [0]
    if cfg.nof_harq_bits == 1:
        base = [_MCS_1BIT[v] for v in range(2)]
        sr_shift = 3
    else:
        base = [_MCS_2BIT[v] for v in range(4)]
        sr_shift = 1
    if cfg.sr_opportunity:
        return base + [(m + sr_shift) % 12 for m in base]
    return base


def format0_generate(cfg: PucchFormat0Config, harq_value: int, sr: bool = False,
                     device: torch.device | str = "cuda") -> torch.Tensor:
    """UE-side signal for loopback: (nof_symbols, 12) complex64 on ``device``.

    sr: positive scheduling request (requires cfg.sr_opportunity)."""
    cands = _f0_candidates(cfg)
    idx = harq_value if cfg.nof_harq_bits else 0
    if sr:
        if not (cfg.sr_opportunity and cfg.nof_harq_bits):
            raise ValueError("a positive SR needs an SR opportunity and HARQ bits")
        idx += len(cands) // 2
    return _f0_refs(cfg, torch.device(device))[idx].clone()  # not a view of the cache


# DTX decision thresholds, calibrated on 4000 noise-only draws per format
# (tests/test_pucch_stats.py asserts the operating points): false-alarm
# rate < 0.1% (max observed DTX metric: F0 0.395, F1 rho 0.707) while the
# 3 dB single-port operating point detects with ~0 missed detections
# (min observed signal metric: F0 0.449, F1 rho 0.810).  The reference
# validates its PUCCH demodulators at spec operating points the same way
# (detector statistics per format).
F0_DTX_THRESHOLD = 0.42
F1_DTX_THRESHOLD = 0.75


@functools.lru_cache(maxsize=None)
def _f0_refs(cfg: PucchFormat0Config, device: torch.device) -> torch.Tensor:
    """(nof_candidates, nof_symbols, 12) reference sequences of every
    candidate cyclic shift."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)
    ncs = _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)
    m_cs = _f0_candidates(cfg) if cfg.nof_harq_bits else [0]
    return torch.stack([torch.stack([
        sequences.generate(u, v, NRE, float(np.float32(_alpha(cfg.initial_cyclic_shift, m, n))),
                           device) for n in ncs]) for m in m_cs])


def format0_detect(grid: torch.Tensor, cfg: PucchFormat0Config):
    """Detect PUCCH F0 from a (P, nsym, nsc) grid.

    Returns (candidate index (int32), metric (float32), per-candidate
    powers): the index is the HARQ value, plus half the candidates for a
    positive SR."""
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    # Intra-slot frequency hopping: symbols after the first move to
    # second_hop_prb (reference pucch_detector_format0.cpp:150-155).
    hop = cfg.second_hop_prb if cfg.second_hop_prb is not None else cfg.prb
    prbs = [cfg.prb] + [hop] * (cfg.nof_symbols - 1)
    y = torch.stack([grid[:, s, p * NRE : (p + 1) * NRE] for s, p in zip(syms, prbs)],
                    dim=1)  # (P, S, 12)
    refs = _f0_refs(cfg, grid.device)  # (ncand, S, 12)
    total = (y.abs() ** 2).sum() + 1e-12
    # Coherent correlation per port and symbol, power-combined.
    corr = (y[None] * refs[:, None].conj()).sum(dim=-1)  # (ncand, P, S)
    powers = (corr.abs() ** 2).sum(dim=(1, 2))
    best = torch.argmax(powers)
    # Ideal noiseless signal gives metric 1: each symbol contributes
    # |12 h|^2 = 144 |h|^2 to the winning correlation and 12 |h|^2 to total.
    return best.to(torch.int32), powers[best] / (total * NRE), powers


# Time-domain OCC w_i(m) = exp(j 2 pi phi(m) / N_sf) for format 1 (TS 38.211
# Table 6.3.2.4.1-2): phi(m) = i m, the DFT's rows, except at N_sf = 4,
# where the table has the Walsh rows.  (The JAX package takes the DFT's rows
# at N_sf = 4 too; a UE sends the table's.)
_WALSH4_PHI = ((0, 0, 0, 0), (0, 2, 0, 2), (0, 0, 2, 2), (0, 2, 2, 0))


def _occ(n_sf: int, i: int) -> np.ndarray:
    phi = np.asarray(_WALSH4_PHI[i]) if n_sf == 4 else i * np.arange(n_sf)
    return np.exp(2j * np.pi * phi / n_sf).astype(np.complex64)


# (rows, n) conjugated OCCs of an n-symbol part over its first ``rows``
# indices, zero rows past n: despreads every OCC of the part at once.
_occ_bank_on = device_table(lambda n, rows: np.stack(
    [np.conj(_occ(n, i)) if i < n else np.zeros(n, np.complex64) for i in range(rows)]))


def _f1_hops(cfg: PucchFormat1Config):
    """Per-hop (syms, dmrs_syms, data_syms, prb).  One hop without
    frequency hopping; with hopping, the second half of the allocation
    moves to second_hop_prb and OCC spreading restarts."""
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    if cfg.second_hop_prb is None:
        groups = [(syms, cfg.prb)]
    else:
        half = cfg.nof_symbols // 2
        groups = [(syms[:half], cfg.prb), (syms[half:], cfg.second_hop_prb)]
    hops = []
    for hop_syms, prb in groups:
        dmrs = [l for l in hop_syms if (l - cfg.start_symbol) % 2 == 0]
        data = [l for l in hop_syms if (l - cfg.start_symbol) % 2 == 1]
        hops.append((hop_syms, dmrs, data, prb))
    return hops


@functools.lru_cache(maxsize=None)
def _f1_refs(cfg: PucchFormat1Config, device: torch.device):
    """Per hop: (PRB, DM-RS symbols, their (n, 12) sequences and (n,) OCC,
    data symbols, their sequences and OCC)."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    ncs = dict(zip(syms, _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)))

    def part(l_list):
        seq = torch.stack([sequences.generate(
            u, v, NRE, float(np.float32(_alpha(cfg.initial_cyclic_shift, 0, ncs[l]))), device)
            for l in l_list])
        occ = torch.from_numpy(_occ(max(len(l_list), 1), cfg.occ_index)[: len(l_list)]).to(device)
        return list(l_list), seq, occ

    return [(prb, *part(dmrs), *part(data)) for _s, dmrs, data, prb in _f1_hops(cfg)]


def format1_generate(cfg: PucchFormat1Config, bits, device: torch.device | str = "cuda"
                     ) -> torch.Tensor:
    """UE-side signal for loopback: (nof_symbols, 12) complex64 (data and
    DM-RS) on ``device``.  With frequency hopping the caller places row i
    at the PRB of its hop (``_f1_hops``); the OCC restarts on the second
    hop.  The symbol times its OCC weight times the sequence is formed in
    complex128 and rounded once, as the reference's host code does."""
    device = torch.device(device)
    b = [int(x) for x in bits]
    if cfg.nof_harq_bits == 1:
        d = (1.0 - 2.0 * b[0]) / np.sqrt(2) * (1 + 1j)
    else:
        d = ((1.0 - 2.0 * b[0]) + 1j * (1.0 - 2.0 * b[1])) / np.sqrt(2)
    out = torch.zeros((cfg.nof_symbols, NRE), dtype=torch.complex64, device=device)
    for _prb, dmrs, dmrs_seq, _o, data, data_seq, _p in _f1_refs(cfg, device):
        for l_list, seq, scale in ((data, data_seq, d), (dmrs, dmrs_seq, 1.0)):
            w = scale * _occ(len(l_list), cfg.occ_index)  # complex128
            for i, l in enumerate(l_list):
                out[l - cfg.start_symbol] = (complex(w[i]) * seq[i].to(torch.complex128)
                                             ).to(torch.complex64)
    return out


def format1_detect(grid: torch.Tensor, cfg: PucchFormat1Config):
    """Detect PUCCH F1 HARQ bits from a (P, nsym, nsc) grid.

    Returns (bits (nof_harq_bits,) uint8, llrs, rho): rho is the DTX
    statistic, the normalized correlation between the DM-RS and data
    despread estimates in [0, 1] (~1 for a matched transmission, low for
    noise), thresholded against F1_DTX_THRESHOLD.

    The channel is estimated per subcarrier, so another F1 transmission on
    the same PRB, at any other cyclic shift or OCC, adds its own energy to
    the correlation: this detector takes a lone occasion only.  A slot's
    occasions go through ``format1_detect_all``, which sends those that
    share a resource to ``format1_detect_batch``."""
    corr = h_pow = z_pow = 0.0
    for prb, dmrs, dmrs_seq, dmrs_occ, data, data_seq, data_occ in _f1_refs(cfg, grid.device):
        sc = slice(prb * NRE, (prb + 1) * NRE)
        # Coherent despreading within the hop; the hops combine additively
        # (the channel differs per hop, but d is common).
        h = ((grid[:, dmrs, sc] * dmrs_seq.conj()) * dmrs_occ.conj()[:, None]).sum(dim=1) \
            / max(len(dmrs), 1)
        z = ((grid[:, data, sc] * data_seq.conj()) * data_occ.conj()[:, None]).sum(dim=1) \
            / max(len(data), 1)
        corr = corr + (z * h.conj()).sum()
        h_pow = h_pow + (h.abs() ** 2).sum()
        z_pow = z_pow + (z.abs() ** 2).sum()
    rho = corr.abs() / torch.sqrt(h_pow * z_pow + 1e-24)
    if cfg.nof_harq_bits == 1:
        proj = (corr.real + corr.imag) / np.sqrt(2)
        return (proj < 0).to(torch.uint8)[None], proj[None], rho
    bits = torch.stack([corr.real < 0, corr.imag < 0]).to(torch.uint8)
    return bits, torch.stack([corr.real, corr.imag]) / np.sqrt(2), rho


@functools.lru_cache(maxsize=None)
def _f1_batch_refs(cfg: PucchFormat1Config, device: torch.device):
    """Per hop: (PRB, DM-RS symbols, their (n, 12) sequences at cyclic
    shift 0, data symbols, their sequences)."""
    u, v = sequences.group_hopping_params(cfg.n_id, cfg.slot_in_frame, cfg.start_symbol)
    syms = list(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols))
    ncs = dict(zip(syms, _ncs_values(cfg.n_id, cfg.slot_in_frame, syms)))

    def seqs(l_list):
        return torch.stack([sequences.generate(u, v, NRE, float(np.float32(_alpha(0, 0, ncs[l]))),
                                               device) for l in l_list])

    return [(prb, list(dmrs), seqs(dmrs), list(data), seqs(data))
            for _s, dmrs, data, prb in _f1_hops(cfg)]


def format1_detect_batch(grid: torch.Tensor, cfg: PucchFormat1Config) -> dict:
    """Detect every multiplexed F1 transmission on one resource (the
    reference's format1_batch_configuration path) from a (P, nsym, nsc)
    grid; cfg's initial_cyclic_shift and occ_index are ignored.

    Per hop, the LS of each symbol against the shift-0 sequence goes
    through a 12-point DFT over the subcarriers (one bin per initial
    cyclic shift), then through the conjugated OCCs of the hop's DM-RS and
    data symbols (``_occ``: the DFT's rows, Walsh's at 4 symbols; one row
    per OCC, zero past the part's length, as many as the data symbols).
    Returns a dict of ``corr`` (12, max_occ) complex correlations, ``rho``
    (12, max_occ) DTX statistics and ``bits2`` (12, max_occ, 2) hard bits
    ([..., :1] for 1-bit candidates).  Read only the entries the scheduler
    allocated: another active transmission's sidelobes can raise rho on an
    unallocated one."""
    max_occ = max(len(h[2]) for h in _f1_hops(cfg))  # the data symbols bound the OCC set

    def bank(prb, l_list, seq):
        z = grid[:, l_list, prb * NRE : (prb + 1) * NRE] * seq.conj()  # (P, n, 12)
        w = _occ_bank_on(grid.device, len(l_list), max_occ)  # (max_occ, n)
        return torch.matmul(w, torch.fft.fft(z, dim=-1) / NRE) / len(l_list)  # (P, max_occ, 12)

    corr = h_pow = z_pow = 0.0
    for prb, dmrs, dmrs_seq, data, data_seq in _f1_batch_refs(cfg, grid.device):
        hb = bank(prb, dmrs, dmrs_seq)
        zb = bank(prb, data, data_seq)
        corr = corr + (zb * hb.conj()).sum(dim=0)  # (max_occ, 12)
        h_pow = h_pow + (hb.abs() ** 2).sum(dim=0)
        z_pow = z_pow + (zb.abs() ** 2).sum(dim=0)
    corr = corr.T  # (12 shifts, max_occ)
    rho = corr.abs() / torch.sqrt((h_pow * z_pow).T + 1e-24)
    bits2 = torch.stack([corr.real < 0, corr.imag < 0], dim=-1).to(torch.uint8)
    return {"corr": corr, "rho": rho, "bits2": bits2}


# Flat (shift, OCC) entries of a batch detection's (12, max_occ) outputs,
# uploaded once per device and occasion set.
_entries_on = device_table(lambda max_occ, pairs: np.array([s * max_occ + o for s, o in pairs],
                                                            dtype=np.int64))


def _f1_resource(cfg: PucchFormat1Config) -> tuple:
    """What F1 occasions multiplexed by cyclic shift and OCC share: the
    PRBs, the symbols, the hopping id and the slot (the sequences' and
    n_cs's inputs) on the same grid."""
    return (cfg.prb, cfg.second_hop_prb, cfg.start_symbol, cfg.nof_symbols, cfg.n_id,
            cfg.slot_in_frame, cfg.nof_grid_sc)


def format1_detect_all(grid: torch.Tensor, cfgs) -> list:
    """(bits (nof_harq_bits,) uint8, rho) of every F1 occasion of a slot, in
    input order.

    Occasions that share a resource (``_f1_resource``) are code-multiplexed
    by (initial cyclic shift, OCC): one ``format1_detect_batch`` a resource,
    each occasion's bits and rho read at its own (shift, OCC) entry, rho
    held against F1_DTX_THRESHOLD as ``format1_detect``'s is.  Read so, rho
    is the normalized correlation of n = ports x hops despread DM-RS and
    data values; on noise alone rho^2 ~ Beta(1, n - 1), so an allocated,
    silent occasion reads as detected (DTX as ACK) at the rate
    (1 - 0.75^2)^(n - 1): 0.31 % at 4 ports with hopping, 8.4 % at 4
    ports without or 2 with, 44 % at 2 ports without or 1 with, and
    always at 1 port without (rho = 1 on anything); a lone occasion's
    per-subcarrier rho has 12 times the values.  A 1-bit occasion's bit is
    the sign of the correlation's projection on (1 + j), as
    ``format1_detect`` takes it.  A lone occasion goes through
    ``format1_detect``, whose results it keeps bit for bit.  No occasion,
    no span."""
    if not cfgs:
        return []
    with l1_tracer.span("pucch.f1") as span:
        by_resource: dict[tuple, list[int]] = {}
        for j, cfg in enumerate(cfgs):
            by_resource.setdefault(_f1_resource(cfg), []).append(j)
        span.count(occasions=len(cfgs), resources=len(by_resource))
        out: list = [None] * len(cfgs)
        for js in by_resource.values():
            if len(js) == 1:
                out[js[0]] = format1_detect(grid, cfgs[js[0]])[::2]
                continue
            det = format1_detect_batch(grid, cfgs[js[0]])
            entries = _entries_on(grid.device, det["corr"].shape[1],
                                  tuple((cfgs[j].initial_cyclic_shift, cfgs[j].occ_index)
                                        for j in js))
            corr = det["corr"].reshape(-1)[entries]
            rho = det["rho"].reshape(-1)[entries]
            bits2 = torch.stack([corr.real < 0, corr.imag < 0], dim=-1).to(torch.uint8)
            bits1 = (corr.real + corr.imag < 0).to(torch.uint8)[:, None]
            for k, j in enumerate(js):
                out[j] = (bits1[k] if cfgs[j].nof_harq_bits == 1 else bits2[k], rho[k])
        return out
