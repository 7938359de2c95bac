"""PUSCH receiver front end: resource grid -> descrambled int8 LLRs.

Port of ``srsran_project_tpu/phy/pusch.py``, flagship path: the fast
estimator with second-difference noise (``_estimate_stage``), per-
subcarrier 4x4 MMSE weights applied across the data symbols
(``_equalize_stage``, kernel K3), and the float max-log demapper with
int8 quantization, descrambling and post-equalization SINR
(``_demap_stage``).  Every function takes a leading slot-batch dimension
(B, ...).  Field values outside this path raise NotImplementedError.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from srsran_project_tpu.phy import allocation as alloc_mod
from srsran_project_tpu.ran import dmrs as dmrs_mod

from ..ops import scrambling
from ..ops._tables import device_table
from ..ops.equalizer import mmse_weights_4x4
from ..ops.estimator import estimate_channel
from ..ops.modulation import Modulation, demap_soft, quantize_llr
from ..ops.modulation.evm import evm
from .pdsch import check_flagship_alloc
from .sch import SchConfig

# Field -> (the value this port runs, the ROADMAP item that ports the rest).
_SLICE_ONLY = {
    "equalizer": ("mmse", "Q1.8"),
    "sinr_method": ("post_equalization", "Q1.8"),
    "noise_method": ("second_difference", "Q1.8"),
    "estimator": ("fast", "Q1.8"),
    "demapper": ("float", "Q1.8 / Q2 K4"),
    "ldpc_decoder": ("auto", "Q1.8"),
    "cfo_compensation": (False, "Q1.8"),
    "uci": (None, "Q1.8"),
    "ptrs_enabled": (False, "Q1.8"),
    "transform_precoding": (False, "Q1.8"),
    "compute_ta": (False, "Q1.8"),
}


@dataclasses.dataclass(frozen=True)
class PuschConfig:
    """Twin of the reference's ``PuschConfig`` (same fields and defaults).
    ``uci`` takes only None here, the reference's UciOnPuschConfig is not
    ported."""

    tbs: int
    target_code_rate: float
    modulation: Modulation
    alloc: alloc_mod.Allocation
    nof_layers: int = 1
    nof_rx_ports: int = 1
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624
    scs_khz: int = 30
    n_id: int = 0
    rv: int = 0
    slot_in_frame: int = 0
    dmrs_scrambling_id: int = 0
    n_scid: int = 0
    nof_ldpc_iterations: int = 6
    equalizer: str = "mmse"
    sinr_method: str = "post_equalization"
    noise_method: str = "second_difference"
    estimator: str = "fast"
    llr_range_limit: float = 20.0
    demapper: str = "float"
    ldpc_decoder: str = "auto"
    cfo_compensation: bool = False
    ldpc_early_stop: bool = True
    uci: object | None = None
    ptrs_enabled: bool = False
    ptrs_k: int = 2
    ptrs_re_offset: int = 0
    ptrs_k_rb_ref: int = 0
    transform_precoding: bool = False
    n_rs_id: int = 0
    compute_ta: bool = False

    def __post_init__(self):
        for name, (ported, item) in _SLICE_ONLY.items():
            if getattr(self, name) != ported:
                raise NotImplementedError(
                    f"PuschConfig.{name}={getattr(self, name)!r} is not ported yet "
                    f"(ROADMAP {item}); the port runs {name}={ported!r}")

    @functools.cached_property
    def g_total(self) -> int:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        return alloc_mod.nof_data_re(self.alloc) * qm * self.nof_layers

    @functools.cached_property
    def sch(self) -> SchConfig:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        return SchConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            qm=qm,
            nof_layers=self.nof_layers,
            nof_total_bits=self.g_total,
            rv=self.rv,
            decoder=self.ldpc_decoder,
        )


def _pusch_c_init(rnti: torch.Tensor, n_id: int) -> torch.Tensor:
    return (rnti.to(torch.int64) << 15) + n_id


@functools.lru_cache(maxsize=None)
def _estimate_constants(cfg: PuschConfig):
    """Host pilot geometry + DM-RS pilot values: (idx_all (nl, nsym_d*Np)
    int32, wf_all (nl, Np) f32, r_all (nl, nsym_d, Np) complex64 descaled
    by the DM-RS boost beta, pair positions)."""
    a = cfg.alloc
    idx_l, wf_l, seq_l = [], [], []
    pair_pos = None
    for layer in range(cfg.nof_layers):
        idx, wf, pair_pos, seq_idx = alloc_mod.pilot_re_indices(a, layer, cfg.nof_grid_sc)
        idx_l.append(idx.reshape(-1))
        wf_l.append(wf)
        seq_l.append(seq_idx)
    idx_all = np.stack(idx_l).astype(np.int32)
    wf_all = np.stack(wf_l).astype(np.float32)
    n_total = int(max(s[-1] for s in seq_l)) + 1
    pil = []
    for sym in a.dmrs_symbols:
        c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id, cfg.n_scid)
        c = scrambling.gold_ref(int(c_init), 2 * n_total).astype(np.float32)
        pil.append(((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2))
    beta = dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data)
    pilots = (np.stack(pil) / np.float32(beta)).astype(np.complex64)
    r_all = np.stack([pilots[:, s] for s in seq_l]).astype(np.complex64)
    return idx_all, wf_all, r_all, pair_pos


def _estimate_table(cfg: PuschConfig, which: int) -> np.ndarray:
    t = _estimate_constants(cfg)[which]
    return t.astype(np.int64) if which == 0 else t


_est_on = device_table(_estimate_table)


def _estimate_stage(grid: torch.Tensor, cfg: PuschConfig):
    """(B, P, nsym, nsc) grid -> (gflat (B, P, nsym*nsc), h (B, P, nof_sc,
    nl), noise_var (B,)): pilot gather, all port/layer channel estimates,
    second-difference noise."""
    a = cfg.alloc
    nl, npr = cfg.nof_layers, cfg.nof_rx_ports
    nsym_d = len(a.dmrs_symbols)
    b = grid.shape[0]
    dev = grid.device
    _, _, _, pair_pos = _estimate_constants(cfg)
    idx_all = _est_on(dev, cfg, 0)
    wf_all = _est_on(dev, cfg, 1)
    r_all = _est_on(dev, cfg, 2)
    gflat = grid.reshape(b, npr, -1)
    y_p = gflat[:, :, idx_all].reshape(b, npr, nl, nsym_d, -1).transpose(1, 2)  # (B, nl, P, ...)
    h_l = estimate_channel(y_p, r_all[:, None], wf_all[:, None, None, :], pair_pos, a.nof_sc)
    h = h_l.permute(0, 2, 3, 1)  # (B, P, nof_sc, nl)

    # Noise from (1, -2, 1) second differences of the OCC-despread pair
    # estimates (co-CDM layer removed exactly, channel level and slope
    # cancelled; the bulk delay is derotated first so curvature from a
    # fast phase ramp does not read as noise).
    ls = y_p * r_all[:, None].conj() * wf_all[:, None, None, :]
    pair = ls.reshape(ls.shape[:-1] + (ls.shape[-1] // 2, 2))
    h_pair = pair.mean(dim=-1).mean(dim=-2)  # (B, nl, P, NpPairs)
    npair = h_pair.shape[-1]
    slope = torch.angle(torch.sum(h_pair[..., 1:] * h_pair[..., :-1].conj(), dim=-1,
                                  keepdim=True))
    ramp = torch.arange(npair, dtype=torch.float32, device=dev)
    h_pair = h_pair * torch.polar(torch.ones_like(slope), -slope * ramp)
    d2 = h_pair[..., 2:] - 2.0 * h_pair[..., 1:-1] + h_pair[..., :-2]
    beta2 = dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data) ** 2
    nv = (d2.abs() ** 2).reshape(b, -1).mean(dim=-1) * nsym_d / 3.0 * beta2
    return gflat, h, torch.clamp_min(nv, 1e-10)


def _equalize_stage(gflat: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                    cfg: PuschConfig):
    """Per-subcarrier 4x4 MMSE weights (kernel K3) applied to every data
    symbol -> (x_hat (B, ndata, nl) complex64, eq_nvar (B, ndata, nl))."""
    a = cfg.alloc
    nl, npr = cfg.nof_layers, cfg.nof_rx_ports
    if (nl, npr) != (4, 4):
        raise NotImplementedError(f"{npr}x{nl} equalization: only 4x4 MMSE is ported "
                                  "(ROADMAP Q1.8)")
    b = gflat.shape[0]
    g3 = gflat.reshape(b, npr, cfg.nof_grid_symbols, cfg.nof_grid_sc)
    data_syms = [s for s in range(a.sym_start, a.sym_start + a.sym_count)
                 if s not in a.dmrs_symbols]
    y = g3[:, :, data_syms, a.sc_start : a.sc_start + a.nof_sc]  # (B, P, nsym_d, nof_sc)
    w, eq_sc = mmse_weights_4x4(h.transpose(1, 2).contiguous(), noise_var)
    # x[b, s, n, l] = sum_p w[b, n, l, p] y[b, p, s, n]
    x = torch.stack([sum(w[:, None, :, l, p] * y[:, p] for p in range(npr))
                     for l in range(nl)], dim=-1)  # (B, nsym_d, nof_sc, nl)
    eq_nvar = eq_sc[:, None].expand(b, len(data_syms), a.nof_sc, nl)
    return x.reshape(b, -1, nl), eq_nvar.reshape(b, -1, nl)


def _demap_stage(x_hat: torch.Tensor, eq_nvar: torch.Tensor, rnti: torch.Tensor,
                 cfg: PuschConfig):
    """Soft demap + de-layer-map + quantize + descramble, and the
    decision-directed post-equalization SINR -> (llr_i8 (B, G), sinr (B,))."""
    b, _, nl = x_hat.shape
    qm = cfg.sch.qm
    llr = demap_soft(x_hat.transpose(1, 2), eq_nvar.transpose(1, 2), cfg.modulation)
    llr = llr.reshape(b, nl, -1, qm).transpose(1, 2).reshape(b, -1)  # (B, G)
    llr_i8 = scrambling.descramble_llrs(quantize_llr(llr, cfg.llr_range_limit),
                                        _pusch_c_init(rnti, cfg.n_id))
    e = evm(x_hat.reshape(b, -1), cfg.modulation)
    return llr_i8, 1.0 / torch.clamp_min(e * e, 1e-12)


def _front_end(grid: torch.Tensor, rnti: torch.Tensor, cfg: PuschConfig):
    """(B, P, nsym, nsc) grids and (B,) RNTIs -> (llr_i8 (B, G),
    noise_var (B,), post-equalization SINR (B,))."""
    check_flagship_alloc(cfg.alloc)
    gflat, h, noise_var = _estimate_stage(grid, cfg)
    x_hat, eq_nvar = _equalize_stage(gflat, h, noise_var, cfg)
    llr_i8, sinr = _demap_stage(x_hat, eq_nvar, rnti, cfg)
    return llr_i8, noise_var, sinr
