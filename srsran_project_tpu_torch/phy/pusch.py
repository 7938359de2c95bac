"""PUSCH receiver: resource grid -> transport block, and the loopback
transmitter.

Port of ``srsran_project_tpu/phy/pusch.py``: the fast estimator with
second-difference or pilot-residual noise, CFO compensation (estimate,
derotate each symbol by the slope, estimate again), the TA estimate and
PT-RS common-phase-error tracking (``_estimate``, per-grant pilots
through ``r_override``, the low-PAPR DM-RS of transform precoding; every
estimate per batch element, never averaged across grants; kernel K7 for
the estimate with second-difference noise and no CFO, TA or PT-RS),
per-subcarrier MMSE weights of 1, 2 or 4 layers from 4 ports applied across
full data rows in kernel K8 (``mmse_equalize``; ZF, 3 layers and other port
counts: ``equalize_weights`` and ``apply_weights``), or the per-RE
``equalize`` where data shares the DM-RS symbols (``_equalize_stage``),
the DFT-s-OFDM deprecode (``_deprecode_stage``), the float max-log
demapper (BPSK, pi/2-BPSK, QPSK, square QAM; kernel K5 for QPSK and
square QAM) with int8 quantization, descrambling, the PT-RS LLR erasure
and post-equalization SINR (``_demap_stage``; ``sinr_method="channel_estimator"`` reports the
estimator's pilot SNR instead), and the back end with UCI on PUSCH
(HARQ-ACK, CSI parts 1 and 2 demultiplexed and decoded, two-step CSI whose part-2 size
follows the decoded RI, ``phy/ulsch_demux``) and HARQ (``finish``).  ``process`` decodes one grant per slot,
``process_multi`` N equal-config grants of one slot grid in one batch;
with ``compute_ta`` both add ``ta_s``, the signed delay in seconds.
The plane path (``demapper="planes"``) runs apply + demap + quantize +
descramble in kernel K4 straight into the decoder's bit-planes
(``_front_end_planes``).  The reference-exact conformance modes run too:
``estimator="reference"`` (the 31-tap reference estimator of
``ops/estimator_reftorch``, with its epoch-based CFO derotation and TA,
then PT-RS tracking, which the reference skips: ROADMAP Q3),
``equalizer="mmse_ref"/"zf_ref"`` (``equalizer.equalize_ref`` per RE),
``demapper="reference"`` (the int8 interval demapper
``demapper_i8.demap_llr_i8``) and ``ldpc_decoder="reference_i8"``
(``SchConfig.decoder``: the int8 layered min-sum ``decode_i8``).  Every
function takes a leading batch dimension (B, ...): slots, or the grants
of a slot.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import estimator_reftorch, pusch_estimate, scrambling, transform_precoding
from ..ops._tables import device_table
from ..ops.demap_llrs import demap_llrs, quantized_llrs
from ..ops.demap_planes import demap_planes
from ..ops.equalizer import (MMSE_EQUALIZE_LAYERS, apply_weights, equalize, equalize_ref,
                             equalize_weights, mmse_equalize, mmse_weights_4x4)
from ..ops.estimator import channel_metrics, estimate_h
from ..ops.modulation import Modulation
from ..ops.modulation.demapper_i8 import demap_llr_i8
from ..ops.modulation.evm import nearest_err2
from ..ops.modulation.mapper import SQUARE_QAM
from ..ran import csi as csi_mod
from ..ran import dmrs as dmrs_mod
from ..ran import ulsch_info
from ..support.tracing import l1_tracer
from . import allocation as alloc_mod
from . import pdsch as pdsch_mod
from . import ulsch_demux
from .sch import SchConfig, _fused_decode_ok, decode_transport_block

# Kernel selections -> the values they take (the reference's).
MODES = {
    "equalizer": ("mmse", "zf", "mmse_ref", "zf_ref"),
    "estimator": ("fast", "reference"),
    "demapper": ("float", "planes", "reference"),
    "ldpc_decoder": ("auto", "reference_i8"),
}


@dataclasses.dataclass(frozen=True)
class UciOnPuschConfig:
    """Twin of the reference's ``UciOnPuschConfig``: UCI multiplexed on
    PUSCH (TS 38.212 §6.3), payload sizes and beta offset indices.  With a
    ``csi_report_cfg`` (``ran.csi.CsiReportConfig``: two-step CSI) part 1
    is decoded first and the part-2 size follows its RI; nof_csi1_bits and
    nof_csi2_bits then give part 1's width and the largest part 2 for the
    G split, as in the reference."""

    nof_harq_ack_bits: int = 0
    nof_csi1_bits: int = 0
    nof_csi2_bits: int = 0
    beta_harq_ack_index: int = 9
    beta_csi_index: int = 9
    beta_csi2_index: int = 9
    csi_report_cfg: object | None = None

    @classmethod
    def from_reference(cls, ref) -> "UciOnPuschConfig":
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        if kw["csi_report_cfg"] is not None:
            kw["csi_report_cfg"] = csi_mod.CsiReportConfig.from_reference(kw["csi_report_cfg"])
        return cls(**kw)


@dataclasses.dataclass(frozen=True)
class PuschConfig:
    """Twin of the reference's ``PuschConfig`` (same fields, defaults and
    derived values)."""

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
    uci: UciOnPuschConfig | None = None
    ptrs_enabled: bool = False
    ptrs_k: int = 2
    ptrs_re_offset: int = 0
    ptrs_k_rb_ref: int = 0
    transform_precoding: bool = False
    n_rs_id: int = 0
    compute_ta: bool = False

    def __post_init__(self):
        for name, values in MODES.items():
            if getattr(self, name) not in values:
                raise ValueError(f"PuschConfig.{name}={getattr(self, name)!r}: want one of "
                                 f"{values}")

    @classmethod
    def from_reference(cls, ref) -> "PuschConfig":
        """Copy a reference (JAX package) ``PuschConfig`` field by field, by
        attribute access only; the modulation converts by value, and the
        allocation is rebuilt as the port's own ``Allocation`` from the
        reference's fields."""
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        kw["modulation"] = Modulation(int(kw["modulation"]))
        kw["alloc"] = alloc_mod.Allocation.from_fields(kw["alloc"])
        if kw["uci"] is not None:
            kw["uci"] = UciOnPuschConfig.from_reference(kw["uci"])
        return cls(**kw)

    @functools.cached_property
    def g_total(self) -> int:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        return alloc_mod.nof_data_re(self.alloc) * qm * self.nof_layers

    @functools.cached_property
    def uci_mux(self):
        """``UlschMuxConfig`` when UCI is configured (G_ack, G_csi1, G_csi2
        from the betas), else None."""
        u = self.uci
        if u is None or not (u.nof_harq_ack_bits or u.nof_csi1_bits or u.nof_csi2_bits):
            return None
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        geo = (self.tbs + 24, alloc_mod.nof_data_re(self.alloc), qm, self.nof_layers)
        g_ack = ulsch_info.nof_harq_ack_bits(u.nof_harq_ack_bits, u.beta_harq_ack_index, *geo)
        g_csi1 = ulsch_info.nof_csi1_bits(u.nof_csi1_bits, u.beta_csi_index, *geo, g_ack=g_ack)
        g_csi2 = ulsch_info.nof_csi2_bits(u.nof_csi2_bits, u.beta_csi2_index, *geo,
                                          g_ack=g_ack, g_csi1=g_csi1)
        # Reserved-ACK layout for 1-2 bit payloads: sized as if O_ack = 2
        # (TS 38.212 §6.2.7; data maps through, ACK punctures).
        g_ack_rvd = 0
        if 0 < u.nof_harq_ack_bits <= 2:
            g_ack_rvd = ulsch_info.nof_harq_ack_bits(2, u.beta_harq_ack_index, *geo)
        return ulsch_demux.UlschMuxConfig(
            alloc=self.alloc, qm=qm, nof_layers=self.nof_layers,
            nof_grid_symbols=self.nof_grid_symbols, nof_grid_sc=self.nof_grid_sc,
            g_ack=g_ack, g_csi1=g_csi1, g_csi2=g_csi2,
            nof_ack_bits=u.nof_harq_ack_bits, g_ack_rvd=g_ack_rvd)

    @functools.cached_property
    def sch(self) -> SchConfig:
        qm = int(self.modulation) if self.modulation != Modulation.PI_2_BPSK else 1
        mux = self.uci_mux
        return SchConfig(
            tbs=self.tbs,
            target_code_rate=self.target_code_rate,
            qm=qm,
            nof_layers=self.nof_layers,
            # Rate-matched around CSI (and around a rate-matched ACK).
            nof_total_bits=self.g_total if mux is None else mux.nof_data_bits,
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
    if cfg.transform_precoding:
        # Low-PAPR DM-RS: one sequence on every DM-RS symbol, indexed from
        # the allocation start.
        base = np.zeros(n_total, np.complex64)
        first = int(min(s[0] for s in seq_l))
        base[first:] = pdsch_mod._low_papr_pilots(cfg, n_total - first)
        pil = [base for _ in a.dmrs_symbols]
    else:
        pil = []
        for sym in a.dmrs_symbols:
            c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id,
                                          cfg.n_scid)
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


def _estimate(grid: torch.Tensor, cfg: PuschConfig, r_override=None):
    """(B, P, nsym, nsc) grid -> (gflat (B, P, nsym*nsc), h (B, P, nof_sc,
    nl), noise_var (B,), extras): pilot gather, all port/layer channel
    estimates, with CFO compensation the grid derotated by each grant's
    slope and estimated again, the noise (second differences or the pilot
    residual), and with PT-RS the grid derotated by each symbol's common
    phase error.  ``extras`` holds "snr" (B,) with the channel-estimator
    SINR method and "ta_s" (B,) with compute_ta.  ``r_override`` (B, nl,
    nsym_d, Np) replaces the config's DM-RS pilot values per batch element
    (the grants of a multi-UE slot share a compact config, but their
    pilots follow each grant's absolute CRB).  The span counts the
    ``grants`` (B) and the ``kernel_grants`` K7 estimated."""
    with l1_tracer.span("pusch.estimate") as span:
        b = grid.shape[0]
        fused = _fused_estimate_ok(cfg)
        span.count(grants=b, kernel_grants=b if fused and grid.is_cuda else 0)
        if cfg.estimator == "reference":
            return _estimate_reference(grid, cfg, r_override)
        return _estimate_fast(grid, cfg, r_override, fused)


def _metrics_needed(cfg: PuschConfig) -> bool:
    """Whether the fast estimate needs ``channel_metrics``: CFO
    compensation over two or more DM-RS symbols, the TA, the pilot-residual
    noise (as in the reference, a noise method other than second
    differences) or the estimator's SINR (a SINR method other than post
    equalization)."""
    return ((cfg.cfo_compensation and len(cfg.alloc.dmrs_symbols) > 1) or cfg.compute_ta
            or cfg.noise_method != "second_difference"
            or cfg.sinr_method != "post_equalization")


def _fused_estimate_ok(cfg: PuschConfig) -> bool:
    """Gate of ``pusch_estimate.estimate`` (K7 on a CUDA tensor): the fast
    estimator without metrics or PT-RS, and at least 3 CDM pairs (the
    second differences need 3)."""
    return (cfg.estimator == "fast" and not _metrics_needed(cfg) and not cfg.ptrs_enabled
            and len(_estimate_constants(cfg)[3]) >= 3)


def _estimate_fast(grid: torch.Tensor, cfg: PuschConfig, r_override, fused: bool):
    """``_estimate`` with the fast estimator; ``fused``: through
    ``pusch_estimate.estimate`` (``_fused_estimate_ok``)."""
    a = cfg.alloc
    nl, npr = cfg.nof_layers, cfg.nof_rx_ports
    nsym_d = len(a.dmrs_symbols)
    b = grid.shape[0]
    dev = grid.device
    _, _, _, pair_pos = _estimate_constants(cfg)
    idx_all = _est_on(dev, cfg, 0)
    r_all = _est_on(dev, cfg, 2)[None] if r_override is None else r_override
    # Pilot descaling (_estimate_constants) divides the pilot-domain noise
    # by beta^2; the noise and SNR are referred back to the data REs.
    beta2 = dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data) ** 2
    if fused:  # kernel K7 on a CUDA tensor, its plain version on the CPU
        h, nv = pusch_estimate.estimate(grid, idx_all, r_all, _est_on(dev, cfg, 1), pair_pos,
                                        a.nof_sc, beta2)
        return grid.reshape(b, npr, -1), h, nv, {}
    wf = _est_on(dev, cfg, 1)[:, None, None, :]
    r_all = r_all[:, :, None]
    cfo = cfg.cfo_compensation and nsym_d > 1
    metrics = _metrics_needed(cfg)

    def estimate(g):
        """(pair values (B, nl, P, nsym_d, Np/2), h, residual noise (B, nl,
        P) and metrics, or None without metrics)."""
        gf = g.reshape(b, npr, -1)
        y_p = gf[:, :, idx_all].reshape(b, npr, nl, nsym_d, -1).transpose(1, 2)  # (B, nl, P, ...)
        h_l, ls, h_pair = estimate_h(y_p, r_all, wf, pair_pos, a.nof_sc)
        m = (channel_metrics(y_p, ls, h_pair, compute_ta=cfg.compute_ta, compute_cfo=cfo)
             if metrics else None)
        return h_pair, h_l.permute(0, 2, 3, 1), m  # h (B, P, nof_sc, nl)

    h_pair, h, m = estimate(grid)
    if cfo:
        # Derotate every symbol by the grant's CFO slope (radians per
        # symbol), then estimate again so that the channel's phase
        # reference matches the derotated data symbols.
        slope = m[1]["cfo_phase_per_dmrs_symbol"].mean(dim=(1, 2)) / float(
            a.dmrs_symbols[1] - a.dmrs_symbols[0])
        sym = torch.arange(cfg.nof_grid_symbols, dtype=torch.float32, device=dev)
        phase = -slope[:, None] * sym
        grid = grid * torch.polar(torch.ones_like(phase), phase)[:, None, :, None]
        h_pair, h, m = estimate(grid)
    gflat = grid.reshape(b, npr, -1)
    if cfg.noise_method == "second_difference":
        nv = pusch_estimate.second_difference_noise(h_pair, nsym_d, beta2)
    else:
        nv = m[0].mean(dim=(1, 2)) * beta2
    extras = {}
    if cfg.sinr_method != "post_equalization":
        extras["snr"] = m[1]["snr"].mean(dim=(1, 2)) / beta2
    if cfg.compute_ta:
        # Peak bin of the 4096-point delay profile of the pair channel at
        # the pair spacing: tau = bin / (4096 df_pair).
        df_pair = (pair_pos[1] - pair_pos[0]) * cfg.scs_khz * 1e3
        extras["ta_s"] = m[1]["ta_peak_bin_4096"].mean(dim=(1, 2)) / float(
            np.float32(4096.0 * df_pair))
    if cfg.ptrs_enabled:
        # On the CFO-derotated grid: the reference derotates the grid as it
        # was before, which undoes the CFO compensation (ROADMAP Q3).
        gflat = _ptrs_derotate(grid, gflat, h, cfg)
    return gflat, h, nv, extras


@functools.lru_cache(maxsize=None)
def _reference_config(cfg: PuschConfig) -> estimator_reftorch.RefEstimatorConfig:
    """The reference estimator's config of a grant: the allocation's PRBs
    and symbols, the DM-RS pattern of CDM group 0 (and of group 1 above 2
    layers) relative to the allocation, the DM-RS boost as the scaling,
    the 31-tap filter, the time average, and CFO compensation with two or
    more DM-RS symbols."""
    a = cfg.alloc
    nl = cfg.nof_layers
    if nl > 4:
        raise ValueError("estimator='reference' supports <=4 layers (2 CDM groups)")
    ppb = dmrs_mod.pilots_per_prb(a.dmrs_config_type)

    def pattern(port):
        ks, _ = dmrs_mod.pilot_subcarriers(a.dmrs_config_type, port, a.rb_count, a.rb_start)
        return tuple(int(k - a.sc_start) for k in ks[:ppb])

    return estimator_reftorch.RefEstimatorConfig(
        scs_khz=cfg.scs_khz, nof_prb=a.rb_count, first_symbol=a.sym_start,
        nof_symbols=a.sym_count, dmrs_symbol_mask=sum(1 << s for s in a.dmrs_symbols),
        re_pattern=pattern(0), re_pattern2=pattern(2) if nl > 2 else None, nof_layers=nl,
        scaling=float(dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data)),
        smoothing="filter", td_strategy="average",
        compensate_cfo=cfg.cfo_compensation and len(a.dmrs_symbols) > 1)


_grid_epochs_on = device_table(estimator_reftorch.symbol_epochs)


def _estimate_reference(grid: torch.Tensor, cfg: PuschConfig, r_override=None):
    """``_estimate`` with ``estimator="reference"``: the reference
    estimator on every receive port of each grant (both CDM groups, so up
    to 4 layers), its noise, SNR, CFO and TA averaged over the ports, with
    CFO compensation the grid derotated at each symbol's start epoch, and
    with PT-RS the common-phase-error tracking of ``_estimate``.  The
    reference returns before its PT-RS tracking, so that its PT-RS grants
    fail under phase noise that the fast estimator's pass: repaired here
    (ROADMAP Q3)."""
    a = cfg.alloc
    rcfg = _reference_config(cfg)
    dev = grid.device
    b = grid.shape[0]
    # Per-layer pilots with the OCC, at transmit amplitude (the LS table
    # is descaled by the DM-RS boost; the estimator takes raw pilots and
    # the boost as its scaling).
    r_all = _est_on(dev, cfg, 2)[None] if r_override is None else r_override
    pilots = (r_all * rcfg.scaling) * _est_on(dev, cfg, 1)[:, None, :]  # (B|1, nl, nsym_d, Np)
    window = grid[..., a.sc_start : a.sc_start + a.nof_sc]
    outs = estimator_reftorch.estimate_port_ref(window, pilots[:, None], rcfg, ce=False)
    h = outs["freq_resp"][..., 0, :].transpose(-1, -2)  # (B, P, nof_sc, nl)
    if rcfg.compensate_cfo:
        cfo = outs["cfo"].mean(dim=1)
        phase = -2 * np.pi * _grid_epochs_on(dev, cfg.nof_grid_symbols, cfg.scs_khz) * cfo[:, None]
        grid = grid * torch.polar(torch.ones_like(phase), phase)[:, None, :, None]
    extras = {}
    if cfg.sinr_method != "post_equalization":
        extras["snr"] = outs["snr"].mean(dim=1)
    if cfg.compute_ta:
        extras["ta_s"] = outs["ta_s"].mean(dim=1)
    gflat = grid.reshape(b, cfg.nof_rx_ports, -1)
    if cfg.ptrs_enabled:
        gflat = _ptrs_derotate(grid, gflat, h, cfg)
    return gflat, h, outs["noise_var"].mean(dim=1), extras


def _estimate_stage(grid: torch.Tensor, cfg: PuschConfig, r_override=None):
    """``_estimate`` without its extras: (gflat, h, noise_var)."""
    return _estimate(grid, cfg, r_override)[:3]


def _ptrs_twin(cfg: PuschConfig) -> pdsch_mod.PdschConfig:
    """The transmitter's PdschConfig of a PT-RS grant, as the reference
    builds it for the PT-RS layout."""
    return pdsch_mod.PdschConfig(
        tbs=cfg.tbs, target_code_rate=cfg.target_code_rate, modulation=cfg.modulation,
        alloc=cfg.alloc, nof_layers=cfg.nof_layers, nof_grid_symbols=cfg.nof_grid_symbols,
        nof_grid_sc=cfg.nof_grid_sc, slot_in_frame=cfg.slot_in_frame,
        dmrs_scrambling_id=cfg.dmrs_scrambling_id, n_scid=cfg.n_scid, ptrs_enabled=True,
        ptrs_k=cfg.ptrs_k, ptrs_re_offset=cfg.ptrs_re_offset, ptrs_k_rb_ref=cfg.ptrs_k_rb_ref)


@functools.lru_cache(maxsize=None)
def _ptrs_plan(cfg: PuschConfig):
    """(PT-RS grid indices (Nptrs,), pilot values (Nptrs,), their
    subcarrier in the allocation (Nptrs,), the symbols that carry them);
    each of those symbols holds the same PRBs, symbol-major."""
    p_idx, p_vals, p_syms = pdsch_mod.ptrs_layout(_ptrs_twin(cfg))
    syms = sorted(set(p_syms.tolist()))
    return (p_idx.astype(np.int64), p_vals,
            ((p_idx % cfg.nof_grid_sc) - cfg.alloc.sc_start).astype(np.int64),
            np.asarray(syms, np.int64))


_ptrs_on = device_table(lambda cfg, which: _ptrs_plan(cfg)[which])


def cpe_phases(gflat: torch.Tensor, h: torch.Tensor, cfg: PuschConfig) -> torch.Tensor:
    """PT-RS common phase error: (B, P, nsym*nsc) grid and (B, P, nof_sc,
    nl) channel estimates -> (B, nsym) unit phasors, per data symbol the
    rotation of the received PT-RS REs against pilot x layer 0's channel,
    summed over ports and REs; 1 on symbols without PT-RS."""
    dev = gflat.device
    phase = torch.ones((gflat.shape[0], cfg.nof_grid_symbols), dtype=torch.complex64, device=dev)
    syms = _ptrs_on(dev, cfg, 3)
    if not len(syms):
        return phase
    y_p = gflat[:, :, _ptrs_on(dev, cfg, 0)]  # (B, P, Nptrs)
    expect = _ptrs_on(dev, cfg, 1) * h[:, :, _ptrs_on(dev, cfg, 2), 0]
    corr = (y_p * expect.conj()).sum(dim=1)  # (B, Nptrs)
    per_sym = corr.reshape(corr.shape[0], len(syms), -1).sum(dim=-1)
    mag = per_sym.abs()
    phase[:, syms] = torch.where(mag > 0, per_sym / torch.clamp_min(mag, 1e-12), 1.0 + 0j)
    return phase


def _ptrs_derotate(grid: torch.Tensor, gflat: torch.Tensor, h: torch.Tensor,
                   cfg: PuschConfig) -> torch.Tensor:
    """The grid derotated by each symbol's common phase error, flat."""
    phase = cpe_phases(gflat, h, cfg)
    return (grid * phase.conj()[:, None, :, None]).reshape(gflat.shape)


def _data_symbols(cfg: PuschConfig) -> list:
    """The allocation's symbols that carry no DM-RS, ascending."""
    a = cfg.alloc
    return [s for s in range(a.sym_start, a.sym_start + a.sym_count) if s not in a.dmrs_symbols]


def _grid_of(gflat: torch.Tensor, cfg: PuschConfig) -> torch.Tensor:
    """(B, P, nsym*nsc) grid -> its (B, P, nsym, nsc) view."""
    return gflat.reshape(gflat.shape[0], cfg.nof_rx_ports, cfg.nof_grid_symbols, cfg.nof_grid_sc)


def _data_rows(gflat: torch.Tensor, cfg: PuschConfig) -> torch.Tensor:
    """(B, P, nsym*nsc) grid -> (B, P, nsym_d, nof_sc) data symbols of the
    allocation (full rows: the DM-RS symbols carry no data)."""
    a = cfg.alloc
    return _grid_of(gflat, cfg)[:, :, _data_symbols(cfg), a.sc_start : a.sc_start + a.nof_sc]


def _weights(h: torch.Tensor, noise_var: torch.Tensor, cfg: PuschConfig):
    """(B, P, nof_sc, nl) channels -> per-subcarrier weights (B, nof_sc,
    nl, P) and post-equalization noise (B, nof_sc, nl): kernel K3 for 4x4
    MMSE (the plane path's K4 takes them), the general ``equalize_weights``
    (MMSE or ZF) for the rest."""
    hs = h.transpose(1, 2)  # (B, nof_sc, P, nl)
    if (cfg.nof_layers, cfg.nof_rx_ports, cfg.equalizer) == (4, 4, "mmse"):
        return mmse_weights_4x4(hs, noise_var)  # K3 reads the view through its strides
    # Elementwise torch keeps its input's layout: the copy makes w
    # contiguous, as K4 takes it on the plane path.
    return equalize_weights(hs.contiguous(), noise_var[:, None], method=cfg.equalizer)


_data_re_on = device_table(lambda cfg: alloc_mod.data_re_indices(
    cfg.alloc, cfg.nof_grid_symbols, cfg.nof_grid_sc).astype(np.int64))
_data_sc_on = device_table(lambda cfg: (alloc_mod.data_re_indices(
    cfg.alloc, cfg.nof_grid_symbols, cfg.nof_grid_sc) % cfg.nof_grid_sc
    - cfg.alloc.sc_start).astype(np.int64))


def _equalize_stage(gflat: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                    cfg: PuschConfig):
    """(x_hat (B, ndata, nl) complex64, eq_nvar (B, ndata, nl)) in data-RE
    order.  Full data rows: per-subcarrier weights applied to every data
    symbol, in kernel K8 for MMSE at 4 ports and 1, 2 or 4 layers on a
    CUDA tensor (its plain version on the CPU).  Otherwise (data on the
    DM-RS symbols), and for the reference equalizers: the data-RE gather
    and the per-RE ``equalize`` (or ``equalize_ref``) with each RE's
    channel, as the reference does.  The span counts the ``res`` (B *
    ndata) and the ``kernel_res`` K8 equalized."""
    with l1_tracer.span("pusch.equalize") as span:
        nl, npr = cfg.nof_layers, cfg.nof_rx_ports
        fused = False
        if not pdsch_mod.uniform_data_rows(cfg.alloc) or cfg.equalizer.endswith("_ref"):
            dev = gflat.device
            y = gflat[:, :, _data_re_on(dev, cfg)].transpose(1, 2)  # (B, ndata, P)
            h_data = h[:, :, _data_sc_on(dev, cfg), :].transpose(1, 2)  # (B, ndata, P, nl)
            if cfg.equalizer.endswith("_ref"):
                # The reference's per-port noise: the grant's, on every port.
                x, eq_nvar = equalize_ref(y, h_data, noise_var[:, None].expand(-1, npr),
                                          method=cfg.equalizer[: -len("_ref")])
            else:
                x, eq_nvar = equalize(y, h_data, noise_var[:, None], method=cfg.equalizer)
        elif cfg.equalizer == "mmse" and npr == 4 and nl in MMSE_EQUALIZE_LAYERS:
            # Kernel K8 on a CUDA tensor, its plain version on the CPU.
            x, eq_nvar = mmse_equalize(_grid_of(gflat, cfg), h, noise_var, _data_symbols(cfg),
                                       cfg.alloc.sc_start)
            fused = x.is_cuda
        else:
            w, eq_sc = _weights(h, noise_var, cfg)
            x, eq_nvar = apply_weights(_data_rows(gflat, cfg), w, eq_sc)
        res = x.shape[0] * x.shape[1]
        span.count(res=res, kernel_res=res if fused else 0)
        return x, eq_nvar


def _deprecode_stage(x_hat: torch.Tensor, eq_nvar: torch.Tensor, cfg: PuschConfig):
    """Undo transform precoding: per data symbol, the IDFT of the equalized
    M_sc block, and its noise variances replaced by their mean."""
    b, _, nl = x_hat.shape
    xb = x_hat.reshape(b, -1, cfg.alloc.nof_sc, nl)
    nb = eq_nvar.reshape(b, -1, cfg.alloc.nof_sc, nl)
    return (transform_precoding.deprecode(xb, dim=2).reshape(x_hat.shape),
            transform_precoding.deprecode_noise_var(nb, dim=2).reshape(eq_nvar.shape))


@functools.lru_cache(maxsize=None)
def _ptrs_bit_positions(cfg: PuschConfig) -> np.ndarray:
    """Bit indices in the G stream that the PT-RS punctures (every layer's
    bits of a PT-RS RE, as the reference erases them)."""
    didx = alloc_mod.data_re_indices(cfg.alloc, cfg.nof_grid_symbols, cfg.nof_grid_sc)
    pos_of = {int(g): i for i, g in enumerate(didx)}
    bits_per_re = cfg.sch.qm * cfg.nof_layers
    out = []
    for g in _ptrs_plan(cfg)[0]:
        i = pos_of.get(int(g))
        if i is not None:
            out.extend(range(i * bits_per_re, (i + 1) * bits_per_re))
    return np.asarray(sorted(out), np.int32)


_ptrs_bits_on = device_table(lambda cfg: _ptrs_bit_positions(cfg).astype(np.int64))


def _demap_stage(x_hat: torch.Tensor, eq_nvar: torch.Tensor, rnti: torch.Tensor,
                 cfg: PuschConfig):
    """Soft demap + de-layer-map + quantize + descramble (+ the PT-RS
    erasure), and the decision-directed post-equalization SINR ->
    (llr_i8 (B, G), sinr (B,)).  The float demapper on QPSK and square QAM
    runs kernel K5 (``demap_llrs``) on a CUDA tensor; BPSK, pi/2-BPSK and
    ``demapper="reference"`` run eager.  The span counts the ``lanes``
    (B * ndata * nl) and the ``kernel_lanes`` K5 demapped."""
    with l1_tracer.span("pusch.demap") as span:
        b, ndata, nl = x_hat.shape
        qm = cfg.sch.qm
        c_init = _pusch_c_init(rnti, cfg.n_id)
        fused = cfg.demapper != "reference" and cfg.modulation in SQUARE_QAM
        if fused:  # kernel K5 on a CUDA tensor, its plain version on the CPU
            c = scrambling.gold_sequence(c_init, ndata * nl * qm)
            llr_i8, err2 = demap_llrs(x_hat.contiguous(), eq_nvar.contiguous(), c,
                                      cfg.modulation, cfg.llr_range_limit)
        else:
            if cfg.demapper == "reference":
                # RE-major layer interleave = the codeword order.
                llr_i8 = demap_llr_i8(x_hat.reshape(b, -1), eq_nvar.reshape(b, -1),
                                      cfg.modulation)
            else:  # BPSK, pi/2-BPSK
                llr_i8 = quantized_llrs(x_hat, eq_nvar, cfg.modulation, cfg.llr_range_limit)
            llr_i8 = scrambling.descramble_llrs(llr_i8, c_init)
            err2 = nearest_err2(x_hat.reshape(b, -1), cfg.modulation)
        lanes = b * ndata * nl
        span.count(lanes=lanes, kernel_lanes=lanes if fused and x_hat.is_cuda else 0)
        if cfg.ptrs_enabled:
            llr_i8 = llr_i8.index_fill(-1, _ptrs_bits_on(llr_i8.device, cfg), 0)
        e = torch.sqrt(err2.mean(dim=-1))
        return llr_i8, 1.0 / torch.clamp_min(e * e, 1e-12)


def _after_estimate(gflat: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                    extras: dict, rnti: torch.Tensor, cfg: PuschConfig):
    """Equalize (+ deprecode with transform precoding) + demap of estimated
    grids -> (llr_i8 (B, G), noise_var (B,), SINR (B,)[, ta_s (B,) with
    compute_ta])."""
    x_hat, eq_nvar = _equalize_stage(gflat, h, noise_var, cfg)
    if cfg.transform_precoding:
        x_hat, eq_nvar = _deprecode_stage(x_hat, eq_nvar, cfg)
    llr_i8, sinr = _demap_stage(x_hat, eq_nvar, rnti, cfg)
    return _with_metrics(llr_i8, noise_var, sinr, extras, cfg)


def _with_metrics(llrs: torch.Tensor, noise_var: torch.Tensor, sinr_post_eq: torch.Tensor,
                  extras: dict, cfg: PuschConfig):
    """(LLRs, noise_var, the SINR of cfg.sinr_method[, ta_s with
    compute_ta]), as the reference's front ends return them."""
    snr = sinr_post_eq if cfg.sinr_method == "post_equalization" else extras["snr"]
    if cfg.compute_ta:
        return llrs, noise_var, snr, extras["ta_s"]
    return llrs, noise_var, snr


def _front_end(grid: torch.Tensor, rnti: torch.Tensor, cfg: PuschConfig):
    """(B, P, nsym, nsc) grids and (B,) RNTIs -> (llr_i8 (B, G),
    noise_var (B,), SINR (B,)[, ta_s (B,) with compute_ta])."""
    return _after_estimate(*_estimate(grid, cfg), rnti, cfg)


def transmit(tb_bits: torch.Tensor, rnti: torch.Tensor, cfg: PuschConfig,
             ack_bits: torch.Tensor | None = None, csi1_bits: torch.Tensor | None = None,
             csi2_bits: torch.Tensor | None = None,
             precoding: torch.Tensor | None = None) -> torch.Tensor:
    """UE-side PUSCH transmitter for loopback: SCH encode + UCI multiplex +
    PUSCH scrambling + modulation + DM-RS.  (..., A) TB bits, (...,) RNTIs
    and the configured UCI payloads (..., O) -> (..., P, nsym, nsc) grids,
    P = precoding's columns (default: one port per layer, nof_layers x
    nof_rx_ports identity)."""
    from .sch import encode_transport_block

    cw = encode_transport_block(tb_bits, cfg.sch)
    mux = cfg.uci_mux
    if mux is None and not (ack_bits is None and csi1_bits is None and csi2_bits is None):
        raise ValueError("transmit: UCI payloads given, but the config carries no UCI")
    if mux is not None:
        cw = ulsch_demux.multiplex(cw, ack_bits, csi1_bits, mux, csi2_bits=csi2_bits)
    scr = scrambling.scramble_bits(cw, _pusch_c_init(rnti, cfg.n_id))
    if precoding is None:
        precoding = torch.eye(cfg.nof_layers, cfg.nof_rx_ports, dtype=torch.complex64)
    tx_cfg = pdsch_mod.PdschConfig(
        tbs=cfg.tbs, target_code_rate=cfg.target_code_rate, modulation=cfg.modulation,
        alloc=cfg.alloc, nof_layers=cfg.nof_layers, nof_ports=precoding.shape[-1],
        nof_grid_symbols=cfg.nof_grid_symbols, nof_grid_sc=cfg.nof_grid_sc,
        slot_in_frame=cfg.slot_in_frame, dmrs_scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid)
    return pdsch_mod._grid_chain(scr, precoding.to(device=cw.device, dtype=torch.complex64),
                                 tx_cfg)


# UCI part -> the result keys of its (bits, ok).
UCI_KEYS = (("ack", ("harq_ack_bits", "harq_ack_ok")), ("csi1", ("csi1_bits", "csi1_ok")),
            ("csi2", ("csi2_bits", "csi2_ok")))


def split_uci(llr_i8: torch.Tensor, cfg: PuschConfig):
    """UCI demultiplex + decode of (B, G) descrambled LLRs -> (the (B,
    nof_data_bits) SCH LLRs, dict of the UCI result keys; with two-step
    CSI also csi_rank and nof_csi2_bits).  Without UCI the LLRs pass
    through and the dict is empty."""
    mux = cfg.uci_mux
    if mux is None:
        return llr_i8, {}
    u = cfg.uci
    data, ack, csi1, csi2 = ulsch_demux.demultiplex(llr_i8, mux)
    out = {}
    if u.csi_report_cfg is not None and u.nof_csi1_bits:
        parts = ulsch_demux.decode_uci_parts(ack, None, u.nof_harq_ack_bits, 0)
        two = ulsch_demux.decode_csi_two_step(csi1, csi2, u.csi_report_cfg)
        parts.update(two)
        if "rank" in two:
            out["csi_rank"], out["nof_csi2_bits"] = two["rank"], two["nof_csi2_bits"]
    else:
        parts = ulsch_demux.decode_uci_parts(ack, csi1, u.nof_harq_ack_bits, u.nof_csi1_bits,
                                             csi2_llrs=csi2, nof_csi2_bits=u.nof_csi2_bits)
    for part, (bits_key, ok_key) in UCI_KEYS:
        if part in parts:
            out[bits_key], out[ok_key] = parts[part]
    return data, out


def finish(llr_i8: torch.Tensor, noise_var: torch.Tensor, snr_acc: torch.Tensor,
           cfg: PuschConfig, harq_buffer: torch.Tensor | None = None) -> dict:
    """Back half of ``process``: UCI demultiplex + decode, LDPC decode
    (with the HARQ combine when a buffer is given) + result dict, from
    (B, G) descrambled LLRs."""
    data, uci_out = split_uci(llr_i8, cfg)
    tb, ok, harq = decode_transport_block(data, cfg.sch, cfg.nof_ldpc_iterations,
                                          harq_buffer, early_stop=cfg.ldpc_early_stop)
    return {
        "tb_bits": tb,
        "tb_crc_ok": ok,
        "harq_buffer": harq,
        "noise_var": noise_var,
        "snr_db": 10.0 * torch.log10(torch.clamp_min(snr_acc, 1e-12)),
        **uci_out,
    }


def process(grid: torch.Tensor, rnti: torch.Tensor, cfg: PuschConfig,
            harq_buffer: torch.Tensor | None = None) -> dict:
    """Decode one PUSCH grant per slot: (B, P, nsym, nsc) grids, (B,) RNTIs
    and optional (B, C, N) HARQ buffers -> dict of tb_bits (B, A),
    tb_crc_ok (B,), harq_buffer (B, C, N), noise_var (B,), snr_db (B,),
    and with UCI harq_ack_bits / csi1_bits / csi2_bits (B, O) and their
    _ok flags (B,); with two-step CSI csi2_bits pads to the largest part-2
    size, and csi_rank (B,) and nof_csi2_bits (B,) say which it was; with
    compute_ta ta_s (B,) in seconds (bins of the pair channel's delay
    profile above half its length are negative)."""
    fe = _front_end(grid, rnti, cfg)
    out = finish(*fe[:3], cfg, harq_buffer=harq_buffer)
    if cfg.compute_ta:
        out["ta_s"] = fe[3]
    return out


def _multi_front_end(grid: torch.Tensor, rntis: torch.Tensor, first_scs, r_batch: torch.Tensor,
                     cfg: PuschConfig):
    """Front end of N equal-config grants of one (P, nsym, nsc_total) slot
    grid: each grant's window of cfg.nof_grid_sc subcarriers from its first
    subcarrier, stacked into one batch -> (llr_i8 (N, G), noise_var (N,),
    SINR (N,)[, ta_s (N,) with compute_ta]), each grant with its own
    estimate, CFO and TA."""
    w = cfg.nof_grid_sc
    win = torch.stack([grid[:, :, sc0 : sc0 + w] for sc0 in first_scs])
    return _after_estimate(*_estimate(win, cfg, r_override=r_batch), rntis, cfg)


@functools.lru_cache(maxsize=None)
def _multi_pilot_bank(cfg: PuschConfig, first_rbs: tuple) -> np.ndarray:
    """Per-grant DM-RS pilot values for a batch of PRB offsets (N, nl,
    nsym_d, Np): the only per-UE constant of the shared compact config (the
    Gold sequence index follows the absolute CRB)."""
    rs = []
    for rb0 in first_rbs:
        cfg_i = dataclasses.replace(cfg, alloc=dataclasses.replace(cfg.alloc, crb_start=int(rb0)))
        rs.append(_estimate_constants(cfg_i)[2])
    return np.stack(rs)


_pilot_bank_on = device_table(_multi_pilot_bank)


def process_multi(grid: torch.Tensor, rntis, first_rbs, cfg: PuschConfig,
                  harq_buffers: torch.Tensor | None = None) -> dict:
    """Decode N equal-config grants of one slot grid in one batch: grid
    (P, nsym, nsc_total), rntis (N,), first_rbs a length-N sequence of PRB
    offsets of compact (rb_start = 0) windows sharing ``cfg``, optional
    (N, C, N_cb) HARQ buffers.  Returns the dict of ``process`` stacked
    over the grants."""
    if cfg.uci is not None and cfg.uci.csi_report_cfg is not None:
        raise ValueError("process_multi: two-step CSI PDUs take the per-PDU path "
                         "(part-2 size follows the decoded RI)")
    first_rbs = tuple(int(r) for r in first_rbs)
    dev = grid.device
    rntis = torch.as_tensor(rntis, dtype=torch.int64, device=dev)
    fe = _multi_front_end(grid, rntis, [12 * r for r in first_rbs],
                          _pilot_bank_on(dev, cfg, first_rbs), cfg)
    out = finish(*fe[:3], cfg, harq_buffer=harq_buffers)
    if cfg.compute_ta:
        out["ta_s"] = fe[3]
    return out


def _demap_planes_ok(cfg: PuschConfig) -> bool:
    """Gate of the plane path (kernel K4 + K1 in plane layout): opted in
    with ``demapper="planes"``, the fast estimator and the MMSE or ZF
    equalizer (closed to the reference modes, as in the reference), no
    repetition, no UCI, no PT-RS, no CFO compensation, no transform
    precoding, square 16/64/256QAM and full-row data symbols.
    Unlike the reference, the gate does not ask which device runs it: the
    device follows the input tensor."""
    return (cfg.demapper == "planes"
            and cfg.estimator == "fast"
            and cfg.equalizer in ("mmse", "zf")
            and not cfg.transform_precoding
            and not cfg.ptrs_enabled
            and not cfg.cfo_compensation
            and cfg.uci_mux is None
            and _fused_decode_ok(cfg.sch)
            and cfg.modulation in (Modulation.QAM16, Modulation.QAM64, Modulation.QAM256)
            and pdsch_mod.uniform_data_rows(cfg.alloc))


def _plane_inputs(grid: torch.Tensor, rnti: torch.Tensor, cfg: PuschConfig):
    """(B, P, nsym, nsc) grids and (B,) RNTIs -> ((data rows y, MMSE
    weights, eq_nvar, the (B, G) uint8 Gold sequence in stream order): the
    inputs of ``demap_planes``, noise_var (B,)), with the estimate and the
    weights as in ``_front_end``."""
    gflat, h, noise_var = _estimate_stage(grid, cfg)
    return _plane_inputs_of(gflat, h, noise_var, rnti, cfg), noise_var


def _plane_inputs_of(gflat: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                     rnti: torch.Tensor, cfg: PuschConfig) -> tuple:
    """The inputs of ``demap_planes`` from an estimate."""
    y = _data_rows(gflat, cfg).contiguous()
    w, eq_sc = _weights(h, noise_var, cfg)
    c = scrambling.gold_sequence(_pusch_c_init(rnti, cfg.n_id), cfg.g_total)
    return y, w, eq_sc, c


def _front_end_planes(grid: torch.Tensor, rnti: torch.Tensor, cfg: PuschConfig):
    """(B, P, nsym, nsc) grids and (B,) RNTIs -> (descrambled int8 LLR
    bit-planes (B, qm, G/qm), noise_var (B,), SINR (B,)[, ta_s (B,) with
    compute_ta]): the inputs of ``_plane_inputs``, then kernel K4 applies
    the weights, demaps, quantizes and descrambles straight into the
    planes ``sch.decode_from_planes`` reads."""
    gflat, h, noise_var, extras = _estimate(grid, cfg)
    with l1_tracer.span("pusch.equalize"):
        inputs = _plane_inputs_of(gflat, h, noise_var, rnti, cfg)
    with l1_tracer.span("pusch.demap"):
        planes, err2 = demap_planes(*inputs, cfg.modulation, cfg.llr_range_limit)
    snr = 1.0 / torch.clamp_min(err2.mean(dim=(1, 2)), 1e-12)
    return _with_metrics(planes, noise_var, snr, extras, cfg)
