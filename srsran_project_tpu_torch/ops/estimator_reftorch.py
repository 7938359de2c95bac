"""Reference-parity port channel estimator in torch.

Port of ``srsran_project_tpu/ops/estimator_refjax.py`` (the estimator
``PuschConfig.estimator="reference"`` runs): the semantics of the numpy
oracle ``ops/estimator_ref.py``, itself a copy of the reference's
port_channel_estimator_average_impl.cpp, as tensor code:

  LS pilot match -> CFO estimate/compensation -> time-domain average (or
  per-DMRS-symbol LSE) -> CDM pair averaging -> raised-cosine smoothing
  with virtual edge pilots -> linear frequency interpolation -> noise
  variance / EPRE / RSRP / SNR -> TA via zero-padded IDFT peak with
  fractional refinement.

Every static quantity (pilot geometry, filter taps, interpolation maps,
DFT size) is planned on the host by ``_constants`` from the oracle's own
helpers; ``estimate_port_ref`` is float32 tensor math on the device of
its input.  It takes any leading dimensions (the receive ports, the
grants of a slot), in place of the reference's ``jax.vmap``.  The
smoothing is a sum over the filter's taps (no convolution library call,
so no TF32 path can touch it).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import estimator_ref as _oracle
from ._tables import device_table

NRE = 12
MAX_SINR_DB = 100.0
_MU = {15: 0, 30: 1, 60: 2, 120: 3}  # numerology of a subcarrier spacing in kHz


@dataclasses.dataclass(frozen=True)
class RefEstimatorConfig:
    """Twin of the reference's ``RefEstimatorConfig`` (same fields and
    defaults).  re_pattern2 is the RE pattern of CDM group 1 (layers 2-3);
    None = one group."""

    scs_khz: int
    nof_prb: int
    first_symbol: int
    nof_symbols: int
    dmrs_symbol_mask: int
    re_pattern: tuple
    nof_layers: int = 1
    re_pattern2: tuple | None = None
    scaling: float = 1.0
    smoothing: str = "filter"    # filter | mean | none
    td_strategy: str = "average"  # average | interpolate
    compensate_cfo: bool = True


@functools.lru_cache(maxsize=None)
def _constants(cfg: RefEstimatorConfig) -> dict:
    """Host plan of every static quantity (the oracle's scalar code paths
    run once, symbolically): DM-RS symbols, per-group pilot REs, symbol
    epochs, filter taps and virtual-pilot count, per-layer linear
    interpolation maps (i0, i1, w), and the TA correlator's geometry."""
    mu = _MU[cfg.scs_khz]
    dmrs_syms = tuple(s for s in range(14) if (cfg.dmrs_symbol_mask >> s) & 1)
    nof_cdm = (cfg.nof_layers + 1) // 2
    pats = [cfg.re_pattern if g == 0 else (cfg.re_pattern2 or cfg.re_pattern)
            for g in range(max(nof_cdm, 1))]
    re_idx_g = np.stack([np.concatenate(
        [rb * NRE + np.asarray(p) for rb in range(cfg.nof_prb)]
    ).astype(np.int64) for p in pats])  # (ncdm, Np)
    re_idx = re_idx_g[0]
    nof_pilots = len(re_idx)
    stride = (int(cfg.re_pattern[1]) - int(cfg.re_pattern[0])) if len(cfg.re_pattern) > 1 else 1
    epochs = _oracle._symbol_start_epochs(14, mu)

    taps = _oracle._rc_filter(cfg.nof_prb, stride)
    nof_v = min(_oracle.MAX_V_PILOTS, len(taps) // 2)
    if cfg.nof_prb == 1:
        nof_v = nof_pilots // cfg.nof_prb

    nof_subc = cfg.nof_prb * NRE

    def _interp_map(off):
        i0 = np.zeros(nof_subc, np.int64)
        i1 = np.zeros(nof_subc, np.int64)
        w = np.zeros(nof_subc, np.float32)
        i_out, i_in = off, 0
        while i_out + stride < nof_subc and i_in + 1 < nof_pilots:
            for k in range(1, stride + 1):
                i0[i_out + k] = i_in
                i1[i_out + k] = i_in + 1
                w[i_out + k] = k / stride
            i_out += stride
            i_in += 1
        last = min(i_in, nof_pilots - 1)
        i0[i_out + 1 :] = last
        i1[i_out + 1 :] = last
        w[i_out + 1 :] = 0.0
        return i0, i1, w

    maps_g = [_interp_map(int(p[0])) for p in pats]
    nlay = max(cfg.nof_layers, 1)
    interp = tuple(np.stack([maps_g[min(l // 2, len(maps_g) - 1)][j] for l in range(nlay)])
                   for j in range(3))

    pat = tuple(cfg.re_pattern)
    if pat == _oracle._RE_PATTERN_FULL:
        ta_stride, ta_mask = 1, None
    elif pat in (_oracle._RE_PATTERN_PUSCH0, _oracle._RE_PATTERN_PUSCH1):
        ta_stride, ta_mask = 2, None
    elif pat == _oracle._RE_PATTERN_PUCCH_F2:
        ta_stride, ta_mask = 3, None
    else:
        ta_stride, ta_mask = 1, re_idx
    if ta_mask is not None:
        lo, hi = int(ta_mask.min()), int(ta_mask.max())
        nof_required = hi - lo + 1
        ta_positions = (ta_mask - lo).astype(np.int64)
    else:
        nof_required = nof_pilots
        ta_positions = np.arange(nof_pilots, dtype=np.int64)
    n = (nof_required * _oracle._MAX_DFT) // _oracle._MAX_NOF_RE
    dft_size = max(_oracle._MIN_DFT, 1 << max(0, int(np.ceil(np.log2(max(n, 1))))))
    fs = dft_size * cfg.scs_khz * 1000.0 * ta_stride
    kappa_s = 1.0 / (480000.0 * 4096.0)
    half_cp = 144.0 * 64.0 * kappa_s / (2 ** (mu + 1))
    max_ta_samples = int(np.floor(half_cp * fs))

    return dict(
        dmrs_syms=dmrs_syms, re_idx=re_idx, re_idx_g=re_idx_g, epochs=epochs.astype(np.float64),
        taps=taps.astype(np.float32), nof_v=nof_v, interp=interp, dft_size=dft_size, fs=fs,
        max_ta_samples=max_ta_samples, ta_positions=ta_positions, nof_subc=nof_subc)


def symbol_epochs(nof_symbols: int, scs_khz: int) -> np.ndarray:
    """(nof_symbols,) float32 start epochs of a slot's symbols, CP
    included, in units of the useful symbol time (the CFO's time base)."""
    return _oracle._symbol_start_epochs(nof_symbols, _MU[scs_khz]).astype(np.float32)


def _table(cfg: RefEstimatorConfig, name: str) -> np.ndarray:
    """A host table of the plan by name; "dmrs_epochs" is the float32
    epochs of the DM-RS symbols, "epochs" of all 14."""
    c = _constants(cfg)
    if name == "dmrs_epochs":
        return c["epochs"][list(c["dmrs_syms"])].astype(np.float32)
    if name == "epochs":
        return symbol_epochs(14, cfg.scs_khz)
    if name in ("i0", "i1", "w"):
        return c["interp"][("i0", "i1", "w").index(name)]
    if name == "avg_layers":
        # CDM pair averaging: every layer with several DM-RS symbols, only
        # the layers of full pairs with one.
        nl = cfg.nof_layers
        return np.asarray([len(c["dmrs_syms"]) > 1 or (l // 2) * 2 + 1 < nl
                           for l in range(nl)])
    return c[name]


_table_on = device_table(_table)


def _unwrap(p: torch.Tensor) -> torch.Tensor:
    """numpy/JAX ``unwrap`` along the last axis (discont pi, period 2 pi)."""
    dd = p[..., 1:] - p[..., :-1]
    ddmod = torch.remainder(dd + np.pi, 2 * np.pi) - np.pi
    ddmod = torch.where((ddmod == -np.pi) & (dd > 0), torch.full_like(ddmod, np.pi), ddmod)
    corr = torch.where(dd.abs() < np.pi, torch.zeros_like(dd), ddmod - dd)
    return torch.cat([p[..., :1], p[..., 1:] + torch.cumsum(corr, dim=-1)], dim=-1)


def _v_pilots(p_abs: torch.Tensor, p_arg: torch.Tensor, is_start: bool) -> torch.Tensor:
    """Virtual-pilot extrapolation (helpers.cpp:310) on (..., n) moduli and
    unwrapped phases: least-squares lines through both, evaluated n
    positions before (or after) the run."""
    n = p_abs.shape[-1]
    xs = torch.arange(n, dtype=torch.float32, device=p_abs.device)
    mean_x = (n * (n - 1)) / 2.0 / n
    norm_x_sq = (n - 1) * n * (2 * n - 1) / 6.0
    denom = norm_x_sq - n * mean_x * mean_x

    def fit(v):
        mean_v = v.mean(dim=-1, keepdim=True)
        slope = ((v * xs).sum(dim=-1, keepdim=True) - mean_x * mean_v * n) / denom
        return slope, mean_v - slope * mean_x

    s_abs, i_abs = fit(p_abs)
    s_arg, i_arg = fit(p_arg)
    iv = xs + (-n if is_start else n)
    rho = s_abs * iv + i_abs
    phase = s_arg * iv + i_arg + torch.where(rho > 0, 0.0, np.pi)
    return torch.polar(rho.abs(), phase)


def _fd_smooth(p: torch.Tensor, cfg: RefEstimatorConfig) -> torch.Tensor:
    """Frequency smoothing of (..., Np) pilot estimates: the mean, none, or
    the resampled RC filter over the run extended by virtual pilots at
    both edges ("same" convolution; the taps are symmetric)."""
    if cfg.smoothing == "mean":
        return p.mean(dim=-1, keepdim=True).expand(p.shape)
    if cfg.smoothing == "none":
        return p
    c = _constants(cfg)
    nof_v = c["nof_v"]
    taps = _table_on(p.device, cfg, "taps")
    head = _v_pilots(p[..., :nof_v].abs(), _unwrap(torch.angle(p[..., :nof_v])), True)
    tail = _v_pilots(p[..., -nof_v:].abs(), _unwrap(torch.angle(p[..., -nof_v:])), False)
    enlarged = torch.cat([head, p, tail], dim=-1)
    m = taps.shape[0]
    # "same": output n sits on input n, the filter centred on it.
    pad = torch.nn.functional.pad(torch.view_as_real(enlarged).movedim(-1, -2),
                                  (m // 2, m // 2))
    win = pad.unfold(-1, m, 1)  # (..., 2, n, m)
    out = (win * taps).sum(dim=-1).movedim(-2, -1).contiguous()
    out = torch.view_as_complex(out)
    return out[..., nof_v : nof_v + p.shape[-1]]


def _ta_seconds(filtered: torch.Tensor, cfg: RefEstimatorConfig) -> torch.Tensor:
    """TA of (..., rows, Np) filtered pilots: the peak of the summed
    |IDFT|^2 of the zero-padded rows within +-half a CP, refined by the
    3- or 5-tap fractional estimate (not at the full 4096 grid)."""
    c = _constants(cfg)
    dev = filtered.device
    dft = c["dft_size"]
    buf = torch.zeros(filtered.shape[:-1] + (dft,), dtype=torch.complex64, device=dev)
    buf[..., _table_on(dev, cfg, "ta_positions")] = filtered
    t = torch.fft.ifft(buf, dim=-1) * dft
    corr = (t.real ** 2 + t.imag ** 2).sum(dim=-2)  # (..., dft)
    mts = c["max_ta_samples"]
    # argmax takes the first of equal maxima, as jnp's does.
    delay_idx = torch.argmax(corr[..., :mts], dim=-1)
    adv_idx = torch.argmax(corr[..., dft - mts :], dim=-1)
    delay_max = torch.gather(corr, -1, delay_idx[..., None])[..., 0]
    adv_max = torch.gather(corr, -1, (dft - mts + adv_idx)[..., None])[..., 0]
    idx = torch.where(delay_max >= adv_max, delay_idx, -(mts - adv_idx))
    frac = torch.zeros(idx.shape, dtype=torch.float32, device=dev)
    if dft != _oracle._MAX_DFT:
        nof_taps = 5 if mts > 2 else 3
        offs = torch.arange(nof_taps, device=dev) - nof_taps // 2
        peak = torch.gather(corr, -1, (idx[..., None] + offs + dft) % dft)
        if nof_taps == 5:
            num_w = (-0.4, -0.2, 0.0, 0.2, 0.4)
            den_w = (0.571429, -0.285714, -0.571429, -0.285714, 0.571429)
            corr_f = 1.0
        else:
            num_w, den_w, corr_f = (-0.5, 0.0, 0.5), (0.5, -1.0, 0.5), 0.5
        num = (peak * torch.tensor(num_w, dtype=torch.float32, device=dev)).sum(dim=-1)
        den = (peak * torch.tensor(den_w, dtype=torch.float32, device=dev)).sum(dim=-1)
        res = torch.where(den != 0, -corr_f * num / torch.where(den != 0, den, 1.0),
                          torch.full_like(num, float("nan")))
        frac = torch.where(torch.isfinite(res) & (res.abs() <= 1.0), res, 0.0)
    return (idx.to(torch.float32) + frac) / np.float32(c["fs"])


def _cis(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def estimate_port_ref(grid: torch.Tensor, pilots: torch.Tensor, cfg: RefEstimatorConfig,
                      ce: bool = True) -> dict:
    """Reference-semantics estimate of receive ports.

    grid: (..., 14, nof_subc) complex64, each row of the leading
    dimensions one receive port; pilots: (..., layers, nof_dmrs_symbols,
    nof_pilots) complex64 (per layer, OCC included: the oracle's input),
    broadcast against the grid's leading dimensions.  Returns a dict of
    freq_resp (..., layers, nof_lse_symbols, nof_subc), noise_var, rsrp,
    epre, snr, ta_s, cfo (each (...)), and with ``ce`` the per-symbol
    estimates ce (..., layers, 14, nof_subc)."""
    c = _constants(cfg)
    dev = grid.device
    dmrs_syms = c["dmrs_syms"]
    nsym_d = len(dmrs_syms)
    layers = cfg.nof_layers
    nof_cdm = (layers + 1) // 2
    beta = float(np.float32(cfg.scaling))
    interpolate_td = cfg.td_strategy == "interpolate"
    nof_lse = nsym_d if interpolate_td else 1
    lead = grid.shape[:-2]

    # rx pilots per CDM group, each on its own REs: (..., ncdm, nsym_d, Np).
    g_d = grid[..., list(dmrs_syms), :]  # (..., nsym_d, nsubc)
    rx = g_d[..., _table_on(dev, cfg, "re_idx_g")].transpose(-3, -2)
    epre_sum = (rx.real ** 2 + rx.imag ** 2).sum(dim=(-3, -2, -1))

    # LS match per layer.
    pilots = pilots.to(torch.complex64)
    cdm_of = [l // 2 for l in range(layers)]
    p_sym = rx[..., cdm_of, :, :] * pilots.conj()  # (..., layers, nsym_d, Np)

    cfo = None
    if nsym_d >= 2:
        # Per-CDM-group angle of sum p1 conj(p0), the group CFOs averaged.
        prod_l = (p_sym[..., 1, :] * p_sym[..., 0, :].conj()).sum(dim=-1)  # (..., layers)
        denom = c["epochs"][dmrs_syms[1]] - c["epochs"][dmrs_syms[0]]
        cfo_sum = torch.zeros(prod_l.shape[:-1], dtype=torch.float32, device=dev)
        for g0 in range(0, layers, 2):
            acc_g = prod_l[..., g0 : min(g0 + 2, layers)].sum(dim=-1)
            cfo_sum = cfo_sum + torch.angle(acc_g) / (2 * np.pi) / denom
        cfo = cfo_sum / nof_cdm

    ep_d = _table_on(dev, cfg, "dmrs_epochs")  # (nsym_d,) float32
    if cfo is not None and cfg.compensate_cfo:
        rot = _cis(-2 * np.pi * ep_d * cfo[..., None])  # (..., nsym_d)
        p_sym = p_sym * rot[..., None, :, None]

    p_lse = p_sym if interpolate_td else p_sym.sum(dim=-2, keepdim=True)

    if layers > 1:
        # CDM pair averaging (orthogonal cover cancellation) on the layers
        # the plan selects.
        npairs = p_lse.shape[-1] // 2
        pairs = p_lse[..., : 2 * npairs].reshape(p_lse.shape[:-1] + (npairs, 2))
        avg = (pairs[..., 0] + pairs[..., 1]) / 2.0
        new = torch.stack([avg, avg], dim=-1).reshape(pairs.shape[:-2] + (2 * npairs,))
        sel = _table_on(dev, cfg, "avg_layers")[:, None, None]
        p_lse = torch.cat([torch.where(sel, new, p_lse[..., : 2 * npairs]),
                           p_lse[..., 2 * npairs :]], dim=-1)

    total_scaling = float(np.float32(1.0) / np.float32(beta)
                          / np.float32(nsym_d if not interpolate_td else 1))
    filtered = _fd_smooth(p_lse * total_scaling, cfg)  # (..., layers, nof_lse, Np)
    rsrp_sum = ((filtered.real ** 2 + filtered.imag ** 2).sum(dim=(-3, -2, -1))
                * beta * beta * nsym_d / nof_lse)

    # Linear frequency interpolation through the per-layer maps.
    shape = lead + (layers, nof_lse, c["nof_subc"])
    f0 = torch.gather(filtered, -1, _table_on(dev, cfg, "i0")[:, None, :].expand(shape))
    f1 = torch.gather(filtered, -1, _table_on(dev, cfg, "i1")[:, None, :].expand(shape))
    w = _table_on(dev, cfg, "w")[:, None, :]
    freq_resp = f0 * (1.0 - w) + f1 * w  # (..., layers, nof_lse, nof_subc)

    out = {}
    if ce:
        sym_range = range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols)
        ce_t = torch.zeros(lead + (layers, 14, c["nof_subc"]), dtype=torch.complex64,
                           device=dev)
        if not interpolate_td or nof_lse == 1:
            for sym in sym_range:
                ce_t[..., sym, :] = freq_resp[..., 0, :]
        else:
            ds = list(dmrs_syms)
            for sym in sym_range:
                before = [s for s in ds if s < sym]
                after = [s for s in ds if s >= sym]
                if not before:
                    s0, s1 = ds[0], ds[1]
                elif not after:
                    s0, s1 = ds[-2], ds[-1]
                else:
                    s0, s1 = before[-1], after[0]
                wts = (sym - s0) / (s1 - s0)
                k0 = ds.index(s0)
                ce_t[..., sym, :] = (freq_resp[..., k0, :]
                                     + (freq_resp[..., k0 + 1, :] - freq_resp[..., k0, :]) * wts)
        if cfg.compensate_cfo and cfo is not None:
            rot = _cis(2 * np.pi * _table_on(dev, cfg, "epochs") * cfo[..., None])
            ce_t = ce_t * rot[..., None, :, None]
        out["ce"] = ce_t

    # Noise: residual against the regenerated pilots, per CDM group.
    scaled = filtered.sum(dim=-2) * (beta / nof_lse)  # (..., layers, Np)
    pred = scaled[..., None, :] * pilots  # (..., layers, nsym_d, Np)
    if cfg.compensate_cfo and cfo is not None:
        pred = pred * _cis(2 * np.pi * ep_d * cfo[..., None])[..., None, :, None]
    noise_sum = torch.zeros(lead, dtype=torch.float32, device=dev)
    for g0 in range(0, layers, 2):
        resid = rx[..., g0 // 2, :, :] - pred[..., g0 : min(g0 + 2, layers), :, :].sum(dim=-3)
        energy = (resid.real ** 2 + resid.imag ** 2).sum(dim=(-2, -1))
        noise_sum = noise_sum + torch.where(torch.isfinite(energy) & (energy > 0), energy, 0.0)

    ta_s = _ta_seconds(filtered.reshape(lead + (layers * nof_lse, -1)), cfg)

    nof_dmrs_pilots = len(c["re_idx"]) * nsym_d
    rsrp = rsrp_sum / (nof_dmrs_pilots * layers)
    epre = epre_sum / nof_dmrs_pilots
    noise_var = noise_sum / (nof_dmrs_pilots * nof_cdm - 1)
    noise_var = torch.maximum(noise_var, rsrp / np.float32(10 ** (MAX_SINR_DB / 10)))
    datarp = rsrp * layers / (beta * beta)
    snr = torch.where(torch.isfinite(noise_var) & (noise_var > 0), datarp / noise_var, 0.0)
    out.update(freq_resp=freq_resp, noise_var=noise_var, rsrp=rsrp, epre=epre, snr=snr,
               ta_s=ta_s,
               cfo=cfo if cfo is not None else torch.zeros(lead, dtype=torch.float32,
                                                            device=dev))
    return out
