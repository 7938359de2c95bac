"""Reference-parity port channel estimator (conformance oracle), in numpy.

JAX-free copy of ``srsran_project_tpu/ops/estimator_ref.py``, value for
value: a faithful numpy re-implementation of the reference's
port_channel_estimator_average_impl
(lib/phy/upper/signal_processors/channel_estimator/
port_channel_estimator_average_impl.cpp + _helpers.cpp + the DFT-based
time-alignment estimator, time_alignment_estimator_dft_impl.cpp):

  LS pilot match -> CFO estimate (2+ DM-RS symbols) & compensation ->
  time-domain average (or per-symbol LSE) -> frequency-domain smoothing
  (raised-cosine filter with virtual edge pilots / mean / none) ->
  linear frequency interpolation -> per-symbol mapping (copy / linear
  time interpolation) -> noise variance from regenerated-pilot residuals
  -> TA via zero-padded IDFT correlation peak with fractional refinement.

This host-side oracle is the host plan of the torch estimator
(``ops/estimator_reftorch.py``: symbol epochs, filter taps, virtual
pilot count, DFT geometry) and the surface it is held against;
tolerances per the reference's own vector suite (CE per-RE float
compare, TA within one sample at the 4096 grid).
"""

from __future__ import annotations

import dataclasses

import numpy as np

NRE = 12
MAX_V_PILOTS = 12
MAX_SINR_DB = 100.0
# 31-tap raised-cosine prototype (roll-off 0.2, 3-symbol span, 10x oversampled),
# port_channel_estimator_helpers.cpp:51.
RC_FILTER = np.array([
    -0.0641253, -0.0660711, -0.0611526, -0.0485918, -0.0281126, 0.0000000, 0.0348830,
    0.0751249, 0.1188406, 0.1637874, 0.2075139, 0.2475302, 0.2814857, 0.3073415,
    0.3235207, 0.3290274, 0.3235207, 0.3073415, 0.2814857, 0.2475302, 0.2075139,
    0.1637874, 0.1188406, 0.0751249, 0.0348830, 0.0000000, -0.0281126, -0.0485918,
    -0.0611526, -0.0660711, -0.0641253,
], dtype=np.float64)


@dataclasses.dataclass(frozen=True)
class EstimatorConfig:
    scs_khz: int
    nof_prb: int
    first_symbol: int
    nof_symbols: int
    dmrs_symbol_mask: int  # bitmask over the slot
    re_pattern: tuple  # RE indices within an RB carrying DM-RS (CDM group 0)
    nof_layers: int = 1
    # RE pattern of CDM group 1 (layers 2-3).  None = all layers share
    # re_pattern (the pre-round-4 single-group behavior).  The reference
    # processes layers pairwise with per-pair patterns
    # (port_channel_estimator_average_impl.cpp:256).
    re_pattern2: tuple | None = None
    scaling: float = 1.0
    smoothing: str = "filter"  # filter | mean | none
    td_strategy: str = "average"  # average | interpolate
    compensate_cfo: bool = True


@dataclasses.dataclass
class EstimateResult:
    ce: np.ndarray  # (layers, nof_symbols, nof_prb*NRE) complex64
    noise_var: float
    rsrp: float
    epre: float
    snr: float
    time_alignment_s: float
    cfo_hz: float | None


def _cp_fractions(nof_symbols: int = 14, mu: int = 1) -> np.ndarray:
    """CP length of each slot symbol as a fraction of the useful symbol time."""
    # Normal CP: 144/2048 per symbol, +16*64*kappa extra on subframe-half
    # boundaries (subframe symbols 0 and 7*2^mu).
    fr = np.full(nof_symbols, 144.0 / 2048.0)
    extra = 16.0 / 2048.0 * (2 ** mu)
    for l in range(nof_symbols):
        if l % (7 << mu) == 0:
            fr[l] += extra
    return fr


def _symbol_start_epochs(nof_symbols: int = 14, mu: int = 1) -> np.ndarray:
    """Cumulative (CP + symbol) start times in units of the symbol time
    (port_channel_estimator_average_impl.cpp initialize_symbol_start_epochs)."""
    fr = _cp_fractions(nof_symbols, mu)
    epochs = np.zeros(nof_symbols)
    epochs[0] = fr[0]
    for i in range(1, nof_symbols):
        epochs[i] = epochs[i - 1] + fr[i] + 1.0
    return epochs


def _rc_filter(nof_rb: int, stride: int):
    """filter_type ctor (helpers.cpp:84): resampled + renormalized RC taps."""
    nof_rbs = min(nof_rb, 3)
    nof_coefs = nof_rbs * 10 + 1
    nof_out_half = nof_coefs // 2 // stride
    n_first = len(RC_FILTER) // 2 - nof_out_half * stride
    nof_out = 2 * nof_out_half + 1
    taps = RC_FILTER[n_first : n_first + nof_out * stride : stride].copy()
    taps /= taps.sum()
    return taps


def _unwrap_args(x: np.ndarray) -> np.ndarray:
    return np.unwrap(np.angle(x))


def _compute_v_pilots(in_abs, in_arg, is_start: bool) -> np.ndarray:
    """Linear extrapolation of modulus and phase (helpers.cpp:310)."""
    n = len(in_abs)
    xs = np.arange(n, dtype=np.float64)
    mean_x = (n * (n - 1)) / 2.0 / n
    norm_x_sq = (n - 1) * n * (2 * n - 1) / 6.0
    denom = norm_x_sq - n * mean_x * mean_x

    mean_abs = np.mean(in_abs)
    slope_abs = (np.dot(in_abs, xs) - mean_x * mean_abs * n) / denom
    icpt_abs = mean_abs - slope_abs * mean_x
    mean_arg = np.mean(in_arg)
    slope_arg = (np.dot(in_arg, xs) - mean_x * mean_arg * n) / denom
    icpt_arg = mean_arg - slope_arg * mean_x

    v_offset = -n if is_start else n
    out = np.empty(n, np.complex128)
    for i in range(n):
        iv = i + v_offset
        rho = slope_abs * iv + icpt_abs
        phase = slope_arg * iv + icpt_arg + (0.0 if rho > 0 else np.pi)
        out[i] = np.abs(rho) * np.exp(1j * phase)
    return out


def _fd_smooth(p: np.ndarray, nof_rb: int, stride: int, strategy: str) -> np.ndarray:
    if strategy == "mean":
        return np.full_like(p, p.mean())
    if strategy == "none":
        return p.copy()
    taps = _rc_filter(nof_rb, stride)
    nof_v = min(MAX_V_PILOTS, len(taps) // 2)
    if nof_rb == 1:
        nof_v = len(p) // nof_rb
    head = _compute_v_pilots(np.abs(p[:nof_v]), _unwrap_args(p[:nof_v]), True)
    tail = _compute_v_pilots(np.abs(p[-nof_v:]), _unwrap_args(p[-nof_v:]), False)
    enlarged = np.concatenate([head, p, tail])
    filtered = np.convolve(enlarged, taps, mode="same")
    return filtered[nof_v : nof_v + len(p)]


def _interp_linear(pilots: np.ndarray, nof_re: int, offset: int, stride: int) -> np.ndarray:
    """interpolator_linear_impl semantics: fill head with first pilot,
    linear between, repeat last at the tail."""
    out = np.empty(nof_re, np.complex128)
    out[: offset + 1] = pilots[0]
    i_out, i_in = offset, 0
    while i_out + stride < nof_re and i_in + 1 < len(pilots):
        jump = (pilots[i_in + 1] - pilots[i_in]) / stride
        for k in range(1, stride + 1):
            out[i_out + k] = pilots[i_in] + jump * k
        i_out += stride
        i_in += 1
    out[i_out + 1 :] = pilots[min(i_in, len(pilots) - 1)]
    return out


def _fractional_sample_delay(peak: np.ndarray) -> float:
    if len(peak) == 5:
        num_w = np.array([-0.4, -0.2, 0.0, 0.2, 0.4])
        den_w = np.array([0.571429, -0.285714, -0.571429, -0.285714, 0.571429])
        corr = 1.0
    elif len(peak) == 3:
        num_w = np.array([-0.5, 0.0, 0.5])
        den_w = np.array([0.5, -1.0, 0.5])
        corr = 0.5
    else:
        return 0.0
    num = float(np.dot(num_w, peak))
    den = float(np.dot(den_w, peak))
    res = -corr * num / den if den != 0 else np.nan
    if not np.isfinite(res) or abs(res) > 1.0:
        return 0.0
    return res


_MAX_NOF_RE = 275 * NRE  # MAX_NOF_PRBS * NRE
_MAX_DFT = 4096
_MIN_DFT = 128


def _ta_estimate(pilots_list, stride: int, scs_khz: int, mask=None) -> float:
    """time_alignment_estimator_dft_impl: zero-padded IDFT correlation.

    pilots_list: list of 1-D arrays (slices, accumulated incoherently).
    With a mask, pilots go at their mask positions (stride 1); otherwise
    the pilots are packed from bin 0 and `stride` scales the sampling rate.
    """
    if mask is not None:
        lo, hi = int(np.min(mask)), int(np.max(mask))
        nof_required = hi - lo + 1
    else:
        nof_required = len(pilots_list[0])
    n = (nof_required * _MAX_DFT) // _MAX_NOF_RE
    dft_size = max(_MIN_DFT, 1 << max(0, int(np.ceil(np.log2(max(n, 1))))))
    corr = np.zeros(dft_size)
    for p in pilots_list:
        buf = np.zeros(dft_size, np.complex128)
        if mask is not None:
            buf[np.asarray(mask) - lo] = p
        else:
            buf[: len(p)] = p
        t = np.fft.ifft(buf) * dft_size  # unnormalized INVERSE DFT
        corr += np.abs(t) ** 2

    fs = dft_size * scs_khz * 1000.0 * stride
    kappa_s = 1.0 / (480000.0 * 4096.0)
    mu = {15: 0, 30: 1, 60: 2, 120: 3}[scs_khz]
    half_cp = 144.0 * 64.0 * kappa_s / (2 ** (mu + 1))
    max_ta_samples = int(np.floor(half_cp * fs))

    delay_idx = int(np.argmax(corr[:max_ta_samples]))
    delay_max = corr[delay_idx]
    adv = corr[-max_ta_samples:]
    adv_idx = int(np.argmax(adv))
    adv_max = adv[adv_idx]
    idx = delay_idx if delay_max >= adv_max else -(max_ta_samples - adv_idx)

    frac = 0.0
    if dft_size != _MAX_DFT:
        nof_taps = 5 if max_ta_samples > 2 else 3
        peak = np.array(
            [corr[(idx + i + dft_size - nof_taps // 2) % dft_size] for i in range(nof_taps)]
        )
        frac = _fractional_sample_delay(peak)
    return (idx + frac) / fs


_RE_PATTERN_PUSCH0 = tuple(range(0, 12, 2))
_RE_PATTERN_PUSCH1 = tuple(range(1, 12, 2))
_RE_PATTERN_PUCCH_F2 = (1, 4, 7, 10)
_RE_PATTERN_FULL = tuple(range(12))


def estimate_port(
    grid: np.ndarray,  # (nof_symbols_slot, nof_subc) complex — one rx port
    pilots: np.ndarray,  # (layers, nof_dmrs_symbols, nof_pilots) complex
    cfg: EstimatorConfig,
) -> EstimateResult:
    mu = {15: 0, 30: 1, 60: 2}[cfg.scs_khz]
    nof_subc = cfg.nof_prb * NRE
    dmrs_syms = [s for s in range(14) if (cfg.dmrs_symbol_mask >> s) & 1]
    nof_dmrs_symbols = len(dmrs_syms)
    layers = cfg.nof_layers
    nof_cdm = (layers + 1) // 2
    pats = [cfg.re_pattern if g == 0 else (cfg.re_pattern2 or cfg.re_pattern)
            for g in range(max(nof_cdm, 1))]
    re_idx_g = [np.concatenate(
        [rb * NRE + np.asarray(p) for rb in range(cfg.nof_prb)]) for p in pats]
    re_idx = re_idx_g[0]
    nof_pilots = len(re_idx)
    assert all(len(r) == nof_pilots for r in re_idx_g)
    epochs = _symbol_start_epochs(14, mu)
    beta = cfg.scaling
    interpolate_td = cfg.td_strategy == "interpolate"
    nof_lse_symbols = nof_dmrs_symbols if interpolate_td else 1

    # --- extract rx pilots (per CDM group, on the group's own REs) ---------
    rx = np.empty((nof_cdm, nof_dmrs_symbols, nof_pilots), np.complex128)
    for s_idx, sym in enumerate(dmrs_syms):
        for cdm in range(nof_cdm):
            rx[cdm, s_idx] = grid[sym, re_idx_g[cdm]]

    epre = float(sum(np.sum(np.abs(rx[cdm]) ** 2) for cdm in range(nof_cdm)))

    # --- LS match + CFO ----------------------------------------------------
    # p_lse[layer][dmrs_symbol] before accumulation.
    p_sym = np.empty((layers, nof_dmrs_symbols, nof_pilots), np.complex128)
    for l in range(layers):
        cdm = l // 2
        for s_idx in range(nof_dmrs_symbols):
            p_sym[l, s_idx] = rx[cdm, s_idx] * np.conj(pilots[l, s_idx])

    cfo = None
    if nof_dmrs_symbols >= 2:
        # Reference: per-CDM-group angle, then the group CFOs averaged
        # (compute_hop: cfo_hop accumulates each group's estimate and is
        # divided by divide_ceil(nof_layers, 2)).
        cfo_sum = 0.0
        for group_start in range(0, layers, 2):
            group = range(group_start, min(group_start + 2, layers))
            g_acc = 0.0 + 0.0j
            for l in group:
                g_acc += np.vdot(p_sym[l, 1], p_sym[l, 0])  # sum p1 * conj(p0)
            noisy_phase = np.angle(np.conj(g_acc))  # dot_prod(a,b) = sum a*conj(b)
            cfo_sum += noisy_phase / (2 * np.pi) / (
                epochs[dmrs_syms[1]] - epochs[dmrs_syms[0]])
        cfo = cfo_sum / nof_cdm

    # --- CFO compensation + accumulation ----------------------------------
    if cfo is not None and cfg.compensate_cfo:
        for s_idx, sym in enumerate(dmrs_syms):
            rot = np.exp(-2j * np.pi * epochs[sym] * cfo)
            p_sym[:, s_idx] *= rot

    if interpolate_td:
        p_lse = p_sym.copy()  # (layers, nof_lse_symbols, nof_pilots)
    else:
        p_lse = p_sym.sum(axis=1, keepdims=True)  # (layers, 1, nof_pilots)

    # CDM pair averaging (orthogonal cover cancellation).  Multi-symbol
    # path: applied to every layer when layers > 1
    # (compensate_cfo_and_accumulate tail).  Single-symbol path: only to
    # layers in full pairs (preprocess_pilots' need_average).
    if layers > 1:
        if nof_dmrs_symbols == 1:
            avg_layers = [l for l in range(layers) if (l // 2) * 2 + 1 < layers]
        else:
            avg_layers = list(range(layers))
        for l in avg_layers:
            for s in range(p_lse.shape[1]):
                v = p_lse[l, s]
                pairs = (len(v) // 2) * 2
                avg = (v[0:pairs:2] + v[1:pairs:2]) / 2.0
                v[0:pairs:2] = avg
                v[1:pairs:2] = avg

    # --- frequency-domain processing per layer -----------------------------
    # Stride is common to all groups; the interpolation offset is each
    # layer's own group pattern offset (configure_interpolator per layer).
    stride = (int(cfg.re_pattern[1]) - int(cfg.re_pattern[0])
              if len(cfg.re_pattern) > 1 else 1)
    total_scaling = 1.0 / beta / (nof_dmrs_symbols if not interpolate_td else 1.0)

    ce = np.zeros((layers, 14, nof_subc), np.complex128)
    rsrp = 0.0
    filtered = np.empty_like(p_lse)
    for l in range(layers):
        offset = int(pats[min(l // 2, len(pats) - 1)][0])
        freq_resp = np.empty((nof_lse_symbols, nof_subc), np.complex128)
        for s in range(nof_lse_symbols):
            p = p_lse[l, s] * total_scaling
            p_lse[l, s] = p
            f = _fd_smooth(p, cfg.nof_prb, stride, cfg.smoothing)
            filtered[l, s] = f
            avg = float(np.sum(np.abs(f) ** 2))
            rsrp += avg * beta * beta * nof_dmrs_symbols / nof_lse_symbols
            freq_resp[s] = _interp_linear(f, nof_subc, offset, stride)

        for sym in range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols):
            if not interpolate_td or nof_lse_symbols == 1:
                ce[l, sym] = freq_resp[0]
                continue
            before = [s for s in dmrs_syms if s < sym]
            after = [s for s in dmrs_syms if s >= sym]
            if not before:
                s0, s1 = dmrs_syms[0], dmrs_syms[1]
            elif not after:
                s0, s1 = dmrs_syms[-2], dmrs_syms[-1]
            else:
                s0, s1 = before[-1], after[0]
            w = (sym - s0) / (s1 - s0)
            i0 = dmrs_syms.index(s0)
            ce[l, sym] = freq_resp[i0] + (freq_resp[i0 + 1] - freq_resp[i0]) * w

    # --- noise estimation ---------------------------------------------------
    noise_var = 0.0
    for group_start in range(0, layers, 2):
        group = list(range(group_start, min(group_start + 2, layers)))
        cdm = group_start // 2
        scaled = {}
        for l in group:
            # scaling_factor = beta / nof_lse_symbols, summed over LSE symbols.
            scaled[l] = filtered[l].sum(axis=0) * (beta / nof_lse_symbols)
        energy = 0.0
        for s_idx, sym in enumerate(dmrs_syms):
            pred = np.zeros(nof_pilots, np.complex128)
            for l in group:
                p = scaled[l] * pilots[l, s_idx]
                if cfg.compensate_cfo and cfo is not None:
                    p = p * np.exp(2j * np.pi * epochs[sym] * cfo)
                pred += p
            resid = rx[cdm, s_idx] - pred
            energy += float(np.sum(np.abs(resid) ** 2))
        if np.isfinite(energy) and energy > 0:
            noise_var += energy

    # --- time alignment -----------------------------------------------------
    pat = tuple(cfg.re_pattern)
    slices = [filtered[l, s] for s in range(nof_lse_symbols) for l in range(layers)]
    if pat == _RE_PATTERN_FULL:
        ta = _ta_estimate(slices, 1, cfg.scs_khz)
    elif pat in (_RE_PATTERN_PUSCH0, _RE_PATTERN_PUSCH1):
        ta = _ta_estimate(slices, 2, cfg.scs_khz)
    elif pat == _RE_PATTERN_PUCCH_F2:
        ta = _ta_estimate(slices, 3, cfg.scs_khz)
    else:
        ta = _ta_estimate(slices, 1, cfg.scs_khz, mask=re_idx)

    # --- final statistics ---------------------------------------------------
    nof_dmrs_pilots = nof_pilots * nof_dmrs_symbols
    rsrp /= nof_dmrs_pilots * layers
    epre /= nof_dmrs_pilots
    noise_var /= nof_dmrs_pilots * nof_cdm - 1
    noise_var = max(noise_var, rsrp / (10 ** (MAX_SINR_DB / 10)))
    datarp = rsrp * layers / beta / beta
    snr = datarp / noise_var if np.isfinite(noise_var) and noise_var > 0 else 0.0

    # Re-apply CFO rotation to the channel estimates.
    if cfg.compensate_cfo and cfo is not None:
        for sym in range(cfg.first_symbol, cfg.first_symbol + cfg.nof_symbols):
            ce[:, sym] *= np.exp(2j * np.pi * epochs[sym] * cfo)

    cfo_hz = cfo * cfg.scs_khz * 1000.0 if cfo is not None else None
    return EstimateResult(
        ce=ce.astype(np.complex64),
        noise_var=noise_var,
        rsrp=rsrp,
        epre=epre,
        snr=snr,
        time_alignment_s=ta,
        cfo_hz=cfo_hz,
    )
