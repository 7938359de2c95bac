"""DM-RS channel estimator, fast path (port of
``srsran_project_tpu/ops/estimator.py``: ``estimate_channel``,
``_smooth_freq``, ``_rc_filter_taps``; ``estimate_h`` is its channel part
alone).

Per (rx port, layer): LS at the pilot REs -> OCC despread over CDM pairs
-> time average over DM-RS symbols -> bulk-delay derotation -> 9-tap
raised-cosine smoothing in frequency -> linear interpolation to every
subcarrier -> re-rotation, then the pilot-residual noise variance and the
EPRE / RSRP / SNR metrics (PUCCH F2 reads them; PUSCH measures its noise
by second differences unless asked for the pilot residual,
ops/pusch_estimate.py),
and on request the CFO metric (phase per DM-RS symbol interval) and the
TA metric (``estimate_ta_samples``: the delay-profile peak of the pair
channel before derotation).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._tables import device_table


@functools.lru_cache(maxsize=None)
def _rc_filter_taps(nof_taps: int = 9, rolloff: float = 0.2, cutoff: float = 0.45) -> np.ndarray:
    """Raised-cosine low-pass taps used for frequency smoothing, normalized."""
    n = np.arange(nof_taps) - (nof_taps - 1) / 2
    sinc = np.sinc(2 * cutoff * n)
    cosf = np.cos(np.pi * rolloff * 2 * cutoff * n)
    den = 1 - (2 * rolloff * 2 * cutoff * n) ** 2
    den = np.where(np.abs(den) < 1e-9, 1e-9, den)
    taps = sinc * cosf / den
    return (taps / taps.sum()).astype(np.float32)


def _smooth_freq(h: torch.Tensor, taps: np.ndarray) -> torch.Tensor:
    """Edge-replicated 1-D convolution along the last axis."""
    k = len(taps)
    pad = k // 2
    n = h.shape[-1]
    hp = torch.cat([h[..., :1].expand(h.shape[:-1] + (pad,)), h,
                    h[..., -1:].expand(h.shape[:-1] + (pad,))], dim=-1)
    out = torch.zeros_like(h)
    for i in range(k):
        out = out + float(taps[i]) * hp[..., i : i + n]
    return out


def _interp_plan(pair_positions: tuple, nof_sc: int):
    """(left neighbour (nof_sc,), right neighbour (nof_sc,), fraction
    (nof_sc,), pair-index coordinate (nof_sc,)) of the linear interpolation
    from pair centres.  The right neighbour of a single pair is itself (the
    reference's gather clamps the index; its weight is 0)."""
    pos = np.asarray(pair_positions, dtype=np.float32)
    x = np.arange(nof_sc, dtype=np.float32)
    li = np.clip(np.searchsorted(pos, x, side="right") - 1, 0, max(len(pos) - 2, 0))
    ri = np.minimum(li + 1, len(pos) - 1).astype(np.int64)
    if len(pos) < 2:  # one pair: every subcarrier takes its value
        return li.astype(np.int64), ri, np.zeros_like(x), np.zeros_like(x)
    frac = np.clip((x - pos[li]) / (pos[li + 1] - pos[li]), 0.0, 1.0)
    spacing = float(pos[1] - pos[0])
    return (li.astype(np.int64), ri, frac.astype(np.float32),
            ((x - pos[0]) / spacing).astype(np.float32))


_interp_on = device_table(lambda pp, n, which: _interp_plan(pp, n)[which])


def _unit_phasor(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def estimate_ta_samples(h_freq: torch.Tensor, dft_size: int = 4096) -> torch.Tensor:
    """Time-alignment estimate by IDFT peak search: (..., Nf) channel
    samples at a uniform spacing df -> (...,) float32 peak bin of the
    dft_size-point delay profile (tau = bin / (dft_size * df)), signed:
    bins above dft_size / 2 are negative delays."""
    nf = h_freq.shape[-1]
    p = torch.fft.ifft(torch.nn.functional.pad(h_freq, (0, dft_size - nf)), dim=-1).abs() ** 2
    peak = torch.argmax(p, dim=-1)
    return torch.where(peak > dft_size // 2, peak - dft_size, peak).to(torch.float32)


def estimate_h(y_pilots: torch.Tensor, ref_pilots: torch.Tensor, wf: torch.Tensor,
               pair_positions: tuple, nof_sc: int, smooth: bool = True):
    """The channel part of ``estimate_channel``: (h (..., nof_sc)
    complex64, the LS samples (..., nsym_dmrs, Np), the despread pair
    values (..., nsym_dmrs, Np/2)).  PUSCH calls it alone: its noise comes
    from second differences, and the metrics would cost launches for
    nothing."""
    dev = y_pilots.device
    ls = y_pilots * ref_pilots.conj() * wf
    pair = ls.reshape(ls.shape[:-1] + (ls.shape[-1] // 2, 2))
    h_pair = pair.mean(dim=-1)  # (..., nsym_dmrs, Np/2)
    h_t = h_pair.mean(dim=-2)  # (..., Np/2)

    # Bulk-delay derotation before smoothing/interpolation (both lag a fast
    # phase rotation); the rotation is re-applied at every subcarrier.  A
    # single pair has no slope: the reference neither derotates it nor
    # re-rotates.
    n_pairs = h_t.shape[-1]
    if n_pairs > 1:
        slope = torch.angle(torch.sum(h_t[..., 1:] * h_t[..., :-1].conj(), dim=-1,
                                      keepdim=True))
        idx = torch.arange(n_pairs, dtype=torch.float32, device=dev)
        h_t = h_t * _unit_phasor(-slope * idx)
    if smooth:
        h_t = _smooth_freq(h_t, _rc_filter_taps())

    li, ri, fr = (_interp_on(dev, pair_positions, nof_sc, i) for i in range(3))
    h = h_t[..., li] * (1 - fr) + h_t[..., ri] * fr
    if n_pairs > 1:
        h = h * _unit_phasor(slope * _interp_on(dev, pair_positions, nof_sc, 3))
    return h.to(torch.complex64), ls, h_pair


def channel_metrics(y_pilots: torch.Tensor, ls: torch.Tensor, h_pair: torch.Tensor,
                    compute_ta: bool = False, compute_cfo: bool = False):
    """The metric part of ``estimate_channel`` from ``estimate_h``'s LS
    samples and pair values: (noise_var (...,) float32, metrics dict of
    epre / rsrp / snr (...,), with compute_cfo "cfo_phase_per_dmrs_symbol"
    (radians per DM-RS symbol interval, 0 with one DM-RS symbol) and with
    compute_ta "ta_peak_bin_4096")."""
    # Noise: residual of the LS samples against the despread pair values
    # (one degree of freedom per pair goes to the despreading).
    resid = ls - h_pair.repeat_interleave(2, dim=-1)
    noise_var = torch.clamp_min((resid.abs() ** 2).mean(dim=(-2, -1)) * 2.0, 1e-10)
    epre = (y_pilots.abs() ** 2).mean(dim=(-2, -1))
    rsrp = (h_pair.abs() ** 2).mean(dim=-1).mean(dim=-1)
    metrics = {"epre": epre, "rsrp": rsrp, "snr": rsrp / noise_var}
    if compute_cfo:
        if h_pair.shape[-2] > 1:
            prod = (h_pair[..., 1:, :] * h_pair[..., :-1, :].conj()).sum(dim=(-2, -1))
            metrics["cfo_phase_per_dmrs_symbol"] = torch.angle(prod)
        else:
            metrics["cfo_phase_per_dmrs_symbol"] = torch.zeros(
                h_pair.shape[:-2], dtype=torch.float32, device=h_pair.device)
    if compute_ta:
        # The pair channel before derotation: the TA needs the true slope.
        metrics["ta_peak_bin_4096"] = estimate_ta_samples(h_pair.mean(dim=-2), dft_size=4096)
    return noise_var.to(torch.float32), metrics


def estimate_channel(y_pilots: torch.Tensor, ref_pilots: torch.Tensor, wf: torch.Tensor,
                     pair_positions: tuple, nof_sc: int, smooth: bool = True,
                     compute_ta: bool = False, compute_cfo: bool = False):
    """Estimate (rx port, layer) channels over an allocation.

    y_pilots:   (..., nsym_dmrs, Np) received pilot REs
    ref_pilots: broadcastable to y_pilots — pilot values without the OCC
    wf:         broadcastable (Np,) +-1 frequency OCC of the layer's port
    pair_positions: CDM pair centres relative to the allocation start
    Returns (h (..., nof_sc) complex64, noise_var (...,) float32, metrics
    dict as ``channel_metrics`` gives it)."""
    h, ls, h_pair = estimate_h(y_pilots, ref_pilots, wf, pair_positions, nof_sc, smooth)
    return (h, *channel_metrics(y_pilots, ls, h_pair, compute_ta, compute_cfo))
