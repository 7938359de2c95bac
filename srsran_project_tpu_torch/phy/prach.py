"""PRACH preamble generation and detection (TS 38.211 §6.3.3).

Port of ``srsran_project_tpu/phy/prach.py``, with its own copies of
``_prach_roots.npz``, ``_prach_tables.npz`` and ``_prach_thresholds.npz``.
The root sequences, shift windows and the CFAR threshold (an 80-step
bisection) are host work in float64, cached per config; the tables go to
each device once.

``detect`` evaluates every preamble hypothesis of an occasion in one
batch: per root the received subcarriers times the conjugate root, one
batched IDFT to the delay domain, the ports' powers summed, then the peak
and its position in each cyclic shift's window against the root's mean
power.  ``detect_ref`` is the reference-parity detector
(prach_detector_generic_impl.cpp:80-360: half-spectrum swap into an
unnormalized IDFT, per-shift windows against their neighbourhood, the
validated threshold table), batched over sequences, ports and shifts on
the tensor's device.  ``generate_preamble(_ref)`` is the UE side.
"""

from __future__ import annotations

import dataclasses
import functools
import math
import os

import numpy as np
import torch

from ..ops._tables import device_table
from ..ops.lower_phy import KAPPA_S, PRACH_PREAMBLES
from ..support.tracing import l1_tracer

# Zero-correlation-zone -> N_CS, long preambles, unrestricted set
# (TS 38.211 Table 6.3.3.1-5).
NCS_LONG_UNRESTRICTED = (0, 13, 15, 18, 22, 26, 32, 38, 46, 59, 76, 93, 119, 167, 279, 419)
# Short preambles (TS 38.211 Table 6.3.3.1-7).
NCS_SHORT = (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69)

_HERE = os.path.dirname(os.path.abspath(__file__))


@dataclasses.dataclass(frozen=True)
class PrachConfig:
    """Twin of the reference's ``PrachConfig`` (same fields, defaults and
    derived values)."""

    l_ra: int = 839  # 839 (long) or 139 (short)
    root_sequence_index: int = 0  # logical start index -> physical roots used in order
    zero_correlation_zone: int = 1
    nof_rx_ports: int = 1
    dft_size: int = 1024  # IDFT size of the power delay profile
    # Detection threshold (peak power over the noise floor); None = CFAR
    # for target_pfa per occasion (``threshold_for``).
    detect_threshold: float | None = None
    target_pfa: float = 1e-3

    @classmethod
    def from_reference(cls, ref) -> "PrachConfig":
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    @property
    def n_cs(self) -> int:
        table = NCS_LONG_UNRESTRICTED if self.l_ra == 839 else NCS_SHORT
        return table[self.zero_correlation_zone]

    @property
    def nof_shifts(self) -> int:
        return self.l_ra // self.n_cs if self.n_cs else 1

    @property
    def nof_roots(self) -> int:
        return -(-64 // self.nof_shifts)


def zc_root(u: int, l_ra: int) -> np.ndarray:
    """Time-domain Zadoff-Chu root x_u(n) = exp(-j pi u n(n+1) / L_RA),
    complex128."""
    n = np.arange(l_ra, dtype=np.float64)
    return np.exp(-1j * np.pi * u * n * (n + 1) / l_ra)


@functools.lru_cache(maxsize=None)
def _root_fd(u: int, l_ra: int) -> np.ndarray:
    """Frequency-domain root sequence (complex64)."""
    return np.fft.fft(zc_root(u, l_ra)).astype(np.complex64)


@functools.lru_cache(maxsize=1)
def _root_tables():
    d = np.load(os.path.join(_HERE, "_prach_roots.npz"))
    return d["long"], d["short"]


def physical_root(logical_index: int, l_ra: int) -> int:
    """Logical -> physical root sequence number u (TS 38.211 Tables
    6.3.3.1-3 / 6.3.3.1-4)."""
    long_t, short_t = _root_tables()
    table = long_t if l_ra == 839 else short_t
    return int(table[logical_index % len(table)])


def _gamma_sf(x: float, p: int) -> float:
    """Survival function of Gamma(shape=p, scale=1) for integer p:
    exp(-x) * sum_{k<p} x^k / k!."""
    s = 0.0
    term = 1.0
    for k in range(p):
        if k:
            term *= x / k
        s += term
    return math.exp(-x) * s


def _window(cfg: PrachConfig) -> int:
    """Usable delay span of a shift window in delay-profile bins: 0.8 of
    the window, so that the leakage of the neighbouring shift's zero-delay
    peak stays outside every window (the reference caps its TA the same
    way)."""
    full_win = max(1, int(cfg.n_cs * cfg.dft_size / cfg.l_ra)) if cfg.n_cs else cfg.dft_size
    return max(1, int(0.8 * full_win))


@functools.lru_cache(maxsize=None)
def threshold_for(cfg: PrachConfig) -> float:
    """CFAR detection threshold for target_pfa per occasion.

    Each delay-profile bin of a root's correlation is exponential under
    noise alone; the P ports' sum is Gamma(P), and the metric divides by
    P times the bin mean, so metric * P ~ Gamma(P).  With 64 preambles x
    window bins candidates, solve N_eff * SF_Gamma(P)(P*T) = pfa by
    bisection."""
    n_eff = 64 * _window(cfg)
    p = cfg.nof_rx_ports
    target = cfg.target_pfa / n_eff
    lo, hi = 0.0, 200.0 * p
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if _gamma_sf(mid, p) > target:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi) / p


def generate_preamble(cfg: PrachConfig, preamble_index: int,
                      device: torch.device | str = "cuda") -> torch.Tensor:
    """UE-side frequency-domain preamble (L_RA,) complex64 on ``device``."""
    v = preamble_index % cfg.nof_shifts
    root_i = preamble_index // cfg.nof_shifts
    u = physical_root(cfg.root_sequence_index + root_i, cfg.l_ra)
    x = np.roll(zc_root(u, cfg.l_ra), -v * cfg.n_cs)  # x_u((n + C_v) mod L_RA)
    return torch.from_numpy(np.fft.fft(x).astype(np.complex64)).to(device)


def _detect_roots(cfg: PrachConfig) -> np.ndarray:
    """(nof_roots, L_RA) complex64 conjugate frequency-domain roots."""
    return np.conj(np.stack([_root_fd(physical_root(cfg.root_sequence_index + i, cfg.l_ra),
                                      cfg.l_ra) for i in range(cfg.nof_roots)]))


def _detect_windows(cfg: PrachConfig) -> np.ndarray:
    """(nof_shifts, window) delay-profile bins of each shift's window:
    preamble (root, shift v) peaks at (d - v N_CS dft/L_RA) mod dft for a
    channel delay d."""
    nfft, lr = cfg.dft_size, cfg.l_ra
    starts = ((lr - np.arange(cfg.nof_shifts) * cfg.n_cs) * nfft // lr) % nfft
    return ((starts[:, None] + np.arange(_window(cfg))[None, :]) % nfft).astype(np.int64)


_roots_on = device_table(_detect_roots)
_windows_on = device_table(_detect_windows)


def detect(rx_fd: torch.Tensor, cfg: PrachConfig) -> dict:
    """Detect preambles from one occasion's demodulated preamble
    subcarriers rx_fd (nof_rx_ports, L_RA) complex64.  Returns a dict of
    tensors on rx_fd's device: detected (64,) bool, metric (64,) float32
    and ta_samples (64,) float32, the delay in bins of the
    dft_size-point profile.  In the span ``prach.detect``, with counts
    ``roots`` and ``detected`` (a device count, read when the spans are
    taken)."""
    with l1_tracer.span("prach.detect") as span:
        out = _detect(rx_fd, cfg)
        span.count(roots=cfg.nof_roots, detected=out["detected"])
        return out


def _detect(rx_fd: torch.Tensor, cfg: PrachConfig) -> dict:
    dev = rx_fd.device
    c = rx_fd[None, :, :] * _roots_on(dev, cfg)[:, None, :]  # (nroot, P, L)
    pdp = torch.fft.ifft(c, n=cfg.dft_size, dim=-1).abs() ** 2
    pdp = pdp.sum(dim=1)  # (nroot, nfft): ports combined
    windows = pdp[:, _windows_on(dev, cfg)]  # (nroot, nshift, win)
    peak, peak_pos = windows.max(dim=-1)
    metric = peak / (pdp.mean(dim=-1, keepdim=True) + 1e-12)  # per-root noise floor
    flat_metric = metric.reshape(-1)[:64]
    thr = cfg.detect_threshold if cfg.detect_threshold is not None else threshold_for(cfg)
    return {"detected": flat_metric > thr, "metric": flat_metric,
            "ta_samples": peak_pos.reshape(-1)[:64].to(torch.float32)}


# ---------------------------------------------------------------------------
# Reference-exact generation and detection (conformance surface)
# ---------------------------------------------------------------------------

# Long formats use L_RA = 839 (RA SCS 1.25 kHz for 0-2, 5 kHz for 3);
# short formats use L_RA = 139 (TS 38.211 Table 6.3.3.1-1/2).
_LONG_FORMATS = {"0": 1250, "1": 1250, "2": 1250, "3": 5000}


@functools.lru_cache(maxsize=1)
def _std_tables():
    d = np.load(os.path.join(_HERE, "_prach_tables.npz"))
    return {k: d[k] for k in d.files}


def prach_ncs(fmt: str, zero_correlation_zone: int, restricted: str = "unrestricted") -> int:
    """N_CS from TS 38.211 Tables 6.3.3.1-5/6/7 (reference
    lib/ran/prach/prach_cyclic_shifts.cpp).  Raises on reserved entries."""
    t = _std_tables()
    if fmt in _LONG_FORMATS:
        base = "ncs_1_25" if _LONG_FORMATS[fmt] == 1250 else "ncs_5"
        key = {"unrestricted": f"{base}_unrestricted",
               "type_a": f"{base}_type_a",
               "type_b": f"{base}_type_b"}[restricted]
    else:
        if restricted != "unrestricted":
            raise ValueError("restricted sets apply to long preambles only")
        key = "ncs_short_unrestricted"
    val = int(t[key][zero_correlation_zone])
    if val == int(t["ncs_reserved_marker"][0]):
        raise ValueError(f"reserved N_CS for format {fmt} zcz {zero_correlation_zone}")
    return val


def physical_root_ref(logical_index: int, l_ra: int) -> int:
    """Logical -> physical root (TS 38.211 Tables 6.3.3.1-3/4), as the
    reference generator maps it."""
    t = _std_tables()
    table = t["long_root_map"] if l_ra == 839 else t["short_root_map"]
    return int(table[logical_index % len(table)])


def _preamble_ref(fmt: str, root_sequence_index: int, preamble_index: int,
                  zero_correlation_zone: int, restricted: str = "unrestricted") -> np.ndarray:
    """``generate_preamble_ref`` as a host complex64 array."""
    l_ra = 839 if fmt in _LONG_FORMATS else 139
    n_cs = prach_ncs(fmt, zero_correlation_zone, restricted)
    logical = root_sequence_index + preamble_index
    shift = 0
    if n_cs != 0:
        nof_seq_per_root = l_ra // n_cs
        logical = root_sequence_index + preamble_index // nof_seq_per_root
        shift = (preamble_index % nof_seq_per_root) * n_cs
    x = zc_root(physical_root_ref(logical, l_ra), l_ra)
    if shift:
        x = np.roll(x, -shift)
    return np.fft.fft(x).astype(np.complex64)


def generate_preamble_ref(fmt: str, root_sequence_index: int, preamble_index: int,
                          zero_correlation_zone: int, restricted: str = "unrestricted",
                          device: torch.device | str = "cuda") -> torch.Tensor:
    """Frequency-domain preamble y_u,v (L_RA,) complex64 on ``device``: the
    unnormalized DFT of the cyclic-shifted time-domain ZC root, root and
    shift chosen per TS 38.211 §6.3.3.1 (reference
    prach_generator_impl::generate)."""
    return torch.from_numpy(_preamble_ref(fmt, root_sequence_index, preamble_index,
                                          zero_correlation_zone, restricted)).to(device)


_SCS_ENUM = {1250.0: 0, 5000.0: 1, 15000.0: 2, 30000.0: 3, 60000.0: 4, 120000.0: 5}
_FMT_ENUM = {"0": 0, "1": 1, "2": 2, "3": 3, "A1": 10, "A2": 11, "A3": 12,
             "B1": 13, "B4": 16, "C0": 30, "C2": 31}


@functools.lru_cache(maxsize=1)
def _threshold_table():
    return np.load(os.path.join(_HERE, "_prach_thresholds.npz"))["table"]


@functools.lru_cache(maxsize=None)
def detection_threshold_ref(fmt: str, nof_rx_ports: int, zero_correlation_zone: int,
                            ra_scs_hz: float, combine_symbols: bool = True) -> tuple[float, int]:
    """(threshold, window margin) from the reference's validated table
    (prach_detector_generic_thresholds.cpp), with its fallback defaults
    for uncovered combinations."""
    key = (nof_rx_ports, _SCS_ENUM[ra_scs_hz], _FMT_ENUM[fmt],
           zero_correlation_zone, 1 if combine_symbols else 0)
    for row in _threshold_table():
        if tuple(int(v) for v in row[:5]) == key:
            return float(row[5]), int(row[6])
    if fmt in _LONG_FORMATS:
        return 2.0, 5
    return 0.3, 12


@functools.lru_cache(maxsize=None)
def _ref_plan(fmt: str, root_sequence_index: int, zero_correlation_zone: int, l_ra: int,
              nof_rx_ports: int, dft_size: int, ra_scs_hz: float):
    """Host plan of ``detect_ref``: geometry numbers, the (nseq, L_RA)
    conjugate roots, the IDFT buffer's source index per bin (-1: zero),
    and the (nshift, win) window and (nshift, win + 2 margin) reference
    bins."""
    cp_kappa = PRACH_PREAMBLES[fmt][0]
    n_cs = prach_ncs(fmt, zero_correlation_zone)
    nof_shifts = min(64, l_ra // n_cs) if n_cs else 1
    nof_sequences = -(-64 // nof_shifts)
    cp_prach = int(np.floor(cp_kappa * KAPPA_S * l_ra * ra_scs_hz))
    win_width = cp_prach if n_cs == 0 else min(n_cs, cp_prach)
    win_width = (win_width * dft_size) // l_ra
    max_delay = cp_prach if n_cs == 0 else min(max(n_cs, 1) - 1, cp_prach)
    max_delay = (max_delay * dft_size) // l_ra
    threshold, margin = detection_threshold_ref(fmt, nof_rx_ports, zero_correlation_zone,
                                                ra_scs_hz, True)
    roots = np.conj(np.stack([_preamble_ref(fmt, root_sequence_index, i * nof_shifts,
                                            zero_correlation_zone)
                              for i in range(nof_sequences)]))
    # Half-spectrum swap: the upper half (from L_RA // 2) at the low bins,
    # the lower half at the top of the buffer.
    half = l_ra // 2
    src = np.full(dft_size, -1, np.int64)
    src[: half + 1] = np.arange(half, l_ra)
    src[dft_size - half :] = np.arange(half)
    starts = np.asarray([(dft_size - (n_cs * i_w * dft_size) // l_ra) % dft_size
                         for i_w in range(nof_shifts)], np.int64)
    win_idx = (starts[:, None] + np.arange(win_width)) % dft_size
    ref_idx = (starts[:, None] - margin + np.arange(2 * margin + win_width)) % dft_size
    return (dict(nof_shifts=nof_shifts, threshold=threshold, max_delay=max_delay,
                 fs=dft_size * ra_scs_hz),
            roots.astype(np.complex64), src, win_idx, ref_idx)


_ref_table_on = device_table(lambda which, *key: _ref_plan(*key)[which])


def detect_ref(rx_fd: torch.Tensor, fmt: str, root_sequence_index: int,
               zero_correlation_zone: int, nof_rx_ports: int | None = None,
               dft_size: int = 1024, ra_scs_hz: float | None = None) -> list:
    """Reference-parity PRACH detection (prach_detector_generic_impl.cpp:
    80-360) on rx_fd (ports, nof_symbols, L_RA) complex64, every sequence,
    port and shift in one batch on rx_fd's device, in float32.

    Returns a list of dicts {preamble_index, metric, ta_s, power} for the
    detected preambles (validated threshold and margin table), in
    preamble order."""
    ports, nof_symbols, l_ra = rx_fd.shape
    if nof_rx_ports is None:
        nof_rx_ports = ports
    scs_default = PRACH_PREAMBLES[fmt][2]
    if ra_scs_hz is None:
        ra_scs_hz = scs_default if scs_default else 15000.0
    key = (fmt, root_sequence_index, zero_correlation_zone, l_ra, nof_rx_ports, dft_size,
           float(ra_scs_hz))
    geo = _ref_plan(*key)[0]
    dev = rx_fd.device
    roots, src, win_idx, ref_idx = (_ref_table_on(dev, i, *key) for i in range(1, 5))

    combined = rx_fd.sum(dim=1)  # (P, L): symbols combined
    no_root = combined[None] * roots[:, None]  # (nseq, P, L)
    buf = torch.where(src >= 0, no_root[..., src.clamp_min(0)], 0)
    t = torch.fft.ifft(buf, dim=-1) * float(dft_size)  # the unnormalized inverse DFT
    mod_sq = t.abs() ** 2 / float(dft_size * l_ra)  # (nseq, P, dft)
    window = mod_sq[..., win_idx] * float(dft_size / l_ra)  # (nseq, P, nshift, win)
    reference = mod_sq[..., ref_idx].sum(dim=-1, keepdim=True)  # (nseq, P, nshift, 1)
    diff = reference - window
    diff = torch.where(torch.isfinite(diff) & (diff != 0), diff, 1e-9)
    num = window.sum(dim=1)  # (nseq, nshift, win)
    metric = num / diff.sum(dim=1).abs()
    peak, d = metric.max(dim=-1)  # (nseq, nshift)
    power = num.gather(-1, d[..., None])[..., 0]
    peak, d, power = (x.reshape(-1).cpu().numpy() for x in (peak, d, power))

    results = []
    for pi in range(min(64, peak.size)):
        if peak[pi] > geo["threshold"] and d[pi] < 0.8 * geo["max_delay"]:
            results.append({
                "preamble_index": pi,
                "metric": float(peak[pi]) / geo["threshold"],
                "ta_s": int(d[pi]) / geo["fs"],
                "power": float(power[pi]) / (nof_rx_ports * l_ra * nof_symbols * nof_symbols),
            })
    return results
