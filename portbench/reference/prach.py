"""The benchmark's plain PRACH (TS 38.211 6.3.3): short preambles (L_RA =
139) sent in the frequency domain and detected.

Sent: the Zadoff-Chu root x_u(i) = exp(-j pi u i (i + 1) / L_RA) of the
physical root u (Table 6.3.3.1-4: logical index 2m -> m + 1, 2m + 1 ->
L_RA - m - 1), cyclically shifted by C_v = v N_CS (unrestricted set, N_CS
of Table 6.3.3.1-7), its L_RA-point DFT scaled to unit power per
subcarrier; the 64 preambles of an occasion in order of increasing shift,
then of increasing logical root.  A delay tau multiplies subcarrier k by
exp(-j 2 pi k df tau).

Detected: per root the received subcarriers times the root's conjugate
DFT, the dft_size-point inverse DFT, the power delay profile summed over
the ports; shift v's window starts at bin ((L_RA - v N_CS) dft_size //
L_RA) mod dft_size and spans the given fraction of N_CS dft_size / L_RA
bins; a preamble's metric is its window's peak over the root's mean
profile power, detected above the threshold at which noise alone crosses
with probability ``target_pfa`` an occasion (the ports' summed profile
bin is Gamma(P)-distributed: 64 x window bins tries), its delay the
peak's bin within the window.

Departures from the spec: the spec defines no detector; the window
fraction, the profile's size and the false-alarm target are the
deployment's detector parameters, stated in its configuration.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from .link import FLOAT32, Precision

# Float32 products stay float32 on the card (no TF32).
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

L_RA = 139
NCS_SHORT = (0, 2, 4, 6, 8, 10, 12, 13, 15, 17, 19, 23, 27, 34, 46, 69)  # Table 6.3.3.1-7


def physical_root(logical: int) -> int:
    i = logical % (L_RA - 1)
    return i // 2 + 1 if i % 2 == 0 else L_RA - (i // 2 + 1)


def n_cs(zcz: int) -> int:
    return NCS_SHORT[zcz]


def nof_shifts(zcz: int) -> int:
    return L_RA // n_cs(zcz)


@functools.lru_cache(maxsize=None)
def root_fd(u: int, shift: int = 0) -> np.ndarray:
    """The L_RA-point DFT of x_u((n + shift) mod L_RA), unit power per
    subcarrier, complex64."""
    i = np.arange(L_RA, dtype=np.float64)
    x = np.exp(-1j * np.pi * u * i * (i + 1) / L_RA)
    return (np.fft.fft(np.roll(x, -shift)) / np.sqrt(L_RA)).astype(np.complex64)


def preamble(root_index: int, zcz: int, index: int) -> np.ndarray:
    v, r = index % nof_shifts(zcz), index // nof_shifts(zcz)
    return root_fd(physical_root(root_index + r), v * n_cs(zcz))


def delay_ramp(tau_s: torch.Tensor, df_hz: float) -> torch.Tensor:
    """(...,) delays -> (..., L_RA) complex64 exp(-j 2 pi k df tau)."""
    k = torch.arange(L_RA, dtype=torch.float64, device=tau_s.device)
    ph = -2.0 * math.pi * df_hz * tau_s.to(torch.float64)[..., None] * k
    return torch.polar(torch.ones_like(ph), ph).to(torch.complex64)


def _gamma_sf(x: float, p: int) -> float:
    """P(X > x) of X ~ Gamma(p, 1), p whole: exp(-x) sum_{k<p} x^k / k!."""
    return math.exp(-x) * sum(x ** k / math.factorial(k) for k in range(p))


@functools.lru_cache(maxsize=None)
def threshold(nof_ports: int, window: int, target_pfa: float) -> float:
    """T with 64 window P(P T) = target_pfa, by bisection."""
    want = target_pfa / (64 * window)
    lo, hi = 0.0, 200.0 * nof_ports
    for _ in range(100):
        mid = 0.5 * (lo + hi)
        lo, hi = (mid, hi) if _gamma_sf(mid, nof_ports) > want else (lo, mid)
    return 0.5 * (lo + hi) / nof_ports


def window_bins(zcz: int, dft_size: int, fraction: float) -> int:
    return max(1, int(fraction * max(1, int(n_cs(zcz) * dft_size / L_RA))))


def detect(rx: torch.Tensor, root_index: int, zcz: int, dft_size: int, fraction: float,
           target_pfa: float, rnd: Precision = FLOAT32) -> dict:
    """(B, P, L_RA) received subcarriers -> detected (B, 64) bool, metric
    (B, 64), delay (B, 64) in profile bins."""
    ns, nroots = nof_shifts(zcz), -(-64 // nof_shifts(zcz))
    win = window_bins(zcz, dft_size, fraction)
    dev = rx.device
    peaks, delays = [], []
    for r in range(nroots):
        ref = torch.from_numpy(root_fd(physical_root(root_index + r))).to(dev)
        pdp = rnd(torch.fft.ifft(rnd(rx * ref.conj()), n=dft_size, dim=-1).abs() ** 2).sum(dim=1)
        mean = pdp.mean(dim=-1, keepdim=True)
        for v in range(ns):
            start = ((L_RA - v * n_cs(zcz)) * dft_size // L_RA) % dft_size
            bins = (start + torch.arange(win, device=dev)) % dft_size
            peak, pos = pdp[:, bins].max(dim=-1)
            peaks.append(rnd(peak / mean[:, 0]))
            delays.append(pos)
    metric = torch.stack(peaks, dim=-1)[:, :64]
    delay = torch.stack(delays, dim=-1)[:, :64].to(torch.float32)
    return {"detected": metric > threshold(rx.shape[1], win, target_pfa), "metric": metric,
            "delay": delay}
