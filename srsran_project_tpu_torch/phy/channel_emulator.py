"""TDL fading channel emulator for BLER tests, on resource grids and, in
``apply_channel_time``, on baseband sample streams.

Port of ``srsran_project_tpu/phy/channel_emulator.py``: TDL-A/B/C tap
profiles (TS 38.104 annex G delay and power tables), Rayleigh fading per
tap, optional Jakes Doppler, optional CFO and AWGN at a configured SINR,
in the frequency domain: H(r, t, k) = sum_taps g exp(-j 2 pi k scs tau).

Randomness comes from an explicit ``torch.Generator`` on the grid's
device in place of the JAX key, so draws differ from the reference's;
the tap table, the steering, the application of a drawn channel, the CFO
phases and the noise scaling are the same (``apply_channel_time_taps``
takes its draws as arguments).  The sums over taps and over transmit
ports are elementwise float32 multiply-adds, not matrix products, so no
TF32 path can touch them.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops._tables import device_table
from ..ran.constants import SubcarrierSpacing, scs_khz

# (delay ns, power dB) tap tables.
PROFILES = {
    "single": ((0, 0.0),),
    "tdla": (
        (0, -15.5), (10, 0.0), (15, -5.1), (20, -5.1), (25, -9.6), (50, -8.2),
        (65, -13.1), (75, -11.5), (105, -11.0), (135, -16.2), (150, -16.6), (290, -26.2),
    ),
    "tdlb": (
        (0, 0.0), (10, -2.2), (20, -0.6), (30, -0.6), (35, -0.3), (45, -1.2),
        (55, -5.9), (120, -2.2), (170, -0.8), (245, -6.3), (330, -7.5), (480, -7.1),
    ),
    "tdlc": (
        (0, -6.9), (65, 0.0), (70, -7.7), (190, -2.5), (195, -2.4), (200, -9.9),
        (240, -8.0), (325, -6.6), (520, -7.1), (1045, -13.0), (1510, -14.2), (2595, -16.0),
    ),
}


@dataclasses.dataclass(frozen=True)
class ChannelConfig:
    """Twin of the reference's ``ChannelConfig`` (same fields and defaults).

    noise_convention: "post_fading" sets the noise so every slot sees
    sinr_db against its own faded signal power; "fixed" pins the noise
    variance to the nominal unit signal (fading dips then cause outages).
    doppler_hz: 0 is block fading (one channel a slot); above 0, Jakes
    sum-of-sinusoids fading, continuous across symbols and slots."""

    profile: str = "tdla"
    sinr_db: float = 20.0
    nof_tx_ports: int = 1
    nof_rx_ports: int = 1
    nof_sc: int = 624
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    cfo_hz: float = 0.0
    noise_convention: str = "post_fading"
    doppler_hz: float = 0.0
    nof_sinusoids: int = 8

    @classmethod
    def from_reference(cls, ref) -> "ChannelConfig":
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        kw["scs"] = SubcarrierSpacing(int(kw["scs"]))
        return cls(**kw)


@functools.lru_cache(maxsize=None)
def _tap_params(profile: str, nof_sc: int, scs: SubcarrierSpacing):
    """(tap amplitudes (T,) float32 with unit total power, steering (T,
    nsc) complex64)."""
    taps = PROFILES[profile]
    delays = np.asarray([t[0] for t in taps], np.float64) * 1e-9
    p = 10.0 ** (np.asarray([t[1] for t in taps], np.float64) / 10.0)
    p /= p.sum()
    f = np.arange(nof_sc, dtype=np.float64) * scs_khz(scs) * 1e3
    steer = np.exp(-2j * np.pi * f[None, :] * delays[:, None])
    return np.sqrt(p).astype(np.float32), steer.astype(np.complex64)


_amp_on = device_table(lambda profile, nof_sc, scs: _tap_params(profile, nof_sc, scs)[0])
_steer_on = device_table(lambda profile, nof_sc, scs: _tap_params(profile, nof_sc, scs)[1])


def _check_generator(generator: torch.Generator, device: torch.device) -> None:
    if generator.device.type != device.type:
        raise ValueError(f"the generator lives on {generator.device}, the grid on {device}")


def _complex_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """CN(0, 2): unit-variance real and imaginary parts."""
    g = torch.randn(tuple(shape) + (2,), generator=generator, device=generator.device)
    return torch.complex(g[..., 0], g[..., 1])


def _steer(g: torch.Tensor, cfg: ChannelConfig) -> torch.Tensor:
    """Per-tap gains (..., T) or (..., T, S) -> frequency response (..., nsc)
    or (..., S, nsc): sum over taps of gain x steering, tap by tap."""
    steer = _steer_on(g.device, cfg.profile, cfg.nof_sc, cfg.scs)
    if g.dim() == 3:
        return sum(g[..., n, None] * steer[n] for n in range(steer.shape[0]))
    return sum(g[..., n, :, None] * steer[n] for n in range(steer.shape[0]))


def draw_channel(generator: torch.Generator, cfg: ChannelConfig) -> torch.Tensor:
    """Random frequency response (nrx, ntx, nsc) complex64 on the
    generator's device: unit average power per (rx, tx) pair, or under the
    "fixed" convention the reference emulator's normalization 1/sqrt(nrx)."""
    amp = _amp_on(generator.device, cfg.profile, cfg.nof_sc, cfg.scs)
    g = _complex_normal((cfg.nof_rx_ports, cfg.nof_tx_ports, amp.shape[0]), generator)
    g = g / np.sqrt(2) * amp
    if cfg.noise_convention == "fixed":
        g = g / np.sqrt(float(cfg.nof_rx_ports))
    return _steer(g, cfg)


@functools.lru_cache(maxsize=None)
def _symbol_times_s(scs: SubcarrierSpacing, nof_symbols: int = 14) -> np.ndarray:
    """Per-symbol start times in seconds, cyclic prefixes included."""
    mu = int(scs)
    sym_s = 1.0 / (scs_khz(scs) * 1e3)
    t = np.zeros(nof_symbols)
    acc = 0.0
    for l in range(nof_symbols):
        cp_frac = 144.0 / 2048.0 + (16.0 / 2048.0 * (1 << mu) if l % (7 << mu) == 0 else 0.0)
        acc += cp_frac * sym_s
        t[l] = acc
        acc += sym_s
    return t


def draw_channel_doppler(generator: torch.Generator, cfg: ChannelConfig,
                         slot_index: int = 0) -> torch.Tensor:
    """Time-selective frequency response (nrx, ntx, nsym, nsc): per tap
    g(t) = 1/sqrt(N) sum_n exp(j (2 pi f_d cos(theta_n) t + phi_n)), with
    (theta, phi) drawn once, so one generator state gives a fading
    trajectory that is continuous across slots through ``slot_index``."""
    dev = generator.device
    amp = _amp_on(dev, cfg.profile, cfg.nof_sc, cfg.scs)
    shape = (cfg.nof_rx_ports, cfg.nof_tx_ports, amp.shape[0], cfg.nof_sinusoids)
    theta = torch.rand(shape, generator=generator, device=dev) * (2 * np.pi)
    phi = torch.rand(shape, generator=generator, device=dev) * (2 * np.pi)
    slot_s = 1e-3 / (1 << int(cfg.scs))
    t = torch.as_tensor(_symbol_times_s(cfg.scs) + slot_index * slot_s, dtype=torch.float32,
                        device=dev)
    w = 2 * np.pi * cfg.doppler_hz * torch.cos(theta)
    ph = w[..., None, :] * t[:, None] + phi[..., None, :]  # (..., T, nsym, N)
    g = torch.polar(torch.ones_like(ph), ph).sum(dim=-1) / np.sqrt(cfg.nof_sinusoids)
    return _steer(g * amp[:, None], cfg)


def _apply_h(grid: torch.Tensor, h: torch.Tensor) -> torch.Tensor:
    """(ntx, nsym, nsc) grid through (nrx, ntx, nsc) or (nrx, ntx, nsym,
    nsc) responses -> (nrx, nsym, nsc): one multiply-add per tx port."""
    hh = h[:, :, None, :] if h.dim() == 3 else h
    return sum(hh[:, t] * grid[t] for t in range(grid.shape[0]))


def _cfo_phases(cfg: ChannelConfig, nof_symbols: int, device: torch.device) -> torch.Tensor:
    """(nsym,) complex64 CFO rotation at the CP-cumulative symbol starts."""
    t = torch.as_tensor(_symbol_times_s(cfg.scs, nof_symbols), dtype=torch.float32, device=device)
    ph = 2 * np.pi * cfg.cfo_hz * t
    return torch.polar(torch.ones_like(ph), ph)


def _noise_var(rx: torch.Tensor, cfg: ChannelConfig) -> torch.Tensor:
    """The noise variance for the configured SINR: against the faded
    signal's mean power, or against the unit signal ("fixed")."""
    if cfg.noise_convention == "fixed":
        sig_pow = torch.ones((), dtype=torch.float32, device=rx.device)
    else:
        sig_pow = (rx.abs() ** 2).mean()
    return sig_pow / (10.0 ** (cfg.sinr_db / 10.0))


def apply_channel(grid: torch.Tensor, generator: torch.Generator, cfg: ChannelConfig,
                  slot_index: int = 0):
    """(ntx, nsym, nsc) grid -> (rx (nrx, nsym, nsc) faded + AWGN grid, h,
    noise variance (0-dim tensor)).  h is (nrx, ntx, nsc) for block fading
    or (nrx, ntx, nsym, nsc) with Doppler.  ``generator`` lives on the
    grid's device; the channel is drawn first, then the noise."""
    _check_generator(generator, grid.device)
    if cfg.doppler_hz:
        h = draw_channel_doppler(generator, cfg, slot_index)
    else:
        h = draw_channel(generator, cfg)
    rx = _apply_h(grid.to(torch.complex64), h)
    if cfg.cfo_hz:
        rx = rx * _cfo_phases(cfg, grid.shape[-2], rx.device)[None, :, None]
    nvar = _noise_var(rx, cfg)
    noise = _complex_normal(rx.shape, generator) * torch.sqrt(nvar / 2)
    return rx + noise, h, nvar


# ---- the time-domain TDL (baseband sample streams) ---------------------------

@functools.lru_cache(maxsize=None)
def _time_taps(profile: str, srate_hz: float):
    """(tap delays in samples, rounded to the sample grid; tap amplitudes
    sqrt(p / 2) float32, p the tap powers normalized to unit total)."""
    taps = PROFILES[profile]
    delays_s = np.asarray([t[0] for t in taps], np.float64) * 1e-9
    p = 10.0 ** (np.asarray([t[1] for t in taps], np.float64) / 10.0)
    p = p / p.sum()
    delays = np.round(delays_s * srate_hz).astype(np.int32)
    return tuple(int(d) for d in delays), np.sqrt(p / 2.0).astype(np.float32)


_time_amp_on = device_table(lambda profile, srate_hz: _time_taps(profile, srate_hz)[1])


def draw_channel_time(generator: torch.Generator, cfg: ChannelConfig,
                      srate_hz: float) -> torch.Tensor:
    """Rayleigh tap gains (nrx, ntx, T) complex64 on the generator's device:
    CN(0, p_n) per tap of the profile."""
    amp = _time_amp_on(generator.device, cfg.profile, float(srate_hz))
    return _complex_normal((cfg.nof_rx_ports, cfg.nof_tx_ports, amp.shape[0]), generator) * amp


def apply_channel_time_taps(samples: torch.Tensor, gains: torch.Tensor, noise: torch.Tensor,
                            cfg: ChannelConfig, srate_hz: float) -> torch.Tensor:
    """The applying part of ``apply_channel_time``: (ntx, nsamples) samples
    through the sparse FIR of ``gains`` (nrx, ntx, T) at the profile's
    delays (one zero-padded shift per tap, summed over the transmit ports
    by multiply-adds), plus ``noise`` (nrx, nsamples), a unit complex
    normal (real and imaginary parts N(0, 1)), scaled to the configured
    SINR against the faded signal's mean power."""
    delays, _ = _time_taps(cfg.profile, float(srate_hz))
    x = samples.to(torch.complex64)
    n = x.shape[-1]
    out = torch.zeros((gains.shape[0], n), dtype=torch.complex64, device=x.device)
    for ti, d in enumerate(delays):
        shifted = torch.cat([x.new_zeros((x.shape[0], d)), x], dim=-1)[:, :n]
        out = out + sum(gains[:, t, ti, None] * shifted[t] for t in range(x.shape[0]))
    sig_pow = (out.abs() ** 2).mean()
    nstd = torch.sqrt(sig_pow * 10.0 ** (-cfg.sinr_db / 10.0) / 2.0)
    return out + noise.to(torch.complex64) * nstd


def apply_channel_time(samples: torch.Tensor, generator: torch.Generator, cfg: ChannelConfig,
                       srate_hz: float) -> torch.Tensor:
    """Time-domain TDL channel for baseband sample streams (the RU / lower
    PHY path): per-tap Rayleigh gains at the TS 38.104 delay profile
    applied as a sparse FIR per (rx, tx) pair, the delays rounded to the
    sample grid, then AWGN at the configured SINR.  (ntx, nsamples)
    complex64 -> (nrx, nsamples).  ``generator`` lives on the samples'
    device; the gains are drawn first, then the noise.  The frequency-domain
    ``apply_channel`` is the per-slot-grid equivalent; this one runs true
    multipath through the OFDM cyclic prefix."""
    _check_generator(generator, samples.device)
    gains = draw_channel_time(generator, cfg, srate_hz)
    noise = _complex_normal((cfg.nof_rx_ports, samples.shape[-1]), generator)
    return apply_channel_time_taps(samples, gains, noise, cfg, srate_hz)
