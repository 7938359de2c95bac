"""The PUSCH DM-RS channel estimate of the fast estimator and its
second-difference noise in one call (kernel K7).

``estimate`` is the entry point: a CUDA tensor launches the hand-written
kernel (``csrc/pusch_estimate.cu``, two launches), a CPU tensor runs
``estimate_plain`` below, the eager composition ``phy/pusch._estimate_fast``
ran before the kernel: the pilot gather, ``estimator.estimate_h`` (LS, the
CDM pair despread, the time mean over the DM-RS symbols, the bulk-delay
derotation, the 9-tap smoothing, the interpolation and the re-rotation) and
``second_difference_noise``.  K7 computes the bulk-delay slope once for
both; the plain version, as the eager chain did, twice on the same values.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib
from .estimator import _interp_on, _rc_filter_taps, estimate_h


def second_difference_noise(h_pair: torch.Tensor, nsym_d: int, beta2: float) -> torch.Tensor:
    """Noise from (1, -2, 1) second differences of the OCC-despread pair
    estimates (B, nl, P, nsym_d, Np/2): the co-CDM layer is removed
    exactly and the channel's level and slope cancel; the bulk delay is
    derotated first so that curvature from a fast phase ramp does not read
    as noise.  Returns (B,)."""
    h_pair = h_pair.mean(dim=-2)  # (B, nl, P, NpPairs)
    npair = h_pair.shape[-1]
    slope = torch.angle(torch.sum(h_pair[..., 1:] * h_pair[..., :-1].conj(), dim=-1,
                                  keepdim=True))
    ramp = torch.arange(npair, dtype=torch.float32, device=h_pair.device)
    h_pair = h_pair * torch.polar(torch.ones_like(slope), -slope * ramp)
    d2 = h_pair[..., 2:] - 2.0 * h_pair[..., 1:-1] + h_pair[..., :-2]
    nv = (d2.abs() ** 2).reshape(h_pair.shape[0], -1).mean(dim=-1) * nsym_d / 3.0 * beta2
    return torch.clamp_min(nv, 1e-10)


@functools.lru_cache(maxsize=None)
def _plan_on(device: torch.device, pair_positions: tuple, nof_sc: int) -> tuple:
    """The interpolation plan's four device tables (left, right, fraction,
    coordinate) in one lookup: hashing the pair positions is most of a
    lookup's host time."""
    return tuple(_interp_on(device, pair_positions, nof_sc, i) for i in range(4))


@functools.lru_cache(maxsize=None)
def _taps_address() -> int:
    """Host address of the smoothing taps (``_rc_filter_taps``' cached
    array, alive for the process): ``ndarray.ctypes`` costs more host time
    than the rest of a launch's arguments."""
    return _rc_filter_taps().ctypes.data


def _check(grid, idx_all, r_all, wf, pair_positions, nof_sc):
    """Validate the shapes, types and devices -> (B, P, nl, nsym_d, Np)."""
    if grid.dim() != 4 or grid.dtype != torch.complex64:
        raise ValueError(f"pusch_estimate: want grid (B, P, nsym, nsc) complex64, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    b, p, nsym, nsc = grid.shape
    if r_all.dim() != 4:
        raise ValueError(f"pusch_estimate: want r_all (1 or B, nl, nsym_d, Np), got "
                         f"{tuple(r_all.shape)}")
    rb, nl, nsym_d, np_ = r_all.shape
    want = {"idx_all": (idx_all, (nl, nsym_d * np_), torch.int64),
            "r_all": (r_all, (1 if rb == 1 else b, nl, nsym_d, np_), torch.complex64),
            "wf": (wf, (nl, np_), torch.float32)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != grid.device:
            raise ValueError(f"pusch_estimate: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} {dtype} on {grid.device}")
    if np_ % 2 or len(pair_positions) != np_ // 2 or np_ // 2 < 3:
        raise ValueError(f"pusch_estimate: {np_} pilots a symbol and {len(pair_positions)} "
                         "pair positions: want an even count of pilots, two a pair, and at "
                         "least 3 pairs")
    if not 0 < nof_sc <= nsc:
        raise ValueError(f"pusch_estimate: nof_sc {nof_sc} outside the grid")
    return b, p, nl, nsym_d, np_


def estimate_plain(grid: torch.Tensor, idx_all: torch.Tensor, r_all: torch.Tensor,
                   wf: torch.Tensor, pair_positions: tuple, nof_sc: int, beta2: float):
    """Plain torch version of ``estimate`` (same arguments)."""
    b, npr, nl, nsym_d, _ = _check(grid, idx_all, r_all, wf, pair_positions, nof_sc)
    gf = grid.reshape(b, npr, -1)
    y_p = gf[:, :, idx_all].reshape(b, npr, nl, nsym_d, -1).transpose(1, 2)  # (B, nl, P, ...)
    h_l, _, h_pair = estimate_h(y_p, r_all[:, :, None], wf[:, None, None, :], pair_positions,
                                nof_sc)
    return h_l.permute(0, 2, 3, 1), second_difference_noise(h_pair, nsym_d, beta2)


def estimate(grid: torch.Tensor, idx_all: torch.Tensor, r_all: torch.Tensor, wf: torch.Tensor,
             pair_positions: tuple, nof_sc: int, beta2: float):
    """Channel estimate and second-difference noise of every (b, layer,
    port) sequence.

    grid: (B, P, nsym, nsc) complex64 received grids; idx_all (nl,
    nsym_d*Np) int64 flat pilot RE indices of a port's (nsym, nsc) block,
    layer-major; r_all (1 or B, nl, nsym_d, Np) complex64 pilot values
    without the OCC, descaled by the DM-RS boost; wf (nl, Np) float32 the
    layers' +-1 frequency OCC; pair_positions the CDM pair centres relative
    to the allocation (at least 3); nof_sc the allocation's subcarriers;
    beta2 the DM-RS boost squared, which refers the noise to the data REs.
    Returns (h (B, P, nof_sc, nl) complex64, noise_var (B,) float32).

    CUDA tensor: kernel K7 (two launches; the grid read through its
    strides, the tables contiguous, at most 1,024 pairs; h lies in memory
    as (B, nof_sc, P, nl), the layout the equalizer reads); CPU tensor:
    the plain version."""
    if grid.device.type == "cpu":
        return estimate_plain(grid, idx_all, r_all, wf, pair_positions, nof_sc, beta2)
    if grid.device.type != "cuda":
        raise ValueError(f"pusch_estimate: unsupported device {grid.device}")
    np_ = _check(grid, idx_all, r_all, wf, pair_positions, nof_sc)[4]
    if np_ // 2 > 1024:
        raise ValueError(f"pusch_estimate: {np_ // 2} pairs (the kernel takes at most 1,024)")
    for name, t in (("idx_all", idx_all), ("r_all", r_all), ("wf", wf)):
        if not t.is_contiguous():
            raise ValueError(f"pusch_estimate: {name} must be contiguous")
    with torch.cuda.device(grid.device):
        out = _launch(grid, idx_all, r_all, wf, pair_positions, nof_sc, beta2,
                      torch.cuda.current_stream(grid.device).cuda_stream)
    estimate.launches += 2
    return out


def _launch(grid, idx_all, r_all, wf, pair_positions, nof_sc, beta2, stream):
    """K7 on checked inputs, on ``stream`` -> (h as (B, P, nof_sc, nl) view
    of its (B, nof_sc, P, nl) memory, noise_var)."""
    (b, npr, _, _), (_, nl, nsym_d, np_) = grid.shape, r_all.shape
    dev = grid.device
    plan = _plan_on(dev, tuple(pair_positions), nof_sc)
    h = torch.empty((b, nof_sc, npr, nl), dtype=torch.complex64, device=dev)
    noise_var = torch.empty((b,), dtype=torch.float32, device=dev)
    partial = torch.empty((b, nl * npr), dtype=torch.float32, device=dev)
    status = cuda_lib.library().pusch_estimate(
        grid.data_ptr(), *grid.stride(), grid.shape[3], idx_all.data_ptr(), r_all.data_ptr(),
        r_all.shape[0], wf.data_ptr(), *(t.data_ptr() for t in plan),
        _taps_address(), b, npr, nl, nsym_d, np_, nof_sc,
        float(np.float32(beta2)), h.data_ptr(), partial.data_ptr(), noise_var.data_ptr(), stream)
    cuda_lib.check(status, "pusch_estimate")
    return h.transpose(1, 2), noise_var


estimate.launches = 0


def occupancy() -> dict:
    """K7's registers a thread and resident 256-thread blocks per SM, by
    the CUDA occupancy calculator on the current device."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().pusch_estimate_occupancy(
        ctypes.byref(regs), ctypes.byref(blocks)), "pusch_estimate_occupancy")
    return {"registers": regs.value, "blocks_per_sm": blocks.value}
