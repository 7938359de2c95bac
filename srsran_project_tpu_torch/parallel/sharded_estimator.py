"""Subcarrier-sharded channel estimation with halo exchange.

Port of ``srsran_project_tpu/parallel/sharded_estimator.py``.  The
north-star's sequence-parallel axis (SURVEY.md §5.7): a wide carrier's
subcarriers shard across ranks; per-RE work (LS, interpolation) is local,
and the only communication is the raised-cosine smoothing filter's halo at
shard boundaries — sent to and received from the neighbours on the axis's
process group with ``dist.batch_isend_irecv`` (the overlap-save pattern;
JAX's ``ppermute``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.estimator import _rc_filter_taps
from .mesh import Axis, axis as mesh_axis


def _real(x: torch.Tensor) -> torch.Tensor:
    return torch.view_as_real(x) if x.is_complex() else x


def _halo_exchange(x: torch.Tensor, halo: int, ax: Axis) -> torch.Tensor:
    """Append neighbours' edge columns: (..., n) -> (..., halo + n + halo).

    Edge shards replicate their own boundary (edge-hold, matching the
    single-device convolution's edge padding).  A group of one does no P2P
    at all (a send to self over NCCL hangs or raises): both sides hold.
    """
    from_left = x[..., :1].expand(x.shape[:-1] + (halo,)).contiguous()
    from_right = x[..., -1:].expand(x.shape[:-1] + (halo,)).contiguous()
    ops = []
    if ax.index > 0:  # the left neighbour's right edge, and ours to it
        left = ax.ranks[ax.index - 1]
        ops += [dist.P2POp(dist.isend, _real(x[..., :halo].contiguous()), left, ax.group),
                dist.P2POp(dist.irecv, _real(from_left), left, ax.group)]
    if ax.index < ax.size - 1:
        right = ax.ranks[ax.index + 1]
        ops += [dist.P2POp(dist.isend, _real(x[..., -halo:].contiguous()), right, ax.group),
                dist.P2POp(dist.irecv, _real(from_right), right, ax.group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([from_left, x, from_right], dim=-1)


def _fir(ext: torch.Tensor, taps, n: int) -> torch.Tensor:
    out = torch.zeros(ext.shape[:-1] + (n,), dtype=ext.dtype, device=ext.device)
    for i in range(len(taps)):
        out = out + float(taps[i]) * ext[..., i : i + n]
    return out


def smooth_freq_sharded(h_pilots: torch.Tensor, mesh, axis: str = "dp") -> torch.Tensor:
    """RC-filter smoothing of pilot estimates sharded along the last axis.

    h_pilots: this rank's (..., n_local) block of the (..., n_pilots)
    complex estimates, the last axis sharded over ``axis`` of the mesh.
    Returns this rank's block of the result, equal (up to float rounding)
    to its slice of ``smooth_freq_reference``.
    """
    taps = _rc_filter_taps()
    ext = _halo_exchange(h_pilots, len(taps) // 2, mesh_axis(mesh, axis))
    return _fir(ext, taps, h_pilots.shape[-1])


def smooth_freq_reference(h: torch.Tensor) -> torch.Tensor:
    """Single-device smoothing with the same edge handling (oracle)."""
    taps = _rc_filter_taps()
    halo = len(taps) // 2
    hp = torch.cat([h[..., :1].expand(h.shape[:-1] + (halo,)), h,
                    h[..., -1:].expand(h.shape[:-1] + (halo,))], dim=-1)
    return _fir(hp, taps, h.shape[-1])
