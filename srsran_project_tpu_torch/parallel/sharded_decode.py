"""Codeblock-sharded LDPC decoding across the ranks of a mesh.

Port of ``srsran_project_tpu/parallel/sharded_decode.py``.  The north
star's "per-codeword LDPC work balanced across chips": a transport block's
codeblocks are embarrassingly parallel, so the (C, N) LLR batch shards
along a mesh axis and each rank decodes its slice with
``ops.ldpc.decoder.decode`` (kernel K2 on a CUDA tensor, the whole budget
with no early stop, as the reference's decoder runs it); the per-TB CRC
verdict needs one ``all_reduce`` of per-shard failure counts.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import crc as crc_mod
from ..ops.ldpc import decoder as ldpc_decoder
from .mesh import axis as mesh_axis, device_of


def decode_codeblocks_sharded(llrs: torch.Tensor, bg: int, z: int, mesh,
                              nof_iterations: int = 6, axis="dp"):
    """Decode this rank's (C/n, N) slice of the codeblock LLRs, C sharded
    over ``axis`` (a mesh axis name or a tuple of axes, e.g. ("host",
    "dp") to span hosts).

    Returns (this rank's bits (C/n, K) uint8, the number of CRC24B
    failures over every shard (a 0-dim int32 tensor, all-reduced)).  Pad C
    to a multiple of the axis size with zero-LLR codeblocks upstream
    (``shard_codeblocks``)."""
    bits, _app, _iters = ldpc_decoder.decode(llrs, bg, z, nof_iterations, bits_only=True)
    c = crc_mod.crc(bits, "24B").to(torch.int32)
    bad_local = (c.sum(dim=-1) > 0).to(torch.int32).sum()
    return bits, mesh_axis(mesh, axis).all_reduce(bad_local)


def shard_codeblocks(llrs, mesh, axis="dp"):
    """Pad C to a multiple of the axis size and keep this rank's slice:
    (llrs (C, N) numpy array or tensor) -> (the (C_pad/n, N) slice on the
    mesh's device, C)."""
    ax = mesh_axis(mesh, axis)
    x = torch.as_tensor(np.asarray(llrs) if not isinstance(llrs, torch.Tensor) else llrs)
    c = x.shape[0]
    pad = (-c) % ax.size
    x = torch.cat([x, x.new_zeros((pad,) + tuple(x.shape[1:]))]) if pad else x
    per = x.shape[0] // ax.size
    return x[ax.index * per : (ax.index + 1) * per].to(device_of(mesh)), c
