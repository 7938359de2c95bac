"""Polar decoder: simplified successive cancellation (SSC), batched.

Port of ``srsran_project_tpu/ops/polar/decoder.py``.  The code tree is
walked once per ``PolarCode`` on the host into a plan (``_plan``):
all-frozen subtrees emit zeros, rate-1 subtrees collapse to a hard
decision plus the polar transform (exact for SC), parity-check positions
(UCI 12 <= A <= 19) become leaves whose decision is the XOR of the
earlier message bits of the same mod-5 residue, and only mixed nodes run
the f/g stages.  ``decode`` runs that plan over a leading batch: every
codeword of a call (all grants of a config group, both segments of a
segmented payload) goes through the same launches.  ``_f`` and ``_g`` use
only sign, min, abs and +-1 times a value, so the LLRs, and the bits, are
the reference's exactly.  Partial sums and decisions are kept as bool
tensors.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tables import device_table
from . import code as code_mod
from .encoder import _gf2, _transform_on


def _f(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Check-node LLR combine (min-sum approximation)."""
    return torch.sign(a) * torch.sign(b) * torch.minimum(a.abs(), b.abs())


def _g(a: torch.Tensor, b: torch.Tensor, u_left: torch.Tensor) -> torch.Tensor:
    """Variable-node combine given the (bool) left partial sum:
    b + (1 - 2u) a."""
    return torch.where(u_left, b - a, b + a)


@functools.lru_cache(maxsize=None)
def _plan(code: code_mod.PolarCode):
    """The pruned code tree as nested tuples: ("zero", size), ("info", lo),
    ("pc", lo), ("rate1", lo, size), ("mixed", size, left, right)."""
    nval = code.nval
    frozen = np.ones(nval, dtype=bool)
    frozen[np.asarray(code.info_set)] = False
    pc = frozenset(code.pc_set)

    def build(lo: int, size: int):
        has_pc = any(lo <= q < lo + size for q in pc)
        if frozen[lo : lo + size].all() and not has_pc:
            return ("zero", size)
        if size == 1:
            return ("pc", lo) if lo in pc else ("info", lo)
        if not frozen[lo : lo + size].any() and not has_pc:
            return ("rate1", lo, size)
        half = size // 2
        return ("mixed", size, build(lo, half), build(lo + half, half))

    return build(0, nval)


def _residue_matrix(lo: int, size: int) -> np.ndarray:
    """(size, 5) 0/1: column r selects the positions lo + j = r (mod 5)."""
    m = np.zeros((size, 5), dtype=np.float32)
    m[np.arange(size), (lo + np.arange(size)) % 5] = 1.0
    return m


_residue_on = device_table(_residue_matrix)
_info_on = device_table(lambda code: np.asarray(code.info_set, dtype=np.int64))


def decode(llrs: torch.Tensor, code: code_mod.PolarCode) -> torch.Tensor:
    """(..., N) LLRs (positive = bit 0) -> (..., K) message bits.

    With PC bits the decoder tracks five batched accumulators, acc[r] =
    XOR of the decoded message bits at positions p = r (mod 5) so far, and
    forces each PC decision to its residue's accumulator (dynamically
    frozen SC)."""
    nval = code.nval
    if llrs.shape[-1] != nval:
        raise ValueError(f"polar decode: want (..., {nval}) LLRs, got {tuple(llrs.shape)}")
    dev = llrs.device
    batch = llrs.shape[:-1]
    zeros = torch.zeros(batch + (nval,), dtype=torch.bool, device=dev)
    with_pc = bool(code.pc_set)
    acc = torch.zeros(batch + (5,), dtype=torch.bool, device=dev) if with_pc else None
    parts: list[torch.Tensor] = []

    def run(node, llr):
        nonlocal acc
        kind = node[0]
        if kind == "zero":
            u = zeros[..., : node[1]]
            parts.append(u)
            return u
        if kind == "pc":
            u = acc[..., node[1] % 5 : node[1] % 5 + 1]
            parts.append(u)
            return u
        if kind == "info":
            u = llr < 0
            parts.append(u)
            if with_pc:
                r = node[1] % 5
                acc = torch.cat([acc[..., :r], acc[..., r : r + 1] ^ u, acc[..., r + 1 :]], dim=-1)
            return u
        if kind == "rate1":
            x = llr < 0
            u = _gf2(x, _transform_on(dev, node[2]))  # the polar transform
            parts.append(u)
            if with_pc:
                acc = acc ^ _gf2(u, _residue_on(dev, node[1], node[2]))
            return x
        _, size, left_node, right_node = node
        half = size // 2
        a, b = llr[..., :half], llr[..., half:]
        if left_node[0] == "zero":
            # An all-frozen left half decides nothing from f(a, b), and its
            # zero partial sums make g(a, b, 0) = b + a.
            run(left_node, None)
            right = run(right_node, b + a)
            return torch.cat([right, right], dim=-1)
        left = run(left_node, _f(a, b))
        right = run(right_node, _g(a, b, left))
        return torch.cat([left ^ right, right], dim=-1)

    run(_plan(code), llrs.to(torch.float32))
    return torch.cat(parts, dim=-1)[..., _info_on(dev, code)].to(torch.uint8)
