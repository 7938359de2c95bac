"""Polar encoder + rate matcher (TS 38.212 §5.3.1.1 / §5.4.1), batched.

Port of ``srsran_project_tpu/ops/polar/encoder.py``: place the message
(and parity-check) bits into the reliable positions, apply the butterfly
transform x = u F^{xor n}, gather the rate-matched output; and the
receive side's rate dematch of LLRs.  The transform is one float32 matmul
against the host's 0/1 generator matrix, reduced mod 2: every product is
0 or 1 and every sum an integer count <= N, so it is exact (also under
TF32, whose mantissa holds 0 and 1 exactly and which accumulates in
float32).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .._tables import device_table
from . import code as code_mod
from . import tables


@functools.lru_cache(maxsize=None)
def _transform_matrix(n: int) -> np.ndarray:
    """(N, N) 0/1 matrix G with x = u G mod 2: the XOR butterfly stages
    applied to the identity."""
    x = np.eye(n, dtype=np.uint8)
    step = 1
    while step < n:
        xs = x.reshape(n, n // (2 * step), 2, step)
        xs[:, :, 0, :] ^= xs[:, :, 1, :]
        step *= 2
    return x.astype(np.float32)


_transform_on = device_table(_transform_matrix)


def _gf2(x: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """(x @ m) mod 2 of 0/1 x (any dtype) and a 0/1 float32 matrix, as
    bool."""
    return (x.to(torch.float32) @ m) % 2 != 0


def polar_transform(u: torch.Tensor) -> torch.Tensor:
    """x = u F^{xor n} over GF(2); u: (..., N) 0/1.  Self-inverse."""
    return _gf2(u, _transform_on(u.device, u.shape[-1])).to(torch.uint8)


_index_on = device_table(lambda idx: np.asarray(idx, dtype=np.int64))
_pc_masks_on = device_table(lambda code: code_mod.pc_masks(code).T.astype(np.float32))
_rm_on = device_table(lambda code: code_mod.rate_match_indices(code).astype(np.int64))
_il_on = device_table(lambda k: tables.input_interleaver(k).astype(np.int64))


def encode(msg: torch.Tensor, code: code_mod.PolarCode,
           interleave_input: bool = False) -> torch.Tensor:
    """(..., K) message bits -> (..., E) rate-matched coded bits.

    interleave_input: True for DL (PDCCH/PBCH, I_IL = 1)."""
    dev = msg.device
    msg = msg.to(torch.uint8)
    if interleave_input:
        msg = msg[..., _il_on(dev, code.k)]
    u = torch.zeros(msg.shape[:-1] + (code.nval,), dtype=torch.uint8, device=dev)
    u[..., _index_on(dev, code.info_set)] = msg
    if code.pc_set:
        # PC bits are static GF(2) combinations of the message bits.
        u[..., _index_on(dev, code.pc_set)] = _gf2(msg, _pc_masks_on(dev, code)).to(torch.uint8)
    return polar_transform(u)[..., _rm_on(dev, code)]


@functools.lru_cache(maxsize=None)
def _dematch_plan(code: code_mod.PolarCode) -> np.ndarray:
    """(reps, N) indices into the (E + 1) LLRs padded with one zero: the
    LLRs that land on each of the N positions, in transmission order (index
    E, the zero, where fewer land)."""
    sel = code_mod.rate_match_indices(code)
    n, e = code.nval, code.e
    reps = max(1, -(-e // n)) if code.rm_mode == "repetition" else 1
    plan = np.full((reps, n), e, dtype=np.int64)
    count = np.zeros(n, dtype=np.int64)
    for j, pos in enumerate(sel):
        plan[count[pos], pos] = j
        count[pos] += 1
    return plan


_dematch_on = device_table(_dematch_plan)
_known_on = device_table(lambda code: np.setdiff1d(
    np.arange(code.nval), code_mod.rate_match_indices(code)).astype(np.int64))


def rate_dematch_llrs(llrs: torch.Tensor, code: code_mod.PolarCode) -> torch.Tensor:
    """(..., E) float LLRs -> (..., N) decoder-input LLRs.

    Repetition adds the copies of a position in transmission order (as the
    reference's scatter-add does); puncturing leaves untransmitted bits at
    0 (unknown); shortening sets them to 1e9 (known zero)."""
    dev = llrs.device
    plan = _dematch_on(dev, code)
    x = torch.nn.functional.pad(llrs.to(torch.float32), (0, 1))
    out = x[..., plan[0]]
    for r in range(1, plan.shape[0]):
        out = out + x[..., plan[r]]
    if code.rm_mode == "shortening":
        out[..., _known_on(dev, code)] = 1e9
    return out
