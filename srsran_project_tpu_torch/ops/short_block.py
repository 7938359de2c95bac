"""Short-block codes for UCI of 1-11 bits (TS 38.212 §5.3.3 / §5.4.3).

Port of ``srsran_project_tpu/ops/short_block.py``: K in [3, 11] uses the
RM(32, K) code of Table 5.3.3.3-1, K in {1, 2} the repetition / simplex
codes.  ``detect`` is ML detection: the repetitions fold back onto the
mother codeword, then every candidate codeword scores by its correlation
with the folded LLRs.  The correlation is a +-1 weighted sum over the
candidate's positions, computed as products and a sum (no matmul, so no
TF32 path): on integer LLRs (int8 from the PUSCH front end) every sum is
an integer below 2^24 and exact in any order, so the card and the CPU
agree bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ._tables import device_table

# TS 38.212 Table 5.3.3.3-1: 11 basis sequences M_{n,k} of length 32.
BASIS = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1],
        [1, 1, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 0, 1, 1, 1, 0, 1, 0, 0, 1, 0],
        [0, 1, 0, 1, 1, 0, 1, 0, 0, 1, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 1, 1, 0, 1, 1, 1, 1, 1, 0],
        [0, 0, 1, 1, 1, 0, 0, 1, 1, 1, 0, 0, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 0, 0, 1, 0, 1, 1, 0, 1, 1, 0],
        [0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 1, 0],
        [0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 1, 1, 1, 1, 1, 1, 0],
        [0, 0, 1, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 1, 1, 1, 0],
        [0, 0, 0, 0, 1, 1, 0, 1, 1, 0, 1, 0, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0, 1, 0, 1, 1, 0, 1, 0, 1, 1, 0],
        [0, 0, 1, 1, 0, 1, 1, 1, 0, 0, 0, 1, 1, 0, 0, 0, 0, 1, 0, 0, 0, 0, 1, 1, 1, 0, 1, 1, 1, 1, 1, 0],
        [0, 1, 1, 0, 0, 0, 1, 0, 1, 1, 1, 0, 1, 1, 0, 1, 1, 0, 0, 0, 0, 1, 0, 1, 1, 0, 1, 1, 0, 0, 1, 0],
        [1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 1, 1, 1, 1, 0, 1, 0, 0, 0, 0, 1, 0],
    ],
    dtype=np.uint8,
)


@functools.lru_cache(maxsize=None)
def _mother_codewords(k: int) -> np.ndarray:
    """(2^K, Ncode) all codewords of the K-bit short block code."""
    if k == 1:
        return np.array([[0], [1]], dtype=np.uint8)
    if k == 2:
        # Index decoding is LSB-first everywhere (matches detect()).
        msgs = np.array([[0, 0], [1, 0], [0, 1], [1, 1]], dtype=np.uint8)
        return np.stack([msgs[:, 0], msgs[:, 1], msgs[:, 0] ^ msgs[:, 1]], axis=1)
    idx = np.arange(1 << k)
    msgs = ((idx[:, None] >> np.arange(k)) & 1).astype(np.uint8)  # a_k LSB-first? see encode
    return (msgs @ BASIS[:k]) % 2


# Placeholder markers for K <= 2 (TS 38.212 §5.3.3.1/.2; reference
# short_block_encoder.h:40-45): "x" repeats the previous modulation symbol
# value, "y" repeats the previous bit after scrambling.
PLACEHOLDER_X = 255
PLACEHOLDER_Y = 254


def encode(msg: torch.Tensor, e: int, placeholders: bool = False) -> torch.Tensor:
    """(..., K) bits -> (..., E) coded bits (rate-matched by repetition).

    K = msg.shape[-1] in [1, 11]; for K in [3, 11] codeword
    d(n) = sum_k a_k M_{n,k} mod 2 (TS 38.212 §5.3.3.3).

    placeholders=True emits the spec's x/y markers (255/254) for K <= 2
    exactly like the reference encoder; E must then be Qm (K=1) or 3*Qm
    (K=2)."""
    k = msg.shape[-1]
    msg = msg.to(torch.uint8)
    if placeholders and k <= 2:
        out = torch.full(msg.shape[:-1] + (e,), PLACEHOLDER_X, dtype=torch.uint8,
                         device=msg.device)
        if k == 1:
            out[..., 0] = msg[..., 0]
            if e > 1:
                out[..., 1] = PLACEHOLDER_Y
            return out
        c2 = msg[..., 0] ^ msg[..., 1]
        out[..., 0] = msg[..., 0]
        out[..., 1] = msg[..., 1]
        if e == 3:
            out[..., 2] = c2
            return out
        step = e // 3
        out[..., step] = c2
        out[..., step + 1] = msg[..., 0]
        out[..., 2 * step] = msg[..., 1]
        out[..., 2 * step + 1] = c2
        return out
    if k == 1:
        base = msg
    elif k == 2:
        base = torch.cat([msg, msg[..., :1] ^ msg[..., 1:2]], dim=-1)
    else:
        basis = _basis_on(msg.device, k)
        base = ((msg.to(torch.float32) @ basis).to(torch.int32) & 1).to(torch.uint8)
    n = base.shape[-1]
    reps = -(-e // n)
    return base.repeat((1,) * (base.dim() - 1) + (reps,))[..., :e]


_basis_on = device_table(lambda k: BASIS[:k].astype(np.float32))
_signs_on = device_table(lambda k: 1.0 - 2.0 * _mother_codewords(k).astype(np.float32))
_msgs_on = device_table(
    lambda k: ((np.arange(1 << k)[:, None] >> np.arange(k)) & 1).astype(np.uint8))


def detect(llrs: torch.Tensor, k: int, e: int):
    """ML detection of a K-bit short block from (..., E) LLRs.

    Returns (bits (..., K) uint8, metric (...,) float32 in [0, 1]: the
    normalized correlation of the winning candidate)."""
    signs = _signs_on(llrs.device, k)  # (2^K, n)
    n = signs.shape[1]
    reps = -(-e // n)
    x = torch.nn.functional.pad(llrs.to(torch.float32), (0, reps * n - e))
    x = x.reshape(x.shape[:-1] + (reps, n))
    folded = x[..., 0, :]
    for r in range(1, reps):  # in transmission order, as the reference's sum
        folded = folded + x[..., r, :]
    scores = (folded[..., None, :] * signs).sum(dim=-1)  # (..., 2^K)
    best = torch.argmax(scores, dim=-1)
    bits = _msgs_on(llrs.device, k)[best]
    denom = folded.abs().sum(dim=-1) + 1e-9
    metric = torch.gather(scores, -1, best[..., None])[..., 0] / denom
    return bits, metric
