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
    # A gather: indexing by a 0-d tensor would read it on the host.
    bits = _msgs_on(llrs.device, k).index_select(0, best.reshape(-1)).reshape(best.shape + (k,))
    denom = folded.abs().sum(dim=-1) + 1e-9
    metric = torch.gather(scores, -1, best[..., None])[..., 0] / denom
    return bits, metric


def _sat_fold(x: torch.Tensor, n: int) -> torch.Tensor:
    """Fold (..., E) int32 LLRs onto n positions with the reference's
    saturated LLR sum, repetition by repetition: a == -b -> 0, a +-127
    operand passes through, else clip(a + b, +-120)."""
    reps = -(-x.shape[-1] // n)
    v = torch.nn.functional.pad(x, (0, reps * n - x.shape[-1]))
    blocks = v.reshape(v.shape[:-1] + (reps, n))
    out = blocks[..., 0, :]
    for r in range(1, reps):
        b = blocks[..., r, :]
        res = torch.where(b.abs() == 127, b, (out + b).clamp(-120, 120))
        res = torch.where(out.abs() == 127, out, res)
        out = torch.where(out == -b, torch.zeros_like(out), res)
    return out


_K2_TABLE = np.array([[1, 1, 1], [-1, 1, -1], [1, -1, -1], [-1, -1, 1]], np.float32)
_k2_table_on = device_table(lambda: _K2_TABLE)
_rm_signs_on = device_table(lambda k: 1.0 - 2.0 * (
    (((2 * np.arange(1 << (k - 1)))[:, None] >> np.arange(11)) & 1) @ BASIS % 2
).astype(np.float32))
# GLRT thresholds of the reference's detector, by K - 1.
REF_THRESHOLDS = (0, 0, 12, 14, 16, 18, 20, 22, 24, 26, 29)


def detect_ref(llrs: torch.Tensor, k: int, e: int, qm: int):
    """Reference-exact short-block detection on (..., E) int8-valued LLRs
    (short_block_detector_impl.cpp): the saturated fold onto the mother
    length (Qm for K = 1, 3 Qm for K = 2, 32 otherwise), the per-K
    detector and its GLRT threshold.  Returns (bits (..., K) uint8,
    ok (...,) bool), on the device of llrs.

    float32 throughout, as the reference computes it: the scores and norms
    are sums of integers below 2^24, exact in any order, and the metric is
    the same few rounded operations on both devices, so the card and the
    CPU agree bit for bit."""
    x = llrs.to(torch.int32)
    batch = x.shape[:-1]
    if k == 1:
        tmp = _sat_fold(x, max(qm, 1))
        bit = (tmp[..., 0] <= 0).to(torch.uint8)
        return bit[..., None], torch.ones(batch, dtype=torch.bool, device=x.device)
    if k == 2:
        n = 3 * qm if qm > 1 else 3
        x2 = _sat_fold(x, n)
        if n == 3:
            l0, l1, l2 = x2[..., 0], x2[..., 1], x2[..., 2]
        else:
            step = qm - 2
            l0 = x2[..., 0] + x2[..., step + 3]
            l1 = x2[..., 1] + x2[..., 2 * step + 4]
            l2 = x2[..., step + 2] + x2[..., 2 * step + 5]
        lv = torch.stack([l0, l1, l2], dim=-1).to(torch.float32)
        scores = (lv[..., None, :] * _k2_table_on(x.device)).sum(dim=-1)  # (..., 4)
        best = torch.argmax(scores, dim=-1)
        # Strict '>' against a tiny positive start: all-nonpositive -> 0.
        best = torch.where(scores.amax(dim=-1) > 0, best, torch.zeros_like(best))
        bits = torch.stack([best & 1, (best >> 1) & 1], dim=-1).to(torch.uint8)
        m = torch.gather(scores, -1, best[..., None])[..., 0]
        norm = (lv * lv).sum(dim=-1)
        metric = 2.0 * m * m / (3.0 * norm - m * m)
        return bits, metric > 0.0
    folded = _sat_fold(x, 32).to(torch.float32)
    scores = (folded[..., None, :] * _rm_signs_on(x.device, k)).sum(dim=-1)  # (..., 2^(K-1))
    absval = scores.abs()
    best = torch.argmax(absval, dim=-1)
    m = absval.amax(dim=-1)
    bit0 = (torch.gather(scores, -1, best[..., None])[..., 0] < 0).to(torch.int64)
    full_idx = 2 * best + bit0
    shifts = torch.arange(k, device=x.device)
    bits = ((full_idx[..., None] >> shifts) & 1).to(torch.uint8)
    norm = (folded * folded).sum(dim=-1)
    metric = 31.0 * m * m / (32.0 * norm - m * m)
    return bits, metric > REF_THRESHOLDS[k - 1]
