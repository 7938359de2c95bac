"""UCI encoding/decoding (TS 38.212 §6.3): HARQ-ACK / CSI payload codecs.

Port of ``srsran_project_tpu/ops/uci.py``: payloads of 1-11 bits use the
short-block code; 12-19 bits CRC6-aided polar with 3 parity-check bits;
20 and more CRC11-aided polar; payloads of 360 bits and more on 1088 coded
bits and more split into two segments (TS 38.212 §6.3.1.2.1).  Polar
codewords go through the UL triangular channel interleaver; the receive
side undoes it with a gather through the inverse permutation (a host
plan), so no scatter runs on the device.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import crc as crc_mod
from . import polar, short_block
from ._tables import device_table
from .polar import code as polar_code_mod


def _crc_name(k: int) -> str | None:
    if k <= 11:
        return None
    return "6" if k <= 19 else "11"


@functools.lru_cache(maxsize=None)
def _uci_code(k: int, e: int) -> polar.PolarCode:
    crc_len = 6 if k <= 19 else 11
    if k <= 19:
        # 12 <= A <= 19: 3 PC bits, one of minimal row weight when the
        # rate-matched budget is large (TS 38.212 §6.3.1.3.1 / §5.3.1.2).
        n_pc_wm = 1 if e - (k + crc_len) + 3 > 192 else 0
        return polar.construct(k + crc_len, e, n_max=10, n_pc=3, n_pc_wm=n_pc_wm)
    return polar.construct(k + crc_len, e, n_max=10)


def _is_segmented(k: int, e: int) -> bool:
    """Two polar segments for large payloads (TS 38.212 §6.3.1.2.1)."""
    return k >= 360 and e >= 1088


_perm_on = device_table(lambda e: polar_code_mod.channel_interleaver_pattern(e).astype(np.int64))
_inv_perm_on = device_table(
    lambda e: np.argsort(polar_code_mod.channel_interleaver_pattern(e)).astype(np.int64))


def encode_uci(bits: torch.Tensor, e: int) -> torch.Tensor:
    """(..., K) UCI payload -> (..., E) coded bits."""
    k = bits.shape[-1]
    bits = bits.to(torch.uint8)
    if k <= 11:
        return short_block.encode(bits, e)
    if _is_segmented(k, e):
        # Two segments (zero-prepended if K is odd), each with its own CRC
        # and polar code of length E/2, concatenated.
        kseg = -(-k // 2)
        x = torch.nn.functional.pad(bits, (2 * kseg - k, 0))
        segs = x.reshape(x.shape[:-1] + (2, kseg))
        coded = polar.encode(crc_mod.crc_append(segs, _crc_name(kseg)), _uci_code(kseg, e // 2))
        coded = coded[..., _perm_on(bits.device, e // 2)]
        return coded.reshape(coded.shape[:-2] + (e,))
    coded = polar.encode(crc_mod.crc_append(bits, _crc_name(k)), _uci_code(k, e))
    return coded[..., _perm_on(bits.device, e)]


def decode_uci(llrs: torch.Tensor, k: int):
    """(..., E) LLRs -> (bits (..., K) uint8, ok (...,) bool)."""
    e = llrs.shape[-1]
    if k <= 11:
        bits, metric = short_block.detect(llrs, k, e)
        return bits, metric > 0.2
    llrs = llrs.to(torch.float32)
    if _is_segmented(k, e):
        kseg = -(-k // 2)
        code = _uci_code(kseg, e // 2)
        x = llrs.reshape(llrs.shape[:-1] + (2, e // 2))
        u = polar.decode(polar.rate_dematch_llrs(x[..., _inv_perm_on(llrs.device, e // 2)], code),
                         code)
        ok = crc_mod.crc_check(u, _crc_name(kseg)).all(dim=-1)
        bits = u[..., :kseg].reshape(u.shape[:-2] + (2 * kseg,))
        return bits[..., 2 * kseg - k :], ok
    code = _uci_code(k, e)
    u = polar.decode(polar.rate_dematch_llrs(llrs[..., _inv_perm_on(llrs.device, e)], code), code)
    return u[..., :k], crc_mod.crc_check(u, _crc_name(k))
