"""The float PUSCH path's demap stage in one launch (kernel K5): max-log
LLRs, int8 quantization, descrambling and the lanes' squared distances to
the nearest constellation point.

``demap_llrs`` is the entry point: a CUDA tensor launches the hand-written
kernel (``csrc/demap_llrs.cu``), a CPU tensor runs ``demap_llrs_plain``
below, the eager composition ``phy/pusch._demap_stage`` ran before the
kernel: ``demap_soft``, the (B, L, ., qm) -> (B, G) re-layout,
``quantize_llr``, the descrambling sign flip and the per-lane distance of
``evm``.  Both give the same numbers bit for bit.  Per lane j = r*L + l
(data RE r, layer l) of a slot:

* 16/64/256QAM: per axis the closed-form max-log LLR of each bit label
  (the difference of the two min trees of squared distances to the PAM
  levels) times 1 / eq_nvar; QPSK: 2 sqrt(2) x / eq_nvar;
* q = clip(round(llr * 120 / range_limit), +-120), rounded half to even,
  negated where its Gold bit c[j*qm + t] is 1, at position j*qm + t of
  the (B, G) stream: the codeword order, I and Q bits interleaved;
* err2[j]: the squared distance to the nearest constellation point.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib, scrambling
from .modulation.demapper import LLR_MAX, demap_soft, quantize_llr
from .modulation.evm import nearest_err2
from .modulation.mapper import Modulation, bits_per_symbol, check_square_qam


def _check(x_hat, eq_nvar, c, mod: Modulation):
    """Validate the shapes and types -> (B, ndata, L, qm)."""
    qm = check_square_qam(mod)
    if x_hat.dim() != 3:
        raise ValueError(f"demap_llrs: want x_hat (B, ndata, L), got {tuple(x_hat.shape)}")
    b, n, l = x_hat.shape
    want = {"x_hat": (x_hat, (b, n, l), torch.complex64),
            "eq_nvar": (eq_nvar, (b, n, l), torch.float32),
            "c": (c, (b, n * l * qm), torch.uint8)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != x_hat.device:
            raise ValueError(f"demap_llrs: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} {dtype} on {x_hat.device}")
    return b, n, l, qm


def quantized_llrs(x_hat: torch.Tensor, eq_nvar: torch.Tensor, mod: Modulation,
                   range_limit: float = 20.0) -> torch.Tensor:
    """The float demapper's int8 LLRs of (B, ndata, L) symbols and noise
    variances, any modulation, before descrambling -> (B, ndata*L*qm) in
    the codeword order: ``demap_soft`` per layer, re-laid RE-major."""
    b, _, l = x_hat.shape
    llr = demap_soft(x_hat.transpose(1, 2), eq_nvar.transpose(1, 2), mod)
    llr = llr.reshape(b, l, -1, bits_per_symbol(mod)).transpose(1, 2).reshape(b, -1)
    return quantize_llr(llr, range_limit)


def demap_llrs_plain(x_hat: torch.Tensor, eq_nvar: torch.Tensor, c: torch.Tensor,
                     mod: Modulation, range_limit: float = 20.0):
    """Plain torch version of ``demap_llrs`` (same arguments)."""
    b = _check(x_hat, eq_nvar, c, mod)[0]
    llr_i8 = scrambling.flip_llrs(quantized_llrs(x_hat, eq_nvar, mod, range_limit), c)
    return llr_i8, nearest_err2(x_hat.reshape(b, -1), mod)


def demap_llrs(x_hat: torch.Tensor, eq_nvar: torch.Tensor, c: torch.Tensor,
               mod: Modulation, range_limit: float = 20.0):
    """Max-log demap + int8 quantize + descramble, and the EVM distances.

    x_hat: (B, ndata, L) complex64 equalized symbols and eq_nvar (B, ndata,
    L) f32 their noise variances, in data-RE order; c: (B, ndata*L*qm)
    uint8 Gold sequence in stream order, as ``scrambling.gold_sequence``
    returns it; mod: QPSK or 16/64/256QAM.
    Returns (llr_i8 (B, ndata*L*qm) int8, positive = bit 0, descrambled,
    bit t of lane j = r*L + l at j*qm + t; err2 (B, ndata*L) f32 squared
    distances to the nearest point, in ``x_hat.reshape(B, -1)``'s order).

    CUDA tensor: kernel K5 (one launch; 1-4 layers, contiguous 16-byte
    aligned inputs); CPU tensor: the plain version."""
    if x_hat.device.type == "cpu":
        return demap_llrs_plain(x_hat, eq_nvar, c, mod, range_limit)
    if x_hat.device.type != "cuda":
        raise ValueError(f"demap_llrs: unsupported device {x_hat.device}")
    b, n, l, qm = _check(x_hat, eq_nvar, c, mod)
    if l > 4:
        raise ValueError(f"demap_llrs: {l} layers (the kernel takes 1 to 4)")
    for name, t in (("x_hat", x_hat), ("eq_nvar", eq_nvar), ("c", c)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"demap_llrs: {name} must be contiguous and 16-byte aligned")
    dev = x_hat.device
    llr = torch.empty((b, n * l * qm), dtype=torch.int8, device=dev)
    err2 = torch.empty((b, n * l), dtype=torch.float32, device=dev)
    if llr.numel() == 0:
        return llr, err2
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.demap_llrs(
            x_hat.data_ptr(), eq_nvar.data_ptr(), c.data_ptr(), b * n, l, qm,
            float(np.float32(LLR_MAX / range_limit)), llr.data_ptr(), err2.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "demap_llrs")
    demap_llrs.launches += 1
    return llr, err2


demap_llrs.launches = 0


def occupancy(mod: Modulation, nof_layers: int) -> dict:
    """K5's registers a thread and resident 128-thread blocks per SM for
    one constellation and layer count, by the CUDA occupancy calculator
    on the current device."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().demap_llrs_occupancy(
        int(mod), nof_layers, ctypes.byref(regs), ctypes.byref(blocks)), "demap_llrs_occupancy")
    return {"registers": regs.value, "blocks_per_sm": blocks.value}
