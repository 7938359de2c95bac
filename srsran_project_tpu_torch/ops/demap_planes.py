"""MMSE apply + max-log demap + int8 quantize + descramble into the LDPC
decoder's de-interleave bit-planes (kernel K4).

Port of ``demap_planes_pallas`` (srsran_project_tpu/ops/demap_pallas.py)
with a leading slot batch.  ``demap_planes`` is the entry point: a CUDA
tensor launches the hand-written kernel (``csrc/demap_planes.cu``), a CPU
tensor runs ``demap_planes_plain`` below.  Both compute, per lane (slot,
data symbol s, subcarrier n, layer l):

* x = sum_p w[n, l, p] y[p, s, n], as real multiply-adds in port order,
  each separately rounded;
* per axis the squared distances to the PAM levels, and per bit label the
  difference of the two min trees (the closed-form max-log LLR of
  ``demap_soft``);
* q = clip(round(llr * (1 / max(eq_nvar, 1e-12)) * 120 / range_limit),
  +-120), rounded half to even, times the descrambling sign 1 - 2c of its
  Gold bit c[j*qm + t] (j = (s*nsc + n)*L + l), written to plane t at
  position j;
* the squared distance to the nearest constellation point (for the
  decision-directed post-equalization SINR).

The TPU kernel's lane expansion (y repeated L times, re/im planes) was a
Mosaic layout workaround and is left out, and so are its f32 sign planes:
the port reads the uint8 Gold sequence in stream order, a quarter of the
bytes, with no transpose before the call.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib
from .modulation.demapper import LLR_MAX
from .modulation.mapper import Modulation, check_square_qam, pam_levels


def _check(y, w, eq_nvar, c, mod: Modulation):
    """Validate the shapes and types -> (B, P, S, N, L, qm)."""
    qm = check_square_qam(mod)
    if y.dim() != 4 or w.dim() != 4:
        raise ValueError(f"demap_planes: want y (B, P, S, N), w (B, N, L, P), got "
                         f"{tuple(y.shape)}, {tuple(w.shape)}")
    b, p, s, n = y.shape
    l = w.shape[2]
    want = {"y": (y, (b, p, s, n), torch.complex64), "w": (w, (b, n, l, p), torch.complex64),
            "eq_nvar": (eq_nvar, (b, n, l), torch.float32),
            "c": (c, (b, s * n * l * qm), torch.uint8)}
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape or t.dtype != dtype or t.device != y.device:
            raise ValueError(f"demap_planes: {name} is {tuple(t.shape)} {t.dtype} on "
                             f"{t.device}, want {shape} {dtype} on {y.device}")
    return b, p, s, n, l, qm


def demap_planes_plain(y: torch.Tensor, w: torch.Tensor, eq_nvar: torch.Tensor,
                       c: torch.Tensor, mod: Modulation, range_limit: float = 20.0):
    """Plain torch version of ``demap_planes`` (same arguments)."""
    b, p_, s, n, l, qm = _check(y, w, eq_nvar, c, mod)
    levels, labels = pam_levels(mod)
    lv = [float(np.float32(v)) for v in levels]
    yr, yi = y.real[:, :, :, :, None], y.imag[:, :, :, :, None]  # (B, P, S, N, 1)
    wr, wi = w.real[:, None], w.imag[:, None]  # (B, 1, N, L, P)
    xr = wr[..., 0] * yr[:, 0] - wi[..., 0] * yi[:, 0]  # (B, S, N, L)
    xi = wr[..., 0] * yi[:, 0] + wi[..., 0] * yr[:, 0]
    for p in range(1, p_):
        xr = xr + wr[..., p] * yr[:, p] - wi[..., p] * yi[:, p]
        xi = xi + wr[..., p] * yi[:, p] + wi[..., p] * yr[:, p]
    inv = (1.0 / torch.clamp_min(eq_nvar, 1e-12))[:, None]  # (B, 1, N, L)
    scale = float(np.float32(LLR_MAX / range_limit))

    def axis(v):
        d2 = [(v - x) * (v - x) for x in lv]
        llrs = []
        for t in range(labels.shape[1]):
            m0 = m1 = None
            for k, d in enumerate(d2):
                if labels[k, t]:
                    m1 = d if m1 is None else torch.minimum(m1, d)
                else:
                    m0 = d if m0 is None else torch.minimum(m0, d)
            llrs.append(m1 - m0)
        dmin = d2[0]
        for d in d2[1:]:
            dmin = torch.minimum(dmin, d)
        return llrs, dmin

    li, di = axis(xr)
    lq, dq = axis(xi)
    # Bit t of lane j = (s*N + n)*L + l descrambles with c[j*qm + t].
    sg = (1.0 - 2.0 * c.to(torch.float32)).reshape(b, s, n, l, qm)
    planes = torch.empty((b, qm, s, n, l), dtype=torch.int8, device=y.device)
    for t in range(qm // 2):
        for bit, llr in ((2 * t, li[t]), (2 * t + 1, lq[t])):
            q = torch.clamp(torch.round(llr * inv * scale), -LLR_MAX, LLR_MAX)
            planes[:, bit] = (q * sg[..., bit]).to(torch.int8)
    return planes.reshape(b, qm, -1), (di + dq).reshape(b, s, n * l)


def demap_planes(y: torch.Tensor, w: torch.Tensor, eq_nvar: torch.Tensor,
                 c: torch.Tensor, mod: Modulation, range_limit: float = 20.0):
    """Fused equalize-apply + demap + quantize + descramble.

    y: (B, P, S, N) complex64 data symbols; w: (B, N, L, P) complex64
    per-subcarrier weights; eq_nvar: (B, N, L) f32 post-equalization noise;
    c: (B, S*N*L*qm) uint8 Gold sequence in stream order, as
    ``scrambling.gold_sequence`` returns it (plane bit t of lane j
    descrambles with c[j*qm + t]).
    Returns (planes (B, qm, S*N*L) int8, positive = bit 0, equal to the
    quantized, descrambled LLR stream re-laid as ``llr.reshape(-1, qm).T``;
    err2 (B, S, N*L) f32 squared distances to the nearest point).

    CUDA tensor: kernel K4 (one launch; 1-4 layers, contiguous 16-byte
    aligned inputs); CPU tensor: the plain version."""
    if y.device.type == "cpu":
        return demap_planes_plain(y, w, eq_nvar, c, mod, range_limit)
    if y.device.type != "cuda":
        raise ValueError(f"demap_planes: unsupported device {y.device}")
    b, p, s, n, l, qm = _check(y, w, eq_nvar, c, mod)
    if l > 4:
        raise ValueError(f"demap_planes: {l} layers (the kernel takes 1 to 4)")
    if max(p, qm) * s * n * l >= 2 ** 31:
        raise ValueError("demap_planes: a slot must hold fewer than 2^31 elements")
    for name, t in (("y", y), ("w", w), ("eq_nvar", eq_nvar), ("c", c)):
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"demap_planes: {name} must be contiguous and 16-byte aligned")
    dev = y.device
    planes = torch.empty((b, qm, s * n * l), dtype=torch.int8, device=dev)
    err2 = torch.empty((b, s, n * l), dtype=torch.float32, device=dev)
    if planes.numel() == 0:
        return planes, err2
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.demap_planes(
            y.data_ptr(), w.data_ptr(), eq_nvar.data_ptr(), c.data_ptr(),
            b, p, s, n, l, qm, float(np.float32(LLR_MAX / range_limit)),
            planes.data_ptr(), err2.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "demap_planes")
    demap_planes.launches += 1
    return planes, err2


demap_planes.launches = 0


def occupancy(mod: Modulation, nof_layers: int) -> dict:
    """K4's registers a thread and resident 128-thread blocks per SM for
    one constellation and layer count, by the CUDA occupancy calculator
    on the current device."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().demap_planes_occupancy(
        int(mod), nof_layers, ctypes.byref(regs), ctypes.byref(blocks)), "demap_planes_occupancy")
    return {"registers": regs.value, "blocks_per_sm": blocks.value}
