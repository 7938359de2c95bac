"""Equalizer weights per subcarrier: MMSE and ZF on any ports x layers
(L <= 4), the 4x4 MMSE kernel K3, the full-row MMSE equalizer K8, and the
per-RE equalizer.

Port of ``equalize_weights`` and ``equalize`` (srsran_project_tpu/ops/
equalizer.py, tx_scaling = 1) and of the TPU kernel
``equalize_weights_pallas`` (ops/equalizer_pallas.py).

* ``mmse_weights_4x4`` is K3's entry point: a CUDA tensor launches the
  hand-written kernel (``csrc/mmse_weights_4x4.cu``), a CPU tensor runs
  ``mmse_weights_4x4_plain``, its plain torch version.  Both compute the
  kernel's algebra: gram, C = G + nv I with nv >= 1e-12, blocked 2x2 Schur
  inverse, unbias mu clipped to [1e-9, 1 - 1e-9], W = C^-1 H^H / mu,
  eq_nvar = (1 - mu) / mu, as explicit scalar complex algebra on (re, im)
  float32 tensors: no torch.linalg, no matmul (so no TF32 path either).
* ``equalize_weights(h, noise_var, method)`` is the general function,
  which the reference computes outside any TPU kernel: plain torch on
  every device.  Its 4x4 MMSE case is ``mmse_weights_4x4_plain`` (so bit
  for bit K3's algebra); every other case runs the reference's batched
  algebra (gram, closed-form ``_inv_small``, W) as
  elementwise complex products summed over the short axes, again no
  matmul.
* ``mmse_equalize`` is K8's entry point: the MMSE weights of 1, 2 or 4
  layers from 4 ports, applied to every data symbol of full data rows
  read straight from the grid.  A CUDA tensor launches the hand-written
  kernel (``csrc/mmse_equalize.cu``), a CPU tensor runs
  ``mmse_equalize_plain``: the data-row gather, the weights
  (``mmse_weights_4x4_plain`` or ``equalize_weights``) and
  ``apply_weights``, the eager composition it replaced.
* ``equalize(y, h, noise_var, method)`` equalizes each resource element
  with its own channel, for allocations whose data REs do not fill whole
  rows (data on the DM-RS symbols): plain torch, as in the reference.
* ``equalize_ref`` is the reference-parity equalizer of the conformance
  modes (``equalizer="mmse_ref"/"zf_ref"``, 1-2 layers, per-port noise):
  plain torch, as in the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import cuda_lib

L = P = 4


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _cneg(a):
    return (-a[0], -a[1])


def _cconj(a):
    return (a[0], -a[1])


def _crecip(a):
    r = 1.0 / torch.clamp_min(a[0] * a[0] + a[1] * a[1], 1e-30)
    return (a[0] * r, -a[1] * r)


def _inv2(c00, c01, c10, c11):
    r = _crecip(_csub(_cmul(c00, c11), _cmul(c01, c10)))
    return (_cmul(c11, r), _cneg(_cmul(c01, r)), _cneg(_cmul(c10, r)), _cmul(c00, r))


def _mm2(a, b):
    return (_cadd(_cmul(a[0], b[0]), _cmul(a[1], b[2])),
            _cadd(_cmul(a[0], b[1]), _cmul(a[1], b[3])),
            _cadd(_cmul(a[2], b[0]), _cmul(a[3], b[2])),
            _cadd(_cmul(a[2], b[1]), _cmul(a[3], b[3])))


def _check(h: torch.Tensor, noise_var: torch.Tensor) -> torch.Tensor:
    """Validate h (..., nsc, 4, 4) complex64 and return noise_var as a
    float32 tensor of shape h.shape[:-3] on h's device."""
    if h.dim() < 3 or h.shape[-2:] != (P, L) or h.dtype != torch.complex64:
        raise ValueError(f"mmse_weights_4x4: want (..., nsc, 4, 4) complex64, got "
                         f"{tuple(h.shape)} {h.dtype}")
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)
    if nv.shape != h.shape[:-3]:
        raise ValueError(f"mmse_weights_4x4: noise_var shape {tuple(nv.shape)} != "
                         f"{tuple(h.shape[:-3])}")
    return nv


def mmse_weights_4x4_plain(h: torch.Tensor, noise_var: torch.Tensor):
    """K3's plain version: (..., nsc, P=4, L=4) complex64 channels and
    (...,) noise variances -> (w (..., nsc, L, P) complex64, eq_nvar (...,
    nsc, L) float32)."""
    nv = torch.clamp_min(_check(h, noise_var), 1e-12)[..., None]
    hr, hi = h.real, h.imag
    hh = [[(hr[..., p, l], hi[..., p, l]) for l in range(L)] for p in range(P)]
    zero = torch.zeros_like(hr[..., 0, 0])
    g = [[None] * L for _ in range(L)]
    for l in range(L):
        for m in range(L):
            acc = (zero, zero)
            for p in range(P):
                acc = _cadd(acc, _cmul(_cconj(hh[p][l]), hh[p][m]))
            g[l][m] = acc
    c = [[(g[l][m][0] + nv, g[l][m][1]) if l == m else g[l][m] for m in range(L)]
         for l in range(L)]

    a = (c[0][0], c[0][1], c[1][0], c[1][1])
    bm = (c[0][2], c[0][3], c[1][2], c[1][3])
    bh = (c[2][0], c[2][1], c[3][0], c[3][1])
    d = (c[2][2], c[2][3], c[3][2], c[3][3])
    ai = _inv2(*a)
    si = _inv2(*(_csub(x, t) for x, t in zip(d, _mm2(_mm2(bh, ai), bm))))
    aib = _mm2(ai, bm)
    bhai = _mm2(bh, ai)
    tl = tuple(_cadd(x, t) for x, t in zip(ai, _mm2(_mm2(aib, si), bhai)))
    tr = tuple(_cneg(t) for t in _mm2(aib, si))
    bl = tuple(_cneg(t) for t in _mm2(si, bhai))
    ci = [[tl[0], tl[1], tr[0], tr[1]],
          [tl[2], tl[3], tr[2], tr[3]],
          [bl[0], bl[1], si[0], si[1]],
          [bl[2], bl[3], si[2], si[3]]]

    w_rows, ev = [], []
    for l in range(L):
        mu = zero
        for m in range(L):
            mu = mu + (ci[l][m][0] * g[m][l][0] - ci[l][m][1] * g[m][l][1])
        mu = torch.clamp(mu, 1e-9, 1.0 - 1e-9)
        inv_mu = 1.0 / mu
        row = []
        for p in range(P):
            acc = (zero, zero)
            for m in range(L):
                acc = _cadd(acc, _cmul(ci[l][m], _cconj(hh[p][m])))
            row.append(torch.complex(acc[0] * inv_mu, acc[1] * inv_mu))
        w_rows.append(torch.stack(row, dim=-1))
        ev.append((1.0 - mu) * inv_mu)
    return torch.stack(w_rows, dim=-2), torch.stack(ev, dim=-1)


def mmse_weights_4x4(h: torch.Tensor, noise_var: torch.Tensor):
    """4x4 MMSE weights: (..., nsc, 4, 4) complex64 h, (...,) noise_var ->
    (w (..., nsc, L, P) complex64, eq_nvar (..., nsc, L) float32).

    h may be any strided view, such as ``h.transpose(1, 2)`` of the channel
    estimate's (B, P, nsc, L): the kernel reads it through its strides.
    The leading dimensions are merged with ``reshape``, a view wherever
    they merge (one leading dimension always does).

    CUDA tensor: kernel K3 (one launch); CPU tensor: the plain version."""
    if h.device.type == "cpu":
        return mmse_weights_4x4_plain(h, noise_var)
    if h.device.type != "cuda":
        raise ValueError(f"mmse_weights_4x4: unsupported device {h.device}")
    nv = _check(h, noise_var).reshape(-1).contiguous()
    nsc = h.shape[-3]
    w = torch.empty(h.shape, dtype=torch.complex64, device=h.device)
    ev = torch.empty(h.shape[:-1], dtype=torch.float32, device=h.device)
    if w.numel() == 0:
        return w, ev
    h4 = h.reshape(-1, nsc, P, L)
    lib = cuda_lib.library()
    with torch.cuda.device(h.device):
        status = lib.mmse_weights_4x4(h4.data_ptr(), *h4.stride(), nv.data_ptr(), h4.shape[0],
                                      nsc, w.data_ptr(), ev.data_ptr(),
                                      torch.cuda.current_stream(h.device).cuda_stream)
    cuda_lib.check(status, "mmse_weights_4x4")
    mmse_weights_4x4.launches += 1
    return w, ev


mmse_weights_4x4.launches = 0


def occupancy() -> dict:
    """K3's registers a thread and resident 256-thread blocks per SM, by
    the CUDA occupancy calculator on the current device."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().mmse_weights_4x4_occupancy(ctypes.byref(regs),
                                                                 ctypes.byref(blocks)),
                   "mmse_weights_4x4_occupancy")
    return {"registers": regs.value, "blocks_per_sm": blocks.value}


# ---- full data rows: K8 ----------------------------------------------------

MMSE_EQUALIZE_LAYERS = (1, 2, 4)  # K8's layer counts, at P ports
_MAX_SYMBOLS = 14


def apply_weights(y: torch.Tensor, w: torch.Tensor, eq_sc: torch.Tensor):
    """Per-subcarrier weights applied to full data rows: y (B, P, nsym_d,
    nsc), w (B, nsc, L, P), eq_sc (B, nsc, L) -> (x_hat (B, nsym_d * nsc,
    L) complex64, eq_nvar (B, nsym_d * nsc, L) float32) in data-RE order,
    x[b, s, n, l] = sum_p w[b, n, l, p] y[b, p, s, n]."""
    b, npr, nsym_d, nsc = y.shape
    nl = w.shape[-2]
    x = torch.stack([sum(w[:, None, :, l, p] * y[:, p] for p in range(npr))
                     for l in range(nl)], dim=-1)  # (B, nsym_d, nsc, nl)
    eq_nvar = eq_sc[:, None].expand(b, nsym_d, nsc, nl)
    return x.reshape(b, -1, nl), eq_nvar.reshape(b, -1, nl)


def _equalize_check(grid: torch.Tensor, h: torch.Tensor, noise_var, data_symbols,
                    sc_start: int) -> torch.Tensor:
    """Validate K8's inputs and return noise_var as a (B,) float32 tensor
    on h's device."""
    if grid.dim() != 4 or grid.shape[1] != P or grid.dtype != torch.complex64:
        raise ValueError(f"mmse_equalize: want a (B, 4, nsym, nsc) complex64 grid, got "
                         f"{tuple(grid.shape)} {grid.dtype}")
    b, _, nsym, nsc_grid = grid.shape
    if (h.dim() != 4 or h.shape[:2] != (b, P) or h.shape[-1] not in MMSE_EQUALIZE_LAYERS
            or h.dtype != torch.complex64):
        raise ValueError(f"mmse_equalize: want (B, 4, nsc, L in {MMSE_EQUALIZE_LAYERS}) "
                         f"complex64 channels, got {tuple(h.shape)} {h.dtype}")
    if h.device != grid.device:
        raise ValueError(f"mmse_equalize: grid on {grid.device}, channels on {h.device}")
    if not 0 <= sc_start <= nsc_grid - h.shape[2]:
        raise ValueError(f"mmse_equalize: {h.shape[2]} subcarriers from {sc_start} leave "
                         f"the grid's {nsc_grid}")
    syms = list(data_symbols)
    if not syms or syms != sorted(set(syms)) or syms[0] < 0 or syms[-1] >= min(nsym,
                                                                              _MAX_SYMBOLS):
        raise ValueError(f"mmse_equalize: data symbols {syms} of a {nsym}-symbol grid")
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)
    if nv.shape != (b,):
        raise ValueError(f"mmse_equalize: noise_var shape {tuple(nv.shape)} != ({b},)")
    return nv


def mmse_equalize_plain(grid: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                        data_symbols, sc_start: int):
    """K8's plain version: the eager composition it replaced (the data-row
    gather, the weights, ``apply_weights``)."""
    nv = _equalize_check(grid, h, noise_var, data_symbols, sc_start)
    y = grid[:, :, list(data_symbols), sc_start : sc_start + h.shape[2]]
    hs = h.transpose(1, 2)  # (B, nsc, P, L)
    if h.shape[-1] == L:
        w, eq_sc = mmse_weights_4x4_plain(hs, nv)
    else:
        w, eq_sc = equalize_weights(hs.contiguous(), nv[:, None])
    return apply_weights(y, w, eq_sc)


def mmse_equalize(grid: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor,
                  data_symbols, sc_start: int):
    """MMSE-equalize full data rows: grid (B, 4, nsym, nsc_grid) complex64,
    h (B, 4, nsc, L in {1, 2, 4}) complex64 (the channel of subcarriers
    sc_start..sc_start + nsc - 1), noise_var (B,), the data symbols
    (ascending, below 14) -> (x_hat (B, nsym_d * nsc, L) complex64,
    eq_nvar (B, nsym_d * nsc, L) float32) in data-RE order.

    The grid and h may be any strided views: the kernel reads them through
    their strides.  CUDA tensor: kernel K8 (one launch); CPU tensor: the
    plain version."""
    if grid.device.type == "cpu":
        return mmse_equalize_plain(grid, h, noise_var, data_symbols, sc_start)
    if grid.device.type != "cuda":
        raise ValueError(f"mmse_equalize: unsupported device {grid.device}")
    nv = _equalize_check(grid, h, noise_var, data_symbols, sc_start).contiguous()
    syms = list(data_symbols)
    b, nsc, nl = grid.shape[0], h.shape[2], h.shape[3]
    shape = (b, len(syms) * nsc, nl)
    x = torch.empty(shape, dtype=torch.complex64, device=grid.device)
    ev = torch.empty(shape, dtype=torch.float32, device=grid.device)
    if x.numel() == 0:
        return x, ev
    mask = sum(1 << s for s in syms)
    with torch.cuda.device(grid.device):
        status = cuda_lib.library().mmse_equalize(
            grid.data_ptr(), *grid.stride(), h.data_ptr(), *h.stride(), nv.data_ptr(), b, nsc,
            nl, sc_start, mask, x.data_ptr(), ev.data_ptr(),
            torch.cuda.current_stream(grid.device).cuda_stream)
    cuda_lib.check(status, "mmse_equalize")
    mmse_equalize.launches += 1
    return x, ev


mmse_equalize.launches = 0


def mmse_equalize_occupancy(layers: int) -> dict:
    """K8's registers a thread and resident blocks per SM at ``layers``
    (256-thread blocks at 4, 128 at 1 and 2), by the CUDA occupancy
    calculator on the current device."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().mmse_equalize_occupancy(
        layers, ctypes.byref(regs), ctypes.byref(blocks)), "mmse_equalize_occupancy")
    return {"registers": regs.value, "blocks_per_sm": blocks.value}


# ---- the general path (any P, L <= 4; MMSE and ZF) ------------------------

def _cmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., m, k) x (..., k, n) complex products summed over k (no matmul,
    so no TF32)."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _inv2x2(c: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., 2, 2) complex matrices."""
    a, b, d, e = c[..., 0, 0], c[..., 0, 1], c[..., 1, 0], c[..., 1, 1]
    r = 1.0 / (a * e - b * d)
    return torch.stack([torch.stack([e * r, -b * r], dim=-1),
                        torch.stack([-d * r, a * r], dim=-1)], dim=-2)


def _inv_small(c: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of (..., L, L) matrices, L in {1, 2, 3, 4}:
    blocked 2x2 Schur complements; L = 3 pads to 4 with an identity corner
    (block-diagonal, so the padded inverse embeds the answer)."""
    nl = c.shape[-1]
    if nl == 1:
        return 1.0 / c
    if nl == 2:
        return _inv2x2(c)
    if nl == 3:
        pad = torch.zeros(c.shape[:-2] + (4, 4), dtype=c.dtype, device=c.device)
        pad[..., :3, :3] = c
        pad[..., 3, 3] = 1.0
        return _inv_small(pad)[..., :3, :3]
    if nl == 4:
        a, b = c[..., :2, :2], c[..., :2, 2:]
        bh, d = c[..., 2:, :2], c[..., 2:, 2:]
        ai = _inv2x2(a)
        si = _inv2x2(d - _cmm(_cmm(bh, ai), b))  # inverse of A's Schur complement
        aib, bhai = _cmm(ai, b), _cmm(bh, ai)
        top = torch.cat([ai + _cmm(_cmm(aib, si), bhai), -_cmm(aib, si)], dim=-1)
        bot = torch.cat([-_cmm(si, bhai), si], dim=-1)
        return torch.cat([top, bot], dim=-2)
    raise ValueError(f"L={nl} unsupported")


def equalize_weights(h: torch.Tensor, noise_var: torch.Tensor, method: str = "mmse"):
    """Per-position equalizer weights: (..., P, L) complex64 channels,
    noise_var broadcastable to (...,) -> (w (..., L, P) complex64, eq_nvar
    (..., L) float32), x_hat = w @ y unbiased with post-equalization noise
    eq_nvar.  MMSE: C = G + nv I, mu = diag(C^-1 G) clipped to
    [1e-9, 1 - 1e-9], W = C^-1 H^H / mu, eq_nvar = (1 - mu) / mu.  ZF:
    C = G + 1e-9 I, W = C^-1 H^H, eq_nvar = nv diag(C^-1)."""
    if method not in ("mmse", "zf"):
        raise ValueError(method)
    if h.dim() < 2 or h.shape[-1] > 4 or h.dtype != torch.complex64:
        raise ValueError(f"equalize_weights: want (..., P, L <= 4) complex64, got "
                         f"{tuple(h.shape)} {h.dtype}")
    npr, nl = h.shape[-2], h.shape[-1]
    nv = torch.clamp_min(torch.as_tensor(noise_var, dtype=torch.float32, device=h.device)
                         .broadcast_to(h.shape[:-2]), 1e-12)
    if method == "mmse" and (npr, nl) == (P, L):
        # Each position as a one-subcarrier "slot" of its own noise.
        w, ev = mmse_weights_4x4_plain(h[..., None, :, :], nv)
        return w[..., 0, :, :], ev[..., 0, :]
    nv = nv[..., None]
    hh = h.conj().transpose(-1, -2)  # (..., L, P)
    gram = _cmm(hh, h)  # (..., L, L)
    eye = torch.eye(nl, dtype=torch.float32, device=h.device)
    load = nv[..., None] * eye if method == "mmse" else 1e-9 * eye
    cinv = _inv_small(gram + load)
    w = _cmm(cinv, hh)
    if method == "mmse":
        mu = torch.clamp((cinv * gram.transpose(-1, -2)).sum(dim=-1).real, 1e-9, 1.0 - 1e-9)
        return w / mu[..., None], (1.0 - mu) / mu
    return w, nv * torch.diagonal(cinv, dim1=-2, dim2=-1).real


# ---- per resource element (any allocation shape) ---------------------------

def _equalize_mmse4(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor):
    """4-layer, 4-port MMSE per RE in the reference's order of operations
    (``_equalize_mmse4_soa``): matched filter z = H^H y, C = G + nv I, the
    blocked 2x2 Schur inverse, x = C^-1 z / mu, eq_nvar = (1 - mu) / mu."""
    nv = torch.clamp_min(noise_var, 1e-12)
    hc = [[h[..., p, l] for l in range(L)] for p in range(P)]
    yc = [y[..., p] for p in range(P)]
    g = [[sum(hc[p][l].conj() * hc[p][m] for p in range(P)) for m in range(L)]
         for l in range(L)]
    z = [sum(hc[p][l].conj() * yc[p] for p in range(P)) for l in range(L)]
    c = [[g[l][m] + nv if l == m else g[l][m] for m in range(L)] for l in range(L)]

    def inv2(c00, c01, c10, c11):
        r = 1.0 / (c00 * c11 - c01 * c10)
        return c11 * r, -c01 * r, -c10 * r, c00 * r

    def mm2(a, b):
        return (a[0] * b[0] + a[1] * b[2], a[0] * b[1] + a[1] * b[3],
                a[2] * b[0] + a[3] * b[2], a[2] * b[1] + a[3] * b[3])

    ai = inv2(c[0][0], c[0][1], c[1][0], c[1][1])
    bm = (c[0][2], c[0][3], c[1][2], c[1][3])
    bh = (c[2][0], c[2][1], c[3][0], c[3][1])
    d = (c[2][2], c[2][3], c[3][2], c[3][3])
    si = inv2(*(x - t for x, t in zip(d, mm2(mm2(bh, ai), bm))))
    aib, bhai = mm2(ai, bm), mm2(bh, ai)
    tl = tuple(a + t for a, t in zip(ai, mm2(mm2(aib, si), bhai)))
    tr = tuple(-t for t in mm2(aib, si))
    bl = tuple(-t for t in mm2(si, bhai))
    ci = [[tl[0], tl[1], tr[0], tr[1]],
          [tl[2], tl[3], tr[2], tr[3]],
          [bl[0], bl[1], si[0], si[1]],
          [bl[2], bl[3], si[2], si[3]]]
    x = [sum(ci[l][m] * z[m] for m in range(L)) for l in range(L)]
    mu = [torch.clamp(sum((ci[l][m] * g[m][l]).real for m in range(L)), 1e-9, 1.0 - 1e-9)
          for l in range(L)]
    return (torch.stack([x[l] / mu[l] for l in range(L)], dim=-1),
            torch.stack([(1.0 - mu[l]) / mu[l] for l in range(L)], dim=-1))


def equalize(y: torch.Tensor, h: torch.Tensor, noise_var: torch.Tensor, method: str = "mmse"):
    """Equalize every resource element with its own channel: y (..., nre,
    P) complex64, h (..., nre, P, L <= 4) complex64, noise_var
    broadcastable to (..., nre) -> (x_hat (..., nre, L) complex64, eq_nvar
    (..., nre, L) float32), the unbiased estimates and their
    post-equalization noise.  Port of the reference's ``equalize``: 4x4
    MMSE in its structure-of-arrays algebra, every other case its batched
    algebra (matched filter, closed-form ``_inv_small``, C^-1 z), as
    elementwise complex products summed over the short axes (no matmul,
    so no TF32)."""
    if method not in ("mmse", "zf"):
        raise ValueError(method)
    if h.dim() < 3 or h.shape[-1] > 4 or h.dtype != torch.complex64:
        raise ValueError(f"equalize: want (..., nre, P, L <= 4) complex64, got "
                         f"{tuple(h.shape)} {h.dtype}")
    npr, nl = h.shape[-2], h.shape[-1]
    nv = torch.as_tensor(noise_var, dtype=torch.float32, device=h.device).broadcast_to(
        h.shape[:-2])
    if method == "mmse" and (npr, nl) == (P, L):
        return _equalize_mmse4(y, h, nv)
    nv = torch.clamp_min(nv, 1e-12)[..., None]
    hh = h.conj().transpose(-1, -2)  # (..., L, P)
    gram = _cmm(hh, h)
    z = (hh * y[..., None, :]).sum(dim=-1)  # (..., L) matched filter
    eye = torch.eye(nl, dtype=torch.float32, device=h.device)
    load = nv[..., None] * eye if method == "mmse" else 1e-9 * eye
    cinv = _inv_small(gram + load)
    xt = (cinv * z[..., None, :]).sum(dim=-1)
    if method == "mmse":
        mu = torch.clamp((cinv * gram.transpose(-1, -2)).sum(dim=-1).real, 1e-9, 1.0 - 1e-9)
        return xt / mu, (1.0 - mu) / mu
    return xt, nv * torch.diagonal(cinv, dim1=-2, dim2=-1).real


# ---- reference parity (channel_equalizer_generic_impl, 1-2 layers) ---------

_TINY = 1.1754944e-38  # smallest normal float32 (the reference's isnormal gate)


def _isnormal(x: torch.Tensor) -> torch.Tensor:
    return torch.isfinite(x) & (x.abs() >= _TINY)


def equalize_ref(y: torch.Tensor, h: torch.Tensor, noise_var_port: torch.Tensor,
                 tx_scaling: float = 1.0, method: str = "zf"):
    """Reference-parity equalizer, port of the reference's ``equalize_ref``
    (channel_equalizer_generic_impl semantics): y (..., nre, P) complex64,
    h (..., nre, P, L) complex64, noise_var_port (..., P) per-port noise
    variances (the leading dimensions of y without nre) -> (x_hat (...,
    nre, L), eq_nvar (..., nre, L)).

    * L = 1, ZF and MMSE alike (the reference reduces 1-layer MMSE to ZF):
      per-port accumulation with per-port noise weighting, ports whose
      |h|^2 or noise is not a normal positive float left out;
      eq_nvar = sum(|h|^2 sigma_p) / (beta sum |h|^2)^2.
    * L = 2 (ZF): the adjugate solve with the largest port noise,
      eq_nvar_l = sigma_max [G^-1]_ll / beta.
    An abnormal denominator gives (0, inf), as in the reference; above 2
    layers it raises ValueError, as the reference does."""
    nlayers = h.shape[-1]
    beta = float(np.float32(tx_scaling))
    nv = torch.as_tensor(noise_var_port, dtype=torch.float32, device=h.device)
    zero = torch.zeros((), dtype=torch.complex64, device=h.device)
    if nlayers == 1:
        nv = nv[..., None, :]  # (..., 1, P)
        h1 = h[..., 0]
        norm = h1.abs() ** 2
        port_ok = _isnormal(norm) & _isnormal(nv) & (nv > 0)
        norm = torch.where(port_ok, norm, 0.0)
        mf = torch.where(port_ok, y * h1.conj(), zero)
        ch_mod_sq = norm.sum(dim=-1)
        nvar_acc = (norm * nv).sum(dim=-1)
        re_out = mf.sum(dim=-1)
        d_pinv = beta * ch_mod_sq
        ok = _isnormal(d_pinv) & _isnormal(nvar_acc)
        rcp = torch.where(ok, 1.0 / torch.where(ok, d_pinv, 1.0), 0.0)
        x = torch.where(ok, re_out * rcp, zero)
        nvar = torch.where(ok, nvar_acc * rcp * rcp, torch.inf)
        return x[..., None], nvar[..., None]
    if nlayers == 2:
        sigma = nv.amax(dim=-1)[..., None]  # (..., 1)
        h0, h1 = h[..., 0], h[..., 1]
        g00 = (h0.abs() ** 2).sum(dim=-1)
        g11 = (h1.abs() ** 2).sum(dim=-1)
        xi = (h1 * h0.conj()).sum(dim=-1)
        m0 = (y * h0.conj()).sum(dim=-1)
        m1 = (y * h1.conj()).sum(dim=-1)
        d_pinv = beta * (g00 * g11 - xi.abs() ** 2)
        ok = _isnormal(d_pinv) & (d_pinv > 0)
        rcp = torch.where(ok, 1.0 / torch.where(ok, d_pinv, 1.0), 0.0)
        x0 = torch.where(ok, (m0 * g11 - xi * m1) * rcp, zero)
        x1 = torch.where(ok, (m1 * g00 - xi.conj() * m0) * rcp, zero)
        nv0 = torch.where(ok, g11 * sigma * rcp, torch.inf)
        nv1 = torch.where(ok, g00 * sigma * rcp, torch.inf)
        return torch.stack([x0, x1], dim=-1), torch.stack([nv0, nv1], dim=-1)
    raise ValueError(
        f"reference parity covers 1-2 layers (the open-source reference stubs "
        f"3-4 layer equalizers); got {nlayers}; use equalize() instead")
