"""Kernel K8's module on the CPU (``ops/equalizer.mmse_equalize``) and its
route in ``phy/pusch._equalize_stage``.

A CPU tensor runs ``mmse_equalize_plain``, which must equal bit for bit the
eager composition that ``_equalize_stage`` ran before K8 (the data-row
gather, K3's plain weights or ``equalize_weights``, the apply as Python's
sum of complex products, the copy of eq_nvar to every data symbol):
``_old_equalize`` below keeps that composition as it was.  The card's
kernel against the plain version is in ``tests/test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

from srsran_project_tpu_torch.models import cell
from srsran_project_tpu_torch.ops import equalizer as eq
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.phy import pusch
from srsran_project_tpu_torch.support import tracing

NSYM, NSC_GRID, SC_START, NSC = 14, 96, 24, 48  # a 4-PRB band at PRB 2 of 8
DMRS = {"dmrs-1": (2,), "dmrs-2": (2, 11)}


def _old_equalize(grid, h, noise_var, data_symbols, sc_start):
    """The eager full-row composition of ``_equalize_stage`` before K8."""
    y = grid[:, :, list(data_symbols), sc_start : sc_start + h.shape[2]]
    b, npr, nsym_d, nsc = y.shape
    nl = h.shape[-1]
    hs = h.transpose(1, 2)
    if nl == 4:
        w, eq_sc = eq.mmse_weights_4x4(hs, noise_var)
    else:
        w, eq_sc = eq.equalize_weights(hs.contiguous(), noise_var[:, None], method="mmse")
    x = torch.stack([sum(w[:, None, :, l, p] * y[:, p] for p in range(npr))
                     for l in range(nl)], dim=-1)
    eq_nvar = eq_sc[:, None].expand(b, nsym_d, nsc, nl)
    return x.reshape(b, -1, nl), eq_nvar.reshape(b, -1, nl)


def _cplx(rng, shape, scale=0.5):
    return torch.from_numpy(((rng.standard_normal(shape) + 1j * rng.standard_normal(shape))
                             * scale).astype(np.complex64))


def _inputs(batch: int, layers: int, layout: str, seed: int = 0):
    """A (B, 4, 14, 96) grid as a non-contiguous view, the (B, 4, nsc, L)
    channel in the memory K7 writes it in ((B, nsc, P, L)), and noise
    variances from 1e-13 (clamped to 1e-12) to 0.3."""
    rng = np.random.default_rng(seed)
    if layout == "window":  # a subcarrier window of a wider grid
        grid = _cplx(rng, (batch, 4, NSYM, NSC_GRID + 40))[..., 8 : 8 + NSC_GRID]
    else:  # symbols and subcarriers swapped in memory
        grid = _cplx(rng, (batch, 4, NSC_GRID, NSYM)).transpose(2, 3)
    assert not grid.is_contiguous()
    h = _cplx(rng, (batch, NSC, 4, layers)).transpose(1, 2)
    nv = torch.tensor([1e-13, 0.013, 0.3][-batch:], dtype=torch.float32)
    return grid, h, nv


def _bits(t: torch.Tensor) -> np.ndarray:
    t = torch.view_as_real(t) if t.is_complex() else t
    return t.contiguous().numpy().view(np.int32)


@pytest.mark.parametrize("layout", ["window", "transposed"])
@pytest.mark.parametrize("dmrs", sorted(DMRS))
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("layers", eq.MMSE_EQUALIZE_LAYERS)
def test_plain_equals_the_eager_composition(layers, batch, dmrs, layout):
    """``mmse_equalize`` on a CPU tensor (its plain version) equals the old
    eager composition bit for bit: a partial band from sc_start > 0, DM-RS
    on one and on two symbols, a non-contiguous grid."""
    grid, h, nv = _inputs(batch, layers, layout, seed=layers * 10 + batch)
    syms = [s for s in range(1, NSYM) if s not in DMRS[dmrs]]
    x, ev = eq.mmse_equalize(grid, h, nv, syms, SC_START)
    x_old, ev_old = _old_equalize(grid, h, nv, syms, SC_START)
    assert x.shape == ev.shape == (batch, len(syms) * NSC, layers)
    assert x.dtype == torch.complex64 and ev.dtype == torch.float32
    np.testing.assert_array_equal(_bits(x), _bits(x_old))
    np.testing.assert_array_equal(_bits(ev), _bits(ev_old))


@pytest.mark.parametrize("bad", ["ports", "layers", "band", "symbols", "noise"])
def test_mmse_equalize_refuses_what_k8_does_not_take(bad):
    """Three ports, three layers, a band past the grid's edge, data symbols
    out of order and a noise variance per subcarrier raise ValueError."""
    grid, h, nv = _inputs(2, 4, "window")
    syms, sc0 = [1, 3, 4], SC_START
    if bad == "ports":
        grid, h = grid[:, :3], h[:, :3]
    elif bad == "layers":
        h = h[..., :3]
    elif bad == "band":
        sc0 = NSC_GRID - NSC + 1
    elif bad == "symbols":
        syms = [3, 1]
    else:
        nv = nv[:, None].expand(-1, NSC)
    with pytest.raises(ValueError):
        eq.mmse_equalize(grid, h, nv, syms, sc0)


@pytest.mark.parametrize("scale", [1e-5, 1e5])
@pytest.mark.parametrize("layers", [1, 2])
def test_plain_keeps_the_channel_range(layers, scale):
    """The plain version, which the card's K8 is held to, solves MMSE
    within 1e-4 x RMS(x) and 1e-4 x (1 + eq_nvar) of a float64 solve for
    channels and grids of 1e-5 and 1e5 (the noise at 20 dB below the
    channel, clamped to 1e-12): a 2x2 determinant of 1e-20 or 1e20 keeps
    its inverse."""
    grid, h, _ = _inputs(3, layers, "window", seed=layers)
    grid, h = grid * scale, h * scale
    nv = torch.full((3,), max(0.01 * scale**2, 1e-12), dtype=torch.float32)
    syms = [s for s in range(1, NSYM) if s != 2]
    x, ev = eq.mmse_equalize(grid, h, nv, syms, SC_START)

    hd = h.transpose(1, 2).numpy().astype(np.complex128)  # (B, nsc, P, L)
    y = grid[:, :, syms, SC_START : SC_START + NSC].numpy().astype(np.complex128)
    hh = np.conj(np.swapaxes(hd, -1, -2))
    g = hh @ hd
    nvd = np.maximum(nv.numpy().astype(np.float64), 1e-12)[:, None, None, None]
    cinv = np.linalg.inv(g + nvd * np.eye(layers))
    mu = np.clip(np.einsum("bnlm,bnml->bnl", cinv, g).real, 1e-9, 1 - 1e-9)
    w = (cinv @ hh) / mu[..., None]  # (B, nsc, L, P)
    x_ref = np.einsum("bnlp,bpsn->bsnl", w, y).reshape(3, -1, layers)
    ev_ref = np.broadcast_to(((1 - mu) / mu)[:, None], (3, len(syms), NSC, layers))
    rms = np.sqrt(np.mean(np.abs(x_ref) ** 2))
    assert np.isfinite(x.numpy()).all() and np.isfinite(ev.numpy()).all()
    assert np.abs(x.numpy() - x_ref).max() <= 1e-4 * rms
    assert (np.abs(ev.numpy() - ev_ref.reshape(3, -1, layers)) / (1 + ev_ref.reshape(
        3, -1, layers))).max() <= 1e-4


def _grant(layers: int, modulation: Modulation, rate: float, seed: int):
    """A 6-PRB grant at 4 RX ports and its received grid at 30 dB."""
    cfg = cell.CellConfig(nof_rb=6, nof_ports=4, nof_layers=layers, modulation=modulation,
                          target_code_rate=rate, f_center_hz=0.0).pusch_cfg
    gen = torch.Generator().manual_seed(seed)
    rnti = torch.tensor([0x4601, 0x4602])
    bits = torch.randint(0, 2, (2, cfg.tbs), generator=gen, dtype=torch.uint8)
    rng = np.random.default_rng(seed)
    q, _ = np.linalg.qr(rng.standard_normal((4, 4)) + 1j * rng.standard_normal((4, 4)))
    prec = torch.from_numpy(q[:, :layers].T.astype(np.complex64))  # (layers, 4 ports)
    grid = pusch.transmit(bits, rnti, cfg, precoding=prec)
    rms = float(grid.abs().pow(2).mean().sqrt())
    return cfg, grid + _cplx(rng, grid.shape, rms * 10 ** (-30 / 20) * np.sqrt(0.5)), rnti


@pytest.mark.parametrize("case", ["rank4-256qam", "rank1-64qam"])
def test_after_estimate_is_unchanged_on_the_cpu(monkeypatch, case):
    """``_after_estimate``'s LLRs, noise and SINR on the new route equal
    bitwise what the old eager composition gives in its place."""
    layers, mod, rate = {"rank4-256qam": (4, Modulation.QAM256, 0.8),
                         "rank1-64qam": (1, Modulation.QAM64, 0.55)}[case]
    cfg, grid, rnti = _grant(layers, mod, rate, seed=layers)
    est = pusch._estimate(grid, cfg)
    calls = []

    def spy(*args):
        calls.append(args)
        return eq.mmse_equalize(*args)

    monkeypatch.setattr(pusch, "mmse_equalize", spy)
    new = pusch._after_estimate(*est, rnti, cfg)
    assert len(calls) == 1
    monkeypatch.setattr(pusch, "mmse_equalize", _old_equalize)
    old = pusch._after_estimate(*est, rnti, cfg)
    assert len(new) == len(old) == 3
    for a, b in zip(new, old):
        np.testing.assert_array_equal(_bits(a) if a.is_floating_point() else a.numpy(),
                                      _bits(b) if b.is_floating_point() else b.numpy())
    assert int((new[0] != 0).sum()) > 0


def _route_cfg(route: str):
    """A 6-PRB grant's config for one of the routes of ``_equalize_stage``."""
    layers, ports, equalizer = {"zf": (4, 4, "zf"), "three-layers": (3, 4, "mmse"),
                                "two-ports": (2, 2, "mmse"), "data-on-dmrs": (4, 4, "mmse"),
                                "mmse-1": (1, 4, "mmse"), "mmse-2": (2, 4, "mmse"),
                                "mmse-4": (4, 4, "mmse")}[route]
    cfg = cell.CellConfig(nof_rb=6, nof_ports=ports, nof_layers=layers, equalizer=equalizer,
                          modulation=Modulation.QAM16, target_code_rate=0.5).pusch_cfg
    if route == "data-on-dmrs":
        cfg = dataclasses.replace(cfg, alloc=dataclasses.replace(
            cfg.alloc, nof_cdm_groups_without_data=1))
    return cfg


ROUTES = ["zf", "three-layers", "two-ports", "data-on-dmrs", "mmse-1", "mmse-2", "mmse-4"]


@pytest.mark.parametrize("route", ROUTES)
def test_only_full_row_mmse_at_four_ports_takes_k8(monkeypatch, route):
    """MMSE on full data rows at 4 ports and 1, 2 or 4 layers goes through
    ``mmse_equalize``; ZF, 3 layers, 2 ports and data on the DM-RS symbols
    keep their old route.  The span counts every data RE in ``res`` and
    none in ``kernel_res`` on the CPU."""
    cfg = _route_cfg(route)
    b, npr, nl = 2, cfg.nof_rx_ports, cfg.nof_layers
    rng = np.random.default_rng(3)
    gflat = _cplx(rng, (b, npr, cfg.nof_grid_symbols * cfg.nof_grid_sc))
    h = _cplx(rng, (b, npr, cfg.alloc.nof_sc, nl))
    nv = torch.tensor([0.01, 0.02])
    calls = []
    monkeypatch.setattr(pusch, "mmse_equalize",
                        lambda *a: calls.append(a) or eq.mmse_equalize(*a))
    tracer = tracing.l1_tracer
    monkeypatch.setattr(tracer, "_kept", [])
    monkeypatch.setattr(tracer, "enabled", True)
    x, ev = pusch._equalize_stage(gflat, h, nv, cfg)
    assert len(calls) == (1 if route.startswith("mmse-") else 0)
    ndata = cfg.g_total // (cfg.sch.qm * nl)
    assert x.shape == ev.shape == (b, ndata, nl)
    assert tracer.take().totals["pusch.equalize"].counts == {"res": b * ndata, "kernel_res": 0}
