"""Kernel K7's module (srsran_project_tpu_torch/ops/pusch_estimate.py) and
the PUSCH estimate stage that runs it, on the CPU.

* ``pusch._estimate`` on CPU tensors (K7's plain version) gives what the
  eager composition gave before it, bit for bit: the pilot gather,
  ``estimate_h`` and the second-difference noise, at the shapes of the
  five uplink cells cut down as ``portbench/tests/small.py`` and
  ``small_ul_tti.py`` cut them, with the per-grant pilots of a multi-UE
  slot (``r_override``) and without, and on two DM-RS symbols.
* The route: only the fast estimator with second-difference noise,
  post-equalization SINR, no CFO compensation over two or more DM-RS
  symbols, no TA, no PT-RS and at least 3 CDM pairs goes through
  ``pusch_estimate.estimate``; every other mode keeps the eager code.
* The ``pusch.estimate`` span counts the grants and the grants K7 took
  (none on the CPU).
* The wrapper rejects a wrong shape, dtype or device.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against this plain version.
"""

import dataclasses

import numpy as np
import pytest
import torch

from portbench.harness import cells
from portbench.tests import small, small_ul_tti
from srsran_project_tpu_torch.models import cell
from srsran_project_tpu_torch.ops import pusch_estimate
from srsran_project_tpu_torch.ops.estimator import estimate_h
from srsran_project_tpu_torch.phy import pusch
from srsran_project_tpu_torch.ran import dmrs as dmrs_mod
from srsran_project_tpu_torch.support import tracing


def rx_grids(cfg, first_rbs, seed: int, snr_db: float = 30.0, delay_sc: float = 0.0):
    """(B, P, nsym, nsc) complex64 received grids of one grant per first
    PRB (each transmitted with its own CRB's DM-RS, as a multi-UE slot's
    compact windows hold them) through a random flat P x nl channel with
    orthonormal columns, as the benchmark's cells draw it, a delay of
    ``delay_sc`` cycles across the window, and AWGN ``snr_db`` below the
    signal."""
    rng = np.random.default_rng(seed)
    out = []
    for k, rb0 in enumerate(first_rbs):
        at = dataclasses.replace(cfg, alloc=dataclasses.replace(cfg.alloc, crb_start=rb0))
        tb = torch.from_numpy(rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8))
        x = pusch.transmit(tb, torch.tensor(0x4601 + k), at).numpy()  # (nl, nsym, nsc)
        nl, _, nsc = x.shape
        h = np.linalg.qr(rng.standard_normal((cfg.nof_rx_ports, nl))
                         + 1j * rng.standard_normal((cfg.nof_rx_ports, nl)))[0]
        y = np.einsum("pl,lsk->psk", h, x) * np.exp(-2j * np.pi * delay_sc * np.arange(nsc) / nsc)
        s = np.sqrt(np.mean(np.abs(y) ** 2) / 2 * 10 ** (-snr_db / 10))
        out.append(y + s * (rng.standard_normal(y.shape) + 1j * rng.standard_normal(y.shape)))
    return torch.from_numpy(np.stack(out).astype(np.complex64))


def estimate_args(cfg, dev, r_override=None):
    """``pusch_estimate.estimate``'s arguments after the grid for ``cfg``,
    as ``pusch._estimate_fast`` passes them."""
    r = pusch._est_on(dev, cfg, 2)[None] if r_override is None else r_override
    beta2 = dmrs_mod.sch_to_dmrs_beta(cfg.alloc.nof_cdm_groups_without_data) ** 2
    return (pusch._est_on(dev, cfg, 0), r, pusch._est_on(dev, cfg, 1),
            pusch._estimate_constants(cfg)[3], cfg.alloc.nof_sc, beta2)


def _old_estimate(grid, cfg, r_override=None):
    """The eager composition ``pusch._estimate_fast`` ran before K7 for its
    modes, copied as it was: (gflat, h, noise_var)."""
    a = cfg.alloc
    nl, npr = cfg.nof_layers, cfg.nof_rx_ports
    nsym_d = len(a.dmrs_symbols)
    b = grid.shape[0]
    dev = grid.device
    _, _, _, pair_pos = pusch._estimate_constants(cfg)
    idx_all = pusch._est_on(dev, cfg, 0)
    wf = pusch._est_on(dev, cfg, 1)[:, None, None, :]
    r_all = (pusch._est_on(dev, cfg, 2)[None] if r_override is None else r_override)[:, :, None]
    gf = grid.reshape(b, npr, -1)
    y_p = gf[:, :, idx_all].reshape(b, npr, nl, nsym_d, -1).transpose(1, 2)
    h_l, _ls, h_pair = estimate_h(y_p, r_all, wf, pair_pos, a.nof_sc)
    beta2 = dmrs_mod.sch_to_dmrs_beta(a.nof_cdm_groups_without_data) ** 2
    h_pair = h_pair.mean(dim=-2)
    npair = h_pair.shape[-1]
    slope = torch.angle(torch.sum(h_pair[..., 1:] * h_pair[..., :-1].conj(), dim=-1,
                                  keepdim=True))
    ramp = torch.arange(npair, dtype=torch.float32, device=dev)
    h_pair = h_pair * torch.polar(torch.ones_like(slope), -slope * ramp)
    d2 = h_pair[..., 2:] - 2.0 * h_pair[..., 1:-1] + h_pair[..., :-2]
    nv = (d2.abs() ** 2).reshape(h_pair.shape[0], -1).mean(dim=-1) * nsym_d / 3.0 * beta2
    return grid.reshape(b, npr, -1), h_l.permute(0, 2, 3, 1), torch.clamp_min(nv, 1e-10)


def _groups(config: dict) -> list:
    """(the program's PuschConfig, first PRBs) of each group of equal
    grants of a benchmark configuration."""
    groups = {}
    for ue in cells.ue_layout(config):
        pc = cells.program_cell(config, ue).pusch_cfg
        groups.setdefault(pc, []).append(ue["first_rb"])
    return list(groups.items())


# Cell -> (its cut-down configuration, grants a call for a single-UE cell).
CELLS = {
    "su_ul_b8": (small.su_config, 2),
    "su_ul_b8_bler10": (lambda: small.su_config("nr100_4x4_256qam_su_bler10"), 2),
    "su_ul_b1": (small.su_config, 1),
    "mu8_ul": (small.mu_config, None),
    "fapi_ul_tti": (small_ul_tti.config, None),
}


def _bitwise(got, want, what):
    if got.is_complex():
        got, want = torch.view_as_real(got), torch.view_as_real(want)
    assert got.shape == want.shape, what
    got, want = got.contiguous().view(torch.int32), want.contiguous().view(torch.int32)
    assert torch.equal(got, want), what


@pytest.mark.parametrize("name", sorted(CELLS))
def test_plain_matches_old_composition(name):
    """At each cut-down cell's grant groups (a single-UE cell's slots
    batched, a multi-UE group with its per-grant pilots and, as a
    single-UE slot, without): gflat, h and the noise bit for bit."""
    make, slots = CELLS[name]
    for k, (pc, first_rbs) in enumerate(_groups(make())):
        assert pusch._fused_estimate_ok(pc), name
        if slots is not None:
            grid = rx_grids(pc, [0] * slots, seed=k)
            overrides = [None]
        else:
            grid = rx_grids(pc, first_rbs, seed=k)
            overrides = [pusch._pilot_bank_on(torch.device("cpu"), pc, tuple(first_rbs)), None]
        for r in overrides:
            got = pusch._estimate(grid, pc, r)
            assert got[3] == {}
            for g, w, what in zip(got[:3], _old_estimate(grid, pc, r), ("gflat", "h", "nv")):
                _bitwise(g, w, f"{name} group {k} {what} r_override={r is not None}")


def test_plain_on_two_dmrs_symbols_and_a_delay():
    """Two DM-RS symbols (the time mean) and a bulk delay (the slope)."""
    base = cell.CellConfig(nof_rb=24, nof_ports=2, nof_layers=2).pusch_cfg
    cfg = dataclasses.replace(base, alloc=dataclasses.replace(base.alloc, dmrs_symbols=(2, 11)))
    assert pusch._fused_estimate_ok(cfg)
    grid = rx_grids(cfg, [0, 0], seed=5, delay_sc=3.0)
    got = pusch._estimate(grid, cfg)
    for g, w in zip(got[:3], _old_estimate(grid, cfg)):
        _bitwise(g, w, "two DM-RS symbols")


def _flagship_like(**kw):
    """The flagship's modes on 12 PRB, 2 ports, 2 layers, with ``kw``."""
    cfg = cell.CellConfig(nof_rb=12, nof_ports=2, nof_layers=2).pusch_cfg
    return dataclasses.replace(cfg, **kw)


def _narrow():
    """A grant of 1 PRB with DM-RS type 2: 4 pilots a symbol, 2 pairs."""
    cfg = _flagship_like()
    a = dataclasses.replace(cfg.alloc, rb_count=1, dmrs_config_type=2)
    return dataclasses.replace(cfg, alloc=a, nof_grid_sc=12, tbs=24)


def _two_dmrs(**kw):
    cfg = _flagship_like(**kw)
    return dataclasses.replace(cfg, alloc=dataclasses.replace(cfg.alloc, dmrs_symbols=(2, 11)))


# Mode -> (its config, whether K7's route takes it).
ROUTES = {
    "k7": (_flagship_like, True),
    "k7-cfo-one-dmrs-symbol": (lambda: _flagship_like(cfo_compensation=True), True),
    "k7-two-dmrs-symbols": (_two_dmrs, True),
    "k7-transform-precoding": (lambda: dataclasses.replace(
        cell.CellConfig(nof_rb=12, nof_ports=2, nof_layers=1).pusch_cfg,
        transform_precoding=True), True),
    "cfo-two-dmrs-symbols": (lambda: _two_dmrs(cfo_compensation=True), False),
    "compute-ta": (lambda: _flagship_like(compute_ta=True), False),
    "ptrs": (lambda: _flagship_like(ptrs_enabled=True), False),
    "pair-residual-noise": (lambda: _flagship_like(noise_method="pair_residual"), False),
    "channel-estimator-sinr": (lambda: _flagship_like(sinr_method="channel_estimator"), False),
    "reference-estimator": (lambda: _flagship_like(estimator="reference"), False),
    "two-pairs": (_narrow, False),
}


@pytest.mark.parametrize("mode", sorted(ROUTES))
def test_route_table(mode, monkeypatch):
    """K7's modes call ``pusch_estimate.estimate`` once an estimate; every
    other mode keeps the eager code and never calls it."""
    make, routed = ROUTES[mode]
    cfg = make()
    assert pusch._fused_estimate_ok(cfg) == routed
    calls = []
    real = pusch_estimate.estimate
    monkeypatch.setattr(pusch_estimate, "estimate", lambda *a: calls.append(1) or real(*a))
    grid = rx_grids(cfg, [0, 0], seed=3)
    _gflat, h, nv, _extras = pusch._estimate(grid, cfg)
    assert len(calls) == int(routed)
    assert h.shape == (2, cfg.nof_rx_ports, cfg.alloc.nof_sc, cfg.nof_layers)
    assert nv.shape == (2,)


@pytest.mark.parametrize("mode", ["k7", "reference-estimator", "compute-ta"])
def test_estimate_span_counts_grants(mode, monkeypatch):
    """``pusch.estimate`` counts every grant of the batch and the grants K7
    estimated: none on the CPU, on any route."""
    cfg = ROUTES[mode][0]()
    tracer = tracing.l1_tracer
    monkeypatch.setattr(tracer, "_kept", [])
    monkeypatch.setattr(tracer, "enabled", True)
    pusch._estimate(rx_grids(cfg, [0, 0, 0], seed=4), cfg)
    assert tracer.take().totals["pusch.estimate"].counts == {"grants": 3, "kernel_grants": 0}


def _valid():
    cfg = _flagship_like()
    return (rx_grids(cfg, [0, 0], seed=6), *estimate_args(cfg, torch.device("cpu")))


def _with(i, fn):
    """Replace argument i of ``_valid()`` by fn(it)."""
    def make(args):
        args = list(args)
        args[i] = fn(args[i])
        return args
    return make


REJECTS = {
    "grid-3d": _with(0, lambda g: g[0]),
    "grid-dtype": _with(0, lambda g: g.to(torch.complex128)),
    "idx-dtype": _with(1, lambda t: t.to(torch.int32)),
    "idx-shape": _with(1, lambda t: t[:, :-2]),
    "r-batch": _with(2, lambda r: r.expand(3, -1, -1, -1)),
    "r-layers": _with(2, lambda r: r[:, :1]),
    "r-dtype": _with(2, lambda r: r.to(torch.complex128)),
    "wf-shape": _with(3, lambda w: w[:, :-2]),
    "wf-dtype": _with(3, lambda w: w.double()),
    "wf-device": _with(3, lambda w: w.to("meta")),
    "pairs": _with(4, lambda pp: pp[:-1]),
    "nof-sc": _with(5, lambda n: 10_000),
    "grid-device": lambda args: [a.to("meta") if isinstance(a, torch.Tensor) else a
                                 for a in args],
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_wrapper_rejects(case):
    """A wrong shape, dtype or device raises ValueError, on either route."""
    args = REJECTS[case](_valid())
    with pytest.raises(ValueError):
        pusch_estimate.estimate(*args)
    if case != "grid-device":
        with pytest.raises(ValueError):
            pusch_estimate.estimate_plain(*args)


def test_too_few_pairs_rejected():
    """Fewer than 3 CDM pairs: the second differences need 3."""
    cfg = _narrow()
    args = (rx_grids(cfg, [0], seed=7), *estimate_args(cfg, torch.device("cpu")))
    with pytest.raises(ValueError):
        pusch_estimate.estimate(*args)
