"""Kernel K5's module (srsran_project_tpu_torch/ops/demap_llrs.py) and the
PUSCH demap stage that runs it, on the CPU.

* ``demap_llrs`` on CPU tensors (its plain version) equals the eager
  composition the demap stage ran before it bit for bit: ``demap_soft``,
  the (B, L, ., qm) -> (B, G) re-layout, ``quantize_llr``,
  ``descramble_llrs`` and the per-lane distances of ``evm``; over QPSK and
  16/64/256QAM x 1-4 layers x 1 or 3 slots, with symbols on the
  quantizer's half-points, saturating LLRs and tiny noise variances.
* ``pusch._demap_stage`` gives the LLRs and SINR it gave before, for
  every modulation (BPSK and pi/2-BPSK stay eager), with PT-RS and with
  ``demapper="reference"``; its span counts the lanes and the lanes K5
  demapped (none on the CPU).
* K4 and K5 take their constellation tables from ``csrc/demap_common.cuh``
  alone (tests/test_torch_demap_planes.py holds them to ``pam_levels``),
  and K5's QPSK factor is ``demap_soft``'s float32 value.
* The wrapper rejects a wrong shape, dtype, device or modulation.

The kernel itself runs only on a card: tests/test_torch_cuda.py holds it
against this plain version bitwise.
"""

import functools
import pathlib
import re

import numpy as np
import pytest
import torch

from srsran_project_tpu_torch.ops import demap_llrs as tdl
from srsran_project_tpu_torch.ops import scrambling
from srsran_project_tpu_torch.ops.demap_llrs import demap_llrs, demap_llrs_plain
from srsran_project_tpu_torch.ops.modulation import Modulation, demap_soft, quantize_llr
from srsran_project_tpu_torch.ops.modulation.demapper_i8 import demap_llr_i8
from srsran_project_tpu_torch.ops.modulation.evm import evm
from srsran_project_tpu_torch.ops.modulation.mapper import bits_per_symbol, pam_levels
from srsran_project_tpu_torch.phy import allocation, pusch
from srsran_project_tpu_torch.ran import tbs as tbs_mod
from srsran_project_tpu_torch.support import tracing

SQUARE = [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256]
CSRC = pathlib.Path(tdl.__file__).resolve().parent.parent / "csrc"
SCALE = np.float32(120 / 20.0)


def _pre_round(v: np.ndarray, mod: Modulation, t: int) -> np.ndarray:
    """The plain version's value before rounding of axis bit t at axis
    values v, eq_nvar 1 and range limit 20: numpy float32, each operation
    rounded on its own as torch rounds it on the CPU."""
    v = np.asarray(v, np.float32)
    if mod == Modulation.QPSK:
        llr = (np.float32(2.0 * np.sqrt(2.0)) * v) / np.float32(1.0)
    else:
        levels, labels = pam_levels(mod)
        d2 = [(v - np.float32(x)) * (v - np.float32(x)) for x in levels]
        m1 = np.min([d for k, d in enumerate(d2) if labels[k, t]], axis=0)
        m0 = np.min([d for k, d in enumerate(d2) if not labels[k, t]], axis=0)
        llr = (m1 - m0) * (np.float32(1.0) / np.float32(1.0))
    return llr * SCALE


@functools.lru_cache(maxsize=None)
def _half_points(mod: Modulation) -> tuple:
    """((axis value, bit t, the half-integer its LLR scales to), ...): axis
    values whose scaled LLR of bit t is exactly k + 1/2, |k| < 120, at
    eq_nvar 1 (each bit's crossings of the half-integers on a coarse grid,
    refined over the float32 values next to the crossing)."""
    grid = np.linspace(-1.3, 1.3, 20001).astype(np.float32)
    out = []
    for t in range(bits_per_symbol(mod) // 2):
        pre = _pre_round(grid, mod, t).astype(np.float64)
        for h in np.arange(-119.5, 120.0, 1.0):
            crossings = np.nonzero(np.diff(np.sign(pre - h)) != 0)[0]
            if not crossings.size:
                continue
            i = crossings[0]
            steps = np.arange(-64, 4096) if grid[i] >= 0 else np.arange(-4096, 64)
            cand = (grid[i].view(np.int32) + steps.astype(np.int32)).view(np.float32)
            hit = cand[_pre_round(cand, mod, t) == np.float32(h)]
            if hit.size:
                out.append((float(hit[0]), t, float(h)))
    return tuple(out)


def _inputs(mod: Modulation, layers: int, batch: int, seed: int = 3, n: int = 96):
    """(x_hat (B, n, L) c64, eq_nvar (B, n, L) f32, c_init (B,)): random
    symbols and noise; slot 0's first lanes on the quantizer's
    half-points (real and imaginary parts, eq_nvar 1); lanes that saturate
    (eq_nvar 1e-3 and 1e-30, large symbols) and a few exactly at 0."""
    rng = np.random.default_rng(seed + 10 * layers + int(mod))
    x = (rng.standard_normal((batch, n, layers)) + 1j * rng.standard_normal((batch, n, layers)))
    x = (0.8 * x).astype(np.complex64)
    ev = (0.05 + rng.random((batch, n, layers))).astype(np.float32)
    half = np.array([v for v, _t, _h in _half_points(mod)], np.float32)
    flat_x, flat_ev = x.reshape(-1), ev.reshape(-1)
    k = min(half.size, flat_x.size // 4)
    flat_x[:k] = half[:k] + 1j * half[::-1][:k]
    flat_ev[:k] = 1.0
    sat = slice(k, k + 8)
    flat_x[sat] *= 2.0
    flat_ev[sat] = np.array([1e-3, 1e-30] * 4, np.float32)
    flat_x[k + 8 : k + 10] = 0.0
    flat_ev[k + 10 : k + 14] = 1e-30
    c_init = torch.from_numpy(rng.integers(0, 2 ** 31, size=batch)).to(torch.int64)
    return torch.from_numpy(x), torch.from_numpy(ev), c_init


def _old_composition(x_hat, eq_nvar, c_init, mod, range_limit):
    """The demap stage's eager composition before K5, as it was."""
    b, _, nl = x_hat.shape
    qm = bits_per_symbol(mod)
    llr = demap_soft(x_hat.transpose(1, 2), eq_nvar.transpose(1, 2), mod)
    llr = llr.reshape(b, nl, -1, qm).transpose(1, 2).reshape(b, -1)
    llr_i8 = scrambling.descramble_llrs(quantize_llr(llr, range_limit), c_init)
    s = x_hat.reshape(b, -1)
    levels = torch.from_numpy(pam_levels(mod)[0].astype(np.float32))
    err_re = ((s.real[..., None] - levels) ** 2).amin(dim=-1)
    err_im = ((s.imag[..., None] - levels) ** 2).amin(dim=-1)
    return llr_i8, err_re + err_im


@pytest.mark.parametrize("range_limit", [20.0, 7.5])
@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("layers", [1, 2, 3, 4])
@pytest.mark.parametrize("mod", SQUARE, ids=lambda m: m.name)
def test_plain_matches_old_composition(mod, layers, batch, range_limit):
    """The CPU route equals the old eager composition bitwise: LLRs and the
    per-lane squared distances, whose mean is the old EVM's square."""
    x, ev, c_init = _inputs(mod, layers, batch)
    c = scrambling.gold_sequence(c_init, x.shape[1] * layers * int(mod))
    before = demap_llrs.launches
    llr, err2 = demap_llrs(x, ev, c, mod, range_limit)
    assert demap_llrs.launches == before  # no kernel on the CPU
    llr_o, err2_o = _old_composition(x, ev, c_init, mod, range_limit)
    assert llr.dtype == torch.int8 and err2.dtype == torch.float32
    assert torch.equal(llr, llr_o)
    assert torch.equal(err2.view(torch.int32), err2_o.view(torch.int32))
    assert torch.equal(torch.sqrt(err2.mean(dim=-1)).view(torch.int32),
                       evm(x.reshape(batch, -1), mod).view(torch.int32))
    assert int(llr.abs().max()) == 120  # the saturating lanes reach the clamp


@pytest.mark.parametrize("mod", SQUARE, ids=lambda m: m.name)
def test_half_points_round_to_even(mod):
    """Symbols on the quantizer's half-points are found for every
    modulation, and their LLRs round half to even, as torch.round does."""
    pts = _half_points(mod)
    assert len(pts) >= 10, len(pts)
    v = torch.tensor([[[complex(p, p)] for p, _t, _h in pts]], dtype=torch.complex64)
    ev = torch.ones(v.shape, dtype=torch.float32)
    qm = int(mod)
    c = torch.zeros((1, len(pts) * qm), dtype=torch.uint8)
    llr, _ = demap_llrs(v, ev, c, mod)
    got = llr.reshape(len(pts), qm)
    for i, (_p, t, h) in enumerate(pts):
        want = float(np.rint(h))
        assert want % 2 == 0 and abs(want - h) == 0.5
        assert int(got[i, 2 * t]) == int(got[i, 2 * t + 1]) == want, (i, h, got[i])


def _cfg(mod: Modulation, layers: int, **kw) -> pusch.PuschConfig:
    """A 4-PRB grant of ``mod`` on ``layers`` layers (DM-RS on symbol 2)."""
    alloc = allocation.Allocation(rb_start=0, rb_count=4, sym_start=0, sym_count=14,
                                  dmrs_symbols=(2,))
    qm = bits_per_symbol(mod)
    return pusch.PuschConfig(
        tbs=tbs_mod.calculate_tbs(4, 14, 12, 0.5, qm, layers), target_code_rate=0.5,
        modulation=mod, alloc=alloc, nof_layers=layers, nof_rx_ports=layers, nof_grid_sc=48,
        n_id=7, **kw)


def _old_demap_stage(x_hat, eq_nvar, rnti, cfg):
    """``pusch._demap_stage`` as it was before K5."""
    b, _, nl = x_hat.shape
    qm = cfg.sch.qm
    if cfg.demapper == "reference":
        llr_i8 = demap_llr_i8(x_hat.reshape(b, -1), eq_nvar.reshape(b, -1), cfg.modulation)
    else:
        llr = demap_soft(x_hat.transpose(1, 2), eq_nvar.transpose(1, 2), cfg.modulation)
        llr = llr.reshape(b, nl, -1, qm).transpose(1, 2).reshape(b, -1)
        llr_i8 = quantize_llr(llr, cfg.llr_range_limit)
    llr_i8 = scrambling.descramble_llrs(llr_i8, pusch._pusch_c_init(rnti, cfg.n_id))
    if cfg.ptrs_enabled:
        llr_i8 = llr_i8.index_fill(-1, pusch._ptrs_bits_on(llr_i8.device, cfg), 0)
    e = evm(x_hat.reshape(b, -1), cfg.modulation)
    return llr_i8, 1.0 / torch.clamp_min(e * e, 1e-12)


STAGE_CASES = {
    "bpsk": (Modulation.BPSK, 1, {}),
    "pi2bpsk": (Modulation.PI_2_BPSK, 1, dict(transform_precoding=True)),
    "qpsk-2l": (Modulation.QPSK, 2, {}),
    "16qam-3l": (Modulation.QAM16, 3, {}),
    "64qam-1l": (Modulation.QAM64, 1, {}),
    "256qam-4l": (Modulation.QAM256, 4, {}),
    "256qam-4l-ptrs": (Modulation.QAM256, 4, dict(ptrs_enabled=True)),
    "16qam-2l-ptrs": (Modulation.QAM16, 2, dict(ptrs_enabled=True, ptrs_k=4)),
    "64qam-2l-reference": (Modulation.QAM64, 2, dict(demapper="reference")),
    "qpsk-1l-reference": (Modulation.QPSK, 1, dict(demapper="reference")),
    "256qam-2l-range": (Modulation.QAM256, 2, dict(llr_range_limit=8.0)),
}


@pytest.mark.parametrize("case", sorted(STAGE_CASES))
def test_demap_stage_matches_old(case, monkeypatch):
    """``_demap_stage`` on the CPU gives the LLRs and SINR it gave before,
    bit for bit, and its span counts every lane, none of them K5's."""
    mod, layers, kw = STAGE_CASES[case]
    cfg = _cfg(mod, layers, **kw)
    ndata = allocation.nof_data_re(cfg.alloc)
    rng = np.random.default_rng(len(case))
    b = 2
    x = (rng.standard_normal((b, ndata, layers)) + 1j * rng.standard_normal((b, ndata, layers)))
    x = torch.from_numpy((0.7 * x).astype(np.complex64))
    ev = torch.from_numpy((0.01 + 0.2 * rng.random((b, ndata, layers))).astype(np.float32))
    rnti = torch.tensor([0x4601, 0x17])
    tracer = tracing.l1_tracer
    monkeypatch.setattr(tracer, "_kept", [])
    monkeypatch.setattr(tracer, "enabled", True)
    llr, sinr = pusch._demap_stage(x, ev, rnti, cfg)
    counts = tracer.take().totals["pusch.demap"].counts
    llr_o, sinr_o = _old_demap_stage(x, ev, rnti, cfg)
    assert llr.shape == (b, cfg.g_total)
    assert torch.equal(llr, llr_o)
    assert torch.equal(sinr.view(torch.int32), sinr_o.view(torch.int32))
    assert counts == {"lanes": b * ndata * layers, "kernel_lanes": 0}
    if cfg.ptrs_enabled:
        assert int((llr == 0).sum()) >= b * len(pusch._ptrs_bit_positions(cfg))


def test_demap_stage_on_a_view():
    """Non-contiguous symbols and noise (a transposed layout) give what
    their contiguous copies give."""
    cfg = _cfg(Modulation.QAM64, 2)
    ndata = allocation.nof_data_re(cfg.alloc)
    rng = np.random.default_rng(9)
    xt = torch.from_numpy((rng.standard_normal((1, 2, ndata)) + 1j * rng.standard_normal(
        (1, 2, ndata))).astype(np.complex64))
    evt = torch.from_numpy((0.05 + rng.random((1, 2, ndata))).astype(np.float32))
    rnti = torch.tensor([77])
    got = pusch._demap_stage(xt.transpose(1, 2), evt.transpose(1, 2), rnti, cfg)
    want = pusch._demap_stage(xt.transpose(1, 2).contiguous(),
                              evt.transpose(1, 2).contiguous(), rnti, cfg)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("src", ["demap_planes.cu", "demap_llrs.cu"])
def test_kernels_share_the_tables(src):
    """K4 and K5 both include ``demap_common.cuh`` and keep no constellation
    table of their own (tests/test_torch_demap_planes.py holds the
    header's tables to ``pam_levels``)."""
    text = (CSRC / src).read_text()
    assert '#include "demap_common.cuh"' in text
    assert "struct Pam<" not in text and "kLevels" not in text


def test_k5_qpsk_factor_is_the_demappers():
    """K5's QPSK factor is ``demap_soft``'s float32(2 sqrt 2)."""
    m = re.search(r"kQpskScale = ([0-9.]+)f;", (CSRC / "demap_llrs.cu").read_text())
    assert np.float32(m.group(1)) == np.float32(2.0 * np.sqrt(2.0))


def _valid(mod=Modulation.QAM16, b=2, n=10, layers=3):
    x = torch.zeros((b, n, layers), dtype=torch.complex64)
    ev = torch.ones((b, n, layers), dtype=torch.float32)
    c = torch.zeros((b, n * layers * int(mod)), dtype=torch.uint8)
    return x, ev, c


REJECTS = {
    "x-2d": lambda x, ev, c: (x[0], ev, c, Modulation.QAM16),
    "x-dtype": lambda x, ev, c: (x.to(torch.complex128), ev, c, Modulation.QAM16),
    "ev-shape": lambda x, ev, c: (x, ev[:, :-1], c, Modulation.QAM16),
    "ev-dtype": lambda x, ev, c: (x, ev.double(), c, Modulation.QAM16),
    "c-length": lambda x, ev, c: (x, ev, c[:, :-1], Modulation.QAM16),
    "c-dtype": lambda x, ev, c: (x, ev, c.to(torch.int8), Modulation.QAM16),
    "c-device": lambda x, ev, c: (x, ev, c.to("meta"), Modulation.QAM16),
    "x-device": lambda x, ev, c: (x.to("meta"), ev.to("meta"), c.to("meta"), Modulation.QAM16),
    "bpsk": lambda x, ev, c: (x, ev, c[:, : c.shape[1] // 4], Modulation.BPSK),
    "pi2bpsk": lambda x, ev, c: (x, ev, c[:, : c.shape[1] // 4], Modulation.PI_2_BPSK),
}


@pytest.mark.parametrize("case", sorted(REJECTS))
def test_wrapper_rejects(case):
    """A wrong shape, dtype, device or modulation raises ValueError, on
    either route."""
    args = REJECTS[case](*_valid())
    with pytest.raises(ValueError):
        demap_llrs(*args)
    if case != "x-device":
        with pytest.raises(ValueError):
            demap_llrs_plain(*args)

