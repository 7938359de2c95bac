"""PRACH (phy/prach.py) against the JAX package: the copied tables, the
root and N_CS maps, the CFAR threshold, both preamble generators, the
batched detector and the reference-parity detector.

Tolerances:
* the three ``.npz`` tables, root maps, N_CS, ``threshold_for`` and
  ``detection_threshold_ref``: exact;
* ``generate_preamble`` and ``generate_preamble_ref``: exact (the same
  float64 numpy on the host);
* ``detect``: the same ``detected`` and TA bins, ``metric`` within rtol
  1e-4 (float32 FFTs of two libraries);
* ``detect_ref`` (float32 on the tensor's device, the reference float64
  numpy): the same detected preambles and TA, ``metric`` and ``power``
  within rtol 1e-4.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.phy import prach as jp
from srsran_project_tpu_torch.phy import prach as tp


def _cfgs(**kw):
    jc = jp.PrachConfig(**kw)
    return jc, tp.PrachConfig.from_reference(jc)


@pytest.mark.parametrize("name", ["_prach_roots", "_prach_tables", "_prach_thresholds"])
def test_tables_copy(name):
    """The port's copy of each table equals the reference's."""
    j = np.load(os.path.join(os.path.dirname(jp.__file__), f"{name}.npz"))
    t = np.load(os.path.join(os.path.dirname(tp.__file__), f"{name}.npz"))
    assert sorted(j.files) == sorted(t.files)
    for k in j.files:
        np.testing.assert_array_equal(t[k], j[k])
        assert t[k].dtype == j[k].dtype


def test_roots_ncs_and_thresholds():
    """Root maps, N_CS per format and zero-correlation zone (reserved
    entries raise in both), the config's derived values, the CFAR
    threshold and the validated-table lookup."""
    for l_ra in (839, 139):
        for i in (0, 1, 37, 137, 500, 837, 900):
            assert tp.physical_root(i, l_ra) == jp.physical_root(i, l_ra)
            assert tp.physical_root_ref(i, l_ra) == jp.physical_root_ref(i, l_ra)
        np.testing.assert_array_equal(tp.zc_root(25, l_ra), jp.zc_root(25, l_ra))
    for fmt in ("0", "1", "2", "3", "A1", "B4", "C2"):
        for restricted in ("unrestricted", "type_a", "type_b"):
            for zcz in range(16):
                try:
                    want = jp.prach_ncs(fmt, zcz, restricted)
                except ValueError:
                    with pytest.raises(ValueError):
                        tp.prach_ncs(fmt, zcz, restricted)
                    continue
                assert tp.prach_ncs(fmt, zcz, restricted) == want
    for kw in (dict(), dict(zero_correlation_zone=8, nof_rx_ports=4),
               dict(l_ra=139, zero_correlation_zone=7, nof_rx_ports=2, dft_size=256),
               dict(zero_correlation_zone=0, target_pfa=1e-2), dict(zero_correlation_zone=15)):
        jc, tc = _cfgs(**kw)
        assert (tc.n_cs, tc.nof_shifts, tc.nof_roots) == (jc.n_cs, jc.nof_shifts, jc.nof_roots)
        assert tp.threshold_for(tc) == jp.threshold_for(jc)
    for args in (("0", 1, 8, 1250.0), ("0", 4, 8, 1250.0), ("B4", 2, 7, 30000.0),
                 ("A1", 1, 3, 15000.0), ("C2", 8, 1, 60000.0), ("3", 2, 5, 5000.0)):
        assert tp.detection_threshold_ref(*args) == jp.detection_threshold_ref(*args)


@pytest.mark.parametrize("kw", [dict(), dict(zero_correlation_zone=8, root_sequence_index=22),
                                dict(l_ra=139, zero_correlation_zone=7, root_sequence_index=5),
                                dict(zero_correlation_zone=0)],
                         ids=["long-zcz1", "long-zcz8", "short", "zcz0"])
def test_generate_preamble(kw):
    jc, tc = _cfgs(**kw)
    for pi in (0, 1, 17, 50, 63):
        got = to_np(tp.generate_preamble(tc, pi, device="cpu"))
        assert got.dtype == np.complex64
        np.testing.assert_array_equal(got, jp.generate_preamble(jc, pi))


@pytest.mark.parametrize("fmt, zcz", [("0", 1), ("0", 8), ("1", 12), ("3", 5), ("A1", 3),
                                      ("B4", 7), ("C2", 0)])
def test_generate_preamble_ref(fmt, zcz):
    for root, pi in ((0, 0), (5, 33), (129, 63), (837, 12)):
        got = to_np(tp.generate_preamble_ref(fmt, root, pi, zcz, device="cpu"))
        np.testing.assert_array_equal(got, jp.generate_preamble_ref(fmt, root, pi, zcz))


def _occasion(jc, preambles, ports: int, snr_db: float, seed: int) -> np.ndarray:
    """(ports, L_RA) received preamble subcarriers: each (index, delay in
    bins of the dft_size-point profile) through a random gain per port,
    plus AWGN at snr_db per subcarrier and port."""
    rng = np.random.default_rng(seed)
    n = np.arange(jc.l_ra)
    rx = np.zeros((ports, jc.l_ra), np.complex128)
    for pi, d in preambles:
        g = (rng.standard_normal(ports) + 1j * rng.standard_normal(ports)) / np.sqrt(2)
        x = jp.generate_preamble(jc, pi) / np.sqrt(jc.l_ra)  # unit power a subcarrier
        rx += g[:, None] * x[None] * np.exp(-2j * np.pi * n * d / jc.dft_size)[None]
    sigma = np.sqrt(0.5 * 10 ** (-snr_db / 10))
    rx += sigma * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


DETECT_CASES = {
    # Two roots' worth of preambles at format 0 (N_CS 46, 18 shifts a root).
    "multi-root": (dict(zero_correlation_zone=8, nof_rx_ports=4), ((5, 3), (50, 12)), 4, 0.0),
    "one-port": (dict(zero_correlation_zone=8, root_sequence_index=22), ((3, 0), (21, 30)),
                 1, 10.0),
    # Short format: L_RA 139, N_CS 15, 9 shifts a root, 8 roots.
    "short": (dict(l_ra=139, zero_correlation_zone=7, nof_rx_ports=2, root_sequence_index=5,
                   dft_size=256), ((0, 1), (40, 17)), 2, 5.0),
    "noise-only": (dict(zero_correlation_zone=8, nof_rx_ports=4), (), 4, 0.0),
}


@pytest.mark.parametrize("name", list(DETECT_CASES))
def test_detect(name):
    """The batched detector: detected, metric and TA bins against the
    reference's, and the sent preambles found (none in noise)."""
    kw, preambles, ports, snr_db = DETECT_CASES[name]
    jc, tc = _cfgs(**kw)
    rx = _occasion(jc, preambles, ports, snr_db, seed=len(name))
    want = {k: np.asarray(v) for k, v in jp.detect(jnp.asarray(rx), jc).items()}
    got = {k: to_np(v) for k, v in tp.detect(to_torch(rx), tc).items()}
    np.testing.assert_array_equal(got["detected"], want["detected"])
    np.testing.assert_array_equal(got["ta_samples"], want["ta_samples"])
    np.testing.assert_allclose(got["metric"], want["metric"], rtol=1e-4)
    assert sorted(np.nonzero(got["detected"])[0]) == sorted(pi for pi, _d in preambles)
    # A shift's window starts at the floor of its fractional bin, so the
    # reported TA reads up to one bin late.
    for pi, d in preambles:
        assert 0 <= got["ta_samples"][pi] - d <= 1


def _ref_occasion(fmt, root, zcz, preambles, ports, nof_symbols, snr_db, seed):
    """(ports, nof_symbols, L_RA) frequency-domain symbols for detect_ref:
    each (index, delay in L_RA samples) through a random gain per port,
    repeated over the symbols, plus AWGN."""
    rng = np.random.default_rng(seed)
    l_ra = 839 if fmt in ("0", "1", "2", "3") else 139
    n = np.arange(l_ra)
    rx = np.zeros((ports, nof_symbols, l_ra), np.complex128)
    for pi, d in preambles:
        g = (rng.standard_normal(ports) + 1j * rng.standard_normal(ports)) / np.sqrt(2)
        x = jp.generate_preamble_ref(fmt, root, pi, zcz) * np.exp(-2j * np.pi * n * d / l_ra)
        rx += g[:, None, None] * x[None, None]
    sigma = np.sqrt(0.5 * l_ra * 10 ** (-snr_db / 10))
    rx += sigma * (rng.standard_normal(rx.shape) + 1j * rng.standard_normal(rx.shape))
    return rx.astype(np.complex64)


REF_CASES = {
    "format0": ("0", 1, 8, ((5, 2.0), (50, 9.0)), 2, 1, -5.0),
    "format0-noise": ("0", 1, 8, (), 2, 1, -5.0),
    "format3": ("3", 20, 5, ((7, 1.0),), 1, 4, -5.0),
    "B4": ("B4", 3, 7, ((0, 0.0), (20, 3.0)), 2, 12, 0.0),
    "A1-noise": ("A1", 3, 3, (), 1, 2, 0.0),
}


@pytest.mark.parametrize("name", list(REF_CASES))
def test_detect_ref(name):
    """The reference-parity detector, batched in torch, against the
    reference's numpy loop: the same detected list, TA, metric and
    power."""
    fmt, root, zcz, preambles, ports, nsym, snr_db = REF_CASES[name]
    rx = _ref_occasion(fmt, root, zcz, preambles, ports, nsym, snr_db, seed=len(name))
    want = jp.detect_ref(rx, fmt, root, zcz)
    got = tp.detect_ref(to_torch(rx), fmt, root, zcz)
    assert [r["preamble_index"] for r in got] == [r["preamble_index"] for r in want]
    for g, w in zip(got, want):
        assert g["ta_s"] == w["ta_s"]
        np.testing.assert_allclose(g["metric"], w["metric"], rtol=1e-4)
        np.testing.assert_allclose(g["power"], w["power"], rtol=1e-4)
    found = {r["preamble_index"] for r in got}
    assert {pi for pi, _d in preambles} <= found
