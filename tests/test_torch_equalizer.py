"""Kernel K3's module (srsran_project_tpu_torch/ops/equalizer.py): the
port's 4x4 MMSE weights against the JAX package's Pallas kernel in
interpret mode and against a float64 oracle.

Tolerances: against the Pallas kernel, |dW| <= 1e-4 * max(1, max|W|) and,
per element, |d eq_nvar| <= 1e-4 * max(1, |eq_nvar|).  Both sides run the
same float32 algebra in the same order, but XLA:CPU contracts the complex
multiply-adds into FMAs and torch does not; the 4x4 inverse amplifies
those last-bit differences with the channel's conditioning, and
eq_nvar = (1 - mu) / mu amplifies mu's by about eq_nvar itself (measured
up to 8e-5 relative, 1.04e-4 absolute at eq_nvar = 3.1).  Against the
float64 oracle 1e-2, the bound the reference's own test uses."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.ops.equalizer_pallas import equalize_weights_pallas
from srsran_project_tpu_torch.ops import equalizer as teq


def _rand_h(shape, seed=0):
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape + (4, 4)) + 1j * rng.standard_normal(shape + (4, 4)))
            * 0.5).astype(np.complex64)


def _oracle64(h, nv):
    """float64 MMSE weights (as tests/test_equalizer_pallas.py)."""
    h64 = h.astype(np.complex128)
    w = np.empty_like(h64)
    ev = np.empty(h.shape[:1] + (4,), np.float64)
    for i in range(h.shape[0]):
        hm = h64[i]
        g = hm.conj().T @ hm
        ci = np.linalg.inv(g + nv * np.eye(4))
        mu = np.clip(np.real(np.einsum("ij,ji->i", ci, g)), 1e-9, 1 - 1e-9)
        w[i] = (ci @ hm.conj().T) / mu[:, None]
        ev[i] = (1.0 - mu) / mu
    return w, ev


@pytest.mark.parametrize("nsc", [512, 700, 3276])
def test_plain_matches_pallas(nsc):
    h = _rand_h((nsc,))
    nv = np.float32(0.013)
    w_j, e_j = equalize_weights_pallas(jnp.asarray(h), jnp.float32(nv), interpret=True)
    w_t, e_t = teq.mmse_weights_4x4(to_torch(h), torch.tensor(nv))
    w_j, e_j = np.asarray(w_j), np.asarray(e_j)
    assert w_t.shape == (nsc, 4, 4) and e_t.shape == (nsc, 4)
    assert np.abs(to_np(w_t) - w_j).max() <= 1e-4 * max(1.0, np.abs(w_j).max())
    assert (np.abs(to_np(e_t) - e_j) <= 1e-4 * np.maximum(1.0, np.abs(e_j))).all()


def test_plain_matches_f64_oracle():
    h = _rand_h((700,), seed=3)
    nv = 0.013
    w_ref, ev_ref = _oracle64(h, nv)
    w_t, e_t = teq.equalize_weights(to_torch(h), torch.tensor(nv))
    assert np.abs(to_np(w_t) - w_ref).max() < 1e-2
    assert np.abs(to_np(e_t) - ev_ref).max() < 1e-2


def test_slot_batch_uses_each_slots_noise():
    """A leading slot batch with one noise variance per slot gives each
    slot's single-call result exactly."""
    h = _rand_h((3, 100), seed=5)
    nv = np.array([0.01, 0.1, 1e-14], np.float32)  # the last clamps to 1e-12
    w, e = teq.mmse_weights_4x4(to_torch(h), to_torch(nv))
    for s in range(3):
        w1, e1 = teq.mmse_weights_4x4(to_torch(h[s]), torch.tensor(nv[s]))
        np.testing.assert_array_equal(to_np(w[s]), to_np(w1))
        np.testing.assert_array_equal(to_np(e[s]), to_np(e1))


def test_strided_view_equals_contiguous_copy():
    """The (B, nsc, P, L) view of the estimate's (B, P, nsc, L) channels,
    as ``pusch._weights`` hands it over, gives bitwise the weights of its
    contiguous copy: batch 3, 97 subcarriers (no multiple of K3's 64 a
    block), one noise variance per slot."""
    rng = np.random.default_rng(9)
    h = ((rng.standard_normal((3, 4, 97, 4)) + 1j * rng.standard_normal((3, 4, 97, 4)))
         * 0.5).astype(np.complex64)
    nv = to_torch(np.array([1e-13, 0.013, 1.0], np.float32))
    view = to_torch(h).transpose(1, 2)
    assert not view.is_contiguous()
    w_v, e_v = teq.mmse_weights_4x4(view, nv)
    w_c, e_c = teq.mmse_weights_4x4(view.contiguous(), nv)
    np.testing.assert_array_equal(to_np(torch.view_as_real(w_v)), to_np(torch.view_as_real(w_c)))
    np.testing.assert_array_equal(to_np(e_v), to_np(e_c))


def test_pusch_weights_pass_the_estimate_uncopied(monkeypatch):
    """``pusch._weights`` hands K3 a view of the channel estimate, not a
    copy: the kernel reads the estimate's layout through its strides."""
    from srsran_project_tpu_torch.models import cell
    from srsran_project_tpu_torch.phy import pusch

    seen = []

    def spy(h, nv):
        seen.append(h)
        return teq.mmse_weights_4x4(h, nv)

    monkeypatch.setattr(pusch, "mmse_weights_4x4", spy)
    cfg = cell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4).pusch_cfg
    rng = np.random.default_rng(10)
    h = to_torch((rng.standard_normal((2, 4, 288, 4)) + 1j * rng.standard_normal((2, 4, 288, 4)))
                 .astype(np.complex64))  # (B, P, nsc, L)
    w, e = pusch._weights(h, torch.tensor([0.01, 0.02]), cfg)
    assert len(seen) == 1 and seen[0].data_ptr() == h.data_ptr()
    assert seen[0].shape == (2, 288, 4, 4) and not seen[0].is_contiguous()
    w_c, e_c = teq.mmse_weights_4x4(h.transpose(1, 2).contiguous(), torch.tensor([0.01, 0.02]))
    assert torch.equal(w, w_c) and torch.equal(e, e_c)


def test_rejects_bad_inputs():
    with pytest.raises(ValueError):
        teq.mmse_weights_4x4(torch.zeros((10, 4, 2), dtype=torch.complex64), torch.tensor(0.1))
    with pytest.raises(ValueError):
        teq.mmse_weights_4x4(torch.zeros((2, 10, 4, 4), dtype=torch.complex64), torch.tensor(0.1))


# ---- the general path: MMSE and ZF on any ports x layers ---------------------
# Tolerances as above: against the JAX package's ``equalize_weights`` (XLA
# on the CPU, matmuls at HIGHEST precision) |dW| <= 1e-4 * max(1, max|W|)
# and per element |d eq_nvar| <= 1e-4 * max(1, |eq_nvar|); against a
# float64 oracle 1e-2.  The channels are random with condition numbers
# below 20: the float32 error of both sides grows with the square of the
# condition number, and ZF has no noise term to bound it (at 160, a square
# 3x3 ZF differs from the reference by 3.5e-4 x max|W|).

GENERAL_SHAPES = [(2, 1), (2, 2), (4, 2), (4, 3), (3, 3), (4, 4)]


def _oracle64_general(h, nv, method):
    h64 = h.astype(np.complex128)
    hH = np.conj(np.swapaxes(h64, -1, -2))
    g = hH @ h64
    eye = np.eye(h.shape[-1])
    ci = np.linalg.inv(g + (nv if method == "mmse" else 1e-9) * eye)
    w = ci @ hH
    if method == "mmse":
        mu = np.clip(np.real(np.einsum("nij,nji->ni", ci, g)), 1e-9, 1 - 1e-9)
        return w / mu[..., None], (1.0 - mu) / mu
    return w, nv * np.real(np.einsum("nii->ni", ci))


@pytest.mark.parametrize("method", ["mmse", "zf"])
@pytest.mark.parametrize("ports, layers", GENERAL_SHAPES)
def test_general_weights_match_reference(ports, layers, method):
    from srsran_project_tpu.ops.equalizer import equalize_weights as jeq

    rng = np.random.default_rng(10 * ports + layers)
    h = ((rng.standard_normal((900, ports, layers)) + 1j * rng.standard_normal((900, ports, layers)))
         * 0.5).astype(np.complex64)
    h = h[np.linalg.cond(h) < 20][:300]
    nv = np.float32(0.013)
    w_j, e_j = (np.asarray(x) for x in jeq(jnp.asarray(h), jnp.float32(nv), method=method))
    w_t, e_t = (to_np(x) for x in teq.equalize_weights(to_torch(h), torch.tensor(nv), method))
    assert w_t.shape == (300, layers, ports) and e_t.shape == (300, layers)
    assert w_t.dtype == np.complex64 and e_t.dtype == np.float32
    assert np.abs(w_t - w_j).max() <= 1e-4 * max(1.0, np.abs(w_j).max())
    assert (np.abs(e_t - e_j) <= 1e-4 * np.maximum(1.0, np.abs(e_j))).all()
    w64, e64 = _oracle64_general(h, float(nv), method)
    assert np.abs(w_t - w64).max() < 1e-2 and np.abs(e_t - e64).max() < 1e-2


def test_general_4x4_mmse_is_the_k3_plain_version():
    """The general function's 4x4 MMSE case is K3's plain version bit for
    bit, with one noise variance per position as well as per slot."""
    h = _rand_h((2, 200), seed=11)
    nv = np.array([0.01, 0.3], np.float32)
    w_p, e_p = teq.mmse_weights_4x4_plain(to_torch(h), to_torch(nv))
    w_g, e_g = teq.equalize_weights(to_torch(h), to_torch(nv)[:, None])
    assert torch.equal(w_g, w_p) and torch.equal(e_g, e_p)
