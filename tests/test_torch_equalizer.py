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
