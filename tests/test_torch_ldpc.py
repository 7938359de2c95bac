"""Kernel K1's module (srsran_project_tpu_torch/ops/ldpc/decoder.py): the
port's fused rate-dematch + layered min-sum decode, bit for bit against
the JAX package's Pallas kernel run in interpret mode
(``sch._fused_decode(..., interpret=True)``), at a fixed iteration budget.

0 iterations compares the assembled circular buffer's hard decisions (the
dematch map itself); 4 iterations the min-sum arithmetic, including the
unfused r = (+-0.8) * mag, then v + r.  Each call decodes a batch of two
codewords: noisy LLRs of a real codeword and position-dependent LLRs
(any misplaced LLR flips a hard decision)."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_np, to_torch

from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.phy import sch as tsch

# The five geometries of tests/test_fused_dematch_decode.py: one and two
# E-groups, BG1 and BG2, rv 0 and 2, LBRM.
CASES = [
    pytest.param(dict(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                      nof_total_bits=6000, rv=0, tbs_lbrm_bytes=None),
                 id="bg1-single-cb"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=None),
                 id="bg1-two-cbs-two-e-groups"),
    pytest.param(dict(tbs=2000, target_code_rate=0.2, qm=2, nof_layers=1,
                      nof_total_bits=9000, rv=0, tbs_lbrm_bytes=None),
                 id="bg2-low-rate"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=2, tbs_lbrm_bytes=None),
                 id="bg1-rv2"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=0, tbs_lbrm_bytes=2000),
                 id="bg1-lbrm"),
]


def noisy_llrs(cfg, seed: int = 0):
    """(TB, int8 LLRs) of a random TB's rate-matched codeword, +-14 with
    N(0, 4) noise."""
    rng = np.random.default_rng(seed)
    tb = rng.integers(0, 2, size=(cfg.tbs,), dtype=np.uint8)
    cw = np.asarray(jsch.encode_transport_block(jnp.asarray(tb), cfg))
    llr = (1.0 - 2.0 * cw.astype(np.float32)) * 14.0 + rng.normal(0.0, 4.0, size=cw.shape)
    return tb, np.clip(np.round(llr), -120, 120).astype(np.int8)


def position_llrs(g: int) -> np.ndarray:
    """Deterministic position-dependent int8 LLRs, never 0."""
    v = (np.arange(g, dtype=np.int64) * 37 + 11) % 199 - 99
    v[v == 0] = 7
    return np.clip(v, -120, 120).astype(np.int8)


@pytest.mark.parametrize("iters", [0, 4])
@pytest.mark.parametrize("kw", CASES)
def test_fixed_budget_bits_match_pallas(kw, iters):
    cfg_j, cfg_t = jsch.SchConfig(**kw), tsch.SchConfig(**kw)
    assert tsch._fused_decode_ok(cfg_t)
    _, noisy = noisy_llrs(cfg_j)
    llrs = np.stack([noisy, position_llrs(cfg_j.nof_total_bits)])
    want, _ = jsch._fused_decode(jnp.asarray(llrs), cfg_j, iters, early_stop=False,
                                 interpret=True)
    got, got_iters = tsch._fused_decode(to_torch(llrs), cfg_t, iters, early_stop=False)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))
    assert (to_np(got_iters) == iters).all()
