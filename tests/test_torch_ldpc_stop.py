"""Kernel K1's module, continued: the flagship coding geometry, early stop,
and repetition.

Early stop differs from the reference by design: the port stops per
codeblock, the TPU kernel per batch tile of codeblocks.  A codeblock's
trajectory is the same in both until the port stops it, so its iteration
count never exceeds the reference's, and the TB bits and CRC verdicts of a
decodable codeword are equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ldpc import noisy_llrs, position_llrs
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.ops.ldpc import decoder as tdec
from srsran_project_tpu_torch.phy import sch as tsch

TWO_GROUPS = dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                  nof_total_bits=20032, rv=0, tbs_lbrm_bytes=None)


def test_flagship_geometry_zero_iterations():
    """141 codeblocks, BG1 Z=384, LBRM n_cb=13595, two E-groups: the
    assembled buffer's hard decisions equal the Pallas kernel's."""
    cfg_j = jcell.CellConfig().pusch_cfg.sch
    cfg_t = tsch.SchConfig(tbs=cfg_j.tbs, target_code_rate=cfg_j.target_code_rate,
                           qm=cfg_j.qm, nof_layers=cfg_j.nof_layers,
                           nof_total_bits=cfg_j.nof_total_bits)
    assert (cfg_t.seg.nof_codeblocks, cfg_t.n_cb) == (141, 13595)
    llrs = position_llrs(cfg_j.nof_total_bits)
    want, _ = jsch._fused_decode(jnp.asarray(llrs), cfg_j, 0, early_stop=False, interpret=True)
    got, _ = tsch._fused_decode(to_torch(llrs), cfg_t, 0, early_stop=False)
    np.testing.assert_array_equal(to_np(got), np.asarray(want))


def test_early_stop_tb_and_crc_match():
    cfg_j, cfg_t = jsch.SchConfig(**TWO_GROUPS), tsch.SchConfig(**TWO_GROUPS)
    tbs, llrs = zip(*(noisy_llrs(cfg_j, seed) for seed in (3, 4)))
    llrs = np.stack(llrs)
    bits_j, iters_j = jsch._fused_decode(jnp.asarray(llrs), cfg_j, 6, early_stop=True,
                                         interpret=True)
    tb_j, ok_j = jsch._desegment_stage(bits_j, cfg_j, (2,))
    tb_t, ok_t, _ = tsch.decode_transport_block(to_torch(llrs), cfg_t, 6, early_stop=True)
    np.testing.assert_array_equal(to_np(tb_t), np.asarray(tb_j))
    np.testing.assert_array_equal(to_np(ok_t), np.asarray(ok_j))
    assert to_np(ok_t).all()
    np.testing.assert_array_equal(to_np(tb_t), np.stack(tbs))
    _, iters_t = tsch._fused_decode(to_torch(llrs), cfg_t, 6, early_stop=True)
    assert (to_np(iters_t) <= np.asarray(iters_j)).all()
    assert (to_np(iters_t) < 6).all()


def test_early_stop_per_codeblock_counts():
    """A codeblock whose checks are all satisfied stops after one
    iteration, beside codeblocks that need more (per-codeblock stop)."""
    cfg = tsch.SchConfig(**TWO_GROUPS)
    seg = cfg.seg
    _, noisy = noisy_llrs(jsch.SchConfig(**TWO_GROUPS), seed=5)
    e = cfg.cb_e_bits[-1]
    clean = np.full((1, e), 100, np.int8)  # the all-zero codeword, no noise
    span = np.concatenate([clean, noisy[-e:][None]])
    _, iters = tdec.decode_dematch(to_torch(span), seg.base_graph, seg.lifting_size,
                                   seg.nof_payload_bits_per_cb, e, cfg.rv, cfg.qm,
                                   seg.full_codeword_bits, 6, early_stop=True)
    assert to_np(iters)[0] == 1 and to_np(iters)[1] > 1


def test_repetition_raises():
    """K1 refuses a repetition geometry; decode_transport_block takes the
    two-stage path (K2) for it instead (tests/test_torch_harq.py)."""
    kw = dict(tbs=300, target_code_rate=0.1, qm=2, nof_layers=1, nof_total_bits=4000,
              rv=0, tbs_lbrm_bytes=None)
    cfg = tsch.SchConfig(**kw)
    assert not tsch._fused_decode_ok(cfg) and not jsch._fused_decode_ok(jsch.SchConfig(**kw))
    llrs = torch.zeros((cfg.nof_total_bits,), dtype=torch.int8)
    tb, ok, harq = tsch.decode_transport_block(llrs, cfg)
    assert tb.shape == (300,) and harq.shape == (1, cfg.seg.full_codeword_bits)
    seg = cfg.seg
    e = cfg.cb_e_bits[0]
    with pytest.raises(ValueError, match="no-repetition"):
        tdec.decode_dematch(llrs[:e].reshape(1, e), seg.base_graph, seg.lifting_size,
                            seg.nof_payload_bits_per_cb, e, 0, cfg.qm, seg.full_codeword_bits)
