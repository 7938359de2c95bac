"""The port's slot scans (``models.cell.encode_slots_scan`` /
``decode_slots_scan``) against the reference's on the tiny cell at k = 2
chunks of B = 2 slots: the per-slot IQ energies within rtol 1e-5, the CRC
verdicts and bit-error counts exactly; and each against the port's own
per-chunk ``encode_slot`` / ``decode_slot``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu_torch.models import cell as tcell

K, B = 2, 2
RNTI = 0x4601
SNR_DB = 10.0


@pytest.fixture(scope="module")
def case():
    jcfg = jcell.tiny_cell()
    tcfg = tcell.CellConfig.from_reference(jcfg)
    rng = np.random.default_rng(3)
    tb = rng.integers(0, 2, size=(K, B, jcfg.tbs), dtype=np.uint8)
    rnti = (RNTI + np.arange(K * B, dtype=np.uint32)).reshape(K, B)
    w = np.eye(jcfg.nof_layers, jcfg.nof_ports, dtype=np.complex64)
    # The decode scan's slots all carry tb[0, 0] (its one expected payload)
    # but slot (1, 1), which carries tb[1, 1]: a clean CRC, but every bit
    # where the two TBs differ counts as an error.
    sent = np.broadcast_to(tb[0, 0], tb.shape).copy()
    sent[1, 1] = tb[1, 1]
    iq = np.stack([np.asarray(jcell.encode_slot_fused(jnp.asarray(sent[k, b]),
                                                      jnp.uint32(rnti[k, b]), jnp.asarray(w),
                                                      jcfg))
                   for k in range(K) for b in range(B)]).reshape((K, B) + (jcfg.nof_ports, -1))
    pw = np.mean(np.abs(iq) ** 2)
    noise = (rng.standard_normal(iq.shape) + 1j * rng.standard_normal(iq.shape)) \
        * np.sqrt(pw * 10 ** (-SNR_DB / 10) / 2)
    return jcfg, tcfg, tb, rnti, w, (iq + noise).astype(np.complex64)


def test_encode_slots_scan(case):
    jcfg, tcfg, tb, rnti, w, _iq = case
    want = np.asarray(jcell.encode_slots_scan(jnp.asarray(tb), jnp.asarray(rnti), jnp.asarray(w),
                                              jcfg))
    got = tcell.encode_slots_scan(to_torch(tb), to_torch(rnti.astype(np.int64)), to_torch(w),
                                  tcfg)
    assert got.shape == (K, B) and got.dtype == torch.float32
    np.testing.assert_allclose(to_np(got), want, rtol=1e-5)
    for k in range(K):
        iq = tcell.encode_slot(to_torch(tb[k]), to_torch(rnti[k].astype(np.int64)), to_torch(w),
                               tcfg)
        np.testing.assert_allclose(to_np(got[k]), to_np((iq.abs() ** 2).sum(dim=(1, 2))),
                                   rtol=1e-5)


def test_decode_slots_scan(case):
    jcfg, tcfg, tb, rnti, _w, iq = case
    jok, jerr = jcell.decode_slots_scan(jnp.asarray(iq), jnp.asarray(rnti),
                                        jnp.asarray(tb[0, 0]), jcfg)
    ok, err = tcell.decode_slots_scan(to_torch(iq), to_torch(rnti.astype(np.int64)),
                                      to_torch(tb[0, 0]), tcfg)
    assert ok.dtype == err.dtype == torch.int32 and ok.shape == err.shape == (K, B)
    np.testing.assert_array_equal(to_np(ok), np.asarray(jok))
    np.testing.assert_array_equal(to_np(err), np.asarray(jerr))
    assert to_np(ok).tolist() == [[1, 1], [1, 1]] and int(err[1, 1]) > 0
    assert int(err.sum()) == int(err[1, 1]) == int((tb[1, 1] != tb[0, 0]).sum())
    out = tcell.decode_slot(to_torch(iq[1]), to_torch(rnti[1].astype(np.int64)), tcfg)
    np.testing.assert_array_equal(to_np(out["tb_crc_ok"]).astype(np.int32), to_np(ok[1]))


@pytest.mark.parametrize("fn,shape", [(tcell.encode_slots_scan, (B, 10)),
                                      (tcell.decode_slots_scan, (B, 1, 10))])
def test_scans_want_a_chunk_dimension(fn, shape):
    with pytest.raises(ValueError):
        fn(torch.zeros(shape), torch.zeros((B,)), torch.zeros(10), tcell.tiny_cell())
