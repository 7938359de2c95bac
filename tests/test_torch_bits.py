"""Bit-level parity of the PyTorch port with the JAX package: CRC, Gold
sequence and (de)scrambling, segmentation, LDPC encoding, rate matching,
the whole transport-block encoder and the DL bit chain, QAM mapping and
LLR quantization.  Every comparison here is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops import crc as jcrc
from srsran_project_tpu.ops import scrambling as jscr
from srsran_project_tpu.ops.ldpc import encoder as jenc
from srsran_project_tpu.ops.ldpc import rate_match as jrm
from srsran_project_tpu.ops.ldpc import segmenter as jseg
from srsran_project_tpu.ops.modulation import demapper as jdemap
from srsran_project_tpu.ops.modulation import mapper as jmap
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.ops import crc as tcrc
from srsran_project_tpu_torch.ops import scrambling as tscr
from srsran_project_tpu_torch.ops.ldpc import encoder as tenc
from srsran_project_tpu_torch.ops.ldpc import rate_match as trm
from srsran_project_tpu_torch.ops.ldpc import segmenter as tseg
from srsran_project_tpu_torch.ops.modulation import demapper as tdemap
from srsran_project_tpu_torch.ops.modulation import mapper as tmap
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import sch as tsch

# Transport-block coding cases: BG1 and BG2, one and several codeblocks,
# one and two E-groups, rv 0 and 2, LBRM on and off.
SCH_CASES = [
    pytest.param(dict(tbs=3000, target_code_rate=0.5, qm=4, nof_layers=1,
                      nof_total_bits=6000, tbs_lbrm_bytes=None), id="bg1-one-cb"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, tbs_lbrm_bytes=None), id="bg1-two-e-groups"),
    pytest.param(dict(tbs=2000, target_code_rate=0.2, qm=2, nof_layers=1,
                      nof_total_bits=9000, tbs_lbrm_bytes=None), id="bg2"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, rv=2, tbs_lbrm_bytes=None), id="bg1-rv2"),
    pytest.param(dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2,
                      nof_total_bits=20032, tbs_lbrm_bytes=2000), id="bg1-lbrm"),
    pytest.param(dict(tbs=40000, target_code_rate=0.8, qm=6, nof_layers=2,
                      nof_total_bits=50004), id="bg1-five-cbs"),
]


def _bits(rng, shape):
    return rng.integers(0, 2, size=shape, dtype=np.uint8)


@pytest.mark.parametrize("name", ["24A", "24B", "16", "11", "6"])
@pytest.mark.parametrize("length", [1, 300, 8392, 16384, 16385, 102440])
def test_crc(name, length):
    rng = np.random.default_rng(length)
    bits = _bits(rng, (3, length))
    np.testing.assert_array_equal(to_np(tcrc.crc(to_torch(bits), name)),
                                  np.asarray(jcrc.crc(jnp.asarray(bits), name)))


def test_crc_check_concat():
    rng = np.random.default_rng(1)
    chunks = _bits(rng, (4, 13, 7880))
    # Make slot 0 pass: append-style CRC over the stream, spread into chunks.
    stream = np.concatenate([chunks[0].reshape(-1)[:-24], np.zeros(24, np.uint8)])
    stream[-24:] = jcrc.crc_ref(stream[:-24], "24A")
    chunks[0] = stream.reshape(13, 7880)
    got = to_np(tcrc.crc_check_concat(to_torch(chunks), "24A"))
    np.testing.assert_array_equal(got, np.asarray(jcrc.crc_check_concat(jnp.asarray(chunks), "24A")))
    assert got[0] and not got[1:].any()


@pytest.mark.parametrize("length", [1, 31, 1000, 126000])
def test_gold_sequence(length):
    seeds = np.array([0, 1, 0x4601 << 15, (1 << 31) - 1, 123456789], np.int64)
    got = to_np(tscr.gold_sequence(torch.from_numpy(seeds), length))
    want = np.asarray(jscr.gold_sequence(jnp.asarray(seeds, jnp.uint32), length))
    np.testing.assert_array_equal(got, want)
    if length <= 1000:
        np.testing.assert_array_equal(got[2], jscr.gold_ref(int(seeds[2]), length))


def test_scramble_and_descramble():
    rng = np.random.default_rng(2)
    seeds = np.array([0x4601 << 15, 77], np.int64)
    bits = _bits(rng, (2, 5000))
    np.testing.assert_array_equal(
        to_np(tscr.scramble_bits(to_torch(bits), torch.from_numpy(seeds))),
        np.asarray(jscr.scramble_bits(jnp.asarray(bits), jnp.asarray(seeds, jnp.uint32))))
    llrs = rng.integers(-128, 128, size=(2, 5000)).astype(np.int8)
    llrs[:, :64] = -128  # the -128 -> +127 saturating flip
    np.testing.assert_array_equal(
        to_np(tscr.descramble_llrs(to_torch(llrs), torch.from_numpy(seeds))),
        np.asarray(jscr.descramble_llrs(jnp.asarray(llrs), jnp.asarray(seeds, jnp.uint32))))


@pytest.mark.parametrize("kw", SCH_CASES)
def test_segment_encode_rate_match(kw):
    cfg_j, cfg_t = jsch.SchConfig(**kw), tsch.SchConfig(**kw)
    seg_j, seg_t = cfg_j.seg, cfg_t.seg
    rng = np.random.default_rng(3)
    tb = _bits(rng, (2, cfg_t.tbs))
    cbs = to_np(tseg.segment_tx(to_torch(tb), seg_t))
    np.testing.assert_array_equal(cbs, np.asarray(jseg.segment_tx(jnp.asarray(tb), seg_j)))

    bg, z = seg_t.base_graph, seg_t.lifting_size
    buf = to_np(tenc.encode_to_buffer(to_torch(cbs), bg, z, n_cb=cfg_t.n_cb))
    np.testing.assert_array_equal(
        buf, np.asarray(jenc.encode_to_buffer(jnp.asarray(cbs), bg, z, n_cb=cfg_j.n_cb)))

    for start, count, e in tsch._e_groups(cfg_t.cb_e_bits):
        args = (bg, z, seg_t.nof_payload_bits_per_cb, e, cfg_t.rv, cfg_t.qm, cfg_t.n_cb)
        grp = buf[:, start : start + count]
        np.testing.assert_array_equal(to_np(trm.rate_match(to_torch(grp), *args)),
                                      np.asarray(jrm.rate_match(jnp.asarray(grp), *args)))

    cw = to_np(tsch.encode_transport_block(to_torch(tb), cfg_t))
    np.testing.assert_array_equal(cw, np.asarray(jsch.encode_transport_block(jnp.asarray(tb), cfg_j)))

    # Desegmentation of the encoded (error-free) codeblocks: payload and CRC.
    tb_out, ok = tseg.desegment_rx(to_torch(cbs), seg_t)
    tb_j, ok_j = jseg.desegment_rx(jnp.asarray(cbs), seg_j)
    np.testing.assert_array_equal(to_np(tb_out), tb)
    np.testing.assert_array_equal(to_np(tb_out), np.asarray(tb_j))
    assert to_np(ok).all() and np.asarray(ok_j).all()
    bad = cbs.copy()
    bad[1, 0, 5] ^= 1
    np.testing.assert_array_equal(to_np(tseg.desegment_rx(to_torch(bad), seg_t)[1]), [True, False])


def test_dl_codeword_24prb_4x4():
    """The whole DL bit chain of the 24-PRB 4x4 cell (two E-groups, 13
    codeblocks), two slots with distinct RNTIs."""
    ref = jcell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4)
    twin = tcell.CellConfig.from_reference(ref)
    rng = np.random.default_rng(4)
    tb = _bits(rng, (2, twin.tbs))
    rntis = np.array([0x4601, 0x1234])
    got = to_np(tpdsch._bit_chain(to_torch(tb), torch.from_numpy(rntis), twin.pdsch_cfg))
    want = np.stack([np.asarray(jpdsch._bit_chain(jnp.asarray(tb[i]), jnp.uint32(rntis[i]),
                                                  ref.pdsch_cfg)) for i in range(2)])
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("mod", ["QAM16", "QAM64", "QAM256"])
def test_map_bits(mod):
    rng = np.random.default_rng(5)
    tm, jm = tmap.Modulation[mod], jmap.Modulation[mod]
    bits = _bits(rng, (2, 480))
    np.testing.assert_array_equal(to_np(tmap.map_bits(to_torch(bits), tm)),
                                  np.asarray(jmap.map_bits(jnp.asarray(bits), jm)))


@pytest.mark.parametrize("mod", ["QAM16", "QAM64", "QAM256"])
def test_demap_soft(mod):
    """Float max-log LLRs agree to float32 rounding (relative 1e-5 of the
    largest LLR: the same elementwise operations, possibly in another
    evaluation order inside XLA's fused loop)."""
    rng = np.random.default_rng(6)
    tm, jm = tmap.Modulation[mod], jmap.Modulation[mod]
    sym = ((rng.standard_normal((2, 600)) + 1j * rng.standard_normal((2, 600))) * 0.7
           ).astype(np.complex64)
    nv = rng.uniform(0.01, 0.2, size=(2, 600)).astype(np.float32)
    got = to_np(tdemap.demap_soft(to_torch(sym), to_torch(nv), tm))
    want = np.asarray(jdemap.demap_soft(jnp.asarray(sym), jnp.asarray(nv), jm))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_quantize_llr_rounds_half_to_even():
    """torch.round and jnp.round both round half to even: pinned at exact
    .5 boundaries of the x6 (120/20) scaling, and the int8 clip."""
    vals = np.array([0.5 / 6, 1.5 / 6, 2.5 / 6, -0.5 / 6, -1.5 / 6, -2.5 / 6,
                     19.9, 20.0, 25.0, -25.0, 0.0, 3.25], np.float32)
    vals = np.concatenate([vals, np.random.default_rng(7).normal(0, 15, 2000).astype(np.float32)])
    got = to_np(tdemap.quantize_llr(to_torch(vals), 20.0))
    want = np.asarray(jdemap.quantize_llr(jnp.asarray(vals), 20.0))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(to_np(torch.round(torch.tensor([0.5, 1.5, 2.5, -0.5]))),
                                  np.asarray(jnp.round(jnp.asarray([0.5, 1.5, 2.5, -0.5]))))
