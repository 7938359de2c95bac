"""Two-step CSI on PUSCH (ROADMAP Q1.8.3) against the JAX package:

* ``ran/csi.py``, the port's copy: every size, the part-1-to-part-2
  correspondence and the (un)packing equal, over port counts, RI
  restrictions and report quantities;
* ``ulsch_demux.decode_csi_two_step`` on noisy LLRs of encoded parts:
  bits, _ok flags, rank and part-2 size equal;
* ``pusch.process`` with a CSI report configuration (mirrors
  tests/test_uci_on_pusch.py::test_two_step_csi_part2_sizing) at ranks 1,
  2 and 4: the rank, part-2 size, CSI bits and TB equal to the reference's
  and to what was sent; int8 LLRs +-1 and >= 99.9 % equal.
``process_multi`` and ``process_slot`` send such grants away with
ValueError (tests/test_torch_pusch_uci.py, tests/test_torch_import.py).
``ack_placeholder_descramble`` (Q1.8.3's last piece; nothing in either
package calls it) equals the reference's on random LLRs.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import assert_llr_gate, to_np, to_torch

from srsran_project_tpu.ops import uci as juci
from srsran_project_tpu.ops.modulation import Modulation
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import ulsch_demux as jdemux
from srsran_project_tpu.phy.allocation import Allocation
from srsran_project_tpu.ran import csi as jcsi
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import ulsch_demux as tdemux
from srsran_project_tpu_torch.ran import csi as tcsi

CONFIGS = [dict(nof_csi_rs_ports=p, nof_csi_rs_resources=r, ri_restriction=ri, quantities=q)
           for p, r, ri, q in itertools.product(
               (1, 2, 4), (1, 3), (0b1111, 0b0101, 0b0010), jcsi.QUANTITIES)]


def _has_rank(kw) -> bool:
    return bool(jcsi.CsiReportConfig(**kw).allowed_ranks)


@pytest.mark.parametrize("kw", [c for c in CONFIGS if _has_rank(c)][::3],
                         ids=lambda kw: "-".join(str(v) for v in kw.values()))
def test_csi_module_copy(kw):
    j, t = jcsi.CsiReportConfig(**kw), tcsi.CsiReportConfig(**kw)
    assert tcsi.CsiReportConfig.from_reference(j) == t
    assert (t.allowed_ranks, t.has_pmi, t.has_li) == (j.allowed_ranks, j.has_pmi, j.has_li)
    for name in ("cri_bitwidth", "ri_bitwidth", "part1_bitwidth", "part2_correspondence",
                 "part2_min_max", "pucch_bitwidth"):
        assert getattr(tcsi, name)(t) == getattr(jcsi, name)(j), name
    rng = np.random.default_rng(0)
    for rank in t.allowed_ranks:
        for name in ("li_bitwidth", "pmi_bitwidth", "cqi2_bitwidth", "part2_bitwidth"):
            assert getattr(tcsi, name)(t, rank) == getattr(jcsi, name)(j, rank), (name, rank)
        cri = int(rng.integers(0, kw["nof_csi_rs_resources"]))
        p1 = tcsi.pack_part1(t, cri, rank, 9)
        np.testing.assert_array_equal(p1, jcsi.pack_part1(j, cri, rank, 9))
        assert tcsi.unpack_part1(t, p1) == jcsi.unpack_part1(j, p1)
        assert tcsi.part2_size_from_part1(t, p1) == jcsi.part2_size_from_part1(j, p1)
        p2 = tcsi.pack_part2(t, rank, li=1, pmi=1, i11=5, i13=1, i2=1)
        np.testing.assert_array_equal(p2, jcsi.pack_part2(j, rank, li=1, pmi=1, i11=5, i13=1,
                                                           i2=1))
        assert tcsi.unpack_part2(t, rank, p2) == jcsi.unpack_part2(j, rank, p2)
        bits = rng.integers(0, 2, tcsi.pucch_bitwidth(t)).astype(np.uint8)
        bits[tcsi.cri_bitwidth(t): tcsi.cri_bitwidth(t) + tcsi.ri_bitwidth(t)] = 0
        assert tcsi.unpack_pucch(t, bits) == jcsi.unpack_pucch(j, bits)


@pytest.mark.parametrize("ports", [2, 4])
def test_decode_csi_two_step(ports):
    """A batch of three reports, one a rank each, CSI part 1 on 60 and part
    2 on 80 coded bits at a few dB: every output of the port's decode
    equals the reference's (run per report)."""
    j, t = jcsi.CsiReportConfig(nof_csi_rs_ports=ports), tcsi.CsiReportConfig(
        nof_csi_rs_ports=ports)
    n1 = jcsi.part1_bitwidth(j)
    _, _, sizes = jcsi.part2_correspondence(j)
    rng = np.random.default_rng(ports)
    l1, l2 = [], []
    for rank in j.allowed_ranks[:3]:
        c1 = np.asarray(juci.encode_uci(jnp.asarray(jcsi.pack_part1(j, 0, rank, 7)), 60))
        p2 = rng.integers(0, 2, jcsi.part2_bitwidth(j, rank)).astype(np.uint8)
        c2 = np.asarray(juci.encode_uci(jnp.asarray(p2), 80))
        for c, out in ((c1, l1), (c2, l2)):
            llr = (1.0 - 2.0 * c) * 6.0 + rng.normal(0.0, 3.0, c.shape)
            out.append(np.clip(np.round(llr), -120, 120).astype(np.int8))
    l1, l2 = np.stack(l1), np.stack(l2)
    got = tdemux.decode_csi_two_step(to_torch(l1), to_torch(l2), t)
    for b in range(len(l1)):
        ref = jdemux.decode_csi_two_step(jnp.asarray(l1[b]), jnp.asarray(l2[b]), j)
        for part in ("csi1", "csi2"):
            np.testing.assert_array_equal(to_np(got[part][0][b]), np.asarray(ref[part][0]))
            assert bool(got[part][1][b]) == bool(ref[part][1])
        assert int(got["rank"][b]) == int(ref["rank"]) == j.allowed_ranks[b]
        assert int(got["nof_csi2_bits"][b]) == int(ref["nof_csi2_bits"]) == sizes[b]
    assert got["csi1"][0].shape == (len(l1), n1)


@pytest.mark.parametrize("rank", [1, 2, 4])
def test_process_two_step(rank):
    report = jcsi.CsiReportConfig(nof_csi_rs_ports=4)
    n1 = jcsi.part1_bitwidth(report)
    ri_off, ri_w, sizes = jcsi.part2_correspondence(report)
    v = report.allowed_ranks.index(rank)
    n2 = sizes[v]
    jcfg = jpusch.PuschConfig(
        tbs=2048, target_code_rate=0.3, modulation=Modulation.QAM16,
        alloc=Allocation(rb_start=0, rb_count=24, sym_start=0, sym_count=14,
                         dmrs_symbols=(2, 11)),
        nof_layers=1, nof_rx_ports=1, nof_grid_sc=288,
        uci=jpusch.UciOnPuschConfig(nof_harq_ack_bits=1, nof_csi1_bits=n1,
                                    nof_csi2_bits=max(sizes), csi_report_cfg=report))
    tcfg = tpusch.PuschConfig.from_reference(jcfg)
    assert tcfg.uci.csi_report_cfg == tcsi.CsiReportConfig(nof_csi_rs_ports=4)
    assert tcfg.uci_mux == tdemux.UlschMuxConfig(**{
        k: getattr(jcfg.uci_mux, k) for k in tdemux.UlschMuxConfig.__dataclass_fields__
        if k != "alloc"}, alloc=tcfg.alloc)

    rng = np.random.default_rng(rank)
    tb = rng.integers(0, 2, size=(tcfg.tbs,), dtype=np.uint8)
    csi1 = np.zeros(n1, np.uint8)
    for k in range(ri_w):
        csi1[ri_off + k] = (v >> (ri_w - 1 - k)) & 1
    csi1[ri_w:] = rng.integers(0, 2, n1 - ri_w)
    csi2 = rng.integers(0, 2, size=(n2,), dtype=np.uint8)
    ack = np.asarray([1], np.uint8)
    rnti = 0x2468
    grid = to_np(tpusch.transmit(to_torch(tb), torch.tensor(rnti), tcfg, to_torch(ack),
                                 to_torch(csi1), to_torch(csi2)))
    rx = (grid + 0.02 * (rng.standard_normal(grid.shape)
                         + 1j * rng.standard_normal(grid.shape))).astype(np.complex64)
    llr_j = np.asarray(jpusch._front_end(jnp.asarray(rx), jnp.uint32(rnti), jcfg)[0])
    llr_t = to_np(tpusch._front_end(to_torch(rx)[None], torch.tensor([rnti]), tcfg)[0][0])
    assert_llr_gate(llr_j, llr_t)
    res_j = jpusch.process(jnp.asarray(rx), jnp.uint32(rnti), jcfg)
    res_t = tpusch.process(to_torch(rx)[None], torch.tensor([rnti]), tcfg)
    assert sorted(res_t) == sorted(res_j)
    for key in res_j:
        if key not in ("harq_buffer", "noise_var", "snr_db"):
            np.testing.assert_array_equal(to_np(res_t[key][0]), np.asarray(res_j[key]), key)
    assert int(res_t["csi_rank"][0]) == rank and int(res_t["nof_csi2_bits"][0]) == n2
    np.testing.assert_array_equal(to_np(res_t["csi1_bits"][0]), csi1)
    np.testing.assert_array_equal(to_np(res_t["csi2_bits"][0])[:n2], csi2)
    np.testing.assert_array_equal(to_np(res_t["harq_ack_bits"][0]), ack)
    np.testing.assert_array_equal(to_np(res_t["tb_bits"][0]), tb)
    assert bool(res_t["tb_crc_ok"][0]) and bool(res_t["csi2_ok"][0])


@pytest.mark.parametrize("qm, nof_ack_bits", [(1, 1), (2, 1), (2, 2), (4, 1), (6, 2), (8, 1),
                                               (4, 3)])
def test_ack_placeholder_descramble(qm, nof_ack_bits):
    rng = np.random.default_rng(qm * 10 + nof_ack_bits)
    llr = rng.integers(-120, 121, size=(2, 24 * qm)).astype(np.int8)
    c = rng.integers(0, 2, size=(2, 24 * qm)).astype(np.uint8)
    got = to_np(tdemux.ack_placeholder_descramble(to_torch(llr), to_torch(c), qm, nof_ack_bits))
    want = np.asarray(jdemux.ack_placeholder_descramble(jnp.asarray(llr), jnp.asarray(c), qm,
                                                        nof_ack_bits))
    np.testing.assert_array_equal(got, want)
    assert got.dtype == want.dtype
