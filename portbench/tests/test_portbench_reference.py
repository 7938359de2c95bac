"""The reference against the program on the CPU at small sizes (the
program's plain torch versions, which its kernels equal bitwise): the
transmitter's IQ equal to ``encode_slot``'s, the receiver's answers equal
to ``decode_slot``'s, and the decoder's iteration counts."""

import pytest
import torch

from portbench.reference import ldpc, link, nr
from srsran_project_tpu_torch.models import cell
from srsran_project_tpu_torch.ops.modulation import Modulation

SHAPES = [(24, 4, 4, 8, 948), (12, 2, 2, 6, 567), (20, 4, 1, 4, 490)]


def _pair(nof_rb, ports, layers, qm, rate):
    g = link.Grant(nof_rb=nof_rb, first_rb=0, layers=layers, qm=qm, rate=rate / 1024,
                   nof_ports=ports)
    cfg = cell.CellConfig(nof_rb=nof_rb, nof_ports=ports, nof_layers=layers,
                          modulation=Modulation(qm), target_code_rate=rate / 1024)
    return g, cfg


@pytest.mark.parametrize("shape", SHAPES)
def test_the_transmitter_equals_encode_slot(shape):
    g, cfg = _pair(*shape)
    assert g.tbs == cfg.tbs
    gen = torch.Generator().manual_seed(3)
    tb = torch.randint(0, 2, (2, g.tbs), generator=gen, dtype=torch.uint8)
    rnti = torch.tensor([0x4601, 77])
    w = torch.randn((g.layers, g.nof_ports), generator=gen, dtype=torch.complex64)
    ref = nr.ofdm_modulate(link.port_grid(tb, rnti, w, g), 30, cfg.dft_size, cfg.f_center_hz)
    assert torch.equal(ref, cell.encode_slot(tb, rnti, w, cfg))


@pytest.mark.parametrize("shape", SHAPES)
def test_the_receiver_equals_decode_slot(shape):
    g, cfg = _pair(*shape)
    gen = torch.Generator().manual_seed(4)
    tb = torch.randint(0, 2, (2, g.tbs), generator=gen, dtype=torch.uint8)
    rnti = torch.tensor([9, 0xFFEF])
    w = torch.eye(g.layers, g.nof_ports, dtype=torch.complex64)
    iq = cell.encode_slot(tb, rnti, w, cfg)
    iq = iq + 0.03 * torch.randn(iq.shape, generator=gen, dtype=torch.complex64)
    got = cell.decode_slot(iq, rnti, cfg)
    want = link.receive(nr.ofdm_demodulate(iq, g.nof_rb, 30, cfg.dft_size, cfg.f_center_hz),
                        rnti, g)
    assert bool(want["tb_crc_ok"].all()) and torch.equal(want["tb_bits"], tb)
    assert torch.equal(got["tb_crc_ok"], want["tb_crc_ok"])
    assert torch.equal(got["tb_bits"], want["tb_bits"])
    assert torch.allclose(got["noise_var"], want["noise_var"], rtol=1e-6, atol=0)
    assert torch.allclose(got["snr_db"], want["snr_db"], rtol=0, atol=1e-5)


def test_needed_iterations_are_one_fewer_than_run_where_a_codeblock_stopped():
    g = link.Grant(nof_rb=24, first_rb=0, layers=1, qm=2, rate=0.5, nof_ports=1)
    s = g.seg
    gen = torch.Generator().manual_seed(5)
    bits = link.codeword(torch.randint(0, 2, (1, g.tbs), generator=gen, dtype=torch.uint8), g)
    llr = (1.0 - 2.0 * bits.float()) * 3.0 + 2.5 * torch.randn(bits.shape, generator=gen)
    llr = llr.clamp(-120, 120).round().to(torch.int8)
    (count, e), = g.e_groups
    buf = ldpc.rate_dematch(llr.reshape(count, e), s.bg, s.z, s.k_prime, e, 0, 2, g.n_cb)
    _, run, needed = ldpc.decode(buf, s.bg, s.z, g.n_cb, 20, True)
    stopped = run < 20
    assert bool(stopped.any()) and torch.equal(needed[stopped], run[stopped] - 1)
    _, run_f, needed_f = ldpc.decode(buf, s.bg, s.z, g.n_cb, 4, False)
    assert bool((run_f == 4).all()) and bool((needed_f == 4).all())
