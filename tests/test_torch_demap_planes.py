"""Kernel K4's module (srsran_project_tpu_torch/ops/demap_planes.py) and
the plane path of the flagship decode, against the JAX package.

Tolerances:
* K4's plain version against ``demap_planes_pallas`` in interpret mode
  (every square QAM at 1-4 layers; the port takes the uint8 Gold bits,
  the reference the f32 sign planes made from the same bits): planes
  within +-1 and equal on >= 99.9 % of positions, err2 at rtol
  1e-5 plus atol 1e-7.  XLA on the CPU contracts the reference's
  multiply-adds (the weights apply, the distance squares) into FMAs, the
  port rounds each on its own (ROADMAP Q3): the equalized symbol differs
  in its last bits (~1e-7 at unit power), so an LLR at a rounding boundary
  of the int8 quantizer moves by 1, and a small squared distance d^2
  moves by ~2 d 1e-7 (the atol) where the rtol alone would ask 1e-5 d^2;
* K1 reading the plane layout: bits and iteration counts exact against K1
  reading the stream;
* the plane path end to end (``_front_end_planes`` + ``decode_from_planes``,
  and ``cell.decode_slot`` with ``demapper="planes"``): TB bits and CRC
  exact against the reference's plane functions in interpret mode, and
  the planes within +-1 of theirs.
"""

import pathlib
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_ldpc import noisy_llrs
from torch_parity import to_np, to_torch

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops import ofdm as jofdm
from srsran_project_tpu.ops.demap_pallas import demap_planes_pallas
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.ops import demap_planes as tdp
from srsran_project_tpu_torch.ops import ofdm as tofdm
from srsran_project_tpu_torch.ops.demap_planes import demap_planes
from srsran_project_tpu_torch.ops.ldpc import decoder as tdec
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.ops.modulation.mapper import pam_levels
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import sch as tsch

RNTI = 0x4601


def _inputs(rng, b, p, l, s, n, qm):
    y = (rng.standard_normal((b, p, s, n)) + 1j * rng.standard_normal((b, p, s, n)))
    w = (rng.standard_normal((b, n, l, p)) + 1j * rng.standard_normal((b, n, l, p))) * 0.3
    ev = 0.05 + rng.random((b, n, l))
    c = rng.integers(0, 2, size=(b, s * n * l * qm), dtype=np.uint8)
    return y.astype(np.complex64), w.astype(np.complex64), ev.astype(np.float32), c


def _sign_planes(c, qm):
    """The reference's f32 sign planes of one slot's Gold bits c (G,)."""
    return (1.0 - 2.0 * c.astype(np.float32)).reshape(-1, qm).T.copy()


def _close_planes(got, want):
    d = np.abs(got.astype(np.int32) - want.astype(np.int32))
    assert d.max() <= 1 and (d == 0).mean() >= 0.999, (d.max(), (d == 0).mean())


# Every square QAM at 1-4 layers, with as many ports as layers (P odd and
# even); QAM64 x 4 layers puts a subcarrier's 24 Gold bits off any 16-byte
# boundary.
@pytest.mark.parametrize("l", [1, 2, 3, 4])
@pytest.mark.parametrize("mod", [Modulation.QPSK, Modulation.QAM16, Modulation.QAM64,
                                 Modulation.QAM256], ids=lambda m: m.name)
def test_k4_plain_matches_pallas(mod, l):
    p = l
    rng = np.random.default_rng(int(mod) * 10 + l)
    b, s, n, qm = 2, 5, 96, int(mod)
    y, w, ev, c = _inputs(rng, b, p, l, s, n, qm)
    got, err2 = demap_planes(to_torch(y), to_torch(w), to_torch(ev), to_torch(c), mod)
    assert got.dtype == torch.int8 and got.shape == (b, qm, s * n * l)
    for k in range(b):
        want, want_err2 = demap_planes_pallas(
            jnp.asarray(y[k]), jnp.asarray(w[k]), jnp.asarray(ev[k]),
            jnp.asarray(_sign_planes(c[k], qm)), JModulation(qm), l, p, interpret=True)
        _close_planes(to_np(got[k]), np.asarray(want))
        np.testing.assert_allclose(to_np(err2[k]), np.asarray(want_err2), rtol=1e-5,
                                   atol=1e-7)


def test_k4_descrambles_with_gold_bits():
    """Flipping Gold bit j*qm + t negates plane t at lane j and nothing
    else (the (B, G) stream order of ``scrambling.gold_sequence``)."""
    rng = np.random.default_rng(4)
    b, p, l, s, n, qm = 1, 2, 3, 2, 10, 6
    y, w, ev, c = _inputs(rng, b, p, l, s, n, qm)
    base, _ = demap_planes(to_torch(y), to_torch(w), to_torch(ev), to_torch(c), Modulation.QAM64)
    for j, t in ((0, 0), (7, 5), (s * n * l - 1, 3)):
        c2 = c.copy()
        c2[0, j * qm + t] ^= 1
        got, _ = demap_planes(to_torch(y), to_torch(w), to_torch(ev), to_torch(c2),
                              Modulation.QAM64)
        want = base.clone()
        want[0, t, j] = -want[0, t, j]
        np.testing.assert_array_equal(to_np(got), to_np(want))


_PAM_TABLE = re.compile(
    r"struct Pam<(\d)> \{.*?kLevels\[\d+\] = \{([^}]*)\};.*?kLabels\[\d+\] = \{([^}]*)\};",
    re.S)


def test_k4_constellation_tables_match_pam_levels():
    """K4's compile-time PAM levels and Gray labels (csrc/demap_common.cuh,
    which K4 includes and shares with K5) are pam_levels' float32 values,
    for every square QAM."""
    csrc = pathlib.Path(tdp.__file__).resolve().parent.parent / "csrc"
    assert '#include "demap_common.cuh"' in (csrc / "demap_planes.cu").read_text()
    src = csrc / "demap_common.cuh"
    tables = {int(m): (lv, lab) for m, lv, lab in _PAM_TABLE.findall(src.read_text())}
    assert sorted(tables) == [1, 2, 3, 4]
    for mod in (Modulation.QPSK, Modulation.QAM16, Modulation.QAM64, Modulation.QAM256):
        levels, labels = pam_levels(mod)
        lv, lab = tables[int(mod) // 2]
        got = np.array([np.float32(x.strip().rstrip("f")) for x in lv.split(",")])
        np.testing.assert_array_equal(got.view(np.int32), levels.astype(np.float32).view(np.int32))
        want_lab = (labels << np.arange(labels.shape[1])).sum(axis=1)
        np.testing.assert_array_equal([int(x) for x in lab.split(",")], want_lab)


def test_k1_plane_layout_matches_stream():
    """decode_dematch on (B, qm, count, E/qm) views of the planes equals
    decode_dematch on the (C, E) stream, for both E-groups."""
    kw = dict(tbs=9000, target_code_rate=0.45, qm=8, nof_layers=2, nof_total_bits=20032,
              rv=0, tbs_lbrm_bytes=None)
    cfg = tsch.SchConfig(**kw)
    seg = cfg.seg
    llrs = np.stack([noisy_llrs(jsch.SchConfig(**kw), seed)[1] for seed in (0, 1)])
    planes = to_torch(llrs.reshape(2, -1, cfg.qm).transpose(0, 2, 1).copy())  # (B, qm, G/qm)
    off = 0
    for _s, count, e in tsch._e_groups(cfg.cb_e_bits):
        args = (seg.base_graph, seg.lifting_size, seg.nof_payload_bits_per_cb, e, cfg.rv,
                cfg.qm, seg.full_codeword_bits, 6, True)
        view = planes[:, :, off // cfg.qm : (off + count * e) // cfg.qm].unflatten(
            2, (count, e // cfg.qm))
        stream = to_torch(llrs[:, off : off + count * e].reshape(-1, e))
        bits_p, it_p = tdec.decode_dematch(view, *args)
        bits_s, it_s = tdec.decode_dematch(stream, *args)
        np.testing.assert_array_equal(to_np(bits_p), to_np(bits_s))
        np.testing.assert_array_equal(to_np(it_p), to_np(it_s))
        off += count * e


@pytest.fixture(scope="module")
def plane_cell():
    """The 24-PRB 4x4 cell with demapper="planes": two slots of IQ at 30 dB,
    the reference's plane front end and decode (interpret mode), and the
    port's."""
    jc = jcell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4, demapper="planes")
    tc = tcell.CellConfig.from_reference(jc)
    rng = np.random.default_rng(2)
    tb = rng.integers(0, 2, size=(2, jc.tbs), dtype=np.uint8)
    rntis = np.array([RNTI, RNTI + 1])
    iq = tcell.encode_slot(to_torch(tb), to_torch(rntis), torch.eye(4, dtype=torch.complex64), tc)
    rms = float(iq.abs().pow(2).mean().sqrt())
    noise = (rng.standard_normal(iq.shape) + 1j * rng.standard_normal(iq.shape)) * np.sqrt(0.5)
    rx = iq + to_torch((noise * rms * 10 ** (-30 / 20)).astype(np.complex64))
    out = {"tc": tc, "tb": tb, "rx": rx, "planes_j": [], "tb_j": [], "ok_j": []}
    for k in range(2):
        grid = jofdm.demodulate_slot(jnp.asarray(to_np(rx[k])), jc.nof_rb, jc.scs, jc.dft_size,
                                     jc.cp, 0, f_center_hz=jc.f_center_hz)
        planes, _nv, _snr = jpusch._front_end_planes(grid, jnp.uint32(rntis[k]), jc.pusch_cfg,
                                                      interpret=True)
        tb_j, ok_j = jsch.decode_from_planes(planes, jc.pusch_cfg.sch, 6, early_stop=False,
                                             interpret=True)
        out["planes_j"].append(np.asarray(planes))
        out["tb_j"].append(np.asarray(tb_j))
        out["ok_j"].append(bool(ok_j))
    grid_t = tofdm.demodulate_slot(rx, tc.nof_rb, tc.scs, tc.dft_size, tc.cp, 0,
                                   f_center_hz=tc.f_center_hz)
    out["front_t"] = tpusch._front_end_planes(grid_t, to_torch(rntis), tc.pusch_cfg)
    out["rntis"] = rntis
    return out


def test_plane_front_end_and_decode_match_reference(plane_cell):
    tc = plane_cell["tc"]
    assert tpusch._demap_planes_ok(tc.pusch_cfg)
    planes, nv, snr = plane_cell["front_t"]
    assert planes.shape == (2, 8, tc.pusch_cfg.g_total // 8)
    for k in range(2):
        _close_planes(to_np(planes[k]), plane_cell["planes_j"][k])
    tb, ok = tsch.decode_from_planes(planes, tc.pusch_cfg.sch, 6, early_stop=False)
    np.testing.assert_array_equal(to_np(tb), np.stack(plane_cell["tb_j"]))
    np.testing.assert_array_equal(to_np(ok), np.array(plane_cell["ok_j"]))
    assert to_np(ok).all()
    np.testing.assert_array_equal(to_np(tb), plane_cell["tb"])
    assert np.isfinite(to_np(nv)).all() and (to_np(snr) > 10 ** 2.5).all()


def test_decode_slot_planes_matches_reference_and_float_path(plane_cell):
    tc = plane_cell["tc"]
    out = tcell.decode_slot(plane_cell["rx"], to_torch(plane_cell["rntis"]), tc)
    np.testing.assert_array_equal(to_np(out["tb_bits"]), np.stack(plane_cell["tb_j"]))
    np.testing.assert_array_equal(to_np(out["tb_crc_ok"]), np.array(plane_cell["ok_j"]))
    flt = tcell.decode_slot(plane_cell["rx"], to_torch(plane_cell["rntis"]),
                            tcell.CellConfig(nof_rb=24, nof_ports=4, nof_layers=4))
    np.testing.assert_array_equal(to_np(out["tb_bits"]), to_np(flt["tb_bits"]))
    # The plane path's SINR comes from the kernel's per-lane distances, the
    # float path's from the EVM of the equalized symbols: the same quantity.
    np.testing.assert_allclose(to_np(out["snr_db"]), to_np(flt["snr_db"]), atol=1e-3)
