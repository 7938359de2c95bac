"""The reference-exact conformance modes of the port against the JAX
package's, on seeded numpy inputs.

* the numpy estimator oracle's copy equals the reference's ``estimate_port``
  value for value; ``estimator_reftorch.estimate_port_ref`` matches
  ``estimator_refjax.estimate_port_ref`` within rtol 1e-4 (ce, noise,
  SNR, CFO, EPRE, RSRP) and 1 ns on TA;
* ``equalize_ref`` within rtol 1e-5 (atol 1e-6 of the largest value), its
  abnormal cases ((0, inf), excluded ports) exactly;
* ``demap_llr_i8`` and ``decode_i8`` bit for bit (``decode_i8``'s
  a-posteriori LLRs too);
* end to end, ``pusch.process`` in each mode and in the conformance
  combination, ``process_multi``, ``ul_slot.process_slot`` and
  ``CellConfig.decode_slot``: TB bits and CRC exact, int8 LLRs within +-1
  and equal on at least 99.9 % of positions;
* ``du_low_sim`` with the conformance profile and the BLER-parity harness
  on the CPU;
* the faults and limits of ROADMAP Q3 this slice found: PT-RS tracking
  under the reference estimator (repaired, the reference failing),
  ``process_slot`` decoding through K2 whatever ``ldpc_decoder`` says, and
  the CRC-gated two-phase early stop of ``reference_i8``.
"""

import dataclasses
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import (SLOT_PLAN, grant_configs, loopback, process_parity, slot_config,
                          small_slot, to_np)

from srsran_project_tpu.models import cell as jcell
from srsran_project_tpu.ops import equalizer as jeq
from srsran_project_tpu.ops import estimator_ref as jref
from srsran_project_tpu.ops import estimator_refjax as jrefjax
from srsran_project_tpu.ops.ldpc import decoder as jdec
from srsran_project_tpu.ops.ldpc import graphs
from srsran_project_tpu.ops.modulation import Modulation as JMod
from srsran_project_tpu.ops.modulation import demapper_i8 as jdem
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy import sch as jsch
from srsran_project_tpu.phy import ul_slot as jul
from srsran_project_tpu_torch.apps import bler_parity, du_low_sim
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.ops import equalizer as teq
from srsran_project_tpu_torch.ops import estimator_ref as tref
from srsran_project_tpu_torch.ops import estimator_reftorch as trefT
from srsran_project_tpu_torch.ops.ldpc import decoder as tdec
from srsran_project_tpu_torch.ops.modulation import Modulation as TMod
from srsran_project_tpu_torch.ops.modulation import demapper_i8 as tdem
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy import sch as tsch
from srsran_project_tpu_torch.phy import ul_slot as tul

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PAT0, PAT1 = tuple(range(0, 12, 2)), tuple(range(1, 12, 2))


# ---- the reference estimator ------------------------------------------------

def _est_inputs(nof_prb, layers, mask, delay_s=0.0, cfo_hz=0.0, seed=0, ports=2):
    """(grid (ports, 14, nsc) complex64, pilots (layers, nsym_d, Np)
    complex64): QPSK pilots with the frequency OCC on odd layers, each
    layer through a random gain with a delay ramp, a CFO rotation at the
    symbols' CP-cumulative start epochs, random data elsewhere, noise at
    25 dB."""
    rng = np.random.default_rng(seed)
    nsc = nof_prb * 12
    dmrs = [s for s in range(14) if (mask >> s) & 1]
    npil = nof_prb * 6
    qpsk = (rng.choice([-1.0, 1.0], (layers, len(dmrs), npil))
            + 1j * rng.choice([-1.0, 1.0], (layers, len(dmrs), npil))) / np.sqrt(2)
    occ = np.where(np.arange(npil) % 2 == 1, -1.0, 1.0)
    pilots = np.stack([qpsk[l] * (occ if l % 2 else 1.0) for l in range(layers)])
    grid = (rng.standard_normal((ports, 14, nsc)) + 1j * rng.standard_normal((ports, 14, nsc)))
    grid *= np.sqrt(0.5)
    k = np.arange(nsc)
    epochs = jref._symbol_start_epochs(14, 1)
    for p in range(ports):
        for l in range(layers):
            gain = (rng.standard_normal() + 1j * rng.standard_normal()) / np.sqrt(2)
            h = gain * np.exp(-2j * np.pi * k * 30e3 * delay_s)
            res = np.arange(nof_prb)[:, None] * 12 + np.asarray(PAT1 if l >= 2 else PAT0)
            res = res.reshape(-1)
            for si, s in enumerate(dmrs):
                if l % 2 == 0:
                    grid[p, s, res] = 0.0
                rot = np.exp(2j * np.pi * epochs[s] * cfo_hz / 30e3)
                grid[p, s, res] += pilots[l, si] * h[res] * rot
    noise = rng.standard_normal(grid.shape) + 1j * rng.standard_normal(grid.shape)
    grid = grid + noise * np.sqrt(0.5 * 10 ** -2.5)
    return grid.astype(np.complex64), pilots.astype(np.complex64)


# (layers, DM-RS symbol mask, smoothing, time-domain strategy, CFO
# compensation, delay s, CFO Hz)
EST_CASES = {
    "1l-filter": (1, 1 << 2, "filter", "average", False, 0.3e-6, 0.0),
    "2l-cfo": (2, (1 << 2) | (1 << 11), "filter", "average", True, 0.1e-6, 300.0),
    "3l-mean-interp": (3, (1 << 2) | (1 << 7) | (1 << 11), "mean", "interpolate", True, 0.0,
                       -150.0),
    "4l-none": (4, 1 << 3, "none", "average", False, -0.2e-6, 0.0),
    "4l-filter-interp-nocfo": (4, (1 << 2) | (1 << 11), "filter", "interpolate", False, 0.5e-6,
                               200.0),
}


def _est_cfg(module, case, nof_prb=24):
    layers, mask, smoothing, td, cfo = case[:5]
    cls = getattr(module, "RefEstimatorConfig", None) or module.EstimatorConfig
    return cls(scs_khz=30, nof_prb=nof_prb, first_symbol=0, nof_symbols=14,
               dmrs_symbol_mask=mask, re_pattern=PAT0,
               re_pattern2=PAT1 if layers > 2 else None, nof_layers=layers, scaling=1.4,
               smoothing=smoothing, td_strategy=td, compensate_cfo=cfo)


@pytest.mark.parametrize("name", EST_CASES)
def test_oracle_copy_equals_the_reference(name):
    case = EST_CASES[name]
    grid, pilots = _est_inputs(24, case[0], case[1], *case[5:], seed=1, ports=1)
    a = jref.estimate_port(grid[0], pilots, _est_cfg(jref, case))
    b = tref.estimate_port(grid[0], pilots, _est_cfg(tref, case))
    np.testing.assert_array_equal(a.ce, b.ce)
    for f in ("noise_var", "rsrp", "epre", "snr", "time_alignment_s", "cfo_hz"):
        assert getattr(a, f) == getattr(b, f), f


@pytest.mark.parametrize("name", EST_CASES)
def test_estimate_port_ref(name):
    """Two ports in one call against the JAX function per port."""
    case = EST_CASES[name]
    grid, pilots = _est_inputs(24, case[0], case[1], *case[5:], seed=2)
    got = trefT.estimate_port_ref(torch.from_numpy(grid), torch.from_numpy(pilots),
                                  _est_cfg(trefT, case))
    for p in range(grid.shape[0]):
        want = jrefjax.estimate_port_ref(jnp.asarray(grid[p]), jnp.asarray(pilots),
                                         _est_cfg(jrefjax, case))
        for k in ("ce", "freq_resp", "noise_var", "snr", "cfo", "epre", "rsrp"):
            w, g = np.asarray(want[k]), to_np(got[k][p])
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-4 * np.abs(w).max() + 1e-30,
                                       err_msg=f"{name} port {p} {k}")
        assert abs(float(got["ta_s"][p]) - float(want["ta_s"])) < 1e-9, name
    if case[5]:  # the delay is found
        assert abs(float(got["ta_s"][0]) - case[5]) < 0.05e-6, (name, float(got["ta_s"][0]))


# ---- the reference equalizer ------------------------------------------------

@pytest.mark.parametrize("layers, ports", [(1, 1), (1, 2), (1, 4), (2, 2), (2, 4)])
def test_equalize_ref(layers, ports):
    """Random channels: rtol 1e-5 on every RE whose channel has a condition
    number up to 10.  The 2-layer adjugate's denominator g00 g11 - |xi|^2
    cancels as cond(H)^2, so float32 rounding differences grow with it:
    every RE within a relative 1e-6 cond(H)^2 (the worst measured is
    4.6e-7 cond^2)."""
    rng = np.random.default_rng(10 * layers + ports)
    nre = 300
    h = ((rng.standard_normal((nre, ports, layers)) + 1j * rng.standard_normal(
        (nre, ports, layers))) / np.sqrt(2)).astype(np.complex64)
    y = ((rng.standard_normal((nre, ports)) + 1j * rng.standard_normal((nre, ports)))
         ).astype(np.complex64)
    nv = rng.uniform(0.01, 0.2, ports).astype(np.float32)
    cond = np.linalg.cond(h)[:, None]
    for method in ("zf", "mmse") if layers == 1 else ("zf",):
        xj, vj = jeq.equalize_ref(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv), 1.0, method)
        xt, vt = teq.equalize_ref(torch.from_numpy(y), torch.from_numpy(h), torch.from_numpy(nv),
                                  1.0, method)
        for g, w in ((to_np(xt), np.asarray(xj)), (to_np(vt), np.asarray(vj))):
            rel = np.abs(g - w) / np.abs(w)
            assert rel[(cond <= 10).repeat(layers, 1)].max() <= 1e-5, (method, rel.max())
            assert (rel <= 1e-6 * np.maximum(cond, 1.0) ** 2).all(), (method, rel.max())


def test_equalize_ref_abnormal_cases():
    """A zero channel gives (0, inf) and a port with zero noise is left out
    of the 1-layer sums (the result is the other port's alone, to float32
    rounding: torch's vector and scalar complex products round apart);
    with no usable port every RE is (0, inf); a 2-layer channel with a
    silent layer gives (0, inf): the reference's values, exactly."""
    rng = np.random.default_rng(3)
    h = ((rng.standard_normal((6, 2, 1)) + 1j * rng.standard_normal((6, 2, 1)))
         ).astype(np.complex64)
    h[0] = 0.0
    y = (rng.standard_normal((6, 2)) + 1j * rng.standard_normal((6, 2))).astype(np.complex64)
    t = torch.from_numpy
    nv = np.asarray([0.1, 0.0], np.float32)
    xj, vj = jeq.equalize_ref(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    xt, vt = teq.equalize_ref(t(y), t(h), t(nv))
    assert to_np(xt)[0, 0] == 0 == np.asarray(xj)[0, 0]
    assert to_np(vt)[0, 0] == np.inf == np.asarray(vj)[0, 0]
    np.testing.assert_allclose(to_np(xt), np.asarray(xj), rtol=1e-5)
    np.testing.assert_allclose(to_np(vt), np.asarray(vj), rtol=1e-5)
    x0, v0 = teq.equalize_ref(t(y[:, :1]), t(h[:, :1]), t(nv[:1]))
    np.testing.assert_allclose(to_np(xt), to_np(x0), rtol=1e-6)
    np.testing.assert_allclose(to_np(vt), to_np(v0), rtol=1e-6)
    nv = np.zeros(2, np.float32)
    xj, vj = jeq.equalize_ref(jnp.asarray(y), jnp.asarray(h), jnp.asarray(nv))
    xt, vt = teq.equalize_ref(t(y), t(h), t(nv))
    np.testing.assert_array_equal(to_np(xt), np.asarray(xj))
    np.testing.assert_array_equal(to_np(vt), np.asarray(vj))
    assert not to_np(xt).any() and np.isinf(to_np(vt)).all()
    h2 = np.concatenate([h, np.zeros_like(h)], axis=-1)  # a silent layer: singular
    xj, vj = jeq.equalize_ref(jnp.asarray(y), jnp.asarray(h2), jnp.asarray([0.1, 0.2]))
    xt, vt = teq.equalize_ref(t(y), t(h2), torch.tensor([0.1, 0.2]))
    np.testing.assert_array_equal(to_np(xt), np.asarray(xj))
    np.testing.assert_array_equal(to_np(vt), np.asarray(vj))
    assert np.isinf(to_np(vt)).all()
    with pytest.raises(ValueError, match="1-2 layers"):
        teq.equalize_ref(t(y), t(np.repeat(h, 3, -1)), torch.tensor([0.1, 0.2]))


# ---- the int8 demapper --------------------------------------------------------

@pytest.mark.parametrize("mod", [0, 1, 2, 4, 6, 8])
def test_demap_llr_i8(mod):
    """Random symbols with exact zeros and near-zero components, noise
    variances 0, tiny, huge, negative and NaN among them."""
    rng = np.random.default_rng(mod)
    n = 4000
    x = ((rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.8).astype(np.complex64)
    x[:10] = 0.0
    x[10:20] = 1e-10 - 1e-10j
    x[20:30] = 50.0 + 50.0j
    nv = np.abs(rng.standard_normal(n) * 0.3).astype(np.float32)
    nv[:50], nv[50:60], nv[60:70], nv[70:80], nv[80:85] = 0.0, 1e6, 1e-7, -1.0, np.nan
    want = np.asarray(jdem.demap_llr_i8(jnp.asarray(x), jnp.asarray(nv), JMod(mod)))
    got = to_np(tdem.demap_llr_i8(torch.from_numpy(x), torch.from_numpy(nv), TMod(mod)))
    np.testing.assert_array_equal(got, want)


# ---- the int8 layered min-sum decoder ---------------------------------------------

@pytest.mark.parametrize("bg, z, nof_layers, iters", [
    (1, 8, None, 6), (1, 4, 20, 5), (2, 16, None, 3), (2, 5, None, 6), (2, 10, 8, 2)])
def test_decode_i8(bg, z, nof_layers, iters):
    """Noisy int32 LLRs with runs at +-64, +-127 and beyond int8."""
    rng = np.random.default_rng(bg * 100 + z)
    n = (graphs.get_graph(bg, z).n - 2) * z
    x = np.round(rng.standard_normal((3, n)) * 30).astype(np.int32)
    x[0, :6], x[1, :6], x[2, :6] = 127, -127, 64
    x[0, 6:9], x[1, 6:9], x[2, 6:9] = 500, -300, -64
    want_bits, want_app = jdec.decode_i8(jnp.asarray(x), bg, z, iters, nof_layers)
    bits, app = tdec.decode_i8(torch.from_numpy(x), bg, z, iters, nof_layers)
    np.testing.assert_array_equal(to_np(bits), np.asarray(want_bits))
    np.testing.assert_array_equal(to_np(app), np.asarray(want_app))
    assert app.dtype == torch.int32 and int(app.abs().max()) <= tdec.LLR_INF


# ---- end to end -----------------------------------------------------------------

REF_ALL = dict(estimator="reference", equalizer="zf_ref", demapper="reference",
               ldpc_decoder="reference_i8")
# name -> (grant_configs arguments, PuschConfig fields)
MODES = {
    "estimator": ({}, dict(estimator="reference")),
    "estimator-4x4": (dict(layers=4, ports=4), dict(estimator="reference")),
    "estimator-cfo-ta": (dict(dmrs_symbols=(2, 11)),
                         dict(estimator="reference", cfo_compensation=True, compute_ta=True,
                              sinr_method="channel_estimator")),
    "mmse_ref": ({}, dict(equalizer="mmse_ref")),
    "zf_ref": (dict(layers=2), dict(equalizer="zf_ref")),
    "demapper": ({}, dict(demapper="reference")),
    "reference_i8": ({}, dict(ldpc_decoder="reference_i8")),
    "conformance": (dict(layers=2, modulation=6, dmrs_symbols=(2, 11)), REF_ALL),
}


@pytest.mark.parametrize("name", MODES)
def test_process_mode(name):
    """pusch.process and the front end of one 24-PRB grant (the port's UE
    side, a random unitary channel, 30 dB) in both packages."""
    grant, fields = MODES[name]
    jtx, jrx = grant_configs(nof_rb=24, **grant)
    jrx = dataclasses.replace(jrx, **fields)
    tb, rnti, rx = loopback(jtx, jrx, seed=3, snr_db=30.0)
    res_j, res_t = process_parity(jrx, rx, rnti, tb)
    if jrx.compute_ta:
        assert abs(float(res_t["ta_s"]) - float(res_j["ta_s"])) < 1e-9


def _slot_configs(package, modulation_cls, fields):
    """The small slot's grant configs in one package, with ``fields``."""
    return [dataclasses.replace(slot_config(package, modulation_cls, nrb, mcs, rb0), **fields)
            for _r, rb0, nrb, mcs in SLOT_PLAN]


def test_process_multi_reference_estimator():
    """UEs 0 and 1 of the small slot (equal configs at PRB 0 and 8, UE 1
    not attenuated) in one process_multi batch, reference estimator."""
    _, tbs, grid = small_slot(atten_db=0.0)
    fields = dict(estimator="reference")
    cfg = dataclasses.replace(slot_config(tpusch, TMod, 8, 20, 0), **fields)
    jcfg = dataclasses.replace(slot_config(jpusch, JMod, 8, 20, 0), **fields)
    rntis = [SLOT_PLAN[0][0], SLOT_PLAN[1][0]]
    first_rbs = [SLOT_PLAN[0][1], SLOT_PLAN[1][1]]
    res_j = jpusch.process_multi(jnp.asarray(to_np(grid)), np.asarray(rntis, np.uint32),
                                 first_rbs, jcfg)
    res_t = tpusch.process_multi(grid, rntis, first_rbs, cfg)
    for i in range(2):
        assert bool(res_t["tb_crc_ok"][i]) and bool(res_j["tb_crc_ok"][i])
        np.testing.assert_array_equal(to_np(res_t["tb_bits"][i]), tbs[i])
        np.testing.assert_array_equal(np.asarray(res_j["tb_bits"][i]), tbs[i])
        assert abs(float(res_t["snr_db"][i]) - float(res_j["snr_db"][i])) <= 1e-3


def test_process_slot_reference_front_end_decodes_through_k2(monkeypatch):
    """process_slot with the reference estimator, equalizer and demapper on
    every grant and ldpc_decoder="reference_i8": the slot's grants match
    the reference's slot, and the code groups still decode through
    ``decode`` (K2 on the card), never ``decode_i8``, as the reference's
    ``_decode_group`` does (ROADMAP Q3)."""
    _, tbs, grid = small_slot(atten_db=0.0)
    fields = dict(estimator="reference", equalizer="mmse_ref", demapper="reference",
                  ldpc_decoder="reference_i8")
    calls = {"decode": 0}
    real = tul.decode

    def counted(*a, **k):
        calls["decode"] += 1
        return real(*a, **k)

    def no_i8(*a, **k):
        raise AssertionError("process_slot ran decode_i8")

    monkeypatch.setattr(tul, "decode", counted)
    monkeypatch.setattr(tsch, "decode_i8", no_i8)
    plan = [(r, rb0) for r, rb0, _n, _m in SLOT_PLAN]
    res_t = tul.process_slot(grid, [tul.UlSlotPdu(rnti=r, first_rb=rb0, config=c) for (r, rb0), c
                                    in zip(plan, _slot_configs(tpusch, TMod, fields))])[0]
    assert calls["decode"] == len({(c.sch.seg.base_graph, c.sch.seg.lifting_size, c.sch.n_cb)
                                   for c in _slot_configs(tpusch, TMod, fields)})
    res_j = jul.process_slot(jnp.asarray(to_np(grid)), [
        jul.UlSlotPdu(rnti=r, first_rb=rb0, config=c)
        for (r, rb0), c in zip(plan, _slot_configs(jpusch, JMod, fields))])[0]
    for i, tb in enumerate(tbs):
        assert bool(res_t[i]["tb_crc_ok"]) and bool(res_j[i]["tb_crc_ok"]), i
        np.testing.assert_array_equal(to_np(res_t[i]["tb_bits"]), tb)
        np.testing.assert_array_equal(np.asarray(res_j[i]["tb_bits"]), tb)
        assert abs(float(res_t[i]["snr_db"]) - float(res_j[i]["snr_db"])) <= 1e-3


def test_cell_decode_slot_reference_modes():
    """CellConfig with the reference equalizer, demapper and decoder
    through encode_slot / decode_slot, against the reference's decode_slot
    on the same IQ."""
    kw = dict(nof_rb=24, nof_ports=2, nof_layers=1, modulation=4, target_code_rate=0.5,
              equalizer="mmse_ref", demapper="reference", ldpc_decoder="reference_i8")
    tcfg = tcell.CellConfig(**{**kw, "modulation": TMod(4)})
    jcfg = jcell.CellConfig(**{**kw, "modulation": JMod(4)})
    assert tcell.CellConfig.from_reference(jcfg) == tcfg
    rng = np.random.default_rng(5)
    tb = torch.from_numpy(rng.integers(0, 2, size=(2, tcfg.tbs), dtype=np.uint8))
    w = torch.eye(1, 2, dtype=torch.complex64) / np.sqrt(2)
    iq = tcell.encode_slot(tb, 0x4601, w, tcfg)
    noise = rng.standard_normal(iq.shape + (2,)) * np.sqrt(0.5 * float((iq.abs() ** 2).mean())
                                                          * 10 ** -2.5)
    iq = iq + torch.from_numpy((noise[..., 0] + 1j * noise[..., 1]).astype(np.complex64))
    out = tcell.decode_slot(iq, 0x4601, tcfg)
    for b in range(2):
        res_j = jcell.decode_slot(jnp.asarray(to_np(iq[b])), jnp.uint32(0x4601), jcfg)
        assert bool(out["tb_crc_ok"][b]) and bool(res_j["tb_crc_ok"])
        np.testing.assert_array_equal(to_np(out["tb_bits"][b]), to_np(tb[b]))
        np.testing.assert_array_equal(np.asarray(res_j["tb_bits"]), to_np(tb[b]))
        assert abs(float(out["snr_db"][b]) - float(res_j["snr_db"])) <= 1e-3


def test_du_low_sim_conformance_profile(capsys):
    assert du_low_sim.main(["--config", os.path.join(REPO, "configs", "conformance_parity.yml"),
                            "--cpu", "--slots", "2"]) == 0
    err = capsys.readouterr().err
    assert "# cell: 52 PRB, 2x1" in err and "# 2 slots in " in err


def test_conformance_profile_slot_against_the_reference():
    """One slot of the conformance profile (52 PRB, 2x1 16QAM, mmse_ref,
    the int8 demapper and decoder, no early stop) through both packages'
    UpperPhy on the same received grid: CRC, TB bits and snr_db."""
    from srsran_project_tpu.fapi import messages as jfapi
    from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
    from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
    from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
    from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
    from srsran_project_tpu.support import config as jconfig
    from srsran_project_tpu_torch.phy import channel_emulator as tchem
    from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
    from srsran_project_tpu_torch.support import config as tconfig

    path = os.path.join(REPO, "configs", "conformance_parity.yml")
    cell = tconfig.to_cell_config(tconfig.load_config(path))
    jc = jconfig.to_cell_config(jconfig.load_config(path))
    assert tcell.CellConfig.from_reference(jc) == cell
    assert (cell.pusch_cfg.equalizer, cell.pusch_cfg.demapper, cell.pusch_cfg.ldpc_decoder) == (
        "mmse_ref", "reference", "reference_i8")
    tb = np.random.default_rng(0).integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
    dl, tx_data, ul = du_low_sim.slot_requests(cell, 0, tb)
    tphy = UpperPhy(UpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                   device="cpu"))
    ch = tchem.ChannelConfig(profile="tdla", sinr_db=25.0, nof_tx_ports=cell.nof_ports,
                             nof_rx_ports=cell.nof_ports, nof_sc=cell.nof_sc, scs=cell.scs)
    rx, _, _ = tchem.apply_channel(tphy.process_dl_tti(dl, tx_data),
                                   torch.Generator().manual_seed(1), ch)
    res_t = tphy.process_ul_tti(ul, rx)
    jphy = JUpperPhy(JUpperPhyConfig(nof_ports=jc.nof_ports, nof_grid_sc=jc.nof_sc))
    res_j = jphy.process_ul_tti(
        jfapi.UlTtiRequest(slot=JSlot.from_sfn_slot(JScs(int(jc.scs)), 0, 0),
                           pusch=[jfapi.UlPuschPdu(jc.pusch_cfg, du_low_sim.RNTI)]), to_np(rx))
    assert res_t.crc[0].tb_crc_ok and res_j.crc[0].tb_crc_ok
    assert abs(res_t.crc[0].snr_db - res_j.crc[0].snr_db) <= 1e-3
    np.testing.assert_array_equal(res_t.rx_data[0].payload, np.asarray(res_j.rx_data[0].payload))
    np.testing.assert_array_equal(res_t.rx_data[0].payload, tb)


def test_bler_parity_single_tap_is_crc_clean():
    """Manifest row 7 (single tap, 60 dB, 64QAM r 0.55 on 52 PRB) through
    the harness on the CPU, reference estimator: CRC-clean, as the
    reference measured."""
    with open(os.path.join(REPO, "tests", "golden", "bler_parity", "manifest.json")) as f:
        case = json.load(f)[7]
    res = bler_parity.run_case(case, 4, chunk=2, parity_kernels=True, device="cpu")
    assert res["crc_bler"] == 0.0 and res["data_bler"] == 0.0, res
    assert res["nof_slots"] == 4 and 1 <= res["iter_min"] <= res["iter_max"] <= 6
    assert abs(res["crc_bler"] - case["crc_bler"]) <= bler_parity.bler_bound(case, 4)


# ---- faults and limits (ROADMAP Q3) ----------------------------------------------

def test_ptrs_tracking_under_the_reference_estimator():
    """A PT-RS grant under a random phase per data symbol (+-1.5 rad, 1
    port, 16QAM r 0.3): the reference's estimator="reference" returns
    before its PT-RS tracking and fails the CRC, where its fast estimator
    passes; the port tracks PT-RS after the reference estimate too and
    passes.  Without PT-RS both fail."""
    for ptrs in (True, False):
        jtx, jrx = grant_configs(nof_rb=24, ports=1, rate=0.3, ptrs_enabled=ptrs)
        tb, rnti, rx = loopback(jtx, jrx, seed=1, snr_db=31.0, phase_noise=1.5,
                                channel=np.eye(1, dtype=np.complex64))
        ok = {}
        for est in ("fast", "reference"):
            jr = dataclasses.replace(jrx, estimator=est)
            ok["jax", est] = bool(jpusch.process(jnp.asarray(rx), jnp.uint32(rnti), jr)
                                  ["tb_crc_ok"])
            out = tpusch.process(torch.from_numpy(rx)[None], torch.tensor([rnti]),
                                 tpusch.PuschConfig.from_reference(jr))
            ok["port", est] = bool(out["tb_crc_ok"][0])
            if ok["port", est]:
                np.testing.assert_array_equal(to_np(out["tb_bits"][0]), tb)
        if ptrs:
            assert ok == {("jax", "fast"): True, ("port", "fast"): True,
                          ("jax", "reference"): False, ("port", "reference"): True}, ok
        else:
            assert not any(ok.values()), ok


def test_reference_i8_early_stop_is_crc_gated():
    """``decoder="reference_i8"`` with early stop runs 2 iterations and the
    whole budget only when some codeblock's CRC fails (the reference's CPU
    branch; its TPU branch runs the whole budget): a clean codeword
    decodes with the 2-iteration bits, a noisy one with the full budget's,
    and both equal the reference's decode_transport_block."""
    jtx, jrx = grant_configs(nof_rb=24, rate=0.6)
    trx = tpusch.PuschConfig.from_reference(jrx)
    seg = trx.sch.seg
    rng = np.random.default_rng(9)
    tb = rng.integers(0, 2, size=(trx.tbs,), dtype=np.uint8)
    cw = tsch.encode_transport_block(torch.from_numpy(tb), trx.sch)
    clean = (1 - 2 * cw.to(torch.int32)) * 20
    for name, noise in (("clean", 0.0), ("noisy", 55.0)):
        llr = (clean + torch.from_numpy(np.round(rng.standard_normal(clean.shape) * noise)
                                        .astype(np.int32))).clamp(-127, 127).to(torch.int8)
        jcfg = dataclasses.replace(jrx.sch, decoder="reference_i8")
        tcfg = dataclasses.replace(trx.sch, decoder="reference_i8")
        want = jsch.decode_transport_block(jnp.asarray(to_np(llr)), jcfg, 6, early_stop=True)
        got = tsch.decode_transport_block(llr, tcfg, 6, early_stop=True)
        np.testing.assert_array_equal(to_np(got[0]), np.asarray(want[0]))
        assert bool(got[1]) == bool(want[1]), name
        buf = tsch._dematch_stage(llr, None, tcfg)
        two = tdec.decode_i8(buf, seg.base_graph, seg.lifting_size, 2)[0]
        six = tdec.decode_i8(buf, seg.base_graph, seg.lifting_size, 6)[0]
        two_ok = not bool(tsch.crc_mod.crc(two[:, : seg.nof_payload_bits_per_cb],
                                           seg.tb_crc if seg.nof_codeblocks == 1 else "24B")
                          .any())
        bits = tsch._decode_i8_stage(buf, tcfg, 6, True)
        assert torch.equal(bits, two if two_ok else six), name
        # The clean codeword stops after 2 iterations, the noisy one runs 6.
        assert two_ok == (name == "clean"), name
