"""The port's NRPPa-style positioning (``l3.positioning``) against the
reference's: the two messages' bytes, the TOAs of the port's PRS estimator
within the reference test's 0.5-sample bound of the reference's (the
port's estimator repairs the pilots' Point-A advance, ROADMAP Q3, so its
TOA is not the reference's to the bit), and the RSTD report within 0.7
samples of the true delays."""

import jax.numpy as jnp
import numpy as np
import pytest
from torch_parity import to_torch

from srsran_project_tpu.l3 import messages as jm
from srsran_project_tpu.l3 import positioning as jpos
from srsran_project_tpu.phy import ptrs_prs as jpp
from srsran_project_tpu_torch.l3 import messages as tm
from srsran_project_tpu_torch.l3 import positioning as tpos
from srsran_project_tpu_torch.phy import ptrs_prs as tpp

CFG = dict(rb_start=0, rb_count=24, start_symbol=2, nof_symbols=4, comb_size=4, n_id_prs=42,
           nof_grid_sc=624)
DFT = 2048
DELAYS = {1: 5.0, 2: 9.0, 3: 1.0}  # per-TRP propagation delays (samples)


def _delayed_grid(delay: float, seed: int, snr_db: float = 20.0) -> np.ndarray:
    """The reference's PRS grid under a pure delay and noise (the
    reference test's channel)."""
    g = np.asarray(jpp.generate_prs(jpp.PrsConfig(**CFG)))
    k = np.arange(g.shape[1])
    rng = np.random.default_rng(seed)
    noise = (rng.standard_normal(g.shape) + 1j * rng.standard_normal(g.shape))
    noise *= np.sqrt(10 ** (-snr_db / 10) / 2)
    return (g * np.exp(-2j * np.pi * k * delay / DFT)[None, :] + noise).astype(np.complex64)


def test_messages_share_the_reference_tags_and_bytes():
    req = dict(lmf_meas_id=7, trp_ids=[1, 2, 3])
    assert tm.encode(tpos.PositioningMeasurementRequest(**req)) == jm.encode(
        jpos.PositioningMeasurementRequest(**req))
    assert tpos.PROTO_NRPPA == jpos.PROTO_NRPPA == 5
    frame = jm.encode(jpos.PositioningMeasurementRequest(**req, report_type="toa"))
    assert tm.decode(frame) == tpos.PositioningMeasurementRequest(**req, report_type="toa")
    meas = [{"trp_id": 1, "toa_samples": 5.25, "rstd_samples": 0.0, "rsrp": 0.5,
             "quality": 80.0}]
    assert tm.encode(tpos.PositioningMeasurementResponse(lmf_meas_id=7, measurements=meas)) \
        == jm.encode(jpos.PositioningMeasurementResponse(lmf_meas_id=7, measurements=meas))


def test_response_framing_equals_the_reference_s():
    """The same measurements through both procedures: identical bytes."""
    fixed = {1: (5.25, 0.75, 90.0), 2: (9.5, 0.5, 60.0), 3: (-1.0, 0.25, 30.0)}

    def measure(trp):
        toa, rsrp, peak = fixed[trp]
        return {"toa_samples": toa, "rsrp": rsrp, "peak_power": peak}

    req = jm.encode(jpos.PositioningMeasurementRequest(lmf_meas_id=9, trp_ids=[2, 1, 3]))
    assert tpos.PositioningProcedure(measure).rx(req) == jpos.PositioningProcedure(measure).rx(req)
    with pytest.raises(TypeError):
        tpos.PositioningProcedure(measure).rx(tm.encode(tpos.PositioningMeasurementResponse(
            lmf_meas_id=1, measurements=[])))


@pytest.mark.parametrize("delay", [0.0, 3.0, 17.5, -4.0])
def test_toa_within_half_a_sample_of_the_reference(delay):
    rx = _delayed_grid(delay, seed=int(10 * abs(delay)))
    want = jpp.prs_toa_estimate(jnp.asarray(rx), jpp.PrsConfig(**CFG), dft_size=DFT)
    got = tpp.prs_toa_estimate(to_torch(rx), tpp.PrsConfig(**CFG), dft_size=DFT)
    assert abs(float(got["toa_samples"]) - float(want["toa_samples"])) < 0.5
    assert abs(float(got["toa_samples"]) - delay) < 0.5
    assert float(got["peak_power"]) > 50


def test_positioning_procedure_rstd():
    """Three TRPs through the port's procedure with the port's estimator
    on CPU tensors; the response decodes in the reference's registry."""
    cfg = tpp.PrsConfig(**CFG)

    def measure(trp_id):
        return tpp.prs_toa_estimate(to_torch(_delayed_grid(DELAYS[trp_id], seed=trp_id)), cfg,
                                    dft_size=DFT)

    resp = jm.decode(tpos.PositioningProcedure(measure).rx(
        jm.encode(jpos.PositioningMeasurementRequest(lmf_meas_id=7, trp_ids=[1, 2, 3]))))
    assert isinstance(resp, jpos.PositioningMeasurementResponse) and resp.lmf_meas_id == 7
    rstd = {x["trp_id"]: x["rstd_samples"] for x in resp.measurements}
    assert rstd[1] == 0.0
    assert abs(rstd[2] - 4.0) < 0.7 and abs(rstd[3] - (-4.0)) < 0.7
