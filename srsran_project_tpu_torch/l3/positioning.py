"""Positioning: NRPPa-style measurement procedures over DL-PRS TOA.

Counterpart of the reference's lib/nrppa + du_positioning_handler
(SURVEY.md Appendix B "positioning"): an LMF test double requests
positioning measurements; the DU schedules DL-PRS, the UE-side estimator
(``phy.ptrs_prs.prs_toa_estimate``, on the received grid's device)
measures time of arrival per TRP, and the procedure returns RSTD
(reference signal time difference) reports — the multilateration input.
Message framing reuses l3.messages.

A copy of ``srsran_project_tpu/l3/positioning.py``: the two messages sit
in the port's registry under the reference's tags (``PROTO_NRPPA`` 5,
types 0 and 1), so their bytes are the reference's.  The TOAs are the
port's estimator's, whose Point-A advance of the pilots is repaired
(ROADMAP Q3): they agree with the reference's within half a sample, not
to the bit.
"""

from __future__ import annotations

from . import messages as m

PROTO_NRPPA = 5


@m.msg(PROTO_NRPPA, 0)
class PositioningMeasurementRequest:
    lmf_meas_id: int
    trp_ids: list  # TRPs (cells) to measure
    report_type: str = "rstd"


@m.msg(PROTO_NRPPA, 1)
class PositioningMeasurementResponse:
    lmf_meas_id: int
    # [{trp_id, toa_samples, rsrp, quality}] with RSTD relative to trp_ids[0]
    measurements: list


class PositioningProcedure:
    """DU-side handler: runs the PRS TOA estimator per requested TRP."""

    def __init__(self, measure_trp):
        """measure_trp(trp_id) -> dict(toa_samples, rsrp, peak_power), as
        ``prs_toa_estimate`` returns it (numbers or 0-dim tensors)."""
        self.measure_trp = measure_trp

    def rx(self, data: bytes) -> bytes:
        req = m.decode(data)
        if not isinstance(req, PositioningMeasurementRequest):
            raise TypeError(f"PositioningProcedure.rx: got {type(req).__name__}")
        meas = []
        ref_toa = None
        for trp in req.trp_ids:
            r = self.measure_trp(trp)
            toa = float(r["toa_samples"])
            if ref_toa is None:
                ref_toa = toa
            meas.append({"trp_id": trp, "toa_samples": toa,
                         "rstd_samples": toa - ref_toa,
                         "rsrp": float(r["rsrp"]),
                         "quality": float(r["peak_power"])})
        return m.encode(PositioningMeasurementResponse(
            lmf_meas_id=req.lmf_meas_id, measurements=meas))
