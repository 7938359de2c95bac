"""E2 agent + E2SM-KPM service model simulator — O-RAN E2AP/E2SM-KPM.

Counterpart of the reference's lib/e2 (e2ap procedures: E2 Setup, RIC
Subscription, RIC Indication, RIC Control; e2sm_kpm_du_meas_provider_impl
exposing DU metrics to the RIC; SURVEY.md section 2.4 "E2 agent"):

- E2Agent registers RAN functions (KPM, RC), performs E2 Setup, accepts
  subscriptions with report periods, and emits periodic RIC Indications
  carrying measurement records pulled from metric providers.
- KpmMeasProvider adapts the framework's metric sources (scheduler
  reports, support.metrics collectors, callables) to KPM measurement
  names (the reference's e2sm_kpm_metric_defs list: DRB.UEThpDl,
  RRU.PrbTotDl, ...).
- RcControlHandler applies RIC control actions (the E2SM-RC role) through
  registered callbacks.

Transport framing reuses l3.messages' typed-JSON wire (the SCTP role);
time is virtual (slot ticks) as elsewhere in the simulators.

A copy of ``srsran_project_tpu/l3/e2_sim.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

from . import messages as m

PROTO_E2AP = 4


@m.msg(PROTO_E2AP, 0)
class E2SetupRequest:
    gnb_id: int
    ran_functions: list  # [{id, oid, description}]

@m.msg(PROTO_E2AP, 1)
class E2SetupResponse:
    accepted_functions: list

@m.msg(PROTO_E2AP, 2)
class RicSubscriptionRequest:
    ric_request_id: int
    ran_function_id: int
    report_period_slots: int
    measurements: list  # KPM measurement names

@m.msg(PROTO_E2AP, 3)
class RicSubscriptionResponse:
    ric_request_id: int
    admitted: list
    not_admitted: list

@m.msg(PROTO_E2AP, 4)
class RicIndication:
    ric_request_id: int
    sequence: int
    slot: int
    records: dict  # name -> value

@m.msg(PROTO_E2AP, 5)
class RicControlRequest:
    ric_request_id: int
    ran_function_id: int
    action: str
    params: dict

@m.msg(PROTO_E2AP, 6)
class RicControlAck:
    ric_request_id: int
    success: bool
    detail: str = ""
    outcome: dict = None  # E2SM-CCC control outcome (per-cell accepted/failed)

RAN_FUNC_KPM = 2
RAN_FUNC_RC = 3
RAN_FUNC_CCC = 4

# The KPM measurement names the DU provider serves (subset of the
# reference's e2sm_kpm_metric_defs.h list).
KPM_METRICS = (
    "DRB.UEThpDl", "DRB.UEThpUl", "RRU.PrbTotDl", "RRU.PrbTotUl",
    "DRB.RlcSduTransmittedVolumeDL", "DRB.RlcSduTransmittedVolumeUL",
    "CARR.PDSCHMCSDist", "CARR.PUSCHMCSDist", "RACH.PreambleDedCell",
    "PHY.PuschCrcOkRatio", "PHY.SlotLatencyMeanUs",
)


class CccConfigExecutor:
    """E2SM-CCC (Cell Configuration and Control) executor — counterpart of
    the reference's e2sm_ccc_control_action_du_executor
    (lib/e2/e2sm/e2sm_ccc/e2sm_ccc_control_action_du_executor.cpp): control
    style 2 carries a list of cells, each with O-RRMPolicyRatio config
    structures (resource type, S-NSSAI member list, min/max/dedicated
    ratios) that are validated and applied to the DU's slice scheduler.

    ``apply_policy(nr_cgi, policy) -> bool`` performs the actual RRM
    change; the executor builds the per-cell accepted/failed outcome
    (ctrl_outcome_format 2 semantics: accepted structures echo old +
    current values, failed ones echo old + requested)."""

    SUPPORTED_ATTRIBUTES = ("resourceType", "rRMPolicyMemberList",
                            "rRMPolicyMaxRatio", "rRMPolicyMinRatio",
                            "rRMPolicyDedicatedRatio")

    def __init__(self, apply_policy: Callable[[int, dict], bool]):
        self.apply_policy = apply_policy

    @staticmethod
    def _validate(policy: dict) -> str | None:
        if policy.get("name") != "O-RRMPolicyRatio":
            return f"unsupported config structure {policy.get('name')!r}"
        new = policy.get("new", {})
        rmin = new.get("min_ratio", 0)
        rmax = new.get("max_ratio", 100)
        ded = new.get("dedicated_ratio", 0)
        if not (0 <= rmin <= rmax <= 100 and 0 <= ded <= 100):
            return "ratio out of range"
        if new.get("resource_type", "prb") not in ("prb", "prb_dl", "prb_ul"):
            return "unknown resource type"
        return None

    def handle(self, params: dict) -> dict:
        """params: {"style": 2, "cells": [{"nr_cgi": int,
        "cfg_structures": [{"name": "O-RRMPolicyRatio", "old": {...},
        "new": {resource_type, members: [{plmn, sst, sd}], min_ratio,
        max_ratio, dedicated_ratio}}]}]} -> control outcome dict."""
        if params.get("style") != 2:
            return {"error": f"unsupported control style {params.get('style')}"}
        cells_outcome = []
        for cell in params.get("cells", []):
            accepted, failed = [], []
            for st in cell.get("cfg_structures", []):
                err = self._validate(st)
                ok = err is None and self.apply_policy(cell.get("nr_cgi"), st["new"])
                if ok:
                    accepted.append({"name": st["name"], "old": st.get("old"),
                                     "current": st["new"]})
                else:
                    failed.append({"name": st.get("name"), "old": st.get("old"),
                                   "requested": st.get("new"),
                                   "cause": err or "rejected by DU"})
            cells_outcome.append({"nr_cgi": cell.get("nr_cgi"),
                                  "accepted": accepted, "failed": failed})
        return {"cells": cells_outcome}


class KpmMeasProvider:
    """Maps KPM measurement names to framework metric callables."""

    def __init__(self):
        self._sources: dict[str, Callable[[], float]] = {}

    def register(self, name: str, fn: Callable[[], float]) -> None:
        self._sources[name] = fn

    def supported(self) -> list[str]:
        return sorted(self._sources)

    def collect(self, names: list[str]) -> dict:
        return {n: float(self._sources[n]()) for n in names if n in self._sources}


@dataclasses.dataclass
class _Subscription:
    ric_request_id: int
    period: int
    measurements: list
    next_due: int
    sequence: int = 0


class E2Agent:
    """The DU/CU-side E2 agent (e2_impl + e2sm registry role)."""

    def __init__(self, gnb_id: int, send_to_ric: Callable[[bytes], None]):
        self.gnb_id = gnb_id
        self.to_ric = send_to_ric
        self.kpm = KpmMeasProvider()
        self.rc_handlers: dict[str, Callable[[dict], str]] = {}
        self.ccc: CccConfigExecutor | None = None
        self.subs: dict[int, _Subscription] = {}
        self.ready = False

    def start(self) -> None:
        funcs = [
            {"id": RAN_FUNC_KPM, "oid": "1.3.6.1.4.1.53148.1.2.2.2", "description": "KPM"},
            {"id": RAN_FUNC_RC, "oid": "1.3.6.1.4.1.53148.1.1.2.3", "description": "RC"},
        ]
        if self.ccc is not None:
            funcs.append({"id": RAN_FUNC_CCC, "oid": "1.3.6.1.4.1.53148.1.6.2.4",
                          "description": "CCC"})
        self.to_ric(m.encode(E2SetupRequest(gnb_id=self.gnb_id, ran_functions=funcs)))

    def register_rc_action(self, action: str, handler: Callable[[dict], str]) -> None:
        self.rc_handlers[action] = handler

    def register_ccc(self, executor: CccConfigExecutor) -> None:
        """Attach the CCC service model (adds its RAN function to setup)."""
        self.ccc = executor

    def rx(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, E2SetupResponse):
            self.ready = True
        elif isinstance(msg, RicSubscriptionRequest):
            admitted = [n for n in msg.measurements if n in self.kpm.supported()]
            not_admitted = [n for n in msg.measurements if n not in admitted]
            if admitted:
                self.subs[msg.ric_request_id] = _Subscription(
                    ric_request_id=msg.ric_request_id, period=msg.report_period_slots,
                    measurements=admitted, next_due=msg.report_period_slots)
            self.to_ric(m.encode(RicSubscriptionResponse(
                ric_request_id=msg.ric_request_id, admitted=admitted,
                not_admitted=not_admitted)))
        elif isinstance(msg, RicControlRequest):
            if msg.ran_function_id == RAN_FUNC_CCC:
                if self.ccc is None:
                    self.to_ric(m.encode(RicControlAck(
                        ric_request_id=msg.ric_request_id, success=False,
                        detail="CCC not registered")))
                    return
                outcome = self.ccc.handle(msg.params)
                ok = ("error" not in outcome and
                      all(not c["failed"] for c in outcome.get("cells", [])))
                self.to_ric(m.encode(RicControlAck(
                    ric_request_id=msg.ric_request_id, success=ok,
                    detail=outcome.get("error", ""), outcome=outcome)))
                return
            h = self.rc_handlers.get(msg.action)
            if h is None:
                self.to_ric(m.encode(RicControlAck(ric_request_id=msg.ric_request_id,
                                                   success=False, detail="unknown action")))
            else:
                detail = h(msg.params)
                self.to_ric(m.encode(RicControlAck(ric_request_id=msg.ric_request_id,
                                                   success=True, detail=detail)))

    def tick(self, slot: int) -> None:
        """Advance virtual time; emit due periodic indications."""
        for sub in self.subs.values():
            while slot >= sub.next_due:
                sub.next_due += sub.period
                sub.sequence += 1
                self.to_ric(m.encode(RicIndication(
                    ric_request_id=sub.ric_request_id, sequence=sub.sequence,
                    slot=slot, records=self.kpm.collect(sub.measurements))))


class RicSim:
    """Test-double near-RT RIC: subscribes and records indications."""

    def __init__(self):
        self.agent_tx: Callable[[bytes], None] | None = None
        self.setup_seen = None
        self.sub_responses = []
        self.indications = []
        self.control_acks = []

    def rx(self, data: bytes) -> None:
        msg = m.decode(data)
        if isinstance(msg, E2SetupRequest):
            self.setup_seen = msg
            self.agent_tx(m.encode(E2SetupResponse(
                accepted_functions=[f["id"] for f in msg.ran_functions])))
        elif isinstance(msg, RicSubscriptionResponse):
            self.sub_responses.append(msg)
        elif isinstance(msg, RicIndication):
            self.indications.append(msg)
        elif isinstance(msg, RicControlAck):
            self.control_acks.append(msg)

    def subscribe(self, req_id: int, period: int, measurements: list) -> None:
        self.agent_tx(m.encode(RicSubscriptionRequest(
            ric_request_id=req_id, ran_function_id=RAN_FUNC_KPM,
            report_period_slots=period, measurements=measurements)))

    def control(self, req_id: int, action: str, params: dict) -> None:
        self.agent_tx(m.encode(RicControlRequest(
            ric_request_id=req_id, ran_function_id=RAN_FUNC_RC,
            action=action, params=params)))

    def ccc_control(self, req_id: int, cells: list, style: int = 2) -> None:
        """Send an E2SM-CCC style-2 (Cell Configuration and Control)
        request carrying O-RRMPolicyRatio structures per cell."""
        self.agent_tx(m.encode(RicControlRequest(
            ric_request_id=req_id, ran_function_id=RAN_FUNC_CCC,
            action="ccc", params={"style": style, "cells": cells})))
