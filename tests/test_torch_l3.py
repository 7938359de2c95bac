"""The port's L3 control plane against the JAX package's: the typed-JSON
messages, the AMF / CU-CP / CU-UP-E1 / DU-F1 simulators, mobility and the
E2 agent with its RIC double.

The L3 is host code copied from the reference, so the tolerance is zero:
every message class encodes to the reference's bytes, and the attach,
release, handover, reestablishment and A3 choreographies, run in both
packages, put the same byte strings on every link (NG, F1 per DU, E1 and
the RRC containers at the UE), in the same order.  The E2 records
(setup, subscription, KPM indications, RC and CCC outcomes, rejections
among them) are equal too.  The reference's own tests (``test_l3_attach``,
``test_mobility``, ``test_e2``) also run on the port's modules, and the
port's mobility is a base of ``CuCpSim`` rather than methods attached at
import (checked in a fresh interpreter).
"""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import test_e2 as ref_e2
import test_l3_attach as ref_attach
import test_mobility as ref_mob
from torch_parity import plain_state, reference_cases, run_on_port

from srsran_project_tpu.l2 import security as j_sec
from srsran_project_tpu.l2sim import scheduler as j_sched
from srsran_project_tpu.l2sim import slicing as j_slicing
from srsran_project_tpu.l3 import cu_cp_sim as j_cucp
from srsran_project_tpu.l3 import e2_sim as j_e2
from srsran_project_tpu.l3 import messages as j_m
from srsran_project_tpu.l3 import positioning as j_pos  # noqa: F401  (registers NRPPa)
from srsran_project_tpu_torch.apps import ue_sim as t_ue
from srsran_project_tpu_torch.l2 import pdcp as t_pdcp
from srsran_project_tpu_torch.l2 import security as t_sec
from srsran_project_tpu_torch.l2sim import scheduler as t_sched
from srsran_project_tpu_torch.l2sim import slicing as t_slicing
from srsran_project_tpu_torch.l3 import cu_cp_sim as t_cucp
from srsran_project_tpu_torch.l3 import e2_sim as t_e2
from srsran_project_tpu_torch.l3 import messages as t_m
from srsran_project_tpu_torch.l3 import positioning as t_pos

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PORT = dict(security=t_sec, pdcp=t_pdcp, m=t_m, e2_sim=t_e2, AmfSim=t_cucp.AmfSim,
            CuCpSim=t_cucp.CuCpSim, CuUpE1Agent=t_cucp.CuUpE1Agent, DuF1Sim=t_cucp.DuF1Sim,
            make_srb_pdcp=t_cucp.make_srb_pdcp, UeRrcAgent=t_ue.UeRrcAgent,
            RoundRobinScheduler=t_sched.RoundRobinScheduler,
            SchedulerConfig=t_sched.SchedulerConfig)


# ---- the reference's own tests on the port's modules ---------------------------

@pytest.mark.parametrize("module,name,kwargs", reference_cases(ref_attach)
                         + reference_cases(ref_mob) + reference_cases(ref_e2))
def test_reference_tests_on_port(monkeypatch, module, name, kwargs):
    """The reference's attach, mobility and E2 tests pass on the port's
    modules (the mobility tests' UE agent subclasses the attach test's,
    whose globals are swapped too; the CCC tests import the slicing
    module inside the function)."""
    run_on_port(monkeypatch, module, name, kwargs, PORT, also=(ref_attach,),
                modules={"srsran_project_tpu.l2sim.slicing": t_slicing})


# ---- messages --------------------------------------------------------------------

def _sample(ftype: str, rng):
    if "dict" in ftype:
        return {"pci": int(rng.integers(0, 1008)), "name": "x" + str(int(rng.integers(0, 9))),
                "nested": {"a": [1, 2]}}
    if ftype == "list":
        return [int(rng.integers(0, 100)), {"drb_id": int(rng.integers(1, 8)), "qfi": 9}]
    if ftype == "bool":
        return bool(rng.integers(0, 2))
    if ftype == "str":
        return "".join(chr(int(c)) for c in rng.integers(97, 123, 6))
    assert ftype == "int", ftype
    return int(rng.integers(0, 2**32))


# RRC, F1AP, NGAP, E1AP, E2AP and NRPPa (``l3/positioning``, imported here
# in both packages, so that each registry holds it whatever ran before).
PROTOS = (t_m.PROTO_RRC, t_m.PROTO_F1AP, t_m.PROTO_NGAP, t_m.PROTO_E1AP, t_e2.PROTO_E2AP,
          t_pos.PROTO_NRPPA)


def test_registries_match_reference():
    """Both registries hold the same (protocol, type) tags of the ported
    protocols, each on a class of the same name and fields."""
    def table(m):
        return {k: (c.__name__, [(f.name, f.type) for f in dataclasses.fields(c)])
                for k, c in m._REGISTRY.items() if k[0] in PROTOS}
    assert table(t_m) == table(j_m)
    assert set(t_m._REGISTRY) == set(table(t_m)) and len(t_m._REGISTRY) >= 47


def test_every_message_encodes_to_the_reference_bytes():
    """Every message class, with its defaults and with every field drawn
    from a numpy seed: ``encode`` gives the reference's bytes, and the
    port decodes the reference's bytes back to the same message."""
    rng = np.random.default_rng(21)
    for key, jcls in j_m._REGISTRY.items():
        if key[0] not in PROTOS:
            continue
        tcls = t_m._REGISTRY[key]
        fields = dataclasses.fields(jcls)
        required = {f.name: _sample(f.type, rng) for f in fields
                    if f.default is dataclasses.MISSING and f.default_factory is dataclasses.MISSING}
        full = {f.name: _sample(f.type, rng) for f in fields}
        for kw in (required, full):
            jb, tb = j_m.encode(jcls(**kw)), t_m.encode(tcls(**kw))
            assert tb == jb, jcls.__name__
            back = t_m.decode(jb)
            assert type(back) is tcls and back == tcls(**kw)
            assert j_m.decode(tb) == jcls(**kw)


def test_pcap_registries_are_separate(tmp_path):
    """The port's capture hooks are its own: a writer attached to the port's
    NGAP sees the port's frames and none of the reference's."""
    from srsran_project_tpu_torch.support import pcap

    w = pcap.ngap_pcap(str(tmp_path / "ngap.pcap"))
    t_m.attach_pcap(t_m.PROTO_NGAP, w)
    try:
        j_m.encode(j_m.NgSetupRequest(gnb_id=1, plmn="00101", tac=7))
        frame = t_m.encode(t_m.NgSetupRequest(gnb_id=2, plmn="00101", tac=7))
    finally:
        t_m.detach_pcap(t_m.PROTO_NGAP)
        w.close()
    assert j_m._PCAPS == {} and t_m._PCAPS == {}
    assert [p for _, p in pcap.read_pcap(w.path)[1]] == [frame]


# ---- the choreographies ------------------------------------------------------------

def _network(cucp_mod, ue_mod, rec):
    """Two DUs, an AMF and an E1 agent, every link recording its frames in
    ``rec`` as (link, bytes); UE RRC containers are recorded at the DUs."""
    amf = cucp_mod.AmfSim()
    links = {}

    def tap(name, fn):
        def send(b):
            rec.append((name, bytes(b)))
            fn(b)
        return send

    cucp = cucp_mod.CuCpSim(send_to_amf=tap("ng_ul", lambda b: amf.rx(b)),
                            send_to_du=tap("f1_dl0", lambda b: links["du0"].rx(b)),
                            send_to_cuup=tap("e1_dl", lambda b: links["e1"].rx(b)))
    amf.send = tap("ng_dl", cucp.rx_from_amf)
    du0 = cucp_mod.DuF1Sim(send_to_cucp=tap("f1_ul0", lambda b: cucp.rx_from_du(b, du_id=0)),
                           gnb_du_id=1)
    du1 = cucp_mod.DuF1Sim(send_to_cucp=tap("f1_ul1", lambda b: cucp.rx_from_du(b, du_id=1)),
                           gnb_du_id=2)
    cucp.add_du(1, tap("f1_dl1", lambda b: du1.rx(b)))
    cu_ups = []

    def make_cu_up(ue_id, keys, nea, nia):
        c = ref_attach.FakeCuUp(ue_id, keys, nea, nia)
        cu_ups.append(c)
        return c

    e1 = cucp_mod.CuUpE1Agent(send_to_cucp=tap("e1_ul", cucp.rx_from_cuup), make_cu_up=make_cu_up)
    links["du0"], links["e1"] = du0, e1
    return amf, cucp, du0, du1, cu_ups


def _ho_agent(ue_mod, m, make_srb_pdcp):
    """The package's UE RRC agent, also executing reconfigurationWithSync
    (it moves to ``ho_switch``'s DU before it answers) and reestablishment
    (SRB1 PDCP restarted with the same keys), as ``test_mobility.HoUeAgent``
    does for the reference."""

    class HoAgent(ue_mod.UeRrcAgent):
        ho_switch = None

        def deliver_dl(self, srb_id, container):
            if self.srb1_pdcp is not None and srb_id == 1:
                out = []
                self.srb1_pdcp.on_rx_sdu = out.append
                self.srb1_pdcp.rx_pdu(container)
                if not out:
                    return
                container = out[0]
            rrc = m.decode(container)
            if isinstance(rrc, m.RrcSetup):
                self.state = "setup"
                self._send(m.RrcSetupComplete(selected_plmn="00101", nas_pdu="deadbeef"))
            elif isinstance(rrc, m.RrcSecurityModeCommand):
                self.algos = (rrc.ciphering_algo, rrc.integrity_algo)
                self.srb1_pdcp = make_srb_pdcp(self.k_gnb_provider(), *self.algos,
                                               is_cu_side=False)
                self.state = "secure"
                self._send(m.RrcSecurityModeComplete())
            elif isinstance(rrc, m.RrcReconfiguration):
                if rrc.meas_config and self.ho_switch is not None:
                    self.du, self.du_ue_id = self.ho_switch  # "RACH on the target"
                    self.ho_switch = None
                self.drb_configs = rrc.drb_configs
                self.state = "connected"
                self._send(m.RrcReconfigurationComplete())
            elif isinstance(rrc, m.RrcReestablishment):
                self.srb1_pdcp = make_srb_pdcp(self.k_gnb_provider(), *self.algos,
                                               is_cu_side=False)
                self.state = "connected"
                self._send(m.RrcReestablishmentComplete())
            elif isinstance(rrc, m.RrcRelease):
                self.released = True
                self.state = "idle"

    return HoAgent


def _choreography(cucp_mod, ue_mod, m, sec):
    """Attach two UEs, hand UE 1 over to DU 2, re-establish UE 2 on DU 2
    after a radio link failure, A3-trigger UE 1 back to DU 1, release both;
    the recorded frames, the RRC containers at each UE and the final state."""
    rec = []
    amf, cucp, du0, du1, cu_ups = _network(cucp_mod, ue_mod, rec)
    agent = _ho_agent(ue_mod, m, cucp_mod.make_srb_pdcp)
    cucp.start()
    du0.setup(cells=[{"pci": 1, "nr_cgi": "00101-1", "dl_arfcn": 632628, "bandwidth_rb": 48}])
    du1.setup(cells=[{"pci": 2, "nr_cgi": "00101-2", "dl_arfcn": 632628, "bandwidth_rb": 48}])
    ues = []
    for i in range(2):
        ue = agent(du0, c_rnti=0x4601 + i,
                   k_gnb_provider=lambda u=i + 1: sec.kdf(amf.k_amf, 0x6E, u.to_bytes(4, "big")))
        deliver = ue.deliver_dl
        ue.deliver_dl = lambda srb, c, d=deliver, n=i: (rec.append((f"rrc_dl{n}", bytes(c))),
                                                        d(srb, c))
        ue.connect()
        assert ue.state == "connected" and cucp.ues[i + 1].state == "connected"
        ues.append(ue)
    assert amf.sessions_done == [1, 2]
    # UE 1: inter-DU handover to DU 2
    t_id = du1.allocate_ue(ues[0].deliver_dl)
    ues[0].ho_switch = (du1, t_id)
    cucp.start_handover(cu_ue_id=1, target_du_id=1, target_du_ue_id=t_id, target_pci=2)
    # UE 2: radio link failure, reestablishment on DU 2
    new_id = du1.allocate_ue(ues[1].deliver_dl)
    ues[1].du, ues[1].du_ue_id, ues[1].srb1_pdcp = du1, new_id, None
    du1.initial_ul_rrc(new_id, 0x4602,
                       m.encode(m.RrcReestablishmentRequest(rnti=0x4602, cause="rlf")))
    assert not cucp.handle_reestablishment(1, 99, m.RrcReestablishmentRequest(rnti=0xDEAD))
    # UE 1: a measurement report below and then above the A3 offset

    def alloc():
        t = du0.allocate_ue(ues[0].deliver_dl)
        ues[0].ho_switch = (du0, t)
        return t

    cucp.add_neighbor(pci=1, du_id=0, allocate_target_ue=alloc)
    for serving, neigh in ((-80.0, -82.0), (-85.0, -78.0)):
        ues[0]._send(m.RrcMeasurementReport(results=[{"pci": 2, "rsrp_dbm": serving},
                                                     {"pci": 1, "rsrp_dbm": neigh}]))
    state = plain_state({k: (c.du_id, c.du_ue_id, c.state) for k, c in cucp.ues.items()})
    assert state == {1: [0, 3, "connected"], 2: [1, 2, "connected"]}, state
    for cu_ue_id in sorted(cucp.ues):
        cucp.release_ue(cu_ue_id)
    assert all(u.released for u in ues)
    return rec, state, [plain_state((c.ue_id, c.keys, c.nea, c.nia, c.dl_teids)) for c in cu_ups], \
        amf.sessions_done


def test_choreographies_put_the_same_bytes_on_every_link():
    """Attach (NG/F1/E1 setup, RRC setup, security mode with the derived
    keys, PDU session, bearer contexts), handover, reestablishment, an A3
    decision each way and release: both packages record the same frames
    on every link, in the same order, and end in the same state."""
    ref = _choreography(j_cucp, ref_attach, j_m, j_sec)
    port = _choreography(t_cucp, t_ue, t_m, t_sec)
    links = sorted({name for name, _ in ref[0]})
    assert links == ["e1_dl", "e1_ul", "f1_dl0", "f1_dl1", "f1_ul0", "f1_ul1", "ng_dl", "ng_ul",
                     "rrc_dl0", "rrc_dl1"]
    assert len(port[0]) == len(ref[0]) > 60
    for k, (a, b) in enumerate(zip(ref[0], port[0])):
        assert a == b, (k, a[0], b[0])
    assert port[1:] == ref[1:]


def test_mobility_is_a_base_of_cu_cp():
    """In a fresh interpreter, importing only ``l3.cu_cp`` gives a
    ``CuCpSim`` with every mobility procedure (the reference attaches them
    when ``l3.mobility`` is imported)."""
    code = ("from srsran_project_tpu_torch.l3.cu_cp import CuCpSim\n"
            "from srsran_project_tpu_torch.l3.mobility import MobilityMixin\n"
            "import sys\n"
            "names = ['start_handover', '_continue_handover', '_finish_handover',\n"
            "         'handle_reestablishment', 'add_neighbor', '_handle_measurement_report']\n"
            "assert issubclass(CuCpSim, MobilityMixin)\n"
            "assert all(n in vars(MobilityMixin) and callable(getattr(CuCpSim, n)) for n in names)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env=dict(os.environ, PYTHONPATH=REPO), timeout=120)
    assert proc.returncode == 0, proc.stderr


# ---- E2 ------------------------------------------------------------------------------

def _e2_run(e2, sched_mod, slicing):
    rec = []
    ric = e2.RicSim()
    agent = e2.E2Agent(gnb_id=411, send_to_ric=lambda b: (rec.append(("up", bytes(b))), ric.rx(b)))
    ric.agent_tx = lambda b: (rec.append(("down", bytes(b))), agent.rx(b))
    sched = sched_mod.RoundRobinScheduler(sched_mod.SchedulerConfig(nof_rb=24, max_ues_per_slot=2))
    sched.add_ue(0x10, mcs=8)
    sched.add_ue(0x11, mcs=12)
    agent.kpm.register("DRB.UEThpUl", lambda: float(sum(u.ul_bits_ok for u in sched.ues.values())))
    agent.kpm.register("RRU.PrbTotDl", lambda: 24.0)
    slices = slicing.SliceScheduler(sched_mod.SchedulerConfig(nof_rb=52, max_ues_per_slot=2), [
        slicing.SliceConfig(slice_id=1, min_ratio=0.2, max_ratio=1.0, sst=1, sd=0),
        slicing.SliceConfig(slice_id=2, min_ratio=0.1, max_ratio=0.5, sst=2, sd=7)])
    agent.register_ccc(e2.CccConfigExecutor(
        apply_policy=lambda nr_cgi, pol: slices.apply_rrm_policy(pol)))
    agent.register_rc_action("set_max_mcs", lambda p: f"mcs={p['mcs']}")
    agent.start()
    ric.subscribe(req_id=1, period=3, measurements=["DRB.UEThpUl", "RRU.PrbTotDl", "Bogus"])
    ric.subscribe(req_id=2, period=5, measurements=["RRU.PrbTotDl"])
    for slot in range(16):
        for u in sched.ues.values():
            u.ul_bits_ok += 100 * slot
        agent.tick(slot)
    ric.control(req_id=3, action="set_max_mcs", params={"rnti": 0x10, "mcs": 15})
    ric.control(req_id=4, action="unknown", params={})
    ric.ccc_control(req_id=9, cells=[{"nr_cgi": 0x19B0, "cfg_structures": [
        {"name": "O-RRMPolicyRatio", "old": {"min_ratio": 10, "max_ratio": 50},
         "new": {"resource_type": "prb", "members": [{"plmn": "00101", "sst": 2, "sd": 7}],
                 "min_ratio": 30, "max_ratio": 80, "dedicated_ratio": 10}},
        {"name": "O-RRMPolicyRatio",
         "new": {"members": [{"sst": 1, "sd": 0}], "min_ratio": 90, "max_ratio": 20}},
        {"name": "O-RRMPolicyRatio",
         "new": {"members": [{"sst": 9, "sd": 9}], "min_ratio": 10, "max_ratio": 20}},
        {"name": "Bogus", "new": {}}]}])
    ric.ccc_control(req_id=11, cells=[], style=1)
    return rec, plain_state((ric.setup_seen, ric.sub_responses, ric.indications,
                             ric.control_acks)), \
        [(s.min_ratio, s.max_ratio) for s in slices.slices.values()]


def test_e2_records_match_reference():
    """Setup, two subscriptions (one metric not admitted), KPM indications
    over 16 slots, RC control (accepted and unknown) and CCC (an accepted
    policy, out-of-range, rejected-by-DU and unknown structures, an
    unsupported style): the same frames both ways and the same records."""
    ref = _e2_run(j_e2, j_sched, j_slicing)
    port = _e2_run(t_e2, t_sched, t_slicing)
    assert len(ref[0]) > 12
    assert port == ref
