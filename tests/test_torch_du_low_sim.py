"""The port's ``du_low_sim`` and its configuration against the JAX
package's.

The app runs on the CPU here (``--cpu``) at a small ``--set`` config; one
of its slots, the same TB and the same received grid through the JAX
package's ``UpperPhy`` give the same DL grid (within 1e-6 x RMS) and the
same indications (CRC and TB bits exact, snr_db atol 1e-3).  Its scheduler
and multi-cell modes at 24 PRB and 1 port on one tap at 30 dB print the
reference app's summaries (grants, CRCs, BLER, common-channel counters,
per-cell metrics) and its stdout lines (periodic reports, metrics JSON)
exactly, wall-clock figures aside."""

import dataclasses
import importlib.util
import json
import os
import re
import sys

import numpy as np
import pytest
import torch
from test_torch_dl_slot import assert_grid_close
from torch_parity import to_np

from srsran_project_tpu.fapi import messages as jfapi
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu.support import config as jconfig
from srsran_project_tpu_torch.apps import du_low_sim
from srsran_project_tpu_torch.models import cell as tcell
from srsran_project_tpu_torch.phy import channel_emulator as tchem
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.phy.upper_phy import UpperPhyConfig as TUpperPhyConfig
from srsran_project_tpu_torch.support import config as tconfig
from srsran_project_tpu_torch.support import pcap as tpcap
from srsran_project_tpu_torch.support import tracing as ttracing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SMALL = ["--cpu", "--set", "cell.nof_rb=24", "--set", "cell.nof_ports=2",
         "--set", "cell.nof_layers=1", "--set", "cell.modulation=qam16",
         "--channel", "single", "--snr-db", "30", "--slots", "3"]
OVERRIDES = {"cell.nof_rb": 24, "cell.nof_ports": 2, "cell.nof_layers": 1,
             "cell.modulation": "qam16"}


def test_app_runs_clean(capsys):
    assert du_low_sim.main(SMALL) == 0
    err = capsys.readouterr().err
    assert "# cell: 24 PRB, 2x1" in err and "device=cpu" in err
    assert "# 3 slots in " in err and "BLER=0.000" in err


def test_app_needs_a_card_without_cpu(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert du_low_sim.main([a for a in SMALL if a != "--cpu"]) == 2
    assert "no CUDA device" in capsys.readouterr().err


def test_config_twin(capsys):
    """load_config / validate / to_cell_config / dump_config give the JAX
    package's values, and the port's defaults need no YAML file."""
    jd = jconfig.load_config(None, OVERRIDES)
    td = tconfig.load_config(None, OVERRIDES)
    assert dataclasses.asdict(td) == dataclasses.asdict(jd)
    assert tconfig.to_cell_config(td) == tcell.CellConfig.from_reference(jconfig.to_cell_config(jd))
    assert tconfig.to_cell_config(tconfig.load_config()) == tcell.CellConfig()
    assert tconfig.dump_config(td) == jconfig.dump_config(jd)
    for bad in ({"cell.nof_rb": 300}, {"cell.modulation": "qam1024"},
                {"cell.nof_layers": 4, "cell.nof_ports": 2}):
        with pytest.raises(ValueError):
            jconfig.load_config(None, bad)
        with pytest.raises(ValueError):
            tconfig.load_config(None, bad)
    with pytest.raises(KeyError):
        tconfig.load_config(None, {"cell.no_such_field": 1})
    assert du_low_sim.main(SMALL + ["--dump-config"]) == 0
    assert "nof_rb: 24" in capsys.readouterr().out


def test_one_slot_against_the_reference():
    """The app's slot 0 (its requests, its TB and its channel draw) through
    the port's UpperPhy, and the same TB and received grid through the JAX
    package's."""
    cell = tconfig.to_cell_config(tconfig.load_config(None, OVERRIDES))
    jcell = jconfig.to_cell_config(jconfig.load_config(None, OVERRIDES))
    tb = np.random.default_rng(0).integers(0, 2, size=(cell.tbs,), dtype=np.uint8)
    dl, tx_data, ul = du_low_sim.slot_requests(cell, 0, tb)
    tphy = TUpperPhy(TUpperPhyConfig(nof_ports=cell.nof_ports, nof_grid_sc=cell.nof_sc,
                                     device="cpu"))
    jphy = JUpperPhy(JUpperPhyConfig(nof_ports=jcell.nof_ports, nof_grid_sc=jcell.nof_sc))
    slot = JSlot.from_sfn_slot(JScs(int(jcell.scs)), 0, 0)
    w = np.eye(jcell.nof_layers, jcell.nof_ports, dtype=np.complex64)
    grid_j = np.asarray(jphy.process_dl_tti(
        jfapi.DlTtiRequest(slot=slot, pdsch=[jfapi.DlPdschPdu(jcell.pdsch_cfg, 0x4601, w, 0)]),
        jfapi.TxDataRequest(slot=slot, payloads=[tb])))
    grid_t = tphy.process_dl_tti(dl, tx_data)
    assert_grid_close(to_np(grid_t), grid_j)
    ch = tchem.ChannelConfig(profile="tdla", sinr_db=22.0, nof_tx_ports=cell.nof_ports,
                             nof_rx_ports=cell.nof_ports, nof_sc=cell.nof_sc, scs=cell.scs)
    rx, _, _ = tchem.apply_channel(grid_t, torch.Generator().manual_seed(1), ch)
    res_t = tphy.process_ul_tti(ul, rx)
    res_j = jphy.process_ul_tti(
        jfapi.UlTtiRequest(slot=slot, pusch=[jfapi.UlPuschPdu(jcell.pusch_cfg, 0x4601)]),
        to_np(rx))
    assert res_t.crc[0].tb_crc_ok and res_j.crc[0].tb_crc_ok
    assert abs(res_t.crc[0].snr_db - res_j.crc[0].snr_db) <= 1e-3
    np.testing.assert_array_equal(res_t.rx_data[0].payload, np.asarray(res_j.rx_data[0].payload))
    np.testing.assert_array_equal(res_t.rx_data[0].payload, tb)


# ---- scheduler and multi-cell modes ------------------------------------------

SCHED = ["--cpu", "--set", "cell.nof_rb=24", "--set", "cell.nof_ports=1", "--set",
         "cell.nof_layers=1", "--channel", "single", "--snr-db", "30"]
MODES = {
    "qos": ["--ues", "2", "--policy", "qos", "--slots", "6"],
    "tdd": ["--ues", "3", "--tdd", "--slots", "12"],
    "common": ["--ues", "3", "--common", "--slots", "20"],
    "tdd_common_metrics": ["--ues", "4", "--tdd", "--common", "--slots", "20",
                           "--metrics-interval-slots", "5", "--metrics-json"],
    "cells": ["--ues", "3", "--cells", "2", "--slots", "8", "--metrics-json"],
    # The RU loop (single-UE mode): the TBs and the loopback AWGN from the
    # one numpy stream, so every slot sees the reference's draws.
    "ru_generic": ["--ru", "generic", "--slots", "3"],
    "ru_ofh": ["--ru", "ofh", "--slots", "3"],
    "ru_generic_low_snr": ["--ru", "generic", "--slots", "8", "--snr-db", "23.8"],
    # Scheduler mode with a MAC-NR pcap of the DL TBs ({pcap}: a file per
    # app) and the remote-control endpoint (no client: the loop runs on).
    "pcap_remote": ["--ues", "3", "--tdd", "--slots", "12", "--pcap", "{pcap}",
                    "--remote-port", "0", "--metrics-interval-slots", "4"],
}


def _reference_app():
    spec = importlib.util.spec_from_file_location("reference_du_low_sim",
                                                  os.path.join(REPO, "apps", "du_low_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _summary(err: str) -> list[str]:
    """The app's '# ' lines without the cell header and the wall-clock
    figures, the remote-control port and the pcap path."""
    out = []
    for line in err.splitlines():
        if not line.startswith("# ") or line.startswith("# cell: "):
            continue
        line = re.sub(r"in [0-9.]+s", "in Ts", line)
        line = re.sub(r"\([0-9.]+ slot-pairs/s\)", "(R slot-pairs/s)", line)
        line = re.sub(r"ws://127\.0\.0\.1:\d+", "ws://127.0.0.1:P", line)
        line = re.sub(r"-> \S+\.pcap", "-> F.pcap", line)
        out.append(re.sub(r"[0-9.]+ Mbps", "R Mbps", line))
    return out


def _record_crcs(monkeypatch, cls, calls: list) -> None:
    """Record the CRC flags of every ``cls.process_ul_tti`` call."""
    orig = cls.process_ul_tti

    def recorded(phy, *a, **kw):
        res = orig(phy, *a, **kw)
        calls.append([bool(c.tb_crc_ok) for c in res.crc])
        return res

    monkeypatch.setattr(cls, "process_ul_tti", recorded)


def run_both(argv, monkeypatch, capsys, tmp_path=None):
    """(rc, summary, stdout lines, CRCs of each UL_TTI call) of the
    reference app and of the port's; '{pcap}' in argv becomes a file of
    each app's own under tmp_path."""
    ref_crcs, port_crcs = [], []
    _record_crcs(monkeypatch, JUpperPhy, ref_crcs)
    _record_crcs(monkeypatch, TUpperPhy, port_crcs)
    ref_argv = [a.format(pcap=tmp_path / "ref.pcap") if tmp_path else a for a in argv]
    port_argv = [a.format(pcap=tmp_path / "port.pcap") if tmp_path else a for a in argv]
    monkeypatch.setattr(sys, "argv", ["du_low_sim.py", *ref_argv])
    ref_rc = _reference_app().main()
    ref = capsys.readouterr()
    port_rc = du_low_sim.main(port_argv)
    port = capsys.readouterr()
    return ((ref_rc, _summary(ref.err), ref.out.splitlines(), ref_crcs),
            (port_rc, _summary(port.err), port.out.splitlines(), port_crcs))


@pytest.mark.parametrize("mode", list(MODES))
def test_mode_against_the_reference_app(mode, monkeypatch, capsys, tmp_path):
    ref, port = run_both(SCHED + MODES[mode], monkeypatch, capsys, tmp_path)
    assert port == ref
    rc, summary, out, crcs = port
    assert rc == 0 and crcs
    if "--common" not in MODES[mode] and mode != "ru_generic_low_snr":
        assert summary[-1].endswith(("BLER=0.000", "CRC OK in Ts"))
    if mode == "ru_generic_low_snr":  # the noise decides: some slots fail, some pass
        assert [c for (c,) in crcs].count(True) not in (0, len(crcs))
    if mode == "pcap_remote":
        # The records equal the reference's but for the timestamps: one DL
        # TB each, in scheduling order, with its RNTI, SFN and slot.
        dlt, pkts = tpcap.read_pcap(str(tmp_path / "port.pcap"))
        assert (dlt, [p for _, p in pkts]) == (lambda d, k: (d, [p for _, p in k]))(
            *tpcap.read_pcap(str(tmp_path / "ref.pcap")))
        assert summary[1] == f"# pcap: {len(pkts)} MAC PDUs -> F.pcap" and len(pkts) >= 12
        assert {tpcap.parse_mac_nr_context(p)[0]["rnti"] for _, p in pkts} == {0x100, 0x101,
                                                                             0x102}
        assert summary[0] == "# remote control: ws://127.0.0.1:P"
        assert [json.loads(x)["slot"] for x in out] == [4, 8, 12]
    if mode == "tdd_common_metrics":
        assert summary[0] == ("# common channels: {'ssb': 1, 'sib1': 1, 'paging': 0, "
                              "'csi_rs': 1, 'prach': 1, 'cbs': 0, 'fallback': 0, 'si': 0}")
        periodic = [json.loads(line) for line in out[:-1]]
        assert [p["slot"] for p in periodic] == [5, 10, 15, 20]
        assert all(p["type"] == "periodic" and len(p) == 2 + 4 for p in periodic)
        # Nothing records into the metrics collector (kept for parity).
        assert out[-1] == "{}"
    if mode == "cells":
        rep = json.loads(out[-1])
        assert sorted(rep["cells"]) == ["0", "1"] and rep["bler"] == 0.0
        assert rep["cells"]["0"]["nof_ul_grants"] > 0 and rep["cells"]["1"]["nof_ul_grants"] > 0


def test_common_broadcast_slots_fail_the_loopback(capsys):
    """With --common the loopback fails grants the common channels
    overwrite: slot 0's SSB (PRBs 0-19, symbols 2-5) fails the grant on
    PRBs 8-15, and slot 1's SIB1
    broadcast PDSCH takes the band while the three UE grants keep their
    PUSCH (as in the reference app: test_mode_against_the_reference_app)."""
    assert du_low_sim.main(SCHED + ["--ues", "3", "--common", "--slots", "3"]) == 0
    summary = _summary(capsys.readouterr().err)
    assert summary[1] == "# scheduler mode: 3 UEs, 9 grants, 5 CRC OK, R Mbps UL"


@pytest.fixture
def fresh_tracer(monkeypatch):
    """The L1 tracer with no spans kept, its state restored afterwards."""
    tr = ttracing.l1_tracer
    monkeypatch.setattr(tr, "_kept", [])
    monkeypatch.setattr(tr, "enabled", tr.enabled)
    return tr


UL_STAGES = {"pusch.estimate", "pusch.equalize", "pusch.demap", "sch.dematch", "ldpc.decode",
             "sch.desegment"}


@pytest.mark.parametrize("mode", ["single", "scheduler"])
def test_trace_is_chrome_json(mode, tmp_path, fresh_tracer, capsys):
    """--trace writes Chrome trace JSON on one clock: in the single-UE loop
    a DL and a UL span a slot, as in the reference, with the slot path's
    stage spans nested in them (the downlink's inside the FAPI entry's span
    ``upper_phy.process_dl_tti``, the uplink's inside
    ``upper_phy.process_ul_tti``, beside ``upper_phy.indications``); the
    scheduler mode's loop has no slot span (in the reference neither), so
    its outermost spans are the two FAPI entries, with the downlink's
    stages, and ``ul_slot.process_slot`` and the uplink's stages, nested in
    them."""
    path = tmp_path / "trace.json"
    argv = (SMALL if mode == "single" else SCHED + ["--ues", "2", "--slots", "3"])
    assert du_low_sim.main(argv + ["--trace", str(path), "--metrics-json"]) == 0
    events = json.loads(path.read_text())["traceEvents"]
    assert capsys.readouterr().out.splitlines()[-1] == "{}"
    assert all(e["ph"] == "X" and e["dur"] >= 0 and e["cat"] == "L1" for e in events)
    by_id = {e["args"]["id"]: e for e in events}
    top = [e for e in events if e["args"]["parent"] == 0]
    for e in events:
        outer = by_id[e["args"]["request"]]
        assert outer["args"]["parent"] == 0
        assert outer["ts"] - 0.5 <= e["ts"]
        assert e["ts"] + e["dur"] <= outer["ts"] + outer["dur"] + 0.5
    inner = {}
    for e in events:
        if e["args"]["parent"]:
            inner.setdefault(by_id[e["args"]["parent"]]["name"], set()).add(e["name"])
    if mode == "scheduler":
        assert {e["name"] for e in top} == {"upper_phy.process_dl_tti",
                                            "upper_phy.process_ul_tti"}
        assert inner == {"upper_phy.process_dl_tti": {"pdsch.bit_chain", "pdsch.grid"},
                         "upper_phy.process_ul_tti": {"ul_slot.process_slot",
                                                      "upper_phy.indications"},
                         "ul_slot.process_slot": UL_STAGES | {"ul_slot.group"}}
        return
    assert [e["name"] for e in top] == [f"{d}_slot_{i}" for i in range(3) for d in ("dl", "ul")]
    assert inner == {**{f"dl_slot_{i}": {"upper_phy.process_dl_tti"} for i in range(3)},
                     "upper_phy.process_dl_tti": {"pdsch.bit_chain", "pdsch.grid"},
                     **{f"ul_slot_{i}": {"upper_phy.process_ul_tti"} for i in range(3)},
                     "upper_phy.process_ul_tti": UL_STAGES | {"upper_phy.indications"}}


def test_scheduler_mode_config_and_ul_synthesis():
    """The scheduler mode's config is the reference app's, and a UL-only
    TDD slot's synthesized grid equals the sum of each grant's own
    pusch.transmit at its PRB offset."""
    from srsran_project_tpu.l2sim import scheduler as jsched
    from srsran_project_tpu.ran import tdd as jtdd
    from srsran_project_tpu_torch.l2sim import scheduler as tsched
    from srsran_project_tpu_torch.phy import pusch as tpusch

    cell = tconfig.to_cell_config(tconfig.load_config(None, {"cell.nof_rb": 24, "cell.nof_ports": 1,
                                                            "cell.nof_layers": 1}))
    args = du_low_sim._parser().parse_args(["--ues", "6", "--tdd", "--policy", "qos"])
    cfg = du_low_sim.scheduler_config(cell, args)
    assert cfg == tsched.SchedulerConfig.from_reference(jsched.SchedulerConfig(
        nof_grid_sc=cell.nof_sc, nof_rb=cell.nof_rb, max_ues_per_slot=4, nof_layers=1,
        nof_ports=1, tdd_pattern=jtdd.PATTERN_7D2U, policy="qos"))
    s = tsched.RoundRobinScheduler(cfg)
    for i in range(6):
        s.add_ue(0x100 + i, mcs=10)
    rng = np.random.default_rng(0)
    for n in range(9):
        _, _, ul, _ = s.run_slot(du_low_sim._slot_point(cell, n), rng)
    assert len(ul.pusch) == 4
    tx = du_low_sim.synthesize_ul(s, ul, cell, torch.device("cpu"))
    want = torch.zeros_like(tx)
    for pdu in ul.pusch:
        sub = tpusch.transmit(torch.as_tensor(s.ues[pdu.rnti].harqs[pdu.harq_id].tb),
                              torch.tensor(pdu.rnti), pdu.config)
        want[:, :, pdu.first_rb * 12:pdu.first_rb * 12 + sub.shape[2]] = sub
    assert torch.equal(tx, want)


def test_remote_control_quits_the_run(monkeypatch, capsys):
    """--remote-port in scheduler mode: a client subscribes, receives the
    periodic metrics lines the app prints, asks for a report and sends
    "quit", which ends the run long before its --slots."""
    import queue
    import threading

    from srsran_project_tpu_torch.support import remote_server as trs

    started = queue.Queue()
    orig_start = trs.RemoteServer.start

    def start(self):
        orig_start(self)
        started.put(self)

    monkeypatch.setattr(trs.RemoteServer, "start", start)
    got = {}

    def until(cli, want):
        for _ in range(100):
            msg = cli.recv_json()
            if want(msg):
                return msg
            got.setdefault("reports", []).append(msg)
        raise AssertionError("no such message")

    def client():
        srv = started.get(timeout=60)
        cli = trs.WsClient("127.0.0.1", srv.port, timeout=10.0)
        try:
            cli.send_json({"cmd": "metrics_subscribe"})
            until(cli, lambda m: m.get("cmd") == "metrics_subscribe")
            got["first"] = until(cli, lambda m: m.get("type") == "periodic")
            cli.send_json({"cmd": "metrics"})
            got["metrics"] = until(cli, lambda m: m.get("cmd") == "metrics")
            cli.send_json({"cmd": "quit"})
            got["quit"] = until(cli, lambda m: m.get("cmd") == "quit")
        finally:
            cli.close()

    thread = threading.Thread(target=client, daemon=True)
    thread.start()
    rc = du_low_sim.main(SCHED + ["--ues", "2", "--slots", "400", "--metrics-interval-slots",
                                  "2", "--remote-port", "0"])
    thread.join(timeout=30)
    assert not thread.is_alive()
    out = capsys.readouterr()
    printed = [json.loads(x) for x in out.out.splitlines()]
    assert rc == 0 and got["quit"]["cmd"] == "quit"
    assert got["first"] in printed and all(r in printed for r in got.get("reports", []))
    assert sorted(got["metrics"]["report"]) == ["256", "257"]
    assert 1 <= len(printed) < 100  # the run ended long before 400 slots
    assert re.search(r"# remote control: ws://127\.0\.0\.1:\d+", out.err)
