"""The port's monolithic gNB (``apps/gnb_sim``) against the reference's app.

The slice as a whole: the reference's ``apps/gnb_sim.py`` (its ``main``,
in this process) and the port's ``gnb_sim.run`` both run 2 UEs with
handover, E2 and pcaps at 25 dB, given one channel: a numpy-drawn phase
and AWGN added to each package's DL grid, from one seed.  Every
``UpperPhy`` call is recorded in both: the DL_TTI, TX_Data and UL_TTI
requests are equal field by field (the reference's copied with
``from_reference``), the DL grids within 1e-5 x RMS, and the CRC verdicts
and decoded TB bits exactly (the int8 LLRs inside may differ by +-1,
ROADMAP ground rules).  The packets delivered to each UE and to the core,
the printed report, and the frames in every pcap are equal.

The app: the command line's end-to-end run, the test mode's counters
against the reference's, a missing card, and two reference faults
repaired: ``--testmode`` with ``--pcap-dir`` (the reference never closes
its writers there) and a decoded DL TB handed to another UE after a CRC
failure.
"""

import importlib.util
import io
import json
import os
import subprocess
import sys
from contextlib import redirect_stdout

import jax.numpy as jnp
import numpy as np
import pytest
import test_du_cu_split as ref_split
import torch
from test_torch_dl_slot import assert_grid_close
from test_torch_scheduler import assert_same

from srsran_project_tpu.l2 import cu_up_sim as j_cu_up
from srsran_project_tpu.l2 import gtpu as j_gtpu
from srsran_project_tpu.l3 import messages as j_m
from srsran_project_tpu.phy import channel_emulator as j_chem
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu_torch.apps import gnb_sim
from srsran_project_tpu_torch.fapi import messages as t_fapi
from srsran_project_tpu_torch.l2 import gtpu as t_gtpu
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy as TUpperPhy
from srsran_project_tpu_torch.support import pcap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SLICE_ARGS = ["--cpu", "--ues", "2", "--packets", "3", "--slots", "20", "--snr-db", "25",
              "--handover", "--e2", "--metrics-json"]


def _reference_app():
    spec = importlib.util.spec_from_file_location("ref_gnb_sim",
                                                  os.path.join(REPO, "apps", "gnb_sim.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_reference(monkeypatch, argv):
    monkeypatch.setattr(sys, "argv", ["gnb_sim.py", *argv])
    try:
        return _reference_app().main()
    finally:  # the reference leaves its writers attached when it returns early
        for proto in list(j_m._PCAPS):
            j_m.detach_pcap(proto)
        j_gtpu.detach_pcap()


def _shared_channel(seed: int, to_grid):
    """Grid -> grid * a phase per call + AWGN at 25 dB on unit RE power, drawn
    with numpy from ``seed``; ``to_grid`` gives the package's array."""
    rng = np.random.default_rng(seed)

    def channel(grid):
        x = np.asarray(grid.cpu() if isinstance(grid, torch.Tensor) else grid)
        phase = np.exp(1j * rng.uniform(-np.pi, np.pi))
        sigma = np.sqrt(10.0 ** (-25.0 / 10.0) / 2.0)
        noise = sigma * (rng.standard_normal(x.shape) + 1j * rng.standard_normal(x.shape))
        return to_grid((x * phase + noise).astype(np.complex64))
    return channel


def _record(monkeypatch, phy_cls, calls):
    dl, ul = phy_cls.process_dl_tti, phy_cls.process_ul_tti

    def process_dl_tti(self, request, tx):
        grid = dl(self, request, tx)
        calls.append(("dl", request, tx, np.array(grid.cpu() if isinstance(grid, torch.Tensor)
                                                    else grid)))
        return grid

    def process_ul_tti(self, request, rx, *a, **kw):
        res = ul(self, request, rx, *a, **kw)
        calls.append(("ul", request, [(c.rnti, c.harq_id, bool(c.tb_crc_ok)) for c in res.crc],
                      [(d.rnti, d.harq_id, np.asarray(d.payload)) for d in res.rx_data]))
        return res

    monkeypatch.setattr(phy_cls, "process_dl_tti", process_dl_tti)
    monkeypatch.setattr(phy_cls, "process_ul_tti", process_ul_tti)


def _pcap_frames(d):
    return {f: [p for _, p in pcap.read_pcap(os.path.join(d, f))[1]] for f in sorted(os.listdir(d))}


@pytest.fixture(scope="module")
def slice_runs(tmp_path_factory):
    """One run of each package's app on the shared channel, every UpperPhy
    call recorded (module-scoped: the reference's JAX compiles are the cost)."""
    mp = pytest.MonkeyPatch()
    try:
        ref_calls, port_calls, ref_ues, ref_core = [], [], [], []
        _record(mp, JUpperPhy, ref_calls)
        _record(mp, TUpperPhy, port_calls)
        ue_init, cu_init = ref_split.UeSim.__init__, j_cu_up.CuUpSim.__init__

        def ue_new(self, *a, **kw):
            ue_init(self, *a, **kw)
            ref_ues.append(self)

        def cu_new(self, ue_id, ngu_tx, *a, **kw):
            cu_init(self, ue_id, lambda b: (ref_core.append(b), ngu_tx(b)), *a, **kw)

        mp.setattr(ref_split.UeSim, "__init__", ue_new)
        mp.setattr(j_cu_up.CuUpSim, "__init__", cu_new)
        ref_ch = _shared_channel(5, jnp.asarray)
        mp.setattr(j_chem, "apply_channel", lambda grid, key, cfg: (ref_ch(grid), None, None))
        ref_dir, port_dir = tmp_path_factory.mktemp("ref_pcap"), tmp_path_factory.mktemp("port_pcap")
        ref_out, port_out = io.StringIO(), io.StringIO()
        with redirect_stdout(ref_out):
            rc = _run_reference(mp, [*SLICE_ARGS, "--pcap-dir", str(ref_dir)])
        args = gnb_sim._parser().parse_args([*SLICE_ARGS, "--pcap-dir", str(port_dir)])
        with redirect_stdout(port_out):
            port = gnb_sim.run(args, channel=_shared_channel(5, torch.from_numpy))
    finally:
        mp.undo()
    return dict(rc=rc, ref_calls=ref_calls, port_calls=port_calls, ref_ues=ref_ues,
                ref_core=ref_core, port=port, ref_out=ref_out.getvalue(),
                port_out=port_out.getvalue(), ref_dir=str(ref_dir), port_dir=str(port_dir))


def test_slice_phy_calls_match_reference(slice_runs):
    """Every UpperPhy call of the run, in order: the requests field by
    field, the TX_Data TBs bitwise, the DL grids within 1e-5 x RMS, the CRC
    verdicts and decoded TB bits exactly."""
    ref, port = slice_runs["ref_calls"], slice_runs["port_calls"]
    assert len(ref) == len(port) > 8
    for k, (a, b) in enumerate(zip(ref, port)):
        assert a[0] == b[0], k
        if a[0] == "dl":
            assert_same(t_fapi.DlTtiRequest.from_reference(a[1]), b[1], f"call {k} DL_TTI")
            assert_same(t_fapi.TxDataRequest.from_reference(a[2]), b[2], f"call {k} TX_Data")
            assert_grid_close(b[3], a[3], rel=1e-5)
        else:
            assert_same(t_fapi.UlTtiRequest.from_reference(a[1]), b[1], f"call {k} UL_TTI")
            assert a[2] == b[2], k
            assert len(a[3]) == len(b[3]), k
            for (r1, h1, p1), (r2, h2, p2) in zip(a[3], b[3]):
                assert (r1, h1) == (r2, h2) and p1.dtype == p2.dtype and np.array_equal(p1, p2)
    assert all(ok for c in port if c[0] == "ul" for _, _, ok in c[2])


def test_slice_delivers_the_reference_packets(slice_runs):
    """Both apps exit 0 with every packet bytes-exact; the packets at each
    UE and at the core, the report lines and each pcap's frames are equal."""
    port = slice_runs["port"]
    assert slice_runs["rc"] == 0 and port.ok
    assert port.metrics["dl_packets"] == 6 and port.metrics["ul_packets"] == 6
    assert [u.delivered for _, u in port.ues] == [u.delivered for u in slice_runs["ref_ues"]]
    assert port.core_rx == slice_runs["ref_core"]
    assert sorted(t_gtpu.decode(f).payload for f in port.core_rx) == \
        sorted(j_gtpu.decode(f).payload for f in slice_runs["ref_core"])
    assert all(c.du_id == 1 for c in port.cucp.ues.values())

    def lines(out):
        keep = [ln for ln in out.splitlines() if "pcap:" not in ln]
        return [json.dumps({k: v for k, v in json.loads(ln).items() if k != "wall_s"})
                if ln.startswith("{") else ln for ln in keep]
    assert lines(slice_runs["port_out"]) == lines(slice_runs["ref_out"])
    ref_frames, port_frames = _pcap_frames(slice_runs["ref_dir"]), _pcap_frames(slice_runs["port_dir"])
    assert sorted(port_frames) == ["gnb_e1ap.pcap", "gnb_e2ap.pcap", "gnb_f1ap.pcap",
                                   "gnb_gtpu.pcap", "gnb_ngap.pcap"]
    assert port_frames == ref_frames and all(port_frames.values())


def test_cli_runs_end_to_end():
    """``python -m srsran_project_tpu_torch.apps.gnb_sim --cpu --ues 1
    --packets 2 --slots 20 --handover --metrics-json`` exits 0 with ok and
    2/2 packets each way."""
    proc = subprocess.run(
        [sys.executable, "-m", "srsran_project_tpu_torch.apps.gnb_sim", "--cpu", "--ues", "1",
         "--packets", "2", "--slots", "20", "--handover", "--metrics-json"],
        capture_output=True, text=True, timeout=300, cwd=REPO,
        env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2"))
    assert proc.returncode == 0, proc.stdout + proc.stderr
    stats = json.loads([ln for ln in proc.stdout.splitlines() if ln.startswith("{")][-1])
    assert stats["ok"] and stats["dl_packets"] == 2 and stats["ul_packets"] == 2
    assert "UE0 handover -> DU2: state=connected du_id=1" in proc.stdout


def test_testmode_counters_match_reference(monkeypatch, capsys):
    """``--testmode 8 --slots 40 --metrics-json`` (no PHY, deterministic):
    the port's counters equal the reference app's exactly."""
    assert _run_reference(monkeypatch, ["--testmode", "8", "--slots", "40", "--metrics-json"]) == 0
    ref = json.loads(capsys.readouterr().out.splitlines()[-1])
    port = gnb_sim.run(gnb_sim._parser().parse_args(["--testmode", "8", "--slots", "40",
                                                     "--metrics-json"]))
    out = json.loads(capsys.readouterr().out.splitlines()[-1])
    assert port.ok and out == port.metrics
    for k in ("testmode_ues", "slots", "nof_crc", "nof_uci", "dl_bits", "ul_bits"):
        assert out[k] == ref[k], k
    assert (out["nof_crc"], out["nof_uci"]) == (320, 24)


def test_testmode_pcaps_are_closed(monkeypatch, tmp_path, capsys):
    """Reference fault repaired: with ``--testmode`` the reference's app
    returns before it detaches and closes its ``--pcap-dir`` writers, so it
    writes no file and leaves its capture hooks attached.  The port closes
    them however the run ends: five files, each a pcap with no packet."""
    ref_dir, port_dir = tmp_path / "ref", tmp_path / "port"
    monkeypatch.setattr(sys, "argv", ["gnb_sim.py", "--testmode", "2", "--slots", "4",
                                      "--pcap-dir", str(ref_dir)])
    try:
        assert _reference_app().main() == 0
        assert set(j_m._PCAPS) == {j_m.PROTO_NGAP, j_m.PROTO_F1AP, j_m.PROTO_E1AP, 4}
        assert j_gtpu._PCAP is not None
    finally:
        for proto in list(j_m._PCAPS):
            j_m.detach_pcap(proto)
        j_gtpu.detach_pcap()
    assert os.listdir(ref_dir) == []
    port = gnb_sim.run(gnb_sim._parser().parse_args(["--testmode", "2", "--slots", "4",
                                                     "--pcap-dir", str(port_dir)]))
    assert len(port.pcaps) == 5 and all(w.nof_packets == 0 for w in port.pcaps)
    frames = _pcap_frames(str(port_dir))
    assert len(frames) == 5 and not any(frames.values())
    from srsran_project_tpu_torch.l2 import gtpu as t_gtpu_mod
    from srsran_project_tpu_torch.l3 import messages as t_m
    assert t_m._PCAPS == {} and t_gtpu_mod._PCAP is None
    assert "pcap:" in capsys.readouterr().out


def test_no_card_raises(monkeypatch, capsys):
    """Without ``--cpu`` and with no card, ``run`` raises and ``main``
    exits 2 with the reason (the test mode, which runs no PHY, needs none)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        gnb_sim.run(gnb_sim._parser().parse_args(["--ues", "1", "--slots", "1"]))
    assert gnb_sim.main(["--ues", "1", "--slots", "1"]) == 2
    assert "pass --cpu" in capsys.readouterr().err
    assert gnb_sim.main(["--testmode", "1", "--slots", "2"]) == 0


def test_dl_tb_goes_to_its_rnti_repaired(monkeypatch):
    """Reference fault repaired: the reference's app pairs the DL leg's
    RxData indications with ``ul.pusch`` by position, so when the first
    UE's CRC fails the second UE's TB is handed to the first UE
    (``apps/gnb_sim.py`` ``zip(res.rx_data, ul.pusch)``), whose MAC decode
    runs off the end of the foreign PDU and raises.  Here the first DL leg
    loses UE 0's PRBs to noise in both apps; the port hands each TB to its
    RNTI and delivers every packet."""
    def wiping(seed, to_grid):
        inner, calls = _shared_channel(seed, to_grid), []

        def channel(grid):
            rx = inner(grid)
            calls.append(1)
            if len(calls) == 1:  # slot 0's DL leg: UE 0 holds PRBs 0-23
                x = np.array(rx.cpu() if isinstance(rx, torch.Tensor) else rx)
                x[:, :, : 24 * 12] = (np.random.default_rng(9).standard_normal(
                    x[:, :, : 24 * 12].shape) * 3).astype(np.complex64)
                rx = to_grid(x)
            return rx
        return channel

    argv = ["--cpu", "--ues", "2", "--packets", "2", "--slots", "20", "--metrics-json"]
    ref_calls, port_calls = [], []
    _record(monkeypatch, JUpperPhy, ref_calls)
    _record(monkeypatch, TUpperPhy, port_calls)
    ref_ch = wiping(6, jnp.asarray)
    monkeypatch.setattr(j_chem, "apply_channel", lambda grid, key, cfg: (ref_ch(grid), None, None))
    with pytest.raises(IndexError):  # UE 0's MAC decodes UE 1's TB and runs off its end
        _run_reference(monkeypatch, argv)
    port = gnb_sim.run(gnb_sim._parser().parse_args(argv), channel=wiping(6, torch.from_numpy))
    for calls in (ref_calls, port_calls):
        assert calls[1][2] == [(0x4601, 0, False), (0x4602, 0, True)]
    assert port.ok and port.metrics["dl_packets"] == 4 and port.metrics["ul_packets"] == 4
