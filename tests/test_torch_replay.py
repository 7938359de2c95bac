"""The port's golden-replay harness (``support.replay``) against the
reference's: digests of equal values equal across the packages (a tensor
hashes its host copy under the numpy dtype name and shape), traces that
load across the packages, and the port's ``UpperPhy`` replayed from
threads against its sequential golden."""

import dataclasses
import threading

import numpy as np
import pytest
import torch
from torch_parity import to_torch

from srsran_project_tpu.fapi import messages as jfapi
from srsran_project_tpu.phy import pdsch as jpdsch
from srsran_project_tpu.phy import pusch as jpusch
from srsran_project_tpu.phy.allocation import Allocation as JAllocation
from srsran_project_tpu.phy.upper_phy import UpperPhy as JUpperPhy
from srsran_project_tpu.phy.upper_phy import UpperPhyConfig as JUpperPhyConfig
from srsran_project_tpu.ops.modulation import Modulation as JModulation
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlotPoint
from srsran_project_tpu.support import replay as jreplay
from srsran_project_tpu_torch.fapi import messages as tfapi
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.phy import pdsch as tpdsch
from srsran_project_tpu_torch.phy import pusch as tpusch
from srsran_project_tpu_torch.phy.allocation import Allocation
from srsran_project_tpu_torch.phy.upper_phy import UpperPhy, UpperPhyConfig
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
from srsran_project_tpu_torch.ran.slot_point import SlotPoint
from srsran_project_tpu_torch.support import replay

_RNG = np.random.default_rng(7)
ARRAYS = {
    "float32": _RNG.standard_normal((3, 4)).astype(np.float32),
    "complex64": (_RNG.standard_normal(6) + 1j * _RNG.standard_normal(6)).astype(np.complex64),
    "int8": _RNG.integers(-128, 128, size=(2, 5), dtype=np.int8),
    "uint8": _RNG.integers(0, 2, size=(17,), dtype=np.uint8),
    "bool": _RNG.integers(0, 2, size=(4,)).astype(bool),
    "int64_0d": np.array(12345, np.int64),
    "float16": _RNG.standard_normal(5).astype(np.float16),
}


@pytest.mark.parametrize("name", sorted(ARRAYS))
def test_digest_equals_the_reference_s(name):
    a = ARRAYS[name]
    assert replay.array_digest(to_torch(a)) == jreplay.array_digest(a)
    assert replay.array_digest(a) == jreplay.array_digest(a)


def test_digest_of_views():
    """Strided, transposed and conjugate views hash their values."""
    a = ARRAYS["complex64"].reshape(2, 3)
    t = to_torch(a)
    assert replay.array_digest(t.T) == jreplay.array_digest(a.T)
    assert replay.array_digest(t.conj()) == jreplay.array_digest(np.conj(a))
    assert replay.array_digest(t[:, ::2]) == jreplay.array_digest(a[:, ::2])
    assert replay.array_digest(-t.conj().imag) == jreplay.array_digest(-np.conj(a).imag)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float8_e4m3fn])
def test_dtype_without_numpy_twin_raises(dtype):
    with pytest.raises(TypeError):
        replay.array_digest(torch.zeros(3, dtype=dtype))


@dataclasses.dataclass
class _Payload:
    crc_ok: object
    snr_db: float
    name: str
    extra: object = None


def test_flatten_sees_tensors_and_dataclasses():
    """The same payload, with tensors in the port's and numpy arrays in
    the reference's: the same arrays in the same order."""
    a, b = ARRAYS["float32"], ARRAYS["uint8"]
    port = {"z": [_Payload(to_torch(b), 3.5, "x", None), 7], "a": (to_torch(a), True, None)}
    ref = {"z": [_Payload(b, 3.5, "x", None), 7], "a": (a, True, None)}
    got = [replay.array_digest(x) for x in replay._flatten_arrays(port)]
    assert got == [jreplay.array_digest(x) for x in jreplay._flatten_arrays(ref)]
    assert len(got) == 4  # the tensor, the bits, 3.5 and 7 (bools and None skip)


def _record_both(port_rec, ref_rec):
    for i, name in enumerate(sorted(ARRAYS)):
        port_rec.record(name, i, {"x": to_torch(ARRAYS[name]), "k": i})
        ref_rec.record(name, i, {"x": ARRAYS[name], "k": i})


def test_traces_load_across_packages(tmp_path):
    port_rec, ref_rec = replay.SlotRecorder(keep_arrays=True), jreplay.SlotRecorder()
    _record_both(port_rec, ref_rec)
    port_rec.save(str(tmp_path / "port.npz"))
    ref_rec.save(str(tmp_path / "ref.npz"))
    assert not jreplay.diff_traces(jreplay.SlotRecorder.load(str(tmp_path / "port.npz")), ref_rec)
    assert not replay.diff_traces(replay.SlotRecorder.load(str(tmp_path / "ref.npz")), port_rec)
    assert isinstance(port_rec.arrays[0][2][0], np.ndarray)


def _cfgs(alloc_cls, mod, pdsch, pusch):
    alloc = alloc_cls(rb_start=0, rb_count=12, sym_start=1, sym_count=12, dmrs_symbols=(2,))
    common = dict(tbs=600, target_code_rate=0.3, modulation=mod.QPSK, alloc=alloc,
                  nof_layers=1, nof_grid_symbols=14, nof_grid_sc=144)
    return pdsch.PdschConfig(nof_ports=1, **common), pusch.PuschConfig(nof_rx_ports=1, **common)


def _grid(i: int, tx_cfg) -> np.ndarray:
    """Slot i's received grid: the reference's PDSCH of a per-slot TB."""
    rng = np.random.default_rng(100 + i)  # per-slot seed => deterministic
    tb = rng.integers(0, 2, size=(tx_cfg.tbs,), dtype=np.uint8)
    grid = np.asarray(jpdsch.process(tb, np.uint32(0x41 + i), np.eye(1, dtype=np.complex64),
                                     tx_cfg))
    return grid + np.complex64(1e-3)


@pytest.fixture(scope="module")
def grids():
    tx_cfg, _ = _cfgs(JAllocation, JModulation, jpdsch, jpusch)
    return [_grid(i, tx_cfg) for i in range(4)]


def _run_port(recorder, grids, threaded=False, device="cpu"):
    """Drive the port's UpperPhy over the UL slots, optionally from worker
    threads (one per slot), recording grid/result taps."""
    phy = UpperPhy(UpperPhyConfig(nof_ports=1, nof_grid_sc=144, device=device))
    phy.add_tap(recorder.tap)
    _, rx_cfg = _cfgs(Allocation, Modulation, tpdsch, tpusch)
    crc = [None] * len(grids)

    def one_slot(i):
        slot = SlotPoint.from_sfn_slot(SubcarrierSpacing.KHZ30, 0, i)
        req = tfapi.UlTtiRequest(slot=slot, pusch=[tfapi.UlPuschPdu(rx_cfg, 0x41 + i,
                                                                    harq_id=0)])
        crc[i] = phy.process_ul_tti(req, to_torch(grids[i]).to(device)).crc[0].tb_crc_ok

    if threaded:
        threads = [threading.Thread(target=one_slot, args=(i,)) for i in range(len(grids))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    else:
        for i in range(len(grids)):
            one_slot(i)
    assert crc == [True] * len(grids)


def test_ul_grid_digests_equal_the_reference_s(grids):
    """The UL grid each package's UpperPhy taps hashes the same."""
    port_rec, ref_rec = replay.SlotRecorder(), jreplay.SlotRecorder()
    _run_port(port_rec, grids[:2])
    phy = JUpperPhy(JUpperPhyConfig(nof_ports=1))
    phy.add_tap(ref_rec.tap)
    _, rx_cfg = _cfgs(JAllocation, JModulation, jpdsch, jpusch)
    for i in range(2):
        req = jfapi.UlTtiRequest(slot=JSlotPoint.from_sfn_slot(JScs.KHZ30, 0, i),
                                 pusch=[jfapi.UlPuschPdu(rx_cfg, 0x41 + i, harq_id=0)])
        phy.process_ul_tti(req, grids[i])
    port, ref = port_rec.canonical(), ref_rec.canonical()
    keys = [k for k in ref if k[0] == "ul_grid"]
    assert len(keys) == 2 and all(port[k] == ref[k] for k in keys)


def test_sequential_replay_is_deterministic(grids):
    golden = replay.assert_replay_deterministic(lambda rec: _run_port(rec, grids), n_runs=2)
    assert {e.kind for e in golden.entries} == {"ul_grid", "ul_results"}


def test_threaded_run_matches_sequential_golden(grids):
    """A thread-per-slot run must produce the same per-slot digests as the
    sequential golden — the actual race check."""
    g, c = replay.SlotRecorder(), replay.SlotRecorder()
    _run_port(g, grids)
    _run_port(c, grids, threaded=True)
    assert not replay.diff_traces(g, c)


def test_diff_pinpoints_corruption(grids):
    g, c = replay.SlotRecorder(), replay.SlotRecorder()
    _run_port(g, grids[:2])
    _run_port(c, grids[:2])
    e = c.entries[3]
    c.entries[3] = replay.TraceEntry(e.kind, e.slot, ("deadbeef",) * len(e.digests))
    problems = replay.diff_traces(g, c)
    assert problems and f"slot {e.slot}" in problems[0]
    with pytest.raises(AssertionError, match="nondeterministic"):
        runs = iter([g, c])
        replay.assert_replay_deterministic(
            lambda rec: rec.entries.extend(next(runs).entries), n_runs=2)


def test_trace_roundtrips_through_file(grids, tmp_path):
    g = replay.SlotRecorder()
    _run_port(g, grids[:2])
    path = str(tmp_path / "golden_trace.npz")
    g.save(path)
    loaded = replay.SlotRecorder.load(path)
    assert not replay.diff_traces(g, loaded)
    c = replay.SlotRecorder()
    _run_port(c, grids[:2])
    assert not replay.diff_traces(loaded, c)
