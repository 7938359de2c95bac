"""The port's native library (BFP, IQ transport, sample ring, OFH serdes)
and its OFH host modules against the JAX package's.

The port builds its own copy of ``native/*.cpp`` with ``native/Makefile``'s
flags into ``build/native_<hash>/``; both libraries are driven with the
same numpy inputs and must write the same bytes (frames, compressed
buffers, decompressed samples: exact).  The port's native BFP is also held
against its numpy plain version (exact).  Each test of the JAX package's
``tests/test_native.py`` and ``tests/test_ofh.py`` has its counterpart
here; the timing worker runs on a fake clock.
"""

import ctypes
import pathlib

import numpy as np
import pytest
import torch
from torch_parity import FakeClock, ref_native  # noqa: F401  (fixture)

from srsran_project_tpu.ofh import ethernet as jeth
from srsran_project_tpu.ofh import receiver as jrecv
from srsran_project_tpu_torch.ofh import ethernet, receiver, timing
from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
from srsran_project_tpu_torch.support import native

REPO = pathlib.Path(__file__).resolve().parent.parent


# ---- the build ---------------------------------------------------------------

def test_library_is_built_from_the_ports_sources():
    """The port's library is its own copy of native/*.cpp (byte for byte
    below a two-line header) built with the Makefile's flags into
    build/native_<hash>, and loads with every entry point bound."""
    for name in native.SOURCES:
        mine = (native.SRC_DIR / name).read_text().splitlines(keepends=True)
        assert mine[0].startswith("// The port's copy of native/")
        assert "".join(mine[2:]) == (REPO / "native" / name).read_text()
    make = (REPO / "native" / "Makefile").read_text()
    flags = make.split("CXXFLAGS ?= ")[1].splitlines()[0].split()
    assert native.CXX_FLAGS == (*flags, "-shared")
    assert make.split("SRCS = ")[1].splitlines()[0].split() == list(native.SOURCES)
    lib = native.get_lib()
    path = native.build_dir() / native.LIB_NAME
    assert path.exists() and native.build_dir().parent == REPO / "build"
    assert pathlib.Path(lib._name) == path
    assert lib.bfp_compressed_prb_bytes(9) == native._prb_bytes(9) == 28


def test_build_goes_through_a_private_file_and_fails_loudly(tmp_path, monkeypatch):
    """A build links into a per-process file and renames it into place,
    writing nothing into the source tree; a source that does not compile
    raises with the compiler's message, leaving no library behind."""
    src = tmp_path / "src"
    src.mkdir()
    for name in native.SOURCES:
        (src / name).write_bytes((native.SRC_DIR / name).read_bytes())
    monkeypatch.setattr(native, "SRC_DIR", src)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    native.get_lib.cache_clear()
    try:
        lib = native.get_lib()
        out = native.build_dir()
        assert sorted(p.name for p in out.iterdir()) == [native.LIB_NAME]
        assert sorted(p.name for p in src.iterdir()) == sorted(native.SOURCES)
        assert lib.bfp_compressed_prb_bytes(14) == native._prb_bytes(14)
        (src / "bfp.cpp").write_text((src / "bfp.cpp").read_text() + "\nint broken(\n")
        native.get_lib.cache_clear()
        with pytest.raises(RuntimeError, match=r"g\+\+ failed[\s\S]*bfp\.cpp"):
            native.get_lib()
        assert not list(native.build_dir().iterdir())
    finally:
        native.get_lib.cache_clear()


def test_no_compiler_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    native.get_lib.cache_clear()
    try:
        with pytest.raises(RuntimeError, match="needs g"):
            native.get_lib()
    finally:
        native.get_lib.cache_clear()


# ---- BFP (tests/test_native.py) ------------------------------------------------

def test_bfp_roundtrip_lossless_small_values(ref_native):
    rng = np.random.default_rng(0)
    x = rng.integers(-200, 200, size=24 * 8, dtype=np.int16)
    c = native.bfp_compress(x, width=9)
    np.testing.assert_array_equal(c, ref_native.bfp_compress(x, width=9))
    np.testing.assert_array_equal(native.bfp_decompress(c, 8, width=9), x)


def test_bfp_large_values_bounded_error(ref_native):
    rng = np.random.default_rng(1)
    x = rng.integers(-30000, 30000, size=24 * 16, dtype=np.int16)
    c = native.bfp_compress(x, width=9)
    back = native.bfp_decompress(c, 16, width=9)
    np.testing.assert_array_equal(back, ref_native.bfp_decompress(c, 16, width=9))
    err = np.abs(back.astype(np.int32) - x.astype(np.int32))
    assert err.max() < (1 << 8)
    assert len(c) < x.size * 2 * 0.65


@pytest.mark.parametrize("width", [8, 9, 12, 14, 16])
@pytest.mark.parametrize("amp", [100, 5000, 32767])
def test_bfp_native_matches_numpy_and_reference(ref_native, width, amp):
    """The native BFP equals the port's numpy plain version and the
    reference's library byte for byte, both ways."""
    rng = np.random.default_rng(width * 7 + amp)
    x = rng.integers(-amp, amp, size=24 * 6, dtype=np.int16, endpoint=True)
    c = native.bfp_compress(x, width=width)
    np.testing.assert_array_equal(c, native._bfp_compress_np(x, 6, width))
    np.testing.assert_array_equal(c, ref_native.bfp_compress(x, width=width))
    d = native.bfp_decompress(c, 6, width)
    np.testing.assert_array_equal(d, native._bfp_decompress_np(c, 6, width))
    np.testing.assert_array_equal(d, ref_native.bfp_decompress(c, 6, width))


def test_bfp_checks_its_inputs():
    with pytest.raises(ValueError, match="multiple of 24"):
        native.bfp_compress(np.zeros(25, np.int16))
    with pytest.raises(ValueError, match="fewer than 2 PRBs"):
        native.bfp_decompress(np.zeros(30, np.uint8), 2, 9)


# ---- IQ transport and sample ring ---------------------------------------------

def test_iq_transport_loopback():
    """A tensor's samples over the UDP transport (copied to the host at
    the socket), back within the Q15 step."""
    rx = native.IqSocket.rx(47431)
    tx = native.IqSocket.tx(47431)
    try:
        rng = np.random.default_rng(3)
        iq = (rng.standard_normal(3000) + 1j * rng.standard_normal(3000)).astype(np.complex64) * 0.1
        tx.send(slot=7, symbol=3, port_id=1, iq=torch.from_numpy(iq))
        got = []
        while sum(g.size for g in got) < iq.size:
            r = rx.recv(max_samples=4096, timeout_ms=500)
            assert r is not None, "transport timeout"
            slot, symbol, port_id, data = r
            assert (slot, symbol, port_id) == (7, 3, 1)
            got.append(data)
        data = np.concatenate(got)
        assert data.size == iq.size
        np.testing.assert_allclose(data, iq, atol=1e-4)
    finally:
        tx.close()
        rx.close()


def test_sample_ring():
    ring = native.SampleRing(nof_blocks=4, block_samples=128)
    try:
        blocks = [np.full(128, i, np.int16) for i in range(4)]
        for b in blocks:
            assert ring.push(b)
        assert not ring.push(blocks[0])  # full
        assert len(ring) == 4
        for i in range(4):
            np.testing.assert_array_equal(ring.pop(), blocks[i])
        assert ring.pop() is None
        with pytest.raises(ValueError, match="128"):
            ring.push(np.zeros(64, np.int16))
    finally:
        ring.close()


# ---- OFH U-plane and C-plane serdes --------------------------------------------

UPLANE_HDR = dict(pc_id=7, seq_id=42, direction=1, frame_id=99, subframe_id=3, slot_id=13,
                  symbol_id=11, start_prb=100)


def test_ofh_uplane_roundtrip(ref_native):
    rng = np.random.default_rng(5)
    nof_prb = 16
    iq = rng.integers(-20000, 20000, size=nof_prb * 24, dtype=np.int16)
    msg = native.ofh_uplane_build(iq, width=9, **UPLANE_HDR)
    np.testing.assert_array_equal(msg, ref_native.ofh_uplane_build(iq, width=9, **UPLANE_HDR))
    hdr, back = native.ofh_uplane_parse(msg)
    assert hdr == dict(UPLANE_HDR, width=9, nof_prb=nof_prb)
    assert (hdr, back.tolist()) == (lambda h, b: (h, b.tolist()))(*ref_native.ofh_uplane_parse(msg))
    err = np.abs(back.astype(np.int32) - iq.astype(np.int32))
    assert err.max() < (1 << 8)
    assert msg[0] == 0x10 and msg[1] == 0x00


@pytest.mark.parametrize("static", [False, True], ids=["dynamic", "static"])
@pytest.mark.parametrize("nof_prb, width", [(1, 9), (12, 14), (255, 9), (18, 16)])
def test_ofh_uplane_frames_match_reference(ref_native, static, nof_prb, width):
    """U-plane messages (dynamic and static compression) byte-identical to
    the reference's, and parsed back to the same header and samples."""
    rng = np.random.default_rng(nof_prb + width)
    iq = rng.integers(-32768, 32767, size=nof_prb * 24, dtype=np.int16, endpoint=True)
    build = native.ofh_uplane_build_static if static else native.ofh_uplane_build
    rbuild = ref_native.ofh_uplane_build_static if static else ref_native.ofh_uplane_build
    msg = build(iq, width=width, **UPLANE_HDR)
    np.testing.assert_array_equal(msg, rbuild(iq, width=width, **UPLANE_HDR))
    if static:
        got, want = native.ofh_uplane_parse_static(msg, width), ref_native.ofh_uplane_parse_static(msg, width)
    else:
        got, want = native.ofh_uplane_parse(msg), ref_native.ofh_uplane_parse(msg)
    assert got[0] == want[0]
    np.testing.assert_array_equal(got[1], want[1])


def test_ofh_uplane_rejects_garbage():
    with pytest.raises(ValueError):
        native.ofh_uplane_parse(np.zeros(64, np.uint8))
    with pytest.raises(ValueError, match="multiple of 24"):
        native.ofh_uplane_build(np.zeros(30, np.int16))


def _sections(m):
    return [m.CplaneSection(section_id=1, start_prbc=0, num_prbc=48, re_mask=0xFFF,
                            num_symbol=14, beam_id=7),
            m.CplaneSection(section_id=2, start_prbc=48, num_prbc=0, re_mask=0x0F0,
                            num_symbol=2, beam_id=0x7FFF)]


def test_ofh_cplane_type1_roundtrip(ref_native):
    secs = _sections(native)
    kw = dict(rtc_id=5, seq_id=99, direction=1, frame_id=200, subframe_id=3, slot_id=13,
              start_symbol=2, section_type=1)
    msg = native.ofh_cplane_build(secs, **kw)
    np.testing.assert_array_equal(msg, ref_native.ofh_cplane_build(_sections(ref_native), **kw))
    hdr, out = native.ofh_cplane_parse(msg)
    assert hdr == dict(kw, time_offset=0)
    assert out == secs


def test_ofh_cplane_type3_prach_with_freq_offset(ref_native):
    secs = [native.CplaneSection(section_id=9, start_prbc=10, num_prbc=12, freq_offset=-5000)]
    msg = native.ofh_cplane_build(secs, section_type=3, time_offset=1234)
    rsecs = [ref_native.CplaneSection(section_id=9, start_prbc=10, num_prbc=12, freq_offset=-5000)]
    np.testing.assert_array_equal(msg, ref_native.ofh_cplane_build(rsecs, section_type=3,
                                                            time_offset=1234))
    hdr, out = native.ofh_cplane_parse(msg)
    assert hdr["section_type"] == 3 and hdr["time_offset"] == 1234
    assert out[0].freq_offset == -5000


def test_ofh_cplane_malformed_rejected():
    with pytest.raises(ValueError):
        native.ofh_cplane_parse(np.zeros(40, np.uint8))
    with pytest.raises(ValueError):
        native.ofh_cplane_parse_type0(np.zeros(40, np.uint8))
    with pytest.raises(ValueError):
        native.ofh_cplane_comp_hdr(np.zeros(8, np.uint8))


# ---- OFH host modules (tests/test_ofh.py) -------------------------------------

def test_vlan_frame_roundtrip_and_padding():
    dst, src = bytes(range(6)), bytes(range(6, 12))
    f = ethernet.build_frame(dst, src, b"ecpri", vlan_id=564, pcp=7)
    assert f == jeth.build_frame(dst, src, b"ecpri", vlan_id=564, pcp=7)
    assert len(f) == 64
    d, s, vlan, payload = ethernet.parse_frame(f)
    assert (d, s, vlan) == (dst, src, 564)
    assert payload.startswith(b"ecpri")
    d, s, vlan, _ = ethernet.parse_frame(ethernet.build_frame(dst, src, b"x"))
    assert vlan is None
    assert ethernet.parse_frame(dst + src + b"\x08\x00" + bytes(50)) is None


def _ts(abs_sym):
    slots, symbol = divmod(abs_sym, 14)
    sfslots, slot = divmod(slots, 2)
    frame, subframe = divmod(sfslots, 10)
    return frame % 256, subframe, slot, symbol


def test_rx_window_checker():
    """The window's verdicts and counts equal the reference's on a sweep
    around OTA time (the 256-frame wrap included)."""
    w, jw = receiver.RxWindowChecker(28, 2), jrecv.RxWindowChecker(28, 2)
    for ota in (1000, 10):
        w.tick(ota_symbol=ota)
        jw.tick(ota_symbol=ota)
        for d in range(-40, 60, 3):
            t = (ota + d) % (256 * 10 * 2 * 14)
            assert w.check(*_ts(t)) == jw.check(*_ts(t))
    assert vars(w.stats) == vars(jw.stats)
    w = receiver.RxWindowChecker(window_early_symbols=28, window_late_symbols=2)
    w.tick(ota_symbol=1000)
    assert w.check(*_ts(1000)) and w.check(*_ts(1020))
    assert not w.check(*_ts(1060)) and not w.check(*_ts(990))
    assert (w.stats.on_time, w.stats.early, w.stats.late) == (2, 1, 1)


def test_seq_id_checker_gap_and_duplicate():
    c = receiver.SeqIdChecker()
    assert c.check(0, 5) and c.check(0, 6)
    assert c.check(0, 9)
    assert c.lost == 2
    assert not c.check(0, 9)
    assert c.duplicates == 1
    assert c.check(1, 0)
    assert c.check(2, 0xFFFE) and c.check(2, 0xFFFF) and c.check(2, 0)  # 16-bit wrap
    assert (c.lost, c.duplicates) == (2, 1)
    # Verdicts and counts equal the reference's on a stream with gaps,
    # repeats and reordering on three eAxCs.
    rng = np.random.default_rng(4)
    c, jc = receiver.SeqIdChecker(), jrecv.SeqIdChecker()
    seq = {e: 0xFFF0 for e in range(3)}
    for _ in range(300):
        e = int(rng.integers(3))
        seq[e] = (seq[e] + int(rng.choice([1, 1, 1, 2, 5, 0, -1]))) & 0xFFFF
        assert c.check(e, seq[e]) == jc.check(e, seq[e])
    assert (c.lost, c.duplicates) == (jc.lost, jc.duplicates) and c.lost and c.duplicates


def test_cplane_uplane_over_ethernet(ref_native):
    """A U-plane message through the raw C entry points in a VLAN frame,
    byte-identical to the reference library's, parsed back."""
    rng = np.random.default_rng(0)
    iq = rng.integers(-2000, 2000, size=(4 * 24,), dtype=np.int16)
    frames = []
    for m in (native, ref_native):
        lib = m.get_lib()
        buf = np.zeros(lib.ofh_uplane_size(4, 9), np.uint8)
        n = lib.ofh_uplane_build(buf.ctypes.data, buf.size, 2, 17, 0, 12, 3, 1, 7, 0, 4, 9,
                                 iq.ctypes.data)
        assert n == buf.size
        frames.append(ethernet.build_frame(b"\xff" * 6, b"\x02" + bytes(5), bytes(buf),
                                           vlan_id=3))
    assert frames[0] == frames[1]
    _, _, vlan, payload = ethernet.parse_frame(frames[0])
    assert vlan == 3
    out = np.zeros(4 * 24, np.int16)
    ints = [ctypes.c_int() for _ in range(7)]
    pc, seq = ctypes.c_uint16(), ctypes.c_uint16()
    arr = np.frombuffer(payload, np.uint8).copy()
    got = native.get_lib().ofh_uplane_parse(arr.ctypes.data, arr.size, ctypes.byref(pc),
                                            ctypes.byref(seq), *[ctypes.byref(i) for i in ints],
                                            out.ctypes.data)
    assert got == 4 and pc.value == 2 and seq.value == 17
    assert np.abs(out.astype(np.int32) - iq.astype(np.int32)).max() <= (1 << 3)


def test_realtime_timing_worker_paces_slots(monkeypatch):
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    slots = []
    w = timing.RealtimeTimingWorker(SubcarrierSpacing.KHZ30, on_slot=slots.append)
    w.run(nof_slots=10)
    assert len(slots) == 10 and w.slots_skipped == 0
    counts = [s.count for s in slots]
    assert counts == list(range(10))
    # 10 slot boundaries at 0.5 ms, polled every 1/15 of a symbol.
    assert clock.t - 100.0 == pytest.approx(9 * 0.5e-3, abs=w.poll_sleep_s)
    assert clock.sleeps == pytest.approx(9 * 14 * 15, abs=2)


def test_realtime_timing_worker_counts_skipped_slots(monkeypatch):
    """A host that falls behind gets the newest slot and a count of the
    slots it skipped (the late-tick pathology the reference logs)."""
    clock = FakeClock()
    monkeypatch.setattr(timing, "time", clock)
    slots = []
    w = timing.RealtimeTimingWorker(SubcarrierSpacing.KHZ30, on_slot=slots.append)
    assert w.poll() == 1 and w.poll() == 0
    clock.t += 3.2e-3  # 6 slots later
    assert w.poll() == 1
    assert [s.count for s in slots] == [0, 6] and w.slots_skipped == 5
    w.stop()
    w.run(nof_slots=100)  # returns at once
    assert w.slots_notified == 2
