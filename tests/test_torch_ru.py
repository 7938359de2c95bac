"""The port's RU layer (dummy, generic and OFH RUs), the time-domain TDL,
the baseband loop and the RU-emulator slot over UDP against the JAX
package's.

Each test of the JAX package's ``tests/test_ru.py``, ``test_ru_emulator.py``
and ``test_lower_loop.py`` has its counterpart here, on CPU tensors
(``device="cpu"``).  Tolerances: ``RuGeneric``'s transmitted samples, its
demodulated grids and its PRACH buffers within 1e-5 x the reference's RMS
(torch.fft against the reference's DFT); ``RuOfh``'s frames byte-identical
to the reference's, one for one, and its reassembled grids exact;
``apply_channel_time_taps`` on the reference's own draws within 1e-5 x
RMS; the port's own draws by their statistics.  The baseband loop and the
realtime ticker run on a fake clock.
"""

import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch_parity import FakeClock, ref_native, to_np  # noqa: F401  (fixture)

from srsran_project_tpu import ru as jru
from srsran_project_tpu.phy import channel_emulator as jchem
from srsran_project_tpu.phy import prach as jprach
from srsran_project_tpu.ran.constants import SubcarrierSpacing as JScs
from srsran_project_tpu.ran.slot_point import SlotPoint as JSlot
from srsran_project_tpu_torch.ofh import timing
from srsran_project_tpu_torch.ops import lower_phy, ofdm
from srsran_project_tpu_torch.ops.modulation import Modulation
from srsran_project_tpu_torch.phy import channel_emulator as chem
from srsran_project_tpu_torch.phy import lower_loop, pdsch, pusch
from srsran_project_tpu_torch.phy import prach as tprach
from srsran_project_tpu_torch.phy.allocation import Allocation
from srsran_project_tpu_torch.ran.constants import CyclicPrefix, SubcarrierSpacing
from srsran_project_tpu_torch.ran.slot_point import SlotPoint
from srsran_project_tpu_torch.ru import (
    PrachBufferContext,
    ResourceGridContext,
    RuDummy,
    RuDummyConfig,
    RuGeneric,
    RuGenericConfig,
    RuOfh,
    RuOfhConfig,
    RuOfhMultiSector,
    create_ru,
)
from srsran_project_tpu_torch.support import native

SCS = SubcarrierSpacing.KHZ30
JSCS = JScs.KHZ30


class Collector:
    def __init__(self):
        self.symbols = []
        self.prach = []
        self.ttis = []

    def on_new_uplink_symbol(self, context, grid, is_valid):
        self.symbols.append((context, grid, is_valid))

    def on_new_prach_window_data(self, context, buffer):
        self.prach.append((context, buffer))

    def on_tti_boundary(self, slot):
        self.ttis.append(slot)

    def on_ul_half_slot_boundary(self, slot):
        pass

    def on_ul_full_slot_boundary(self, slot):
        pass


class Errors:
    def __init__(self):
        self.dl = []
        self.ul = []
        self.prach = []

    def on_late_downlink_message(self, slot, sector):
        self.dl.append(slot)

    def on_late_uplink_message(self, slot, sector):
        self.ul.append(slot)

    def on_late_prach_message(self, slot, sector):
        self.prach.append(slot)


def random_grid(seed: int, shape, scale: float = 1.0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return ((rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) * scale
            ).astype(np.complex64)


def assert_rms_close(got, want, rel: float = 1e-5):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    rms = float(np.sqrt(np.mean(np.abs(want) ** 2)))
    assert np.abs(got - want).max() <= rel * rms


# ---- RuDummy -----------------------------------------------------------------

def test_dummy_ru_on_time_requests_notify():
    col, err = Collector(), Errors()
    cfg = RuDummyConfig(scs=SCS, dl_data_margin=2)
    ru = RuDummy(cfg, col, timing_notifier=col, error_notifier=err)
    dl = ru.get_downlink_plane_handler()
    ul = ru.get_uplink_plane_handler()
    slot = SlotPoint.from_sfn_slot(SCS, 10, 0)
    dl.handle_dl_data(ResourceGridContext(slot=slot + cfg.dl_data_margin),
                      torch.zeros((1, 14, 12), dtype=torch.complex64))
    ul.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ul.handle_prach_occasion(PrachBufferContext(slot=slot))
    ru.tick(slot)
    m = ru.get_metrics()
    assert m.total_dl_requests == 1 and m.total_ul_requests == 1
    assert m.late_dl_requests == 0 and m.late_ul_requests == 0
    assert len(col.symbols) == 14
    assert len(col.prach) == 1
    assert col.ttis and col.ttis[0] == slot
    assert not err.dl and not err.ul


def test_dummy_ru_detects_late_requests():
    col, err = Collector(), Errors()
    ru = RuDummy(RuDummyConfig(scs=SCS, dl_data_margin=2), col, error_notifier=err)
    stale = SlotPoint.from_sfn_slot(SCS, 0, 4)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=stale))
    ring = len(ru.sectors[0]._ul)
    assert ring == len(jru.RuDummy(jru.RuDummyConfig(), None).sectors[0]._ul) == 8
    ru.tick(SlotPoint(SCS, stale.count + ring))  # same ring index, a later slot
    assert ru.get_metrics().late_ul_requests == 1
    assert err.ul == [stale]
    assert not col.symbols


def test_dummy_ru_loopback_returns_dl_grid():
    col = Collector()
    ru = RuDummy(RuDummyConfig(scs=SCS, dl_data_margin=0, loopback=True), col)
    slot = SlotPoint.from_sfn_slot(SCS, 1, 1)
    grid = torch.arange(14 * 12).reshape(1, 14, 12).to(torch.complex64)
    ru.handle_dl_data(ResourceGridContext(slot=slot), grid)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.tick(slot)
    assert len(col.symbols) == 14
    _, got, valid = col.symbols[0]
    assert valid and got is grid


def test_dummy_ru_realtime_start_stop(monkeypatch):
    """start() runs the realtime ticker in a thread (on a fake clock here),
    which notifies slot boundaries until stop() joins it."""
    monkeypatch.setattr(timing, "time", FakeClock(yield_s=1e-4))
    col = Collector()
    ru = RuDummy(RuDummyConfig(scs=SCS), col, timing_notifier=col)
    ru.start()
    try:
        deadline = time.monotonic() + 10
        while len(col.ttis) < 5 and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        thread = ru._thread
        ru.stop()
    assert not thread.is_alive()
    assert len(col.ttis) >= 5
    counts = [s.count for s in col.ttis]
    assert counts == sorted(set(counts))


# ---- RuGeneric ----------------------------------------------------------------

@pytest.mark.parametrize("dft, nof_rb, tx_gain, rx_gain", [(256, 12, 0.0, 0.0),
                                                          (512, 24, 3.0, -2.0)])
def test_generic_ru_modulates_and_roundtrips(dft, nof_rb, tx_gain, rx_gain):
    """DL grid -> modulated samples (a tensor for transmit_cb) -> looped
    back as UL -> demodulated grid; samples and grids against the
    reference's RU on the same inputs."""
    kw = dict(dft_size=dft, nof_rb=nof_rb, tx_gain_db=tx_gain, rx_gain_db=rx_gain)
    grid = random_grid(0, (1, 14, nof_rb * 12))
    col, col_j = Collector(), Collector()
    tx, tx_j = {}, {}
    ru = RuGeneric(RuGenericConfig(scs=SCS, device="cpu", **kw), col,
                   transmit_cb=lambda s, x: tx.setdefault(s.count, x), timing_notifier=col)
    ru_j = jru.RuGeneric(jru.RuGenericConfig(scs=JSCS, **kw), col_j,
                         transmit_cb=lambda s, x: tx_j.setdefault(s.count, x))
    slot, slot_j = SlotPoint.from_sfn_slot(SCS, 3, 1), JSlot.from_sfn_slot(JSCS, 3, 1)
    ru.handle_dl_data(ResourceGridContext(slot=slot), torch.from_numpy(grid))
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru_j.handle_dl_data(jru.ResourceGridContext(slot=slot_j), grid)
    # No UL baseband yet: the slot transmits the DL and notifies invalid UL
    # symbols.
    ru.advance_slot(slot)
    ru_j.advance_slot(slot_j)
    assert isinstance(tx[slot.count], torch.Tensor) and tx[slot.count].dtype == torch.complex64
    assert_rms_close(to_np(tx[slot.count]), tx_j[slot_j.count])
    assert len(col.symbols) == 14 and not col.symbols[0][2] and col.symbols[0][1] is None
    assert col.ttis == [slot]

    # Round trip: the transmitted baseband back as UL (numpy into the port,
    # moved to its device), the next slot.
    samples = to_np(tx[slot.count])
    for r, c, ctx, s in ((ru, ResourceGridContext, slot + 1, samples),
                         (ru_j, jru.ResourceGridContext, slot_j + 1, samples)):
        r.push_ul_samples(ctx, s)
        r.handle_new_uplink_slot(c(slot=ctx))
        r.advance_slot(ctx)
    got, got_j = col.symbols[-1], col_j.symbols[-1]
    assert got[2] and got_j[2]
    assert isinstance(got[1], torch.Tensor) and got[1].device.type == "cpu"
    assert_rms_close(to_np(got[1]), np.asarray(got_j[1]))
    # slot_in_subframe differs (phase compensation), so compare magnitudes.
    gain = 10 ** ((tx_gain + rx_gain) / 20)
    assert np.allclose(np.abs(to_np(got[1])), np.abs(grid) * gain, atol=2e-3)


def test_generic_ru_counts_stale_requests():
    col, err = Collector(), Errors()
    ru = RuGeneric(RuGenericConfig(scs=SCS, dft_size=256, nof_rb=12, device="cpu"), col,
                   error_notifier=err)
    slot = SlotPoint.from_sfn_slot(SCS, 5, 0)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.handle_dl_data(ResourceGridContext(slot=slot), np.zeros((1, 14, 144), np.complex64))
    ru.handle_prach_occasion(PrachBufferContext(slot=slot))
    ru.advance_slot(slot + 3)
    m = ru.get_metrics()
    assert (m.late_ul_requests, m.late_dl_requests, m.late_prach_requests) == (1, 1, 1)
    assert err.ul == err.dl == err.prach == [slot]


@pytest.mark.parametrize("fmt, dft, nof_rb", [("B4", 2048, 51), ("0", 1024, 24)])
def test_generic_ru_demodulates_prach_occasion(fmt, dft, nof_rb):
    """A PRACH occasion request returns the TS 38.211 5.3.2 frequency-
    domain buffer: a preamble synthesized at the window's DFT bins comes
    back at the right buffer indices, equal to the reference RU's buffer."""
    l_ra = 139 if fmt == "B4" else 839
    slot = SlotPoint.from_sfn_slot(SCS, 0, 1)
    wp = lower_phy.prach_window_params(
        fmt=fmt, pusch_scs_hz=30000, slot_in_subframe=slot.slot_in_subframe, start_symbol=0,
        td_occasion=0, srate_hz=dft * 30000, rb_offset=2, fd_occasion=0,
        nof_prb_ul_grid=nof_rb, l_ra=l_ra)
    rng = np.random.default_rng(5)
    pre = np.exp(2j * np.pi * rng.random(l_ra)).astype(np.complex64)
    spec = np.zeros(wp["dft_size"], np.complex64)
    spec[(wp["k_offset"] + np.arange(l_ra)) % wp["dft_size"]] = pre
    sym = np.fft.ifft(spec) * np.sqrt(wp["dft_size"])
    body = np.tile(sym, wp["nof_symbols"])
    samples = np.concatenate([np.zeros(wp["sample_offset"], np.complex64), body[-wp["cp_samples"]:],
                              body, np.zeros(64, np.complex64)]).astype(np.complex64)[None]

    col, col_j = Collector(), Collector()
    ru = RuGeneric(RuGenericConfig(scs=SCS, dft_size=dft, nof_rb=nof_rb, device="cpu"), col)
    ru_j = jru.RuGeneric(jru.RuGenericConfig(scs=JSCS, dft_size=dft, nof_rb=nof_rb), col_j)
    ctx = PrachBufferContext(slot=slot, start_symbol=0, format=fmt, rb_offset=2)
    slot_j = JSlot.from_sfn_slot(JSCS, 0, 1)
    ru.handle_prach_occasion(ctx)
    ru.push_ul_samples(slot, torch.from_numpy(samples))
    ru.advance_slot(slot)
    ru_j.handle_prach_occasion(jru.PrachBufferContext(slot=slot_j, start_symbol=0, format=fmt,
                                                      rb_offset=2))
    ru_j.push_ul_samples(slot_j, samples)
    ru_j.advance_slot(slot_j)
    assert len(col.prach) == 1 and col.prach[0][0] is ctx
    buffer = to_np(col.prach[0][1])
    assert buffer.shape == (1, wp["nof_symbols"], l_ra)
    assert np.allclose(buffer[0, 0], pre, atol=1e-3)
    assert_rms_close(buffer, np.asarray(col_j.prach[0][1]))


def test_generic_ru_through_time_domain_tdl_channel():
    """RU-modulated baseband through the sparse-FIR TDL-A channel (true
    multipath within the CP) decodes CRC-OK."""
    alloc = Allocation(rb_start=0, rb_count=24, sym_start=0, sym_count=14, dmrs_symbols=(2, 11))
    common = dict(tbs=1200, target_code_rate=0.3, modulation=Modulation.QPSK, alloc=alloc,
                  nof_layers=1, nof_grid_symbols=14, nof_grid_sc=288)
    txc = pdsch.PdschConfig(nof_ports=1, **common)
    rxc = pusch.PuschConfig(nof_rx_ports=1, **common)
    tb = np.random.default_rng(0).integers(0, 2, (1200,), np.uint8)
    grid = pdsch.process(torch.from_numpy(tb), 9, torch.eye(1, dtype=torch.complex64), txc)

    col = Collector()
    tx = {}
    ru = RuGeneric(RuGenericConfig(scs=SCS, dft_size=512, nof_rb=24, device="cpu"), col,
                   transmit_cb=tx.__setitem__)
    slot = SlotPoint.from_sfn_slot(SCS, 0, 0)
    ru.handle_dl_data(ResourceGridContext(slot=slot), grid)
    ru.advance_slot(slot)
    ch = chem.ChannelConfig(profile="tdla", sinr_db=20.0, nof_tx_ports=1, nof_rx_ports=1,
                            nof_sc=288)
    rx = chem.apply_channel_time(tx[slot], torch.Generator().manual_seed(3), ch,
                                 srate_hz=512 * 30e3)
    ru.push_ul_samples(slot, rx)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.advance_slot(slot)
    out = pusch.process(col.symbols[-1][1][None], torch.tensor([9]), rxc)
    assert bool(out["tb_crc_ok"][0])
    np.testing.assert_array_equal(to_np(out["tb_bits"][0]), tb)


# ---- apply_channel_time ------------------------------------------------------------

@pytest.mark.parametrize("profile, ports, srate", [("tdla", 1, 512 * 30e3),
                                                   ("tdla", 4, 122.88e6),
                                                   ("tdlc", 2, 30.72e6)])
def test_apply_channel_time_on_the_references_draws(profile, ports, srate):
    """The applying part, given the reference's own gains and noise (drawn
    from its key as it draws them), equals the reference's output."""
    rng = np.random.default_rng(11)
    x = random_grid(11, (ports, 4000), 0.3)
    cfg_j = jchem.ChannelConfig(profile=profile, sinr_db=17.0, nof_tx_ports=ports,
                                nof_rx_ports=ports)
    key = jax.random.PRNGKey(int(rng.integers(1 << 30)))
    want = np.asarray(jchem.apply_channel_time(x, key, cfg_j, srate_hz=srate))
    kg, kn = jax.random.split(key)
    taps = jchem.PROFILES[profile]
    p = 10.0 ** (np.asarray([t[1] for t in taps]) / 10.0)
    p = p / p.sum()
    one_j = jnp.asarray([1.0, 1j], jnp.complex64)
    g = (jax.random.normal(kg, (ports, ports, len(taps), 2)) @ one_j) * jnp.asarray(
        np.sqrt(p / 2.0), jnp.complex64)
    noise = jax.random.normal(kn, (ports, x.shape[1], 2)) @ one_j
    got = chem.apply_channel_time_taps(torch.from_numpy(x), torch.from_numpy(np.array(g)),
                                       torch.from_numpy(np.array(noise)),
                                       chem.ChannelConfig.from_reference(cfg_j), srate)
    assert_rms_close(to_np(got), want)
    delays = np.round(np.asarray([t[0] for t in taps]) * 1e-9 * srate).astype(np.int32)
    assert chem._time_taps(profile, srate)[0] == tuple(delays.tolist())


def test_apply_channel_time_draws():
    """The port's draws (generator -> gains, then noise) by their
    statistics: each tap's mean power is its share of the profile, the
    noise realizes the SINR against the faded signal; and
    ``apply_channel_time`` is the applying part on exactly those draws."""
    cfg = chem.ChannelConfig(profile="tdla", sinr_db=10.0, nof_tx_ports=2, nof_rx_ports=2)
    srate = 61.44e6
    gen = torch.Generator().manual_seed(5)
    g = torch.stack([chem.draw_channel_time(gen, cfg, srate) for _ in range(2000)])
    p = 10.0 ** (np.asarray([t[1] for t in chem.PROFILES["tdla"]]) / 10.0)
    p = p / p.sum()
    power = to_np((g.abs() ** 2).mean(dim=(0, 1, 2)))
    np.testing.assert_allclose(power, p, rtol=0.08)
    assert abs(float(g.real.mean())) < 0.01 and abs(float(g.imag.mean())) < 0.01

    x = torch.from_numpy(random_grid(3, (2, 20000), 0.5))
    y = chem.apply_channel_time(x, torch.Generator().manual_seed(9), cfg, srate)
    gen = torch.Generator().manual_seed(9)
    gains = chem.draw_channel_time(gen, cfg, srate)
    noise = chem._complex_normal((2, x.shape[1]), gen)
    assert torch.equal(y, chem.apply_channel_time_taps(x, gains, noise, cfg, srate))
    clean = chem.apply_channel_time_taps(x, gains, torch.zeros_like(noise), cfg, srate)
    snr = float((clean.abs() ** 2).mean() / ((y - clean).abs() ** 2).mean())
    assert 10 * np.log10(snr) == pytest.approx(10.0, abs=0.1)
    with pytest.raises(ValueError, match="generator"):
        chem.apply_channel_time(x.to("meta"), torch.Generator(), cfg, srate)


# ---- RuOfh ---------------------------------------------------------------------

class OfhPair:
    """The port's RuOfh and the reference's on one config, fed the same
    requests; each keeps its wire."""

    def __init__(self, ref_native, **kw):
        self.col, self.col_j = Collector(), Collector()
        self.err, self.err_j = Errors(), Errors()
        self.wire, self.wire_j = [], []
        self.ru = RuOfh(RuOfhConfig(scs=SCS, device="cpu", **kw), self.col,
                        send_frame=self.wire.append, error_notifier=self.err)
        self.ru_j = jru.RuOfh(jru.RuOfhConfig(scs=JSCS, **kw), self.col_j,
                              send_frame=self.wire_j.append, error_notifier=self.err_j)

    def call(self, method: str, count: int, *args, grid=None, sector=0, ctx="grid", **kw):
        """The same request to both RUs at the slot of ``count``."""
        cls = {"grid": (ResourceGridContext, jru.ResourceGridContext),
               "prach": (PrachBufferContext, jru.PrachBufferContext)}[ctx]
        for ru, c, slot_cls, g in ((self.ru, cls[0], SlotPoint, None if grid is None else
                                    torch.from_numpy(grid)),
                                   (self.ru_j, cls[1], JSlot, grid)):
            scs = SCS if ru is self.ru else JSCS
            context = c(slot=slot_cls(scs, count), sector=sector, **kw)
            getattr(ru, method)(context, *((g,) if g is not None else ()))

    def tick(self, count: int, symbol: int = 0):
        self.ru.ota_tick(SlotPoint(SCS, count), symbol)
        self.ru_j.ota_tick(JSlot(JSCS, count), symbol)

    def same_wire(self):
        assert len(self.wire) == len(self.wire_j)
        for a, b in zip(self.wire, self.wire_j):
            np.testing.assert_array_equal(a, b)


def test_ofh_ru_slot_roundtrip(ref_native):
    """DL grid -> OFH frames (byte-identical to the reference's) ->
    loopback as UL -> the notified UL grid (a tensor on the RU's device,
    equal to the reference's)."""
    pair = OfhPair(ref_native, nof_prb=12, nof_ports=1, dl_pacing="sync")
    slot = SlotPoint.from_sfn_slot(SCS, 7, 3)
    grid = random_grid(1, (1, 14, 144), 0.1)
    pair.tick(slot.count)
    pair.call("handle_new_uplink_slot", slot.count)
    pair.call("handle_dl_data", slot.count, grid=grid)
    assert len(pair.wire) == 16  # 1 C-plane UL + 1 C-plane DL + 14 U-plane
    pair.same_wire()
    for ru, wire in ((pair.ru, pair.wire), (pair.ru_j, pair.wire_j)):
        for f in wire:
            if f[1] == 0x00:
                ru.push_uplane_frame(f)
    assert len(pair.col.symbols) == 14
    _, got, valid = pair.col.symbols[0]
    assert valid and isinstance(got, torch.Tensor) and got.device.type == "cpu"
    np.testing.assert_array_equal(to_np(got), np.asarray(pair.col_j.symbols[0][1]))
    assert np.allclose(to_np(got), grid, atol=2e-2)


def test_ofh_ru_drops_out_of_window_frames():
    col = Collector()
    frames = []
    ru = RuOfh(RuOfhConfig(scs=SCS, nof_prb=12, device="cpu"), col, send_frame=frames.append)
    slot = SlotPoint.from_sfn_slot(SCS, 0, 0)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.handle_dl_data(ResourceGridContext(slot=slot), torch.zeros((1, 14, 144), dtype=torch.complex64))
    ru.ota_tick(slot + 100)
    for f in frames:
        if f[1] == 0x00:
            ru.push_uplane_frame(f)
    assert not col.symbols
    assert ru.window.stats.late == 14
    assert ru.get_metrics().late_ul_frames == 14


def test_factory_dispatch():
    col = Collector()
    assert isinstance(create_ru("dummy", RuDummyConfig(), col), RuDummy)
    assert isinstance(create_ru("generic", RuGenericConfig(device="cpu"), col), RuGeneric)
    assert isinstance(create_ru("ofh", RuOfhConfig(device="cpu"), col), RuOfh)
    with pytest.raises(ValueError):
        create_ru("uhd", RuDummyConfig(), col)
    with pytest.raises(TypeError):
        create_ru("generic", RuDummyConfig(), col)
    with pytest.raises(TypeError):
        create_ru("ofh", [RuOfhConfig(), RuDummyConfig()], col)


def test_ofh_ru_static_compression_roundtrip(ref_native):
    """Static compression: U-plane sections carry no udCompHdr (2 bytes
    shorter), byte-identical to the reference's, and round-trip."""
    pair = OfhPair(ref_native, nof_prb=12, compression_mode="static", dl_pacing="sync")
    slot = SlotPoint.from_sfn_slot(SCS, 2, 2)
    grid = random_grid(3, (1, 14, 144), 0.1)
    pair.tick(slot.count)
    pair.call("handle_new_uplink_slot", slot.count)
    pair.call("handle_dl_data", slot.count, grid=grid)
    pair.same_wire()
    uplane = [f for f in pair.wire if f[1] == 0x00]
    dyn_len = len(native.ofh_uplane_build(np.zeros(12 * 24, np.int16), width=9))
    assert all(len(f) == dyn_len - 2 for f in uplane)
    for f in uplane:
        pair.ru.push_uplane_frame(f)
    assert len(pair.col.symbols) == 14
    assert np.allclose(to_np(pair.col.symbols[0][1]), grid, atol=2e-2)


def test_ofh_cplane_type0_idle_guard(ref_native):
    """C-plane section type 0 (idle/guard period) round-trips, byte-identical
    to the reference's (reference build_idle_guard_period_message)."""
    kw = dict(rtc_id=2, seq_id=77, frame_id=9, subframe_id=3, slot_id=1, start_symbol=10,
              time_offset=480, frame_structure=0x91, cp_length=352)
    sec = dict(section_id=5, start_prbc=0, num_prbc=106, re_mask=0xFFF, num_symbol=4)
    msg = native.ofh_cplane_build_type0(native.CplaneSection(**sec), **kw)
    np.testing.assert_array_equal(msg, ref_native.ofh_cplane_build_type0(
        ref_native.CplaneSection(**sec), **kw))
    hdr, got = native.ofh_cplane_parse_type0(msg)
    assert hdr == dict(kw, direction=1) == ref_native.ofh_cplane_parse_type0(msg)[0]
    assert got == native.CplaneSection(**sec)
    with pytest.raises(ValueError):
        native.ofh_cplane_parse(msg)


def test_ofh_ru_send_idle_guard(ref_native):
    pair = OfhPair(ref_native, nof_prb=24)
    pair.ru.send_idle_guard(SlotPoint.from_sfn_slot(SCS, 0, 1), start_symbol=12, nof_symbols=2)
    pair.ru_j.send_idle_guard(JSlot.from_sfn_slot(JSCS, 0, 1), start_symbol=12, nof_symbols=2)
    pair.same_wire()
    hdr, sec = native.ofh_cplane_parse_type0(pair.wire[0])
    assert hdr["start_symbol"] == 12 and sec.num_symbol == 2 and sec.num_prbc == 24


def test_ofh_cplane_ud_comp_hdr_static_vs_dynamic(ref_native):
    """The type-1 udCompHdr byte follows the reference's rules; the message
    carrying it is byte-identical to the reference's."""
    assert native.ud_comp_hdr(9, direction=0, mode="dynamic") == 0x91
    assert native.ud_comp_hdr(16, direction=0, mode="dynamic") == 0x01
    assert native.ud_comp_hdr(9, direction=1, mode="dynamic") == 0
    assert native.ud_comp_hdr(9, direction=0, mode="static") == 0
    for mode, direction in (("dynamic", 0), ("static", 0), ("dynamic", 1)):
        comp = native.ud_comp_hdr(9, direction, mode)
        msg = native.ofh_cplane_build_comp([native.CplaneSection(num_prbc=24, num_symbol=14)],
                                           direction=direction, comp_byte=comp)
        np.testing.assert_array_equal(msg, ref_native.ofh_cplane_build_comp(
            [ref_native.CplaneSection(num_prbc=24, num_symbol=14)], direction=direction,
            comp_byte=comp))
        assert native.ofh_cplane_comp_hdr(msg) == comp
        hdr, secs = native.ofh_cplane_parse(msg)
        assert hdr["section_type"] == 1 and secs[0].num_prbc == 24


def test_ofh_ru_prach_ingress_completes_occasion():
    """PRACH-eAxC U-plane frames fill the pending occasion buffer and
    notify on_new_prach_window_data with a tensor on the RU's device."""
    col = Collector()
    cfg = RuOfhConfig(scs=SCS, nof_prb=12, nof_ports=1, dl_pacing="sync", device="cpu")
    frames = []
    ru = RuOfh(cfg, col, send_frame=frames.append)
    slot = SlotPoint.from_sfn_slot(SCS, 3, 1)
    ru.ota_tick(slot)
    ctx = PrachBufferContext(slot=slot, start_symbol=0, format="B4")
    ru.handle_prach_occasion(ctx)
    assert len(frames) == 1
    hdr, secs = native.ofh_cplane_parse(frames[0])
    assert hdr["section_type"] == 3 and secs[0].num_prbc == 12 and secs[0].num_symbol == 12
    # The symbol counts come from the port's one preamble table, the
    # reference RU's from phy/prach's copy of it.
    assert tprach.PRACH_PREAMBLES == jprach._PREAMBLE_INFO
    pre = np.exp(2j * np.pi * np.random.default_rng(9).random(139)).astype(np.complex64) * 0.4
    frame_id, subframe_id, slot_id = ru._timestamp(slot)
    padded = np.zeros(144, np.complex64)
    padded[:139] = pre
    for sym in range(12):
        iq = np.empty(144 * 2, np.int16)
        scaled = padded * cfg.iq_scale
        iq[0::2] = np.round(scaled.real).astype(np.int16)
        iq[1::2] = np.round(scaled.imag).astype(np.int16)
        ru.push_uplane_frame(native.ofh_uplane_build(
            iq, pc_id=cfg.prach_eaxc, seq_id=sym, direction=0, frame_id=frame_id,
            subframe_id=subframe_id, slot_id=slot_id, symbol_id=sym, start_prb=0, width=14))
    assert len(col.prach) == 1
    got_ctx, buffer = col.prach[0]
    assert got_ctx is ctx and isinstance(buffer, torch.Tensor)
    assert buffer.shape == (1, 12, 139)
    assert np.allclose(to_np(buffer[0, 3]), pre, atol=2e-2)
    assert not ru._prach_pending


def test_ofh_ru_evicts_stale_pending_contexts():
    col, err = Collector(), Errors()
    ru = RuOfh(RuOfhConfig(scs=SCS, nof_prb=12, device="cpu"), col, send_frame=lambda f: None,
               error_notifier=err)
    slot = SlotPoint.from_sfn_slot(SCS, 1, 0)
    ru.ota_tick(slot)
    air = slot + 1
    ru.handle_new_uplink_slot(ResourceGridContext(slot=air))
    ru.handle_prach_occasion(PrachBufferContext(slot=air, format="B4"))
    assert ru._ul_pending and ru._prach_pending
    ru.ota_tick(air + 3)
    assert not ru._ul_pending and not ru._ul_filled and not ru._prach_pending
    m = ru.get_metrics()
    assert m.late_ul_requests == 1 and m.late_prach_requests == 1
    assert err.ul == [air] and err.prach == [air]


def test_ofh_ru_late_cplane_counted_on_its_own_plane():
    col, err = Collector(), Errors()
    ru = RuOfh(RuOfhConfig(scs=SCS, nof_prb=12, device="cpu"), col, send_frame=lambda f: None,
               error_notifier=err)
    slot = SlotPoint.from_sfn_slot(SCS, 2, 0)
    ru.ota_tick(slot)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.handle_prach_occasion(PrachBufferContext(slot=slot, format="B4"))
    m = ru.get_metrics()
    assert m.late_ul_requests == 1 and m.late_prach_requests == 1
    assert m.late_dl_requests == 0
    assert not ru._ul_pending and not ru._prach_pending
    assert err.ul == [slot] and err.prach == [slot]
    ru.ota_tick(slot + 3)
    m2 = ru.get_metrics()
    assert m2.late_ul_requests == 1 and m2.late_prach_requests == 1


def test_ofh_ru_paced_dl_transmitter(ref_native):
    """Paced DL: U-plane frames leave only when the OTA clock enters each
    symbol's T1a window, in symbol order, the same frames at the same
    ticks as the reference's; frames whose window closed un-sent are
    dropped and counted."""
    pair = OfhPair(ref_native, nof_prb=12, dl_pacing="paced", tx_window_t1a_max_symbols=6,
                   tx_window_t1a_min_symbols=2)
    slot = SlotPoint.from_sfn_slot(SCS, 1, 4)
    prev = SlotPoint.from_sfn_slot(SCS, 1, 3)
    pair.tick(prev.count)
    pair.call("handle_dl_data", slot.count, grid=np.full((1, 14, 144), 0.1 + 0.05j, np.complex64))
    assert len(pair.wire) == 1 and pair.wire[0][1] != 0x00
    sent_per_tick = []
    for count in (prev.count, slot.count):
        for s in range(14):
            pair.tick(count, s)
            sent_per_tick.append(len(pair.wire))
            pair.same_wire()
    uplane = [f for f in pair.wire if f[1] == 0x00]
    assert 0 < sent_per_tick[13] - 1 < 14  # part of the slot went out during prev
    syms = [native.ofh_uplane_parse(f)[0]["symbol_id"] for f in uplane]
    assert syms == sorted(syms)
    assert 0 < len(uplane) <= 14
    assert pair.ru.get_metrics().late_dl_requests == 14 - len(uplane)
    assert vars(pair.ru.get_metrics()) == vars(pair.ru_j.get_metrics())


def test_ofh_ru_paced_dl_whole_slot_late():
    col, err = Collector(), Errors()
    sent = []
    ru = RuOfh(RuOfhConfig(scs=SCS, nof_prb=12, dl_pacing="paced", device="cpu"), col,
               send_frame=sent.append, error_notifier=err)
    slot = SlotPoint.from_sfn_slot(SCS, 0, 1)
    ru.ota_tick(slot + 3)
    ru.handle_dl_data(ResourceGridContext(slot=slot), torch.zeros((1, 14, 144), dtype=torch.complex64))
    assert not sent
    assert ru.get_metrics().late_dl_requests == 1
    assert err.dl == [slot]


def test_ofh_ru_paced_emulator_roundtrip_decodes():
    """Full paced round trip: the DU-side RuOfh streams a slot toward an RU
    emulator (loopback), the frames come back as UL within the reception
    window, and the reassembled grid matches the transmitted one."""
    col = Collector()
    cfg = RuOfhConfig(scs=SCS, nof_prb=12, dl_pacing="paced", tx_window_t1a_max_symbols=28,
                      tx_window_t1a_min_symbols=0, device="cpu")
    wire = []
    ru = RuOfh(cfg, col, send_frame=wire.append)
    slot = SlotPoint.from_sfn_slot(SCS, 5, 6)
    prev = slot + (-1)
    grid = random_grid(4, (1, 14, 144), 0.1)
    ru.ota_tick(prev, symbol=0)
    ru.handle_new_uplink_slot(ResourceGridContext(slot=slot))
    ru.handle_dl_data(ResourceGridContext(slot=slot), torch.from_numpy(grid))
    for s_slot in (prev, slot):
        for s in range(14):
            ru.ota_tick(s_slot, symbol=s)
            while wire:
                f = wire.pop(0)
                if f[1] == 0x00:
                    ru.push_uplane_frame(f)
    assert len(col.symbols) == 14
    assert np.allclose(to_np(col.symbols[0][1]), grid, atol=2e-2)
    assert ru.get_metrics().late_dl_requests == 0


def test_ofh_paced_soak_sustained_slot_rate(ref_native):
    """Soak with pacing on (the default profile): 100 slots of DL data + UL
    requests one slot ahead of air time, the OTA clock ticking every
    symbol, every U-plane frame looped back as the RU's uplink on the UL
    eAxC map.  Every frame the port emits is byte-identical to the
    reference's at the same tick; zero late frames, zero evictions, every
    slot's UL grid complete and equal to the reference's."""
    pair = OfhPair(ref_native, nof_prb=12, nof_ports=2, dl_eaxc=(0, 1), ul_eaxc=(4, 5),
                   prach_eaxc=8)
    assert pair.ru.cfg.dl_pacing == "paced"
    n_slots = 100
    base = SlotPoint.from_sfn_slot(SCS, 1, 0).count
    grids = {}
    pair.tick(base)
    n_cplane = 0
    for s in range(n_slots + 1):
        if s < n_slots:
            air = base + s + 1
            grids[air] = random_grid(1000 + s, (2, 14, 144), 0.1)
            pair.call("handle_new_uplink_slot", air)
            pair.call("handle_dl_data", air, grid=grids[air])
        for sym in range(14):
            pair.tick(base + s, sym)
            pair.same_wire()
            for ru, wire in ((pair.ru, pair.wire), (pair.ru_j, pair.wire_j)):
                for f in wire:
                    if f[1] == 0x00:  # U-plane: retag DL eAxC -> UL, loop back
                        f = np.array(f)
                        if f[5] in (0, 1):
                            f[5] = (4, 5)[f[5]]
                        ru.push_uplane_frame(f)
                    elif ru is pair.ru:
                        n_cplane += 1
                wire.clear()
    m = pair.ru.get_metrics()
    assert vars(m) == vars(pair.ru_j.get_metrics())
    assert m.late_dl_requests == 0 and m.late_ul_requests == 0 and m.late_ul_frames == 0
    assert m.total_dl_requests == n_slots
    assert len(pair.col.symbols) == len(pair.col_j.symbols) == 14 * n_slots
    assert n_cplane == n_slots * 4
    for (ctx, got, valid), (_, want, _) in zip(pair.col.symbols[::14], pair.col_j.symbols[::14]):
        assert valid
        np.testing.assert_array_equal(to_np(got), np.asarray(want))
        assert np.allclose(to_np(got), grids[ctx.slot.count], atol=2e-2)


def test_ofh_multi_sector_routes_and_aggregates():
    col = Collector()
    cfgs = [RuOfhConfig(scs=SCS, nof_prb=12, nof_ports=1, dl_pacing="sync", dl_eaxc=(s * 2,),
                        ul_eaxc=(s * 2,), device="cpu") for s in range(2)]
    wires = [[], []]
    ru = create_ru("ofh", cfgs, col, send_frames=[wires[0].append, wires[1].append])
    assert isinstance(ru, RuOfhMultiSector)
    slot = SlotPoint.from_sfn_slot(SCS, 4, 2)
    ru.ota_tick(slot)
    grids = [random_grid(20 + s, (1, 14, 144), 0.1) for s in range(2)]
    for s in range(2):
        ru.handle_new_uplink_slot(ResourceGridContext(slot=slot, sector=s))
        ru.handle_dl_data(ResourceGridContext(slot=slot, sector=s), torch.from_numpy(grids[s]))
    assert len(wires[0]) == 16 and len(wires[1]) == 16
    assert all(f[5] == 2 for f in wires[1] if f[1] == 0x00)
    for s in range(2):
        for f in wires[s]:
            if f[1] == 0x00:
                ru.push_uplane_frame(s, f)
    assert len(col.symbols) == 28
    m = ru.get_metrics()
    assert m.total_dl_requests == 2 and m.total_ul_requests == 2
    assert np.allclose(to_np(col.symbols[14][1]), grids[1], atol=2e-2)
    with pytest.raises(ValueError, match="ul_eaxc"):
        RuOfh(RuOfhConfig(ul_eaxc=(8,), device="cpu"), col)


def test_ofh_ru_wide_carrier_sections_roundtrip(ref_native):
    """273 PRB frame as two sections a symbol (255 + 18 PRB), byte-identical
    to the reference's, and reassemble."""
    pair = OfhPair(ref_native, nof_prb=273, nof_ports=1, dl_pacing="sync")
    slot = SlotPoint.from_sfn_slot(SCS, 5, 1)
    grid = random_grid(6, (1, 14, 273 * 12), 0.1)
    pair.tick(slot.count)
    pair.call("handle_new_uplink_slot", slot.count)
    pair.call("handle_dl_data", slot.count, grid=grid)
    pair.same_wire()
    uplane = [f for f in pair.wire if f[1] == 0x00]
    assert len(uplane) == 14 * 2
    for f in uplane:
        pair.ru.push_uplane_frame(f)
    assert len(pair.col.symbols) == 14
    assert np.allclose(to_np(pair.col.symbols[0][1]), grid, atol=2e-2)


# ---- the RU emulator over UDP (tests/test_ru_emulator.py) ----------------------

def test_ru_emulator_slot_over_udp():
    """The RU side sends one slot of samples as Q15 IQ frames over the
    native UDP transport; the DU side reassembles, demodulates and decodes
    the PUSCH."""
    alloc = Allocation(rb_start=0, rb_count=24, sym_start=1, sym_count=12, dmrs_symbols=(2,))
    common = dict(tbs=1000, target_code_rate=0.3, modulation=Modulation.QPSK, alloc=alloc,
                  nof_layers=1, nof_grid_symbols=14, nof_grid_sc=288)
    txc = pdsch.PdschConfig(nof_ports=1, **common)
    rxc = pusch.PuschConfig(nof_rx_ports=1, **common)
    tb = np.random.default_rng(0).integers(0, 2, size=(1000,), dtype=np.uint8)
    grid = pdsch.process(torch.from_numpy(tb), 0x900D, torch.eye(1, dtype=torch.complex64), txc)
    iq = ofdm.modulate_slot(grid, SCS, 512, CyclicPrefix.NORMAL, 0)[0]
    scale = 0.5 / float(iq.abs().max())
    rx = native.IqSocket.rx(47655)
    tx = native.IqSocket.tx(47655)
    try:
        tx.send(slot=3, symbol=0, port_id=0, iq=iq * scale)
        chunks = []
        while sum(c.size for c in chunks) < iq.numel():
            r = rx.recv(max_samples=8192, timeout_ms=1000)
            assert r is not None, "transport timeout"
            slot_id, _sym, port, data = r
            assert (slot_id, port) == (3, 0)
            chunks.append(data)
    finally:
        tx.close()
        rx.close()
    samples = torch.from_numpy(np.concatenate(chunks)[: iq.numel()] / scale)
    back = ofdm.demodulate_slot(samples[None].to(torch.complex64), 24, SCS, 512,
                                CyclicPrefix.NORMAL, 0)
    out = pusch.process(back[None], torch.tensor([0x900D]), rxc)
    assert bool(out["tb_crc_ok"][0])
    np.testing.assert_array_equal(to_np(out["tb_bits"][0]), tb)


# ---- the baseband loop (tests/test_lower_loop.py) -------------------------------

class LockstepGateway(lower_loop.LoopbackGateway):
    """A sample-clock gateway on a fake clock: each receive first waits
    (real time, bounded) until the TX has sent every buffer the pacing
    allows after the buffers received so far, then advances the clock by
    one buffer.  The run then goes the same way under any load."""

    def __init__(self, cfg, nof_buffers, clock):
        super().__init__(cfg, nof_buffers, realtime=False)
        self.clock = clock

    def receive(self):
        # TX starts rx_to_tx_max_delay ahead and may not pass the last
        # received timestamp by more: after k buffers it has sent max(k, 1).
        want = max(self._rx_count, 1)
        deadline = time.monotonic() + 10.0
        while len(self.tx_log) < want:
            assert time.monotonic() < deadline, "the TX thread stalled"
            time.sleep(1e-4)
        self.clock.t += self.cfg.buffer_size / self.cfg.srate_hz
        return super().receive()


def test_loop_paces_tx_to_rx_timestamps(monkeypatch):
    clock = FakeClock(advance=False, yield_s=1e-4)
    monkeypatch.setattr(lower_loop, "time", clock)
    cfg = lower_loop.BasebandLoopConfig(srate_hz=1_920_000.0, buffer_size=1920,
                                        rx_to_tx_max_delay=4 * 1920, tx_time_offset=16)
    gw = LockstepGateway(cfg, nof_buffers=50, clock=clock)
    ul_ts, dl_calls = [], []
    loop = lower_loop.BasebandLoop(cfg, gw, gw, ul_processor=lambda s, ts: ul_ts.append(ts),
                                   dl_producer=lambda ts, n: dl_calls.append((ts, n)) or b"")
    loop.start()
    deadline = time.monotonic() + 30
    while not loop._stop.is_set() and time.monotonic() < deadline:
        time.sleep(0.01)
    loop.stop()
    assert not loop._rx_thread.is_alive() and not loop._tx_thread.is_alive()
    assert loop.stats["rx_buffers"] == 50
    assert ul_ts == [i * 1920 for i in range(50)]
    tx_ts = [t for t, _ in gw.tx_log]
    assert tx_ts[0] == 4 * 1920 + 16
    assert all(t % 1920 == 16 for t in tx_ts)
    assert all(b - a == 1920 for a, b in zip(tx_ts, tx_ts[1:]))
    assert [ts for ts, _ in dl_calls] == [t - 16 for t in tx_ts]
    # The pacing holds exactly on the fake clock (its 2-slot timeout never
    # expires): the TX never leads the last received timestamp by more.
    assert loop.stats["max_tx_lead"] <= cfg.rx_to_tx_max_delay
    assert loop.stats["tx_buffers"] >= 50
    assert loop.stats["tx_waits"] >= 40


def test_loop_stop_is_clean_mid_stream(monkeypatch):
    monkeypatch.setattr(lower_loop, "time", FakeClock(yield_s=1e-4))
    cfg = lower_loop.BasebandLoopConfig(srate_hz=1e6, buffer_size=1000, rx_to_tx_max_delay=2000)
    gw = lower_loop.LoopbackGateway(cfg, nof_buffers=10_000, realtime=True)
    loop = lower_loop.BasebandLoop(cfg, gw, gw, ul_processor=lambda s, ts: None,
                                   dl_producer=lambda ts, n: b"")
    loop.start()
    deadline = time.monotonic() + 10
    while loop.stats["rx_buffers"] < 10 and time.monotonic() < deadline:
        time.sleep(0.001)
    loop.stop()
    assert not loop._rx_thread.is_alive() and not loop._tx_thread.is_alive()
    assert 10 <= loop.stats["rx_buffers"] < 10_000
