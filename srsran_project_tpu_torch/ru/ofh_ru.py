"""Open Fronthaul Radio Unit: RU interface over the OFH message path.

Port of ``srsran_project_tpu/ru/ofh_ru.py``, the counterpart of lib/ru/ofh
(ru_ofh_impl: per-sector OFH transmitter/receiver + realtime timing
worker behind the common RU interface).  The native eCPRI/U-plane/C-plane
serdes (``native/ofh_serdes.cpp``, bound by ``support.native``) and the
receiver-side window/seq-id checkers (``ofh/receiver.py``) carry the data;
this class performs the RU-side choreography:

- ``handle_dl_data`` — per-symbol BFP compression + U-plane framing of the
  requested slot grid, plus a C-plane type-1 message announcing the
  allocation (the transmit path of ofh_transmitter: data_flow_uplane /
  data_flow_cplane_scheduling_commands).  A grid tensor is copied to the
  host once a slot; the framing is host work.
- ``handle_new_uplink_slot`` / ``handle_prach_occasion`` — emit C-plane
  type-1 / type-3 requests toward the RU and register the slot so arriving
  U-plane frames are reassembled and notified upward (ofh_receiver +
  uplane_rx_symbol_data_flow).
- ``push_uplane_frame`` — ingress for RU->DU frames: rx-window + seq-id
  checked, decompressed, written into the slot grid on the host; a
  completed slot's grid (or PRACH buffer) moves to ``RuOfhConfig.device``
  once and is notified symbol by symbol.

The frames are byte-identical to the reference's for the same grid.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..ofh.receiver import RxWindowChecker, SeqIdChecker
from ..phy.prach import _LONG_FORMATS, PRACH_PREAMBLES
from ..ran.constants import SubcarrierSpacing, nof_slots_per_subframe
from ..ran.slot_point import SlotPoint
from ..support import native
from .interface import (
    PrachBufferContext,
    ResourceGridContext,
    RuErrorNotifier,
    RuMetrics,
    RxSymbolContext,
    RxSymbolNotifier,
)

SYMBOLS_PER_SLOT = 14


@dataclasses.dataclass
class RuOfhConfig:
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    nof_prb: int = 24
    nof_ports: int = 1
    compression_width: int = 9   # BFP bit width
    # "dynamic": every U-plane section carries udCompHdr; "static": the
    # width is fixed M-plane-style and omitted from the wire (reference
    # ofh_uplane_message_builder_{dynamic,static}_compression_impl).
    compression_mode: str = "dynamic"
    iq_scale: float = 16384.0    # float → Q-format scaling before BFP
    # Reception window in symbols relative to OTA time (Ta4 window).
    rx_window_early_symbols: int = 28
    rx_window_late_symbols: int = 2
    # eAxC base for PRACH U-plane streams (the reference configures
    # separate prach_eaxc vs ul_eaxc port lists; ru_ofh_configuration).
    prach_eaxc: int = 8
    # Transmit pacing (reference T1a windows, in symbols ahead of OTA):
    # a message goes on the wire when the OTA clock is within
    # [t - t1a_max, t - t1a_min] of its air time t.  "paced" (the default
    # OFH profile, like the reference transmitter pipeline) queues frames
    # and the OTA tick dispatches them inside their windows — U-plane DL
    # data, the DL C-plane, and the UL-grant / PRACH C-plane each with
    # their own window (ofh_data_flow_uplane_downlink_data +
    # ofh_data_flow_cplane_scheduling_commands + the OTA symbol
    # dispatcher).  Before the first OTA tick (no timing loop attached)
    # messages are sent immediately.  "sync" frames everything inside the
    # request handler (legacy/test mode).
    dl_pacing: str = "paced"   # "paced" | "sync"
    tx_window_t1a_max_symbols: int = 14  # U-plane DL earliest: 1 slot ahead
    tx_window_t1a_min_symbols: int = 2   # U-plane DL latest: 2 symbols ahead
    # C-plane windows lead the U-plane (reference T1a_max_cp_dl/ul).
    tx_window_t1a_max_cp_dl_symbols: int = 20
    tx_window_t1a_min_cp_dl_symbols: int = 4
    tx_window_t1a_max_cp_ul_symbols: int = 20
    tx_window_t1a_min_cp_ul_symbols: int = 4
    # eAxC port maps (reference ru_ofh_configuration dl_eaxc/ul_eaxc):
    # entry i is the eAxC carrying antenna port i.  None = 0..nof_ports-1.
    dl_eaxc: tuple | None = None
    ul_eaxc: tuple | None = None
    # Where a completed UL grid or PRACH buffer is moved to.
    device: str = "cuda"


class RuOfh:
    """radio_unit implementation speaking OFH messages.

    ``send_frame(bytes_array)`` transmits one Ethernet-payload message
    toward the RU (tests loop it back; apps attach the VLAN framer + a
    socket).
    """

    def __init__(self, cfg: RuOfhConfig, symbol_notifier: RxSymbolNotifier,
                 send_frame: Optional[Callable[[np.ndarray], None]] = None,
                 timing_notifier=None,
                 error_notifier: Optional[RuErrorNotifier] = None):
        native.get_lib()  # raises if the serdes library cannot be built or loaded
        self.cfg = cfg
        self.symbol_notifier = symbol_notifier
        self.send_frame = send_frame or (lambda frame: None)
        self.timing_notifier = timing_notifier
        self.error_notifier = error_notifier
        self.window = RxWindowChecker(
            window_early_symbols=cfg.rx_window_early_symbols,
            window_late_symbols=cfg.rx_window_late_symbols,
            slots_per_subframe=nof_slots_per_subframe(cfg.scs))
        self.seqid = SeqIdChecker()
        self._tx_seq: Dict[int, int] = {}
        self._ul_pending: Dict[SlotPoint, np.ndarray] = {}
        self._ul_filled: Dict[SlotPoint, np.ndarray] = {}
        self._prach_pending: Dict[SlotPoint, PrachBufferContext] = {}
        # Paced-TX state: (air-time symbol, t1a_min, t1a_max, frame)
        # entries awaiting their window, and the latest OTA time seen
        # (absolute symbols); None until the first tick.
        self._tx_queue: List[tuple[int, int, int, np.ndarray]] = []
        self._ota_symbols: Optional[int] = None
        self._dl_eaxc = tuple(cfg.dl_eaxc) if cfg.dl_eaxc is not None \
            else tuple(range(cfg.nof_ports))
        self._ul_eaxc = tuple(cfg.ul_eaxc) if cfg.ul_eaxc is not None \
            else tuple(range(cfg.nof_ports))
        # Misconfigured maps fail loudly here rather than as silent frame
        # loss: ingress routes pc_id >= prach_eaxc to the PRACH path
        # before the UL map lookup, and short maps IndexError per port.
        if len(self._dl_eaxc) < cfg.nof_ports or len(self._ul_eaxc) < cfg.nof_ports:
            raise ValueError("dl_eaxc/ul_eaxc must cover nof_ports")
        if any(e >= cfg.prach_eaxc for e in self._ul_eaxc):
            raise ValueError(
                f"ul_eaxc {self._ul_eaxc} collides with the PRACH eAxC "
                f"range (>= {cfg.prach_eaxc}); raise prach_eaxc or renumber")
        self._lock = threading.Lock()
        self.metrics = RuMetrics()
        self._running = False

    # -- controller --------------------------------------------------------
    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def get_controller(self):
        return self

    def get_downlink_plane_handler(self):
        return self

    def get_uplink_plane_handler(self):
        return self

    def get_metrics(self) -> RuMetrics:
        m = dataclasses.replace(self.metrics)
        # Frame lateness is reported on its own counter: late frames leave
        # their slot unfilled, so the eviction path already counts that
        # slot once in late_ul_requests.
        m.late_ul_frames += self.window.stats.late
        return m

    # -- helpers -----------------------------------------------------------
    def _timestamp(self, slot: SlotPoint) -> tuple[int, int, int]:
        spsf = nof_slots_per_subframe(self.cfg.scs)
        frame = slot.sfn % 256
        subframe = slot.subframe
        slot_id = slot.count % spsf
        return frame, subframe, slot_id

    def _next_seq(self, eaxc: int) -> int:
        s = self._tx_seq.get(eaxc, 0)
        self._tx_seq[eaxc] = (s + 1) & 0xFFFF
        return s

    def _grid_to_q(self, symbol_res: np.ndarray) -> np.ndarray:
        iq = np.empty(symbol_res.size * 2, np.int16)
        scaled = np.clip(symbol_res * self.cfg.iq_scale, -32768, 32767)
        iq[0::2] = np.round(scaled.real).astype(np.int16)
        iq[1::2] = np.round(scaled.imag).astype(np.int16)
        return iq

    # -- DL plane ----------------------------------------------------------
    def handle_dl_data(self, context: ResourceGridContext, grid) -> None:
        """Frame one slot grid (ports × symbols × subcarriers) as C-plane
        type-1 + per-symbol U-plane messages.

        In "sync" pacing the frames go on the wire immediately; in
        "paced" pacing each symbol's frames are queued and dispatched by
        the OTA clock when it enters that symbol's T1a transmit window
        (the reference's data_flow_uplane_downlink_data + OTA symbol
        dispatcher pipeline).  DL data arriving after its window closed
        is dropped and counted late.  A tensor grid is copied to the host
        once here."""
        grid = grid.cpu().numpy() if isinstance(grid, torch.Tensor) else np.asarray(grid)
        if grid.ndim == 2:
            grid = grid[None]
        frame, subframe, slot_id = self._timestamp(context.slot)
        c = self.cfg
        slot_syms = self._slot_symbols(context.slot)
        with self._lock:
            self.metrics.total_dl_requests += 1
            now = self._ota_symbols
        # Paced only once an OTA clock exists; before the first tick every
        # message goes straight out (no timing loop attached).
        paced = c.dl_pacing == "paced" and now is not None
        if paced and slot_syms - c.tx_window_t1a_min_cp_dl_symbols < now:
            # The slot's DL C-PLANE window has closed: a conformant RU
            # discards U-plane sections with no preceding C-plane, so the
            # whole request is late (a gate on the U-plane window alone
            # could transmit a slot whose C-plane had been dropped).
            with self._lock:
                self.metrics.late_dl_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_downlink_message(context.slot, 0)
            return
        for port in range(min(c.nof_ports, grid.shape[0])):
            eaxc = self._dl_eaxc[port]
            cpl = native.ofh_cplane_build(
                [native.CplaneSection(section_id=0, start_prbc=0,
                                      num_prbc=c.nof_prb,
                                      num_symbol=SYMBOLS_PER_SLOT)],
                rtc_id=eaxc, seq_id=self._next_seq(0x100 + eaxc), direction=1,
                frame_id=frame, subframe_id=subframe, slot_id=slot_id,
                start_symbol=0, section_type=1)
            if paced:
                # The DL C-plane paces in its own (earlier) T1a window.
                self._enqueue_tx(slot_syms, c.tx_window_t1a_min_cp_dl_symbols,
                                 c.tx_window_t1a_max_cp_dl_symbols, cpl,
                                 plane="dl", slot=context.slot)
            else:
                self.send_frame(cpl)
            build = (native.ofh_uplane_build_static
                     if c.compression_mode == "static"
                     else native.ofh_uplane_build)
            for sym in range(min(SYMBOLS_PER_SLOT, grid.shape[1])):
                # The eCPRI section numPrbu field is 8+2 bits but the
                # native builder (and O-RAN practice) caps one section at
                # 255 PRBs: wide carriers (273 PRB @ 100 MHz) split into
                # multiple sections per symbol at startPrbu offsets.
                for prb0 in range(0, c.nof_prb, 255):
                    nprb = min(255, c.nof_prb - prb0)
                    res = grid[port, sym, prb0 * 12 : (prb0 + nprb) * 12]
                    msg = build(
                        self._grid_to_q(res), pc_id=eaxc,
                        seq_id=self._next_seq(eaxc), direction=1,
                        frame_id=frame, subframe_id=subframe, slot_id=slot_id,
                        symbol_id=sym, start_prb=prb0,
                        width=c.compression_width)
                    if paced:
                        self._enqueue_tx(slot_syms + sym,
                                         c.tx_window_t1a_min_symbols,
                                         c.tx_window_t1a_max_symbols, msg,
                                         plane="dl", slot=context.slot)
                    else:
                        self.send_frame(msg)
        if paced:
            self._dispatch_tx()

    # -- UL plane ----------------------------------------------------------
    def handle_new_uplink_slot(self, context: ResourceGridContext) -> None:
        frame, subframe, slot_id = self._timestamp(context.slot)
        slot_syms = self._slot_symbols(context.slot)
        with self._lock:
            self.metrics.total_ul_requests += 1
            now = self._ota_symbols
            self._ul_pending[context.slot] = np.zeros(
                (self.cfg.nof_ports, SYMBOLS_PER_SLOT, self.cfg.nof_prb * 12),
                np.complex64)
            # Subcarriers received per (port, symbol): a symbol may
            # arrive as several <=255-PRB sections.
            self._ul_filled[context.slot] = np.zeros(
                (self.cfg.nof_ports, SYMBOLS_PER_SLOT), np.int32)
        paced = self.cfg.dl_pacing == "paced" and now is not None
        for port in range(self.cfg.nof_ports):
            eaxc = self._ul_eaxc[port]
            cpl = native.ofh_cplane_build(
                [native.CplaneSection(section_id=0, start_prbc=0,
                                      num_prbc=self.cfg.nof_prb,
                                      num_symbol=SYMBOLS_PER_SLOT)],
                rtc_id=eaxc, seq_id=self._next_seq(0x200 + eaxc), direction=0,
                frame_id=frame, subframe_id=subframe, slot_id=slot_id,
                start_symbol=0, section_type=1)
            if paced:
                # UL-grant C-plane rides the same window machinery as the
                # DL C-plane (reference
                # ofh_data_flow_cplane_scheduling_commands).
                self._enqueue_tx(slot_syms,
                                 self.cfg.tx_window_t1a_min_cp_ul_symbols,
                                 self.cfg.tx_window_t1a_max_cp_ul_symbols, cpl,
                                 plane="ul", slot=context.slot)
            else:
                self.send_frame(cpl)
        if paced:
            self._dispatch_tx()

    def handle_prach_occasion(self, context: PrachBufferContext) -> None:

        frame, subframe, slot_id = self._timestamp(context.slot)
        l_ra = 839 if context.format in _LONG_FORMATS else 139
        nof_symbols = PRACH_PREAMBLES[context.format][1]
        with self._lock:
            self.metrics.total_prach_requests += 1
            self._prach_pending[context.slot] = (
                context,
                np.zeros((self.cfg.nof_ports, nof_symbols, l_ra), np.complex64),
                np.zeros((self.cfg.nof_ports, nof_symbols), bool))
        # Type 3: mixed-numerology / PRACH scheduling (ofh_cuplane_constants).
        cpl = native.ofh_cplane_build(
            [native.CplaneSection(section_id=0, start_prbc=context.rb_offset,
                                  num_prbc=(l_ra + 11) // 12,
                                  num_symbol=nof_symbols, freq_offset=0)],
            rtc_id=self.cfg.prach_eaxc, seq_id=self._next_seq(0x300),
            direction=0, frame_id=frame, subframe_id=subframe,
            slot_id=slot_id, start_symbol=context.start_symbol,
            section_type=3)
        with self._lock:
            now = self._ota_symbols
        if self.cfg.dl_pacing == "paced" and now is not None:
            self._enqueue_tx(
                self._slot_symbols(context.slot) + context.start_symbol,
                self.cfg.tx_window_t1a_min_cp_ul_symbols,
                self.cfg.tx_window_t1a_max_cp_ul_symbols, cpl,
                plane="prach", slot=context.slot)
            self._dispatch_tx()
        else:
            self.send_frame(cpl)

    # -- RU→DU ingress ------------------------------------------------------
    def send_idle_guard(self, slot: SlotPoint, start_symbol: int = 0,
                        nof_symbols: int = SYMBOLS_PER_SLOT,
                        time_offset: int = 0) -> None:
        """Emit a C-plane type-0 idle/guard-period indication for the TDD
        guard (reference build_idle_guard_period_message)."""
        frame, subframe, slot_id = self._timestamp(slot)
        msg = native.ofh_cplane_build_type0(
            native.CplaneSection(section_id=0, start_prbc=0,
                                 num_prbc=self.cfg.nof_prb, re_mask=0xFFF,
                                 num_symbol=nof_symbols),
            rtc_id=0, seq_id=self._next_seq(0x400), direction=1,
            frame_id=frame, subframe_id=subframe, slot_id=slot_id,
            start_symbol=start_symbol, time_offset=time_offset)
        self.send_frame(msg)

    def push_uplane_frame(self, data: np.ndarray) -> None:
        """One received U-plane message: check windows, decompress into the
        pending slot grid, notify when the slot completes."""
        if self.cfg.compression_mode == "static":
            hdr, iq = native.ofh_uplane_parse_static(
                np.asarray(data, np.uint8), self.cfg.compression_width)
        else:
            hdr, iq = native.ofh_uplane_parse(np.asarray(data, np.uint8))
        if not self.window.check(hdr["frame_id"], hdr["subframe_id"],
                                 hdr["slot_id"], hdr["symbol_id"]):
            return
        if not self.seqid.check(hdr["pc_id"], hdr["seq_id"]):
            return
        if hdr["pc_id"] >= self.cfg.prach_eaxc:
            self._push_prach_frame(hdr, iq)
            return
        complete = None
        with self._lock:
            target = None
            for slot in self._ul_pending:
                f, sf, sl = self._timestamp(slot)
                if (f, sf, sl) == (hdr["frame_id"], hdr["subframe_id"], hdr["slot_id"]):
                    target = slot
                    break
            if target is None:
                return
            # eAxC -> antenna port via the UL port map.
            if hdr["pc_id"] not in self._ul_eaxc:
                return
            port = self._ul_eaxc.index(hdr["pc_id"])
            sym = hdr["symbol_id"]
            res = (iq[0::2].astype(np.float32) + 1j * iq[1::2].astype(np.float32))
            res = res.astype(np.complex64) / self.cfg.iq_scale
            sc0 = hdr["start_prb"] * 12
            grid = self._ul_pending[target]
            grid[port, sym, sc0 : sc0 + res.size] = res
            self._ul_filled[target][port, sym] += res.size
            if (self._ul_filled[target] >= self.cfg.nof_prb * 12).all():
                complete = target
                grid = self._ul_pending.pop(target)
                del self._ul_filled[target]
        if complete is not None:
            grid = torch.from_numpy(grid).to(self.cfg.device)
            for i_symbol in range(SYMBOLS_PER_SLOT):
                ctx = RxSymbolContext(slot=complete, symbol_id=i_symbol)
                self.symbol_notifier.on_new_uplink_symbol(ctx, grid, True)

    def _push_prach_frame(self, hdr: dict, iq: np.ndarray) -> None:
        """PRACH-eAxC U-plane ingress: fill the pending occasion buffer and
        notify on_new_prach_window_data when every (port, symbol) arrived
        (reference prach_uplane_rx_symbol data flow)."""
        complete = None
        with self._lock:
            target = None
            for slot, (ctx, _, _) in self._prach_pending.items():
                f, sf, sl = self._timestamp(slot)
                if (f, sf, sl) == (hdr["frame_id"], hdr["subframe_id"],
                                   hdr["slot_id"]):
                    target = slot
                    break
            if target is None:
                return
            ctx, buffer, filled = self._prach_pending[target]
            port = hdr["pc_id"] - self.cfg.prach_eaxc
            sym = hdr["symbol_id"] - ctx.start_symbol
            if not (0 <= port < buffer.shape[0] and 0 <= sym < buffer.shape[1]):
                return
            res = (iq[0::2].astype(np.float32) + 1j * iq[1::2].astype(np.float32))
            res = res.astype(np.complex64) / self.cfg.iq_scale
            re0 = hdr["start_prb"] * 12
            n = min(res.size, buffer.shape[2] - re0)
            buffer[port, sym, re0 : re0 + n] = res[:n]
            filled[port, sym] = True
            if filled.all():
                complete = (ctx, buffer)
                del self._prach_pending[target]
        if complete is not None:
            ctx, buffer = complete
            self.symbol_notifier.on_new_prach_window_data(
                ctx, torch.from_numpy(buffer).to(self.cfg.device))

    def _slot_symbols(self, slot: SlotPoint) -> int:
        spsf = nof_slots_per_subframe(self.cfg.scs)
        frame, subframe, slot_id = self._timestamp(slot)
        return ((frame * 10 + subframe) * spsf + slot_id) * SYMBOLS_PER_SLOT

    def _evict_stale(self, now_symbols: int) -> None:
        """Purge pending UL/PRACH contexts whose reception window closed
        (frames lost on the wire); count them late so a long run cannot
        grow the pending maps without bound (reference
        uplink_context_repository expiry + rx window stats)."""
        horizon = SYMBOLS_PER_SLOT + self.cfg.rx_window_late_symbols
        stale_ul, stale_prach = [], []
        with self._lock:
            for slot in list(self._ul_pending):
                if now_symbols - self._slot_symbols(slot) > horizon:
                    del self._ul_pending[slot]
                    del self._ul_filled[slot]
                    stale_ul.append(slot)
                    self.metrics.late_ul_requests += 1
            for slot in list(self._prach_pending):
                if now_symbols - self._slot_symbols(slot) > horizon:
                    del self._prach_pending[slot]
                    stale_prach.append(slot)
                    self.metrics.late_prach_requests += 1
        if self.error_notifier is not None:
            for slot in stale_ul:
                self.error_notifier.on_late_uplink_message(slot, 0)
            for slot in stale_prach:
                self.error_notifier.on_late_prach_message(slot, 0)

    def _enqueue_tx(self, sym_abs: int, t1a_min: int, t1a_max: int,
                    msg: np.ndarray, plane: str = "dl",
                    slot: Optional[SlotPoint] = None) -> None:
        with self._lock:
            self._tx_queue.append((sym_abs, t1a_min, t1a_max, msg, plane, slot))

    def _dispatch_tx(self) -> None:
        """Send queued frames whose transmit window is open (ota in
        [t - t1a_max, t - t1a_min] of the frame's air time t, each frame
        carrying its own C-/U-plane window); drop + count frames whose
        window closed before they were sent, attributed to THEIR plane
        (a late UL-grant C-plane is uplink lateness, not downlink)."""
        late_slots = []
        with self._lock:
            now = self._ota_symbols
            if now is None:
                return
            due, keep = [], []
            counted = set()
            for entry in self._tx_queue:
                sym_abs, t1a_min, t1a_max, msg, plane, slot = entry
                if sym_abs - t1a_min < now:
                    # Too late to reach the RU in time.  UL/PRACH C-plane
                    # lateness is a per-SLOT condition (one request fans
                    # out to one frame per port) — count it once.
                    if plane in ("ul", "prach") and (plane, slot) in counted:
                        late_slots.append((plane, slot))
                        continue
                    counted.add((plane, slot))
                    if plane == "ul":
                        self.metrics.late_ul_requests += 1
                        # The RU never receives this grant: drop the
                        # pending context now so the eviction sweep does
                        # not count the same slot late a second time.
                        if slot is not None:
                            self._ul_pending.pop(slot, None)
                            self._ul_filled.pop(slot, None)
                    elif plane == "prach":
                        self.metrics.late_prach_requests += 1
                        if slot is not None:
                            self._prach_pending.pop(slot, None)
                    else:
                        self.metrics.late_dl_requests += 1
                    late_slots.append((plane, slot))
                elif sym_abs - t1a_max <= now:
                    due.append((sym_abs, msg))
                else:
                    keep.append(entry)
            self._tx_queue = keep
        if self.error_notifier is not None:
            for plane, slot in dict.fromkeys(late_slots):
                if slot is None:
                    continue
                if plane == "ul":
                    self.error_notifier.on_late_uplink_message(slot, 0)
                elif plane == "prach":
                    self.error_notifier.on_late_prach_message(slot, 0)
                else:
                    self.error_notifier.on_late_downlink_message(slot, 0)
        for _sym, msg in sorted(due, key=lambda t: t[0]):
            self.send_frame(msg)

    def ota_tick(self, slot: SlotPoint, symbol: int = 0) -> None:
        """Advance the OTA clock: reception-window bookkeeping, stale
        pending-context eviction, and the paced-DL symbol dispatcher."""
        now = self._slot_symbols(slot) + symbol
        self.window.tick(now)
        with self._lock:
            self._ota_symbols = now
        self._evict_stale(now)
        if self.cfg.dl_pacing == "paced":
            self._dispatch_tx()
        if self.timing_notifier is not None and symbol == 0:
            self.timing_notifier.on_tti_boundary(slot)


class RuOfhMultiSector:
    """Multi-sector OFH RU: one OFH transmitter/receiver pipeline per
    sector behind the single radio_unit facade (reference ru_ofh_impl
    holds a sector vector, lib/ru/ofh/ru_ofh_impl.cpp; per-sector eAxC
    maps and Ethernet flows come from each sector's RuOfhConfig).

    DL/UL plane requests route on ``context.sector``; the OTA tick drives
    every sector's window machinery; metrics aggregate across sectors.
    ``send_frames`` may be one callable shared by all sectors or a list
    with one callable per sector (distinct Ethernet flows).
    """

    def __init__(self, cfgs, symbol_notifier, send_frames=None,
                 timing_notifier=None, error_notifier=None):
        if callable(send_frames) or send_frames is None:
            send_frames = [send_frames] * len(cfgs)
        if len(send_frames) != len(cfgs):
            raise ValueError("need one send_frame per sector (or one shared)")
        # Only sector 0 forwards TTI boundaries (one OTA clock).
        self.sectors = [
            RuOfh(cfg, symbol_notifier, send_frame=tx,
                  timing_notifier=(timing_notifier if i == 0 else None),
                  error_notifier=error_notifier)
            for i, (cfg, tx) in enumerate(zip(cfgs, send_frames))
        ]

    # -- controller --------------------------------------------------------
    def start(self) -> None:
        for s in self.sectors:
            s.start()

    def stop(self) -> None:
        for s in self.sectors:
            s.stop()

    def get_controller(self):
        return self

    def get_downlink_plane_handler(self):
        return self

    def get_uplink_plane_handler(self):
        return self

    def get_metrics(self) -> RuMetrics:
        agg = RuMetrics()
        for s in self.sectors:
            m = s.get_metrics()
            for f in dataclasses.fields(RuMetrics):
                setattr(agg, f.name, getattr(agg, f.name) + getattr(m, f.name))
        return agg

    # -- plane handlers (route on context.sector) --------------------------
    def handle_dl_data(self, context: ResourceGridContext, grid) -> None:
        self.sectors[context.sector].handle_dl_data(context, grid)

    def handle_new_uplink_slot(self, context: ResourceGridContext) -> None:
        self.sectors[context.sector].handle_new_uplink_slot(context)

    def handle_prach_occasion(self, context: PrachBufferContext) -> None:
        self.sectors[context.sector].handle_prach_occasion(context)

    def push_uplane_frame(self, sector: int, data: np.ndarray) -> None:
        self.sectors[sector].push_uplane_frame(data)

    def ota_tick(self, slot: SlotPoint, symbol: int = 0) -> None:
        for s in self.sectors:
            s.ota_tick(slot, symbol)
