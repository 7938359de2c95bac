"""Generic Radio Unit: RU interface over the lower PHY + a baseband gateway.

Port of ``srsran_project_tpu/ru/generic.py``, the counterpart of
lib/ru/generic (ru_generic_impl wiring lower_phy sectors to a radio
session; ru_downlink_handler_generic_impl forwards grids into the lower
PHY request queues, ru_uplink_request_handler_generic_impl the UL/PRACH
requests, rx_symbol_adapter translates lower-PHY notifications into
ru_uplink_plane_rx_symbol_notifier events).

The lower PHY's compute (``ops/ofdm.modulate_slot`` / ``demodulate_slot``
and the PRACH window's ``ops/lower_phy.prach_demodulate``) is
``torch.fft`` on the device the grid or the samples live on, run at each
slot boundary by ``advance_slot``.  The DL grid and the UL samples stay
on the device: ``transmit_cb`` receives the modulated samples as a
tensor, and only a host transport (``support.native.IqSocket``, a file)
copies them out.  ``push_ul_samples`` takes a tensor or a numpy array
and moves it to ``RuGenericConfig.device``; a numpy DL grid goes there
too, a DL tensor stays where it is.  The timestamp-paced rx/tx threading
is ``phy.lower_loop.BasebandLoop``'s when a streaming gateway is attached.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Callable, Dict, Optional

import torch

from ..ops import lower_phy, ofdm
from ..ran.constants import CyclicPrefix, SubcarrierSpacing, scs_khz
from ..ran.slot_point import SlotPoint
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
class RuGenericConfig:
    scs: SubcarrierSpacing = SubcarrierSpacing.KHZ30
    cp: CyclicPrefix = CyclicPrefix.NORMAL
    dft_size: int = 1024
    nof_tx_ports: int = 1
    nof_rx_ports: int = 1
    nof_rb: int = 24
    # Amplitude gains applied to the modulated / received baseband, dB.
    tx_gain_db: float = 0.0
    rx_gain_db: float = 0.0
    # Carrier frequency offset corrections (set through the controller;
    # stored, as in the reference, which does not apply them either).
    tx_cfo_hz: float = 0.0
    rx_cfo_hz: float = 0.0
    # Where host data (numpy DL grids, numpy UL samples) is moved to.
    device: str = "cuda"


def _complex64(x, device) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.complex64)


class RuGeneric:
    """radio_unit over the OFDM programs and a sample transport.

    ``transmit_cb(slot, samples)`` receives the modulated slot baseband
    (ports x samples, complex64 tensor on the grid's device); feed it to
    ``native.IqSocket``, a file or a channel emulator.  Uplink baseband
    enters through ``push_ul_samples``.
    """

    def __init__(self, cfg: RuGenericConfig, symbol_notifier: RxSymbolNotifier,
                 transmit_cb: Optional[Callable[[SlotPoint, torch.Tensor], None]] = None,
                 timing_notifier=None,
                 error_notifier: Optional[RuErrorNotifier] = None):
        self.cfg = cfg
        self.symbol_notifier = symbol_notifier
        self.transmit_cb = transmit_cb or (lambda slot, samples: None)
        self.timing_notifier = timing_notifier
        self.error_notifier = error_notifier
        self._dl_requests: Dict[SlotPoint, torch.Tensor] = {}
        self._ul_requests: Dict[SlotPoint, ResourceGridContext] = {}
        self._prach_requests: Dict[SlotPoint, PrachBufferContext] = {}
        self._ul_samples: Dict[SlotPoint, torch.Tensor] = {}
        self._lock = threading.Lock()
        self.metrics = RuMetrics()
        self._running = False

    # -- controller --------------------------------------------------------
    def start(self) -> None:
        self._running = True

    def stop(self) -> None:
        self._running = False

    def set_tx_gain(self, sector: int, gain_db: float) -> bool:
        self.cfg.tx_gain_db = gain_db
        return True

    def set_rx_gain(self, sector: int, gain_db: float) -> bool:
        self.cfg.rx_gain_db = gain_db
        return True

    def set_tx_cfo(self, sector: int, cfo_hz: float) -> bool:
        self.cfg.tx_cfo_hz = cfo_hz
        return True

    def set_rx_cfo(self, sector: int, cfo_hz: float) -> bool:
        self.cfg.rx_cfo_hz = cfo_hz
        return True

    def get_controller(self):
        return self

    def get_downlink_plane_handler(self):
        return self

    def get_uplink_plane_handler(self):
        return self

    def get_metrics(self) -> RuMetrics:
        return self.metrics

    # -- planes ------------------------------------------------------------
    def handle_dl_data(self, context: ResourceGridContext, grid) -> None:
        """Queue one slot's DL grid (ports x symbols x subcarriers): a tensor
        stays on its device, a numpy array goes to ``cfg.device``."""
        if not isinstance(grid, torch.Tensor):
            grid = _complex64(grid, self.cfg.device)
        with self._lock:
            self._dl_requests[context.slot] = grid
            self.metrics.total_dl_requests += 1

    def handle_new_uplink_slot(self, context: ResourceGridContext) -> None:
        with self._lock:
            self._ul_requests[context.slot] = context
            self.metrics.total_ul_requests += 1

    def handle_prach_occasion(self, context: PrachBufferContext) -> None:
        with self._lock:
            self._prach_requests[context.slot] = context
            self.metrics.total_prach_requests += 1

    # -- baseband ingress ---------------------------------------------------
    def push_ul_samples(self, slot: SlotPoint, samples) -> None:
        """Deliver one received slot of baseband (ports x samples), a tensor
        or a numpy array, moved to ``cfg.device``."""
        samples = _complex64(samples, self.cfg.device)
        with self._lock:
            self._ul_samples[slot] = samples

    # -- slot engine --------------------------------------------------------
    def advance_slot(self, slot: SlotPoint) -> None:
        """Process the boundary of ``slot``: modulate+transmit its DL
        request, demodulate+notify its UL request, flag anything stale."""
        if self.timing_notifier is not None:
            self.timing_notifier.on_tti_boundary(slot)
        with self._lock:
            dl_grid = self._dl_requests.pop(slot, None)
            ul_ctx = self._ul_requests.pop(slot, None)
            prach_ctx = self._prach_requests.pop(slot, None)
            ul_samples = self._ul_samples.pop(slot, None)
            # Drop and count anything from slots already behind us.
            for store, plane in ((self._dl_requests, "dl"),
                                 (self._ul_requests, "ul"),
                                 (self._prach_requests, "prach")):
                stale = [s for s in store if (slot - s) > 0]
                for s in stale:
                    store.pop(s)
                    self._count_late(plane, s)

        if dl_grid is not None:
            samples = ofdm.modulate_slot(dl_grid, scs=self.cfg.scs, dft_size=self.cfg.dft_size,
                                         cp=self.cfg.cp, slot_in_subframe=slot.slot_in_subframe)
            if self.cfg.tx_gain_db:
                samples = samples * (10.0 ** (self.cfg.tx_gain_db / 20.0))
            self.transmit_cb(slot, samples)

        if ul_ctx is not None:
            if ul_samples is not None:
                rx = ul_samples
                if self.cfg.rx_gain_db:
                    rx = rx * (10.0 ** (self.cfg.rx_gain_db / 20.0))
                grid = ofdm.demodulate_slot(
                    rx, nof_rb=self.cfg.nof_rb, scs=self.cfg.scs, dft_size=self.cfg.dft_size,
                    cp=self.cfg.cp, slot_in_subframe=slot.slot_in_subframe)
                valid = True
            else:
                grid, valid = None, False
            for i_symbol in range(SYMBOLS_PER_SLOT):
                ctx = RxSymbolContext(slot=ul_ctx.slot, sector=ul_ctx.sector,
                                      symbol_id=i_symbol)
                self.symbol_notifier.on_new_uplink_symbol(ctx, grid, valid)
        if prach_ctx is not None:
            buffer = None
            if ul_samples is not None:
                buffer = self._prach_buffer(prach_ctx, slot, ul_samples)
            self.symbol_notifier.on_new_prach_window_data(prach_ctx, buffer)
        if self.timing_notifier is not None:
            self.timing_notifier.on_ul_half_slot_boundary(slot)
            self.timing_notifier.on_ul_full_slot_boundary(slot)

    def _prach_buffer(self, ctx: PrachBufferContext, slot: SlotPoint,
                      samples: torch.Tensor) -> torch.Tensor:
        """The PRACH occasion demodulated per TS 38.211 5.3.2 with the full
        window geometry (the 16-kappa extensions; the reference's PRACH
        processor role in ru_generic's lower PHY): (..., nof_symbols, L_RA)
        in the frequency domain, one DFT per repeated symbol, like the
        reference's prach_buffer."""
        scs_hz = scs_khz(self.cfg.scs) * 1000
        l_ra = 839 if ctx.format in ("0", "1", "2", "3") else 139
        wp = lower_phy.prach_window_params(
            fmt=ctx.format, pusch_scs_hz=scs_hz, slot_in_subframe=slot.slot_in_subframe,
            start_symbol=ctx.start_symbol, td_occasion=0, srate_hz=self.cfg.dft_size * scs_hz,
            rb_offset=ctx.rb_offset, fd_occasion=0, nof_prb_ul_grid=self.cfg.nof_rb, l_ra=l_ra)
        window = samples[..., wp["sample_offset"]:]
        syms = [lower_phy.prach_demodulate(window, l_ra=l_ra, dft_size=wp["dft_size"],
                                           nof_symbols=1,
                                           cp_samples=wp["cp_samples"] + s * wp["dft_size"],
                                           k_offset=wp["k_offset"])
                for s in range(wp["nof_symbols"])]
        return torch.stack(syms, dim=-2)

    def _count_late(self, plane: str, slot: SlotPoint) -> None:
        if plane == "dl":
            self.metrics.late_dl_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_downlink_message(slot, 0)
        elif plane == "ul":
            self.metrics.late_ul_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_uplink_message(slot, 0)
        else:
            self.metrics.late_prach_requests += 1
            if self.error_notifier is not None:
                self.error_notifier.on_late_prach_message(slot, 0)
