"""RU interface contracts.

A copy of ``srsran_project_tpu/ru/interface.py``.  Mirrors
include/srsran/ru/ru.h:37-54 (radio_unit aggregates controller + DL plane
+ UL plane + metrics), ru_downlink_plane.h:38-48, ru_uplink_plane.h:35-103
and ru_timing_notifier.h:30-60 — as small Python protocols: grids are
tensors (numpy arrays are accepted where the RU takes host data),
notification is plain callables, and per-implementation threading lives
behind the interface rather than in executor plumbing.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Protocol, runtime_checkable

from ..ran.slot_point import SlotPoint


@dataclasses.dataclass(frozen=True)
class ResourceGridContext:
    """Identifies the slot/sector a grid belongs to (reference
    include/srsran/phy/support/resource_grid_context.h)."""

    slot: SlotPoint
    sector: int = 0


@dataclasses.dataclass(frozen=True)
class PrachBufferContext:
    """PRACH window request context (reference
    include/srsran/phy/support/prach_buffer_context.h — the subset that
    drives capture: where/when the window sits)."""

    slot: SlotPoint
    sector: int = 0
    start_symbol: int = 0
    format: str = "B4"
    rb_offset: int = 0
    nof_td_occasions: int = 1
    nof_fd_occasions: int = 1


@dataclasses.dataclass(frozen=True)
class RxSymbolContext:
    """Uplink received-symbol notification context
    (ru_uplink_plane.h:35-42)."""

    slot: SlotPoint
    sector: int = 0
    symbol_id: int = 13  # last processed symbol within the slot


class RxSymbolNotifier(Protocol):
    """Upward notifications (ru_uplink_plane_rx_symbol_notifier,
    ru_uplink_plane.h:48-71)."""

    def on_new_uplink_symbol(self, context: RxSymbolContext, grid, is_valid: bool) -> None: ...

    def on_new_prach_window_data(self, context: PrachBufferContext, buffer) -> None: ...


class RuTimingNotifier(Protocol):
    """Timing events (ru_timing_notifier.h:38-60)."""

    def on_tti_boundary(self, slot: SlotPoint) -> None: ...

    def on_ul_half_slot_boundary(self, slot: SlotPoint) -> None: ...

    def on_ul_full_slot_boundary(self, slot: SlotPoint) -> None: ...


class RuErrorNotifier(Protocol):
    """Real-time failure events (ru_error_notifier.h)."""

    def on_late_downlink_message(self, slot: SlotPoint, sector: int) -> None: ...

    def on_late_uplink_message(self, slot: SlotPoint, sector: int) -> None: ...

    def on_late_prach_message(self, slot: SlotPoint, sector: int) -> None: ...


class RuDownlinkPlaneHandler(Protocol):
    """DL plane (ru_downlink_plane.h:38-48)."""

    def handle_dl_data(self, context: ResourceGridContext, grid) -> None: ...


class RuUplinkPlaneHandler(Protocol):
    """UL plane (ru_uplink_plane.h:76-103)."""

    def handle_prach_occasion(self, context: PrachBufferContext) -> None: ...

    def handle_new_uplink_slot(self, context: ResourceGridContext) -> None: ...


class RuController(Protocol):
    """Operation control (ru_controller.h:149-...): start/stop plus the
    optional knob controllers, which return None when the underlying
    implementation has no such capability (matching the reference's
    nullptr-returning getters)."""

    def start(self) -> None: ...

    def stop(self) -> None: ...

    def set_tx_gain(self, sector: int, gain_db: float) -> bool:
        return False

    def set_rx_gain(self, sector: int, gain_db: float) -> bool:
        return False

    def set_tx_cfo(self, sector: int, cfo_hz: float) -> bool:
        return False

    def set_rx_cfo(self, sector: int, cfo_hz: float) -> bool:
        return False


@dataclasses.dataclass
class RuMetrics:
    """Aggregated RU counters (ru_metrics_collector.h / ru_dummy_metrics.h)."""

    total_dl_requests: int = 0
    total_ul_requests: int = 0
    total_prach_requests: int = 0
    late_dl_requests: int = 0
    late_ul_requests: int = 0
    late_prach_requests: int = 0
    # Frame-level lateness (OFH rx-window checker): frames outside the Ta4
    # window.  Kept separate from late_ul_requests (slot-level: requests
    # evicted unfilled) so a late-then-evicted slot is not counted twice.
    late_ul_frames: int = 0
    slots_notified: int = 0
    slots_skipped: int = 0


@runtime_checkable
class RadioUnit(Protocol):
    """The single object upper layers hold (ru.h:37-54)."""

    def get_controller(self) -> RuController: ...

    def get_downlink_plane_handler(self) -> RuDownlinkPlaneHandler: ...

    def get_uplink_plane_handler(self) -> RuUplinkPlaneHandler: ...

    def get_metrics(self) -> Optional[RuMetrics]: ...
