"""FAPI message bufferer — L2 lateness/earliness alignment.

Counterpart of the reference's message_bufferer decorator
(lib/fapi/message_buffering/message_bufferer_slot_gateway_impl.cpp): the
MAC may deliver slot requests up to `l2_nof_slots_ahead` slots early;
early messages are cached per slot and released on the matching slot
indication; messages for a slot farther ahead than the configured delay
are rejected, and messages for past slots are dropped as late (counted and
reported through an ERROR.indication-style callback).

Copy of ``srsran_project_tpu/fapi/bufferer.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from ..ran.slot_point import SlotPoint
from . import messages as fapi


@dataclasses.dataclass
class BuffererStats:
    nof_forwarded: int = 0
    nof_cached: int = 0
    nof_late: int = 0
    nof_too_early: int = 0
    nof_unsent_overwritten: int = 0


class MessageBufferer:
    """Caches early slot messages; forwards them at their slot boundary."""

    def __init__(
        self,
        forward: Callable[[Any], None],
        l2_nof_slots_ahead: int = 2,
        on_error: Callable[[fapi.ErrorIndication], None] | None = None,
    ) -> None:
        self._forward = forward
        self._ahead = l2_nof_slots_ahead
        self._on_error = on_error or (lambda _e: None)
        # Pool of l2_nof_slots_ahead + 1 slot bins (reference
        # message_bufferer_slot_gateway_impl.cpp:41).
        self._pool: dict[int, list] = {}
        self._current: SlotPoint | None = None
        self.stats = BuffererStats()

    def handle_message(self, msg: Any) -> bool:
        """Queue or forward a slot-stamped message (DL_TTI/UL_TTI/UL_DCI/
        TX_Data).  Returns True if accepted."""
        slot: SlotPoint = msg.slot
        if self._current is None:
            # No timing yet: cache in the bin.
            self._cache(msg)
            return True
        diff = slot - self._current
        if diff < 0:
            self.stats.nof_late += 1
            self._on_error(
                fapi.ErrorIndication(
                    slot=slot,
                    message=f"late FAPI message for slot {slot} at {self._current}",
                    error_code=fapi.ErrorCode.MSG_SLOT_ERR,
                )
            )
            return False
        if diff > self._ahead:
            self.stats.nof_too_early += 1
            self._on_error(
                fapi.ErrorIndication(
                    slot=slot,
                    message=(
                        f"FAPI message {diff} slots ahead exceeds the configured "
                        f"delay {self._ahead}"
                    ),
                    error_code=fapi.ErrorCode.MSG_INVALID_SFN,
                )
            )
            return False
        if diff == 0:
            self.stats.nof_forwarded += 1
            self._forward(msg)
            return True
        self._cache(msg)
        return True

    def on_slot_indication(self, slot: SlotPoint) -> None:
        """Advance timing; flush the new slot's cached messages and drop any
        unsent stale cache entries (reference :84 warning semantics)."""
        self._current = slot
        key = slot.count % (self._ahead + 1)
        for stale_key in list(self._pool):
            if stale_key == key:
                continue
            # Drop bins whose slot has passed without being flushed.
            msgs = self._pool[stale_key]
            stale = [m for m in msgs if (m.slot - slot) < 0]
            if stale:
                self.stats.nof_unsent_overwritten += len(stale)
                self._pool[stale_key] = [m for m in msgs if (m.slot - slot) >= 0]
        for msg in self._pool.pop(key, []):
            if (msg.slot - slot) == 0:
                self.stats.nof_forwarded += 1
                self._forward(msg)
            else:
                self.stats.nof_unsent_overwritten += 1

    def _cache(self, msg: Any) -> None:
        self.stats.nof_cached += 1
        self._pool.setdefault(msg.slot.count % (self._ahead + 1), []).append(msg)
