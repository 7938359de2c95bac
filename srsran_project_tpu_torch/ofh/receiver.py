"""OFH receiver protections: rx window checker + sequence-id checker.

A copy of ``srsran_project_tpu/ofh/receiver.py``.

Counterparts of the reference's ofh_rx_window_checker.cpp and the
rx_seqid_checker (SURVEY.md sections 2.5 / 5.3): U-plane messages carry
the (frame, subframe, slot, symbol) they belong to; messages arriving
outside the configured reception window relative to OTA time are dropped
and counted (early / on-time / late), and per-eAxC sequence-id gaps are
counted as lost frames.  Time is the virtual symbol clock (caller-driven),
as everywhere in the simulators.
"""

from __future__ import annotations

import dataclasses

SYMBOLS_PER_SLOT = 14


def symbol_index(frame_id: int, subframe_id: int, slot_id: int, symbol_id: int,
                 slots_per_subframe: int = 2) -> int:
    """Absolute symbol count of a CUS-header timestamp (wrap at 256 frames)."""
    slots = (frame_id * 10 + subframe_id) * slots_per_subframe + slot_id
    return slots * SYMBOLS_PER_SLOT + symbol_id


@dataclasses.dataclass
class RxWindowStats:
    on_time: int = 0
    early: int = 0
    late: int = 0


class RxWindowChecker:
    """Accepts messages whose timestamp is within [-Ta4_max, +Ta4_min] of
    OTA symbol time (reference semantics: earlier than the window -> early,
    after it closed -> late)."""

    def __init__(self, window_early_symbols: int = 28, window_late_symbols: int = 2,
                 slots_per_subframe: int = 2):
        self.early_syms = window_early_symbols
        self.late_syms = window_late_symbols
        self.spsf = slots_per_subframe
        self.ota_symbol = 0
        self.stats = RxWindowStats()

    def tick(self, ota_symbol: int) -> None:
        self.ota_symbol = ota_symbol

    def check(self, frame_id: int, subframe_id: int, slot_id: int, symbol_id: int) -> bool:
        t = symbol_index(frame_id, subframe_id, slot_id, symbol_id, self.spsf)
        # unwrap against the 256-frame ambiguity around OTA time
        period = 256 * 10 * self.spsf * SYMBOLS_PER_SLOT
        delta = (t - self.ota_symbol + period // 2) % period - period // 2
        if delta > self.early_syms:
            self.stats.early += 1
            return False
        if delta < -self.late_syms:
            self.stats.late += 1
            return False
        self.stats.on_time += 1
        return True


class SeqIdChecker:
    """Per-eAxC sequence-id continuity (lost/duplicate accounting)."""

    def __init__(self):
        self._expected: dict[int, int] = {}
        self.lost = 0
        self.duplicates = 0

    def check(self, eaxc: int, seq_id: int) -> bool:
        exp = self._expected.get(eaxc)
        self._expected[eaxc] = (seq_id + 1) & 0xFFFF
        if exp is None or seq_id == exp:
            return True
        gap = (seq_id - exp) & 0xFFFF
        if gap >= 0x8000:  # behind: duplicate/reordered
            self.duplicates += 1
            self._expected[eaxc] = exp  # keep expectation
            return False
        self.lost += gap
        return True
