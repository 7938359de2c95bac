"""TDD UL/DL pattern helpers (TS 38.213 §11.1, tdd-UL-DL-ConfigCommon).

A copy of ``srsran_project_tpu/ran/tdd.py`` (the reference's TDD pattern
utilities in include/srsran/ran), with ``TddPattern.from_reference``.
"""

from __future__ import annotations

import dataclasses
import enum


class SlotDirection(enum.Enum):
    DOWNLINK = "dl"
    UPLINK = "ul"
    SPECIAL = "special"  # mixed DL/UL symbols (the 'S' slot)


@dataclasses.dataclass(frozen=True)
class TddPattern:
    """One tdd-UL-DL pattern: period in slots, leading DL, trailing UL."""

    period_slots: int = 10  # e.g. 5 ms at 30 kHz SCS
    nof_dl_slots: int = 7
    nof_ul_slots: int = 2
    nof_dl_symbols: int = 6  # DL symbols in the special slot
    nof_ul_symbols: int = 4  # UL symbols in the special slot

    @classmethod
    def from_reference(cls, ref) -> "TddPattern":
        """Copy a reference (JAX package) ``TddPattern`` field by field."""
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    def __post_init__(self):
        if self.nof_dl_slots + self.nof_ul_slots >= self.period_slots:
            if self.nof_dl_slots + self.nof_ul_slots > self.period_slots:
                raise ValueError("DL+UL slots exceed the period")

    @property
    def has_special_slot(self) -> bool:
        return self.nof_dl_slots + self.nof_ul_slots < self.period_slots

    def direction(self, slot_count: int) -> SlotDirection:
        pos = slot_count % self.period_slots
        if pos < self.nof_dl_slots:
            return SlotDirection.DOWNLINK
        if pos >= self.period_slots - self.nof_ul_slots:
            return SlotDirection.UPLINK
        return SlotDirection.SPECIAL

    def is_dl_symbol(self, slot_count: int, symbol: int) -> bool:
        d = self.direction(slot_count)
        if d == SlotDirection.DOWNLINK:
            return True
        if d == SlotDirection.SPECIAL:
            return symbol < self.nof_dl_symbols
        return False

    def is_ul_symbol(self, slot_count: int, symbol: int, nof_symbols: int = 14) -> bool:
        d = self.direction(slot_count)
        if d == SlotDirection.UPLINK:
            return True
        if d == SlotDirection.SPECIAL:
            return symbol >= nof_symbols - self.nof_ul_symbols
        return False


# A common 5 ms DDDDDDDSUU pattern at 30 kHz SCS.
PATTERN_7D2U = TddPattern(period_slots=10, nof_dl_slots=7, nof_ul_slots=2)
# FDD-like: everything both ways (modeled as all-DL + all-UL helpers).
