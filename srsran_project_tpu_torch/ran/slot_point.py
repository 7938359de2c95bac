"""Slot timestamping: a copy of ``srsran_project_tpu/ran/slot_point.py``
(the reference's include/srsran/ran/slot_point.h).

A SlotPoint identifies one slot within the 1024-frame SFN cycle for a given
numerology.  Pure integer math; hashable and ordered so it can key host-side
pipeline state (grids in flight, HARQ deadlines).
"""

from __future__ import annotations

import dataclasses

from .constants import NOF_SFNS, SubcarrierSpacing, nof_slots_per_frame, nof_slots_per_subframe


@dataclasses.dataclass(frozen=True, order=True)
class SlotPoint:
    scs: SubcarrierSpacing
    count: int  # absolute slot index in [0, 1024 * slots_per_frame)

    @classmethod
    def from_sfn_slot(cls, scs: SubcarrierSpacing, sfn: int, slot_in_frame: int) -> "SlotPoint":
        spf = nof_slots_per_frame(scs)
        if not 0 <= slot_in_frame < spf:
            raise ValueError(f"slot {slot_in_frame} out of range for scs {scs}")
        return cls(scs, (sfn % NOF_SFNS) * spf + slot_in_frame)

    @property
    def slots_per_frame(self) -> int:
        return nof_slots_per_frame(self.scs)

    @property
    def sfn(self) -> int:
        return self.count // self.slots_per_frame

    @property
    def slot_in_frame(self) -> int:
        return self.count % self.slots_per_frame

    @property
    def slot_in_subframe(self) -> int:
        return self.count % nof_slots_per_subframe(self.scs)

    @property
    def subframe(self) -> int:
        return self.slot_in_frame // nof_slots_per_subframe(self.scs)

    def __add__(self, n: int) -> "SlotPoint":
        wrap = NOF_SFNS * self.slots_per_frame
        return SlotPoint(self.scs, (self.count + n) % wrap)

    def __sub__(self, other) -> int:
        if isinstance(other, SlotPoint):
            wrap = NOF_SFNS * self.slots_per_frame
            d = (self.count - other.count) % wrap
            # interpret as signed distance in (-wrap/2, wrap/2]
            return d - wrap if d > wrap // 2 else d
        return NotImplemented

    def __repr__(self) -> str:
        return f"SlotPoint(mu={int(self.scs)}, {self.sfn}.{self.slot_in_frame})"
