"""Periodic SRS scheduling engine.

Counterpart of the reference srs_scheduler_impl (lib/scheduler/srs/
srs_scheduler_impl.cpp): each UE's periodic SRS resource (period, offset
in slots) goes onto a slot wheel sized to the longest supported period;
every UL slot the wheel yields the UEs due to sound, and the scheduler
emits one SRS PDU per due UE.  Collisions inside a slot are avoided by
assigning distinct comb offsets / cyclic shifts round-robin (the reference
fixes them in the UE's srs_config; the sim derives them from the UE index
the same way its config generator does).  A copy of
``srsran_project_tpu/l2sim/srs_alloc.py``.
"""

from __future__ import annotations

import dataclasses

# TS 38.211 Table 6.4.1.4.3-1 supported periodicities (slots).
SRS_PERIODS = (1, 2, 4, 5, 8, 10, 16, 20, 32, 40, 64, 80, 160, 320, 640, 1280, 2560)


@dataclasses.dataclass(frozen=True)
class SrsResourceConfig:
    """One periodic SRS resource of a UE."""

    period_slots: int = 20
    offset_slots: int = 0
    nof_symbols: int = 1  # 1, 2, 4 at the end of the slot
    comb: int = 2  # K_TC in {2, 4}
    comb_offset: int = 0
    cyclic_shift: int = 0
    sequence_id: int = 0

    def __post_init__(self):
        assert self.period_slots in SRS_PERIODS, self.period_slots
        assert 0 <= self.offset_slots < self.period_slots


class SrsScheduler:
    """Slot wheel of periodic SRS opportunities."""

    def __init__(self):
        self._ues: dict[int, SrsResourceConfig] = {}

    def add_ue(self, rnti: int, cfg: SrsResourceConfig | None = None) -> SrsResourceConfig:
        if cfg is None:
            # Distinct comb offset / cyclic shift / offset per UE index, the
            # way the reference's du config generator spreads them.
            i = len(self._ues)
            cfg = SrsResourceConfig(
                period_slots=20,
                offset_slots=i % 20,
                comb_offset=i % 2,
                cyclic_shift=(2 * i) % 8,
                sequence_id=rnti & 0x3FF,
            )
        self._ues[rnti] = cfg
        return cfg

    def rem_ue(self, rnti: int) -> None:
        self._ues.pop(rnti, None)

    def due(self, slot_count: int) -> list[tuple[int, SrsResourceConfig]]:
        """UEs whose periodic SRS resource fires in this slot."""
        return [
            (rnti, cfg)
            for rnti, cfg in self._ues.items()
            if slot_count % cfg.period_slots == cfg.offset_slots
        ]
