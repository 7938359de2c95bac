"""Per-UE scheduler context loops: TA maintenance, DRX, SRS channel state.

Counterparts of the reference's lib/scheduler/ue_context trio:

- ``TaManager`` — ta_manager.cpp: windowed N_TA-difference measurements
  (SINR-gated, 1.75-sigma outlier rejection), TA command
  ``round(n_ta_diff * 2^mu / (16 * 64)) + 31 - target`` emitted as a
  MAC CE when it deviates from 31 by at least the threshold, then a
  prohibit period.
- ``DrxController`` — ue_drx_controller.cpp: long-cycle onDuration
  window + drx-InactivityTimer restarted by new-transmission PDCCH;
  scheduling is gated on active time (pending SR keeps the UE active).
- ``SrsChannelState`` — ue_channel_state_manager.cpp
  update_srs_channel_matrix: the SRS-estimated channel matrix selects
  the UL TPMI/rank (Type-I codebook search at an assumed 30 dB SNR) and
  its per-element power feeds the wideband UL SINR used by link
  adaptation.

A copy of ``srsran_project_tpu/l2sim/ue_context_loops.py``.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

T_C_S = 1.0 / (480_000.0 * 4096.0)  # TS 38.211 basic time unit


# ---------------------------------------------------------------------------
# TA manager
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TaManagerConfig:
    # Slots of measurement accumulation before a command decision
    # (reference scheduler_expert_config ta_measurement_slot_period).
    measurement_period: int = 80
    # Slots after a sent command during which measurement is prohibited.
    prohibit_period: int = 0
    # Minimum |new_t_a - 31| for a command to be sent.
    cmd_offset_threshold: int = 1
    # Measurements below this UL SINR are discarded (outlier gate).
    sinr_threshold_db: float = 0.0
    # Steady-state target offset in TA-command units.
    target: float = 0.0


class TaManager:
    """One instance per UE (single TAG)."""

    _OFFSET_ZERO = 31
    _NUM_STD = 1.75

    def __init__(self, cfg: TaManagerConfig, mu: int):
        self.cfg = cfg
        self.mu = mu
        self.samples: list[float] = []
        self.state = "idle"  # idle | measure | prohibit
        self._window_start = 0
        self._prohibit_start = 0

    def handle_ul_n_ta_update(self, n_ta_diff_tc: float, ul_sinr_db: float) -> None:
        """Record one N_TA difference measurement (T_C units; positive =
        the UE should advance)."""
        if self.state == "measure" and ul_sinr_db > self.cfg.sinr_threshold_db:
            self.samples.append(float(n_ta_diff_tc))

    def handle_ta_seconds(self, ta_s: float, ul_sinr_db: float) -> None:
        """Convenience: PUSCH/SRS time-alignment estimate in seconds."""
        self.handle_ul_n_ta_update(ta_s / T_C_S, ul_sinr_db)

    def _avg(self) -> float:
        s = np.asarray(self.samples, np.float64)
        if len(s) <= 2:
            return float(s.mean())
        mean = s.mean()
        std = s.std(ddof=1)
        keep = np.abs(s - mean) <= self._NUM_STD * std
        if not keep.any():
            return float(mean)
        return float(s[keep].mean())

    def _new_t_a(self, n_ta_diff: float) -> int:
        return int(round(n_ta_diff * (2 ** self.mu) / (16.0 * 64.0)
                         + self._OFFSET_ZERO - self.cfg.target))

    def slot_indication(self, slot_count: int) -> int | None:
        """Advance the state machine; returns a TA command value [0, 63]
        to queue as a MAC CE, or None."""
        if self.state == "idle":
            self._window_start = slot_count
            self.state = "measure"
            return None
        if self.state == "prohibit":
            if slot_count - self._prohibit_start > self.cfg.prohibit_period:
                self._window_start = slot_count
                self.state = "measure"
            return None
        if slot_count - self._window_start < self.cfg.measurement_period:
            return None
        cmd = None
        if self.samples:
            new_t_a = self._new_t_a(self._avg())
            if abs(new_t_a - self._OFFSET_ZERO) >= self.cfg.cmd_offset_threshold:
                cmd = int(np.clip(new_t_a, 0, 63))
        self.samples.clear()
        if cmd is not None and self.cfg.prohibit_period > 0:
            self.state = "prohibit"
            self._prohibit_start = slot_count
        else:
            self.state = "idle"
        return cmd


# ---------------------------------------------------------------------------
# DRX controller
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DrxConfig:
    long_cycle_ms: int = 40
    long_start_offset_ms: int = 0
    on_duration_ms: int = 4
    inactivity_ms: int = 8


class DrxController:
    """Active-time tracking for one UE (slots, scs-aware)."""

    def __init__(self, cfg: DrxConfig | None, scs_mu: int = 1):
        self.cfg = cfg
        n = 1 << scs_mu  # slots per subframe (= per ms)
        if cfg is not None:
            self.period = cfg.long_cycle_ms * n
            start = cfg.long_start_offset_ms * n
            self.window = (start, start + cfg.on_duration_ms * n)
            self.inactivity = cfg.inactivity_ms * n
        self.active_end: int | None = None
        self.sr_pending = False

    def slot_indication(self, slot_count: int) -> None:
        if self.cfg is None:
            return
        if self.active_end is not None and slot_count >= self.active_end:
            self.active_end = None
        if self.active_end is None:
            m = slot_count % self.period
            in_window = self.window[0] <= m < self.window[1]
            wrapped = (not in_window and self.window[1] >= self.period
                       and m < self.window[1] % self.period)
            if in_window:
                self.active_end = slot_count + (self.window[1] - m)
            elif wrapped:
                # Wrapped tail of a window crossing the cycle boundary:
                # the remaining duration is measured against the WRAPPED
                # end (window[1] % period), not the unwrapped one — the
                # latter would keep the UE active nearly a full extra
                # cycle (the reference's arithmetic
                # has the same wrap defect for these configs).
                self.active_end = slot_count + (self.window[1] % self.period - m)

    def is_pdcch_enabled(self) -> bool:
        if self.cfg is None:
            return True
        return self.active_end is not None or self.sr_pending

    def on_new_tx_pdcch(self, slot_count: int) -> None:
        """New DL or UL transmission scheduled: (re)start inactivity."""
        if self.cfg is None or not self.is_pdcch_enabled():
            return
        if self.inactivity:
            end = slot_count + self.inactivity
            if self.active_end is None or self.active_end < end:
                self.active_end = end


# ---------------------------------------------------------------------------
# SRS-driven channel state
# ---------------------------------------------------------------------------

class SrsChannelState:
    """UL channel state from SRS: wideband SINR + TPMI/rank selection."""

    def __init__(self, max_rank: int = 1):
        self.max_rank = max_rank
        self.wideband_snr_db: float | None = None
        self.tpmi: int = 0
        self.rank: int = 1

    def update_srs_channel_matrix(self, h: np.ndarray) -> None:
        """h: (nof_rx_ports, nof_tx_ports) SRS-estimated narrowband matrix
        (or a wideband average).  Reference semantics: noise variance is
        assumed 30 dB below the average received power
        (ue_channel_state_manager.cpp:84), TPMI/rank by capacity search
        over the Type-I codebook."""
        h = np.asarray(h, np.complex128)
        nrx, ntx = h.shape
        fro2 = float(np.sum(np.abs(h) ** 2))
        if fro2 <= 0.0:
            return
        noise_var = fro2 / (1000.0 * ntx)
        self.wideband_snr_db = 10.0 * math.log10(fro2 / ntx / noise_var)
        if ntx <= 1:
            self.tpmi, self.rank = 0, 1
            return
        from ..ran import precoding as precoding_mod

        rank, fields = precoding_mod.select_rank_and_pmi(
            h, ntx, max_rank=min(self.max_rank, ntx, nrx))
        self.rank = rank
        # Flatten the codebook fields to a TPMI ordinal (enumeration order).
        self.tpmi = list(precoding_mod.enumerate_pmis(ntx, rank)).index(fields)
        self.pmi_fields = fields


# ---------------------------------------------------------------------------
# Measurement gaps
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeasGapConfig:
    """Per-UE measurement gap pattern (TS 38.133 table 9.1.2-1 shapes;
    reference: lib/scheduler's meas-gap gating of the schedulable set —
    during a gap the UE retunes for inter-frequency measurements and can
    neither monitor PDCCH nor transmit/receive)."""

    mgrp_ms: int = 40        # gap repetition period
    mgl_ms: float = 6.0      # gap length (1.5 / 3 / 3.5 / 4 / 5.5 / 6)
    gap_offset_ms: int = 0   # offset of the gap start within the period


class MeasGapController:
    """Slot-level in-gap predicate for one UE (scs-aware)."""

    def __init__(self, cfg: MeasGapConfig | None, scs_mu: int = 1):
        self.cfg = cfg
        n = 1 << scs_mu  # slots per ms
        if cfg is not None:
            self.period = cfg.mgrp_ms * n
            self.start = cfg.gap_offset_ms * n
            import math

            self.length = math.ceil(cfg.mgl_ms * n)

    def in_gap(self, slot_count: int) -> bool:
        if self.cfg is None:
            return False
        m = slot_count % self.period
        if self.start + self.length <= self.period:
            return self.start <= m < self.start + self.length
        # Gap wraps the period boundary.
        return m >= self.start or m < (self.start + self.length) % self.period

    def is_schedulable(self, slot_count: int) -> bool:
        return not self.in_gap(slot_count)
