"""Slot scheduler simulator: the L2 front-end that drives the PHY.

Scope-parity counterpart of the reference's scheduler + DU test mode
(lib/scheduler/cell_scheduler.cpp:92 run_slot; mac_test_mode_adapter) at
simulator fidelity: a round-robin policy partitions the carrier across
active UEs each slot, builds FAPI DL_TTI/UL_TTI/TX_Data requests, tracks
per-UE HARQ processes (8, RV cycle 0-2-3-1), consumes CRC indications, and
accounts throughput — enough to drive the upper PHY end-to-end the way the
reference's tests drive it without a real MAC.

Port of ``srsran_project_tpu/l2sim/scheduler.py``: the same policy, the
same draws from the caller's numpy generator in the same order, and the
same FAPI requests, holding the port's PHY config twins, with one repair:
a DCI placed by the PDCCH allocator carries the allocator's CORESET (rb
count and duration) in its PdcchConfig, so that the PHY can encode it.
``SchedulerConfig.from_reference`` copies a JAX package config.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from ..fapi import messages as fapi
from ..ops.modulation import Modulation
from ..phy.allocation import Allocation
from ..phy.pdsch import PdschConfig
from ..phy.pusch import PuschConfig
from ..ran import tbs as tbs_mod
from ..ran.constants import NRE
from ..ran.slot_point import SlotPoint
from ..ran.tdd import SlotDirection, TddPattern

RV_SEQUENCE = (0, 2, 3, 1)
NOF_HARQ = 8


@dataclasses.dataclass
class HarqProcess:
    active: bool = False
    tb: np.ndarray | None = None
    nof_tx: int = 0
    # DL rank/precoding captured at first transmission: retransmissions
    # must reuse them (the TBS is rank-dependent).
    dl_layers: int = 0
    w: np.ndarray | None = None


@dataclasses.dataclass
class UeContext:
    rnti: int
    mcs: int = 10
    mcs_table: str = "qam64"
    qos_weight: float = 1.0  # QoS multiplier (priority)
    ul_buffer_bytes: int = 0  # last BSR-reported UL backlog
    sr_pending: bool = False  # scheduling request seen
    harqs: list = dataclasses.field(default_factory=lambda: [HarqProcess() for _ in range(NOF_HARQ)])
    # Closed-loop spatial adaptation from CSI part-2 reports: the reported
    # rank and the Type-I codebook weights of the reported PMI
    # (ran/precoding.pmi_to_weights); None until a report arrives.
    dl_rank: int | None = None
    dl_precoding: np.ndarray | None = None
    dl_bits_acked: int = 0
    ul_bits_ok: int = 0
    avg_rate: float = 1.0  # EWMA served rate (bits/slot) for PF
    # UL MCS when UL link adaptation diverges from DL (SRS-driven); None
    # means the shared ``mcs`` drives both directions.
    ul_mcs: int | None = None
    # UE-context loops (l2sim/ue_context_loops): set by add_ue per config.
    ta_manager: object | None = None
    drx: object | None = None
    meas_gap: object | None = None  # ue_context_loops.MeasGapController
    srs_state: object | None = None
    pending_ta_cmds: list = dataclasses.field(default_factory=list)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    nof_grid_sc: int = 624
    nof_rb: int = 52
    sym_start: int = 1
    sym_count: int = 12
    dmrs_symbols: tuple[int, ...] = (2,)
    max_ues_per_slot: int = 4
    nof_layers: int = 1
    nof_ports: int = 1
    tdd_pattern: TddPattern | None = None  # None = FDD (DL+UL every slot)
    policy: str = "rr"  # "rr" (round robin) or "qos" (PF-weighted)
    pf_forgetting: float = 0.05  # EWMA factor for the PF average rate
    # Demand-driven UL: grant PUSCH only to UEs with a BSR backlog or a
    # pending SR (the reference's uci_scheduling/ue grant flow).  Off by
    # default: the loopback tests pair every DL grant with a UL grant.
    ul_demand_driven: bool = False
    # NTN: cell-specific koffset (TS 38.213 section 4.2 NTN extensions) —
    # UL grants schedule PUSCH koffset slots after the DL slot that carried
    # them, absorbing the feeder-link round trip (see support.config
    # NtnConfig / configs/ntn_geo.yml).
    ntn_koffset: int = 0
    # Emit PDCCH PDUs carrying packed DCI 1_0 per DL grant (CORESET on
    # symbol 0).  Off by default to keep compile costs out of tests that
    # don't exercise the control channel.
    emit_dci: bool = False
    coreset_rb_count: int = 24
    # Real CCE-level PDCCH allocation (l2sim/pdcch_alloc): every grant
    # consumes a search-space candidate; UEs whose candidates all collide
    # are skipped this slot (the reference pdcch_resource_allocator flow).
    use_pdcch_alloc: bool = False
    # Real PUCCH resource allocation + UCI multiplexing (l2sim/pucch_alloc
    # + uci_alloc): DL grants book an HARQ-ACK resource k1 slots later;
    # UCI rides PUSCH when the UE has one.
    use_pucch_alloc: bool = False
    k1: int = 4  # DL slot -> HARQ-ACK UL slot delay
    # Periodic SRS scheduling (l2sim/srs_alloc slot wheel, the reference
    # srs_scheduler_impl role): each UE sounds every period at its offset.
    use_srs: bool = False
    # UE-context loops (reference lib/scheduler/ue_context):
    # - TA maintenance (ta_manager.cpp): windowed estimator-TA measurements
    #   -> TA-command MAC CEs queued per UE (pop via pop_ta_cmds()).
    # - DRX (ue_drx_controller.cpp): onDuration/inactivity active-time
    #   gating of scheduling; pending SR keeps the UE schedulable.
    # - SRS-driven UL link adaptation (ue_channel_state_manager.cpp role):
    #   SRS wideband SNR selects the UL MCS.
    use_ta_manager: bool = False
    ta_manager_cfg: object | None = None  # ue_context_loops.TaManagerConfig
    scs_mu: int = 1
    drx: object | None = None  # ue_context_loops.DrxConfig
    # Measurement gaps (reference meas-gap gating): UEs with a gap config
    # are unschedulable during their gaps (no PDCCH/PUSCH/PUCCH).
    meas_gap: object | None = None  # ue_context_loops.MeasGapConfig
    srs_link_adaptation: bool = False

    @classmethod
    def from_reference(cls, ref) -> "SchedulerConfig":
        """Copy a reference (JAX package) ``SchedulerConfig`` field by field:
        the TDD pattern and the UE-context loop configs become the port's
        own classes."""
        from . import ue_context_loops as ucl

        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        if kw["tdd_pattern"] is not None:
            kw["tdd_pattern"] = TddPattern.from_reference(kw["tdd_pattern"])
        for name, twin in (("ta_manager_cfg", ucl.TaManagerConfig), ("drx", ucl.DrxConfig),
                           ("meas_gap", ucl.MeasGapConfig)):
            if kw[name] is not None:
                kw[name] = twin(**{f.name: getattr(kw[name], f.name)
                                   for f in dataclasses.fields(twin)})
        return cls(**kw)


class RoundRobinScheduler:
    """FDM round-robin: each slot splits the band evenly over up to K UEs.

    Mirrors scheduler_time_rr.cpp's role at simulator fidelity.
    """

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self.ues: dict[int, UeContext] = {}
        self._rr_offset = 0
        from . import srs_alloc as _srs

        self.srs_sched = _srs.SrsScheduler()
        # Closed-loop UL power control (reference pusch_power_controller,
        # enterprise-stubbed there; real loop in l2sim.power_control).
        from .power_control import PuschPowerController

        self.power_control = PuschPowerController()
        # CSI-driven link adaptation: attach a LinkAdaptor + the CSI report
        # config to close the CQI -> MCS loop (reference ue_link_adapter +
        # csi_report consumption in ue_context).
        self.link_adaptor = None
        self.csi_report_cfg = None
        if cfg.use_pdcch_alloc:
            from . import pdcch_alloc as pa

            nof_rbs = min((cfg.coreset_rb_count // 6) * 6, (cfg.nof_rb // 6) * 6) or 6
            self.coresets = {1: pa.CoresetConfig(id=1, rb_start=0, nof_rbs=nof_rbs,
                                                 duration=2)}
            self.search_spaces = {
                1: pa.SearchSpaceConfig(id=1, coreset_id=1, is_common=True,
                                        nof_candidates=(0, 0, 2, 1, 0)),
                2: pa.SearchSpaceConfig(id=2, coreset_id=1, is_common=False,
                                        nof_candidates=(0, 2, 2, 1, 0)),
            }
        if cfg.use_pucch_alloc:
            from . import pucch_alloc as pua

            self.pucch_cell_cfg = pua.default_pucch_cell_config(cfg.nof_rb)
            # ACKs booked by DL grants: ul_slot_count -> list of (rnti, pri).
            self._pending_acks: dict[int, list] = {}
        self.nof_pdcch_blocked = 0
        self.nof_pucch_blocked = 0
        # Optional MAC hook: called as tb_source(rnti, tbs_bits) -> uint8 bit
        # array for new transmissions.  When None, TBs are random fill (the
        # reference's DU test-mode behavior).
        self.tb_source = None

    def add_ue(self, rnti: int, mcs: int = 10, qos_weight: float = 1.0) -> UeContext:
        ue = UeContext(rnti=rnti, mcs=mcs, qos_weight=qos_weight)
        self.ues[rnti] = ue
        if self.cfg.use_srs:
            self.srs_sched.add_ue(rnti)
        from . import ue_context_loops as ucl

        if self.cfg.use_ta_manager:
            ue.ta_manager = ucl.TaManager(
                self.cfg.ta_manager_cfg or ucl.TaManagerConfig(),
                mu=self.cfg.scs_mu)
        if self.cfg.drx is not None:
            ue.drx = ucl.DrxController(self.cfg.drx, scs_mu=self.cfg.scs_mu)
        if self.cfg.meas_gap is not None:
            ue.meas_gap = ucl.MeasGapController(self.cfg.meas_gap,
                                                scs_mu=self.cfg.scs_mu)
        if self.cfg.use_srs:
            ue.srs_state = ucl.SrsChannelState(max_rank=self.cfg.nof_layers)
        return ue

    def pop_ta_cmds(self, rnti: int) -> list:
        """Drain the pending TA commands for a UE (queued by its
        TaManager); the DU-high sends each as a TA-command MAC CE."""
        ue = self.ues.get(rnti)
        if ue is None or not ue.pending_ta_cmds:
            return []
        cmds, ue.pending_ta_cmds = ue.pending_ta_cmds, []
        return cmds

    def _select_ues(self, active, n):
        """Pick n UEs: round robin, or proportional-fair with QoS weights
        (scheduler_time_qos.cpp's role: metric = weight * inst_rate / avg_rate)."""
        if self.cfg.policy == "rr":
            sel = [active[(self._rr_offset + i) % len(active)] for i in range(n)]
            self._rr_offset = (self._rr_offset + n) % len(active)
            return sel
        def metric(ue):
            qm, rate = tbs_mod.mcs_to_qm_rate(ue.mcs, ue.mcs_table)
            inst = qm * rate  # proxy for achievable rate
            return ue.qos_weight * inst / max(ue.avg_rate, 1e-6)
        ranked = sorted(active, key=metric, reverse=True)
        sel = ranked[:n]
        # EWMA update: selected UEs accrue their instantaneous rate.
        a = self.cfg.pf_forgetting
        for ue in active:
            qm, rate = tbs_mod.mcs_to_qm_rate(ue.mcs, ue.mcs_table)
            served = qm * rate if ue in sel else 0.0
            ue.avg_rate = (1 - a) * ue.avg_rate + a * served
        return sel

    def _grant_configs(self, ue: UeContext, rb_count: int, rv: int, first_rb: int = 0,
                       dl_layers: int | None = None):
        """Compact rb_start=0 configs: the grant is encoded on a window grid
        and placed at the PDU's first_rb with a dynamic slice.  crb_start
        repoints the window's DM-RS/PT-RS sequence index to the absolute CRB
        (TS 38.211 reference point = CRB0), so equal-size grants share the
        program *structure* but compile per distinct PRB offset (bounded by
        max_ues_per_slot since offsets are i*rb_each)."""
        qm, rate = tbs_mod.mcs_to_qm_rate(ue.mcs, ue.mcs_table)
        # UL direction may run its own MCS (SRS-driven link adaptation);
        # the shared ``mcs`` drives both when no UL estimate exists.
        ul_m = ue.ul_mcs if ue.ul_mcs is not None else ue.mcs
        ul_qm, ul_rate = tbs_mod.mcs_to_qm_rate(ul_m, ue.mcs_table)
        _MODS = {1: Modulation.BPSK, 2: Modulation.QPSK, 4: Modulation.QAM16,
                 6: Modulation.QAM64, 8: Modulation.QAM256}
        mod = _MODS[qm]
        c = self.cfg
        alloc = Allocation(rb_start=0, rb_count=rb_count, sym_start=c.sym_start,
                           sym_count=c.sym_count, dmrs_symbols=c.dmrs_symbols,
                           crb_start=first_rb)
        if dl_layers is None:
            dl_layers = c.nof_layers
        dl_tbs = tbs_mod.calculate_tbs(rb_count, c.sym_count, NRE * len(c.dmrs_symbols),
                                       rate, qm, dl_layers)
        ul_tbs = tbs_mod.calculate_tbs(rb_count, c.sym_count, NRE * len(c.dmrs_symbols),
                                       ul_rate, ul_qm, c.nof_layers)
        common = dict(alloc=alloc, nof_grid_symbols=14,
                      nof_grid_sc=rb_count * NRE, rv=rv)
        dl_cfg = PdschConfig(nof_ports=c.nof_ports, tbs=dl_tbs,
                             nof_layers=dl_layers, target_code_rate=rate,
                             modulation=mod, **common)
        ul_cfg = PuschConfig(nof_rx_ports=c.nof_ports, tbs=ul_tbs,
                             nof_layers=c.nof_layers, target_code_rate=ul_rate,
                             modulation=_MODS[ul_qm], **common)
        return dl_cfg, ul_cfg, dl_tbs, ul_tbs

    def run_slot(self, slot: SlotPoint, rng: np.random.Generator,
                 rb_offset: int = 0, pdcch_slot=None):
        """Produce (DlTtiRequest, TxDataRequest, UlTtiRequest, grants).

        With a TDD pattern, DL slots carry only PDSCH and UL slots only
        PUSCH; the special slot is idle in this simulator.

        ``rb_offset`` reserves PRBs [0, rb_offset) for earlier run_slot
        stages (fallback), and ``pdcch_slot`` is the slot's shared CCE
        allocator when one exists — together they form the per-slot shared
        resource map (the reference's cell_resource_allocator).
        """
        c = self.cfg
        tdd_dir = c.tdd_pattern.direction(slot.count) if c.tdd_pattern else None
        # Per-UE context loop ticks: DRX active-time windows open/expire and
        # TA measurement windows close (queueing TA-command MAC CEs).
        for ue in self.ues.values():
            if ue.drx is not None:
                ue.drx.sr_pending = ue.sr_pending
                ue.drx.slot_indication(slot.count)
            if ue.ta_manager is not None:
                cmd = ue.ta_manager.slot_indication(slot.count)
                if cmd is not None:
                    ue.pending_ta_cmds.append(cmd)
        # DRX + measurement gaps gate scheduling: only active-time UEs
        # outside their gaps are PDCCH-schedulable.
        active = [ue for ue in self.ues.values()
                  if (ue.drx is None or ue.drx.is_pdcch_enabled())
                  and (ue.meas_gap is None
                       or ue.meas_gap.is_schedulable(slot.count))]
        if not active or c.nof_rb - rb_offset < c.max_ues_per_slot:
            self.last_pdcch_slot = pdcch_slot
            return (fapi.DlTtiRequest(slot=slot), fapi.TxDataRequest(slot=slot),
                    fapi.UlTtiRequest(slot=slot), [])
        n = min(len(active), c.max_ues_per_slot)
        sel = self._select_ues(active, n)
        rb_each = (c.nof_rb - rb_offset) // n

        pdsch_pdus, payloads, pusch_pdus, grants = [], [], [], []
        pdcch_pdus = []
        if c.use_pdcch_alloc and pdcch_slot is None:
            from . import pdcch_alloc as pa

            pdcch_slot = pa.PdcchSlotAllocator(self.coresets, self.search_spaces)
        for i, ue in enumerate(sel):
            harq_id = slot.count % NOF_HARQ
            hp = ue.harqs[harq_id]
            if hp.active:
                hp.nof_tx += 1
                rv = RV_SEQUENCE[min(hp.nof_tx, 3)]
                new_data = False
                tb = hp.tb
                # Retransmissions reuse the first transmission's rank and
                # precoding (the TBS is rank-dependent).
                dl_layers, w = hp.dl_layers or c.nof_layers, hp.w
            else:
                rv = 0
                new_data = True
                tb = None
                # Rank adaptation: the CSI-reported rank (bounded by the
                # cell's configured layers) drives new transmissions.
                dl_layers = min(ue.dl_rank or c.nof_layers, c.nof_layers)
                w = ue.dl_precoding
            if w is None:
                w = np.eye(dl_layers, c.nof_ports, dtype=np.complex64)
            dl_cfg, ul_cfg, tbs, ul_tbs = self._grant_configs(
                ue, rb_each, rv, first_rb=rb_offset + i * rb_each,
                dl_layers=dl_layers)
            dl_pdcch = ul_pdcch = None
            if pdcch_slot is not None and tdd_dir != SlotDirection.UPLINK:
                # Aggregation level from link quality: poor MCS -> more CCEs.
                al = 8 if ue.mcs < 5 else (4 if ue.mcs < 15 else 2)
                dl_pdcch = pdcch_slot.alloc_dci(ue.rnti, 2, al,
                                                slot_index=slot.count % 20)
                if dl_pdcch is None:
                    self.nof_pdcch_blocked += 1
                    continue  # no PDCCH candidate free: skip the UE this slot
                ul_pdcch = pdcch_slot.alloc_dci(ue.rnti, 2, al,
                                                slot_index=slot.count % 20)
                if ul_pdcch is None:
                    self.nof_pdcch_blocked += 1
            if tb is None:
                if self.tb_source is not None:
                    tb = np.asarray(self.tb_source(ue.rnti, tbs), dtype=np.uint8)
                    assert tb.shape == (tbs,)
                else:
                    tb = rng.integers(0, 2, size=(tbs,), dtype=np.uint8)
                hp.active, hp.tb, hp.nof_tx = True, tb, 0
                hp.dl_layers, hp.w = dl_layers, w
            if ue.drx is not None and new_data:
                # New-transmission PDCCH (re)starts drx-InactivityTimer.
                ue.drx.on_new_tx_pdcch(slot.count)
            pdsch_pdus.append(fapi.DlPdschPdu(dl_cfg, ue.rnti, w, len(payloads),
                                              first_rb=rb_offset + i * rb_each))
            payloads.append(tb)
            if c.emit_dci:
                from ..phy.pdcch import PdcchConfig
                from ..ran import dci as dci_mod

                d = dci_mod.Dci10(rb_start=rb_offset + i * rb_each, rb_count=rb_each,
                                  mcs=ue.mcs, new_data=new_data, rv=rv,
                                  harq_id=harq_id)
                bits = dci_mod.pack_dci_1_0(d, c.nof_rb)
                al = dl_pdcch.aggregation_level if dl_pdcch is not None else 4
                cce = dl_pdcch.cce_index if dl_pdcch is not None else 4 * i
                # An allocated DCI describes the CORESET its CCEs were
                # chosen in.  The reference's PDU keeps a 1-symbol CORESET
                # there, whose CCEs stop at half the allocator's: its
                # PDCCH encoder fails on the upper CCEs (ROADMAP Q3).
                rb_count, duration = c.coreset_rb_count, 1
                if dl_pdcch is not None:
                    cs = self.coresets[dl_pdcch.coreset_id]
                    rb_count, duration = cs.nof_rbs, cs.duration
                pc = PdcchConfig(payload_bits=len(bits), aggregation_level=al,
                                 cce_index=cce, coreset_rb_start=0,
                                 coreset_rb_count=rb_count, duration=duration,
                                 n_id=1, n_rnti=ue.rnti,
                                 nof_grid_sc=c.nof_grid_sc)
                pdcch_pdus.append(fapi.DlPdcchPdu(pc, ue.rnti, bits))
            if c.use_pucch_alloc and tdd_dir != SlotDirection.UPLINK:
                # Book the HARQ-ACK PUCCH k1 slots later; the PRI cycles
                # over resource set 0 like the reference's DCI field.
                ack_slot = slot.count + c.k1
                self._pending_acks.setdefault(ack_slot, []).append(
                    (ue.rnti, i % 8))
            ul_wanted = (not c.ul_demand_driven) or ue.sr_pending \
                or ue.ul_buffer_bytes > 0 or hp.active and not new_data
            if ul_wanted and (pdcch_slot is None or ul_pdcch is not None
                              or tdd_dir == SlotDirection.UPLINK):
                pusch_pdus.append(fapi.UlPuschPdu(ul_cfg, ue.rnti, harq_id=harq_id,
                                                  new_data=new_data, first_rb=rb_offset + i * rb_each))
                grants.append((ue.rnti, harq_id, ul_tbs))
                ue.sr_pending = False
                ue.ul_buffer_bytes = max(0, ue.ul_buffer_bytes - ul_tbs // 8)
        if tdd_dir == SlotDirection.DOWNLINK:
            pusch_pdus = []
        elif tdd_dir == SlotDirection.UPLINK:
            pdsch_pdus, payloads = [], []
        elif tdd_dir == SlotDirection.SPECIAL:
            pdsch_pdus, payloads, pusch_pdus, grants = [], [], [], []
        if tdd_dir == SlotDirection.UPLINK or tdd_dir == SlotDirection.SPECIAL:
            pdcch_pdus = []
        # PUCCH + UCI multiplexing for this UL slot: due HARQ-ACKs, periodic
        # SR/CSI opportunities, PUSCH piggybacking.
        pucch_pdus = []
        if c.use_pucch_alloc and tdd_dir != SlotDirection.DOWNLINK:
            from . import pucch_alloc as pua
            from . import uci_alloc as ua
            from ..phy.pucch import PucchFormat1Config
            from ..phy.pucch_f2 import PucchFormat2Config

            pucch_slot = pua.PucchSlotAllocator(self.pucch_cell_cfg)
            pusch_rntis = {p.rnti for p in pusch_pdus}
            uci = ua.UciSlotAllocator(pucch_slot, pusch_rntis)
            for rnti, pri in self._pending_acks.pop(slot.count, []):
                if not uci.alloc_harq_ack(rnti, pri):
                    self.nof_pucch_blocked += 1
            sr_due, csi_due = ua.periodic_uci_opportunities(
                slot.count, ua.UciPeriodicConfig())
            for rnti, ue in self.ues.items():
                if sr_due and ue.sr_pending:
                    uci.alloc_sr(rnti)
                if csi_due:
                    uci.alloc_csi(rnti, 4)
            for rnti, g in pucch_slot.grants.items():
                res = g.resource
                if res.format == 1:
                    cfgp = PucchFormat1Config(
                        prb=res.prb, start_symbol=res.start_symbol,
                        nof_symbols=res.nof_symbols,
                        initial_cyclic_shift=res.initial_cyclic_shift,
                        occ_index=res.occ_index, n_id=1,
                        slot_in_frame=slot.count % 20,
                        nof_harq_bits=max(1, g.nof_harq_bits),
                        nof_grid_sc=c.nof_grid_sc)
                else:
                    cfgp = PucchFormat2Config(
                        rb_start=res.prb, rb_count=res.rb_count,
                        start_symbol=res.start_symbol,
                        nof_symbols=res.nof_symbols,
                        nof_uci_bits=max(1, g.uci_bits), rnti=rnti, n_id=1,
                        slot_in_frame=slot.count % 20,
                        nof_grid_sc=c.nof_grid_sc)
                pucch_pdus.append(fapi.UlPucchPdu(config=cfgp, rnti=rnti))
            self.last_uci_on_pusch = uci.on_pusch
        srs_pdus = []
        if c.use_srs and tdd_dir != SlotDirection.DOWNLINK:
            from ..phy.srs import SrsConfig

            for rnti, sc in self.srs_sched.due(slot.count):
                srs_pdus.append(fapi.UlSrsPdu(config=SrsConfig(
                    rb_start=0, rb_count=min(c.nof_rb, 48),
                    start_symbol=14 - sc.nof_symbols,
                    nof_symbols=sc.nof_symbols, comb=sc.comb,
                    comb_offset=sc.comb_offset, sequence_id=sc.sequence_id,
                    cyclic_shift=sc.cyclic_shift,
                    nof_grid_sc=c.nof_grid_sc), rnti=rnti))
        ul_slot = slot if not c.ntn_koffset else dataclasses.replace(
            slot, count=slot.count + c.ntn_koffset)
        # Expose this slot's PDCCH allocator so later stages (fallback) share
        # the CCE map instead of re-deriving a fresh, colliding one.
        self.last_pdcch_slot = pdcch_slot
        return (fapi.DlTtiRequest(slot=slot, pdsch=pdsch_pdus, pdcch=pdcch_pdus),
                fapi.TxDataRequest(slot=slot, payloads=payloads),
                fapi.UlTtiRequest(slot=ul_slot, pusch=pusch_pdus,
                                  pucch=pucch_pdus, srs=srs_pdus), grants)

    def handle_sr(self, rnti: int) -> None:
        """PUCCH SR detected (UCI indication) -> pend a UL grant."""
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.sr_pending = True

    def handle_bsr(self, rnti: int, nof_bytes: int) -> None:
        ue = self.ues.get(rnti)
        if ue is not None:
            ue.ul_buffer_bytes = nof_bytes
            if nof_bytes:
                ue.sr_pending = False

    def handle_results(self, res: fapi.SlotResults):
        """Consume CRC indications: ACK clears the HARQ, NACK keeps it for retx."""
        for crc in res.crc:
            ue = self.ues.get(crc.rnti)
            if ue is None:
                continue
            if self.power_control is not None and crc.snr_db is not None:
                self.power_control.handle_pusch_snr(crc.rnti, res.slot.count,
                                                    crc.snr_db)
            if self.link_adaptor is not None:
                self.link_adaptor.handle_crc(crc.rnti, crc.tb_crc_ok)
            if ue.ta_manager is not None and crc.ta_s is not None:
                ue.ta_manager.handle_ta_seconds(
                    crc.ta_s, crc.snr_db if crc.snr_db is not None else 100.0)
            hp = ue.harqs[crc.harq_id]
            if crc.tb_crc_ok:
                if hp.tb is not None:
                    ue.ul_bits_ok += len(hp.tb)
                hp.active, hp.tb, hp.nof_tx = False, None, 0
            elif hp.nof_tx >= 3:
                hp.active, hp.tb, hp.nof_tx = False, None, 0  # drop after 4 tx
        # SRS indications -> UL channel state (wideband SNR drives the UL
        # MCS when srs_link_adaptation is on; the SRS-reported TA also
        # feeds the TA manager like the reference's SRS-based TA source).
        for srs in getattr(res, "srs", ()) or ():
            ue = self.ues.get(srs.rnti)
            if ue is None or ue.srs_state is None:
                continue
            ue.srs_state.wideband_snr_db = srs.snr_db
            if self.cfg.srs_link_adaptation:
                from .link_adaptation import ul_mcs_from_snr

                # UL-only: writing the shared mcs would both clobber the
                # DL MCS and be overwritten by the CSI/OLLA adaptor in
                # the same indication batch.
                ue.ul_mcs = ul_mcs_from_snr(srs.snr_db, ue.mcs_table)
        if self.link_adaptor is not None and self.csi_report_cfg is not None:
            from ..ran import csi as _csi
            from ..ran import precoding as _prec

            cfg_csi = self.csi_report_cfg
            n1 = _csi.part1_bitwidth(cfg_csi)
            # Group this slot's UCI PDUs by rnti so a part-2 report can be
            # paired with its decoded part 1 (the part-1 RI sizes part 2).
            by_rnti: dict[int, list] = {}
            for uci in res.uci:
                bits = getattr(uci, "uci_bits", None)
                if uci.valid and bits is not None and uci.rnti in self.ues:
                    by_rnti.setdefault(uci.rnti, []).append(uci)
            for rnti, pdus in by_rnti.items():
                ue = self.ues[rnti]
                p1 = next((p for p in pdus if len(p.uci_bits) == n1), None)
                if p1 is None:
                    continue
                _cri, rank, cqi = _csi.unpack_part1(cfg_csi, p1.uci_bits)
                self.link_adaptor.handle_csi(rnti, cqi)
                ue.mcs = self.link_adaptor.select_mcs(rnti, fallback=ue.mcs)
                # Part 2 carries the PMI: close the spatial loop — reported
                # rank + Type-I codebook weights drive the next PDSCH
                # (reference: precoding_matrix_mapper + ue_context CSI).
                if not cfg_csi.has_pmi or cfg_csi.nof_csi_rs_ports < 2:
                    continue
                w2 = _csi.part2_bitwidth(cfg_csi, rank)
                p2 = next((p for p in pdus
                           if p is not p1 and len(p.uci_bits) == w2), None)
                if p2 is None or w2 == 0:
                    continue
                fields = _csi.unpack_part2(cfg_csi, rank, p2.uci_bits)
                ue.dl_rank = rank
                ue.dl_precoding = _prec.pmi_to_weights(
                    cfg_csi.nof_csi_rs_ports, rank, fields)

    def report(self) -> dict:
        return {
            rnti: {"ul_bits_ok": ue.ul_bits_ok,
                   "harq_active": sum(h.active for h in ue.harqs)}
            for rnti, ue in self.ues.items()
        }
