"""CU-CP mobility: inter-DU handover, RRC reestablishment, A3-event
measurement handling (reference lib/cu_cp mobility_manager +
cell_meas_manager roles).

The procedures of ``srsran_project_tpu/l3/mobility.py``, which attaches
them to ``CuCpSim`` when it is imported.  Here they are the ordinary
methods of ``MobilityMixin``, a base of ``CuCpSim``, so they exist whatever
was imported before.
"""

from __future__ import annotations

from . import messages as m
from .rrc import CuUeCtx, make_srb_pdcp


class MobilityMixin:
    """Handover, reestablishment and measurement-driven mobility of
    ``CuCpSim`` (uses its ``ues``, ``_by_du_id``, ``du_links``, ``to_cuup``,
    ``_send_rrc``, ``neighbor_cells`` and ``a3_offset_db``)."""

    # Mobility (the reference's cu_cp mobility manager + reestablishment routines)

    def start_handover(self, cu_ue_id: int, target_du_id: int,
                       target_du_ue_id: int, target_pci: int = 2) -> None:
        """Inter-DU handover: UE context on the target, path switch, sync reconfig."""
        ctx = self.ues[cu_ue_id]
        ctx.ho_target = (target_du_id, target_du_ue_id)
        ctx.ho_pci = target_pci
        # bind the target (du, du_ue_id) now: the target's UeContextSetupResponse
        # and the UE's post-sync UL RRC both route by it
        self._by_du_id[(target_du_id, target_du_ue_id)] = ctx
        self.du_links[target_du_id](m.encode(m.UeContextSetupRequest(
            gnb_cu_ue_id=ctx.cu_ue_id, gnb_du_ue_id=target_du_ue_id,
            srbs_to_setup=[{"srb_id": 1}],
            drbs_to_setup=[{"drb_id": d["drb_id"], "lcid": 4, "rlc_mode": "am",
                            "f1u_ul_teid": d["f1u_ul_teid"]} for d in ctx.drbs])))

    def _continue_handover(self, ctx: CuUeCtx, msg) -> None:
        """Target DU admitted the UE: switch the F1-U DL path at the CU-UP, then
        send reconfigurationWithSync via the source DU."""
        if ctx.cu_up_ue_id is not None:
            self.to_cuup(m.encode(m.BearerContextModificationRequest(
                gnb_cu_up_ue_id=ctx.cu_up_ue_id, drb_f1u_dl_teids=msg.drbs_setup)))
        # mark the state before sending: the UE's ReconfigurationComplete (and
        # with it _finish_handover) can arrive synchronously from _send_rrc
        ctx.state = "handover"
        self._send_rrc(ctx, m.RrcReconfiguration(
            drb_configs=[{"drb_id": d["drb_id"], "qfi": s.get("qfi", 9),
                          "pdcp_sn_bits": 18, "rlc_mode": "am", "lcid": 4}
                         for d, s in zip(msg.drbs_setup,
                                         ctx.pending_sessions or [{}] * len(msg.drbs_setup))],
            meas_config={"reconfiguration_with_sync": {"target_pci": ctx.ho_pci}}))

    def _finish_handover(self, ctx: CuUeCtx) -> None:
        """ReconfigurationComplete arrived via the target: release the source."""
        src_du, src_due = ctx.du_id, ctx.du_ue_id
        t_du, t_due = ctx.ho_target
        ctx.du_id, ctx.du_ue_id = t_du, t_due
        ctx.ho_target = None
        ctx.state = "connected"
        self._by_du_id.pop((src_du, src_due), None)
        self.du_links[src_du](m.encode(m.UeContextReleaseCommand(
            gnb_cu_ue_id=ctx.cu_ue_id, gnb_du_ue_id=src_due)))

    def handle_reestablishment(self, du_id: int, du_ue_id: int,
                               req: m.RrcReestablishmentRequest) -> bool:
        """Re-anchor an existing UE context after radio link failure (TS 38.331
        5.3.7): rebind to the new DU UE context, restart SRB1 PDCP with the
        same keys (sim deviation: spec derives new keys via NCC), confirm with
        RrcReestablishment."""
        ctx = next((c for c in self.ues.values() if c.c_rnti == req.rnti), None)
        if ctx is None:
            return False
        self._by_du_id.pop((ctx.du_id, ctx.du_ue_id), None)
        ctx.du_id, ctx.du_ue_id = du_id, du_ue_id
        self._by_du_id[(du_id, du_ue_id)] = ctx
        ctx.srb1_pdcp = make_srb_pdcp(ctx.k_gnb, ctx.nea, ctx.nia, is_cu_side=True)
        ctx.state = "reestablishing"
        self._send_rrc(ctx, m.RrcReestablishment(), protect=False)
        return True

    def add_neighbor(self, pci: int, du_id: int, allocate_target_ue) -> None:
        """Register a neighbor cell for measurement-driven mobility.

        allocate_target_ue() -> target gnb_du_ue_id on that DU (the du_manager
        ue-creation hook; in the sims this is DuF1Sim.allocate_ue bound to the
        UE's DL delivery callback)."""
        self.neighbor_cells[pci] = (du_id, allocate_target_ue)

    def _handle_measurement_report(self, ctx: CuUeCtx, rep) -> None:
        """A3-style decision (cell_meas_manager role): hand over when a known
        neighbor beats the serving cell by the hysteresis offset."""
        if ctx.ho_target is not None or not rep.results:
            return
        serving = rep.results[0]
        best = max(rep.results[1:], key=lambda r: r["rsrp_dbm"], default=None)
        if best is None or best["rsrp_dbm"] < serving["rsrp_dbm"] + self.a3_offset_db:
            return
        target = self.neighbor_cells.get(best["pci"])
        if target is None or target[0] == ctx.du_id:
            return
        du_id, allocate = target
        self.start_handover(ctx.cu_ue_id, du_id, allocate(), target_pci=best["pci"])
