"""``phy.upper_phy.UpperPhy.process_dl_tti`` and then ``process_ul_dci``
onto its grid, on one whole downlink slot a call, as the DU sends it in one
DL_TTI.request, one TX_Data.request and one UL_DCI.request; synchronized
after the call.  The answer is the slot's (P, 14, nsc) grid, which the DU
hands to the fronthaul as it is (split 7.2): no OFDM.

The slot holds the configuration's PDSCH UEs (new data, from PRB
``pdsch_first_rb``, TBS at N_oh^PRB ``pdsch_x_overhead``), each with its own
precoder drawn by the configuration's channel module and rate matched
around the TRS: row-1 NZP-CSI-RS resources on port 0, one a symbol of
``trs.symbols``.  Each UE has a DCI 1_1 (in the DL_TTI.request) and a DCI
0_1 (in the UL_DCI.request) in the CORESET, the DL ones first, each at the
next CCE its aggregation level allows; data scrambled by n_ID = PCI and
n_RNTI = 0 (no pdcch-DMRS-ScramblingID).  The SSBs of ``ssb.indices`` sit
at CRB ``ssb.rb_start`` (k_SSB 0) from ``ssb.first_symbols``.  The PCI is
the seed's; the pool holds ``pool_units`` distinct slots (payloads, RNTIs,
precoders, DCI bits, SFN and MIB).

The reference (``portbench/reference``: ``dl``, ``pdcch``, ``ssb``) builds
the same slot's grid; the numbers compared are the largest IQ gap over the
reference's RMS and the REs that are empty on one side only."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import cells
from portbench.reference import dl as ref_dl
from portbench.reference import link, nr
from portbench.reference import pdcch as ref_pdcch
from portbench.reference import ssb as ref_ssb

CONFIG_KEYS = frozenset({"pdsch_first_rb", "pdsch_x_overhead", "trs", "coreset", "dci", "ssb"})
TRAFFIC_KEYS: frozenset = frozenset()
TRS_KEYS = {"row", "density", "k0", "symbols", "rb_start", "rb_count"}
CORESET_KEYS = {"symbol", "duration", "rb_start", "rb_count", "interleaved"}
DCI_KEYS = {"dl_bits", "ul_bits", "aggregation_levels"}
SSB_KEYS = {"l_max", "indices", "first_symbols", "rb_start"}


def _keys(d: dict, allowed: set, where: str) -> None:
    if set(d) != allowed:
        raise ValueError(f"{where}: keys {sorted(set(d) ^ allowed)} are missing or read by no code")


def _mib(gen: torch.Generator, sfn: int) -> np.ndarray:
    """24 MIB bits (TS 38.331): the message choice 0, the SFN's 6 MSBs,
    random subCarrierSpacingCommon, dmrs-TypeA-Position, pdcch-ConfigSIB1,
    cellBarred and intraFreqReselection, ssb-SubcarrierOffset 0 (k_SSB 0),
    the spare bit 0."""
    mib = torch.randint(0, 2, (24,), generator=gen, device=gen.device).cpu().numpy()
    mib = mib.astype(np.uint8)
    mib[0] = 0
    mib[1:7] = [(sfn >> s) & 1 for s in range(9, 3, -1)]
    mib[8:12] = 0
    mib[23] = 0
    return mib


class Entry(cells.Entry):
    def __init__(self, config, traffic, seed, dev):
        super().__init__(config, traffic, seed, dev)
        from srsran_project_tpu_torch.fapi import messages as fapi
        from srsran_project_tpu_torch.phy import allocation, pdcch, ssb, upper_phy
        from srsran_project_tpu_torch.ran import tbs as tbs_mod
        from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
        from srsran_project_tpu_torch.ran.slot_point import SlotPoint

        trs, cs, dci, sb = config["trs"], config["coreset"], config["dci"], config["ssb"]
        _keys(trs, TRS_KEYS, "trs")
        _keys(cs, CORESET_KEYS, "coreset")
        _keys(dci, DCI_KEYS, "dci")
        _keys(sb, SSB_KEYS, "ssb")
        if (trs["row"], trs["density"], trs["k0"]) != (1, 3, 0):
            raise ValueError("trs: the DL_TTI CSI-RS PDU carries row 1 at density 3 from k0 0")
        if sb["l_max"] != 8 or len(sb["indices"]) != len(sb["first_symbols"]):
            raise ValueError("ssb: the reference sends L_max 8, one first symbol an index")
        nrb, p = config["carrier"]["nof_rb"], config["nof_rx_ports"]
        nsc, nu = nrb * nr.NRE, self.units
        self.nsc, self.p = nsc, p
        self.pci = int(torch.randint(0, 1008, (1,), generator=self.gen, device=dev).item())

        # PDSCH: the configuration's UEs from pdsch_first_rb, rate matched
        # around the TRS REs on their PRBs.
        first, n_oh = int(config["pdsch_first_rb"]), int(config["pdsch_x_overhead"])
        self.ues = [dict(ue, first_rb=ue["first_rb"] + first) for ue in cells.ue_layout(config)]
        trs_lo, trs_hi = trs["rb_start"], trs["rb_start"] + trs["rb_count"]
        self.grants, cfgs = [], []
        for ue in self.ues:
            lo = max(trs_lo, ue["first_rb"]) - ue["first_rb"]
            hi = min(trs_hi, ue["first_rb"] + ue["nof_rb"]) - ue["first_rb"]
            g = dataclasses.replace(cells.grant(config, ue), n_id=self.pci)
            self.grants.append(ref_dl.DlGrant(
                **{f.name: getattr(g, f.name) for f in dataclasses.fields(link.Grant)},
                n_oh=n_oh, reserved=ref_dl.trs_res(trs["symbols"], trs["k0"], lo, max(hi - lo, 0))))
            pc = cells.program_cell(config, ue).pdsch_cfg
            pattern = allocation.RePattern(
                prbs=tuple(range(lo, hi)), re_mask=sum(1 << (trs["k0"] + 4 * j) for j in range(3)),
                symbol_mask=sum(1 << s for s in trs["symbols"]))
            cfgs.append(dataclasses.replace(
                pc, tbs=tbs_mod.calculate_tbs(ue["nof_rb"], pc.alloc.sym_count,
                                              nr.NRE * len(pc.alloc.dmrs_symbols),
                                              ue["rate"], ue["qm"], ue["layers"], overhead=n_oh),
                alloc=dataclasses.replace(pc.alloc, crb_start=ue["first_rb"]), n_id=self.pci,
                reserved=(pattern,) if hi > lo else ()))
        cells.check_geometry(config, self.grants, [c.tbs for c in cfgs])
        for g, c in zip(self.grants, cfgs):
            if g.g != c.sch.nof_total_bits:
                raise ValueError(f"G: reference {g.g}, program {c.sch.nof_total_bits}")

        # PDCCH: a DCI 1_1 and a DCI 0_1 a UE, DL first, each at the next
        # CCE its aggregation level allows.
        levels = list(dci["aggregation_levels"])
        if len(levels) != len(self.ues):
            raise ValueError("dci: one aggregation level a PDSCH UE")
        self.coreset = ref_pdcch.Coreset(rb_start=cs["rb_start"], rb_count=cs["rb_count"],
                                         symbol=cs["symbol"], duration=cs["duration"],
                                         interleaved=cs["interleaved"])
        self.dcis, cce = [], 0  # (ue, reference Dci)
        for bits in (dci["dl_bits"], dci["ul_bits"]):
            for i, lv in enumerate(levels):
                cce = -(-cce // lv) * lv
                self.dcis.append((i, ref_pdcch.Dci(bits=bits, level=lv, cce=cce, n_id=self.pci,
                                                   n_rnti=0)))
                cce += lv
        if cce > cs["rb_count"] * cs["duration"] // 6:
            raise ValueError(f"dci: {cce} CCEs in a CORESET of "
                             f"{cs['rb_count'] * cs['duration'] // 6}")
        self._check_plan(nrb, trs, sb)

        # The slot pool.
        self.rnti = cells.rntis(self.gen, (nu, len(self.ues)), dev)
        self.tb = [torch.randint(0, 2, (nu, g.tbs), generator=self.gen, device=dev,
                                 dtype=torch.uint8) for g in self.grants]
        self.w = [self.draw_channel(nu, g.layers, p) for g in self.grants]
        self.dci_bits = [torch.randint(0, 2, (nu, d.bits), generator=self.gen, device=dev,
                                       dtype=torch.uint8) for _, d in self.dcis]
        self.sfn = torch.randint(0, 1024, (nu,), generator=self.gen, device=dev).tolist()
        self.pbch = torch.from_numpy(np.stack([
            ref_ssb.payload_j(_mib(self.gen, s), s, hrf=0) for s in self.sfn])).to(dev)
        self.ssb = list(zip(sb["indices"], sb["first_symbols"]))
        self.ssb_sc0 = sb["rb_start"] * nr.NRE
        self.trs = trs

        # The program's requests, one set a pool unit; payloads on the host,
        # as the DU hands them over.
        self.phy = upper_phy.UpperPhy(upper_phy.UpperPhyConfig(
            nof_ports=p, nof_grid_symbols=14, nof_grid_sc=nsc, device=str(dev)))
        scs = SubcarrierSpacing(cells.SCS_INDEX[self.scs])
        per_frame = SlotPoint(scs, 0).slots_per_frame
        pd_cfgs = [pdcch.PdcchConfig(
            payload_bits=d.bits, aggregation_level=d.level, cce_index=d.cce,
            coreset_rb_start=cs["rb_start"], coreset_rb_count=cs["rb_count"],
            symbol=cs["symbol"], duration=cs["duration"], interleaved=cs["interleaved"],
            n_id=d.n_id, n_rnti=d.n_rnti, nof_grid_symbols=14, nof_grid_sc=nsc)
            for _, d in self.dcis]
        rnti_h = self.rnti.tolist()
        tb_h = [t.cpu().numpy() for t in self.tb]
        w_h = [w.cpu().numpy() for w in self.w]
        bits_h = [b.cpu().numpy() for b in self.dci_bits]
        pbch_h = self.pbch.cpu().numpy()
        nd = len(self.ues)
        self.requests = []
        for u in range(nu):
            slot = SlotPoint(scs, self.sfn[u] * per_frame)
            pdcch_pdus = [fapi.DlPdcchPdu(c, rnti_h[u][i], bits_h[k][u])
                          for k, (c, (i, _)) in enumerate(zip(pd_cfgs, self.dcis))]
            v = 2 * ((self.sfn[u] >> 2) & 1) + ((self.sfn[u] >> 1) & 1)
            dl = fapi.DlTtiRequest(
                slot=slot,
                pdsch=[fapi.DlPdschPdu(c, rnti_h[u][i], w_h[i][u], tb_index=i,
                                       first_rb=ue["first_rb"])
                       for i, (c, ue) in enumerate(zip(cfgs, self.ues))],
                pdcch=pdcch_pdus[:nd],
                ssb=[fapi.DlSsbPdu(ssb.SsbConfig(pci=self.pci, ssb_index=idx, l_max=8,
                                                 sfn_2lsb=v, hrf=0),
                                   pbch_h[u], first_subcarrier=self.ssb_sc0, first_symbol=sym)
                     for idx, sym in self.ssb],
                csi_rs=[fapi.DlCsiRsPdu(row=1, rb_start=trs["rb_start"],
                                        rb_count=trs["rb_count"], symbol=s,
                                        scrambling_id=self.pci) for s in trs["symbols"]])
            tx = fapi.TxDataRequest(slot=slot, payloads=[t[u] for t in tb_h])
            self.requests.append((dl, tx, fapi.UlDciRequest(slot=slot, pdcch=pdcch_pdus[nd:])))

    def _check_plan(self, nrb: int, trs: dict, sb: dict) -> None:
        """Every PRB on the carrier; the PDSCH PRBs taken once; the SSBs'
        PRBs clear of the PDSCH and the TRS; the CORESET's symbols clear of
        the PDSCH, the TRS and the SSBs."""
        pdsch_prbs: list = []
        for ue in self.ues:
            pdsch_prbs += range(ue["first_rb"], ue["first_rb"] + ue["nof_rb"])
        ssb_prbs = set(range(sb["rb_start"], sb["rb_start"] + ref_ssb.NSC // nr.NRE))
        trs_prbs = set(range(trs["rb_start"], trs["rb_start"] + trs["rb_count"]))
        cs, g = self.coreset, self.grants[0]
        cs_syms = set(range(cs.symbol, cs.symbol + cs.duration))
        busy_syms = (set(range(g.sym_start, g.sym_start + g.sym_count)) | set(trs["symbols"])
                     | {s + i for s in sb["first_symbols"] for i in range(ref_ssb.NSYM)})
        prbs = set(pdsch_prbs) | ssb_prbs | trs_prbs | set(range(cs.rb_start,
                                                                 cs.rb_start + cs.rb_count))
        if (len(set(pdsch_prbs)) != len(pdsch_prbs) or min(prbs) < 0 or max(prbs) >= nrb
                or ssb_prbs & (set(pdsch_prbs) | trs_prbs) or cs_syms & busy_syms):
            raise ValueError("the slot's plan overlaps itself or leaves the carrier")

    def generate(self, unit: int, step: int, prev):
        return self.requests[unit]

    def dispatch(self, args):
        dl, tx, ul_dci = args
        return self.phy.process_ul_dci(ul_dci, self.phy.process_dl_tti(dl, tx))

    def readback(self, out):
        cells.sync(self.dev)

    def expected(self, units: list, rnd: link.Precision) -> dict:
        """Per unit the reference's slot grid (P, 14, nsc)."""
        idx = torch.tensor(units, device=self.dev)
        b = len(units)
        grid = torch.zeros((b, self.p, 14, self.nsc), dtype=torch.complex64, device=self.dev)
        for i, (ue, g) in enumerate(zip(self.ues, self.grants)):
            sc0 = ue["first_rb"] * nr.NRE
            grid[..., sc0:sc0 + g.nsc] += ref_dl.pdsch(self.tb[i][idx], self.rnti[idx, i],
                                                       self.w[i][idx], g, rnd)
        for (i, d), bits in zip(self.dcis, self.dci_bits):
            grid[:, 0] += ref_pdcch.grid(self.coreset, d, bits[idx], self.rnti[idx, i], self.nsc,
                                         rnd=rnd)
        for j, u in enumerate(units):
            for ssb_index, sym in self.ssb:
                blk = ref_ssb.block(self.pbch[u:u + 1], self.pci, ssb_index, self.sfn[u], rnd)
                grid[j, 0, sym:sym + ref_ssb.NSYM, self.ssb_sc0:self.ssb_sc0 + ref_ssb.NSC] += \
                    blk[0]
        t = self.trs
        for s in t["symbols"]:
            grid[:, 0] += rnd(torch.from_numpy(ref_dl.csi_rs_row1(
                s, t["k0"], t["rb_start"], t["rb_count"], self.pci, self.nsc)).to(self.dev))
        return {u: [grid[j]] for j, u in enumerate(units)}

    def compare(self, got: dict, want: dict) -> dict:
        gap, occupancy = 0.0, 0
        for u in want:
            ref = want[u][0]
            prog = got[u][0].to(ref.device)
            rms = float(torch.sqrt((ref.abs() ** 2).mean()))
            gap = max(gap, float((prog - ref).abs().max()) / rms)
            occupancy += int(((prog == 0) != (ref == 0)).sum())
        return {"iq_gap": gap, "re_occupancy_mismatch": occupancy}

    def decoded_tbs(self, unit: int, step: int, reference: dict) -> list:
        return []
