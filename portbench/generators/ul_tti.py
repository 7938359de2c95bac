"""``phy.upper_phy.UpperPhy.process_ul_tti`` on one whole uplink slot a
call, as the DU sends it in one UL_TTI.request, closed loop: each call's
CRC, UCI and RACH indications are on the host when it returns.

The slot holds the configuration's PUSCH UEs (new data, from PRB
``pusch_first_rb``), its PUCCH F1 resources with their UEs
code-multiplexed by initial cyclic shift and OCC (UE i of the list on
resource i // 8 at shift (i % 8) // 2 and OCC i % 2; the ``dtx`` ones
allocated and silent), its PUCCH F2 CSI occasions and one PRACH occasion,
whose demodulated subcarriers come beside the grid.  Everything is sent
by the reference's transmitters (``portbench/reference``) through the
configuration's channel, one flat channel per UE and slot, the PUCCH UEs
``pucch_atten_db`` and the preambles ``prach_atten_db`` below the PUSCH;
AWGN at the configuration's SNR on the grid and on the PRACH subcarriers.
The pool holds ``pool_units`` distinct slots; the F2 RNTIs and the PRACH
root are the seed's, the rest is drawn per slot."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from portbench.harness import cells
from portbench.reference import link, nr
from portbench.reference import prach as ref_prach
from portbench.reference import pucch as ref_pucch

CONFIG_KEYS = frozenset({"pusch_first_rb", "pucch_f1", "pucch_f2", "prach", "pucch_atten_db",
                         "prach_atten_db"})
TRAFFIC_KEYS: frozenset = frozenset()
F1_KEYS = {"resources", "start_symbol", "nof_symbols", "n_id", "cyclic_shifts", "occ",
           "harq_bits", "dtx"}
F2_KEYS = {"occasions", "rb_count", "start_symbol", "nof_symbols", "n_id", "n_id0"}
F2_OCCASION_KEYS = {"rb_start", "nof_uci_bits"}
PRACH_KEYS = {"format", "first_rb", "nof_rb", "zero_correlation_zone", "nof_preambles",
              "max_delay_us", "dft_size", "window_fraction", "target_pfa"}
# The F1 DTX threshold of the detector this deployment runs (the program's
# ``pucch.F1_DTX_THRESHOLD``), applied to the reference's rho.
F1_DTX_THRESHOLD = 0.75
# Short preamble formats on one 30 kHz slot (TS 38.211 Table 6.3.3.1-2).
SHORT_FORMATS = ("A1", "A2", "A3", "B1", "B4", "C0", "C2")


def _keys(d: dict, allowed: set, where: str) -> None:
    if set(d) != allowed:
        raise ValueError(f"{where}: keys {sorted(set(d) ^ allowed)} are missing or read by no code")


def _upper_phy_class():
    """The program's ``UpperPhy`` that keeps each call's PUSCH results
    (noise variance and SINR per UE besides what the indications carry)."""
    from srsran_project_tpu_torch.phy import upper_phy

    class KeepingUpperPhy(upper_phy.UpperPhy):
        def _decode_pusch(self, request, rx_grid):
            outs, pucch_outs = super()._decode_pusch(request, rx_grid)
            self.pusch_outs = outs
            return outs, pucch_outs

    return KeepingUpperPhy


class Entry(cells.Entry):
    ldpc_kernel = "K2"  # the slot program's decode, one launch per code group

    def __init__(self, config, traffic, seed, dev):
        super().__init__(config, traffic, seed, dev)
        from srsran_project_tpu_torch.fapi import messages as fapi
        from srsran_project_tpu_torch.phy import prach, pucch, pucch_f2, upper_phy
        from srsran_project_tpu_torch.ran.constants import SubcarrierSpacing
        from srsran_project_tpu_torch.ran.slot_point import SlotPoint

        f1c, f2c, prc = config["pucch_f1"], config["pucch_f2"], config["prach"]
        _keys(f1c, F1_KEYS, "pucch_f1")
        _keys(f2c, F2_KEYS, "pucch_f2")
        for occ in f2c["occasions"]:
            _keys(occ, F2_OCCASION_KEYS, "pucch_f2 occasion")
        _keys(prc, PRACH_KEYS, "prach")
        if prc["format"] not in SHORT_FORMATS:
            raise ValueError(f"PRACH format {prc['format']}: the reference sends short preambles")
        nrb, p = config["carrier"]["nof_rb"], config["nof_rx_ports"]
        nsc, nu = nrb * nr.NRE, self.units
        self.nsc = nsc

        # PUSCH: the configuration's UEs from pusch_first_rb, new data.
        first = int(config["pusch_first_rb"])
        self.ues = [dict(ue, first_rb=ue["first_rb"] + first) for ue in cells.ue_layout(config)]
        self.grants = [cells.grant(config, ue) for ue in self.ues]
        cfgs = []
        for ue in self.ues:
            pc = cells.program_cell(config, ue).pusch_cfg
            cfgs.append(dataclasses.replace(
                pc, alloc=dataclasses.replace(pc.alloc, crb_start=ue["first_rb"])))
        cells.check_geometry(config, self.grants, [c.tbs for c in cfgs])

        # PUCCH F1: UE i on resource i // 8 at (shift, OCC) from its place.
        per_res = len(f1c["cyclic_shifts"]) * len(f1c["occ"])
        if len(f1c["harq_bits"]) != per_res * len(f1c["resources"]):
            raise ValueError("pucch_f1: one harq_bits entry per UE of every resource")
        self.f1 = []
        for i, nbits in enumerate(f1c["harq_bits"]):
            prb, hop = f1c["resources"][i // per_res]
            k = i % per_res
            self.f1.append(ref_pucch.F1(
                prb=prb, second_hop_prb=hop, start_symbol=f1c["start_symbol"],
                nof_symbols=f1c["nof_symbols"],
                cyclic_shift=f1c["cyclic_shifts"][k // len(f1c["occ"])],
                occ=f1c["occ"][k % len(f1c["occ"])], n_id=f1c["n_id"], nof_bits=nbits))
        self.dtx = {int(i) for i in f1c["dtx"]}

        # PUCCH F2: the seed's RNTIs, one a CSI report.
        f2_rnti = cells.rntis(self.gen, (len(f2c["occasions"]),), dev).tolist()
        self.f2 = [ref_pucch.F2(rb_start=o["rb_start"], rb_count=f2c["rb_count"],
                                start_symbol=f2c["start_symbol"], nof_symbols=f2c["nof_symbols"],
                                nof_bits=o["nof_uci_bits"], rnti=r, n_id=f2c["n_id"],
                                n_id0=f2c["n_id0"])
                   for o, r in zip(f2c["occasions"], f2_rnti)]

        # PRACH: the seed's root, two preambles a slot.
        self.prach = dict(prc, root=int(torch.randint(0, 138, (1,), generator=self.gen,
                                                      device=dev).item()))
        self._check_plan(nrb)

        # The received grids and PRACH subcarriers.
        sigma = cells.sigma(config)
        self.rnti = cells.rntis(self.gen, (nu, len(self.ues)), dev)
        self.grid = sigma * torch.randn((nu, p, 14, nsc), generator=self.gen, device=dev,
                                        dtype=torch.complex64)
        for i, (ue, g) in enumerate(zip(self.ues, self.grants)):
            tb = torch.randint(0, 2, (nu, g.tbs), generator=self.gen, device=dev,
                               dtype=torch.uint8)
            chan = self.draw_channel(nu, ue["layers"], p)
            sc0 = ue["first_rb"] * nr.NRE
            self.grid[..., sc0:sc0 + g.nsc] += self.channel.apply(
                chan, link.layer_grid(tb, self.rnti[:, i], g))
        atten = 10.0 ** (-float(config["pucch_atten_db"]) / 20.0)
        self.f1_bits = []
        for i, o in enumerate(self.f1):
            bits = torch.randint(0, 2, (nu, o.nof_bits), generator=self.gen, device=dev,
                                 dtype=torch.uint8)
            chan = atten * self.draw_channel(nu, 1, p)[:, 0]  # (nu, P)
            self.f1_bits.append(bits)
            if i in self.dtx:
                continue
            for sym, (prb, re) in ref_pucch.f1_transmit(o, bits).items():
                self.grid[:, :, sym, prb * nr.NRE:(prb + 1) * nr.NRE] += chan[..., None] * re[:, None]
        self.f2_bits = []
        for o in self.f2:
            bits = torch.randint(0, 2, (nu, o.nof_bits), generator=self.gen, device=dev,
                                 dtype=torch.uint8)
            chan = atten * self.draw_channel(nu, 1, p)[:, 0]
            self.f2_bits.append(bits)
            self.grid += chan[:, :, None, None] * ref_pucch.f2_transmit(o, bits, nsc)[:, None]
        self.prach_fd = sigma * torch.randn((nu, p, ref_prach.L_RA), generator=self.gen,
                                            device=dev, dtype=torch.complex64)
        npre = int(prc["nof_preambles"])
        self.preambles = torch.rand((nu, 64), generator=self.gen, device=dev).argsort(dim=-1)[
            :, :npre]
        delays = float(prc["max_delay_us"]) * 1e-6 * torch.rand(
            (nu, npre), generator=self.gen, device=dev)
        p_atten = 10.0 ** (-float(config["prach_atten_db"]) / 20.0)
        for j in range(npre):
            seqs = torch.stack([torch.from_numpy(ref_prach.preamble(
                self.prach["root"], prc["zero_correlation_zone"], int(x))).to(dev)
                for x in self.preambles[:, j].tolist()])
            chan = p_atten * self.draw_channel(nu, 1, p)[:, 0]
            ramp = ref_prach.delay_ramp(delays[:, j], 1e3 * self.scs)
            self.prach_fd += chan[..., None] * (seqs * ramp)[:, None]

        # The program's requests, one a pool unit.
        self.phy = _upper_phy_class()(upper_phy.UpperPhyConfig(
            nof_ports=p, nof_grid_symbols=14, nof_grid_sc=nsc, device=str(dev)))
        scs = SubcarrierSpacing(cells.SCS_INDEX[self.scs])
        f1_cfgs = [pucch.PucchFormat1Config(
            prb=o.prb, start_symbol=o.start_symbol, nof_symbols=o.nof_symbols,
            initial_cyclic_shift=o.cyclic_shift, occ_index=o.occ, n_id=o.n_id,
            nof_harq_bits=o.nof_bits, nof_grid_sc=nsc, second_hop_prb=o.second_hop_prb)
            for o in self.f1]
        f2_cfgs = [pucch_f2.PucchFormat2Config(
            rb_start=o.rb_start, rb_count=o.rb_count, start_symbol=o.start_symbol,
            nof_symbols=o.nof_symbols, nof_uci_bits=o.nof_bits, rnti=o.rnti, n_id=o.n_id,
            n_id0=o.n_id0, nof_rx_ports=p, nof_grid_sc=nsc) for o in self.f2]
        prach_cfg = prach.PrachConfig(
            l_ra=ref_prach.L_RA, root_sequence_index=self.prach["root"],
            zero_correlation_zone=prc["zero_correlation_zone"], nof_rx_ports=p,
            dft_size=prc["dft_size"], target_pfa=prc["target_pfa"])
        pucch_pdus = ([fapi.UlPucchPdu(c, 0x4001 + i) for i, c in enumerate(f1_cfgs)]
                      + [fapi.UlPucchPdu(c, c.rnti) for c in f2_cfgs])
        rnti_host = self.rnti.tolist()
        self.requests = [fapi.UlTtiRequest(
            slot=SlotPoint(scs, u * SlotPoint(scs, 0).slots_per_frame),
            pusch=[fapi.UlPuschPdu(c, rnti_host[u][i], harq_id=0, new_data=True,
                                   first_rb=ue["first_rb"])
                   for i, (c, ue) in enumerate(zip(cfgs, self.ues))],
            pucch=pucch_pdus, prach=[fapi.UlPrachPdu(prach_cfg)]) for u in range(nu)]

    def _check_plan(self, nrb: int) -> None:
        """Every PRB of the plan on the carrier and taken once."""
        taken: list = []
        for ue in self.ues:
            taken += range(ue["first_rb"], ue["first_rb"] + ue["nof_rb"])
        for prb, hop in {(o.prb, o.second_hop_prb) for o in self.f1}:
            taken += [prb] + ([hop] if hop is not None else [])
        for o in self.f2:
            taken += range(o.rb_start, o.rb_start + o.rb_count)
        taken += range(self.prach["first_rb"], self.prach["first_rb"] + self.prach["nof_rb"])
        if len(set(taken)) != len(taken) or min(taken) < 0 or max(taken) >= nrb:
            raise ValueError("the PRB plan overlaps itself or leaves the carrier")

    def generate(self, unit: int, step: int, prev):
        return self.requests[unit], self.grid[unit], self.prach_fd[unit]

    def dispatch(self, args):
        return self.phy.process_ul_tti(*args), self.phy.pusch_outs

    def readback(self, out):
        return [c.tb_crc_ok for c in out[0].crc]

    def expected(self, units: list, rnd: link.Precision) -> dict:
        """Per unit the reference's results, each receiver over all the
        units in one batch, in the form ``canonical`` gives."""
        idx = torch.tensor(units, device=self.dev)
        grid = rnd(self.grid[idx])
        pusch = []
        for i, (ue, g) in enumerate(zip(self.ues, self.grants)):
            sc0 = ue["first_rb"] * nr.NRE
            pusch.append(link.receive(grid[..., sc0:sc0 + g.nsc], self.rnti[idx, i], g, rnd=rnd))
        uci = []
        for o in self.f1:
            bits, rho = ref_pucch.f1_receive(grid, o, rnd)
            uci.append((bits, rho > F1_DTX_THRESHOLD, rho))
        uci += [ref_pucch.f2_receive(grid, o, rnd) for o in self.f2]
        pr = self.prach
        det = ref_prach.detect(rnd(self.prach_fd[idx]), pr["root"], pr["zero_correlation_zone"],
                               pr["dft_size"], pr["window_fraction"], pr["target_pfa"], rnd)
        host = [tuple(x.cpu() for x in u) for u in uci]
        return {u: [{"pusch": [{k: v[j:j + 1] for k, v in r.items()} for r in pusch],
                     "uci": [(b[j].numpy(), bool(ok[j]), float(m[j])) for b, ok, m in host],
                     "rach": (det["detected"][j].cpu().numpy(), det["delay"][j].cpu().numpy())}]
                for j, u in enumerate(units)}

    @staticmethod
    def canonical(out) -> dict:
        """A call's answer in the reference's form: the program's
        (indications, PUSCH results) or a reference result as it is."""
        if isinstance(out, dict):
            return out
        res, outs = out
        detected, delay = np.zeros(64, bool), np.zeros(64, np.float32)
        for r in res.rach:
            detected[r.preamble_index], delay[r.preamble_index] = True, r.ta_samples
        return {"pusch": [cells.batched(r) for r in outs],
                "uci": [(u.uci_bits, u.valid, u.metric) for u in res.uci],
                "rach": (detected, delay)}

    def compare(self, got: dict, want: dict) -> dict:
        pairs, bits = [], 0
        verdicts = prach = 0
        metric_gap = ta_gap = 0.0
        for u in want:
            g, w = self.canonical(got[u][0]), want[u][0]
            pairs += list(zip(g["pusch"], w["pusch"]))
            for (gb, gv, gm), (wb, wv, wm) in zip(g["uci"], w["uci"], strict=True):
                verdicts += int(bool(gv) != wv)
                bits += int((np.asarray(gb) != wb).sum()) if wv else 0
                metric_gap = max(metric_gap, abs(float(gm) - wm))
            (gd, gt), (wd, wt) = g["rach"], w["rach"]
            prach += int((gd != wd).sum())
            both = gd & wd
            if both.any():
                ta_gap = max(ta_gap, float(np.abs(gt[both] - wt[both]).max()))
        return {**cells.compare_ul(pairs), "uci_bit_mismatch": bits,
                "uci_verdict_mismatch": verdicts, "pucch_metric_gap": metric_gap,
                "prach_mismatch": prach, "prach_ta_gap": ta_gap}

    def decoded_tbs(self, unit: int, step: int, reference: dict) -> list:
        return [(g, ref["iterations_needed"][0])
                for g, ref in zip(self.grants, reference[unit][step]["pusch"])]
