"""``phy.ul_slot.process_slot`` on one slot of every UE of the
configuration a call, closed loop: each call's CRC verdicts are read back
before the next.  A pool unit is a pair of slots in which the
configuration's ``retransmitted_ue``, ``retransmitted_ue_atten_db`` below
the others, sends one TB at rv 0 and then at the traffic's ``retx_rv``,
combined with the HARQ buffer that the first call returned; the other UEs
send new TBs in both.  The pool holds ``pool_units`` distinct pairs."""

from __future__ import annotations

import dataclasses

import torch

from portbench.harness import cells
from portbench.reference import link, nr

CONFIG_KEYS = frozenset({"retransmitted_ue", "retransmitted_ue_atten_db"})
TRAFFIC_KEYS = frozenset({"retx_rv"})


class Entry(cells.Entry):
    calls_per_unit = 2
    ldpc_kernel = "K2"  # decode of dematched buffers, one launch per code group

    def __init__(self, config, traffic, seed, dev):
        super().__init__(config, traffic, seed, dev)
        from srsran_project_tpu_torch.phy import ul_slot

        self.pdu_cls = ul_slot.UlSlotPdu
        self.ues = cells.ue_layout(config)
        self.retx = int(config["retransmitted_ue"])
        self.rvs = (0, int(traffic["retx_rv"]))
        # Per step, per UE: the reference grant and the program's config.
        self.grants, self.cfgs = [], []
        for rv in self.rvs:
            gs, cs = [], []
            for i, ue in enumerate(self.ues):
                r = rv if i == self.retx else 0
                gs.append(cells.grant(config, ue, r))
                pc = cells.program_cell(config, ue).pusch_cfg
                cs.append(dataclasses.replace(
                    pc, alloc=dataclasses.replace(pc.alloc, crb_start=ue["first_rb"]), rv=r))
            cells.check_geometry(config, gs, [c.tbs for c in cs])
            self.grants.append(gs)
            self.cfgs.append(cs)
        nu, p = self.units, config["nof_rx_ports"]
        nsc = config["carrier"]["nof_rb"] * nr.NRE
        sigma = cells.sigma(config)
        self.rnti = cells.rntis(self.gen, (nu, len(self.ues)), dev)
        self.rnti_host = self.rnti.tolist()
        self.grid = sigma * torch.randn((nu, 2, p, 14, nsc), generator=self.gen, device=dev,
                                        dtype=torch.complex64)
        atten = 10.0 ** (-float(config["retransmitted_ue_atten_db"]) / 20.0)
        for i, ue in enumerate(self.ues):
            g0 = self.grants[0][i]
            tb = torch.randint(0, 2, (nu, 2, g0.tbs), generator=self.gen, device=dev,
                               dtype=torch.uint8)
            if i == self.retx:  # one TB, sent twice
                tb[:, 1] = tb[:, 0]
            chan = self.draw_channel(nu, ue["layers"], p)
            if i == self.retx:
                chan = chan * atten
            sc0 = ue["first_rb"] * nr.NRE
            for step in range(2):
                g = self.grants[step][i]
                grid_l = link.layer_grid(tb[:, step], self.rnti[:, i], g)
                self.grid[:, step, :, :, sc0:sc0 + g.nsc] += self.channel.apply(chan, grid_l)

    def generate(self, unit: int, step: int, prev):
        harq = prev[self.retx]["harq_buffer"] if step else None
        pdus = [self.pdu_cls(rnti=self.rnti_host[unit][i], first_rb=ue["first_rb"],
                             config=self.cfgs[step][i],
                             harq_buffer=harq if i == self.retx else None)
                for i, ue in enumerate(self.ues)]
        return self.grid[unit, step], pdus

    def dispatch(self, args):
        from srsran_project_tpu_torch.phy import ul_slot

        return ul_slot.process_slot(args[0], args[1])[0]

    def readback(self, out):
        return torch.stack([r["tb_crc_ok"] for r in out]).cpu()

    def expected(self, units: list, rnd: link.Precision) -> dict:
        """Per unit, per step, per UE the reference's results; each UE's
        grants of all the units in one batch, the retransmission combined
        with the reference's own first-step HARQ buffer."""
        idx = torch.tensor(units, device=self.dev)
        per_step, harq = [], None
        for step in range(2):
            res = []
            for i, ue in enumerate(self.ues):
                g = self.grants[step][i]
                sc0 = ue["first_rb"] * nr.NRE
                win = self.grid[idx, step, :, :, sc0:sc0 + g.nsc]
                res.append(link.receive(win, self.rnti[idx, i], g,
                                        harq=harq if (step and i == self.retx) else None,
                                        rnd=rnd))
            harq = res[self.retx]["harq_buffer"]
            per_step.append(res)
        return {u: [[{k: v[j:j + 1] for k, v in r.items()} for r in res] for res in per_step]
                for j, u in enumerate(units)}

    def compare(self, got: dict, want: dict) -> dict:
        pairs, harq_diff = [], 0
        for u in want:
            for step in range(2):
                for r, ref in zip(got[u][step], want[u][step]):
                    pairs.append((cells.batched(r), ref))
                    harq_diff += int((r["harq_buffer"] != ref["harq_buffer"][0]).sum())
        return {**cells.compare_ul(pairs), "harq_mismatch": harq_diff}

    def decoded_tbs(self, unit: int, step: int, reference: dict) -> list:
        return [(g, ref["iterations_needed"][0])
                for g, ref in zip(self.grants[step], reference[unit][step])]
