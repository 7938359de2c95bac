"""``models.cell.decode_slot`` on ``slots_per_call`` received slots a call
(unbatched when 1) of the configuration's one UE on the whole carrier,
closed loop: each call's CRC verdicts are read back before the next.  The
pool holds ``pool_units`` calls' distinct slots: payloads, RNTIs, the
configuration's channel per slot and AWGN."""

from __future__ import annotations

import torch

from portbench.harness import cells
from portbench.reference import link, nr

CONFIG_KEYS: frozenset = frozenset()
TRAFFIC_KEYS = frozenset({"slots_per_call"})


class Entry(cells.SingleUe):
    ldpc_kernel = "K1"  # rate dematch and decode of all the call's TBs in one launch

    def __init__(self, config, traffic, seed, dev):
        super().__init__(config, traffic, seed, dev)
        n, g = self.tb.shape[0], self.grant
        chan = self.draw_channel(n, g.layers, g.nof_ports)
        ns = nr.slot_nof_samples(self.scs, self.dft)
        self.iq = torch.empty((n, g.nof_ports, ns), dtype=torch.complex64, device=dev)
        sigma = cells.sigma(config)
        for lo in range(0, n, 8):
            sl = slice(lo, min(n, lo + 8))
            grid = self.channel.apply(chan[sl], link.layer_grid(self.tb[sl], self.rnti[sl], g))
            x = nr.ofdm_modulate(grid, self.scs, self.dft, self.fc)
            noise = torch.randn(x.shape, generator=self.gen, device=dev, dtype=torch.complex64)
            self.iq[sl] = x + sigma * noise
        self.rnti_host = self.rnti.tolist()

    def generate(self, unit: int, step: int, prev):
        if self.slots_per_call == 1:
            return self.iq[unit], self.rnti_host[unit]
        return self.unit_slice(self.iq, unit), self.unit_slice(self.rnti, unit)

    def dispatch(self, args):
        from srsran_project_tpu_torch.models import cell

        return cell.decode_slot(args[0], args[1], self.cfg)

    def readback(self, out):
        return out["tb_crc_ok"].cpu()

    def expected(self, units: list, rnd: link.Precision) -> dict:
        """Per unit the reference receiver's results on the unit's slots."""
        out = {}
        for u in units:
            iq, rnti = self.unit_slice(self.iq, u), self.unit_slice(self.rnti, u)
            grid = nr.ofdm_demodulate(rnd(iq), self.grant.nof_rb, self.scs, self.dft, self.fc)
            out[u] = [link.receive(grid, rnti, self.grant, rnd=rnd)]
        return out

    def compare(self, got: dict, want: dict) -> dict:
        return cells.compare_ul([(cells.batched(got[u][0]), want[u][0]) for u in want])

    def decoded_tbs(self, unit: int, step: int, reference: dict) -> list:
        return [(self.grant, n) for n in reference[unit][0]["iterations_needed"]]
