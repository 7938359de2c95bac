"""``models.cell.encode_slot`` on ``slots_per_call`` payloads a call of the
configuration's one UE on the whole carrier, synchronized after each
call; one random unitary precoder a run.  The pool holds ``pool_units``
calls' distinct payloads and RNTIs."""

from __future__ import annotations

import torch

from portbench.harness import cells
from portbench.reference import link, nr

CONFIG_KEYS: frozenset = frozenset()
TRAFFIC_KEYS = frozenset({"slots_per_call"})


class Entry(cells.SingleUe):
    def __init__(self, config, traffic, seed, dev):
        super().__init__(config, traffic, seed, dev)
        g = self.grant
        self.precoding = cells.channel("flat_orthonormal").draw(
            self.gen, 1, g.layers, g.nof_ports, dev, {})[0]

    def generate(self, unit: int, step: int, prev):
        return self.unit_slice(self.tb, unit), self.unit_slice(self.rnti, unit)

    def dispatch(self, args):
        from srsran_project_tpu_torch.models import cell

        return cell.encode_slot(args[0], args[1], self.precoding, self.cfg)

    def readback(self, out):
        cells.sync(self.dev)

    def expected(self, units: list, rnd: link.Precision) -> dict:
        out = {}
        for u in units:
            grid = link.port_grid(self.unit_slice(self.tb, u), self.unit_slice(self.rnti, u),
                                  self.precoding, self.grant, rnd=rnd)
            out[u] = [rnd(nr.ofdm_modulate(grid, self.scs, self.dft, self.fc))]
        return out

    def compare(self, got: dict, want: dict) -> dict:
        gap = 0.0
        for u in want:
            ref = want[u][0]
            rms = float(torch.sqrt((ref.abs() ** 2).mean()))
            gap = max(gap, float((got[u][0] - ref).abs().max()) / rms)
        return {"iq_gap": gap}

    def decoded_tbs(self, unit: int, step: int, reference: dict) -> list:
        return []
