"""PUCCH format 2: UCI on QPSK with DM-RS, encode (UE side, for loopback)
and demodulate + decode (gNB side).

Port of ``srsran_project_tpu/phy/pucch_f2.py``.  Layout per TS 38.211
§6.3.2.5 / §6.4.1.3.2: data on REs k mod 3 != 1, DM-RS on k mod 3 == 1 of
every allocated PRB, 1-2 symbols (``_re_layout`` and ``_dmrs_pilots`` are
host plans copied from the reference); scrambling with c_init = rnti 2^15
+ n_id; UCI coded with ``ops.uci``.  ``process_all`` receives every
occasion of a call at once through ``ops/pucch_f2_rx.receive``: it
estimates the channel from the DM-RS (per symbol with a second hop),
combines the P ports by MRC, demaps QPSK, descrambles and decodes; on a
CUDA grid in one launch of kernel K6.
"""

from __future__ import annotations

import dataclasses

import torch

from ..ops import pucch_f2_rx, scrambling, uci
from ..ops.modulation import Modulation, map_bits
from ..support.tracing import l1_tracer


@dataclasses.dataclass(frozen=True)
class PucchFormat2Config:
    rb_start: int
    rb_count: int
    start_symbol: int
    nof_symbols: int  # 1 or 2
    nof_uci_bits: int
    rnti: int
    n_id: int = 0  # data scrambling
    n_id0: int = 0  # DM-RS scrambling
    slot_in_frame: int = 0
    nof_rx_ports: int = 1
    nof_grid_sc: int = 624
    # Intra-slot frequency hopping (2-symbol F2 only): RB start of the
    # second symbol (reference format2_configuration.second_hop_prb).
    second_hop_rb_start: int | None = None

    def rb_start_of(self, sym_rel: int) -> int:
        if sym_rel > 0 and self.second_hop_rb_start is not None:
            return self.second_hop_rb_start
        return self.rb_start

    @property
    def nof_data_re(self) -> int:
        return self.rb_count * 8 * self.nof_symbols  # 8 data REs per PRB

    @property
    def nof_coded_bits(self) -> int:
        return self.nof_data_re * 2  # QPSK


# The host plans, shared with the receiver (``ops/pucch_f2_rx``).
_re_layout = pucch_f2_rx.re_layout
_dmrs_pilots = pucch_f2_rx.dmrs_pilots


def generate(cfg: PucchFormat2Config, bits, device: torch.device | str = "cuda") -> torch.Tensor:
    """UE-side grid (14, nsc) complex64 on ``device`` for loopback: the
    (nof_uci_bits,) payload encoded, scrambled, QPSK-mapped, with DM-RS."""
    device = torch.device(device)
    coded = uci.encode_uci(torch.as_tensor(bits, dtype=torch.uint8, device=device),
                           cfg.nof_coded_bits)
    scr = scrambling.scramble_bits(coded, torch.tensor(pucch_f2_rx.c_init(cfg), device=device))
    grid = torch.zeros(14 * cfg.nof_grid_sc, dtype=torch.complex64, device=device)
    grid[pucch_f2_rx.layout_on(device, cfg, 0)] = map_bits(scr, Modulation.QPSK)
    grid[pucch_f2_rx.layout_on(device, cfg, 1)] = pucch_f2_rx.pilots_on(device, cfg).reshape(-1)
    return grid.reshape(14, cfg.nof_grid_sc)


def process_all(grid: torch.Tensor, cfgs) -> list:
    """Every F2 occasion of ``cfgs`` on one (P, nsym, nsc) received grid ->
    per occasion (uci_bits (nof_uci_bits,) uint8, ok bool, snr_db
    float32), through ``pucch_f2_rx.receive`` (kernel K6 on a CUDA grid,
    one launch a call; the plain version on a CPU grid), in one span
    ``pucch.f2`` (counts ``occasions``, the UCI codes ``polar`` and
    ``short_block``, and ``kernel_occasions``, those K6 took)."""
    cfgs = tuple(cfgs)
    if not cfgs:
        return []
    with l1_tracer.span("pucch.f2") as span:
        short = sum(cfg.nof_uci_bits <= 11 for cfg in cfgs)
        span.count(occasions=len(cfgs), polar=len(cfgs) - short, short_block=short,
                   kernel_occasions=len(cfgs) if grid.device.type == "cuda" else 0)
        bits, ok, snr_db = pucch_f2_rx.receive(grid.contiguous(), cfgs)
        return [(bits[o, : cfg.nof_uci_bits], ok[o], snr_db[o]) for o, cfg in enumerate(cfgs)]


def process(grid: torch.Tensor, cfg: PucchFormat2Config):
    """One occasion: ``process_all(grid, [cfg])[0]``."""
    return process_all(grid, [cfg])[0]
