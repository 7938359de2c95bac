"""PUCCH format 2: UCI on QPSK with DM-RS, encode (UE side, for loopback)
and demodulate + decode (gNB side).

Port of ``srsran_project_tpu/phy/pucch_f2.py``.  Layout per TS 38.211
§6.3.2.5 / §6.4.1.3.2: data on REs k mod 3 != 1, DM-RS on k mod 3 == 1 of
every allocated PRB, 1-2 symbols (``_re_layout`` and ``_dmrs_pilots`` are
host plans copied from the reference); scrambling with c_init = rnti 2^15
+ n_id; UCI coded with ``ops.uci``.  ``process`` estimates the channel
from the DM-RS (``estimate_channel``, per symbol with a second hop),
combines the P ports by MRC, demaps QPSK, descrambles and decodes.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling, uci
from ..ops._tables import device_table
from ..ops.estimator import estimate_channel
from ..ops.modulation import Modulation, demap_soft, map_bits
from ..ran.constants import NRE
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


@functools.lru_cache(maxsize=None)
def _re_layout(cfg: PucchFormat2Config):
    data, dmrs = [], []
    for si, sym in enumerate(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)):
        rb0 = cfg.rb_start_of(si)
        for rb in range(rb0, rb0 + cfg.rb_count):
            for re in range(NRE):
                k = sym * cfg.nof_grid_sc + rb * NRE + re
                (dmrs if re % 3 == 1 else data).append(k)
    return np.asarray(data, np.int32), np.asarray(dmrs, np.int32)


def _dmrs_pilots(cfg: PucchFormat2Config) -> np.ndarray:
    """(nsym, 4*rb_count) QPSK pilots (TS 38.211 §6.4.1.3.2.1)."""
    out = []
    for si, sym in enumerate(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)):
        c_init = ((1 << 17) * (14 * cfg.slot_in_frame + sym + 1) * (2 * cfg.n_id0 + 1)
                  + 2 * cfg.n_id0) % (1 << 31)
        # Pilot index counts 4 per PRB from CRB0, at this symbol's hop.
        rb0 = cfg.rb_start_of(si)
        n0 = rb0 * 4
        n1 = (rb0 + cfg.rb_count) * 4
        c = scrambling.gold_ref(c_init, 2 * n1)
        re = 1.0 - 2.0 * c[0::2].astype(np.float32)
        im = 1.0 - 2.0 * c[1::2].astype(np.float32)
        out.append(((re + 1j * im) / np.sqrt(2))[n0:n1])
    return np.stack(out).astype(np.complex64)


def _c_init(cfg: PucchFormat2Config) -> int:
    return (cfg.rnti << 15) + cfg.n_id


_layout_on = device_table(lambda cfg, which: _re_layout(cfg)[which].astype(np.int64))
_pilots_on = device_table(_dmrs_pilots)


def generate(cfg: PucchFormat2Config, bits, device: torch.device | str = "cuda") -> torch.Tensor:
    """UE-side grid (14, nsc) complex64 on ``device`` for loopback: the
    (nof_uci_bits,) payload encoded, scrambled, QPSK-mapped, with DM-RS."""
    device = torch.device(device)
    coded = uci.encode_uci(torch.as_tensor(bits, dtype=torch.uint8, device=device),
                           cfg.nof_coded_bits)
    scr = scrambling.scramble_bits(coded, torch.tensor(_c_init(cfg), device=device))
    grid = torch.zeros(14 * cfg.nof_grid_sc, dtype=torch.complex64, device=device)
    grid[_layout_on(device, cfg, 0)] = map_bits(scr, Modulation.QPSK)
    grid[_layout_on(device, cfg, 1)] = _pilots_on(device, cfg).reshape(-1)
    return grid.reshape(14, cfg.nof_grid_sc)


@functools.lru_cache(maxsize=None)
def _data_subcarriers(cfg: PucchFormat2Config) -> tuple:
    """Per symbol: the data REs' subcarriers relative to that symbol's hop."""
    data_idx, _ = _re_layout(cfg)
    per_sym = cfg.rb_count * 8
    return tuple((data_idx[si * per_sym : (si + 1) * per_sym] % cfg.nof_grid_sc)
                 - cfg.rb_start_of(si) * NRE for si in range(cfg.nof_symbols))


_sc_on = device_table(lambda cfg, si: _data_subcarriers(cfg)[si].astype(np.int64))


def process(grid: torch.Tensor, cfg: PucchFormat2Config):
    """(P, nsym, nsc) received grid -> (uci_bits (nof_uci_bits,) uint8, ok
    bool, snr_db float32), in the span ``pucch.f2`` (counts ``occasions``
    and the UCI code: ``polar`` or ``short_block``)."""
    with l1_tracer.span("pucch.f2") as span:
        short = cfg.nof_uci_bits <= 11
        span.count(occasions=1, polar=int(not short), short_block=int(short))
        return _process(grid, cfg)


def _process(grid: torch.Tensor, cfg: PucchFormat2Config):
    p = cfg.nof_rx_ports
    dev = grid.device
    gflat = grid.reshape(p, -1)
    # Channel estimate from the DM-RS: pilots at k % 3 == 1, 4 per PRB.
    y_p = gflat[:, _layout_on(dev, cfg, 1)].reshape(p, cfg.nof_symbols, -1)
    ref = _pilots_on(dev, cfg)[None]  # (1, nsym, Np)
    wf = torch.ones(y_p.shape[-1], dtype=torch.float32, device=dev)
    pair_pos = tuple(float((3 * i + 1 + 3 * (i + 1) + 1) / 2)
                     for i in range(0, y_p.shape[-1], 2))  # pair centres in the allocation
    nof_sc = cfg.rb_count * NRE
    if cfg.second_hop_rb_start is None:
        h, nvar, metrics = estimate_channel(y_p, ref, wf, pair_pos, nof_sc)
        h_per_sym = [h] * cfg.nof_symbols
    else:
        # Frequency hopping: each symbol sees its own channel segment,
        # estimated from its own DM-RS.
        h_per_sym, nvars = [], []
        for si in range(cfg.nof_symbols):
            h_s, nvar_s, metrics = estimate_channel(y_p[:, si : si + 1], ref[:, si : si + 1], wf,
                                                    pair_pos, nof_sc)
            h_per_sym.append(h_s)
            nvars.append(nvar_s)
        nvar = torch.stack(nvars).mean(dim=0)

    # MRC across ports, per symbol hop.
    h_d = torch.cat([h_per_sym[si][:, _sc_on(dev, cfg, si)] for si in range(cfg.nof_symbols)],
                    dim=1)  # (P, Nd)
    y_d = gflat[:, _layout_on(dev, cfg, 0)]
    den = (h_d.abs() ** 2).sum(dim=0) + 1e-12
    x_hat = (h_d.conj() * y_d).sum(dim=0) / den
    llrs = demap_soft(x_hat, nvar.mean() / den, Modulation.QPSK)
    seq = scrambling.gold_sequence(torch.tensor(_c_init(cfg), device=dev), llrs.shape[-1])
    llrs = torch.where(seq == 1, -llrs, llrs)
    bits, ok = uci.decode_uci(llrs, cfg.nof_uci_bits)
    snr_db = 10.0 * torch.log10(torch.clamp_min(metrics["snr"].mean(), 1e-12))
    return bits, ok, snr_db
