"""NZP-CSI-RS generation (TS 38.211 section 7.4.1.5), mapping rows 1-18.

Port of ``srsran_project_tpu/phy/csi_rs.py``: the full Table 7.4.1.5.3-1
row set (1..32 ports, no-CDM / FD-CDM2 / CDM4 (FD2, TD2) / CDM8 (FD2, TD4)
with the Walsh covers of Tables 7.4.1.5.3-2..5) as per-port static RE
layouts.  The pilot values are a host plan per config (Gold sequences
seeded per OFDM symbol) written into the grid by index assignment.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling
from ..ops._tables import device_table
from ..ran.constants import NRE
from ..support.tracing import l1_tracer

# CDM cover codes: wf over k' (FD2), wt over l' (TD length 1/2/4)
_WF = np.array([[1.0, 1.0], [1.0, -1.0]])
_WT2 = np.array([[1.0, 1.0], [1.0, -1.0]])
_WT4 = np.array([[1, 1, 1, 1], [1, -1, 1, -1], [1, 1, -1, -1], [1, -1, -1, 1]], dtype=np.float64)

# row -> (nof_ki, cdm: "no"|"fd2"|"cdm4"|"cdm8", group symbol layout)
# group layout tokens: "l0", "l0+1", "l1", "l1+1" per the table's (kbar,lbar)
# list; groups are freq-major within each listed symbol.
_ROWS = {
    1: (1, "no", ("l0",)),       # special-cased density-3 below
    2: (1, "no", ("l0",)),
    3: (1, "fd2", ("l0",)),
    4: (2, "fd2", ("l0",)),      # kbar = k0, k0+2 handled via ki list
    5: (1, "fd2", ("l0", "l0+1")),
    6: (4, "fd2", ("l0",)),
    7: (2, "fd2", ("l0", "l0+1")),
    8: (2, "cdm4", ("l0",)),
    9: (6, "fd2", ("l0",)),
    10: (3, "cdm4", ("l0",)),
    11: (4, "fd2", ("l0", "l0+1")),
    12: (4, "cdm4", ("l0",)),
    13: (3, "fd2", ("l0", "l0+1", "l1", "l1+1")),
    14: (3, "cdm4", ("l0", "l1")),
    15: (3, "cdm8", ("l0",)),
    16: (4, "fd2", ("l0", "l0+1", "l1", "l1+1")),
    17: (4, "cdm4", ("l0", "l1")),
    18: (4, "cdm8", ("l0",)),
}
_CDM_SIZE = {"no": 1, "fd2": 2, "cdm4": 4, "cdm8": 8}
_CDM_FD = {"no": 1, "fd2": 2, "cdm4": 2, "cdm8": 2}
_CDM_TD = {"no": 1, "fd2": 1, "cdm4": 2, "cdm8": 4}


@dataclasses.dataclass(frozen=True)
class CsiRsConfig:
    """Twin of the reference's ``CsiRsConfig`` (same fields and defaults)."""

    rb_start: int
    rb_count: int
    symbol: int  # l0
    scrambling_id: int
    row: int = 1  # TS 38.211 Table 7.4.1.5.3-1 mapping row (1-18)
    k0: int = 0  # frequency-domain offset within the PRB (rows 1-3)
    ki: tuple[int, ...] = ()  # kbar list for multi-location rows (defaults spread)
    symbol2: int | None = None  # l1 for rows 13/14/16/17
    slot_in_frame: int = 0
    nof_grid_symbols: int = 14
    nof_grid_sc: int = 624

    @classmethod
    def from_reference(cls, ref) -> "CsiRsConfig":
        kw = {f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)}
        kw["ki"] = tuple(kw["ki"])
        return cls(**kw)

    @property
    def nof_ports(self) -> int:
        nof_ki, cdm, syms = _ROWS[self.row]
        return nof_ki * len(syms) * _CDM_SIZE[cdm]

    def _ki(self) -> tuple[int, ...]:
        nof_ki, cdm, _ = _ROWS[self.row]
        if self.ki:
            assert len(self.ki) == nof_ki
            return self.ki
        if self.row in (1, 2, 3):
            return (self.k0,)
        step = _CDM_FD[cdm]  # adjacent FD-CDM pairs packed by default
        return tuple(self.k0 + i * step for i in range(nof_ki))


def _c_init(cfg: CsiRsConfig, symbol: int) -> int:
    return ((1 << 10) * (14 * cfg.slot_in_frame + symbol + 1) * (2 * cfg.scrambling_id + 1)
            + cfg.scrambling_id) % (1 << 31)


def _symbol_of(token: str, cfg: CsiRsConfig) -> int:
    l1 = cfg.symbol2 if cfg.symbol2 is not None else cfg.symbol + 2
    return {"l0": cfg.symbol, "l0+1": cfg.symbol + 1,
            "l1": l1, "l1+1": l1 + 1}[token]


@functools.lru_cache(maxsize=None)
def _re_layout(cfg: CsiRsConfig):
    """Per-port lists of (symbol, flat grid idx, per-symbol seq idx, weight)."""
    nof_ki, cdm, sym_tokens = _ROWS[cfg.row]
    fd, td = _CDM_FD[cdm], _CDM_TD[cdm]
    rbs = range(cfg.rb_start, cfg.rb_start + cfg.rb_count)

    if cfg.row == 1:  # density 3: k0 + {0,4,8}, one symbol, one port
        offsets = [cfg.k0, cfg.k0 + 4, cfg.k0 + 8]
        sym = cfg.symbol
        ks, seq = [], []
        # Sequence index counts pilots from CRB0, not from rb_start
        # (reference nzp_csi_rs_generator_impl.cpp:86-97 PRG advance).
        for rb in rbs:
            for j, off in enumerate(offsets):
                ks.append(sym * cfg.nof_grid_sc + rb * NRE + off)
                seq.append(rb * 3 + j)
        return (((sym, np.asarray(ks, np.int32), np.asarray(seq, np.int32),
                  np.ones(len(ks), np.float32)),),)

    ki = cfg._ki()
    # groups: freq-major within each listed symbol token
    groups = [(k, tok) for tok in sym_tokens for k in ki]
    # per-symbol subcarrier offsets actually carrying CSI-RS (for seq idx)
    sym_offsets: dict[int, list[int]] = {}
    for k, tok in groups:
        base_l = _symbol_of(tok, cfg)
        for lp in range(td):
            offs = sym_offsets.setdefault(base_l + lp, [])
            for kp in range(fd):
                if k + kp not in offs:
                    offs.append(k + kp)
    for offs in sym_offsets.values():
        offs.sort()

    ports = []
    for g, (k, tok) in enumerate(groups):
        base_l = _symbol_of(tok, cfg)
        for s in range(_CDM_SIZE[cdm]):
            entries = {}
            wf = _WF[s % fd] if fd == 2 else np.ones(1)
            if td == 1:
                wt = np.ones(1)
            elif td == 2:
                wt = _WT2[s // fd]
            else:
                wt = _WT4[s // fd]
            for lp in range(td):
                sym = base_l + lp
                offs = sym_offsets[sym]
                kslist, seqlist, wlist = [], [], []
                # Pilot sequence index m' = fd*n + k' with n the absolute
                # PRB (counted from CRB0): every CDM group in a PRB shares
                # the same fd values — the per-symbol sequence length is
                # nof_rb*fd regardless of how many (kbar, lbar) locations
                # the row has (reference get_seq_len,
                # nzp_csi_rs_generator_impl.cpp:142-176).
                for rb in rbs:
                    for kp in range(fd):
                        kslist.append(sym * cfg.nof_grid_sc + rb * NRE + k + kp)
                        seqlist.append(rb * fd + kp)
                        wlist.append(float(wf[kp] * wt[lp]))
                entries[sym] = (np.asarray(kslist, np.int32), np.asarray(seqlist, np.int32),
                                np.asarray(wlist, np.float32))
            ports.append(tuple((sym, *v) for sym, v in sorted(entries.items())))
    return tuple(ports)


@functools.lru_cache(maxsize=None)
def _port_plan(cfg: CsiRsConfig, amplitude: float):
    """(flat indices into the (ports * nsym * nsc) grid, complex64 values):
    every port's REs with amplitude x pilot x CDM weight, each symbol's
    pilots from its own Gold sequence (as long as the longest any port
    needs on it)."""
    layout = _re_layout(cfg)
    nseq = max(int(seq_idx.max()) + 1 for port_entries in layout
               for _, _, seq_idx, _ in port_entries)
    n = cfg.nof_grid_symbols * cfg.nof_grid_sc
    pilots: dict[int, np.ndarray] = {}
    idx_all, val_all = [], []
    for p, port_entries in enumerate(layout):
        for sym, idx, seq_idx, w in port_entries:
            if sym not in pilots:
                c = scrambling.gold_ref(_c_init(cfg, sym), 2 * nseq).astype(np.float32)
                pilots[sym] = (((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)
                               ).astype(np.complex64)
            idx_all.append(p * n + idx.astype(np.int64))
            val_all.append(amplitude * pilots[sym][seq_idx] * w)
    return np.concatenate(idx_all), np.concatenate(val_all).astype(np.complex64)


_plan_on = device_table(lambda cfg, amplitude, which: _port_plan(cfg, amplitude)[which])


def generate(cfg: CsiRsConfig, amplitude: float = 1.0,
             device: torch.device | str = "cuda") -> torch.Tensor:
    """CSI-RS contribution on ``device`` as a (nof_ports, nsym, nsc)
    complex64 grid, squeezed to (nsym, nsc) for single-port rows.  The span
    ``csi_rs.generate`` counts ``resources`` and ``ports``."""
    with l1_tracer.span("csi_rs.generate") as span:
        dev = torch.device(device)
        nports = len(_re_layout(cfg))
        span.count(resources=1, ports=nports)
        grid = torch.zeros(nports * cfg.nof_grid_symbols * cfg.nof_grid_sc,
                           dtype=torch.complex64, device=dev)
        grid[_plan_on(dev, cfg, amplitude, 0)] = _plan_on(dev, cfg, amplitude, 1)
        grid = grid.reshape(nports, cfg.nof_grid_symbols, cfg.nof_grid_sc)
        return grid[0] if nports == 1 else grid
