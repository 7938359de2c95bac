"""UL-SCH demultiplexing: HARQ-ACK / CSI multiplexed with data on PUSCH
(TS 38.212 §6.2.7).

Port of ``srsran_project_tpu/phy/ulsch_demux.py``.  The RE placement is a
host plan per static config (``_layout``, the reference's per-OFDM-symbol
budgeting copied line for line and held equal to it by
tests/test_torch_uci.py):

* HARQ-ACK starts at l1 (the first data symbol after the first run of
  DM-RS symbols).  For 1-2 bit payloads the ACK REs are reserved (sized by
  ``g_ack_rvd``, the G of a 2-bit payload): data maps straight through
  them and the coded ACK bits then puncture the first G_ack of them.
  Larger payloads are rate-matched around.
* CSI part 1 starts at l0 (the first data symbol) and is always
  rate-matched around; it never maps onto reserved/ACK REs.  CSI part 2
  follows it and may use reserved REs.

``multiplex`` and ``demultiplex`` are gathers and index writes with those
plans on bit / LLR streams of G = nof_data_re * Qm * nof_layers.
``decode_csi_two_step`` decodes CSI part 1, then part 2 at the size its
RI selects (``ran/csi``).
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import uci as uci_mod
from ..ops._tables import device_table
from ..ran import csi as csi_mod
from . import allocation as alloc_mod


@dataclasses.dataclass(frozen=True)
class UlschMuxConfig:
    """Twin of the reference's ``UlschMuxConfig`` (same fields, defaults
    and derived values)."""

    alloc: alloc_mod.Allocation
    qm: int
    nof_layers: int
    nof_grid_symbols: int
    nof_grid_sc: int
    g_ack: int = 0  # coded HARQ-ACK bits (0 = none)
    g_csi1: int = 0  # coded CSI part-1 bits (0 = none)
    g_csi2: int = 0  # coded CSI part-2 bits (0 = none)
    nof_ack_bits: int = 0  # ACK payload size (selects puncture vs rate-match)
    g_ack_rvd: int = 0  # reserved-ACK layout bits (2-bit G); 0 -> use g_ack

    @property
    def g_total(self) -> int:
        return alloc_mod.nof_data_re(self.alloc) * self.qm * self.nof_layers

    @property
    def ack_punctures(self) -> bool:
        """1-2 bit ACK payloads puncture; larger payloads rate-match."""
        return self.nof_ack_bits <= 2

    @property
    def nof_data_bits(self) -> int:
        """SCH bits carried: G minus CSI minus (rate-matched ACK)."""
        g = self.g_total - self.g_csi1 - self.g_csi2
        if self.g_ack and not self.ack_punctures:
            g -= self.g_ack
        return g


def _select_every_d(avail: np.ndarray, d: int, count: int) -> np.ndarray:
    """Every d-th element of the available set, `count` picks (reference
    ulsch_demultiplex_impl re_set_select)."""
    return avail[::d][:count]


@functools.lru_cache(maxsize=None)
def _layout(cfg: UlschMuxConfig):
    """(ack_pos, csi_pos, csi2_pos, data_idx) bit indices into the G stream.

    Faithful host-side port of the reference's per-OFDM-symbol budgeting
    (ulsch_demultiplex_impl.cpp configure_current_ofdm_symbol, steps 1-5):
    per symbol, reserve ACK REs (<=2-bit payloads) or allocate ACK
    (>2 bits), then CSI1 avoiding reserved, then CSI2, with every-d-th-RE
    spreading and running bit remainders across symbols; <=2-bit ACK REs
    stride within the per-symbol reserved set and puncture whatever maps
    there.  ack_pos carries the actual coded ACK bit positions; data_idx
    enumerates the SCH stream (including reserved/punctured REs in
    puncture mode)."""
    a = cfg.alloc
    bpre = cfg.qm * cfg.nof_layers
    didx = alloc_mod.data_re_indices(a, cfg.nof_grid_symbols, cfg.nof_grid_sc)
    sym_of_re = np.asarray(didx) // cfg.nof_grid_sc
    symbols = list(range(a.sym_start, a.sym_start + a.sym_count))
    re_by_sym = {s: np.nonzero(sym_of_re == s)[0] for s in symbols}
    data_syms = [s for s in symbols if len(re_by_sym[s])]
    dmrs = sorted(a.dmrs_symbols)
    # l1: first symbol after the end of the first DM-RS run; l1_csi: first
    # data symbol (reference get_ulsch_demultiplex_l1/_l1_csi).
    end_first_dmrs = dmrs[0]
    while end_first_dmrs + 1 in dmrs:
        end_first_dmrs += 1
    after = [s for s in data_syms if s > end_first_dmrs]
    l1 = after[0] if after else data_syms[0]
    l1_csi = [s for s in data_syms if s not in dmrs][0]

    punct = cfg.ack_punctures
    g_rvd = (cfg.g_ack_rvd or cfg.g_ack) if punct else 0
    g_ack = cfg.g_ack
    g_csi1 = cfg.g_csi1
    g_csi2 = cfg.g_csi2

    m_rvd = m_ack = m_csi1 = m_csi2 = 0
    ack_res: list = []
    csi1_res: list = []
    csi2_res: list = []
    nondata_res: set = set()

    for s in data_syms:
        res = re_by_sym[s]  # indices into the data-RE enumeration
        is_dmrs_sym = s in dmrs
        uci = res if not is_dmrs_sym else res[:0]
        m_uci = len(uci)
        rvd_set = np.zeros(0, np.int64)

        # Step 1: reserve ACK REs (<=2-bit payloads).
        rem_rvd = (g_rvd - m_rvd) // bpre
        if punct and s >= l1 and m_uci > 0 and rem_rvd > 0:
            d, m_cnt = 1, m_uci
            if rem_rvd < m_uci:
                d, m_cnt = m_uci // rem_rvd, rem_rvd
            rvd_set = _select_every_d(uci, d, m_cnt)
            m_rvd += m_cnt * bpre

        # Step 2: allocate ACK (> 2-bit payloads).
        rem_ack = (g_ack - m_ack) // bpre
        if (not punct) and s >= l1 and m_uci > 0 and rem_ack > 0:
            d, m_cnt = 1, m_uci
            if rem_ack < m_uci:
                d, m_cnt = m_uci // rem_ack, rem_ack
            sel = _select_every_d(uci, d, m_cnt)
            ack_res += list(sel)
            nondata_res |= set(int(x) for x in sel)
            uci = np.asarray([r for r in uci if r not in set(sel)])
            m_uci = len(uci)
            m_ack += m_cnt * bpre

        # Step 3: CSI part 1 (avoids reserved REs).
        rem_csi1 = (g_csi1 - m_csi1) // bpre
        m_avail = m_uci - len(rvd_set)
        if s >= l1_csi and m_avail > 0 and rem_csi1 > 0:
            d, m_cnt = 1, m_avail
            if rem_csi1 < m_avail:
                d, m_cnt = m_avail // rem_csi1, rem_csi1
            cand = np.asarray([r for r in uci if r not in set(rvd_set)])
            sel = _select_every_d(cand, d, m_cnt)
            csi1_res += list(sel)
            nondata_res |= set(int(x) for x in sel)
            uci = np.asarray([r for r in uci if r not in set(sel)])
            m_uci = len(uci)
            m_csi1 += m_cnt * bpre

        # Step 3bis: CSI part 2 (may use reserved REs).
        rem_csi2 = (g_csi2 - m_csi2) // bpre
        if s >= l1_csi and m_uci > 0 and rem_csi2 > 0:
            d, m_cnt = 1, m_uci
            if rem_csi2 < m_uci:
                d, m_cnt = m_uci // rem_csi2, rem_csi2
            sel = _select_every_d(uci, d, m_cnt)
            csi2_res += list(sel)
            nondata_res |= set(int(x) for x in sel)
            uci = np.asarray([r for r in uci if r not in set(sel)])
            m_uci = len(uci)
            m_csi2 += m_cnt * bpre

        # Step 5: <=2-bit ACK strides within this symbol's reserved set.
        rem_ack = (g_ack - m_ack) // bpre
        m_rvd_sym = len(rvd_set)
        if punct and m_rvd_sym > 0 and rem_ack > 0:
            d, m_cnt = 1, m_rvd_sym
            if rem_ack < m_rvd_sym:
                d, m_cnt = m_rvd_sym // rem_ack, rem_ack
            ack_res += list(_select_every_d(rvd_set, d, m_cnt))
            m_ack += m_cnt * bpre

    def bits_of(res: list, limit: int) -> np.ndarray:
        if not res:
            return np.zeros(0, np.int32)
        arr = (np.asarray(sorted(res), np.int64)[:, None] * bpre
               + np.arange(bpre)[None, :]).reshape(-1)
        return arr[:limit].astype(np.int32)

    ack_pos = bits_of(ack_res, cfg.g_ack)
    csi_pos = bits_of(csi1_res, cfg.g_csi1)
    csi2_pos = bits_of(csi2_res, cfg.g_csi2)
    data_mask = np.ones(len(didx), dtype=bool)
    if nondata_res:
        data_mask[np.asarray(sorted(nondata_res))] = False
    data_re = np.nonzero(data_mask)[0]
    data_idx = (data_re[:, None] * bpre + np.arange(bpre)[None, :]) \
        .reshape(-1).astype(np.int32)
    return ack_pos, csi_pos, csi2_pos, data_idx


_layout_on = device_table(lambda cfg, which: _layout(cfg)[which].astype(np.int64))


def multiplex(data_bits: torch.Tensor, ack_bits: torch.Tensor | None,
              csi1_bits: torch.Tensor | None, cfg: UlschMuxConfig,
              csi2_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Build the transmitted G-bit streams: (..., nof_data_bits) SCH bits
    and the UCI PAYLOAD bits (encoded here with the UCI codec) -> (..., G)
    uint8.  ACK is written last so it punctures whatever occupies its
    reserved REs (data or CSI part 2)."""
    dev = data_bits.device
    out = torch.zeros(data_bits.shape[:-1] + (cfg.g_total,), dtype=torch.uint8, device=dev)
    out[..., _layout_on(dev, cfg, 3)] = data_bits.to(torch.uint8)
    for g, bits, which in ((cfg.g_csi1, csi1_bits, 1), (cfg.g_csi2, csi2_bits, 2),
                           (cfg.g_ack, ack_bits, 0)):
        if g:
            out[..., _layout_on(dev, cfg, which)] = uci_mod.encode_uci(bits.to(dev), g)
    return out


def demultiplex(llrs: torch.Tensor, cfg: UlschMuxConfig):
    """Split received (..., G) LLRs into (data_llrs, ack_llrs, csi1_llrs,
    csi2_llrs), None for an absent part.

    In puncture mode the ACK bit positions read 0 (erased) in the data and
    CSI part-2 streams; rate-matched ACK and CSI positions are removed
    from the data entirely."""
    dev = llrs.device
    ack = llrs[..., _layout_on(dev, cfg, 0)] if cfg.g_ack else None
    csi1 = llrs[..., _layout_on(dev, cfg, 1)] if cfg.g_csi1 else None
    rest = llrs
    if cfg.g_ack and cfg.ack_punctures:
        rest = llrs.index_fill(-1, _layout_on(dev, cfg, 0), 0)
    data = rest[..., _layout_on(dev, cfg, 3)]
    csi2 = rest[..., _layout_on(dev, cfg, 2)] if cfg.g_csi2 else None
    return data, ack, csi1, csi2


def decode_uci_parts(ack_llrs, csi_llrs, nof_ack_bits: int, nof_csi1_bits: int,
                     csi2_llrs=None, nof_csi2_bits: int = 0) -> dict:
    """Decode the UCI payloads (float32 LLRs of the int8 ones): dict of
    (bits, ok) per part ("ack", "csi1", "csi2")."""
    out = {}
    for name, llrs, k in (("ack", ack_llrs, nof_ack_bits), ("csi1", csi_llrs, nof_csi1_bits),
                          ("csi2", csi2_llrs, nof_csi2_bits)):
        if llrs is not None and k:
            out[name] = uci_mod.decode_uci(llrs.to(torch.float32), k)
    return out


def ack_placeholder_descramble(ack_llrs: torch.Tensor, scr_bits: torch.Tensor, qm: int,
                               nof_ack_bits: int) -> torch.Tensor:
    """Placeholder correction for 1-2 bit HARQ-ACK payloads on PUSCH: the
    demodulator descrambles every position, and the spec's x/y
    placeholders (TS 38.211 scrambling special cases) are reverted on the
    ACK REs.  With 1 bit per RE group [b, y, x..], out[1] flips iff c0 ^
    c1; with 2 bits [b0, b1, x..], out[0:2] pass; out[2:] flip iff their
    own c.  (..., G_ack) LLRs and scrambling bits, G_ack a multiple of
    qm."""
    if nof_ack_bits > 2 or qm == 1:
        return ack_llrs
    g = ack_llrs.shape[-1]
    grp = ack_llrs.reshape(ack_llrs.shape[:-1] + (g // qm, qm))
    c = scr_bits.reshape(scr_bits.shape[:-1] + (g // qm, qm)).to(torch.int32)
    flip = torch.zeros_like(c)
    if nof_ack_bits == 1:
        flip[..., 1] = c[..., 0] ^ c[..., 1]
    if qm > 2:
        flip[..., 2:] = c[..., 2:]
    return torch.where(flip == 1, -grp, grp).reshape(ack_llrs.shape)


_part2_tables_on = device_table(lambda sizes, which: np.asarray(
    [sorted(set(sizes)).index(s) for s in sizes] if which else sizes, np.int64))


def decode_csi_two_step(csi1_llrs: torch.Tensor, csi2_llrs: torch.Tensor | None, csi_cfg) -> dict:
    """Two-step CSI: part 1 at its fixed width, then part 2 at the size its
    decoded RI selects (TS 38.212 Table 6.3.2.1.2-4).  As in the
    reference, part 2 is decoded at every size the correspondence allows
    and the RI picks the result, so nothing waits on the host.

    (..., E1) and (..., E2) LLRs -> dict of "csi1" (bits, ok), and with a
    part 2: "csi2" (bits padded with zeros to the largest size, ok),
    "rank" (...,) and "nof_csi2_bits" (...,) int64."""
    bits1, ok1 = uci_mod.decode_uci(csi1_llrs.to(torch.float32), csi_mod.part1_bitwidth(csi_cfg))
    out = {"csi1": (bits1, ok1)}
    corr = csi_mod.part2_correspondence(csi_cfg)
    if corr is None or csi2_llrs is None:
        return out
    ri_off, ri_w, sizes = corr
    v = torch.zeros(bits1.shape[:-1], dtype=torch.int64, device=bits1.device)
    for j in range(ri_w):  # the RI field, MSB first
        v = (v << 1) | bits1[..., ri_off + j].to(torch.int64)
    v = torch.clamp(v, 0, len(sizes) - 1)
    max_size = max(sizes)
    cand_bits, cand_ok = [], []
    for s in sorted(set(sizes)):
        b, ok = uci_mod.decode_uci(csi2_llrs.to(torch.float32), s)
        cand_bits.append(torch.nn.functional.pad(b, (0, max_size - s)))
        cand_ok.append(ok)
    sel = _part2_tables_on(bits1.device, sizes, 1)[v]
    bits2 = torch.gather(torch.stack(cand_bits, dim=-2), -2,
                         sel[..., None, None].expand(sel.shape + (1, max_size)))[..., 0, :]
    ok2 = torch.gather(torch.stack(cand_ok, dim=-1), -1, sel[..., None])[..., 0]
    out["csi2"] = (bits2, ok2)
    out["rank"] = v + 1
    out["nof_csi2_bits"] = _part2_tables_on(bits1.device, sizes, 0)[v]
    return out
