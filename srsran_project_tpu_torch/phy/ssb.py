"""SS/PBCH block: PSS, SSS, PBCH encode + SSB grid assembly, and the UE-side
PBCH decoder.

Port of ``srsran_project_tpu/phy/ssb.py``: BCH payload interleaving + first
scrambling (TS 38.212 §7.1), CRC24C, polar (K = 56, E = 864), second
scrambling + QPSK (TS 38.211 §7.3.3), PSS/SSS m-sequences and the
240 x 4-subcarrier SSB layout (§7.4.2, §7.4.3).  Sequences, masks and the
RE layout are host plans; the block is written by index assignment.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import crc as crc_mod
from ..ops import polar, scrambling
from ..ops._tables import device_table
from ..ops.modulation import Modulation, map_bits
from ..ops.polar import tables as ptab
from ..support.tracing import l1_tracer

A_BITS = 32
E_PBCH = 864
K_PBCH = A_BITS + 24

# TS 38.212 Table 7.1.1-1: PBCH payload interleaver pattern G(j).
G_PATTERN = (
    16, 23, 18, 17, 8, 30, 10, 6, 24, 7, 0, 5, 3, 2, 1, 4,
    9, 11, 12, 13, 14, 15, 19, 20, 21, 22, 25, 26, 27, 28, 29, 31,
)

SSB_NSC = 240
SSB_NSYM = 4
_PSS_SC0 = 56  # PSS/SSS occupy subcarriers 56..182


def _mseq(taps_fn, length=127) -> np.ndarray:
    x = np.zeros(length + 7, dtype=np.uint8)
    x[0] = 1  # x(0) = 1, x(1..6) = 0 for the SSS generators
    for i in range(length):
        x[i + 7] = taps_fn(x, i)
    return x[:length]


@functools.lru_cache(maxsize=1)
def _pss_base() -> np.ndarray:
    x = np.zeros(127 + 7, dtype=np.uint8)
    x[:7] = [0, 1, 1, 0, 1, 1, 1]  # TS 38.211 §7.4.2.2.1 initial state
    for i in range(127):
        x[i + 7] = x[i + 4] ^ x[i]
    return x[:127]


@functools.lru_cache(maxsize=1)
def _sss_bases():
    return _mseq(lambda x, i: x[i + 4] ^ x[i]), _mseq(lambda x, i: x[i + 1] ^ x[i])


def pss_sequence(nid2: int) -> np.ndarray:
    """d_PSS(n), 127 BPSK values (TS 38.211 §7.4.2.2)."""
    m = (np.arange(127) + 43 * nid2) % 127
    return (1.0 - 2.0 * _pss_base()[m]).astype(np.float32)


def sss_sequence(nid1: int, nid2: int) -> np.ndarray:
    """d_SSS(n), 127 BPSK values (TS 38.211 §7.4.2.3)."""
    x0, x1 = _sss_bases()
    m0 = 15 * (nid1 // 112) + 5 * nid2
    m1 = nid1 % 112
    n = np.arange(127)
    s0 = 1.0 - 2.0 * x0[(n + m0) % 127]
    s1 = 1.0 - 2.0 * x1[(n + m1) % 127]
    return (s0 * s1).astype(np.float32)


@dataclasses.dataclass(frozen=True)
class SsbConfig:
    """Twin of the reference's ``SsbConfig`` (same fields and defaults)."""

    pci: int  # physical cell id N_ID = 3 NID1 + NID2
    ssb_index: int = 0
    l_max: int = 8
    sfn_2lsb: int = 0  # 2nd/3rd LSB of the SFN: first-scrambling offset v
    hrf: int = 0  # half-frame bit (second half-frame = 1)

    @classmethod
    def from_reference(cls, ref) -> "SsbConfig":
        return cls(**{f.name: getattr(ref, f.name) for f in dataclasses.fields(cls)})

    @property
    def nid1(self) -> int:
        return self.pci // 3

    @property
    def nid2(self) -> int:
        return self.pci % 3

    @functools.cached_property
    def code(self) -> polar.PolarCode:
        return polar.construct(K_PBCH, E_PBCH, n_max=9)


def pbch_pack_payload(mib_bits, sfn: int, hrf: int, ssb_index: int,
                      l_max: int, k_ssb: int = 0) -> np.ndarray:
    """Pack the 24 MIB bits + timing fields into the 32-bit pre-interleave
    PBCH payload a(j) that :func:`encode_pbch` takes: the SFN-field MIB
    bits, the SFN LSBs, HRF, the SSB-index / k_ssb bits, then the other
    MIB bits (the reference's pbch_encoder_impl.cpp payload_generate)."""
    mib = np.asarray(mib_bits, np.uint8)
    assert mib.size == 24
    out = []
    out.extend(mib[1:7])                        # MIB SFN payload bits -> G[0..5]
    out.extend(((sfn >> s) & 1) for s in (3, 2, 1, 0))  # SFN 4 LSBs -> G[6..9]
    out.append(hrf & 1)                         # half-frame -> G[10]
    if l_max == 64:
        out.extend(((ssb_index >> s) & 1) for s in (5, 4, 3))  # -> G[11..13]
    else:
        out.extend(((k_ssb >> 4) & 1, 0, 0))    # k_ssb MSB + reserved
    out.append(mib[0])                          # MIB bit 0 -> G[14]
    out.extend(mib[7:24])                       # rest -> G[15..31]
    return np.asarray(out, np.uint8)


_g_on = device_table(lambda: np.asarray(G_PATTERN, np.int64))


def pbch_payload_interleave(a_bits: torch.Tensor) -> torch.Tensor:
    """a'(G(j)) = a(j): spread the 32 payload bits (TS 38.212 §7.1.1)."""
    out = torch.zeros(a_bits.shape, dtype=torch.uint8, device=a_bits.device)
    out[..., _g_on(a_bits.device)] = a_bits.to(torch.uint8)
    return out


@functools.lru_cache(maxsize=None)
def _first_scrambling_mask(cfg: SsbConfig) -> np.ndarray:
    """(A,) 0/1 Gold bits to XOR (SFN 2nd/3rd LSB and HRF positions kept
    clear, and the SSB-index bits at L_max = 64), per TS 38.212 §7.1.2
    with interleaved positions."""
    m = A_BITS - 3 if cfg.l_max in (4, 8) else A_BITS - 6
    seq = scrambling.gold_ref(cfg.pci, (cfg.sfn_2lsb + 1) * m)[-m:]
    mask = np.zeros(A_BITS, dtype=np.uint8)
    skip = {G_PATTERN[7], G_PATTERN[8], G_PATTERN[10]}
    if cfg.l_max == 64:
        skip |= {G_PATTERN[11], G_PATTERN[12], G_PATTERN[13]}
    j = 0
    for i in range(A_BITS):
        if i in skip:
            continue
        mask[i] = seq[j]
        j += 1
        if j == m:
            break
    return mask


def _second_scrambling(cfg: SsbConfig) -> np.ndarray:
    """(E,) 0/1 Gold bits of the second scrambling (TS 38.211 §7.3.3.1):
    block v = the SSB index LSBs."""
    v = cfg.ssb_index & (0b111 if cfg.l_max > 4 else 0b11)
    return scrambling.gold_ref(cfg.pci, (v + 1) * E_PBCH)[v * E_PBCH :].astype(np.uint8)


_mask1_on = device_table(_first_scrambling_mask)
_mask2_on = device_table(_second_scrambling)


def encode_pbch(payload: torch.Tensor, cfg: SsbConfig,
                first_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(..., 32) payload bits -> (..., 864) scrambled coded bits.
    ``first_mask``: the first scrambling's (32,) bits on the payload's
    device in place of the config's (``_first_scrambling_mask``), the one
    part of the chain that follows the SFN."""
    dev = payload.device
    if first_mask is None:
        first_mask = _mask1_on(dev, cfg)
    a = pbch_payload_interleave(payload) ^ first_mask
    coded = polar.encode(crc_mod.crc_append(a, "24C"), cfg.code, interleave_input=True)
    return coded ^ _mask2_on(dev, cfg)


@functools.lru_cache(maxsize=None)
def _ssb_re_layout(pci: int):
    """(pbch_data_idx (432,), dmrs_idx (144,)) flat indices into (4, 240)."""
    v = pci % 4
    data, dmrs = [], []

    def pbch_block(sym, sc_lo, sc_hi):
        for sc in range(sc_lo, sc_hi):
            (dmrs if sc % 4 == v else data).append(sym * SSB_NSC + sc)

    pbch_block(1, 0, SSB_NSC)
    pbch_block(2, 0, 48)
    pbch_block(2, 192, SSB_NSC)
    pbch_block(3, 0, SSB_NSC)
    assert len(data) == 432 and len(dmrs) == 144
    return np.asarray(data, np.int32), np.asarray(dmrs, np.int32)


def _dmrs_c_init(cfg: SsbConfig) -> int:
    # TS 38.211 §7.4.1.4.1: i_ssb takes the SSB index's 2 LSBs + 4 n_hf for
    # L_max = 4, or its 3 LSBs (no half-frame term) otherwise.
    if cfg.l_max == 4:
        issb = (cfg.ssb_index & 0b11) + 4 * (cfg.hrf & 1)
    else:
        issb = cfg.ssb_index & 0b111
    return ((1 << 11) * (issb + 1) * (cfg.pci // 4 + 1) + (1 << 6) * (issb + 1) + (cfg.pci % 4)) % (
        1 << 31)


@functools.lru_cache(maxsize=None)
def _fixed_block(cfg: SsbConfig) -> np.ndarray:
    """(4 * 240,) complex64: PSS, SSS and the PBCH DM-RS, zeros elsewhere."""
    grid = np.zeros(SSB_NSYM * SSB_NSC, np.complex64)
    grid[_PSS_SC0 : _PSS_SC0 + 127] = pss_sequence(cfg.nid2)
    grid[2 * SSB_NSC + _PSS_SC0 : 2 * SSB_NSC + _PSS_SC0 + 127] = sss_sequence(cfg.nid1, cfg.nid2)
    c = scrambling.gold_ref(_dmrs_c_init(cfg), 2 * 144).astype(np.float32)
    pilots = ((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2)
    grid[_ssb_re_layout(cfg.pci)[1]] = pilots.astype(np.complex64)
    return grid


_fixed_on = device_table(_fixed_block)
_layout_on = device_table(lambda pci, which: _ssb_re_layout(pci)[which].astype(np.int64))


def assemble_ssb(payload: torch.Tensor, cfg: SsbConfig, beta: float = 1.0,
                 first_mask: torch.Tensor | None = None) -> torch.Tensor:
    """(32,) PBCH payload bits -> the SSB block (4, 240) complex64 with PSS,
    SSS, PBCH and its DM-RS, on the payload's device; the span
    ``ssb.assemble`` counts ``ssbs``.  ``first_mask`` as in
    ``encode_pbch``."""
    with l1_tracer.span("ssb.assemble") as span:
        span.count(ssbs=1)
        dev = payload.device
        grid = _fixed_on(dev, cfg).clone()
        grid[_layout_on(dev, cfg.pci, 0)] = map_bits(encode_pbch(payload, cfg, first_mask),
                                                     Modulation.QPSK)
        return (beta * grid).reshape(SSB_NSYM, SSB_NSC)


def decode_pbch(llrs: torch.Tensor, cfg: SsbConfig):
    """(864,) LLRs (positive = bit 0) -> (payload (32,) uint8, crc_ok bool
    tensor): undoes the second scrambling, polar-decodes, checks CRC24C and
    undoes the input interleaving, the first scrambling and the payload
    interleaver."""
    dev = llrs.device
    llrs = torch.where(_mask2_on(dev, cfg) == 1, -llrs, llrs)
    u = polar.decode(polar.rate_dematch_llrs(llrs, cfg.code), cfg.code).to(torch.uint8)
    deint = torch.empty_like(u)
    deint[..., _deint_on(dev, K_PBCH)] = u
    ok = crc_mod.crc_check(deint, "24C")
    a = deint[..., :A_BITS] ^ _mask1_on(dev, cfg)
    return a[..., _g_on(dev)], ok


_deint_on = device_table(lambda k: ptab.input_interleaver(k).astype(np.int64))
