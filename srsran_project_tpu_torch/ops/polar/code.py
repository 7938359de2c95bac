"""Polar code construction (TS 38.212 §5.3.1.2): code length, frozen set,
rate-matching mode, parity-check masks, rate-matching indices and the UL
channel interleaver.

Copy of ``srsran_project_tpu/ops/polar/code.py`` (host-side numpy), held
equal to it by tests/test_torch_uci.py.
"""

from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np

from . import tables


@dataclasses.dataclass(frozen=True)
class PolarCode:
    k: int  # message bits (incl. CRC, excl. PC bits)
    e: int  # rate-matched length
    n: int  # log2 N
    rm_mode: str  # "repetition" | "puncturing" | "shortening"
    info_set: tuple[int, ...]  # input positions carrying message bits, ascending
    # Parity-check bit positions (TS 38.212 §5.3.1.2, UCI 12<=A<=19).
    # PC bit at position q equals the XOR of the previously-placed message
    # bits at positions p < q with p = q (mod 5): the spec's length-5
    # cyclic shift register reduces to this residue rule (rotation has
    # period 5 and the register starts at zero).
    pc_set: tuple[int, ...] = ()
    # frozen = complement of info_set | pc_set

    @property
    def nval(self) -> int:
        return 1 << self.n


def _row_weight(i: int) -> int:
    """Weight of row i of G_N: 2**popcount(i)."""
    return 1 << bin(i).count("1")


@functools.lru_cache(maxsize=None)
def construct(k: int, e: int, n_max: int = 9, n_pc: int = 0,
              n_pc_wm: int = 0) -> PolarCode:
    """Compute N and the frozen/info/PC sets (TS 38.212 §5.3.1.2).

    n_max: 9 for DL (PDCCH/PBCH), 10 for UL (UCI).
    n_pc / n_pc_wm: parity-check bit counts (3 / {0,1} for UCI 12<=A<=19).
    """
    assert 0 < k <= e
    cl2e = math.ceil(math.log2(e))
    if e <= (9 / 8) * (1 << (cl2e - 1)) and k / e < 9 / 16:
        n1 = cl2e - 1
    else:
        n1 = cl2e
    r_min = 1 / 8
    n2 = math.ceil(math.log2(k / r_min))
    n = max(5, min(n1, n2, n_max))
    nval = 1 << n

    if e >= nval:
        rm_mode = "repetition"
    elif 16 * k <= 7 * e:
        rm_mode = "puncturing"
    else:
        rm_mode = "shortening"

    # Pre-frozen positions from rate matching (§5.4.1.1 inverse view).
    jn = tables.subblock_interleaver(n)
    pre_frozen = np.zeros(nval, dtype=bool)
    if rm_mode == "puncturing":
        u = nval - e
        pre_frozen[jn[:u]] = True
        if e >= 3 * nval // 4:
            t = math.ceil(3 * nval / 4 - e / 2)
        else:
            t = math.ceil(9 * nval / 16 - e / 4)
        pre_frozen[:t] = True
    elif rm_mode == "shortening":
        pre_frozen[jn[e:]] = True

    # Pick the K + n_PC most reliable non-pre-frozen positions.
    rel = tables.reliability_sequence(n)  # ascending reliability
    usable = [int(i) for i in rel if not pre_frozen[i]]
    assert len(usable) >= k + n_pc, (k, e, n, rm_mode)
    q_tilde = usable[-(k + n_pc):]  # ascending reliability
    pc: list[int] = []
    if n_pc:
        # The n_PC - n_PC_wm least reliable of Q~, plus n_PC_wm positions of
        # minimal G_N row weight among the rest (ties -> highest reliability).
        pc = list(q_tilde[: n_pc - n_pc_wm])
        if n_pc_wm:
            rest = q_tilde[n_pc - n_pc_wm:]
            wmin = min(_row_weight(i) for i in rest)
            cands = [i for i in rest if _row_weight(i) == wmin]
            pc += cands[-n_pc_wm:]  # highest reliability among minimal-weight
    info = sorted(set(q_tilde) - set(pc))
    return PolarCode(k=k, e=e, n=n, rm_mode=rm_mode, info_set=tuple(info),
                     pc_set=tuple(sorted(pc)))


@functools.lru_cache(maxsize=None)
def pc_masks(code: PolarCode) -> np.ndarray:
    """(n_pc, K) uint8 GF(2) matrix: pc_vals = M @ msg (mod 2).

    Row for PC position q selects the message bits whose input positions p
    satisfy p < q and p = q (mod 5) — the closed form of the spec's 5-bit
    cyclic register (§5.3.1.2 encoding procedure)."""
    m = np.zeros((len(code.pc_set), code.k), dtype=np.uint8)
    for r, q in enumerate(code.pc_set):
        for j, p in enumerate(code.info_set):
            if p < q and (p % 5) == (q % 5):
                m[r, j] = 1
    return m


@functools.lru_cache(maxsize=None)
def rate_match_indices(code: PolarCode) -> np.ndarray:
    """(E,) gather indices into the N coded bits d -> transmitted e."""
    jn = tables.subblock_interleaver(code.n)
    nval = code.nval
    e = code.e
    if code.rm_mode == "repetition":
        return jn[np.arange(e) % nval]
    if code.rm_mode == "puncturing":
        return jn[np.arange(e) + (nval - e)]
    return jn[np.arange(e)]  # shortening


@functools.lru_cache(maxsize=None)
def channel_interleaver_pattern(e: int) -> np.ndarray:
    """UL triangular channel interleaver (TS 38.212 §5.4.1.3, I_BIL = 1).

    Returns perm with out[k] = in[perm[k]].
    """
    t = 0
    while t * (t + 1) // 2 < e:
        t += 1
    # Fill the triangle row-wise with input indices, read column-wise.
    rows = []
    k = 0
    for i in range(t):
        row = []
        for j in range(t - i):
            row.append(k if k < e else -1)
            k += 1
        rows.append(row)
    out = []
    for j in range(t):
        for i in range(t):
            if j < len(rows[i]) and rows[i][j] >= 0:
                out.append(rows[i][j])
    assert len(out) == e
    return np.asarray(out, dtype=np.int32)
