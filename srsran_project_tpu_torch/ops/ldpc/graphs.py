"""LDPC base-graph / lifted-graph descriptions (TS 38.212 §5.3.2).

Counterpart of the reference's ldpc_graph_impl (lib/phy/upper/channel_coding/
ldpc/ldpc_graph_impl.cpp) — here a graph is host-side NumPy metadata (edge
lists with shifts reduced mod Z) from which the encoder/decoder build static
jitted programs per (base graph, lifting size).

The port's own copy of ``srsran_project_tpu/ops/ldpc/graphs.py`` (the port imports
nothing of the JAX package); tests/test_torch_import.py holds the two
equal value for value.  The base-graph tables load from the
``_bg_tables.npz`` beside this file.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np

NO_EDGE = 0xFFFF

# Lifting sizes by set index iLS (TS 38.212 Table 5.3.2-1).
LIFTING_SETS = (
    (2, 4, 8, 16, 32, 64, 128, 256),
    (3, 6, 12, 24, 48, 96, 192, 384),
    (5, 10, 20, 40, 80, 160, 320),
    (7, 14, 28, 56, 112, 224),
    (9, 18, 36, 72, 144, 288),
    (11, 22, 44, 88, 176, 352),
    (13, 26, 52, 104, 208),
    (15, 30, 60, 120, 240),
)

ALL_LIFTING_SIZES = tuple(sorted(z for s in LIFTING_SETS for z in s))
MAX_LIFTING_SIZE = 384

BG1, BG2 = 1, 2

# Base-graph geometry: (nof check rows, nof var cols, nof message cols K_b).
_GEOMETRY = {BG1: (46, 68, 22), BG2: (42, 52, 10)}


@functools.lru_cache(maxsize=1)
def _raw_tables():
    path = os.path.join(os.path.dirname(__file__), "_bg_tables.npz")
    d = np.load(path)
    return {BG1: d["bg1"], BG2: d["bg2"]}


def lifting_index(z: int) -> int:
    for i, s in enumerate(LIFTING_SETS):
        if z in s:
            return i
    raise ValueError(f"invalid lifting size {z}")


@dataclasses.dataclass(frozen=True)
class LdpcGraph:
    """One lifted Tanner graph: base graph bg with lifting size z.

    shifts: (M, N) int32, -1 marks no edge, otherwise shift in [0, z).
    """

    bg: int
    z: int
    m: int  # check rows in base graph
    n: int  # variable cols in base graph (before puncturing)
    kb: int  # message cols
    shifts: np.ndarray

    @property
    def nof_message_bits(self) -> int:
        return self.kb * self.z

    @property
    def nof_codeword_bits(self) -> int:
        """Rate-matching buffer length N: full code minus the 2Z punctured cols."""
        return (self.n - 2) * self.z

    @property
    def full_length(self) -> int:
        return self.n * self.z

    def row_edges(self, row: int):
        """[(col, shift)] for one check row, in column order."""
        cols = np.nonzero(self.shifts[row] >= 0)[0]
        return [(int(c), int(self.shifts[row, c])) for c in cols]


@functools.lru_cache(maxsize=None)
def get_graph(bg: int, z: int) -> LdpcGraph:
    m, n, kb = _GEOMETRY[bg]
    raw = _raw_tables()[bg][lifting_index(z)][:m, :n].astype(np.int64)
    shifts = np.where(raw == NO_EDGE, -1, raw % z).astype(np.int32)
    return LdpcGraph(bg=bg, z=z, m=m, n=n, kb=kb, shifts=shifts)


def select_base_graph(tbs_with_crc_less: int, rate: float) -> int:
    """Base-graph selection per TS 38.212 §7.2.2 (A = TB size without CRC)."""
    a = tbs_with_crc_less
    if a <= 292 or (a <= 3824 and rate <= 0.67) or rate <= 0.25:
        return BG2
    return BG1


def base_graph_kb(bg: int, a: int) -> int:
    """Number of systematic blocks K_b used for lifting-size selection
    (TS 38.212 §5.2.2).  `a` is the payload size B (TB + CRC bits)."""
    if bg == BG1:
        return 22
    if a > 640:
        return 10
    if a > 560:
        return 9
    if a > 192:
        return 8
    return 6


def select_lifting_size(bg: int, b: int, nof_codeblocks: int) -> int:
    """Smallest Z with K_b * Z >= K' (TS 38.212 §5.2.2)."""
    # Per-codeblock payload (including per-CB CRC when segmented).
    b_prime = b + (24 * nof_codeblocks if nof_codeblocks > 1 else 0)
    k_prime = -(-b_prime // nof_codeblocks)
    kb = base_graph_kb(bg, b)
    for z in ALL_LIFTING_SIZES:
        if kb * z >= k_prime:
            return z
    raise ValueError(f"no lifting size for b={b} c={nof_codeblocks}")


def parity_check(graph: LdpcGraph, codeword: np.ndarray) -> np.ndarray:
    """H @ c mod 2 as a (batch, M*Z) syndrome (NumPy oracle).

    codeword: (..., n*z) bits over the FULL variable range (message first,
    including the 2Z punctured columns).
    """
    z = graph.z
    c = codeword.reshape(codeword.shape[:-1] + (graph.n, z))
    syn = np.zeros(codeword.shape[:-1] + (graph.m, z), dtype=np.uint8)
    for row in range(graph.m):
        for col, shift in graph.row_edges(row):
            syn[..., row, :] ^= np.roll(c[..., col, :], -shift, axis=-1)
    return syn.reshape(codeword.shape[:-1] + (graph.m * z,))
