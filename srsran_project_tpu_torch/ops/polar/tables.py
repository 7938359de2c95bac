"""Polar code spec tables (TS 38.212 §5.3.1 / §5.4.1).

Copy of ``srsran_project_tpu/ops/polar/tables.py`` (numpy only) with its
own copy of ``_tables.npz`` (tests/test_torch_uci.py holds both equal to
the reference's): the universal reliability sequence (Table 5.3.1.2-1,
stored for N=1024; smaller codes filter it) and the interleaving patterns.
"""

from __future__ import annotations

import functools
import os

import numpy as np

NMAX_LOG = 10
KMAX_IL = 164

# Sub-block interleaver pattern P(i) (TS 38.212 Table 5.4.1.1-1).
SUBBLOCK_PATTERN = (
    0, 1, 2, 4, 3, 5, 6, 7, 8, 16, 9, 17, 10, 18, 11, 19, 12, 20, 13, 21,
    14, 22, 15, 23, 24, 25, 26, 28, 27, 29, 30, 31,
)

# Input-bits interleaver pattern pi_IL^max (TS 38.212 Table 5.3.1.1-1).
INPUT_INTERLEAVER_PATTERN = (
    0, 2, 4, 7, 9, 14, 19, 20, 24, 25, 26, 28, 31, 34, 42, 45, 49, 50, 51,
    53, 54, 56, 58, 59, 61, 62, 65, 66, 67, 69, 70, 71, 72, 76, 77, 81, 82,
    83, 87, 88, 89, 91, 93, 95, 98, 101, 104, 106, 108, 110, 111, 113, 115,
    118, 119, 120, 122, 123, 126, 127, 129, 132, 134, 138, 139, 140, 1, 3,
    5, 8, 10, 15, 21, 27, 29, 32, 35, 43, 46, 52, 55, 57, 60, 63, 68, 73,
    78, 84, 90, 92, 94, 96, 99, 102, 105, 107, 109, 112, 114, 116, 121,
    124, 128, 130, 133, 135, 141, 6, 11, 16, 22, 30, 33, 36, 44, 47, 64,
    74, 79, 85, 97, 100, 103, 117, 125, 131, 136, 142, 12, 17, 23, 37, 48,
    75, 80, 86, 137, 143, 13, 18, 38, 144, 39, 145, 40, 146, 41, 147, 148,
    149, 150, 151, 152, 153, 154, 155, 156, 157, 158, 159, 160, 161, 162,
    163,
)


@functools.lru_cache(maxsize=1)
def _npz():
    return np.load(os.path.join(os.path.dirname(__file__), "_tables.npz"))


@functools.lru_cache(maxsize=None)
def reliability_sequence(n: int) -> np.ndarray:
    """Q_0^{N-1}: bit indices in ascending reliability order for N = 2^n."""
    full = _npz()["reliability_1024"].astype(np.int32)
    nval = 1 << n
    return full[full < nval]


@functools.lru_cache(maxsize=None)
def subblock_interleaver(n: int) -> np.ndarray:
    """J(j) for j in [0, N): output position j reads coded bit J(j)."""
    nval = 1 << n
    j = np.arange(nval)
    i = (32 * j) // nval
    p = np.asarray(SUBBLOCK_PATTERN, dtype=np.int64)
    return (p[i] * (nval // 32) + j % (nval // 32)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def input_interleaver(k: int) -> np.ndarray:
    """pi(k): interleaved position sequence for K input bits (I_IL = 1).

    TS 38.212 §5.3.1.1: take pattern entries >= KMAX_IL - K, subtract the
    offset.
    """
    off = KMAX_IL - k
    out = [p - off for p in INPUT_INTERLEAVER_PATTERN if p >= off]
    assert len(out) == k
    return np.asarray(out, dtype=np.int32)
