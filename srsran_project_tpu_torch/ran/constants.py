"""NR numerology and frame-structure constants (TS 38.211 §4).

Counterpart of the reference's include/srsran/ran/{subcarrier_spacing.h,
cyclic_prefix.h, frame_types.h, resource_block.h}; re-derived from the spec,
not translated.

The port's own copy of ``srsran_project_tpu/ran/constants.py`` (the port imports
nothing of the JAX package); tests/test_torch_import.py holds the two
equal value for value.
"""

from __future__ import annotations

import enum

# Number of resource elements (subcarriers) per resource block (TS 38.211 §4.4.4.1).
NRE = 12

# Maximum number of resource blocks in a carrier (TS 38.101: 275 max for FR1/FR2).
MAX_RB = 275

# Maximum number of antenna ports supported by the PHY processors.
MAX_PORTS = 4

# Maximum number of transmission layers (DL).
MAX_LAYERS = 4

# Reference sample rate constant kappa (TS 38.211 §4.1): T_c-to-T_s ratio.
KAPPA = 64

# Basic time unit T_c in seconds: 1 / (480e3 * 4096).
T_C = 1.0 / (480e3 * 4096)

# Number of OFDM symbols per slot for normal/extended cyclic prefix.
NOF_SYMS_NORMAL = 14
NOF_SYMS_EXTENDED = 12

# Subframes per frame.
NOF_SUBFRAMES_PER_FRAME = 10

# Frames numbered modulo 1024 (SFN).
NOF_SFNS = 1024


class SubcarrierSpacing(enum.IntEnum):
    """Subcarrier spacing, expressed as the numerology index mu (TS 38.211 §4.2)."""

    KHZ15 = 0
    KHZ30 = 1
    KHZ60 = 2
    KHZ120 = 3
    KHZ240 = 4


class CyclicPrefix(enum.IntEnum):
    NORMAL = 0
    EXTENDED = 1


def scs_khz(scs: SubcarrierSpacing) -> int:
    """Subcarrier spacing in kHz."""
    return 15 << int(scs)


def nof_symbols_per_slot(cp: CyclicPrefix) -> int:
    return NOF_SYMS_NORMAL if cp == CyclicPrefix.NORMAL else NOF_SYMS_EXTENDED


def nof_slots_per_subframe(scs: SubcarrierSpacing) -> int:
    return 1 << int(scs)


def nof_slots_per_frame(scs: SubcarrierSpacing) -> int:
    return NOF_SUBFRAMES_PER_FRAME * nof_slots_per_subframe(scs)


def cp_lengths(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix = CyclicPrefix.NORMAL):
    """Cyclic-prefix length in samples for each OFDM symbol of one subframe.

    TS 38.211 §5.3.1: N_cp = 144*kappa*2^-mu for all symbols except symbols
    0 and 7*2^mu of each subframe which get an extra 16*kappa samples
    (normal CP).  Lengths here are scaled to an arbitrary DFT size: the
    canonical formulas assume dft_size = 4096/2^0 at kappa granularity; for a
    DFT of size N at spacing mu, one "kappa unit" is N/2048 samples.

    Returns a list of per-symbol CP lengths (in samples) covering the
    2^mu * 14 symbols of one subframe (normal CP).
    """
    mu = int(scs)
    scale = dft_size / 2048.0
    if cp == CyclicPrefix.EXTENDED:
        n_syms = NOF_SYMS_EXTENDED * (1 << mu)
        base = int(512 * scale)
        return [base] * n_syms
    n_syms = NOF_SYMS_NORMAL * (1 << mu)
    base = int(144 * scale)
    extra = int(16 * scale * (1 << mu))
    out = []
    for l in range(n_syms):
        if l == 0 or l == 7 * (1 << mu):
            out.append(base + extra)
        else:
            out.append(base)
    return out


def symbol_lengths(scs: SubcarrierSpacing, dft_size: int, cp: CyclicPrefix = CyclicPrefix.NORMAL):
    """Total length (CP + body) in samples of each OFDM symbol in a subframe."""
    return [c + dft_size for c in cp_lengths(scs, dft_size, cp)]


def sampling_rate_hz(scs: SubcarrierSpacing, dft_size: int) -> float:
    return float(scs_khz(scs) * 1000 * dft_size)


def min_dft_size(nof_rb: int) -> int:
    """Smallest power-of-two DFT size that fits a carrier of nof_rb PRBs."""
    n = 128
    while n < nof_rb * NRE:
        n *= 2
    return n
