"""Transport-block size determination (TS 38.214 §5.1.3.2).

Counterpart of the reference's lib/ran/sch/tbs_calculator.cpp.  Pure host
integer math; the small-TBS table is 3GPP Table 5.1.3.2-1.

The port's own copy of ``srsran_project_tpu/ran/tbs.py`` (the port imports
nothing of the JAX package); tests/test_torch_import.py holds the two
equal value for value.
"""

from __future__ import annotations

import math

# TS 38.214 Table 5.1.3.2-1: valid TBS for N_info <= 3824.
TBS_TABLE = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144, 152,
    160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320, 336, 352,
    368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640, 672, 704, 736,
    768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160, 1192, 1224, 1256,
    1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736, 1800, 1864, 1928,
    2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600, 2664, 2728, 2792,
    2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
)


def nof_re_per_prb(nof_symbols: int, nof_dmrs_re_per_prb: int, overhead: int = 0) -> int:
    """N'_RE = 12*nsymb - N_dmrs - N_oh, capped at 156 in the TBS formula.

    The reference computes this in unsigned arithmetic
    (tbs_calculator.cpp:133): a negative value wraps and the min() then
    selects 156 — reproduce that by treating negatives as "above the cap".
    """
    n = 12 * nof_symbols - nof_dmrs_re_per_prb - overhead
    return n if n >= 0 else 1 << 32


def calculate_tbs(
    nof_prb: int,
    nof_symbols: int,
    nof_dmrs_re_per_prb: int,
    code_rate: float,
    qm: int,
    nof_layers: int,
    overhead: int = 0,
    tb_scaling: float = 1.0,
) -> int:
    """TBS in bits per TS 38.214 §5.1.3.2 steps 1-4."""
    import numpy as np

    n_re_prime = nof_re_per_prb(nof_symbols, nof_dmrs_re_per_prb, overhead)
    n_re = min(156, n_re_prime) * nof_prb
    # The reference computes N_info in float32 (tbs_calculator.cpp:62-64);
    # mirror that so floor/round boundaries agree exactly.
    f32 = np.float32
    n_info = float(f32(tb_scaling) * f32(n_re) * f32(code_rate) * f32(qm) * f32(nof_layers))
    if n_info <= 3824:
        # Step 3: quantize then pick smallest valid TBS not less than N'_info.
        n = 3
        if n_info > 512:
            n = int(math.floor(math.log2(n_info))) - 6
        n_info_prime = max(24, (1 << n) * int(float(f32(n_info)) / (1 << n)))
        for tbs in TBS_TABLE:
            if tbs >= n_info_prime:
                return tbs
        return TBS_TABLE[-1]
    # Step 4 (tbs_calculator.cpp:44-59); round = half away from zero.
    n = int(math.floor(math.log2(n_info - 24))) - 5
    quotient = float(f32(n_info - 24) / f32(1 << n))
    n_info_prime = max(3840, (1 << n) * int(math.floor(quotient + 0.5)))
    if code_rate <= 0.25:
        c = math.ceil((n_info_prime + 24) / 3816)
    elif n_info_prime > 8424:
        c = math.ceil((n_info_prime + 24) / 8424)
    else:
        c = 1
    return 8 * c * math.ceil((n_info_prime + 24) / (8 * c)) - 24


# MCS tables (TS 38.214 Tables 5.1.3.1-1/2): (Qm, target rate x1024).
MCS_TABLE_64QAM = (
    (2, 120), (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 438), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910),
    (6, 948),
)
MCS_TABLE_256QAM = (
    (2, 120), (2, 193), (2, 308), (2, 449), (2, 602), (4, 378), (4, 434),
    (4, 490), (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567),
    (6, 616), (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (8, 682.5),
    (8, 711), (8, 754), (8, 797), (8, 841), (8, 885), (8, 916.5), (8, 948),
)


# TS 38.214 Table 5.1.3.1-3 (qam64LowSe).
MCS_TABLE_64QAM_LOW_SE = (
    (2, 30), (2, 40), (2, 50), (2, 64), (2, 78), (2, 99), (2, 120), (2, 157),
    (2, 193), (2, 251), (2, 308), (2, 379), (2, 449), (2, 526), (2, 602),
    (4, 340), (4, 378), (4, 434), (4, 490), (4, 553), (4, 616), (6, 438),
    (6, 466), (6, 517), (6, 567), (6, 616), (6, 666), (6, 719), (6, 772),
)
# TS 38.214 Table 6.1.4.1-1 (PUSCH with transform precoding); Qm 1 = pi/2-BPSK.
MCS_TABLE_TP_64QAM = (
    (1, 240), (1, 314), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449),
    (2, 526), (2, 602), (2, 679), (4, 340), (4, 378), (4, 434), (4, 490),
    (4, 553), (4, 616), (4, 658), (6, 466), (6, 517), (6, 567), (6, 616),
    (6, 666), (6, 719), (6, 772), (6, 822), (6, 873), (6, 910), (6, 948),
    (1, 0),  # reserved (retransmission, Qm only)
)
# TS 38.214 Table 6.1.4.1-2 (PUSCH with transform precoding, low SE).
MCS_TABLE_TP_64QAM_LOW_SE = (
    (1, 60), (1, 80), (1, 100), (1, 128), (1, 156), (1, 198), (2, 120),
    (2, 157), (2, 193), (2, 251), (2, 308), (2, 379), (2, 449), (2, 526),
    (2, 602), (2, 679), (4, 378), (4, 434), (4, 490), (4, 553), (4, 616),
    (4, 658), (4, 699), (4, 772), (6, 567), (6, 616), (6, 666), (6, 772),
    (1, 0),  # reserved
)

_TABLES = {
    "qam64": MCS_TABLE_64QAM,
    "qam256": MCS_TABLE_256QAM,
    "qam64LowSe": MCS_TABLE_64QAM_LOW_SE,
}
_TP_TABLES = {
    "qam64": MCS_TABLE_TP_64QAM,
    "qam64LowSe": MCS_TABLE_TP_64QAM_LOW_SE,
}


def mcs_to_qm_rate(mcs: int, table: str = "qam64", transform_precoding: bool = False,
                   tp_pi2bpsk: bool = False):
    """(Qm, code rate) for an MCS index (reference pusch_mcs.cpp /
    pdsch_mcs.cpp semantics; qam256 ignores transform precoding)."""
    if transform_precoding and table != "qam256":
        qm, r1024 = _TP_TABLES[table][mcs]
        if qm == 1:  # pi/2-BPSK entry
            if not tp_pi2bpsk:
                return 2, (r1024 / 2) / 1024.0
            return 1, r1024 / 1024.0
        return qm, r1024 / 1024.0
    qm, r1024 = _TABLES[table][mcs]
    return qm, r1024 / 1024.0
