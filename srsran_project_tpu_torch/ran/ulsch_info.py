"""UL-SCH rate-matching information: UCI-on-PUSCH bit counts and beta
offsets (TS 38.212 §6.3.2.4, TS 38.213 §9.3).

Copy of ``srsran_project_tpu/ran/ulsch_info.py`` (pure Python, held equal
to it by tests/test_torch_uci.py): G_ack / G_csi1 / G_csi2 from the
payload sizes, beta offsets and the allocation geometry, which drive
phy/ulsch_demux.
"""

from __future__ import annotations

import math

# TS 38.213 Table 9.3-1: HARQ-ACK beta offsets.
BETA_HARQ_ACK = (
    1.0, 2.0, 2.5, 3.125, 4.0, 5.0, 6.25, 8.0, 10.0, 12.625, 15.875, 20.0,
    31.0, 50.0, 80.0, 126.0,
)
# TS 38.213 Table 9.3-2: CSI beta offsets.
BETA_CSI = (
    1.125, 1.25, 1.375, 1.625, 1.75, 2.0, 2.25, 2.5, 2.875, 3.125, 3.5, 4.0,
    5.0, 6.25, 8.0, 10.0, 12.625, 15.875, 20.0,
)


def _uci_crc_bits(o: int) -> int:
    if o <= 11:
        return 0
    return 6 if o <= 19 else 11


def nof_harq_ack_bits(
    o_ack: int,
    beta_index: int,
    sum_kr: int,
    nof_re_uci: int,
    qm: int,
    nof_layers: int,
    alpha: float = 1.0,
) -> int:
    """G_ack per TS 38.212 §6.3.2.4.1.1.

    sum_kr: total SCH payload bits of the codeword (sum of K_r);
    nof_re_uci: RE budget available for UCI (the sum over symbols of
    M_sc^uci); the cap is alpha * that budget.
    """
    if o_ack == 0:
        return 0
    beta = BETA_HARQ_ACK[beta_index]
    l = _uci_crc_bits(o_ack)
    total_bits_for_re = qm * nof_layers
    need = math.ceil((o_ack + l) * beta * nof_re_uci * total_bits_for_re / max(sum_kr, 1))
    cap = math.ceil(alpha * nof_re_uci) * total_bits_for_re
    g = min(need, cap)
    # Multiple of one RE's bit capacity.
    return ((g + total_bits_for_re - 1) // total_bits_for_re) * total_bits_for_re


def nof_csi1_bits(
    o_csi1: int,
    beta_index: int,
    sum_kr: int,
    nof_re_uci: int,
    qm: int,
    nof_layers: int,
    alpha: float = 1.0,
    g_ack: int = 0,
) -> int:
    """G_csi1 per TS 38.212 §6.3.2.4.1.2 (same structure, CSI beta table,
    budget reduced by the ACK allocation)."""
    if o_csi1 == 0:
        return 0
    beta = BETA_CSI[beta_index]
    l = _uci_crc_bits(o_csi1)
    total_bits_for_re = qm * nof_layers
    need = math.ceil((o_csi1 + l) * beta * nof_re_uci * total_bits_for_re / max(sum_kr, 1))
    cap = max(math.ceil(alpha * nof_re_uci) * total_bits_for_re - g_ack, 0)
    g = min(need, cap)
    return ((g + total_bits_for_re - 1) // total_bits_for_re) * total_bits_for_re


def nof_csi2_bits(
    o_csi2: int,
    beta_index: int,
    sum_kr: int,
    nof_re_uci: int,
    qm: int,
    nof_layers: int,
    alpha: float = 1.0,
    g_ack: int = 0,
    g_csi1: int = 0,
) -> int:
    """G_csi2 per TS 38.212 §6.3.2.4.1.3 (budget reduced by ACK + CSI1)."""
    if o_csi2 == 0:
        return 0
    beta = BETA_CSI[beta_index]
    l = _uci_crc_bits(o_csi2)
    total_bits_for_re = qm * nof_layers
    need = math.ceil((o_csi2 + l) * beta * nof_re_uci * total_bits_for_re / max(sum_kr, 1))
    cap = max(math.ceil(alpha * nof_re_uci) * total_bits_for_re - g_ack - g_csi1, 0)
    g = min(need, cap)
    return ((g + total_bits_for_re - 1) // total_bits_for_re) * total_bits_for_re
