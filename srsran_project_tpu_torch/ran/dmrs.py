"""DM-RS patterns for PDSCH/PUSCH (TS 38.211 §7.4.1.1 / §6.4.1.1).

Host-side geometry: which subcarriers/symbols carry pilots for a given
configuration type and port, plus the scrambling c_init.  Counterpart of the
reference's include/srsran/ran/dmrs.h and the per-channel DM-RS generators'
index math (lib/phy/upper/signal_processors/pdsch/dmrs_pdsch_processor_impl.cpp);
the actual pilot values are produced on device by ops/scrambling.

The port's own copy of ``srsran_project_tpu/ran/dmrs.py`` (the port imports
nothing of the JAX package); tests/test_torch_import.py holds the two
equal value for value.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from .constants import NRE


@dataclasses.dataclass(frozen=True)
class DmrsConfig:
    config_type: int = 1  # 1 or 2
    symbols: tuple[int, ...] = (2,)  # OFDM symbol indices carrying DM-RS
    scrambling_id: int = 0  # N_ID
    n_scid: int = 0
    nof_cdm_groups_without_data: int = 2


# Per-port parameters (single-symbol DM-RS, TS 38.211 Tables 7.4.1.1.2-1/2):
# port p -> (cdm_group lambda, delta, w_f over k' = (wf0, wf1)).
_TYPE1_PORTS = {
    0: (0, 0, (1, 1)),
    1: (0, 0, (1, -1)),
    2: (1, 1, (1, 1)),
    3: (1, 1, (1, -1)),
}
_TYPE2_PORTS = {
    0: (0, 0, (1, 1)),
    1: (0, 0, (1, -1)),
    2: (1, 2, (1, 1)),
    3: (1, 2, (1, -1)),
    4: (2, 4, (1, 1)),
    5: (2, 4, (1, -1)),
}


def pilots_per_prb(config_type: int) -> int:
    """Pilot REs per PRB per CDM group (both types place 2 per 4 or 6 REs)."""
    return 6 if config_type == 1 else 4


def pilot_subcarriers(config_type: int, port: int, nof_rb: int, rb_start: int = 0):
    """(k_indices (Np,), w_f (Np,)) for one port over an RB range.

    Type 1: k = 4n + 2k' + delta; Type 2: k = 6n + k' + delta (k' in {0,1}).
    w_f alternates with k' (the freq-domain OCC).
    """
    table = _TYPE1_PORTS if config_type == 1 else _TYPE2_PORTS
    _, delta, wf = table[port]
    ks, ws = [], []
    for rb in range(rb_start, rb_start + nof_rb):
        base = rb * NRE
        if config_type == 1:
            for n in range(3):
                for kp in (0, 1):
                    ks.append(base + 4 * n + 2 * kp + delta)
                    ws.append(wf[kp])
        else:
            for n in range(2):
                for kp in (0, 1):
                    ks.append(base + 6 * n + kp + delta)
                    ws.append(wf[kp])
    return np.asarray(ks, dtype=np.int32), np.asarray(ws, dtype=np.int32)


def cdm_group(config_type: int, port: int) -> int:
    table = _TYPE1_PORTS if config_type == 1 else _TYPE2_PORTS
    return table[port][0]


def dmrs_c_init(slot_in_frame: int, symbol: int, n_id: int, n_scid: int) -> int:
    """c_init per TS 38.211 §7.4.1.1.1 (PDSCH) / §6.4.1.1.1 (PUSCH)."""
    return (
        (1 << 17) * (14 * slot_in_frame + symbol + 1) * (2 * n_id + 1) + 2 * n_id + n_scid
    ) % (1 << 31)


def data_subcarrier_mask(config_type: int, nof_cdm_groups_without_data: int) -> np.ndarray:
    """(12,) bool: which REs of a PRB still carry data on a DM-RS symbol."""
    mask = np.ones(NRE, dtype=bool)
    if config_type == 1:
        # CDM group g occupies k = 4n + 2k' + g.
        for g in range(min(nof_cdm_groups_without_data, 2)):
            for n in range(3):
                for kp in (0, 1):
                    mask[4 * n + 2 * kp + g] = False
    else:
        for g in range(min(nof_cdm_groups_without_data, 3)):
            for n in range(2):
                for kp in (0, 1):
                    mask[6 * n + kp + 2 * g] = False
    return mask


def sch_to_dmrs_beta(nof_cdm_groups_without_data: int) -> float:
    """DM-RS amplitude relative to SCH data REs (TS 38.214 Tables 4.1-1 /
    6.2.2-1 via the SCH-to-DMRS EPRE ratio: 0 / -3 / -4.77 dB for 1 / 2 / 3
    CDM groups without data; reference sch_dmrs_power.h)."""
    import math

    return math.sqrt(float(nof_cdm_groups_without_data))
