"""Codebook-based precoding weights (TS 38.214 §5.2.2.2.1).

Maps a reported PMI (Type-I single-panel, the codebooks `ran/csi.py`
sizes and packs) to the precoding weight matrix applied to the next
PDSCH — the counterpart of the reference's codebook constructors
(lib/ran/precoding/precoding_codebooks.cpp: make_one_layer_two_ports,
make_two_layer_two_ports, make_*_four_ports_type1_sp_mode1) and the
FAPI precoding-matrix mapper that feeds them from CSI reports
(lib/fapi_adaptor/precoding_matrix_mapper.cpp).

Weight matrices are (nof_layers, nof_ports) complex64, normalized so
total transmit power is independent of rank (reference scaling
conventions: 1/sqrt(P) per layer, 1/sqrt(P*L) overall).  A copy of
``srsran_project_tpu/ran/precoding.py``.
"""

from __future__ import annotations

import numpy as np

# Type-I single panel, mode 1, N1=2 N2=1 O1=4 (the 4-port geometry the
# CSI report sizing in ran/csi.py assumes — 8 azimuth beams).
O1 = 4
N1 = 2
NOF_BEAMS = O1 * N1


def _beam(l: int, initial_phase: float, scaling: float) -> np.ndarray:
    """Horizontal DFT beam over the N1 co-polarized elements."""
    inc = 2.0 * np.pi * l / NOF_BEAMS
    return scaling * np.exp(1j * (initial_phase + inc * np.arange(N1)))


def one_layer_two_ports(i_codebook: int) -> np.ndarray:
    phi = (1.0, 1.0j, -1.0, -1.0j)[i_codebook & 3]
    return (np.asarray([[1.0, phi]], np.complex64) / np.sqrt(2)).astype(np.complex64)


def two_layer_two_ports(i_codebook: int) -> np.ndarray:
    # (layer, port) values exactly as the reference's codebook0/1 tables.
    phi = (1.0, 1.0j)[i_codebook & 1]
    return np.asarray([[0.5, 0.5], [0.5 * phi, -0.5 * phi]], np.complex64)


def _four_ports(rank: int, i11: int, i13: int, i2: int) -> np.ndarray:
    phi = np.pi / 2 * i2
    if rank == 1:
        s = 0.5
        w = np.empty((1, 4), np.complex64)
        w[0, :2] = _beam(i11, 0.0, s)
        w[0, 2:] = _beam(i11, phi, s)
        return w
    if rank == 2:
        s = 0.5 / np.sqrt(2)
        k1 = O1 if i13 else 0
        w = np.empty((2, 4), np.complex64)
        w[0, :2] = _beam(i11, 0.0, s)
        w[0, 2:] = _beam(i11, phi, s)
        w[1, :2] = _beam(i11 + k1, 0.0, s)
        w[1, 2:] = _beam(i11 + k1, phi + np.pi, s)
        return w
    if rank == 3:
        s = 1.0 / np.sqrt(12.0)
        k1 = O1
        w = np.empty((3, 4), np.complex64)
        w[0, :2] = _beam(i11, 0.0, s)
        w[0, 2:] = _beam(i11, phi, s)
        w[1, :2] = _beam(i11 + k1, 0.0, s)
        w[1, 2:] = _beam(i11 + k1, phi, s)
        w[2, :2] = _beam(i11, 0.0, s)
        w[2, 2:] = _beam(i11, phi + np.pi, s)
        return w
    if rank == 4:
        s = 0.25
        k1 = O1
        w = np.empty((4, 4), np.complex64)
        w[0, :2] = _beam(i11, 0.0, s)
        w[0, 2:] = _beam(i11, phi, s)
        w[1, :2] = _beam(i11 + k1, 0.0, s)
        w[1, 2:] = _beam(i11 + k1, phi, s)
        w[2, :2] = _beam(i11, 0.0, s)
        w[2, 2:] = _beam(i11, phi + np.pi, s)
        w[3, :2] = _beam(i11 + k1, 0.0, s)
        w[3, 2:] = _beam(i11 + k1, phi + np.pi, s)
        return w
    raise ValueError(f"rank {rank} unsupported for 4 ports")


def pmi_to_weights(nof_ports: int, rank: int, pmi_fields: dict) -> np.ndarray:
    """(rank, nof_ports) precoding weights from unpacked PMI fields.

    ``pmi_fields`` is the dict ran/csi.py's unpack_part2/unpack_pucch
    produces: {"pmi": i} for 2 ports, {"i11", "i13"?, "i2"} for 4.
    """
    if nof_ports == 1:
        return np.ones((1, 1), np.complex64)
    if nof_ports == 2:
        i = int(pmi_fields.get("pmi", 0))
        return one_layer_two_ports(i) if rank == 1 else two_layer_two_ports(i)
    if nof_ports == 4:
        return _four_ports(rank, int(pmi_fields.get("i11", 0)),
                           int(pmi_fields.get("i13", 0)),
                           int(pmi_fields.get("i2", 0)))
    raise ValueError(f"{nof_ports} ports unsupported")


def select_pmi(h: np.ndarray, nof_ports: int, rank: int) -> tuple[dict, float]:
    """UE-side codebook search: the (pmi fields, achieved metric) that
    maximizes the post-precoding capacity proxy sum_l log2(1 + SINR_l)
    for channel ``h`` (rx_ports, tx_ports).  This is the UE behavior the
    gNB's closed loop relies on (reference: CSI computed UE-side; sim
    fidelity here)."""
    best, best_m = {}, -1.0
    for fields in enumerate_pmis(nof_ports, rank):
        w = pmi_to_weights(nof_ports, rank, fields)
        # w maps layers -> ports (x_p = sum_l w[l, p] s_l), so the
        # effective per-layer channel is h @ w.T: (rx_ports, rank).
        g = np.abs(np.linalg.svd(h @ w.T, compute_uv=False)) ** 2
        m = float(np.log2(1 + g[:rank] * nof_ports).sum())
        if m > best_m:
            best, best_m = fields, m
    return best, best_m


def enumerate_pmis(nof_ports: int, rank: int):
    if nof_ports == 1:
        return [{}]
    if nof_ports == 2:
        return [{"pmi": i} for i in range(4 if rank == 1 else 2)]
    out = []
    for i11 in range(NOF_BEAMS):
        i13s = (0, 1) if rank == 2 else (0,)
        for i13 in i13s:
            for i2 in range(4 if rank == 1 else 2):
                out.append({"i11": i11, "i13": i13, "i2": i2})
    return out


def select_rank_and_pmi(h: np.ndarray, nof_ports: int,
                        max_rank: int | None = None) -> tuple[int, dict]:
    """Joint rank + PMI selection maximizing the capacity proxy."""
    nof_rx = h.shape[0]
    ranks = range(1, min(nof_ports, nof_rx, max_rank or 4) + 1)
    best_rank, best_fields, best_m = 1, {}, -1.0
    for r in ranks:
        fields, m = select_pmi(h, nof_ports, r)
        if m > best_m:
            best_rank, best_fields, best_m = r, fields, m
    return best_rank, best_fields
