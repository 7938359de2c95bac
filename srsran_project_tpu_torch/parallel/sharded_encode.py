"""Sharded PDSCH encode — the DOWNLINK direction of the multi-chip layer.

Port of ``srsran_project_tpu/parallel/sharded_encode.py``.  The reference
parallelizes DL encode as codeblock batches dispatched over an executor
(pdsch_processor_flexible_impl.cpp:42 — the batch pipeline splits the bit
chain per codeblock and the RE map per symbol range).  Here both axes map
onto the ranks of a mesh:

  - the bit chain shards over the CODEBLOCK axis (``cb_axis``): every rank
    segments the TB (CRC + segmentation are cheap) and LDPC-encodes its
    C/n codeblocks — the FLOP-heavy part of DL — and ONE ``all_gather``
    joins the circular buffers;
  - rate-match bit selection + scrambling + modulation + DM-RS +
    precoding then run on the whole codeword, and each rank keeps its
    SUBCARRIER slice along ``sc_axis``: the layout ``sharded_carrier``'s
    UL front end takes, so DL encode -> channel -> UL decode composes on
    the mesh without a resharding hop in between.

The reference's ``encode_hlo_text`` (XLA's compiled HLO of the encode, to
assert its collectives) has no torch counterpart (ROADMAP stay-outs); the
port's tests count the ``all_gather`` calls instead.
"""

from __future__ import annotations

import torch

from ..ops import scrambling
from ..ops.ldpc import encoder as ldpc_encoder
from ..ops.ldpc import rate_match as rm
from ..ops.ldpc import segmenter
from ..phy import pdsch as pdsch_mod
from ..phy.sch import SchConfig, _e_groups
from .mesh import axis as mesh_axis


def _encode_tb_cb_sharded(tb_bits: torch.Tensor, cfg: SchConfig, mesh, cb_axis) -> torch.Tensor:
    """TB (A,) -> codeword bits (G,); this rank LDPC-encodes its C/n
    codeblocks (C padded with zero codeblocks to a multiple of n) and one
    ``all_gather`` joins the buffers."""
    ax = mesh_axis(mesh, cb_axis)
    seg = cfg.seg
    cbs = segmenter.segment_tx(tb_bits, seg)  # (C, K)
    c = cbs.shape[0]
    per = -(-c // ax.size)
    cbs = torch.cat([cbs, cbs.new_zeros((per * ax.size - c, cbs.shape[1]))])
    mine = cbs[ax.index * per : (ax.index + 1) * per]
    buf = ldpc_encoder.encode_to_buffer(mine, seg.base_graph, seg.lifting_size, n_cb=cfg.n_cb)
    buf = ax.all_gather(buf, dim=0)[:c]
    k_prime = seg.nof_payload_bits_per_cb
    pieces = []
    for start, count, e in _e_groups(cfg.cb_e_bits):
        grp = rm.rate_match(buf[start : start + count], seg.base_graph, seg.lifting_size,
                            k_prime, e, cfg.rv, cfg.qm, cfg.n_cb)
        pieces.append(grp.reshape(count * e))
    return torch.cat(pieces)


def sc_slice(grid: torch.Tensor, mesh, sc_axis: str = "sp") -> torch.Tensor:
    """This rank's block of the (..., nsc) grid along ``sc_axis``: whole
    PRBs, the carrier zero-padded on the right to equal blocks (the
    geometry of ``sharded_carrier._check_shardable``)."""
    ax = mesh_axis(mesh, sc_axis)
    nsc = grid.shape[-1]
    local = -(-nsc // (12 * ax.size)) * 12
    grid = torch.nn.functional.pad(grid, (0, local * ax.size - nsc))
    return grid[..., ax.index * local : (ax.index + 1) * local]


def sharded_encode_slot(tb_bits: torch.Tensor, rnti, precoding: torch.Tensor,
                        cfg: pdsch_mod.PdschConfig, mesh, cb_axis="sp", sc_axis: str = "sp"):
    """One PDSCH slot encode on the mesh.

    tb_bits (A,) uint8, rnti, precoding (nl, nports) complex64 -> this
    rank's (nports, nsym, local_sc) block of the port grid, sharded along
    ``sc_axis`` (on tb_bits' device)."""
    dev = tb_bits.device
    cw = _encode_tb_cb_sharded(tb_bits, cfg.sch, mesh, cb_axis)
    rnti_t = torch.as_tensor(rnti, dtype=torch.int64, device=dev)
    scr = scrambling.scramble_bits(cw, pdsch_mod._pdsch_c_init(rnti_t, cfg.n_id))
    grid = pdsch_mod._grid_chain(scr, precoding.to(device=dev, dtype=torch.complex64), cfg)
    return sc_slice(grid, mesh, sc_axis)


def sharded_transmit(tb_bits: torch.Tensor, rnti, cfg, mesh, precoding=None, cb_axis="sp",
                     sc_axis: str = "sp"):
    """UE-grid twin of ``phy.pusch.transmit``, encoded on the mesh: builds
    the same PdschConfig twin and returns this rank's (nports, nsym,
    local_sc) block of the grid along ``sc_axis`` — the block
    ``sharded_carrier.sharded_decode`` takes."""
    if precoding is None:
        precoding = torch.eye(cfg.nof_layers, cfg.nof_rx_ports, dtype=torch.complex64)
    tx_cfg = pdsch_mod.PdschConfig(
        tbs=cfg.tbs, target_code_rate=cfg.target_code_rate, modulation=cfg.modulation,
        alloc=cfg.alloc, nof_layers=cfg.nof_layers, nof_ports=int(precoding.shape[-1]),
        nof_grid_symbols=cfg.nof_grid_symbols, nof_grid_sc=cfg.nof_grid_sc,
        slot_in_frame=cfg.slot_in_frame, dmrs_scrambling_id=cfg.dmrs_scrambling_id,
        n_scid=cfg.n_scid)
    return sharded_encode_slot(tb_bits, rnti, precoding, tx_cfg, mesh, cb_axis=cb_axis,
                               sc_axis=sc_axis)
