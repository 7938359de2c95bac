"""Sequence-parallel (subcarrier-sharded) PUSCH front end for carriers too
wide for one chip — the north-star's sequence-length scaling axis
(SURVEY.md §5.7).

Port of ``srsran_project_tpu/parallel/sharded_carrier.py``.  A wide
carrier's resource grid shards along the subcarrier axis over the ranks
of a mesh axis; everything per-RE (LS pilot estimate, OCC despread,
interpolation, MMSE equalization, soft demapping) is rank-local, and the
ONLY communication is:

  - the raised-cosine smoothing filter's halo at shard boundaries
    (``sharded_estimator._halo_exchange``, +5 CDM pairs each side: 4 for
    the 9-tap filter, 1 for the linear interpolation straddling the
    boundary);
  - ``all_reduce``s for the bulk-delay slope and the global noise
    variance, RSRP and EVM accumulators (the reference's five ``psum``s,
    the scalar ones stacked into one call);
  - one ``all_gather`` of the (nsym_data, local_sc * nl * qm) LLR blocks,
    after which every rank holds the unsharded stream.

Constraints (checked): full-band type-1 DM-RS allocation starting at RB 0
with no data on DM-RS symbols, no CFO compensation, PT-RS or UCI; local
shard width whole PRBs (so every shard sees the same pilot geometry).

The output LLR stream is identical in layout to the unsharded
``phy.pusch._front_end`` (symbol-major, subcarrier order, layer x Qm per
RE), so the descramble + LDPC decode path consumes it unchanged.  The
equalizer is the plain per-RE ``ops.equalizer.equalize`` and the demapper
``demap_soft``, as in the reference's sharded front end (not kernels K3 or
K4).  With ``sharded_ldpc=False`` every rank decodes the whole TB (kernel
K1 on a CUDA tensor); with ``sharded_ldpc=True`` each rank decodes its
codeblocks (``sharded_decode``, K2) and the bits are gathered.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from ..ops import scrambling
from ..ops.equalizer import equalize
from ..ops.estimator import _rc_filter_taps
from ..ops.modulation import Modulation, demap_soft, quantize_llr
from ..ops.modulation.mapper import constellation
from ..phy.pusch import PuschConfig, _pusch_c_init
from ..ran import dmrs as dmrs_mod
from .mesh import Axis, axis as mesh_axis
from .sharded_encode import sc_slice
from .sharded_estimator import _halo_exchange


def _check_shardable(cfg: PuschConfig, nof_shards: int) -> tuple[int, int]:
    """Shard geometry: (local_sc, pad_sc).

    Carriers whose PRB count does not divide the mesh (273 PRB / 8 ranks
    — the flagship; SURVEY §7's pad-to-shardable + mask prescription) are
    zero-PADDED with whole PRBs on the right so every shard runs the same
    uniform-pilot program; the pad lives entirely in the LAST shard and is
    masked out of every estimate/metric (edge-hold extension keeps the
    smoother's band-edge semantics identical to the unsharded estimator;
    reference mask machinery counterpart:
    pusch_demodulator_impl.cpp:286-291).  Raises ValueError for a config
    outside the sharded front end's scope."""
    a = cfg.alloc
    why = ("full-band type-1 only" if a.rb_start != 0 or a.dmrs_config_type != 1 else
           "allocation must span the carrier" if a.nof_sc != cfg.nof_grid_sc else
           "no data on DM-RS symbols" if a.nof_cdm_groups_without_data != 2 else
           "no CFO compensation, PT-RS or UCI"
           if cfg.cfo_compensation or cfg.ptrs_enabled or cfg.uci is not None else None)
    prbs_per_shard = -(-a.rb_count // nof_shards)
    local_sc = prbs_per_shard * 12
    pad_sc = local_sc * nof_shards - cfg.nof_grid_sc
    if why is None and pad_sc >= local_sc:
        why = f"{a.rb_count} PRB leave a whole shard of {nof_shards} empty"
    if why is None and pad_sc and cfg.noise_method != "second_difference":
        why = "padded sharding masks the second-difference noise stencil only"
    if why is not None:
        raise ValueError(f"sharded front end: {why}")
    return local_sc, pad_sc


def padded_width(cfg: PuschConfig, nof_shards: int) -> int:
    """Grid width (subcarriers) expected by sharded_front_end on this mesh
    size — nof_grid_sc rounded up to whole PRBs per shard."""
    local_sc, _pad_sc = _check_shardable(cfg, nof_shards)
    return local_sc * nof_shards


def pad_grid(grid: torch.Tensor, cfg: PuschConfig, nof_shards: int) -> torch.Tensor:
    """Zero-pad (..., nsc) on the right to the shardable width."""
    pad = padded_width(cfg, nof_shards) - grid.shape[-1]
    if pad == 0:
        return grid
    return torch.nn.functional.pad(grid, (0, pad))


@functools.lru_cache(maxsize=None)
def _local_geometry(cfg: PuschConfig, local_sc: int):
    """Per-shard constants: pilot gather indices, OCC, interp tables."""
    nsym_d = len(cfg.alloc.dmrs_symbols)
    # Type-1 pilots of CDM group g sit at 4n + 2k' + g: per-PRB pattern.
    # OCC per layer (port = layer index, v1 convention).
    per_layer = [dmrs_mod.pilot_subcarriers(1, layer, local_sc // 12, 0)
                 for layer in range(cfg.nof_layers)]
    n_pairs = len(per_layer[0][0]) // 2
    wf_layers = np.stack([p[1] for p in per_layer]).astype(np.float32)  # (nl, Np_loc)
    ks_layers = np.stack([p[0] for p in per_layer]).astype(np.int64)  # (nl, Np_loc)
    # Interp: pair centers extended one pair each side (halo).  The
    # centers are the last layer's for every layer, the unsharded
    # estimator's convention (1, 5, 9, ... up to 2 layers; 2, 6, 10, ...
    # from 3 layers, one subcarrier off for layers 0-1; the reference's
    # sharded front end keeps port 0's, off for layers 2-3: ROADMAP Q3).
    ks_last = per_layer[-1][0]
    centers = (ks_last[0::2] + ks_last[1::2]) / 2.0
    pos = np.concatenate([[centers[0] - 4.0], centers, [centers[-1] + 4.0]])
    x = np.arange(local_sc, dtype=np.float32)
    li = np.clip(np.searchsorted(pos, x, side="right") - 1, 0, len(pos) - 2)
    frac = np.clip((x - pos[li]) / (pos[li + 1] - pos[li]), 0.0, 1.0)
    data_syms = [s for s in range(cfg.alloc.sym_start, cfg.alloc.sym_start + cfg.alloc.sym_count)
                 if s not in cfg.alloc.dmrs_symbols]
    return (ks_layers, wf_layers, n_pairs, li.astype(np.int64), frac.astype(np.float32),
            tuple(data_syms), nsym_d, float(centers[0]))


def _beta2(cfg: PuschConfig) -> float:
    """Square of the SCH-to-DMRS amplitude offset: pilot-domain noise ->
    data-RE-domain noise (pilots in _global_pilots are descaled by beta)."""
    return float(dmrs_mod.sch_to_dmrs_beta(cfg.alloc.nof_cdm_groups_without_data) ** 2)


@functools.lru_cache(maxsize=None)
def _global_pilots(cfg: PuschConfig) -> np.ndarray:
    """(nsym_d, Np_global) DM-RS values r(m) (host LFSR; type-1 full band).

    crb_start repoints the Gold-sequence index to the allocation's absolute
    CRB (TS 38.211 reference point CRB0) — windowed general allocations
    (sharded_decode_windowed) re-home compact windows this way."""
    ppb = dmrs_mod.pilots_per_prb(1)
    n_total = cfg.alloc.rb_count * ppb
    n_skip = cfg.alloc.crb_start * ppb
    out = []
    for sym in cfg.alloc.dmrs_symbols:
        c_init = dmrs_mod.dmrs_c_init(cfg.slot_in_frame, sym, cfg.dmrs_scrambling_id, cfg.n_scid)
        c = scrambling.gold_ref(int(c_init), 2 * (n_skip + n_total)).astype(np.float32)
        c = c[2 * n_skip :]
        out.append(((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2])) / np.sqrt(2))
    # Divide out the TX-side SCH-to-DMRS boost so the conj-multiply LS is
    # referenced to data-RE amplitude (see pusch._estimate_constants).
    beta = dmrs_mod.sch_to_dmrs_beta(cfg.alloc.nof_cdm_groups_without_data)
    return (np.stack(out) / np.float32(beta)).astype(np.complex64)


def _local_front_end(g: torch.Tensor, cfg: PuschConfig, ax: Axis, local_sc: int, pad_sc: int):
    """One rank's share: (npr, nsym, local_sc) block -> (llr_i8 (nsym_data,
    local_sc * nl * qm), noise_var, snr), the metrics all-reduced."""
    (ks_layers, wf_layers, n_pairs, li, frac, data_syms, nsym_d, c0) = _local_geometry(cfg,
                                                                                      local_sc)
    dev = g.device
    idx, size = ax.index, ax.size
    nl, npr = cfg.nof_layers, cfg.nof_rx_ports
    qm = int(cfg.modulation) if cfg.modulation != Modulation.PI_2_BPSK else 1
    taps = _rc_filter_taps()
    halo = len(taps) // 2 + 1  # filter halo + one interp pair
    # Pad geometry (last shard only): pairs/subcarriers beyond the real
    # band are edge-held for the smoother and masked from every reduction.
    n_pairs_pad = pad_sc // 4  # 3 pilot pairs per padded PRB (type 1)
    n_real_pairs = n_pairs - n_pairs_pad
    real_sc = local_sc - pad_sc
    is_last = idx == size - 1

    pilots = _global_pilots(cfg)
    if pad_sc:
        pilots = np.concatenate([pilots, np.ones((nsym_d, pad_sc // 2), pilots.dtype)], -1)
    r_loc = torch.from_numpy(np.ascontiguousarray(
        pilots.reshape(nsym_d, size, -1)[:, idx])).to(dev)  # (nsym_d, Np_loc)
    ks = torch.from_numpy(ks_layers).to(dev)  # (nl, Np_loc)
    wf = torch.from_numpy(wf_layers).to(dev)
    y_p = g[:, list(cfg.alloc.dmrs_symbols)][:, :, ks]  # (npr, nsym_d, nl, Np)
    y_p = torch.movedim(y_p, 2, 0)  # (nl, npr, nsym_d, Np)
    ls = y_p * r_loc.conj()[None, None] * wf[:, None, None, :]
    pair = ls.reshape(ls.shape[:-1] + (n_pairs, 2))
    h_pair_sym = pair.mean(dim=-1)  # (nl, npr, nsym_d, n_pairs)
    h_pair = h_pair_sym.mean(dim=-2)  # time avg: (nl, npr, n_pairs)

    jj = torch.arange(n_pairs, device=dev)
    pair_valid = torch.ones(n_pairs, dtype=torch.float32, device=dev)
    if pad_sc and is_last:
        # Mask of REAL pairs and edge-hold extension of the channel into
        # the pad, so the RC smoother sees exactly the unsharded
        # estimator's band-edge clamp at the true carrier edge.
        pair_valid = (jj < n_real_pairs).to(torch.float32)
        h_pair = torch.where(pair_valid > 0, h_pair, h_pair[..., n_real_pairs - 1 : n_real_pairs])

    # Halo exchange + RC smoothing; keep one extra smoothed pair per side
    # for the boundary-straddling interpolation.
    ext = _halo_exchange(h_pair, halo, ax)  # (nl, npr, n + 2 halo)

    # Bulk-delay compensation, matching ops/estimator.estimate_channel: a
    # global per-(layer, port) phase slope over adjacent pairs (the
    # cross-shard product comes from the halo; shard 0 has no left
    # neighbour), derotate before smoothing/interpolation, re-rotate
    # exactly at every subcarrier.
    prod = ext[..., halo : halo + n_pairs] * ext[..., halo - 1 : halo - 1 + n_pairs].conj()
    # Exclude the global left edge AND any product touching a pad pair
    # (edge-held pads give angle-0 products that bias the slope).
    tmask = pair_valid.clone()
    if idx == 0:
        tmask[0] = 0.0
    slope = torch.angle(ax.all_reduce((prod * tmask).sum(dim=-1)))[..., None]  # (nl, npr, 1)
    g_ext = (idx * n_pairs - halo) + torch.arange(n_pairs + 2 * halo, dtype=torch.float32,
                                                  device=dev)
    ext_d = ext * torch.exp(-1j * slope * g_ext)
    # At the carrier's edges the unsharded estimator replicates its
    # derotated edge pairs: hold those (the reference's sharded front end
    # holds the pairs before derotating them, which tilts the edge values
    # by the slope: a repair, ROADMAP Q3).
    if idx == 0:
        ext_d[..., :halo] = ext_d[..., halo : halo + 1]
    if is_last:
        last = halo + n_real_pairs
        ext_d[..., last:] = ext_d[..., last - 1 : last]

    sm_len = n_pairs + 2  # [-1 .. n] pair positions
    sm = torch.zeros(h_pair.shape[:-1] + (sm_len,), dtype=h_pair.dtype, device=dev)
    for i in range(len(taps)):
        sm = sm + float(taps[i]) * ext_d[..., i : i + sm_len]
    # At the global edges the unsharded interp clamps to the first/last
    # smoothed pair; replicate it into the interp halo slot, and on a
    # padded last shard into the pad pairs too (the reference clamps at the
    # pad's end: a repair, ROADMAP Q3).
    if idx == 0:
        sm[..., 0] = sm[..., 1]
    if is_last:
        sm[..., n_real_pairs + 1 :] = sm[..., n_real_pairs : n_real_pairs + 1]

    li_t = torch.from_numpy(li).to(dev)
    frac_t = torch.from_numpy(frac).to(dev)
    h = sm[..., li_t] * (1 - frac_t) + sm[..., li_t + 1] * frac_t  # (nl, npr, local_sc)
    # Re-rotation at the global subcarrier positions (pair centers sit at
    # c0 + 4n, so k_pair = (x - c0)/4).
    x_glob = idx * local_sc + torch.arange(local_sc, dtype=torch.float32, device=dev)
    h = h * torch.exp(1j * slope * ((x_glob - c0) / 4.0))

    # Noise variance / RSRP accumulators, all-reduced in one call.
    rsrp_terms = [((h_pair_sym.abs() ** 2) * pair_valid).sum(),
                  pair_valid.sum() * nl * npr * nsym_d]
    if cfg.noise_method == "second_difference":
        # Same estimator as the unsharded path
        # (ops/pusch_estimate.second_difference_noise): the OCC despread in h_pair has removed
        # the co-CDM layer exactly, and the (1, -2, 1) stencil over
        # neighbouring pairs cancels channel level + slope, so |d2|^2 reads
        # 3 sigma^2 / nsym_d.  Cross-shard neighbours come from the halo
        # already exchanged for the RC filter; the two global-edge pairs
        # have no physical neighbour and are masked out.  The stencil runs
        # on the bulk-delay-derotated pairs, like the unsharded estimator.
        d2 = (ext_d[..., halo - 1 : halo - 1 + n_pairs] - 2.0 * ext_d[..., halo : halo + n_pairs]
              + ext_d[..., halo + 1 : halo + 1 + n_pairs])
        # The last VALID pair (n_real_pairs-1 on a padded last shard) has
        # no physical right neighbour; pad pairs are excluded too.
        edge = ((jj == 0) & (idx == 0)) | ((jj >= n_real_pairs - 1) & is_last)
        w_valid = torch.where(edge, 0.0, 1.0)
        sums = ax.all_reduce(torch.stack([((d2.abs() ** 2) * w_valid).sum(),
                                          w_valid.sum() * nl * npr, *rsrp_terms]))
        nv_loc = sums[0] / torch.clamp_min(sums[1], 1.0) * nsym_d / 3.0
        nv = torch.clamp_min(nv_loc * _beta2(cfg), 1e-10)
    else:
        h_rep = h_pair_sym.repeat_interleave(2, dim=-1)
        nv_loc = ((ls - h_rep).abs() ** 2).mean() * 2.0 * _beta2(cfg)
        sums = ax.all_reduce(torch.stack([nv_loc, *rsrp_terms]))
        nv = torch.clamp_min(sums[0] / size, 1e-10)
    rsrp = sums[-2] / torch.clamp_min(sums[-1], 1.0)

    # Equalize + demap the local data REs (all sc of data symbols).
    y_d = g[:, list(data_syms)]  # (npr, nsym_data, local_sc)
    nsym_data = len(data_syms)
    y_flat = y_d.reshape(npr, -1)  # sym-major, sc within symbol
    h_d = torch.movedim(h, 0, -1)  # (npr, local_sc, nl)
    h_full = h_d[:, None].expand(npr, nsym_data, local_sc, nl).reshape(npr, -1, nl)
    x_hat, eq_nvar = equalize(y_flat.T, h_full.transpose(0, 1), nv, method=cfg.equalizer)
    # SNR metric following cfg.sinr_method like the unsharded chain:
    # decision-directed EVM of the equalized symbols (default), or the
    # pilot-domain rsrp/nv.
    if cfg.sinr_method == "post_equalization":
        # Decision-directed EVM with pad subcarriers masked (zero-input pad
        # REs equalize to junk that would bias the metric).
        lut = torch.from_numpy(constellation(cfg.modulation)).to(dev)
        err2 = ((x_hat[..., None] - lut).abs() ** 2).amin(dim=-1)  # (nd, nl)
        sc_valid = torch.ones(local_sc, dtype=torch.float32, device=dev)
        if pad_sc and is_last:
            sc_valid = (torch.arange(local_sc, device=dev) < real_sc).to(torch.float32)
        w_re = sc_valid.repeat(nsym_data)[:, None]  # (nd, 1)
        e2 = ax.all_reduce(torch.stack([(err2 * w_re).sum(), w_re.sum() * nl]))
        snr = 1.0 / torch.clamp_min(e2[0] / e2[1], 1e-12)
    else:
        snr = rsrp / nv
    llr_layers = demap_soft(x_hat.T, eq_nvar.T, cfg.modulation)  # (nl, nd*qm)
    nd = llr_layers.shape[-1] // qm
    llr = torch.movedim(llr_layers.reshape(nl, nd, qm), 0, 1)  # (nd, nl, qm)
    llr_i8 = quantize_llr(llr.reshape(-1), cfg.llr_range_limit)
    # (nsym_data, local_sc * nl * qm): symbol-major so the gathered global
    # array matches the unsharded data-RE order exactly.
    return llr_i8.reshape(nsym_data, local_sc * nl * qm), nv, snr


def sharded_front_end(grid: torch.Tensor, cfg: PuschConfig, mesh, axis: str = "sp"):
    """grid: this rank's (npr, nsym, local_sc) block of the carrier, the
    subcarrier axis sharded over ``axis`` of the mesh (the last block
    zero-padded to whole PRBs, as ``sharded_encode.sc_slice`` cuts it) ->
    (llr_pre_descramble (G,) int8, noise_var, snr), the same on every
    rank.

    Pair with descrambling and ``decode_transport_block``, as
    ``sharded_decode`` does."""
    ax = mesh_axis(mesh, axis)
    local_sc, pad_sc = _check_shardable(cfg, ax.size)
    if grid.shape[-1] != local_sc:
        raise ValueError(f"sharded front end: a block of {grid.shape[-1]} subcarriers, want "
                         f"this rank's {local_sc} of the carrier's {cfg.nof_grid_sc}")
    llr_loc, nv, snr = _local_front_end(grid, cfg, ax, local_sc, pad_sc)
    llr2d = ax.all_gather(llr_loc, dim=1)
    qm = int(cfg.modulation) if cfg.modulation != Modulation.PI_2_BPSK else 1
    # Pad REs sit at the tail of every symbol row (the last shard's padded
    # PRBs): slice them off so the LLR stream is identical in layout to
    # the unsharded front end.
    return llr2d[:, : cfg.nof_grid_sc * cfg.nof_layers * qm].reshape(-1), nv, snr


def sharded_decode_windowed(grid: torch.Tensor, rnti, cfg: PuschConfig, mesh,
                            axis: str = "sp", **kw):
    """General-allocation sharded decode: a PARTIAL-band allocation
    (rb_start > 0 and/or rb_count < carrier) is sliced out of the full
    grid (every rank passes the whole carrier) and re-homed as a compact
    full-band window config — crb_start keeps the absolute-CRB pilot/Gold
    indexing — then this rank's block of the window runs the padded
    sharded path (the reference handles arbitrary allocations through its
    RE-mask machinery, pusch_demodulator_impl.cpp:286-291; here the window
    slice plus pad-to-shardable+mask cover the same space)."""
    a = cfg.alloc
    if not (a.rb_start == 0 and a.nof_sc == cfg.nof_grid_sc):
        grid = grid[..., a.sc_start : a.sc_start + a.nof_sc]
        cfg = dataclasses.replace(
            cfg, alloc=dataclasses.replace(a, rb_start=0, crb_start=a.crb_start + a.rb_start),
            nof_grid_sc=a.nof_sc)
    return sharded_decode(sc_slice(grid, mesh, axis), rnti, cfg, mesh, axis=axis, **kw)


def sharded_decode(grid: torch.Tensor, rnti, cfg: PuschConfig, mesh, axis: str = "sp",
                   sharded_ldpc: bool = False, decode_axis=None) -> dict:
    """Full sp-sharded PUSCH decode: sharded front end -> descramble ->
    LDPC decode (optionally codeblock-sharded over ``decode_axis``, which
    defaults to the front end's subcarrier axis; pass a tuple like ("sp",
    "dp") on a 2-D mesh to spread codeblocks over every rank — the sp x dp
    composition of the two parallel axes).  Every rank returns the whole
    result."""
    from ..phy.sch import _dematch_stage, _desegment_stage, decode_transport_block
    from .sharded_decode import decode_codeblocks_sharded

    llr, nv, snr = sharded_front_end(grid, cfg, mesh, axis)
    rnti_t = torch.as_tensor(rnti, dtype=torch.int64, device=llr.device)
    llr = scrambling.descramble_llrs(llr, _pusch_c_init(rnti_t, cfg.n_id))
    snr_db = 10.0 * torch.log10(torch.clamp_min(snr, 1e-12))
    if not sharded_ldpc:
        tb, ok, harq = decode_transport_block(llr, cfg.sch, cfg.nof_ldpc_iterations)
        return {"tb_bits": tb, "tb_crc_ok": ok, "harq_buffer": harq, "noise_var": nv,
                "snr_db": snr_db}
    dax = decode_axis if decode_axis is not None else axis
    dec = mesh_axis(mesh, dax)
    seg = cfg.sch.seg
    flat = _dematch_stage(llr, None, cfg.sch)  # (C, N) int8
    c = flat.shape[0]
    per = -(-c // dec.size)
    flat = torch.cat([flat, flat.new_zeros((per * dec.size - c, flat.shape[1]))])
    bits, _bad = decode_codeblocks_sharded(
        flat[dec.index * per : (dec.index + 1) * per], seg.base_graph, seg.lifting_size, mesh,
        nof_iterations=cfg.nof_ldpc_iterations, axis=dax)
    tb, ok = _desegment_stage(dec.all_gather(bits, dim=0)[:c], cfg.sch, ())
    return {"tb_bits": tb, "tb_crc_ok": ok, "noise_var": nv, "snr_db": snr_db}
