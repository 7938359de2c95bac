"""Every PUCCH format 2 occasion of a call received in one launch (kernel
K6): the DM-RS channel estimate, MRC over the ports, the QPSK LLRs,
descrambling and the UCI decode (polar SSC with its CRC, or the
short-block ML detection).

``receive`` is the entry point: a CUDA grid launches the hand-written
kernel (``csrc/pucch_f2_rx.cu``, one block an occasion), a CPU grid runs
``receive_plain`` below, the eager chain ``phy/pucch_f2.process`` ran an
occasion at a time before the kernel: ``estimator.estimate_channel`` (per
symbol with a second hop), MRC, ``demap_soft``, the Gold sign flip and
``uci.decode_uci``.  Both return (bits (O, K_max) uint8, ok (O,) bool,
snr_db (O,) float32) for the O configurations, each occasion's K UCI bits
first in its row, zeros after.

The host plans of an occasion (its RE layout and DM-RS pilots, copied from
the reference) live here too; ``params`` packs those of a tuple of
configurations, with the interpolation plan, the data Gold bits, the polar
code's rate-dematch plan and SSC walk or the short-block basis, into one
int32 buffer that is uploaded once per tuple and device.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import cuda_lib, estimator, scrambling, short_block, uci
from ._tables import device_table
from .crc import POLYS
from .estimator import estimate_channel
from .modulation import Modulation, demap_soft
from .polar import code as polar_code_mod
from .polar import decoder as polar_decoder
from .polar.encoder import _dematch_plan

NRE = 12


# ---- the host plans of one occasion ---------------------------------------------

@functools.lru_cache(maxsize=None)
def re_layout(cfg):
    """(data, dmrs) flat indices into one port's (14 * nof_grid_sc) grid."""
    data, dmrs = [], []
    for si, sym in enumerate(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)):
        rb0 = cfg.rb_start_of(si)
        for rb in range(rb0, rb0 + cfg.rb_count):
            for re in range(NRE):
                k = sym * cfg.nof_grid_sc + rb * NRE + re
                (dmrs if re % 3 == 1 else data).append(k)
    return np.asarray(data, np.int32), np.asarray(dmrs, np.int32)


def dmrs_pilots(cfg) -> np.ndarray:
    """(nsym, 4*rb_count) QPSK pilots (TS 38.211 §6.4.1.3.2.1)."""
    out = []
    for si, sym in enumerate(range(cfg.start_symbol, cfg.start_symbol + cfg.nof_symbols)):
        c_init = ((1 << 17) * (14 * cfg.slot_in_frame + sym + 1) * (2 * cfg.n_id0 + 1)
                  + 2 * cfg.n_id0) % (1 << 31)
        # Pilot index counts 4 per PRB from CRB0, at this symbol's hop.
        rb0 = cfg.rb_start_of(si)
        n0 = rb0 * 4
        n1 = (rb0 + cfg.rb_count) * 4
        c = scrambling.gold_ref(c_init, 2 * n1)
        re = 1.0 - 2.0 * c[0::2].astype(np.float32)
        im = 1.0 - 2.0 * c[1::2].astype(np.float32)
        out.append(((re + 1j * im) / np.sqrt(2))[n0:n1])
    return np.stack(out).astype(np.complex64)


def c_init(cfg) -> int:
    """The data scrambling seed, rnti 2^15 + n_id."""
    return (cfg.rnti << 15) + cfg.n_id


@functools.lru_cache(maxsize=None)
def data_subcarriers(cfg) -> tuple:
    """Per symbol: the data REs' subcarriers relative to that symbol's hop."""
    data_idx, _ = re_layout(cfg)
    per_sym = cfg.rb_count * 8
    return tuple((data_idx[si * per_sym : (si + 1) * per_sym] % cfg.nof_grid_sc)
                 - cfg.rb_start_of(si) * NRE for si in range(cfg.nof_symbols))


def pair_positions(rb_count: int) -> tuple:
    """The DM-RS pair centres relative to the allocation start."""
    return tuple(float((3 * i + 1 + 3 * (i + 1) + 1) / 2) for i in range(0, 4 * rb_count, 2))


layout_on = device_table(lambda cfg, which: re_layout(cfg)[which].astype(np.int64))
pilots_on = device_table(dmrs_pilots)
_sc_on = device_table(lambda cfg, si: data_subcarriers(cfg)[si].astype(np.int64))


# ---- the plain version ------------------------------------------------------------

def _receive_one(grid: torch.Tensor, cfg):
    """One occasion through the eager chain -> (uci_bits (K,) uint8, ok
    bool, snr_db float32)."""
    p = cfg.nof_rx_ports
    dev = grid.device
    gflat = grid.reshape(p, -1)
    # Channel estimate from the DM-RS: pilots at k % 3 == 1, 4 per PRB.
    y_p = gflat[:, layout_on(dev, cfg, 1)].reshape(p, cfg.nof_symbols, -1)
    ref = pilots_on(dev, cfg)[None]  # (1, nsym, Np)
    wf = torch.ones(y_p.shape[-1], dtype=torch.float32, device=dev)
    pair_pos = pair_positions(cfg.rb_count)
    nof_sc = cfg.rb_count * NRE
    if cfg.second_hop_rb_start is None:
        h, nvar, metrics = estimate_channel(y_p, ref, wf, pair_pos, nof_sc)
        h_per_sym = [h] * cfg.nof_symbols
    else:
        # Frequency hopping: each symbol sees its own channel segment,
        # estimated from its own DM-RS.
        h_per_sym, nvars = [], []
        for si in range(cfg.nof_symbols):
            h_s, nvar_s, metrics = estimate_channel(y_p[:, si : si + 1], ref[:, si : si + 1], wf,
                                                    pair_pos, nof_sc)
            h_per_sym.append(h_s)
            nvars.append(nvar_s)
        nvar = torch.stack(nvars).mean(dim=0)

    # MRC across ports, per symbol hop.
    h_d = torch.cat([h_per_sym[si][:, _sc_on(dev, cfg, si)] for si in range(cfg.nof_symbols)],
                    dim=1)  # (P, Nd)
    y_d = gflat[:, layout_on(dev, cfg, 0)]
    den = (h_d.abs() ** 2).sum(dim=0) + 1e-12
    x_hat = (h_d.conj() * y_d).sum(dim=0) / den
    llrs = demap_soft(x_hat, nvar.mean() / den, Modulation.QPSK)
    seq = scrambling.gold_sequence(torch.tensor(c_init(cfg), device=dev), llrs.shape[-1])
    llrs = torch.where(seq == 1, -llrs, llrs)
    bits, ok = uci.decode_uci(llrs, cfg.nof_uci_bits)
    snr_db = 10.0 * torch.log10(torch.clamp_min(metrics["snr"].mean(), 1e-12))
    return bits, ok, snr_db


def receive_plain(grid: torch.Tensor, cfgs) -> tuple:
    """Plain torch version of ``receive`` (same arguments): the eager
    chain an occasion at a time, stacked."""
    outs = [_receive_one(grid, cfg) for cfg in cfgs]
    k_max = max(cfg.nof_uci_bits for cfg in cfgs)
    bits = torch.stack([torch.nn.functional.pad(b, (0, k_max - b.shape[-1])) for b, _, _ in outs])
    return (bits, torch.stack([ok for _, ok, _ in outs]),
            torch.stack([snr for _, _, snr in outs]).to(torch.float32))


# ---- the kernel's parameter buffer --------------------------------------------------

# Global words: the 9 smoothing taps, then the number of occasions.
_GLOBAL_WORDS = 16
# One occasion's header (csrc/pucch_f2_rx.cu reads the same indices).
(H_NSC, H_SYM0, H_NSYM, H_RBS, H_RB0, H_RB1, H_HOP, H_PORTS, H_K, H_E, H_POLAR, H_N, H_REPS,
 H_CRC_LEN, H_CRC_POLY, H_NOPS, H_PILOTS, H_GOLD, H_INTERP, H_PROG, H_DEMATCH, H_INFO) = range(22)
_HDR_WORDS = 24
# The SSC walk's instructions (op, lo, size).
OP_F, OP_G, OP_ZERO, OP_PC, OP_INFO, OP_RATE1, OP_COMBINE = range(7)
# Limits of the kernel's shared arrays.
MAX_PORTS, MAX_SYMBOLS, MAX_RB, MAX_N = 4, 2, 16, 512


def _f32_words(x) -> np.ndarray:
    return np.ascontiguousarray(np.asarray(x, np.float32)).view(np.int32).reshape(-1)


@functools.lru_cache(maxsize=None)
def ssc_program(code: polar_code_mod.PolarCode) -> np.ndarray:
    """(ops, 3) int32: ``polar.decoder._plan``'s tree as the kernel walks
    it.  A node of size s reads its LLRs at L[s, 2s) and leaves its
    partial sums at X[lo, lo + s), its decided bits at U[lo, lo + s):
    F and G fill the child's L[s/2, s) from the parent's, COMBINE folds
    the right child's partial sums into the left's.  An all-frozen left
    child skips F (its partial sums are zero, so G adds)."""
    ops = []

    def walk(node, lo: int, size: int):
        kind = node[0]
        if kind in ("zero", "rate1"):
            ops.append((OP_ZERO if kind == "zero" else OP_RATE1, lo, size))
            return
        if kind in ("pc", "info"):
            ops.append((OP_PC if kind == "pc" else OP_INFO, lo, 1))
            return
        _, _, left, right = node
        half = size // 2
        if left[0] != "zero":
            ops.append((OP_F, lo, size))
        walk(left, lo, half)
        ops.append((OP_G, lo, size))
        walk(right, lo + half, half)
        ops.append((OP_COMBINE, lo, size))

    walk(polar_decoder._plan(code), 0, code.nval)
    return np.asarray(ops, np.int32).reshape(-1, 3)


@functools.lru_cache(maxsize=None)
def _dematch_words(e: int, code: polar_code_mod.PolarCode) -> np.ndarray:
    """(reps, N) int32: per decoder input position the received LLRs that
    the rate dematch sums into it, in transmission order, as indices into
    the interleaved (received) order; -1 adds nothing, -2 in row 0 marks a
    shortened position (a known zero bit)."""
    inv = np.argsort(polar_code_mod.channel_interleaver_pattern(e))
    plan = _dematch_plan(code)
    out = np.where(plan < e, inv[np.minimum(plan, e - 1)], -1).astype(np.int32)
    if code.rm_mode == "shortening":
        known = np.setdiff1d(np.arange(code.nval), polar_code_mod.rate_match_indices(code))
        out[0, known] = -2
    return out


@functools.lru_cache(maxsize=None)
def _short_basis(k: int) -> tuple:
    """(mother length n, K masks: bit j of mask t is bit j of the codeword
    of message bit t) of the K-bit short block code."""
    cw = short_block._mother_codewords(k)  # (2^K, n), LSB-first message index
    masks = [int(sum(int(b) << j for j, b in enumerate(cw[1 << t]))) for t in range(k)]
    return cw.shape[1], tuple(masks)


@functools.lru_cache(maxsize=256)
def _occasion(cfg) -> tuple:
    """(header words with section offsets relative to the occasion's data,
    data words) of one configuration."""
    k, nsym, rbs, p = cfg.nof_uci_bits, cfg.nof_symbols, cfg.rb_count, cfg.nof_rx_ports
    e = cfg.nof_coded_bits
    if not (1 <= p <= MAX_PORTS and 1 <= nsym <= MAX_SYMBOLS and 1 <= rbs <= MAX_RB
            and 1 <= k and cfg.start_symbol + nsym <= 14):
        raise ValueError(f"pucch_f2_rx: K6 takes 1-{MAX_PORTS} ports, 1-{MAX_SYMBOLS} symbols "
                         f"and 1-{MAX_RB} PRB inside the slot, got {cfg}")
    for si in range(nsym):
        if cfg.rb_start_of(si) < 0 or (cfg.rb_start_of(si) + rbs) * NRE > cfg.nof_grid_sc:
            raise ValueError(f"pucch_f2_rx: the allocation leaves the grid: {cfg}")
    hdr = np.zeros(_HDR_WORDS, np.int32)
    hdr[[H_NSC, H_SYM0, H_NSYM, H_RBS, H_RB0, H_RB1, H_HOP, H_PORTS, H_K, H_E]] = (
        cfg.nof_grid_sc, cfg.start_symbol, nsym, rbs, cfg.rb_start_of(0),
        cfg.rb_start_of(nsym - 1), cfg.second_hop_rb_start is not None, p, k, e)
    sections = []

    def put(hkey: int, words) -> None:
        words = np.asarray(words, np.int32).reshape(-1)
        hdr[hkey] = sum(len(s) for s in sections)
        # Every section starts on an even word, so float2 reads align.
        sections.append(np.concatenate([words, np.zeros(len(words) % 2, np.int32)]))

    put(H_PILOTS, _f32_words(dmrs_pilots(cfg).view(np.float32)))
    gold = scrambling.gold_ref(c_init(cfg), e).astype(np.uint64)
    packed = np.zeros(-(-e // 32), np.uint64)
    np.add.at(packed, np.arange(e) // 32, gold << (np.arange(e) % 32).astype(np.uint64))
    put(H_GOLD, packed.astype(np.uint32).view(np.int32))
    li, ri, fr, xc = estimator._interp_plan(pair_positions(rbs), rbs * NRE)
    put(H_INTERP, np.stack([li.astype(np.int32), ri.astype(np.int32), _f32_words(fr),
                            _f32_words(xc)], axis=1))
    if k <= 11:
        n, masks = _short_basis(k)
        hdr[H_N] = n
        put(H_PROG, np.asarray(masks, np.int64).astype(np.uint32).view(np.int32))
    else:
        if uci._is_segmented(k, e):
            raise ValueError(f"pucch_f2_rx: K6 decodes one polar segment, not K={k}, E={e}")
        code = uci._uci_code(k, e)
        if code.nval > MAX_N:
            raise ValueError(f"pucch_f2_rx: polar N={code.nval} above {MAX_N}")
        name = uci._crc_name(k)
        poly, crc_len = POLYS[name]
        prog = ssc_program(code)
        dematch = _dematch_words(e, code)
        hdr[[H_POLAR, H_N, H_REPS, H_CRC_LEN, H_CRC_POLY, H_NOPS]] = (
            1, code.nval, dematch.shape[0], crc_len, poly, len(prog))
        put(H_PROG, prog)
        put(H_DEMATCH, dematch)
        put(H_INFO, np.asarray(code.info_set, np.int32))
    return hdr, np.concatenate(sections)


@functools.lru_cache(maxsize=64)
def params(cfgs: tuple) -> np.ndarray:
    """The int32 parameter buffer of a tuple of configurations: the global
    words (the smoothing taps, the count), every occasion's header, then
    their data, with the header's section offsets made absolute."""
    o = len(cfgs)
    words = [np.zeros(_GLOBAL_WORDS, np.int32), np.zeros(o * _HDR_WORDS, np.int32)]
    words[0][:9] = _f32_words(estimator._rc_filter_taps())
    words[0][9] = o
    base = _GLOBAL_WORDS + o * _HDR_WORDS
    for i, cfg in enumerate(cfgs):
        hdr, data = _occasion(cfg)
        hdr = hdr.copy()
        hdr[[H_PILOTS, H_GOLD, H_INTERP, H_PROG, H_DEMATCH, H_INFO]] += base
        words[1][i * _HDR_WORDS : (i + 1) * _HDR_WORDS] = hdr
        words.append(data)
        base += len(data)
    return np.concatenate(words)


@functools.lru_cache(maxsize=64)
def _params_on(device: torch.device, cfgs: tuple) -> torch.Tensor:
    return torch.from_numpy(params(cfgs)).to(device)


# ---- the kernel ---------------------------------------------------------------------

def receive(grid: torch.Tensor, cfgs) -> tuple:
    """Receive every PUCCH F2 occasion of ``cfgs`` on one grid.

    grid: (P, nsym, nsc) complex64 received slot, read as
    ``grid.reshape(P_o, -1)`` by an occasion of P_o ports; cfgs: a
    sequence of ``PucchFormat2Config``.  Returns (bits (O, K_max) uint8,
    ok (O,) bool, snr_db (O,) float32).

    CUDA grid: kernel K6 (one launch; 1-4 ports, 1-16 PRB, 1-2 symbols, a
    contiguous grid); CPU grid: the plain version."""
    cfgs = tuple(cfgs)
    if not cfgs:
        raise ValueError("pucch_f2_rx: no occasion")
    if grid.device.type == "cpu":
        return receive_plain(grid, cfgs)
    if grid.device.type != "cuda":
        raise ValueError(f"pucch_f2_rx: unsupported device {grid.device}")
    if grid.dtype != torch.complex64 or not grid.is_contiguous():
        raise ValueError(f"pucch_f2_rx: want a contiguous complex64 grid, got {grid.dtype}")
    numel = grid.numel()
    for cfg in cfgs:
        if numel % cfg.nof_rx_ports or ((cfg.start_symbol + cfg.nof_symbols) * cfg.nof_grid_sc
                                        > numel // cfg.nof_rx_ports):
            raise ValueError(f"pucch_f2_rx: a grid of {numel} REs has no room for {cfg}")
    dev = grid.device
    table = _params_on(dev, cfgs)
    o, k_max = len(cfgs), max(cfg.nof_uci_bits for cfg in cfgs)
    bits = torch.empty((o, k_max), dtype=torch.uint8, device=dev)
    ok = torch.empty((o,), dtype=torch.bool, device=dev)
    snr_db = torch.empty((o,), dtype=torch.float32, device=dev)
    lib = cuda_lib.library()
    with torch.cuda.device(dev):
        status = lib.pucch_f2_rx(grid.data_ptr(), numel, table.data_ptr(), o, k_max,
                                 bits.data_ptr(), ok.data_ptr(), snr_db.data_ptr(),
                                 torch.cuda.current_stream(dev).cuda_stream)
    cuda_lib.check(status, "pucch_f2_rx")
    receive.launches += 1
    return bits, ok, snr_db


receive.launches = 0


def occupancy() -> dict:
    """K6's registers a thread and resident blocks per SM, by the CUDA
    occupancy calculator on the current device."""
    regs, blocks = ctypes.c_int(0), ctypes.c_int(0)
    cuda_lib.check(cuda_lib.library().pucch_f2_rx_occupancy(
        ctypes.byref(regs), ctypes.byref(blocks)), "pucch_f2_rx_occupancy")
    return {"registers": regs.value, "blocks_per_sm": blocks.value}
