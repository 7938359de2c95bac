"""Plain LDPC transport coding of the benchmark's reference (TS 38.212
5.2.2, 5.3.2, 5.4.2): segmentation, encoding, rate matching, rate
dematching with HARQ combining, and layered normalized min-sum decoding
that also reports the iterations each codeblock needed.

Frozen copies of the plain arithmetic, trimmed to the benchmark's
configurations.  The decoder is srsRAN's: float32 state, channel LLRs
clamped to +-64, punctured columns and erasures at 0, fillers at +64,
scaling 0.8 with the duplicate-minimum rule, the a-posteriori update as one
fused multiply-add, early stop per codeblock after a whole iteration that
saw every check satisfied.  Only the check rows that can reach the message
bits run under limited-buffer rate matching.
"""

from __future__ import annotations

import dataclasses
import functools
import os

import numpy as np
import torch

from . import nr

BG1, BG2 = 1, 2
_GEOMETRY = {BG1: (46, 68, 22), BG2: (42, 52, 10)}  # check rows, columns, message columns
LIFTING_SETS = ((2, 4, 8, 16, 32, 64, 128, 256), (3, 6, 12, 24, 48, 96, 192, 384),
                (5, 10, 20, 40, 80, 160, 320), (7, 14, 28, 56, 112, 224),
                (9, 18, 36, 72, 144, 288), (11, 22, 44, 88, 176, 352),
                (13, 26, 52, 104, 208), (15, 30, 60, 120, 240))
ALL_LIFTING_SIZES = tuple(sorted(z for s in LIFTING_SETS for z in s))
MAX_SEG_BITS = {BG1: 8448, BG2: 3840}
CB_CRC_BITS = 24
LLR_MAX = 120
LLR_INF = 127
SCALING = 0.8
INPUT_CLAMP = 64.0
_BIG = 3.0e38
_RV_NUM = {BG1: (0, 17, 33, 56), BG2: (0, 13, 25, 43)}
_DEN = {BG1: 66, BG2: 50}


# ---- graphs -----------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _raw_tables():
    d = np.load(os.path.join(os.path.dirname(__file__), "bg_tables.npz"))
    return {BG1: d["bg1"], BG2: d["bg2"]}


@dataclasses.dataclass(frozen=True)
class Graph:
    bg: int
    z: int
    m: int
    n: int
    kb: int
    shifts: np.ndarray  # (m, n), -1 = no edge

    @property
    def nof_codeword_bits(self) -> int:
        return (self.n - 2) * self.z

    def row_edges(self, row: int):
        cols = np.nonzero(self.shifts[row] >= 0)[0]
        return [(int(c), int(self.shifts[row, c])) for c in cols]


@functools.lru_cache(maxsize=None)
def get_graph(bg: int, z: int) -> Graph:
    m, n, kb = _GEOMETRY[bg]
    ils = next(i for i, s in enumerate(LIFTING_SETS) if z in s)
    raw = _raw_tables()[bg][ils][:m, :n].astype(np.int64)
    return Graph(bg, z, m, n, kb, np.where(raw == 0xFFFF, -1, raw % z).astype(np.int32))


# ---- segmentation (5.2.2) ----------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Segments:
    tbs: int
    bg: int
    c: int  # codeblocks
    z: int
    k: int  # K = Kb * Z
    k_prime: int  # payload and CRC bits a codeblock
    zero_pad: int
    tb_crc: str

    @property
    def n(self) -> int:
        return get_graph(self.bg, self.z).nof_codeword_bits


def segments(tbs: int, rate: float) -> Segments:
    bg = BG2 if (tbs <= 292 or (tbs <= 3824 and rate <= 0.67) or rate <= 0.25) else BG1
    tb_crc = "24A" if tbs > 3824 else "16"
    b = tbs + nr.POLYS[tb_crc][1]
    c = 1 if b <= MAX_SEG_BITS[bg] else -(-b // (MAX_SEG_BITS[bg] - CB_CRC_BITS))
    b_prime = b + (CB_CRC_BITS * c if c > 1 else 0)
    k_prime = -(-b_prime // c)
    if bg == BG1:
        kb = 22
    else:
        kb = 10 if b > 640 else 9 if b > 560 else 8 if b > 192 else 6
    z = next(z for z in ALL_LIFTING_SIZES if kb * z >= k_prime)
    return Segments(tbs, bg, c, z, _GEOMETRY[bg][2] * z, k_prime, k_prime * c - b_prime, tb_crc)


def segment_tx(tb_bits: torch.Tensor, s: Segments) -> torch.Tensor:
    """(..., A) -> (..., C, K): TB CRC, C segments, each with CRC24B when
    C > 1, then the filler bits as zeros."""
    bits = nr.crc_append(tb_bits, s.tb_crc)
    if s.zero_pad:
        bits = torch.nn.functional.pad(bits, (0, s.zero_pad))
    segs = bits.reshape(bits.shape[:-1] + (s.c, bits.shape[-1] // s.c))
    if s.c > 1:
        segs = nr.crc_append(segs, "24B")
    return torch.nn.functional.pad(segs, (0, s.k - s.k_prime))


def desegment_rx(cb_bits: torch.Tensor, s: Segments):
    """(..., C, K) decoded bits -> ((..., A) payload, (...,) every CRC ok)."""
    payload = cb_bits[..., :s.k_prime]
    l_tb = nr.POLYS[s.tb_crc][1]
    if s.c > 1:
        nof_bad = nr.crc(payload, "24B").to(torch.int32).sum(dim=(-2, -1))
        payload = payload[..., :s.k_prime - CB_CRC_BITS]
        nof_bad = nof_bad + (~nr.crc_ok_concat(payload, s.tb_crc)).to(torch.int32)
    tb = payload.reshape(payload.shape[:-2] + (-1,))
    tb = tb[..., :tb.shape[-1] - s.zero_pad]
    if s.c == 1:
        nof_bad = nr.crc(tb, s.tb_crc).to(torch.int32).sum(dim=-1)
    return tb[..., :tb.shape[-1] - l_tb], nof_bad == 0


# ---- encoding (5.3.2) ------------------------------------------------------------

def _nof_ext_rows(g: Graph, n_cb: int | None) -> int:
    if n_cb is not None and n_cb < g.nof_codeword_bits:
        return max(0, -(-(n_cb + 2 * g.z) // g.z) - g.kb - 4)
    return g.m - 4


@functools.lru_cache(maxsize=None)
def _encode_tables(bg: int, z: int):
    """Flat gather tables of the core rows over [message | sink] and of the
    extension rows over [message | core parity | sink], the core's back
    substitution edges and the p0 rotation."""
    g = get_graph(bg, z)
    zi = np.arange(z)

    def build(rows, max_col, sink):
        lists = [[(c, s) for c, s in g.row_edges(r) if c < max_col] for r in rows]
        idx = np.full((len(rows), max(len(e) for e in lists), z), sink, dtype=np.int64)
        for i, edges in enumerate(lists):
            for e, (col, shift) in enumerate(edges):
                idx[i, e] = col * z + (zi + shift) % z
        return idx

    shifts = sorted(s for s in g.shifts[:4, g.kb] if s >= 0)
    rot = shifts[2] if shifts[0] == shifts[1] else shifts[0]
    back = [[(c - g.kb, s) for c, s in g.row_edges(row) if c >= g.kb] for row in range(3)]
    return build(range(4), g.kb, g.kb * z), build(range(4, g.m), g.kb + 4, (g.kb + 4) * z), back, rot


_core_on = nr.table(lambda bg, z: _encode_tables(bg, z)[0].reshape(-1))
_ext_on = nr.table(lambda bg, z, rows: _encode_tables(bg, z)[1][:rows].reshape(-1))


def encode_buffer(message: torch.Tensor, bg: int, z: int, n_cb: int | None) -> torch.Tensor:
    """(..., Kb*Z) message bits -> (..., (N_cols - 2) * Z) circular buffer
    (the codeword without its 2Z punctured columns; extension rows beyond
    the limited buffer read 0)."""
    g = get_graph(bg, z)
    lead = message.shape[:-1]
    dev = message.device
    _, _, back, rot = _encode_tables(bg, z)
    nof_ext = _nof_ext_rows(g, n_cb)
    msg = message.to(torch.uint8)
    sink = torch.zeros(lead + (1,), dtype=torch.uint8, device=dev)

    def syndromes(flat, idx, rows):
        return (flat[..., idx].reshape(lead + (rows, -1, z)).sum(dim=-2, dtype=torch.int32)
                & 1).to(torch.uint8)

    s = syndromes(torch.cat([msg, sink], dim=-1), _core_on(dev, bg, z), 4)
    parity = [torch.roll(s[..., 0, :] ^ s[..., 1, :] ^ s[..., 2, :] ^ s[..., 3, :], rot, dims=-1)]
    for row in range(3):
        acc = s[..., row, :]
        for col_off, shift in back[row]:
            if col_off < len(parity):
                acc = acc ^ torch.roll(parity[col_off], -shift, dims=-1)
        parity.append(acc)
    head = torch.cat([msg, *parity], dim=-1)
    pieces = [head]
    if nof_ext:
        pieces.append(syndromes(torch.cat([head, sink], dim=-1), _ext_on(dev, bg, z, nof_ext),
                                nof_ext).reshape(lead + (nof_ext * z,)))
    if nof_ext < g.m - 4:
        pieces.append(torch.zeros(lead + ((g.m - 4 - nof_ext) * z,), dtype=torch.uint8,
                                  device=dev))
    return torch.cat(pieces, dim=-1)[..., 2 * z:]


# ---- rate matching (5.4.2) ---------------------------------------------------------

def k0(bg: int, z: int, rv: int, n_cb: int) -> int:
    return (_RV_NUM[bg][rv] * n_cb // (_DEN[bg] * z)) * z


@functools.lru_cache(maxsize=None)
def _filler_mask(bg: int, z: int, k_prime: int, n_cb: int) -> np.ndarray:
    m = np.zeros(n_cb, dtype=bool)
    m[k_prime - 2 * z:get_graph(bg, z).kb * z - 2 * z] = True
    return m


@functools.lru_cache(maxsize=None)
def _runs(bg: int, z: int, k_prime: int, rv: int, n_cb: int):
    """Consecutive runs ((buffer start, length), ...) of the circular read
    from k0 with the fillers skipped."""
    order = (k0(bg, z, rv, n_cb) + np.arange(n_cb)) % n_cb
    valid = order[~_filler_mask(bg, z, k_prime, n_cb)[order]]
    cuts = np.nonzero(np.diff(valid) != 1)[0] + 1
    starts = np.concatenate([[0], cuts])
    ends = np.concatenate([cuts, [len(valid)]])
    return tuple((int(valid[s]), int(e - s)) for s, e in zip(starts, ends))


@functools.lru_cache(maxsize=None)
def _chunks(bg: int, z: int, k_prime: int, e: int, rv: int, n_cb: int):
    """Per pass over the usable buffer: ((buffer start, stream start, length), ...)."""
    runs = _runs(bg, z, k_prime, rv, n_cb)
    usable = sum(ln for _, ln in runs)
    out, off = [], 0
    while off < e:
        take, pos, segs = min(usable, e - off), 0, []
        for bs, ln in runs:
            if pos >= take:
                break
            n = min(ln, take - pos)
            segs.append((bs, off + pos, n))
            pos += n
        out.append(tuple(segs))
        off += take
    return tuple(out)


def usable_bits(bg: int, z: int, k_prime: int, rv: int, n_cb: int) -> int:
    return sum(ln for _, ln in _runs(bg, z, k_prime, rv, n_cb))


def rate_match(buf: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int, qm: int,
               n_cb: int) -> torch.Tensor:
    """(..., N) buffer -> (..., E) bits: bit selection, then the qm-row
    block interleaver."""
    pre = torch.cat([buf[..., bs:bs + ln] for segs in _chunks(bg, z, k_prime, e, rv, n_cb)
                     for bs, _ds, ln in segs], dim=-1)
    return pre.reshape(pre.shape[:-1] + (qm, e // qm)).transpose(-1, -2).reshape(pre.shape)


def rate_dematch(llrs: torch.Tensor, bg: int, z: int, k_prime: int, e: int, rv: int, qm: int,
                 n_cb: int) -> torch.Tensor:
    """(..., E) int8 LLRs -> (..., N) int8 buffer: repeated positions add
    and saturate at +-120, fillers read +127, untransmitted positions 0."""
    n = get_graph(bg, z).nof_codeword_bits
    lead = llrs.shape[:-1]
    de = llrs.reshape(lead + (e // qm, qm)).transpose(-1, -2).reshape(lead + (e,)).to(torch.int32)
    acc = torch.zeros(lead + (n,), dtype=torch.int32, device=llrs.device)
    for segs in _chunks(bg, z, k_prime, e, rv, n_cb):
        for bs, ds, ln in segs:
            acc[..., bs:bs + ln] += de[..., ds:ds + ln]
    if e > usable_bits(bg, z, k_prime, rv, n_cb):
        acc = acc.clamp(-LLR_MAX, LLR_MAX)
    fill = torch.zeros(n, dtype=torch.bool, device=llrs.device)
    fill[:n_cb] = torch.from_numpy(_filler_mask(bg, z, k_prime, n_cb)).to(llrs.device)
    acc[..., fill] = LLR_INF
    return acc.to(torch.int8)


def combine_harq(old: torch.Tensor, new: torch.Tensor) -> torch.Tensor:
    """Saturating int8 sum of a retransmission into the HARQ buffer: a == -b
    gives 0, an operand at +-127 gives that value, otherwise +-120 at most."""
    a, b = old.to(torch.int16), new.to(torch.int16)
    s = (a + b).clamp(-LLR_MAX, LLR_MAX)
    s = torch.where(b.abs() == LLR_INF, b, s)
    s = torch.where(a.abs() == LLR_INF, a, s)
    return torch.where(a == -b, 0, s).to(torch.int8)


# ---- layered min-sum decoding ------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DecodePlan:
    z: int
    kb: int
    ncols: int
    width_in: int
    layers: tuple  # ((col, shift), ...) per check row that runs

    @property
    def total_edges(self) -> int:
        return sum(len(e) for e in self.layers)


@functools.lru_cache(maxsize=None)
def decode_plan(bg: int, z: int, n_cb: int | None) -> DecodePlan:
    """With a limited buffer only the rows whose extension column lies
    inside it run: the others never send a message to a data bit."""
    g = get_graph(bg, z)
    nl = g.m
    if n_cb is not None and n_cb < g.nof_codeword_bits:
        nl = min(nl, max(4, -(-(n_cb + 2 * z) // z) - g.kb))
    ncols = g.kb + max(4, nl)
    return DecodePlan(z, g.kb, ncols, min(g.nof_codeword_bits, (ncols - 2) * z),
                      tuple(tuple(g.row_edges(r)) for r in range(nl)))


_layer_idx_on = nr.table(lambda plan, li: np.stack(
    [col * plan.z + (np.arange(plan.z) + shift) % plan.z for col, shift in plan.layers[li]]))


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """float32 a*b + c rounded once: the float64 sum and its TwoSum error
    decide the one case (a tie) where rounding the sum is not enough."""
    p, cd = a.double() * b.double(), c.double()
    s = p + cd
    bv = s - p
    e = (p - (s - bv)) + (cd - bv)
    r = s.float()
    toward = torch.nextafter(r, torch.where(s > r.double(), torch.inf, -torch.inf).float())
    tie = (s != r.double()) & (toward.double() - s == s - r.double())
    return torch.where(tie & (e != 0) & ((e > 0) == (toward > r)), toward, r)


def _iteration(app: torch.Tensor, r: torch.Tensor, plan: DecodePlan) -> torch.Tensor:
    """One layered iteration in place; returns (n,) bool: some check was
    unsatisfied on entry to some layer."""
    odd_any = torch.zeros(app.shape[0], dtype=torch.bool, device=app.device)
    base = 0
    for li, edges in enumerate(plan.layers):
        deg = len(edges)
        idx = _layer_idx_on(app.device, plan, li)
        rot = app[:, idx]
        odd_any |= ((rot < 0).sum(dim=1) % 2 == 1).any(dim=1)
        v = rot - r[:, base:base + deg]
        absv = v.abs()
        m1 = absv.amin(dim=1, keepdim=True)
        is_min = absv == m1
        nof_min = is_min.sum(dim=1, keepdim=True)
        m2 = torch.where(is_min, _BIG, absv).amin(dim=1, keepdim=True)
        m2 = torch.where((nof_min > 1) | (m2 >= _BIG), m1, m2)
        neg = v < 0
        odd_total = neg.sum(dim=1, keepdim=True) % 2 == 1
        mag = torch.where(is_min, m2, m1)
        sign = torch.where(odd_total ^ neg, -SCALING, SCALING)
        r[:, base:base + deg] = sign * mag
        app[:, idx] = _fma(sign, mag, v)
        base += deg
    return odd_any


def decode(buf: torch.Tensor, bg: int, z: int, n_cb: int | None, nof_iterations: int,
           early_stop: bool):
    """(C, N) int8 dematched buffers -> (bits (C, Kb*Z) uint8, iterations
    run (C,) int32, iterations needed (C,) int32).  A codeblock needed k
    iterations when the k-th left every check satisfied (the (k+1)-th then
    finds it so and stops it); one that never converges needed the whole
    budget."""
    plan = decode_plan(bg, z, n_cb)
    c, w = buf.shape[0], plan.width_in
    dev = buf.device
    app = torch.zeros((c, plan.ncols * z), dtype=torch.float32, device=dev)
    app[:, 2 * z:2 * z + w] = buf[:, :w].to(torch.float32).clamp(-INPUT_CLAMP, INPUT_CLAMP)
    r = torch.zeros((c, plan.total_edges, z), dtype=torch.float32, device=dev)
    run = torch.zeros(c, dtype=torch.int32, device=dev)
    needed = torch.full((c,), nof_iterations, dtype=torch.int32, device=dev)
    active = torch.arange(c, device=dev)
    for it in range(nof_iterations):
        if active.numel() == 0:
            break
        sub_app, sub_r = app[active], r[active]
        odd = _iteration(sub_app, sub_r, plan)
        app[active], r[active] = sub_app, sub_r
        run[active] += 1
        if early_stop:
            # Every check held on entry to every layer of this iteration:
            # the iterations before it were the ones needed.
            needed[active[~odd]] = it
            active = active[odd]
    return (app[:, :plan.kb * z] < 0).to(torch.uint8), run, needed


def ldpc_operations(plan: DecodePlan, iterations: int) -> float:
    """float32 operations of ``iterations`` codeblock iterations: 9 per edge
    and z (v = APP - r, the running two-minimum update, the argmin, the
    sign and hard-decision compares, the fused multiply-add as 2) and 2 per
    check row and z (0.8 m1, 0.8 m2)."""
    return float((9 * plan.total_edges + 2 * len(plan.layers)) * plan.z) * iterations
