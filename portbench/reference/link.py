"""The benchmark's plain shared-channel link: the transmitter that makes
every input (TB -> codeword -> QAM -> layers + DM-RS -> precoded port
grid), and the receiver that the program's answers are compared with
(DM-RS channel estimate with second-difference noise, MMSE weights per
subcarrier, max-log demap, int8 quantization, descrambling, rate dematch
with HARQ combining, layered min-sum, desegmentation and CRCs).

Frozen copies of the plain arithmetic, trimmed to full-row data symbols,
type-1 DM-RS with two CDM groups without data, square QAM and MMSE.  A
``Precision`` rounds every intermediate result: float32 is the identity;
bfloat16 is the benchmark's control (the same computation one precision
lower), which the comparison has to refuse.
"""

from __future__ import annotations

import dataclasses
import functools

import numpy as np
import torch

from . import ldpc, nr


class Precision:
    """Rounding of intermediate results: ``None`` keeps float32."""

    def __init__(self, dtype: torch.dtype | None = None):
        self.dtype = dtype

    def __call__(self, t: torch.Tensor) -> torch.Tensor:
        if self.dtype is None:
            return t
        if t.is_complex():
            return torch.complex(t.real.to(self.dtype).float(), t.imag.to(self.dtype).float())
        return t.to(self.dtype).float()


FLOAT32 = Precision()
BFLOAT16 = Precision(torch.bfloat16)


@dataclasses.dataclass(frozen=True)
class Grant:
    """One PUSCH or PDSCH grant on a window of ``nof_rb`` PRBs that starts
    at CRB ``first_rb`` of the carrier (the DM-RS sequence counts from
    CRB 0)."""

    nof_rb: int
    first_rb: int
    layers: int
    qm: int
    rate: float
    nof_ports: int
    rv: int = 0
    sym_start: int = 1
    sym_count: int = 13
    dmrs_symbols: tuple = (2,)
    slot_in_frame: int = 0
    n_id: int = 0
    nof_iterations: int = 6
    early_stop: bool = True
    llr_range_limit: float = 20.0
    tbs_lbrm_bytes: int = 159749

    @property
    def nsc(self) -> int:
        return self.nof_rb * nr.NRE

    @property
    def data_symbols(self) -> list:
        return [s for s in range(self.sym_start, self.sym_start + self.sym_count)
                if s not in self.dmrs_symbols]

    @functools.cached_property
    def tbs(self) -> int:
        return nr.calculate_tbs(self.nof_rb, self.sym_count, nr.NRE * len(self.dmrs_symbols),
                                self.rate, self.qm, self.layers)

    @functools.cached_property
    def seg(self) -> ldpc.Segments:
        return ldpc.segments(self.tbs, self.rate)

    @property
    def g(self) -> int:
        """Rate-matched bits of the codeword."""
        return self.nsc * len(self.data_symbols) * self.qm * self.layers

    @functools.cached_property
    def n_cb(self) -> int:
        n = self.seg.n
        return min(n, self.tbs_lbrm_bytes * 8 * 3 // (2 * self.seg.c), 25344)

    @functools.cached_property
    def e_groups(self) -> tuple:
        """((codeblocks, E), ...): the rate-matched lengths, equal ones
        contiguous (TS 38.212 5.4.2.1)."""
        c, unit = self.seg.c, self.qm * self.layers
        lo = unit * (self.g // (unit * c))
        nof_hi = (self.g // unit) % c
        return tuple((n, e) for n, e in ((c - nof_hi, lo), (nof_hi, lo + unit)) if n)

    @functools.cached_property
    def pilots(self):
        """(grid positions (nl, nsym_d * Np), w_f (nl, Np), pilot values
        descaled by the DM-RS amplitude (nl, nsym_d, Np), values as sent
        (nsym_d, nl, nsc) with zeros between, pair centres)."""
        idx, wfs, vals, rows = [], [], [], np.zeros(
            (len(self.dmrs_symbols), self.layers, self.nsc), np.complex64)
        beta = np.float32(nr.DMRS_BETA)
        for layer in range(self.layers):
            ks, wf = nr.pilot_subcarriers(layer, self.nof_rb)
            seq = self.first_rb * 6 + np.arange(len(ks))
            per_sym = []
            for sym in self.dmrs_symbols:
                c = nr.gold_ref(nr.dmrs_c_init(self.slot_in_frame, sym), 2 * (seq[-1] + 1))
                c = c.astype(np.float32)
                per_sym.append((((1.0 - 2.0 * c[0::2]) + 1j * (1.0 - 2.0 * c[1::2]))
                                / np.sqrt(2))[seq])
            r = np.stack(per_sym)  # complex128
            idx.append(np.concatenate([sym * self.nsc + ks for sym in self.dmrs_symbols]))
            wfs.append(wf)
            vals.append((r / beta).astype(np.complex64))
            rows[:, layer, layer // 2::2] = beta * r.astype(np.complex64) * wf.astype(np.complex64)
        # The interpolation's pair centres are those of the last layer's
        # CDM group, for every layer, as the program's estimator takes them.
        ksl, _ = nr.pilot_subcarriers(self.layers - 1, self.nof_rb)
        pairs = tuple(float((ksl[2 * i] + ksl[2 * i + 1]) / 2) for i in range(len(ksl) // 2))
        return (np.stack(idx), np.stack(wfs), np.stack(vals), rows, pairs)


_pilots_on = nr.table(lambda g, which: g.pilots[which])


# ---- transmitter ----------------------------------------------------------------

def codeword(tb: torch.Tensor, g: Grant) -> torch.Tensor:
    """(B, A) TB bits -> (B, G) rate-matched codeword bits."""
    s = g.seg
    buf = ldpc.encode_buffer(ldpc.segment_tx(tb, s), s.bg, s.z, g.n_cb)
    pieces, start = [], 0
    for count, e in g.e_groups:
        grp = ldpc.rate_match(buf[..., start:start + count, :], s.bg, s.z, s.k_prime, e, g.rv,
                              g.qm, g.n_cb)
        pieces.append(grp.reshape(grp.shape[:-2] + (count * e,)))
        start += count
    return torch.cat(pieces, dim=-1)


def layer_grid(tb: torch.Tensor, rnti: torch.Tensor, g: Grant,
               rnd: Precision = FLOAT32) -> torch.Tensor:
    """(B, A) TB bits and (B,) RNTIs -> (B, nl, 14, nsc) complex64 layer
    grids of the window: scrambled QAM symbols on the data symbols, layer
    i % nl, DM-RS at its amplitude."""
    cw = codeword(tb, g) ^ nr.gold_sequence(nr.sch_c_init(rnti, g.n_id), g.g)
    syms = rnd(nr.map_bits(cw, g.qm))
    b, nl, dev = tb.shape[0], g.layers, tb.device
    layered = syms.reshape(b, -1, nl).transpose(-1, -2)
    data = layered.reshape(b, nl, len(g.data_symbols), g.nsc)
    dmrs = _pilots_on(dev, g, 3)
    zero = torch.zeros((b, nl, g.nsc), dtype=torch.complex64, device=dev)
    rows = []
    for s in range(14):
        if s in g.data_symbols:
            rows.append(data[:, :, g.data_symbols.index(s)])
        elif s in g.dmrs_symbols:
            rows.append(dmrs[list(g.dmrs_symbols).index(s)].expand(b, nl, g.nsc))
        else:
            rows.append(zero)
    return torch.stack(rows, dim=-2)


def precode(grid_l: torch.Tensor, w: torch.Tensor, rnd: Precision = FLOAT32) -> torch.Tensor:
    """(B, nl, 14, nsc) layer grids and a flat precoding or channel, (nl, P)
    or (B, nl, P) -> (B, P, 14, nsc), each port the float32 sum of its
    layers' products."""
    w = w.to(torch.complex64)
    return rnd(torch.stack([sum(w[..., l, p, None, None] * grid_l[:, l]
                                for l in range(grid_l.shape[1]))
                            for p in range(w.shape[-1])], dim=-3))


def port_grid(tb: torch.Tensor, rnti: torch.Tensor, precoding: torch.Tensor, g: Grant,
              rnd: Precision = FLOAT32) -> torch.Tensor:
    """(B, A) TB bits, (B,) RNTIs and the precoding, (nl, P) or (B, nl, P)
    -> (B, P, 14, nsc) complex64 port grids of the window."""
    return precode(layer_grid(tb, rnti, g, rnd), precoding, rnd)


# ---- receiver -------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _smoothing_taps() -> np.ndarray:
    """9-tap raised-cosine low-pass (roll-off 0.2, cut-off 0.45), normalized."""
    n = np.arange(9) - 4.0
    den = 1 - (2 * 0.2 * 2 * 0.45 * n) ** 2
    taps = (np.sinc(2 * 0.45 * n) * np.cos(np.pi * 0.2 * 2 * 0.45 * n)
            / np.where(np.abs(den) < 1e-9, 1e-9, den))
    return (taps / taps.sum()).astype(np.float32)


def _interp_plan(pairs: tuple, nsc: int):
    pos = np.asarray(pairs, dtype=np.float32)
    x = np.arange(nsc, dtype=np.float32)
    li = np.clip(np.searchsorted(pos, x, side="right") - 1, 0, len(pos) - 2)
    frac = np.clip((x - pos[li]) / (pos[li + 1] - pos[li]), 0.0, 1.0)
    return (li.astype(np.int64), (li + 1).astype(np.int64), frac.astype(np.float32),
            ((x - pos[0]) / float(pos[1] - pos[0])).astype(np.float32))


_interp_on = nr.table(lambda pairs, nsc, which: _interp_plan(pairs, nsc)[which])


def _phasor(phase: torch.Tensor) -> torch.Tensor:
    return torch.polar(torch.ones_like(phase), phase)


def estimate(grid: torch.Tensor, g: Grant, rnd: Precision):
    """(B, P, 14, nsc) grid -> (h (B, P, nsc, nl), noise variance (B,)):
    LS at the pilots, OCC despread over CDM pairs, time average, bulk
    delay derotated, 9-tap smoothing, linear interpolation, re-rotated;
    the noise from (1, -2, 1) second differences of the pair values."""
    b, npr = grid.shape[:2]
    nl, nsym_d = g.layers, len(g.dmrs_symbols)
    dev = grid.device
    idx, wf = _pilots_on(dev, g, 0), _pilots_on(dev, g, 1)
    r, pairs = _pilots_on(dev, g, 2), g.pilots[4]
    y = grid.reshape(b, npr, -1)[:, :, idx.reshape(-1)]
    y = y.reshape(b, npr, nl, nsym_d, -1).transpose(1, 2)  # (B, nl, P, nsym_d, Np)
    ls = y * r[None, :, None].conj() * wf[None, :, None, None, :]
    h_pair = ls.reshape(ls.shape[:-1] + (-1, 2)).mean(dim=-1)  # (B, nl, P, nsym_d, Np/2)
    h_t = h_pair.mean(dim=-2)
    n_pairs = h_t.shape[-1]
    slope = torch.angle(torch.sum(h_t[..., 1:] * h_t[..., :-1].conj(), dim=-1, keepdim=True))
    h_t = h_t * _phasor(-slope * torch.arange(n_pairs, dtype=torch.float32, device=dev))
    taps = _smoothing_taps()
    hp = torch.cat([h_t[..., :1].expand(h_t.shape[:-1] + (4,)), h_t,
                    h_t[..., -1:].expand(h_t.shape[:-1] + (4,))], dim=-1)
    sm = torch.zeros_like(h_t)
    for i in range(9):
        sm = sm + float(taps[i]) * hp[..., i:i + n_pairs]
    li, ri, fr, coord = (_interp_on(dev, pairs, g.nsc, i) for i in range(4))
    h = (sm[..., li] * (1 - fr) + sm[..., ri] * fr) * _phasor(slope * coord)
    h = rnd(h.to(torch.complex64).permute(0, 2, 3, 1))  # (B, P, nsc, nl)

    hp2 = h_pair.mean(dim=-2)
    npair = hp2.shape[-1]
    s2 = torch.angle(torch.sum(hp2[..., 1:] * hp2[..., :-1].conj(), dim=-1, keepdim=True))
    hp2 = hp2 * _phasor(-s2 * torch.arange(npair, dtype=torch.float32, device=dev))
    d2 = hp2[..., 2:] - 2.0 * hp2[..., 1:-1] + hp2[..., :-2]
    nv = (d2.abs() ** 2).reshape(b, -1).mean(dim=-1) * nsym_d / 3.0 * nr.DMRS_BETA ** 2
    return h, rnd(torch.clamp_min(nv, 1e-10))


def _cmul(a, b):
    return (a[0] * b[0] - a[1] * b[1], a[0] * b[1] + a[1] * b[0])


def _cadd(a, b):
    return (a[0] + b[0], a[1] + b[1])


def _csub(a, b):
    return (a[0] - b[0], a[1] - b[1])


def _cneg(a):
    return (-a[0], -a[1])


def _crecip(a):
    r = 1.0 / torch.clamp_min(a[0] * a[0] + a[1] * a[1], 1e-30)
    return (a[0] * r, -a[1] * r)


def _inv2(c00, c01, c10, c11):
    r = _crecip(_csub(_cmul(c00, c11), _cmul(c01, c10)))
    return (_cmul(c11, r), _cneg(_cmul(c01, r)), _cneg(_cmul(c10, r)), _cmul(c00, r))


def _mm2(a, b):
    return (_cadd(_cmul(a[0], b[0]), _cmul(a[1], b[2])), _cadd(_cmul(a[0], b[1]), _cmul(a[1], b[3])),
            _cadd(_cmul(a[2], b[0]), _cmul(a[3], b[2])), _cadd(_cmul(a[2], b[1]), _cmul(a[3], b[3])))


def mmse_4x4(h: torch.Tensor, nv: torch.Tensor):
    """(..., nsc, P=4, L=4) channels, (...,) noise -> (w (..., nsc, L, P),
    post-equalization noise (..., nsc, L)): gram, C = G + nv I, blocked 2x2
    Schur inverse, mu = diag(C^-1 G) in [1e-9, 1 - 1e-9], W = C^-1 H^H / mu,
    (1 - mu) / mu; real scalar algebra on float32."""
    nv = torch.clamp_min(nv, 1e-12)[..., None]
    hr, hi = h.real, h.imag
    hh = [[(hr[..., p, l], hi[..., p, l]) for l in range(4)] for p in range(4)]
    zero = torch.zeros_like(hr[..., 0, 0])
    gm = [[None] * 4 for _ in range(4)]
    for l in range(4):
        for m in range(4):
            acc = (zero, zero)
            for p in range(4):
                acc = _cadd(acc, _cmul((hh[p][l][0], -hh[p][l][1]), hh[p][m]))
            gm[l][m] = acc
    c = [[(gm[l][m][0] + nv, gm[l][m][1]) if l == m else gm[l][m] for m in range(4)]
         for l in range(4)]
    a = (c[0][0], c[0][1], c[1][0], c[1][1])
    bm = (c[0][2], c[0][3], c[1][2], c[1][3])
    bh = (c[2][0], c[2][1], c[3][0], c[3][1])
    d = (c[2][2], c[2][3], c[3][2], c[3][3])
    ai = _inv2(*a)
    si = _inv2(*(_csub(x, t) for x, t in zip(d, _mm2(_mm2(bh, ai), bm))))
    aib, bhai = _mm2(ai, bm), _mm2(bh, ai)
    tl = tuple(_cadd(x, t) for x, t in zip(ai, _mm2(_mm2(aib, si), bhai)))
    tr = tuple(_cneg(t) for t in _mm2(aib, si))
    bl = tuple(_cneg(t) for t in _mm2(si, bhai))
    ci = [[tl[0], tl[1], tr[0], tr[1]], [tl[2], tl[3], tr[2], tr[3]],
          [bl[0], bl[1], si[0], si[1]], [bl[2], bl[3], si[2], si[3]]]
    w_rows, ev = [], []
    for l in range(4):
        mu = zero
        for m in range(4):
            mu = mu + (ci[l][m][0] * gm[m][l][0] - ci[l][m][1] * gm[m][l][1])
        mu = torch.clamp(mu, 1e-9, 1.0 - 1e-9)
        inv_mu = 1.0 / mu
        row = []
        for p in range(4):
            acc = (zero, zero)
            for m in range(4):
                acc = _cadd(acc, _cmul(ci[l][m], (hh[p][m][0], -hh[p][m][1])))
            row.append(torch.complex(acc[0] * inv_mu, acc[1] * inv_mu))
        w_rows.append(torch.stack(row, dim=-1))
        ev.append((1.0 - mu) * inv_mu)
    return torch.stack(w_rows, dim=-2), torch.stack(ev, dim=-1)


def _cmm(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return (a[..., :, :, None] * b[..., None, :, :]).sum(dim=-2)


def _inv2x2(c: torch.Tensor) -> torch.Tensor:
    a, b, d, e = c[..., 0, 0], c[..., 0, 1], c[..., 1, 0], c[..., 1, 1]
    r = 1.0 / (a * e - b * d)
    return torch.stack([torch.stack([e * r, -b * r], dim=-1),
                        torch.stack([-d * r, a * r], dim=-1)], dim=-2)


def mmse_small(h: torch.Tensor, nv: torch.Tensor):
    """MMSE weights of 1 or 2 layers on any ports: (..., P, L), (...,) ->
    (w (..., L, P), post-equalization noise (..., L))."""
    nl = h.shape[-1]
    nv = torch.clamp_min(nv, 1e-12)[..., None]
    hh = h.conj().transpose(-1, -2)
    gram = _cmm(hh, h)
    c = gram + nv[..., None] * torch.eye(nl, dtype=torch.float32, device=h.device)
    cinv = 1.0 / c if nl == 1 else _inv2x2(c)
    w = _cmm(cinv, hh)
    mu = torch.clamp((cinv * gram.transpose(-1, -2)).sum(dim=-1).real, 1e-9, 1.0 - 1e-9)
    return w / mu[..., None], (1.0 - mu) / mu


def receive(grid: torch.Tensor, rnti: torch.Tensor, g: Grant, harq: torch.Tensor | None = None,
            rnd: Precision = FLOAT32) -> dict:
    """(B, P, 14, nsc) received window grids, (B,) RNTIs and the (B, C, N)
    HARQ buffers of earlier transmissions (None for new data) -> dict of
    tb_bits (B, A) uint8, tb_crc_ok (B,), harq_buffer (B, C, N) int8,
    noise_var (B,), snr_db (B,), iterations_needed (B, C)."""
    grid = rnd(grid)
    b, npr = grid.shape[:2]
    nl = g.layers
    h, nv = estimate(grid, g, rnd)
    y = grid[:, :, g.data_symbols]  # (B, P, nd, nsc)
    hs = h.transpose(1, 2)  # (B, nsc, P, nl)
    if (nl, npr) == (4, 4):
        w, eq = mmse_4x4(hs, nv)
    elif nl <= 2:
        w, eq = mmse_small(hs.contiguous(), nv[:, None].expand(b, g.nsc))
    else:
        raise ValueError(f"the reference's MMSE covers 4x4, or 1-2 layers; got {nl}x{npr}")
    w, eq = rnd(w), rnd(eq)
    x = torch.stack([sum(w[:, None, :, l, p] * y[:, p] for p in range(npr)) for l in range(nl)],
                    dim=-1)
    nd = x.shape[1]
    x = rnd(x).reshape(b, -1, nl)
    eq = eq[:, None].expand(b, nd, g.nsc, nl).reshape(b, -1, nl)
    llr = rnd(nr.demap_soft(x.transpose(1, 2), eq.transpose(1, 2), g.qm))
    llr = llr.reshape(b, nl, -1, g.qm).transpose(1, 2).reshape(b, -1)
    llr = nr.descramble_llrs(nr.quantize_llr(llr, g.llr_range_limit),
                             nr.sch_c_init(rnti, g.n_id))
    e = nr.evm(x.reshape(b, -1), g.qm)
    sinr = 1.0 / torch.clamp_min(e * e, 1e-12)

    s = g.seg
    parts, off = [], 0
    for count, e_len in g.e_groups:
        span = llr[:, off:off + count * e_len].reshape(b, count, e_len)
        parts.append(ldpc.rate_dematch(span, s.bg, s.z, s.k_prime, e_len, g.rv, g.qm, g.n_cb))
        off += count * e_len
    buf = torch.cat(parts, dim=-2)
    if harq is not None:
        buf = ldpc.combine_harq(harq, buf)
    bits, _run, needed = ldpc.decode(buf.reshape(-1, buf.shape[-1]), s.bg, s.z, g.n_cb,
                                     g.nof_iterations, g.early_stop)
    tb, ok = ldpc.desegment_rx(bits.reshape(b, s.c, -1), s)
    return {"tb_bits": tb, "tb_crc_ok": ok, "harq_buffer": buf, "noise_var": nv,
            "snr_db": 10.0 * torch.log10(torch.clamp_min(sinr, 1e-12)),
            "iterations_needed": needed.reshape(b, s.c)}
