"""Plain NR physical-layer helpers of the benchmark's reference: modulation,
transport-block size, DM-RS geometry, Gold sequences, CRCs and OFDM.

Frozen copies, trimmed to the benchmark's configurations (square QAM,
type-1 DM-RS on full data rows, normal cyclic prefix), of the plain
arithmetic that TS 38.211, 38.212 and 38.214 define.  Plain torch and
numpy only: nothing here imports the program under test.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

NRE = 12
_QAM_SCALE = {4: 10.0, 6: 42.0, 8: 170.0}


def table(build):
    """Wrap ``build(*args) -> np.ndarray`` as ``f(device, *args) -> Tensor``,
    cached per (device, args)."""

    @functools.lru_cache(maxsize=None)
    def on(device, *args):
        return torch.from_numpy(np.ascontiguousarray(build(*args))).to(device)

    return on


# ---- modulation (TS 38.211 5.1) ---------------------------------------------

def _pam(bits: np.ndarray) -> np.ndarray:
    n, m = bits.shape
    amp = np.ones(n)
    for k in range(m - 1, 0, -1):
        amp = 2 ** (m - k) - (1 - 2 * bits[:, k]) * amp
    return (1 - 2 * bits[:, 0]) * amp


@functools.lru_cache(maxsize=None)
def pam_levels(qm: int):
    """Sorted per-axis amplitudes and their axis bit labels of a square
    QAM: (levels (2^m,), labels (2^m, m))."""
    m = max(qm // 2, 1)
    idx = np.arange(1 << m)
    bits = ((idx[:, None] >> (m - 1 - np.arange(m))) & 1).astype(np.int64)
    if qm <= 2:
        amp, scale = (1 - 2 * bits[:, 0]).astype(np.float64), np.sqrt(2.0)
    else:
        amp, scale = _pam(bits).astype(np.float64), np.sqrt(_QAM_SCALE[qm])
    levels = amp / scale
    order = np.argsort(levels)
    return levels[order], bits[order]


_levels_on = table(lambda qm: pam_levels(qm)[0].astype(np.float32))


def map_bits(bits: torch.Tensor, qm: int) -> torch.Tensor:
    """(..., E) bits -> (..., E/qm) complex64 square-QAM symbols."""
    e = bits.shape[-1]
    group = bits.to(torch.float32).reshape(bits.shape[:-1] + (e // qm, qm))
    s2 = float(np.float32(1.0 / np.sqrt(2)))
    if qm == 2:
        return torch.complex((1.0 - 2.0 * group[..., 0]) * s2, (1.0 - 2.0 * group[..., 1]) * s2)
    m = qm // 2

    def pam(axis_bits):
        amp = torch.ones(axis_bits.shape[:-1], dtype=torch.float32, device=bits.device)
        for k in range(m - 1, 0, -1):
            amp = 2.0 ** (m - k) - (1.0 - 2.0 * axis_bits[..., k]) * amp
        return (1.0 - 2.0 * axis_bits[..., 0]) * amp

    s = float(np.float32(1.0 / np.sqrt(_QAM_SCALE[qm])))
    return torch.complex(pam(group[..., 0::2]) * s, pam(group[..., 1::2]) * s)


def _axis_llrs(y: torch.Tensor, levels: np.ndarray, labels: np.ndarray) -> torch.Tensor:
    """Exact per-axis max-log LLRs: (m, ...) of the (...) observations y."""
    d2 = [(y - float(np.float32(lv))) ** 2 for lv in levels]
    outs = []
    for b in range(labels.shape[1]):
        m0 = m1 = None
        for lv, d in enumerate(d2):
            if labels[lv, b]:
                m1 = d if m1 is None else torch.minimum(m1, d)
            else:
                m0 = d if m0 is None else torch.minimum(m0, d)
        outs.append(m1 - m0)
    return torch.stack(outs)


def demap_soft(symbols: torch.Tensor, noise_var: torch.Tensor, qm: int) -> torch.Tensor:
    """(..., S) symbols and noise variances -> (..., S*qm) float32 max-log
    LLRs (positive = bit 0), I and Q bits interleaved as the mapper."""
    shape = symbols.shape
    if qm == 2:
        c = float(np.float32(2.0 * np.sqrt(2.0)))
        both = torch.stack([c * symbols.real / noise_var, c * symbols.imag / noise_var], dim=-1)
        return both.reshape(shape[:-1] + (shape[-1] * 2,))
    levels, labels = pam_levels(qm)
    inv_nv = 1.0 / noise_var
    li = _axis_llrs(symbols.real, levels, labels) * inv_nv
    lq = _axis_llrs(symbols.imag, levels, labels) * inv_nv
    both = torch.movedim(torch.stack([li, lq], dim=-1), 0, -2)  # (..., S, m, 2)
    return both.reshape(shape[:-1] + (shape[-1] * qm,))


LLR_MAX = 120


def quantize_llr(llrs: torch.Tensor, range_limit: float) -> torch.Tensor:
    """Mid-tread uniform int8 quantization in [-LLR_MAX, LLR_MAX]."""
    scaled = llrs * float(np.float32(LLR_MAX / range_limit))
    return torch.clamp(torch.round(scaled), -LLR_MAX, LLR_MAX).to(torch.int8)


def evm(symbols: torch.Tensor, qm: int) -> torch.Tensor:
    """RMS error of (..., S) symbols against the nearest square-QAM point."""
    levels = _levels_on(symbols.device, qm)
    err_re = ((symbols.real[..., None] - levels) ** 2).amin(dim=-1)
    err_im = ((symbols.imag[..., None] - levels) ** 2).amin(dim=-1)
    return torch.sqrt((err_re + err_im).mean(dim=-1))


# ---- transport-block size (TS 38.214 5.1.3.2) ----------------------------------

# TS 38.214 Table 5.1.3.2-1: the transport block sizes up to 3824 bits.
TBS_TABLE = (
    24, 32, 40, 48, 56, 64, 72, 80, 88, 96, 104, 112, 120, 128, 136, 144, 152,
    160, 168, 176, 184, 192, 208, 224, 240, 256, 272, 288, 304, 320, 336, 352,
    368, 384, 408, 432, 456, 480, 504, 528, 552, 576, 608, 640, 672, 704, 736,
    768, 808, 848, 888, 928, 984, 1032, 1064, 1128, 1160, 1192, 1224, 1256,
    1288, 1320, 1352, 1416, 1480, 1544, 1608, 1672, 1736, 1800, 1864, 1928,
    2024, 2088, 2152, 2216, 2280, 2408, 2472, 2536, 2600, 2664, 2728, 2792,
    2856, 2976, 3104, 3240, 3368, 3496, 3624, 3752, 3824,
)


def calculate_tbs(nof_prb: int, nof_symbols: int, nof_dmrs_re_per_prb: int, code_rate: float,
                  qm: int, nof_layers: int) -> int:
    """TBS in bits (steps 1-4), N_info in float32 as srsRAN's
    tbs_calculator computes it."""
    f32 = np.float32
    n_re = min(156, 12 * nof_symbols - nof_dmrs_re_per_prb) * nof_prb
    n_info = float(f32(1.0) * f32(n_re) * f32(code_rate) * f32(qm) * f32(nof_layers))
    if n_info <= 3824:
        n = 3 if n_info <= 512 else int(math.floor(math.log2(n_info))) - 6
        n_info_prime = max(24, (1 << n) * int(float(f32(n_info)) / (1 << n)))
        return next((t for t in TBS_TABLE if t >= n_info_prime), TBS_TABLE[-1])
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


# ---- DM-RS type 1, single symbol (TS 38.211 6.4.1.1) -----------------------------

# Port -> (CDM group = delta, w_f over k').
_TYPE1_PORTS = {0: (0, (1, 1)), 1: (0, (1, -1)), 2: (1, (1, 1)), 3: (1, (1, -1))}
DMRS_BETA = math.sqrt(2.0)  # two CDM groups without data


def pilot_subcarriers(layer: int, nof_rb: int):
    """(k (Np,), w_f (Np,)) of one layer's pilots over PRBs 0..nof_rb-1."""
    delta, wf = _TYPE1_PORTS[layer]
    ks = [rb * NRE + 4 * n + 2 * kp + delta for rb in range(nof_rb) for n in range(3)
          for kp in (0, 1)]
    ws = [wf[kp] for _rb in range(nof_rb) for _n in range(3) for kp in (0, 1)]
    return np.asarray(ks, np.int64), np.asarray(ws, np.float32)


def dmrs_c_init(slot_in_frame: int, symbol: int, n_id: int = 0, n_scid: int = 0) -> int:
    return ((1 << 17) * (14 * slot_in_frame + symbol + 1) * (2 * n_id + 1) + 2 * n_id
            + n_scid) % (1 << 31)


# ---- Gold sequences (TS 38.211 5.2.1) --------------------------------------------

NC = 1600
_NBITS = 31


def gold_ref(c_init: int, length: int) -> np.ndarray:
    """c(n), n < length, by the LFSR recursion."""
    total = NC + length
    x1 = np.zeros(total + _NBITS, dtype=np.uint8)
    x2 = np.zeros(total + _NBITS, dtype=np.uint8)
    x1[0] = 1
    for i in range(_NBITS):
        x2[i] = (c_init >> i) & 1
    for i in range(total):
        x1[i + _NBITS] = x1[i + 3] ^ x1[i]
        x2[i + _NBITS] = x2[i + 3] ^ x2[i + 2] ^ x2[i + 1] ^ x2[i]
    return x1[NC:NC + length] ^ x2[NC:NC + length]


@functools.lru_cache(maxsize=None)
def _x2_blocks(k: int):
    """Advance-matrix banks over GF(2): the x2 state of 31-bit block
    a*T + b is seed @ D[a] @ C[b]; returns (C (31, T*31), D (31, A*31))."""
    m = np.zeros((_NBITS, _NBITS), np.int64)  # s_{t+31} = s_t @ m
    state = np.eye(_NBITS, dtype=np.int64)
    x = np.concatenate([state, np.zeros((_NBITS, _NBITS), np.int64)], axis=1)
    for i in range(_NBITS):
        x[:, _NBITS + i] = x[:, i] ^ x[:, i + 1] ^ x[:, i + 2] ^ x[:, i + 3]
    m[:] = x[:, _NBITS:]
    t_blk = 1 << max(0, (max(k, 1) - 1).bit_length() // 2)
    nof_a = -(-k // t_blk)
    c = np.empty((t_blk, _NBITS, _NBITS), np.float32)
    cur = np.eye(_NBITS, dtype=np.int64)
    for b in range(t_blk):
        c[b] = cur
        cur = (cur @ m) % 2
    d = np.empty((nof_a, _NBITS, _NBITS), np.float32)
    step, cur = cur, np.eye(_NBITS, dtype=np.int64)
    for a in range(nof_a):
        d[a] = cur
        cur = (cur @ step) % 2
    return (c.transpose(1, 0, 2).reshape(_NBITS, -1), d.transpose(1, 0, 2).reshape(_NBITS, -1))


@functools.lru_cache(maxsize=None)
def _x1_bits(length: int) -> np.ndarray:
    total = NC + length
    x1 = np.zeros(total + _NBITS, dtype=np.uint8)
    x1[0] = 1
    for i in range(total):
        x1[i + _NBITS] = x1[i + 3] ^ x1[i]
    return x1[NC:NC + length]


_bank_on = table(lambda which, k: _x2_blocks(k)[which])
_x1_on = table(_x1_bits)


def gold_sequence(c_init: torch.Tensor, length: int) -> torch.Tensor:
    """(...,) integer seeds -> (..., length) uint8 Gold bits on their
    device.  Every product and sum of the float32 products is an exact
    integer below 32."""
    k = -(-(NC + length) // _NBITS)
    dev = c_init.device
    shifts = torch.arange(_NBITS, device=dev)
    seed = ((c_init.to(torch.int64)[..., None] >> shifts) & 1).to(torch.float32)
    s_a = (seed @ _bank_on(dev, 1, k)).to(torch.int32) & 1
    s_a = s_a.to(torch.float32).reshape(c_init.shape + (-1, _NBITS))
    states = ((s_a @ _bank_on(dev, 0, k)).to(torch.int32) & 1).to(torch.uint8)
    x2 = states.reshape(c_init.shape + (-1,))[..., NC:NC + length]
    return x2 ^ _x1_on(dev, length)


def sch_c_init(rnti: torch.Tensor, n_id: int = 0) -> torch.Tensor:
    """PUSCH and PDSCH (codeword 0) data scrambling seed."""
    return (rnti.to(torch.int64) << 15) + n_id


def descramble_llrs(llrs: torch.Tensor, c_init: torch.Tensor) -> torch.Tensor:
    seq = gold_sequence(c_init, llrs.shape[-1])
    flipped = torch.where(llrs == -128, 127, -(llrs.to(torch.int16))).to(torch.int8)
    return torch.where(seq == 1, flipped, llrs)


# ---- CRC (TS 38.212 5.1) ---------------------------------------------------------

POLYS = {"24A": (0x1864CFB, 24), "24B": (0x1800063, 24), "16": (0x11021, 16)}
_CHUNK = 1024


def _gf2_step(reg: int, poly: int, n: int) -> int:
    reg <<= 1
    return reg ^ poly if reg >> n else reg


@functools.lru_cache(maxsize=None)
def generator_matrix(name: str, length: int) -> np.ndarray:
    """(length, n) uint8 A with row i = CRC of the unit message e_i."""
    poly, n = POLYS[name]
    out = np.empty((length, n), dtype=np.uint8)
    r = 1
    for _ in range(n):
        r = _gf2_step(r, poly, n)
    for k in range(length):
        out[length - 1 - k] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
        r = _gf2_step(r, poly, n)
    return out


@functools.lru_cache(maxsize=None)
def _advance(name: str, nof_bits: int) -> np.ndarray:
    """(n, n) GF(2) matrix that advances a CRC state over nof_bits zeros."""
    poly, n = POLYS[name]
    t1 = np.empty((n, n), dtype=np.int64)
    for b in range(n):
        r = _gf2_step(1 << (n - 1 - b), poly, n)
        t1[b] = [(r >> (n - 1 - i)) & 1 for i in range(n)]
    acc, p, s = np.eye(n, dtype=np.int64), t1, nof_bits
    while s:
        if s & 1:
            acc = (acc @ p) % 2
        p = (p @ p) % 2
        s >>= 1
    return acc


@functools.lru_cache(maxsize=None)
def _fold(name: str, nof_chunks: int, chunk_bits: int) -> np.ndarray:
    """(nof_chunks * n, n): block j advances chunk j's CRC past the rest."""
    _, n = POLYS[name]
    t = _advance(name, chunk_bits)
    out = np.empty((nof_chunks, n, n), dtype=np.float32)
    cur = np.eye(n, dtype=np.int64)
    for j in range(nof_chunks):
        out[nof_chunks - 1 - j] = cur
        cur = (cur @ t) % 2
    return out.reshape(nof_chunks * n, n)


_gen_on = table(lambda name, length: generator_matrix(name, length).astype(np.float32))
_fold_on = table(_fold)


def _mod2(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32) & 1


def crc(bits: torch.Tensor, name: str) -> torch.Tensor:
    """(..., L) bits -> (..., n) uint8 CRC, MSB first.  Exact in float32:
    every sum is an integer count below 2^24."""
    length, n = bits.shape[-1], POLYS[name][1]
    dev = bits.device
    if length <= 4 * _CHUNK:
        return _mod2(bits.to(torch.float32) @ _gen_on(dev, name, length)).to(torch.uint8)
    k = -(-length // _CHUNK)  # leading zeros do not change a CRC
    x = torch.nn.functional.pad(bits.to(torch.float32), (k * _CHUNK - length, 0))
    part = _mod2(x.reshape(x.shape[:-1] + (k, _CHUNK)) @ _gen_on(dev, name, _CHUNK))
    flat = part.to(torch.float32).reshape(part.shape[:-2] + (k * n,))
    return _mod2(flat @ _fold_on(dev, name, k, _CHUNK)).to(torch.uint8)


def crc_append(bits: torch.Tensor, name: str) -> torch.Tensor:
    return torch.cat([bits.to(torch.uint8), crc(bits, name)], dim=-1)


def crc_ok_concat(chunks: torch.Tensor, name: str) -> torch.Tensor:
    """CRC verdict of the concatenation of (..., C, L) equal chunks."""
    c, length = chunks.shape[-2], chunks.shape[-1]
    n = POLYS[name][1]
    dev = chunks.device
    part = _mod2(chunks.to(torch.float32) @ _gen_on(dev, name, length)).to(torch.float32)
    comb = _mod2(part.reshape(part.shape[:-2] + (c * n,)) @ _fold_on(dev, name, c, length))
    return comb.sum(dim=-1) == 0


# ---- OFDM, normal cyclic prefix (TS 38.211 5.3) ---------------------------------

def min_dft_size(nof_rb: int) -> int:
    n = 128
    while n < nof_rb * NRE:
        n *= 2
    return n


@functools.lru_cache(maxsize=None)
def slot_geometry(scs_khz: int, dft_size: int):
    """Slot 0 of a subframe: (CP lengths (14,), useful-part start times in
    seconds (14,))."""
    mu = {15: 0, 30: 1, 60: 2, 120: 3}[scs_khz]
    scale = dft_size / 2048.0
    base, extra = int(144 * scale), int(16 * scale * (1 << mu))
    cps = [base + extra if l in (0, 7 * (1 << mu)) else base for l in range(14 * (1 << mu))]
    fs = float(scs_khz * 1000 * dft_size)
    starts = np.cumsum([0] + [c + dft_size for c in cps])[:-1]
    return tuple(cps[:14]), tuple((starts[i] + cps[i]) / fs for i in range(14))


def _phase(scs_khz: int, dft_size: int, f_center_hz: float) -> np.ndarray:
    """exp(-j 2 pi f_c t_l) per symbol, the cycles reduced mod 1 in float64."""
    _, t_useful = slot_geometry(scs_khz, dft_size)
    cycles = np.array([f_center_hz * t for t in t_useful], dtype=np.float64)
    return np.exp(-2j * np.pi * (cycles - np.round(cycles))).astype(np.complex64)


def _cp_index(scs_khz: int, dft_size: int) -> np.ndarray:
    cps, _ = slot_geometry(scs_khz, dft_size)
    rows = []
    for l, c in enumerate(cps):
        rows.append(l * dft_size + np.arange(dft_size - c, dft_size))
        rows.append(l * dft_size + np.arange(dft_size))
    return np.concatenate(rows).astype(np.int64)


def _body_index(scs_khz: int, dft_size: int) -> np.ndarray:
    cps, _ = slot_geometry(scs_khz, dft_size)
    starts = np.cumsum([0] + [c + dft_size for c in cps])[:-1] + np.asarray(cps)
    return (starts[:, None] + np.arange(dft_size)[None, :]).astype(np.int64)


_phase_on = table(_phase)
_cp_index_on = table(_cp_index)
_body_index_on = table(_body_index)


def slot_nof_samples(scs_khz: int, dft_size: int) -> int:
    cps, _ = slot_geometry(scs_khz, dft_size)
    return sum(cps) + 14 * dft_size


def ofdm_modulate(grid: torch.Tensor, scs_khz: int, dft_size: int,
                  f_center_hz: float) -> torch.Tensor:
    """(..., 14, nsc) grid -> (..., samples) baseband IQ: a unitary IDFT
    per symbol (subcarrier k at (k - nsc/2) * scs), the phase
    compensation of the carrier, then each symbol's cyclic prefix."""
    nsc = grid.shape[-1]
    half = nsc // 2
    dev = grid.device
    spec = torch.zeros(grid.shape[:-1] + (dft_size,), dtype=torch.complex64, device=dev)
    spec[..., :half] = grid[..., half:]
    spec[..., dft_size - half:] = grid[..., :half]
    gain = float(np.float32(dft_size * (1.0 / np.sqrt(dft_size))))
    x = torch.fft.ifft(spec, dim=-1) * gain
    x = x * _phase_on(dev, scs_khz, dft_size, f_center_hz)[:, None]
    flat = x.reshape(x.shape[:-2] + (14 * dft_size,))
    return flat[..., _cp_index_on(dev, scs_khz, dft_size)]


def ofdm_demodulate(samples: torch.Tensor, nof_rb: int, scs_khz: int, dft_size: int,
                    f_center_hz: float) -> torch.Tensor:
    """(..., samples) IQ -> (..., 14, nof_rb * 12) grid, the inverse of
    ``ofdm_modulate`` with the DFT window on each symbol's useful part."""
    nsc = nof_rb * NRE
    dev = samples.device
    x = samples[..., _body_index_on(dev, scs_khz, dft_size)]
    x = x * _phase_on(dev, scs_khz, dft_size, f_center_hz).conj()[:, None]
    gain = float(np.float32(dft_size * (1.0 / np.sqrt(dft_size))))
    spec = torch.fft.fft(x, dim=-1) / gain
    half = nsc // 2
    return torch.cat([spec[..., dft_size - half:], spec[..., :half]], dim=-1)
