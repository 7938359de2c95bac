"""5G NR security algorithms: NEA1/2/3 ciphering + NIA1/2/3 integrity.

Counterpart of the reference's lib/security (s3g.cpp, zuc.cpp,
ciphering_engine_nea{1,2,3}.cpp, integrity_engine_nia2_cmac.cpp,
security_engine_impl.cpp; SURVEY.md section 2.4 "Security"):

- NEA2/NIA2: AES-128 in CTR / CMAC mode (TS 33.501 -> 33.401 Annex B,
  128-EEA2/128-EIA2).  The AES core is implemented here (FIPS-197) —
  the reference delegates to mbedTLS.
- NEA1/NIA1: SNOW 3G f8/f9 (UEA2/UIA2 spec, SAGE D2 v1.1).  S-box
  constants (SR/SQ) are the published standard tables, loaded from
  _security_tables.npz (see tools/extract_security_tables.py).
- NEA3/NIA3: ZUC (TS 35.221/35.222/35.223).  S0/S1/D constants likewise.

All host-side byte logic (crypto never touches the device); Python-int
implementations are simulator-fidelity, validated by FIPS-197 / RFC 4493 /
TS 35.222 known-answer vectors plus encrypt-decrypt roundtrips.

A copy of ``srsran_project_tpu/l2/security.py`` (no JAX in it), held equal to it
by the port's tests.
"""

from __future__ import annotations

import os

import numpy as np

_TABLES = np.load(os.path.join(os.path.dirname(__file__), "_security_tables.npz"))
_SR = [int(x) for x in _TABLES["snow3g_sr"]]  # Rijndael S-box (AES + SNOW3G S1)
_SQ = [int(x) for x in _TABLES["snow3g_sq"]]  # SNOW3G S2 (Dickson) S-box
_ZS0 = [int(x) for x in _TABLES["zuc_s0"]]
_ZS1 = [int(x) for x in _TABLES["zuc_s1"]]
_ZD = [int(x) for x in _TABLES["zuc_d"]]

M32 = 0xFFFFFFFF

DIR_UPLINK = 0
DIR_DOWNLINK = 1


def _zero_tail(data: bytes, length_bits: int | None) -> bytes:
    """Zero bits beyond length_bits in the last byte (TS conformance sets
    express lengths in bits; ciphered output bits past LENGTH are zeroed)."""
    if length_bits is None or length_bits >= 8 * len(data):
        return data
    nbytes = (length_bits + 7) // 8
    out = bytearray(data[:nbytes])
    rem = length_bits % 8
    if rem:
        out[-1] &= (0xFF << (8 - rem)) & 0xFF
    return bytes(out) + bytes(len(data) - nbytes)


# ---------------------------------------------------------------------------
# AES-128 core (FIPS-197) + CTR + CMAC  ->  NEA2 / NIA2
# ---------------------------------------------------------------------------

_RCON = (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x40, 0x80, 0x1B, 0x36)


def _xtime(a: int) -> int:
    a <<= 1
    return (a ^ 0x1B) & 0xFF if a & 0x100 else a


def _aes_expand_key(key: bytes) -> list[list[int]]:
    w = [list(key[i : i + 4]) for i in range(0, 16, 4)]
    for r in range(10):
        t = w[-1]
        t = [_SR[t[1]] ^ _RCON[r], _SR[t[2]], _SR[t[3]], _SR[t[0]]]
        for _ in range(4):
            t = [a ^ b for a, b in zip(w[-4], t)]
            w.append(t)
            t = w[-1]
    return [sum(w[4 * i : 4 * i + 4], []) for i in range(11)]  # 11 x 16 bytes


def aes128_encrypt_block(key: bytes, block: bytes) -> bytes:
    rk = _aes_expand_key(key)
    s = [b ^ k for b, k in zip(block, rk[0])]
    for rnd in range(1, 11):
        s = [_SR[b] for b in s]
        # ShiftRows on column-major state: byte i sits at row i%4, col i//4
        s = [s[(i + 4 * (i % 4)) % 16] for i in range(16)]
        if rnd < 10:
            m = []
            for c in range(0, 16, 4):
                a = s[c : c + 4]
                t = a[0] ^ a[1] ^ a[2] ^ a[3]
                m += [a[i] ^ t ^ _xtime(a[i] ^ a[(i + 1) % 4]) for i in range(4)]
            s = m
        s = [b ^ k for b, k in zip(s, rk[rnd])]
    return bytes(s)


def _aes_ctr(key: bytes, iv16: bytes, data: bytes) -> bytes:
    out = bytearray()
    ctr = int.from_bytes(iv16, "big")
    for i in range(0, len(data), 16):
        ks = aes128_encrypt_block(key, ctr.to_bytes(16, "big"))
        chunk = data[i : i + 16]
        out += bytes(a ^ b for a, b in zip(chunk, ks))
        ctr = (ctr + 1) & ((1 << 128) - 1)
    return bytes(out)


def _cmac_subkeys(key: bytes) -> tuple[int, int]:
    l = int.from_bytes(aes128_encrypt_block(key, bytes(16)), "big")
    k1 = (l << 1) & ((1 << 128) - 1)
    if l >> 127:
        k1 ^= 0x87
    k2 = (k1 << 1) & ((1 << 128) - 1)
    if k1 >> 127:
        k2 ^= 0x87
    return k1, k2


def aes_cmac(key: bytes, msg: bytes) -> bytes:
    """AES-CMAC per RFC 4493 / NIST SP 800-38B."""
    k1, k2 = _cmac_subkeys(key)
    n = max(1, (len(msg) + 15) // 16)
    complete = len(msg) and len(msg) % 16 == 0
    last = msg[16 * (n - 1) :]
    if complete:
        lastb = int.from_bytes(last, "big") ^ k1
    else:
        padded = last + b"\x80" + bytes(15 - len(last))
        lastb = int.from_bytes(padded, "big") ^ k2
    x = bytes(16)
    for i in range(n - 1):
        x = aes128_encrypt_block(key, bytes(a ^ b for a, b in zip(x, msg[16 * i : 16 * i + 16])))
    return aes128_encrypt_block(key, bytes(a ^ b for a, b in zip(x, lastb.to_bytes(16, "big"))))


def nea2(key: bytes, count: int, bearer: int, direction: int, data: bytes, length_bits: int | None = None) -> bytes:
    """128-NEA2 ciphering (AES-CTR; TS 33.401 B.1.3). Involutive."""
    iv = count.to_bytes(4, "big") + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)]) + bytes(11)
    return _zero_tail(_aes_ctr(key, iv, data), length_bits)


def nia2(key: bytes, count: int, bearer: int, direction: int, msg: bytes) -> bytes:
    """128-NIA2 integrity (AES-CMAC; TS 33.401 B.2.3): 32-bit MAC."""
    m = count.to_bytes(4, "big") + bytes([((bearer & 0x1F) << 3) | ((direction & 1) << 2)]) + bytes(3) + msg
    return aes_cmac(key, m)[:4]


# ---------------------------------------------------------------------------
# SNOW 3G  ->  NEA1 / NIA1
# ---------------------------------------------------------------------------


def _mulx(v: int, c: int) -> int:
    return ((v << 1) ^ c) & 0xFF if v & 0x80 else (v << 1) & 0xFF


def _mulxpow(v: int, i: int, c: int) -> int:
    for _ in range(i):
        v = _mulx(v, c)
    return v


_MULA = [0] * 256
_DIVA = [0] * 256
for _c in range(256):
    _MULA[_c] = (
        (_mulxpow(_c, 23, 0xA9) << 24)
        | (_mulxpow(_c, 245, 0xA9) << 16)
        | (_mulxpow(_c, 48, 0xA9) << 8)
        | _mulxpow(_c, 239, 0xA9)
    )
    _DIVA[_c] = (
        (_mulxpow(_c, 16, 0xA9) << 24)
        | (_mulxpow(_c, 39, 0xA9) << 16)
        | (_mulxpow(_c, 6, 0xA9) << 8)
        | _mulxpow(_c, 64, 0xA9)
    )


def _s3g_sbox(w: int, table: list[int], c: int) -> int:
    """32->32 S-box: byte S-box then Rijndael MixColumn with constant c."""
    b = [table[(w >> sh) & 0xFF] for sh in (24, 16, 8, 0)]
    r = [
        _mulx(b[0], c) ^ b[1] ^ b[2] ^ _mulx(b[3], c) ^ b[3],
        _mulx(b[0], c) ^ b[0] ^ _mulx(b[1], c) ^ b[2] ^ b[3],
        b[0] ^ _mulx(b[1], c) ^ b[1] ^ _mulx(b[2], c) ^ b[3],
        b[0] ^ b[1] ^ _mulx(b[2], c) ^ b[2] ^ _mulx(b[3], c),
    ]
    return (r[0] << 24) | (r[1] << 16) | (r[2] << 8) | r[3]


class Snow3G:
    """SNOW 3G keystream generator (UEA2/UIA2 spec sections 3-4)."""

    def __init__(self, key: bytes, iv: bytes):
        # K = k3||k2||k1||k0 (k3 = first/most-significant word).  IV words
        # w0..w3 (in byte order) enter the LFSR as: s15^=w0, s12^=w1,
        # s10^=w2, s9^=w3 (spec section 4.1 key/IV loading).
        k3, k2, k1, k0 = [int.from_bytes(key[i : i + 4], "big") for i in range(0, 16, 4)]
        w0, w1, w2, w3 = [int.from_bytes(iv[i : i + 4], "big") for i in range(0, 16, 4)]
        inv = 0xFFFFFFFF
        s = [
            k0 ^ inv, k1 ^ inv, k2 ^ inv, k3 ^ inv,
            k0, k1, k2, k3,
            k0 ^ inv, k1 ^ inv ^ w3, k2 ^ inv ^ w2, k3 ^ inv,
            k0 ^ w1, k1, k2, k3 ^ w0,
        ]
        self.s = s
        self.r1 = self.r2 = self.r3 = 0
        for _ in range(32):
            f = self._clock_fsm()
            self._clock_lfsr(f)
        self._clock_fsm()  # discarded
        self._clock_lfsr(None)

    def _clock_fsm(self) -> int:
        s = self.s
        f = ((s[15] + self.r1) & M32) ^ self.r2
        r = (self.r2 + (self.r3 ^ s[5])) & M32
        self.r3 = _s3g_sbox(self.r2, _SQ, 0x69)
        self.r2 = _s3g_sbox(self.r1, _SR, 0x1B)
        self.r1 = r
        return f

    def _clock_lfsr(self, f: int | None) -> None:
        s = self.s
        v = ((s[0] << 8) & 0xFFFFFF00) ^ _MULA[(s[0] >> 24) & 0xFF] ^ s[2] \
            ^ ((s[11] >> 8) & 0x00FFFFFF) ^ _DIVA[s[11] & 0xFF]
        if f is not None:
            v ^= f
        self.s = s[1:] + [v & M32]

    def keystream(self, n_words: int) -> list[int]:
        out = []
        for _ in range(n_words):
            f = self._clock_fsm()
            out.append(f ^ self.s[0])
            self._clock_lfsr(None)
        return out


def nea1(key: bytes, count: int, bearer: int, direction: int, data: bytes, length_bits: int | None = None) -> bytes:
    """128-NEA1 / UEA2 f8 ciphering (involutive keystream XOR)."""
    bd = ((bearer & 0x1F) << 27) | ((direction & 1) << 26)
    # (w0, w1, w2, w3) = (BD, COUNT, BD, COUNT) per f8 section 4.1
    iv = bd.to_bytes(4, "big") + count.to_bytes(4, "big") + bd.to_bytes(4, "big") + count.to_bytes(4, "big")
    ks = Snow3G(key, iv).keystream((len(data) + 3) // 4)
    stream = b"".join(w.to_bytes(4, "big") for w in ks)[: len(data)]
    return _zero_tail(bytes(a ^ b for a, b in zip(data, stream)), length_bits)


def _mul64(v: int, p: int) -> int:
    """GF(2^64) multiply, reduction polynomial x^64+x^4+x^3+x+1 (0x1B)."""
    r = 0
    for i in range(63, -1, -1):
        r = ((r << 1) ^ 0x1B) & ((1 << 64) - 1) if r >> 63 else (r << 1)
        if (p >> i) & 1:
            r ^= v
    return r


def nia1(key: bytes, count: int, bearer: int, direction: int, msg: bytes, msg_len_bits: int | None = None) -> bytes:
    """128-NIA1 / UIA2 f9 integrity: 32-bit MAC (TS 33.401 B.2.2).

    FRESH = BEARER << 27; direction folded into IV words per the spec.
    """
    length = msg_len_bits if msg_len_bits is not None else 8 * len(msg)
    fresh = (bearer & 0x1F) << 27
    # (w0, w1, w2, w3) = (FRESH^(DIR<<15), COUNT^(DIR<<31), FRESH, COUNT)
    # per f9 section 4.4 key/IV composition
    iv = (
        (fresh ^ ((direction & 1) << 15)).to_bytes(4, "big")
        + ((count ^ ((direction & 1) << 31)) & M32).to_bytes(4, "big")
        + fresh.to_bytes(4, "big")
        + count.to_bytes(4, "big")
    )
    z = Snow3G(key, iv).keystream(5)
    p = (z[0] << 32) | z[1]
    q = (z[2] << 32) | z[3]
    blocks = [int.from_bytes(msg[i : i + 8].ljust(8, b"\0"), "big") for i in range(0, len(msg), 8)] or [0]
    a = 0
    for m in blocks:
        a = _mul64(a ^ m, p)
    a = _mul64(a ^ length, q)
    mac = ((a >> 32) ^ z[4]) & M32
    return mac.to_bytes(4, "big")


# ---------------------------------------------------------------------------
# ZUC  ->  NEA3 / NIA3
# ---------------------------------------------------------------------------

M31 = 0x7FFFFFFF


def _add31(a: int, b: int) -> int:
    c = a + b
    return (c & M31) + (c >> 31)


def _rot31(x: int, k: int) -> int:
    return ((x << k) | (x >> (31 - k))) & M31


def _rot32(x: int, k: int) -> int:
    return ((x << k) | (x >> (32 - k))) & M32


def _zuc_l1(x: int) -> int:
    return x ^ _rot32(x, 2) ^ _rot32(x, 10) ^ _rot32(x, 18) ^ _rot32(x, 24)


def _zuc_l2(x: int) -> int:
    return x ^ _rot32(x, 8) ^ _rot32(x, 14) ^ _rot32(x, 22) ^ _rot32(x, 30)


def _zuc_sbox(x: int) -> int:
    return (
        (_ZS0[(x >> 24) & 0xFF] << 24)
        | (_ZS1[(x >> 16) & 0xFF] << 16)
        | (_ZS0[(x >> 8) & 0xFF] << 8)
        | _ZS1[x & 0xFF]
    )


class Zuc:
    """ZUC stream cipher (TS 35.222)."""

    def __init__(self, key: bytes, iv: bytes):
        self.s = [((key[i] << 23) | (_ZD[i] << 8) | iv[i]) for i in range(16)]
        self.r1 = self.r2 = 0
        for _ in range(32):
            w = self._f(*self._bitreorg())
            self._lfsr(w >> 1)
        self._f(*self._bitreorg())  # discard
        self._lfsr(None)

    def _bitreorg(self) -> tuple[int, int, int, int]:
        s = self.s
        x0 = ((s[15] & 0x7FFF8000) << 1) | (s[14] & 0xFFFF)
        x1 = ((s[11] & 0xFFFF) << 16) | (s[9] >> 15)
        x2 = ((s[7] & 0xFFFF) << 16) | (s[5] >> 15)
        x3 = ((s[2] & 0xFFFF) << 16) | (s[0] >> 15)
        return x0, x1, x2, x3

    def _f(self, x0: int, x1: int, x2: int, x3: int) -> int:
        w = ((x0 ^ self.r1) + self.r2) & M32
        w1 = (self.r1 + x1) & M32
        w2 = self.r2 ^ x2
        self.r1 = _zuc_sbox(_zuc_l1(((w1 << 16) | (w2 >> 16)) & M32))
        self.r2 = _zuc_sbox(_zuc_l2(((w2 << 16) | (w1 >> 16)) & M32))
        self._x3 = x3
        return w

    def _lfsr(self, u: int | None) -> None:
        s = self.s
        v = _add31(_rot31(s[15], 15), _add31(_rot31(s[13], 17), _add31(_rot31(s[10], 21),
            _add31(_rot31(s[4], 20), _add31(_rot31(s[0], 8), s[0])))))
        if u is not None:
            v = _add31(v, u)
        if v == 0:
            v = M31
        self.s = s[1:] + [v]

    def keystream(self, n_words: int) -> list[int]:
        out = []
        for _ in range(n_words):
            w = self._f(*self._bitreorg())
            out.append(w ^ self._x3)
            self._lfsr(None)
        return out


def _zuc_eea3_iv(count: int, bearer: int, direction: int) -> bytes:
    c = count.to_bytes(4, "big")
    iv5 = ((bearer & 0x1F) << 3) | ((direction & 1) << 2)
    half = bytes([c[0], c[1], c[2], c[3], iv5, 0, 0, 0])
    return half + half


def nea3(key: bytes, count: int, bearer: int, direction: int, data: bytes, length_bits: int | None = None) -> bytes:
    """128-NEA3 / 128-EEA3 ciphering (TS 35.221 Annex A)."""
    ks = Zuc(key, _zuc_eea3_iv(count, bearer, direction)).keystream((len(data) + 3) // 4)
    stream = b"".join(w.to_bytes(4, "big") for w in ks)[: len(data)]
    return _zero_tail(bytes(a ^ b for a, b in zip(data, stream)), length_bits)


def nia3(key: bytes, count: int, bearer: int, direction: int, msg: bytes, msg_len_bits: int | None = None) -> bytes:
    """128-NIA3 / 128-EIA3 integrity: 32-bit MAC (TS 35.221 Annex B)."""
    length = msg_len_bits if msg_len_bits is not None else 8 * len(msg)
    c = count.to_bytes(4, "big")
    iv = bytearray(16)
    iv[0:4] = c
    iv[4] = (bearer & 0x1F) << 3
    iv[8] = iv[0] ^ ((direction & 1) << 7)
    iv[9:14] = iv[1:6]
    iv[14] = iv[6] ^ ((direction & 1) << 7)
    iv[15] = iv[7]
    nwords = (length + 31) // 32 + 2
    z = Zuc(key, bytes(iv)).keystream(nwords)
    zbits = 0
    for w in z:
        zbits = (zbits << 32) | w
    total_bits = 32 * nwords

    def zword(i: int) -> int:
        return (zbits >> (total_bits - 32 - i)) & M32

    t = 0
    for i in range(length):
        if (msg[i // 8] >> (7 - (i % 8))) & 1:
            t ^= zword(i)
    t ^= zword(length)
    mac = t ^ zword(32 * (nwords - 1))
    return mac.to_bytes(4, "big")


# ---------------------------------------------------------------------------
# Engine facade (the reference's security_engine_impl)
# ---------------------------------------------------------------------------

CIPHERING = {0: lambda k, c, b, d, x, length_bits=None: x, 1: nea1, 2: nea2, 3: nea3}  # NEA0 = null
INTEGRITY = {1: nia1, 2: nia2, 3: nia3}


class SecurityEngine:
    """Per-bearer ciphering+integrity engine (TS 33.501 key usage).

    Mirrors security_engine_impl.h: protect() appends MAC-I then ciphers,
    unprotect() deciphers then verifies — the PDCP data-plane order.
    """

    def __init__(self, ciphering_algo: int, integrity_algo: int | None,
                 cipher_key: bytes, integrity_key: bytes | None, bearer: int):
        self.nea = ciphering_algo
        self.nia = integrity_algo
        self.ck = cipher_key
        self.ik = integrity_key
        self.bearer = bearer

    def protect(self, count: int, direction: int, pdu_header: bytes, payload: bytes) -> bytes:
        """Integrity over header+payload, then cipher payload+MAC."""
        body = payload
        if self.nia:
            mac = INTEGRITY[self.nia](self.ik, count, self.bearer, direction, pdu_header + payload)
            body = payload + mac
        return CIPHERING[self.nea](self.ck, count, self.bearer, direction, body)

    def unprotect(self, count: int, direction: int, pdu_header: bytes, body: bytes) -> tuple[bytes, bool]:
        """Returns (payload, integrity_ok)."""
        plain = CIPHERING[self.nea](self.ck, count, self.bearer, direction, body)
        if not self.nia:
            return plain, True
        payload, mac = plain[:-4], plain[-4:]
        exp = INTEGRITY[self.nia](self.ik, count, self.bearer, direction, pdu_header + payload)
        return payload, mac == exp


# ---------------------------------------------------------------------------
# Key derivation (TS 33.220 generic KDF + TS 33.501 A.8 algorithm keys)
# ---------------------------------------------------------------------------

import hashlib as _hashlib
import hmac as _hmac

ALGO_TYPE_NRRC_ENC = 0x03
ALGO_TYPE_NRRC_INT = 0x04
ALGO_TYPE_NUP_ENC = 0x05
ALGO_TYPE_NUP_INT = 0x06


def kdf(key: bytes, fc: int, *params: bytes) -> bytes:
    """Generic 3GPP KDF (TS 33.220 B.2): HMAC-SHA256(key, FC||Pi||Li...)."""
    s = bytes([fc]) + b"".join(p + len(p).to_bytes(2, "big") for p in params)
    return _hmac.new(key, s, _hashlib.sha256).digest()


def derive_algo_key(k_gnb: bytes, algo_type: int, algo_id: int) -> bytes:
    """K_RRCenc/K_RRCint/K_UPenc/K_UPint (TS 33.501 A.8): FC=0x69; the
    128-bit algorithm key is the 128 LSBs of the 256-bit KDF output."""
    return kdf(k_gnb, 0x69, bytes([algo_type]), bytes([algo_id]))[16:]
