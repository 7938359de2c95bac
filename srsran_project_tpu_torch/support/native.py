"""ctypes bindings of the port's native host library (``native/*.cpp``).

Port of ``srsran_project_tpu/support/native.py``: O-RAN BFP IQ
compression (the reference's lib/ofh/compression), the simulated-RF IQ
transport over UDP (lib/radio/zmq), the SPSC sample ring and the OFH
C-/U-plane serdes.  This is host code on both sides of the port: the
device only ever sees resource grids and sample tensors.

The library is built at first use from the port's own copy of the
sources (``srsran_project_tpu_torch/native/``) with ``native/Makefile``'s
flags, so the port's library and the reference's write the same bytes on
one machine.  It goes into ``build/native_<hash>/`` at the repository
root (a hash of the sources, the flags and the instruction set that
``-march=native`` selects on this host): each builder links into a
file of its own and renames it into place, so concurrent first uses (one
per test worker) cannot read a half-written library.  A failed build or
load raises with the compiler's or the loader's message; there is no
fallback.  ``_bfp_compress_np`` / ``_bfp_decompress_np`` are the plain
numpy versions the tests hold the native BFP against.  Nothing here runs
at import.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

import numpy as np
import torch

_PKG = pathlib.Path(__file__).resolve().parent.parent
SRC_DIR = _PKG / "native"
BUILD_DIR = _PKG.parent / "build"
SOURCES = ("bfp.cpp", "iq_transport.cpp", "ring_buffer.cpp", "ofh_serdes.cpp")
# native/Makefile: $(CXX) $(CXXFLAGS) -shared -o $@ $(SRCS), CXX = g++.
CXX_FLAGS = ("-O3", "-Wall", "-fPIC", "-std=c++17", "-march=native", "-shared")
LIB_NAME = "libsrsran_tpu_native.so"

_P = ctypes.c_void_p
_I = ctypes.c_int
_U16 = ctypes.c_uint16
# C entry point -> (argument types, result type).
_SIGNATURES = {
    "bfp_compressed_prb_bytes": ((_I,), _I),
    "bfp_compress": ((_P, _I, _I, _P), None),
    "bfp_decompress": ((_P, _I, _I, _P), None),
    "iq_open_rx": ((ctypes.c_char_p, _I), _I),
    "iq_open_tx": ((ctypes.c_char_p, _I), _I),
    "iq_send": ((_I, ctypes.c_uint32, _I, _I, _P, _I), _I),
    "iq_recv": ((_I, _P, _P, _P, _P, _I, _I), _I),
    "iq_close": ((_I,), None),
    "ring_create": ((_I, _I), _P),
    "ring_destroy": ((_P,), None),
    "ring_push": ((_P, _P), _I),
    "ring_pop": ((_P, _P), _I),
    "ring_size": ((_P,), _I),
    "ofh_uplane_size": ((_I, _I), _I),
    "ofh_uplane_build": ((_P, _I, _U16, _U16) + (_I,) * 8 + (_P,), _I),
    "ofh_uplane_parse": ((_P, _I) + (_P,) * 10, _I),
    "ofh_cplane_size": ((_I, _I), _I),
    "ofh_cplane_build": ((_P, _I, _U16, _U16) + (_I,) * 7 + (_P, _I), _I),
    "ofh_cplane_parse": ((_P, _I) + (_P,) * 9 + (_P, _I), _I),
    "ofh_uplane_size_static": ((_I, _I), _I),
    "ofh_uplane_build_static": ((_P, _I, _U16, _U16) + (_I,) * 8 + (_P,), _I),
    "ofh_uplane_parse_static": ((_P, _I, _I) + (_P,) * 9, _I),
    "ofh_cplane_build_comp": ((_P, _I, _U16, _U16) + (_I,) * 6 + (_P, _I), _I),
    "ofh_cplane_comp_hdr": ((_P, _I), _I),
    "ofh_cplane_size_type0": ((), _I),
    "ofh_cplane_build_type0": ((_P, _I, _U16, _U16) + (_I,) * 8 + (_P,), _I),
    "ofh_cplane_parse_type0": ((_P, _I) + (_P,) * 10 + (_P,), _I),
}


@functools.lru_cache(maxsize=None)
def _native_target() -> str:
    """What ``-march=native`` selects on this host (g++'s target options),
    so that a build directory shared between hosts keeps one library per
    instruction set; empty without g++."""
    cxx = shutil.which("g++")
    if cxx is None:
        return ""
    return subprocess.run([cxx, "-march=native", "-Q", "--help=target"], capture_output=True,
                          text=True).stdout


def build_dir() -> pathlib.Path:
    """Where the library of the current sources, flags and host lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_native_target().encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return BUILD_DIR / f"native_{h.hexdigest()[:16]}"


def _build(lib: pathlib.Path) -> None:
    """Compile the sources into ``lib``: link into a per-process file, then
    rename it into place."""
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("building the native library needs g++, which is not on PATH")
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), *(str(SRC_DIR / s) for s in SOURCES)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed with code {proc.returncode} building {lib}:\n"
                           f"{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)


@functools.lru_cache(maxsize=None)
def get_lib() -> ctypes.CDLL:
    """The native library, built first if it is missing."""
    path = build_dir() / LIB_NAME
    if not path.exists():
        _build(path)
    try:
        lib = ctypes.CDLL(str(path))
    except OSError as e:
        raise RuntimeError(f"loading the native library {path} failed: {e}") from e
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = restype
    return lib


def _int16(x, what: str, multiple: int = 24) -> np.ndarray:
    x = np.ascontiguousarray(x, np.int16)
    if x.ndim != 1 or x.size % multiple:
        raise ValueError(f"{what}: want a flat int16 array of a multiple of {multiple} "
                         f"values, got shape {x.shape}")
    return x


# ---------------------------------------------------------------------------
# BFP compression
# ---------------------------------------------------------------------------

def bfp_compress(samples: np.ndarray, width: int = 9) -> np.ndarray:
    """int16 IQ (nof_prb*24,) -> compressed bytes."""
    samples = _int16(samples, "bfp_compress")
    nof_prb = samples.size // 24
    lib = get_lib()
    out = np.empty(nof_prb * lib.bfp_compressed_prb_bytes(width), np.uint8)
    lib.bfp_compress(samples.ctypes.data, nof_prb, width, out.ctypes.data)
    return out


def bfp_decompress(data: np.ndarray, nof_prb: int, width: int = 9) -> np.ndarray:
    data = np.ascontiguousarray(data, np.uint8)
    if data.size < nof_prb * _prb_bytes(width):
        raise ValueError(f"bfp_decompress: {data.size} bytes hold fewer than {nof_prb} PRBs")
    out = np.empty(nof_prb * 24, np.int16)
    get_lib().bfp_decompress(data.ctypes.data, nof_prb, width, out.ctypes.data)
    return out


def _prb_bytes(width: int) -> int:
    return 1 + (24 * width + 7) // 8


def _bfp_compress_np(samples, nof_prb, width):
    out = np.zeros(nof_prb * _prb_bytes(width), np.uint8)
    for p in range(nof_prb):
        blk = samples[p * 24 : (p + 1) * 24].astype(np.int32)
        maxabs = int(np.abs(blk).max())
        e = 0
        while (maxabs >> e) >= (1 << (width - 1)):
            e += 1
        mant = (blk >> e) & ((1 << width) - 1)
        bits = ((mant[:, None] >> np.arange(width - 1, -1, -1)) & 1).reshape(-1)
        dst = p * _prb_bytes(width)
        out[dst] = e
        packed = np.packbits(bits)
        out[dst + 1 : dst + 1 + len(packed)] = packed
    return out


def _bfp_decompress_np(data, nof_prb, width):
    out = np.empty(nof_prb * 24, np.int16)
    pb = _prb_bytes(width)
    for p in range(nof_prb):
        src = data[p * pb : (p + 1) * pb]
        e = int(src[0])
        bits = np.unpackbits(src[1:])[: 24 * width].reshape(24, width)
        mant = (bits * (1 << np.arange(width - 1, -1, -1))).sum(axis=1).astype(np.int32)
        mant = np.where(mant >= (1 << (width - 1)), mant - (1 << width), mant)
        out[p * 24 : (p + 1) * 24] = (mant << e).astype(np.int16)
    return out


# ---------------------------------------------------------------------------
# IQ transport
# ---------------------------------------------------------------------------

class IqSocket:
    """UDP IQ frame endpoint over the native transport: the one place
    where a sample tensor is copied to the host."""

    def __init__(self, fd: int):
        self._lib = get_lib()
        self.fd = fd

    @classmethod
    def rx(cls, port: int, bind: str = "127.0.0.1") -> "IqSocket":
        fd = get_lib().iq_open_rx(bind.encode(), port)
        if fd < 0:
            raise OSError("iq_open_rx failed")
        return cls(fd)

    @classmethod
    def tx(cls, port: int, dest: str = "127.0.0.1") -> "IqSocket":
        fd = get_lib().iq_open_tx(dest.encode(), port)
        if fd < 0:
            raise OSError("iq_open_tx failed")
        return cls(fd)

    def send(self, slot: int, symbol: int, port_id: int, iq) -> int:
        """iq: complex64 samples (a numpy array or a tensor on any device)
        -> int16 interleaved on the wire (Q15)."""
        if isinstance(iq, torch.Tensor):
            iq = iq.detach().cpu().numpy()
        iq = np.asarray(iq).reshape(-1)
        scaled = np.empty(iq.size * 2, np.int16)
        scaled[0::2] = np.clip(np.round(iq.real * 32767), -32768, 32767)
        scaled[1::2] = np.clip(np.round(iq.imag * 32767), -32768, 32767)
        return self._lib.iq_send(self.fd, slot, symbol, port_id, scaled.ctypes.data, iq.size)

    def recv(self, max_samples: int = 8192, timeout_ms: int = 100):
        buf = np.empty(max_samples * 2, np.int16)
        slot = ctypes.c_uint32()
        symbol = ctypes.c_int()
        port_id = ctypes.c_int()
        n = self._lib.iq_recv(self.fd, ctypes.byref(slot), ctypes.byref(symbol),
                              ctypes.byref(port_id), buf.ctypes.data, max_samples, timeout_ms)
        if n <= 0:
            return None
        iq = (buf[0 : 2 * n : 2].astype(np.float32) + 1j * buf[1 : 2 * n : 2].astype(np.float32)) / 32767.0
        return slot.value, symbol.value, port_id.value, iq.astype(np.complex64)

    def close(self):
        self._lib.iq_close(self.fd)


class SampleRing:
    """SPSC ring of int16 sample blocks."""

    def __init__(self, nof_blocks: int, block_samples: int):
        self._lib = get_lib()
        self.block_samples = block_samples
        self._h = self._lib.ring_create(nof_blocks, block_samples)
        if not self._h:
            raise MemoryError

    def push(self, block: np.ndarray) -> bool:
        block = np.ascontiguousarray(block, np.int16)
        if block.size != self.block_samples:
            raise ValueError(f"SampleRing.push: {block.size} samples, the ring's blocks hold "
                             f"{self.block_samples}")
        return bool(self._lib.ring_push(self._h, block.ctypes.data))

    def pop(self):
        out = np.empty(self.block_samples, np.int16)
        if not self._lib.ring_pop(self._h, out.ctypes.data):
            return None
        return out

    def __len__(self):
        return self._lib.ring_size(self._h)

    def close(self):
        if self._h:
            self._lib.ring_destroy(self._h)
            self._h = None


# ---------------------------------------------------------------------------
# OFH U-plane serdes (eCPRI + ORAN CUS-style headers + BFP payload)
# ---------------------------------------------------------------------------

def ofh_uplane_build(iq: np.ndarray, *, pc_id=0, seq_id=0, direction=0, frame_id=0,
                     subframe_id=0, slot_id=0, symbol_id=0, start_prb=0,
                     width=9) -> np.ndarray:
    """Serialize int16 interleaved IQ (nof_prb*24,) into one U-plane message."""
    lib = get_lib()
    iq = _int16(iq, "ofh_uplane_build")
    nof_prb = iq.size // 24
    out = np.empty(lib.ofh_uplane_size(nof_prb, width), np.uint8)
    n = lib.ofh_uplane_build(out.ctypes.data, len(out), pc_id, seq_id, direction,
                             frame_id, subframe_id, slot_id, symbol_id, start_prb,
                             nof_prb, width, iq.ctypes.data)
    if n < 0:
        raise ValueError("ofh_uplane_build failed")
    return out[:n]


def ofh_uplane_parse(data: np.ndarray):
    """Parse one U-plane message -> (header dict, int16 IQ array)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    pc = ctypes.c_uint16(); sq = ctypes.c_uint16()
    di = ctypes.c_int(); fr = ctypes.c_int(); sf = ctypes.c_int(); sl = ctypes.c_int()
    sy = ctypes.c_int(); sp = ctypes.c_int(); wd = ctypes.c_int()
    refs = [ctypes.byref(v) for v in (pc, sq, di, fr, sf, sl, sy, sp, wd)]
    n = lib.ofh_uplane_parse(data.ctypes.data, len(data), *refs, None)
    if n < 0:
        raise ValueError("malformed OFH U-plane message")
    iq = np.empty(n * 24, np.int16)
    lib.ofh_uplane_parse(data.ctypes.data, len(data), *refs, iq.ctypes.data)
    hdr = {"pc_id": pc.value, "seq_id": sq.value, "direction": di.value,
           "frame_id": fr.value, "subframe_id": sf.value, "slot_id": sl.value,
           "symbol_id": sy.value, "start_prb": sp.value, "width": wd.value,
           "nof_prb": n}
    return hdr, iq


# ---------------------------------------------------------------------------
# OFH C-plane (scheduling commands; native/ofh_serdes.cpp)
# ---------------------------------------------------------------------------

class _CplaneSectionStruct(ctypes.Structure):
    _fields_ = [("section_id", ctypes.c_uint16), ("start_prbc", ctypes.c_uint16),
                ("num_prbc", ctypes.c_uint8), ("re_mask", ctypes.c_uint16),
                ("num_symbol", ctypes.c_uint8), ("beam_id", ctypes.c_uint16),
                ("freq_offset", ctypes.c_int32)]


_SECTION_FIELDS = ("section_id", "start_prbc", "num_prbc", "re_mask", "num_symbol", "beam_id",
                   "freq_offset")


@dataclasses.dataclass(frozen=True)
class CplaneSection:
    section_id: int = 0
    start_prbc: int = 0
    num_prbc: int = 0
    re_mask: int = 0xFFF
    num_symbol: int = 14
    beam_id: int = 0
    freq_offset: int = 0


def _sections_struct(sections):
    arr = (_CplaneSectionStruct * len(sections))()
    for i, s in enumerate(sections):
        for f in _SECTION_FIELDS:
            setattr(arr[i], f, getattr(s, f))
    return arr


def _section(st) -> CplaneSection:
    return CplaneSection(**{f: getattr(st, f) for f in _SECTION_FIELDS})


def ofh_cplane_build(sections, *, rtc_id=0, seq_id=0, direction=1, frame_id=0,
                     subframe_id=0, slot_id=0, start_symbol=0, section_type=1,
                     time_offset=0) -> np.ndarray:
    """Serialize a C-plane message (section type 1 scheduling / 3 PRACH)."""
    lib = get_lib()
    n = len(sections)
    arr = _sections_struct(sections)
    out = np.empty(lib.ofh_cplane_size(section_type, n), np.uint8)
    r = lib.ofh_cplane_build(out.ctypes.data, out.size, rtc_id, seq_id, direction,
                             frame_id, subframe_id, slot_id, start_symbol,
                             section_type, time_offset, ctypes.byref(arr), n)
    if r < 0:
        raise ValueError("ofh_cplane_build failed")
    return out


def ofh_cplane_parse(data: np.ndarray, max_sections: int = 64):
    """Parse a C-plane message -> (header dict, [CplaneSection])."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    rtc = ctypes.c_uint16()
    seq = ctypes.c_uint16()
    ints = [ctypes.c_int() for _ in range(7)]
    arr = (_CplaneSectionStruct * max_sections)()
    n = lib.ofh_cplane_parse(data.ctypes.data, data.size, ctypes.byref(rtc),
                             ctypes.byref(seq), *[ctypes.byref(v) for v in ints],
                             ctypes.byref(arr), max_sections)
    if n < 0:
        raise ValueError("malformed C-plane message")
    hdr = {"rtc_id": rtc.value, "seq_id": seq.value, "direction": ints[0].value,
           "frame_id": ints[1].value, "subframe_id": ints[2].value,
           "slot_id": ints[3].value, "start_symbol": ints[4].value,
           "section_type": ints[5].value, "time_offset": ints[6].value}
    return hdr, [_section(arr[i]) for i in range(min(n, max_sections))]


# ---------------------------------------------------------------------------
# Static-compression OFH variants + C-plane section type 0 (idle/guard)
# ---------------------------------------------------------------------------

def ud_comp_hdr(width: int, direction: int, mode: str = "dynamic",
                method: int = 1) -> int:
    """The udCompHdr byte per the reference's serialize_compression_header:
    static mode and downlink always encode 0; dynamic uplink encodes
    iqWidth<<4|compMeth with width 16 mapping to 0
    (ofh_cplane_message_builder_{static,dynamic}_compression_impl.cpp)."""
    if mode == "static" or direction == 1:
        return 0
    return (((0 if width == 16 else width) & 0xF) << 4) | (method & 0xF)


def ofh_uplane_build_static(iq: np.ndarray, *, pc_id=0, seq_id=0, direction=0,
                            frame_id=0, subframe_id=0, slot_id=0, symbol_id=0,
                            start_prb=0, width=9) -> np.ndarray:
    """Static-compression U-plane message: no udCompHdr on the wire — the
    width is fixed by configuration on both ends."""
    lib = get_lib()
    iq = _int16(iq, "ofh_uplane_build_static")
    nof_prb = iq.size // 24
    out = np.empty(lib.ofh_uplane_size_static(nof_prb, width), np.uint8)
    n = lib.ofh_uplane_build_static(out.ctypes.data, len(out), pc_id, seq_id,
                                    direction, frame_id, subframe_id, slot_id,
                                    symbol_id, start_prb, nof_prb, width,
                                    iq.ctypes.data)
    if n < 0:
        raise ValueError("ofh_uplane_build_static failed")
    return out[:n]


def ofh_uplane_parse_static(data: np.ndarray, width: int):
    """Parse a static-compression U-plane message (configured width)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    pc = ctypes.c_uint16(); sq = ctypes.c_uint16()
    ints = [ctypes.c_int() for _ in range(6)]
    refs = [ctypes.byref(pc), ctypes.byref(sq), *[ctypes.byref(v) for v in ints]]
    n = lib.ofh_uplane_parse_static(data.ctypes.data, len(data), width, *refs, None)
    if n < 0:
        raise ValueError("malformed static U-plane message")
    iq = np.empty(n * 24, np.int16)
    lib.ofh_uplane_parse_static(data.ctypes.data, len(data), width, *refs, iq.ctypes.data)
    hdr = {"pc_id": pc.value, "seq_id": sq.value, "direction": ints[0].value,
           "frame_id": ints[1].value, "subframe_id": ints[2].value,
           "slot_id": ints[3].value, "symbol_id": ints[4].value,
           "start_prb": ints[5].value, "width": width, "nof_prb": n}
    return hdr, iq


def ofh_cplane_build_comp(sections, *, rtc_id=0, seq_id=0, direction=1,
                          frame_id=0, subframe_id=0, slot_id=0, start_symbol=0,
                          comp_byte=0) -> np.ndarray:
    """Type-1 C-plane message with an explicit udCompHdr byte (use
    ud_comp_hdr() to derive it from the compression mode)."""
    lib = get_lib()
    n = len(sections)
    arr = _sections_struct(sections)
    out = np.empty(lib.ofh_cplane_size(1, n), np.uint8)
    r = lib.ofh_cplane_build_comp(out.ctypes.data, out.size, rtc_id, seq_id,
                                  direction, frame_id, subframe_id, slot_id,
                                  start_symbol, comp_byte, ctypes.byref(arr), n)
    if r < 0:
        raise ValueError("ofh_cplane_build_comp failed")
    return out


def ofh_cplane_comp_hdr(data: np.ndarray) -> int:
    """Extract the udCompHdr byte of a type-1 C-plane message."""
    data = np.ascontiguousarray(data, np.uint8)
    v = get_lib().ofh_cplane_comp_hdr(data.ctypes.data, data.size)
    if v < 0:
        raise ValueError("not a type-1 C-plane message")
    return v


def ofh_cplane_build_type0(section: CplaneSection, *, rtc_id=0, seq_id=0,
                           direction=1, frame_id=0, subframe_id=0, slot_id=0,
                           start_symbol=0, time_offset=0, frame_structure=0,
                           cp_length=0) -> np.ndarray:
    """Idle/guard-period indication (C-plane section type 0; reference
    build_idle_guard_period_message, ofh_cplane_message_builder_impl.cpp:222)."""
    lib = get_lib()
    arr = _sections_struct([section])
    out = np.empty(lib.ofh_cplane_size_type0(), np.uint8)
    r = lib.ofh_cplane_build_type0(out.ctypes.data, out.size, rtc_id, seq_id,
                                   direction, frame_id, subframe_id, slot_id,
                                   start_symbol, time_offset, frame_structure,
                                   cp_length, ctypes.byref(arr))
    if r < 0:
        raise ValueError("ofh_cplane_build_type0 failed")
    return out


def ofh_cplane_parse_type0(data: np.ndarray):
    """Parse a type-0 idle/guard message -> (header dict, CplaneSection)."""
    lib = get_lib()
    data = np.ascontiguousarray(data, np.uint8)
    rtc = ctypes.c_uint16(); seq = ctypes.c_uint16()
    ints = [ctypes.c_int() for _ in range(8)]
    arr = (_CplaneSectionStruct * 1)()
    r = lib.ofh_cplane_parse_type0(data.ctypes.data, data.size,
                                   ctypes.byref(rtc), ctypes.byref(seq),
                                   *[ctypes.byref(v) for v in ints],
                                   ctypes.byref(arr))
    if r < 0:
        raise ValueError("malformed type-0 C-plane message")
    hdr = {"rtc_id": rtc.value, "seq_id": seq.value, "direction": ints[0].value,
           "frame_id": ints[1].value, "subframe_id": ints[2].value,
           "slot_id": ints[3].value, "start_symbol": ints[4].value,
           "time_offset": ints[5].value, "frame_structure": ints[6].value,
           "cp_length": ints[7].value}
    return hdr, _section(arr[0])
