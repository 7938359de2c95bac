"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` file is compiled by its own ``nvcc`` into a shared
library with a plain C interface, loaded with ``ctypes``; the compilers
run side by side (5.2-5.6 s for four sources on an H100 host, against
11.3-13.2 s for one ``nvcc`` over all of them).  The build happens at first use, into ``build/`` at the
repository root, in a directory named by a hash of every source and
header and of the flags, so a changed source rebuilds.  ``--fmad=false``
keeps every float multiply and add separately rounded unless a kernel
spells out a fused one (``__fmaf_rn``), as the plain torch versions
compute them: the kernels are bit-exact with those only so.  Nothing here
runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import types

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
# Source -> {C entry point: argument types} (pointers and the stream as void*).
_SIGNATURES = {
    "ldpc_decode_dematch.cu": {
        "ldpc_decode_dematch": (
            _P, _I, _I, _I,  # E-group table (n, 10) int64 on the host, n, blocks, C per TB
            _P, _I, _I,  # copy plans (rows, 4) int32, filler range [f_start, f_end)
            _P, _P, _I, _I,  # edges (total, 2) int32, layer offsets (L+1,), L, total
            _I, _I, _I,  # z, ncols, kb
            _I, _I,  # nof_iterations, early_stop
            _P, _P, _P,  # state records (C, L, Z, 4) i32, bits (C, kb*Z) u8, iters (C,) i32
            _P),  # stream
        "ldpc_decode_dematch_blocks_per_sm": (_I, _I, _I, _I, _P)},
    "ldpc_decode.cu": {
        "ldpc_decode": (
            _P, _I, _I, _L, _I,  # llrs, is f32, C, row stride, width read
            _P, _P, _I, _I,  # edges (total, 2) int32, layer offsets (L+1,), L, total
            _I, _I, _I, _I,  # z, ncols, kb, n
            _I, _I, _I,  # nof_iterations, early_stop, bits_only
            _P, _P, _P,  # state records, bits u8 or a-posteriori f32, iters (C,) i32
            _P),  # stream
        "ldpc_decode_blocks_per_sm": (_I, _I, _I, _I, _P)},
    "mmse_weights_4x4.cu": {
        "mmse_weights_4x4": (
            _P, _L, _L, _L, _L,  # h (B, nsc, 4, 4) c64 and its element strides
            _P, _I, _I,  # nv (B,) f32, B, nsc
            _P, _P,  # w (B, nsc, 4, 4) c64, eq_nvar (B, nsc, 4) f32
            _P),  # stream
        "mmse_weights_4x4_occupancy": (_P, _P)},  # registers, blocks per SM
    "mmse_equalize.cu": {
        "mmse_equalize": (
            _P, _L, _L, _L, _L,  # grid (B, 4, nsym, nsc_grid) c64 and its element strides
            _P, _L, _L, _L, _L,  # h (B, 4, nsc, L) c64 and its element strides
            _P, _I, _I, _I, _I, _I,  # nv (B,) f32, B, nsc, L, sc_start, data-symbol mask
            _P, _P,  # x_hat (B, nsym_d*nsc, L) c64, eq_nvar (B, nsym_d*nsc, L) f32
            _P),  # stream
        "mmse_equalize_occupancy": (_I, _P, _P)},  # L, registers, blocks per SM
    "demap_planes.cu": {
        "demap_planes": (
            _P, _P, _P, _P,  # y (B, P, S, N) c64, w (B, N, L, P) c64, eq_nvar f32, Gold bits u8
            _I, _I, _I, _I, _I, _I, _F,  # B, P, S, N, L, qm, scale
            _P, _P,  # planes (B, qm, S*N*L) int8, err2 (B, S, N*L) f32
            _P),  # stream
        "demap_planes_occupancy": (_I, _I, _P, _P)},  # qm, L, registers, blocks per SM
    "demap_llrs.cu": {
        "demap_llrs": (
            _P, _P, _P,  # x_hat (B, ndata, L) c64, eq_nvar (B, ndata, L) f32, Gold bits u8
            _L, _I, _I, _F,  # rows B*ndata, L, qm, scale
            _P, _P,  # llr (B, ndata*L*qm) int8, err2 (B, ndata*L) f32
            _P),  # stream
        "demap_llrs_occupancy": (_I, _I, _P, _P)},  # qm, L, registers, blocks per SM
    "pucch_f2_rx.cu": {
        "pucch_f2_rx": (
            _P, _L, _P,  # grid c64, its element count, the parameter buffer (int32)
            _I, _I,  # occasions, K_max
            _P, _P, _P,  # bits (O, K_max) u8, ok (O,) bool, snr_db (O,) f32
            _P),  # stream
        "pucch_f2_rx_occupancy": (_P, _P)},  # registers, blocks per SM
    "pusch_estimate.cu": {
        "pusch_estimate": (
            _P, _L, _L, _L, _L, _I,  # grid (B, P, nsym, nsc) c64, its four element strides, nsc
            _P, _P, _I, _P,  # pilot REs (nl, nsym_d*Np) i64, pilots (rb, nl, nsym_d, Np), rb, OCC
            _P, _P, _P, _P, _P,  # interpolation: left, right (i64), fraction, coordinate; taps
            _I, _I, _I, _I, _I, _I, _F,  # B, P, nl, nsym_d, Np, nof_sc, beta^2
            _P, _P, _P,  # h (B, nof_sc, P, nl) c64, partial sums (B, nl*P) f32, noise_var (B,)
            _P),  # stream
        "pusch_estimate_occupancy": (_P, _P)},  # registers, blocks per SM
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build_dir() -> pathlib.Path:
    """Where the libraries for the current sources and flags live."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"kernels_{h.hexdigest()[:16]}"


@functools.lru_cache(maxsize=None)
def library() -> types.SimpleNamespace:
    """Every kernel's C entry point, as attributes, built first if a
    library is missing.  A failed build raises with the compiler's output;
    the ptxas resource report of each successful build is kept beside its
    library (``.log``)."""
    out_dir = build_dir()
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for src in _SIGNATURES:
        lib = out_dir / f"lib{pathlib.Path(src).stem}.so"
        if not lib.exists():
            tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
            procs[src] = (lib, tmp, subprocess.Popen(
                [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for src, (lib, tmp, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc {src} failed with code {proc.returncode}:\n{log}")
            continue
        lib.with_suffix(".log").write_text(log)
        os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    fns = {}
    for src, entries in _SIGNATURES.items():
        lib = ctypes.CDLL(str(out_dir / f"lib{pathlib.Path(src).stem}.so"))
        for name, argtypes in entries.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
            fns[name] = fn
    return types.SimpleNamespace(**fns)


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
