"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` into ONE shared library
with a plain C interface, loaded with ``ctypes``.  The build happens at
first use, into ``build/`` at the repository root; the library's file name
carries a hash of the sources and flags, so a changed source rebuilds.
``--fmad=false`` keeps every float multiply and add separately rounded,
as the plain torch versions compute them (the LDPC min-sum update is
bit-exact only without contraction).  Nothing here runs at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess

_PKG = pathlib.Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
# C entry points: name -> argument types (pointers and the stream as void*).
_SIGNATURES = {
    "ldpc_decode_dematch": (
        _P, _I, _I, _I,  # llrs (C, E) int8, C, E, qm
        _P, _I,  # copy plan (n, 4) int32, n
        _I, _I,  # filler range [f_start, f_end) in buffer coordinates
        _P, _P, _I, _I,  # edges (total, 2) int32, layer offsets (L+1,), L, total
        _I, _I, _I,  # z, ncols, kb
        _I, _I,  # nof_iterations, early_stop
        _P, _P, _P,  # r scratch (C, total*Z) f32, bits (C, kb*Z) u8, iters (C,) i32
        _P),  # stream
    "mmse_weights_4x4": (
        _P, _P, _I, _I,  # h (n, 4, 4) c64, nv (n / rows_per_nv,) f32, n, rows_per_nv
        _P, _P,  # w (n, 4, 4) c64, eq_nvar (n, 4) f32
        _P),  # stream
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def library_path() -> pathlib.Path:
    """Where the library for the current sources and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libsrsran_torch_kernels_{h.hexdigest()[:16]}.so"


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if it is missing.  A failed
    build raises with the compiler's output; the ptxas resource report of
    a successful build is kept beside the library (``.log``)."""
    out = library_path()
    if not out.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        sources = [str(s) for s in sorted(CSRC.glob("*.cu"))]
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp), *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed with code {proc.returncode}:\n"
                               f"{proc.stdout}\n{proc.stderr}")
        out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
        os.replace(tmp, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status}")
