"""Build and load the CUDA kernels of ``rankfm_tpu_torch/csrc``.

The sources are compiled with ``nvcc`` at first use into a shared library
with a plain C interface, loaded with ``ctypes``. The library goes into
``rankfm_tpu_torch/_build/<hash>/``, keyed by the sources and the flags, so
an edited source rebuilds and an unchanged one loads at once. A failed
build raises; nothing falls back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[1]
SOURCES = (_PKG / "csrc" / "fused_chunk.cu",)
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_ARGTYPES = {
    # tab_u, tab_i, D, F, rec, packed, W, blk, ublk, iblk, acc, ll_rows,
    # chosen, nT, C, UB, BLK, NW, M, nm1, log_I, mult_bpr, seed, eta, dreg,
    # stream
    "rfm_fused_batch": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P, _P,
                        _I, _I, _I, _I, _I, _I, _F, _F, _F, ctypes.c_uint,
                        _F, _F, _P],
}

_lib = None
build_info = {}   # {"seconds": build time (0 when loaded as built), "log": nvcc output}


def nvcc_path():
    """nvcc from $CUDA_HOME / $CUDA_PATH, else $PATH, else the toolkit's
    default install prefix."""
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cand = Path(os.environ[env]) / "bin" / "nvcc"
            if cand.exists():
                return str(cand)
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def _digest():
    h = hashlib.sha256()
    for src in SOURCES:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def build():
    """Compile the sources unless this content's library exists; returns
    its path."""
    out_dir = BUILD_DIR / _digest()
    lib_path = out_dir / "libfused_chunk.so"
    if lib_path.exists():
        build_info.setdefault("seconds", 0.0)
        return lib_path
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f"libfused_chunk.{os.getpid()}.tmp.so"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), *map(str, SOURCES)]
    t0 = time.time()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    build_info["seconds"] = time.time() - t0
    build_info["log"] = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n"
            f"{build_info['log']}")
    os.replace(tmp, lib_path)
    return lib_path


def load():
    """The loaded kernel library (built at first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rfm_error_string.argtypes = [ctypes.c_int]
        lib.rfm_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def error_string(err):
    return load().rfm_error_string(int(err)).decode()
