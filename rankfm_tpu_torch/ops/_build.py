"""Build and load the CUDA kernels of ``rankfm_tpu_torch/csrc``.

Each library of `LIBS` is compiled with ``nvcc`` at first use into a shared
library of its own with a plain C interface, loaded with ``ctypes``; all
compilers run at the same time. ``fused_chunk.cu`` becomes four libraries,
one per instantiation of its kernel (side features of users / of items),
because one compiler would build the four one after another. The libraries
go into ``rankfm_tpu_torch/_build/<hash>/``, keyed by the sources, the
headers they include and the flags, so an edited source rebuilds and an
unchanged one loads at once. A failed build raises; nothing falls back.
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
SOURCES = (_PKG / "csrc" / "fused_chunk.cu",
           _PKG / "csrc" / "table_update.cu",
           _PKG / "csrc" / "topk_select.cu",
           _PKG / "csrc" / "pcg_normal.cu")
# headers the sources include, part of the content key
HEADERS = (_PKG / "csrc" / "ziggurat.h",)
# library name -> (source, its own nvcc flags)
LIBS = {f"fused_chunk_{uf}{it}": (SOURCES[0], (f"-DRFM_UF={uf}",
                                               f"-DRFM_IF={it}"))
        for uf in (0, 1) for it in (0, 1)}
LIBS["table_update"] = (SOURCES[1], ())
LIBS["topk_select"] = (SOURCES[2], ())
LIBS["pcg_normal"] = (SOURCES[3], ())
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
_U = ctypes.c_ulonglong
# source stem -> {function: argtypes}; every function returns int, and every
# library also exports `rfm_error_string`
_ARGTYPES = {
    "fused_chunk": {
        # tab_u, tab_i, D, F, rec, packed, W, blk, ublk, iblk, acc, ll_rows,
        # chosen, nT, C, UB, BLK, NW, M, nm1, log_I, mult_bpr, seed, scal,
        # x_uf, x_if, tab_uf, tab_if, P, Q, facc, pw, cnt, phase_ns, stream
        "rfm_fused_batch": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P, _P, _P,
                            _P, _I, _I, _I, _I, _I, _I, _F, _F, _F,
                            _P, _P, _P, _P, _P, _P, _I, _I,
                            _P, _P, _P, _P, _P],
        # n, cooperative, stream
        "rfm_phase_probe": [_I, _I, _P],
    },
    "table_update": {
        # tab, bias, N, F, idx, upd, B2, claim, acc, scal, stream
        "rfm_table_update_sorted": [_P, _P, _I, _I, _P, _P, _I, _P, _P,
                                    _P, _P],
        # tab, bias, N, F, idx, upd, B2, acc, scal, stream
        "rfm_table_update_dense": [_P, _P, _I, _I, _P, _P, _I, _P, _P, _P],
    },
    "topk_select": {
        # v_u, v_i, w_i, v_uf, v_if, w_if, x_uf, x_if, u_idx, bitmap, W, U,
        # I, F, P, Q, B, k, S, scratch, out_i, out_s, stream
        "rfm_topk_select": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                            _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P],
    },
    "pcg_normal": {
        # state and increment (hi, lo), N, seg_words, mask, cnt, stream
        "rfm_pcg_scan": [_U, _U, _U, _U, _L, _I, _P, _P, _P],
        # ..., N, seg_words, mask, off, rec, stream
        "rfm_pcg_compact": [_U, _U, _U, _U, _L, _I, _P, _P, _P, _P],
        # ..., N, seg_words, mask, base, T, n0, sigma, out0, out1, stream
        "rfm_pcg_emit": [_U, _U, _U, _U, _L, _I, _P, _P, _L, _L,
                         ctypes.c_double, _P, _P, _P],
    },
}

_libs = {}
# {"seconds": wall time of the parallel build (0 when loaded as built),
#  "log": nvcc output of every source}
build_info = {}


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
    for src in SOURCES + HEADERS:
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(repr(sorted((k, v[0].name, v[1]) for k, v in LIBS.items()))
             .encode())
    return h.hexdigest()[:16]


def build():
    """Compile every library that is missing for this content, all
    compilers at once; returns the directory holding ``lib<name>.so`` for
    each name of `LIBS`."""
    out_dir = BUILD_DIR / _digest()
    todo = [n for n in LIBS if not (out_dir / f"lib{n}.so").exists()]
    if not todo:
        build_info.setdefault("seconds", 0.0)
        return out_dir
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.time()
    jobs = []
    for name in todo:
        src, flags = LIBS[name]
        tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
        cmd = [nvcc, *NVCC_FLAGS, *flags, "-o", str(tmp), str(src)]
        jobs.append((name, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    logs, failed = [], []
    for name, tmp, cmd, proc in jobs:
        out, _ = proc.communicate()
        logs.append(f"== {name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}"
                          f"\n{out}")
        else:
            os.replace(tmp, out_dir / f"lib{name}.so")
    build_info["seconds"] = time.time() - t0
    build_info["log"] = "\n".join(logs)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out_dir


def load(name="fused_chunk_00"):
    """The loaded library ``name`` of `LIBS` (every library is built at the
    first load)."""
    if name not in _libs:
        out_dir = build()
        lib = ctypes.CDLL(str(out_dir / f"lib{name}.so"))
        for fn_name, argtypes in _ARGTYPES[LIBS[name][0].stem].items():
            fn = getattr(lib, fn_name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.rfm_error_string.argtypes = [ctypes.c_int]
        lib.rfm_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


def error_string(err, name="fused_chunk_00"):
    return load(name).rfm_error_string(int(err)).decode()
