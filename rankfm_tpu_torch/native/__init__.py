"""ctypes bindings for the native host-side data pipeline (``ingest.cpp``),
the port's copy of the loader half of `rankfm_tpu/native/__init__.py`.

The library is compiled with g++ at first use, from the source beside this
file and nothing else, into ``rankfm_tpu_torch/_build/`` (where the CUDA
kernels' libraries go too). All entry points have pure-numpy fallbacks in
`rankfm_tpu_torch.utils.data`: without a toolchain `get_lib` returns None,
every function here returns None and the callers take the numpy / pandas
path, which gives the same arrays. That is a convenience of the host code;
nothing on a device depends on it.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from rankfm_tpu_torch.ops._build import BUILD_DIR

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "ingest.cpp")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")

MAP_REGIMES = ("bsearch", "table", "hash")   # `rfm_map_ids_regime`'s codes

_lock = threading.Lock()
_lib = None
_tried = False
# why `get_lib` returned None: the compiler's or the loader's message
build_error = None


def _compile_and_load(src, stem):
    """Compile ``src`` (if needed) and CDLL it.

    The binary's name is keyed on a content hash of the source and the
    flags: a fresh checkout (where mtimes are meaningless) always rebuilds
    for ITS source and ITS machine — binaries are never shipped (they are
    built -march=native). g++ writes to a temp file that is atomically
    renamed into place, so concurrent builds (pytest-xdist workers, a test
    plus a script) never CDLL a partially-written ELF."""
    with open(src, "rb") as f:
        h = hashlib.sha256(f.read() + " ".join(_FLAGS).encode())
    path = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *_FLAGS, "-o", tmp, src],
                           check=True, capture_output=True)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return ctypes.CDLL(path)


def get_lib():
    """Load (building if necessary) the native library; None if unavailable."""
    global _lib, _tried, build_error
    if _lib is not None or _tried:
        return _lib
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        try:
            lib = _compile_and_load(_SRC, "ingest")
            lib.rfm_unique_sorted.restype = ctypes.c_int64
            lib.rfm_unique_sorted.argtypes = [
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.rfm_map_ids_regime.restype = ctypes.c_int32
            lib.rfm_map_ids_regime.argtypes = [ctypes.c_int64] * 4
            lib.rfm_map_ids.restype = None
            lib.rfm_map_ids.argtypes = [
                ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p]
            lib.rfm_build_csr.restype = ctypes.c_int64
            lib.rfm_build_csr.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                ctypes.c_int32, ctypes.c_void_p, ctypes.c_void_p]
            lib.rfm_hash_pairs.restype = ctypes.c_uint64
            lib.rfm_hash_pairs.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
            lib.rfm_ingest.restype = ctypes.c_int64
            lib.rfm_ingest.argtypes = [
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # u_raw, i_raw, n
                ctypes.c_void_p, ctypes.c_int64,                    # uids, nu
                ctypes.c_void_p, ctypes.c_int64,                    # iids, ni
                ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,   # prev csr
                ctypes.c_void_p, ctypes.c_void_p,                   # pairs, keep
                ctypes.c_void_p, ctypes.c_void_p,                   # offsets, items
                ctypes.c_void_p]                                    # n_kept
            _lib = lib
        except Exception as e:
            _lib = None
            build_error = (e.stderr.decode(errors="replace")
                           if isinstance(e, subprocess.CalledProcessError)
                           else repr(e))
    return _lib


def _ptr(a):
    return a.ctypes.data_as(ctypes.c_void_p)


def unique_sorted(ids):
    """native sorted-unique for int64 id columns; None if native unavailable.
    The library's counterpart of `np.unique`, held against it by the tests;
    `utils.data.build_index` calls `np.unique`, which is faster."""
    lib = get_lib()
    if lib is None:
        return None
    ids = np.ascontiguousarray(ids, dtype=np.int64)
    out = np.empty_like(ids)
    m = lib.rfm_unique_sorted(_ptr(ids), len(ids), _ptr(out))
    return out[:m].copy()


def map_ids_regime(n, sorted_unique):
    """Which lookup `map_ids` takes for ``n`` raw ids against this
    vocabulary: one of `MAP_REGIMES`; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    if len(sorted_unique) == 0:
        return "bsearch"
    return MAP_REGIMES[lib.rfm_map_ids_regime(
        n, len(sorted_unique), int(sorted_unique[0]), int(sorted_unique[-1]))]


def map_ids(raw, sorted_unique):
    """native id -> dense index mapping (-1 for unknown); None if unavailable"""
    lib = get_lib()
    if lib is None:
        return None
    raw = np.ascontiguousarray(raw, dtype=np.int64)
    su = np.ascontiguousarray(sorted_unique, dtype=np.int64)
    out = np.empty(len(raw), dtype=np.int32)
    lib.rfm_map_ids(_ptr(raw), len(raw), _ptr(su), len(su), _ptr(out))
    return out


def hash_pairs(u_raw, i_raw):
    """64-bit content hash of the raw id columns; None if native unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    u_raw = np.ascontiguousarray(u_raw, dtype=np.int64)
    i_raw = np.ascontiguousarray(i_raw, dtype=np.int64)
    return int(lib.rfm_hash_pairs(_ptr(u_raw), _ptr(i_raw), len(u_raw)))


def ingest(u_raw, i_raw, uids, iids, prev_csr=None):
    """One-pass map+filter+CSR(+union) ingest; None if native unavailable.

    Returns ``(pairs int32 [kept,2], keep bool [n], offsets int32 [nu+1],
    flat_items int32 [nnz])``.
    """
    lib = get_lib()
    if lib is None:
        return None
    u_raw = np.ascontiguousarray(u_raw, dtype=np.int64)
    i_raw = np.ascontiguousarray(i_raw, dtype=np.int64)
    uids = np.ascontiguousarray(uids, dtype=np.int64)
    iids = np.ascontiguousarray(iids, dtype=np.int64)
    n, nu = len(u_raw), len(uids)
    pairs = np.empty((max(n, 1), 2), dtype=np.int32)
    keep = np.empty(max(n, 1), dtype=np.uint8)
    offsets = np.empty(nu + 1, dtype=np.int32)
    if prev_csr is not None:
        prev_off = np.ascontiguousarray(prev_csr[0], dtype=np.int32)
        prev_items = np.ascontiguousarray(prev_csr[1], dtype=np.int32)
        prev_nnz = len(prev_items)
        po, pi = _ptr(prev_off), _ptr(prev_items)
    else:
        prev_nnz = 0
        po = pi = None
    items = np.empty(max(n + prev_nnz, 1), dtype=np.int32)
    n_kept = np.zeros(1, dtype=np.int64)
    nnz = lib.rfm_ingest(_ptr(u_raw), _ptr(i_raw), n,
                         _ptr(uids), nu, _ptr(iids), len(iids),
                         po, pi, prev_nnz,
                         _ptr(pairs), _ptr(keep), _ptr(offsets), _ptr(items),
                         _ptr(n_kept))
    kept = int(n_kept[0])
    return (pairs[:kept].copy(), keep[:n].astype(bool), offsets,
            items[:nnz].copy())


def build_csr(users, items, num_users):
    """native CSR user-history build; None if unavailable"""
    lib = get_lib()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, dtype=np.int32)
    items = np.ascontiguousarray(items, dtype=np.int32)
    offsets = np.empty(num_users + 1, dtype=np.int32)
    flat = np.empty(max(len(items), 1), dtype=np.int32)
    nnz = lib.rfm_build_csr(_ptr(users), _ptr(items), len(users),
                            num_users, _ptr(offsets), _ptr(flat))
    return offsets, flat[:nnz].copy()
