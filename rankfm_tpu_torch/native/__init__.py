"""ctypes bindings for the native host-side data pipeline (``ingest.cpp``)
and the sequential SGD oracle (``oracle.cpp``), the port's copy of
`rankfm_tpu/native/__init__.py`.

Each library is compiled with g++ at first use, from its source beside this
file and nothing else, into ``rankfm_tpu_torch/_build/`` (where the CUDA
kernels' libraries go too). All ingest entry points have pure-numpy
fallbacks in `rankfm_tpu_torch.utils.data`: without a toolchain `get_lib`
returns None, every ingest function here returns None and the callers take
the numpy / pandas path, which gives the same arrays. That is a convenience
of the host code; nothing on a device depends on it. The oracle is test and
validation infrastructure (`tests/torch_parity_common.py`,
`chip_smoke.py`); no training path calls it. The normal walk
(``normal_walk.cpp``) is the host half of the card's initial draws
(`rankfm_tpu_torch.ops.init`), built with ``-ffp-contract=off`` so that its
multiplies and adds round apart, as numpy's do; without it the card's draw
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading

import numpy as np

from rankfm_tpu_torch.ops._build import BUILD_DIR

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "ingest.cpp")
_ORACLE_SRC = os.path.join(_HERE, "oracle.cpp")
_WALK_SRC = os.path.join(_HERE, "normal_walk.cpp")
_ZIGGURAT_H = os.path.join(os.path.dirname(_HERE), "csrc", "ziggurat.h")
_FLAGS = ("-O3", "-march=native", "-shared", "-fPIC", "-std=c++17")
_WALK_FLAGS = _FLAGS + ("-ffp-contract=off",)

MAP_REGIMES = ("bsearch", "table", "hash")   # `rfm_map_ids_regime`'s codes

_lock = threading.Lock()
_lib = None
_tried = False
# why `get_lib` returned None: the compiler's or the loader's message
build_error = None


def _compile_and_load(src, stem, flags=_FLAGS, deps=()):
    """Compile ``src`` (if needed) and CDLL it.

    The binary's name is keyed on a content hash of the source, the headers
    it includes (``deps``) and the flags: a fresh checkout (where mtimes are
    meaningless) always rebuilds for ITS source and ITS machine — binaries
    are never shipped (they are built -march=native). g++ writes to a temp
    file that is atomically renamed into place, so concurrent builds
    (pytest-xdist workers, a test plus a script) never CDLL a
    partially-written ELF."""
    h = hashlib.sha256()
    for path in (src, *deps):
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(flags).encode())
    path = os.path.join(BUILD_DIR, f"{stem}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{path}.{os.getpid()}.tmp"
        try:
            subprocess.run(["g++", *flags, "-o", tmp, src],
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
        # only now: a caller that sees it outside the lock must also see
        # the attempt's result
        _tried = True
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


_oracle_lock = threading.Lock()
_oracle_lib = None
_oracle_tried = False
# why `get_oracle` returned None: the compiler's or the loader's message
oracle_build_error = None


def get_oracle():
    """Load (building if necessary) the sequential reference-semantics SGD
    oracle (oracle.cpp); None if no toolchain, with the reason in
    ``oracle_build_error``. Test/validation infrastructure — no training
    path calls this."""
    global _oracle_lib, _oracle_tried, oracle_build_error
    if _oracle_lib is not None or _oracle_tried:
        return _oracle_lib
    with _oracle_lock:
        if _oracle_lib is not None or _oracle_tried:
            return _oracle_lib
        try:
            lib = _compile_and_load(_ORACLE_SRC, "oracle")
            lib.rfm_oracle_fit.restype = ctypes.c_int32
            lib.rfm_oracle_fit.argtypes = (
                [ctypes.c_void_p] * 2 + [ctypes.c_int64]
                + [ctypes.c_void_p] * 10
                + [ctypes.c_int32] * 5
                + [ctypes.c_float, ctypes.c_float, ctypes.c_float,
                   ctypes.c_int32, ctypes.c_float,
                   ctypes.c_int32, ctypes.c_int32, ctypes.c_uint64]
                + [ctypes.c_void_p])
            _oracle_lib = lib
        except Exception as e:
            _oracle_lib = None
            oracle_build_error = (e.stderr.decode(errors="replace")
                                  if isinstance(e, subprocess.CalledProcessError)
                                  else repr(e))
        _oracle_tried = True      # after the result, as in `get_lib`
    return _oracle_lib


def oracle_fit(interactions, sample_weight, offsets, items, x_uf, x_if,
               weights, alpha, beta, learning_rate, learning_schedule,
               learning_exponent, max_samples, epochs, seed):
    """Run the sequential reference-semantics SGD oracle.

    Every argument is a numpy array or a Python scalar: a caller holding
    tensors passes ``t.cpu().numpy()``. ``weights`` is the
    {w_i,w_if,v_u,v_i,v_uf,v_if} dict of INITIAL arrays (not mutated).
    Returns ``(weights_out, ll_per_epoch)`` or None if the native oracle is
    unavailable. The call releases the GIL while the oracle trains, so
    several fits can run at once on threads.
    """
    lib = get_oracle()
    if lib is None:
        return None
    inter = np.ascontiguousarray(interactions, dtype=np.int32)
    sw = np.ascontiguousarray(sample_weight, dtype=np.float32)
    off = np.ascontiguousarray(offsets, dtype=np.int32)
    itm = np.ascontiguousarray(items, dtype=np.int32)
    xu = np.ascontiguousarray(x_uf, dtype=np.float32)
    xi = np.ascontiguousarray(x_if, dtype=np.float32)
    w = {k: np.array(weights[k], dtype=np.float32, order="C")
         for k in ("w_i", "w_if", "v_u", "v_i", "v_uf", "v_if")}
    U, F = w["v_u"].shape
    I = w["v_i"].shape[0]
    P, Q = xu.shape[1], xi.shape[1]
    # the library indexes every array by these sizes, unchecked
    if (inter.ndim != 2 or inter.shape[1] != 2 or sw.shape != (len(inter),)
            or off.shape != (U + 1,) or xu.shape[0] != U or xi.shape[0] != I
            or w["w_i"].shape != (I,) or w["w_if"].shape != (Q,)
            or w["v_i"].shape[1] != F or w["v_uf"].shape != (P, F)
            or w["v_if"].shape != (Q, F) or len(itm) < off[-1]):
        raise ValueError("oracle_fit: inconsistent shapes")
    ll = np.zeros(epochs, dtype=np.float32)
    rc = lib.rfm_oracle_fit(
        _ptr(inter), _ptr(sw), len(inter), _ptr(off), _ptr(itm),
        _ptr(xu), _ptr(xi),
        _ptr(w["w_i"]), _ptr(w["w_if"]), _ptr(w["v_u"]), _ptr(w["v_i"]),
        _ptr(w["v_uf"]), _ptr(w["v_if"]),
        U, I, P, Q, F,
        alpha, beta, learning_rate,
        1 if learning_schedule == "invscaling" else 0, learning_exponent,
        max_samples, epochs, seed, _ptr(ll))
    if rc != 0:
        raise FloatingPointError("oracle: weights went non-finite")
    return w, ll


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


_walk_lock = threading.Lock()
_walk_lib = None


def get_walk():
    """Load (building if necessary) the normal walk (normal_walk.cpp);
    raises RuntimeError with the compiler's message if it cannot."""
    global _walk_lib
    if _walk_lib is not None:
        return _walk_lib
    with _walk_lock:
        if _walk_lib is not None:
            return _walk_lib
        try:
            lib = _compile_and_load(_WALK_SRC, "normal_walk", _WALK_FLAGS,
                                    (_ZIGGURAT_H,))
        except (OSError, subprocess.CalledProcessError) as e:
            why = (e.stderr.decode(errors="replace")
                   if isinstance(e, subprocess.CalledProcessError) else repr(e))
            raise RuntimeError(f"native normal walk unavailable: {why}") from e
        lib.rfm_ziggurat_tables.restype = None
        lib.rfm_ziggurat_tables.argtypes = [ctypes.c_void_p] * 3
        lib.rfm_normal_walk.restype = None
        lib.rfm_normal_walk.argtypes = (
            [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
             ctypes.c_int64, ctypes.c_int64, ctypes.c_double]
            + [ctypes.c_uint64] * 4 + [ctypes.c_int64]
            + [ctypes.c_void_p] * 4)
        _walk_lib = lib
    return _walk_lib


def ziggurat_tables():
    """numpy's ziggurat tables ``(ki uint64, wi float64, fi float64)``, 256
    entries each, as the walk and the card hold them."""
    ki = np.empty(256, dtype=np.uint64)
    wi = np.empty(256, dtype=np.float64)
    fi = np.empty(256, dtype=np.float64)
    get_walk().rfm_ziggurat_tables(_ptr(ki), _ptr(wi), _ptr(fi))
    return ki, wi, fi


def normal_walk(rec, mask, n_pos, n_draws, sigma, state, inc, seg_words):
    """Resolve, in stream order, the positions one word does not decide
    (``rec`` int64 ``[m, 4]``: position and its three words) among the first
    ``n_pos`` of the PCG64 stream ``(state, inc)``; ``mask`` (uint32, the
    one-word bits) becomes the emit mask in place.

    Returns ``(base, idx, val, stats)``: the emits before each segment of
    ``seg_words`` mask words (int64), the rank and float32 value of each
    emit resolved here, and a dict ``emitted`` (emits in the ``n_pos``
    positions, at most ``n_draws``), ``done`` (``n_draws`` reached),
    ``words`` (words consumed when done, else the first position no attempt
    has read), ``wedge`` and ``tail`` (attempts resolved here).
    """
    lib = get_walk()
    rec = np.ascontiguousarray(rec, dtype=np.int64)
    m = rec.shape[0]
    nw = (n_pos + 31) // 32
    # the library indexes both by these sizes, unchecked
    if (rec.shape != (m, 4) or mask.dtype != np.uint32 or mask.shape != (nw,)
            or not (mask.flags.c_contiguous and mask.flags.writeable)
            or seg_words < 1):
        raise ValueError("normal_walk: inconsistent shapes")
    base = np.empty(max(-(-nw // seg_words), 1), dtype=np.int64)
    idx = np.empty(max(m, 1), dtype=np.int64)
    val = np.empty(max(m, 1), dtype=np.float32)
    stats = np.zeros(6, dtype=np.int64)
    mask64 = (1 << 64) - 1
    lib.rfm_normal_walk(_ptr(rec), m, _ptr(mask), n_pos, n_draws, sigma,
                        state >> 64, state & mask64, inc >> 64, inc & mask64,
                        seg_words, _ptr(base), _ptr(idx), _ptr(val),
                        _ptr(stats))
    n = int(stats[0])
    return base, idx[:n], val[:n], {
        "emitted": int(stats[1]), "words": int(stats[2]),
        "wedge": int(stats[3]), "tail": int(stats[4]),
        "done": bool(stats[5])}
