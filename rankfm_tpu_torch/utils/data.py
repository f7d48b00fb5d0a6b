"""Host-side data utilities: ingestion, id mapping, CSR user-history arrays.

A copy of `rankfm_tpu/utils/data.py` for the PyTorch port (the port never
imports `rankfm_tpu`, whose package import pulls in JAX). In
`map_interactions`, `map_ids_float` and `build_user_items_csr` integer id
columns (`_int64_view`) go through the C++ library of
`rankfm_tpu_torch.native` when it could be built; every other column, and
every call without a toolchain, takes the numpy / pandas path, which gives
the same arrays, dtype included. `build_index` is numpy's alone: its
vectorised sort is the faster one (see there).

* interactions become a dense ``int32 [N, 2]`` array of internal indices,
* per-user item histories become a CSR pair ``(offsets [U+1], flat_items [nnz])``
  with each row sorted ascending.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from rankfm_tpu_torch import native


def get_data(obj):
    """Extract the underlying ndarray from common pandas/numpy containers:
    DataFrame/Series -> ``.values``, ndarray passes through, anything else
    raises ``TypeError``.
    """
    if isinstance(obj, (pd.DataFrame, pd.Series)):
        return obj.values
    elif isinstance(obj, np.ndarray):
        return obj
    else:
        raise TypeError("input data must be in [pd.DataFrame, pd.Series, np.ndarray] format")


def _int64_view(values):
    """return an int64 ndarray view of an id column if losslessly possible"""
    arr = np.asarray(values)
    if arr.dtype.kind == "i" and arr.dtype.itemsize <= 8:
        return arr.astype(np.int64, copy=False)
    if arr.dtype.kind == "u":
        # uint64 values >= 2^63 would WRAP to negative int64, corrupting the
        # sorted-vocabulary order — only convert when the range fits
        if arr.dtype.itemsize < 8 or (arr.size and
                                      arr.max() <= np.iinfo(np.int64).max):
            return arr.astype(np.int64, copy=False)
    return None


def build_index(values):
    """Sorted-unique id array and an id -> zero-based-index pandas Series:
    ids are sorted ascending and assigned dense int indices.

    Always `np.unique`, also for integer ids: the JAX package sends those
    through `rfm_unique_sorted`, which sorts the whole column and took
    0.038-0.069 s for the two columns of 599,924 rows where `np.unique`
    took 0.008-0.013 s (NVIDIA H100 80GB HBM3 host, `chip_smoke.py` phase
    10). Both give equal arrays (`tests/test_torch_native.py`)."""
    ids = pd.Series(np.sort(np.unique(values)))
    to_index = pd.Series(data=ids.index, index=ids.values)
    return ids, to_index


def map_interactions(interactions, user_to_index, item_to_index):
    """Map raw (user_id, item_id) pairs to internal int32 indices.

    Pairs containing an unknown user or item are silently dropped.

    Returns ``(pairs int32 [N,2], keep_mask bool [N_in])`` where ``keep_mask``
    marks the surviving input rows (used to subset ``sample_weight``).
    """
    arr = get_data(interactions)
    u_raw, i_raw = _int64_view(arr[:, 0]), _int64_view(arr[:, 1])
    uid_int = _int64_view(user_to_index.index.values)
    iid_int = _int64_view(item_to_index.index.values)
    if u_raw is not None and i_raw is not None and uid_int is not None and iid_int is not None:
        u_idx = native.map_ids(u_raw, uid_int)
        i_idx = native.map_ids(i_raw, iid_int)
        if u_idx is not None and i_idx is not None:
            keep = (u_idx >= 0) & (i_idx >= 0)
            pairs = np.stack([u_idx[keep], i_idx[keep]], axis=1).astype(np.int32)
            return np.ascontiguousarray(pairs), keep
    u = pd.Series(arr[:, 0]).map(user_to_index).values.astype(np.float64)
    i = pd.Series(arr[:, 1]).map(item_to_index).values.astype(np.float64)
    keep = ~(np.isnan(u) | np.isnan(i))
    pairs = np.stack([u[keep], i[keep]], axis=1).astype(np.int32)
    return np.ascontiguousarray(pairs), keep


def map_ids_float(values, to_index):
    """Map raw ids to float64 internal indices with NaN for unknowns,
    through the native lookup for integer id columns."""
    iv = _int64_view(values)
    ti = _int64_view(to_index.index.values)
    if iv is not None and ti is not None:
        idx = native.map_ids(iv, ti)
        if idx is not None:
            out = idx.astype(np.float64)
            out[idx < 0] = np.nan
            return out
    return pd.Series(np.asarray(values)).map(to_index).values.astype(np.float64)


def remap_indices(index_values, idx_float):
    """Vectorized inverse mapping: float indices (NaN = unknown) -> original
    ids. With no NaN, integer vocabularies keep their exact dtype; with NaN,
    int/float ids come back float64 (what pandas ``.map`` produces) unless
    the ids exceed float64's 2^53 integer precision — those (and non-numeric
    ids) come back object so snowflake-scale int64 ids are never corrupted
    by a float round-trip."""
    flat = np.asarray(idx_float, dtype=np.float64)
    known = ~np.isnan(flat)
    safe = np.where(known, flat, 0.0).astype(np.int64)
    vals = np.asarray(index_values)
    if vals.dtype.kind in "iu" and known.all():
        return vals[safe].reshape(np.shape(idx_float))
    float_exact = (vals.dtype.kind == "f"
                   or (vals.dtype.kind in "iu" and vals.size
                       and np.abs(vals.astype(np.float64)).max() < 2.0**53)
                   or (vals.dtype.kind in "iu" and not vals.size))
    if float_exact:
        out = vals.astype(np.float64)[safe]
        out[~known] = np.nan
    else:
        out = vals[safe].astype(object)
        out[~known] = np.nan
    return out.reshape(np.shape(idx_float))


def build_user_items_csr(pairs, num_users):
    """Build a CSR view of the distinct, sorted item history of every user.

    ``pairs`` is ``int32 [N, 2]`` of (user_idx, item_idx). Duplicate (u, i)
    pairs are collapsed (histories are *sets*) and rows are sorted ascending.

    Returns ``(offsets int32 [U+1], flat_items int32 [nnz])``.
    """
    if len(pairs) == 0:
        return np.zeros(num_users + 1, dtype=np.int32), np.zeros(0, dtype=np.int32)
    res = native.build_csr(pairs[:, 0], pairs[:, 1], num_users)
    if res is not None:
        return res
    uniq = np.unique(pairs, axis=0)  # sorts by (u, i) and dedups
    users = uniq[:, 0]
    items = uniq[:, 1]
    counts = np.bincount(users, minlength=num_users).astype(np.int64)
    offsets = np.zeros(num_users + 1, dtype=np.int32)
    np.cumsum(counts, out=offsets[1:])
    return offsets, np.ascontiguousarray(items, dtype=np.int32)


def merge_user_items_csr(offsets_a, items_a, offsets_b, items_b, num_users):
    """Union two CSR user-history structures row-wise (``fit_partial``
    semantics)."""
    pairs = []
    for off, it in ((offsets_a, items_a), (offsets_b, items_b)):
        if len(it):
            counts = np.diff(off).astype(np.int64)
            users = np.repeat(np.arange(num_users, dtype=np.int32), counts)
            pairs.append(np.stack([users, it.astype(np.int32)], axis=1))
    if not pairs:
        return np.zeros(num_users + 1, dtype=np.int32), np.zeros(0, dtype=np.int32)
    return build_user_items_csr(np.concatenate(pairs, axis=0), num_users)


def csr_row_pairs(offsets, flat_items, rows):
    """``(row position, item)`` of every history entry of the CSR rows
    ``rows``: int32 arrays, the position counting within ``rows``."""
    starts = offsets[rows].astype(np.int64)
    lens = offsets[rows + 1].astype(np.int64) - starts
    total = int(lens.sum())
    if total == 0:
        return np.zeros(0, dtype=np.int32), np.zeros(0, dtype=np.int32)
    pos = np.repeat(np.arange(len(rows), dtype=np.int32), lens)
    cum = np.repeat(np.cumsum(lens) - lens, lens)
    cols = flat_items[np.repeat(starts, lens) + (np.arange(total) - cum)]
    return pos, cols.astype(np.int32)


def csr_to_dict(offsets, flat_items):
    """Expose the CSR history as a ``{user: sorted int32 array}`` dict."""
    out = {}
    for u in range(len(offsets) - 1):
        lo, hi = int(offsets[u]), int(offsets[u + 1])
        if hi > lo:
            out[u] = flat_items[lo:hi].copy()
    return out


def validate_features(features, to_index, idx, kind):
    """Coerce a feature frame to a float32 ``[n, d]`` matrix row-ordered by
    internal index: the first column is the id; the id set must exactly
    equal the interaction id set else ``KeyError``; string feature columns
    raise ``ValueError`` (via the float cast).
    """
    x = pd.DataFrame(features).copy()
    x = x.set_index(x.columns[0])
    x.index = x.index.map(to_index)
    if np.array_equal(sorted(x.index.values), idx):
        return np.ascontiguousarray(x.sort_index(), dtype=np.float32)
    raise KeyError(f"the {kind}s in [{kind}_features] do not match the {kind}s in [interactions]")
