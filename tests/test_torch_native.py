"""The port's native C++ data pipeline (`rankfm_tpu_torch.native`): the cases
of `tests/test_native.py` against the port's copy, each also against
`rankfm_tpu.native` on the same input (exact: ints and bools); the byte cap
on `rfm_map_ids`' range table; and the native against the numpy / pandas
paths of `rankfm_tpu_torch.utils.data` (exact, dtype included).
"""

import numpy as np
import pandas as pd
import pytest

from rankfm_tpu import native as jnative
from rankfm_tpu_torch import native as tnative
from rankfm_tpu_torch.ops._build import BUILD_DIR
from rankfm_tpu_torch.utils import data as tdata


@pytest.fixture(scope="module")
def lib():
    lib = tnative.get_lib()
    if lib is None or jnative.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    return lib


def _searchsorted_oracle(raw, su):
    pos = np.minimum(np.searchsorted(su, raw), len(su) - 1)
    return np.where(su[pos] == raw, pos, -1).astype(np.int32)


def test_library_is_built_under_the_build_dir(lib):
    assert BUILD_DIR.name == "_build"
    assert str(BUILD_DIR) in lib._name
    assert not list(BUILD_DIR.parent.glob("native/*.so"))


def test_unique_sorted(lib):
    rng = np.random.default_rng(0)
    ids = rng.integers(-10**12, 10**12, 10000)
    got = tnative.unique_sorted(ids)
    np.testing.assert_array_equal(got, np.unique(ids))
    want = jnative.unique_sorted(ids)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_map_ids(lib):
    rng = np.random.default_rng(1)
    uniq = np.unique(rng.integers(0, 10**9, 500))
    raw = np.concatenate([rng.choice(uniq, 2000), rng.integers(10**10, 10**11, 50)])
    rng.shuffle(raw)
    got = tnative.map_ids(raw, uniq)
    want = pd.Series(raw).map(pd.Series(np.arange(len(uniq)), index=uniq)).fillna(-1).values
    np.testing.assert_array_equal(got, want.astype(np.int32))
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, jnative.map_ids(raw, uniq))


def _regime_cases():
    rng = np.random.default_rng(7)
    su2 = np.unique(rng.integers(-2**62, 2**62, 5000).astype(np.int64))
    lo, hi = np.iinfo(np.int64).min, np.iinfo(np.int64).max
    return {
        # dense range (span == m): the table path
        "table": (np.arange(100, 100 + 5000, dtype=np.int64),
                  np.concatenate([rng.integers(0, 6000, 20000),
                                  np.array([-5, 99, 100, 5099, 5100])]
                                 ).astype(np.int64)),
        # sparse 64-bit ids (span >> 8m): the hash path
        "hash": (su2, np.concatenate([rng.choice(su2, 20000),
                                      rng.integers(-2**62, 2**62, 5000)]
                                     ).astype(np.int64)),
        # single-id vocabulary
        "single": (np.array([42], dtype=np.int64),
                   np.array([41, 42, 43], dtype=np.int64)),
        # tiny query against a big vocabulary (n*8 < m): binary search
        "bsearch": (su2, np.concatenate([rng.choice(su2, 10),
                                         [int(su2[0]) - 1]]).astype(np.int64)),
        # a vocabulary spanning (almost) the whole int64 range: hi - lo
        # overflows signed arithmetic; must take the hash, not a wrapped table
        "full-range": (np.array([lo, -7, 0, 123, hi], dtype=np.int64),
                       np.array([lo, hi, 0, 122, 123, -7, 55], dtype=np.int64)),
    }


@pytest.mark.parametrize("case", ["table", "hash", "single", "bsearch",
                                  "full-range"])
def test_map_ids_lookup_regimes(lib, case):
    """The range table, the hash and the binary search each reproduce the
    searchsorted oracle, unknowns below / above / inside the range and
    negative raw ids included, and equal the JAX package's library."""
    su, raw = _regime_cases()[case]
    want_regime = {"single": "table", "full-range": "hash"}.get(case, case)
    assert tnative.map_ids_regime(len(raw), su) == want_regime
    got = tnative.map_ids(raw, su)
    np.testing.assert_array_equal(got, _searchsorted_oracle(raw, su))
    np.testing.assert_array_equal(got, jnative.map_ids(raw, su))
    if case == "full-range":
        np.testing.assert_array_equal(got, [0, 4, 2, -1, 3, 1, -1])


def test_map_ids_range_table_has_a_byte_cap(lib):
    """A near-contiguous vocabulary (span <= 8 m) whose table would be one
    slot over 64 MiB takes the hash; one slot under takes the table; both
    give the oracle's and the uncapped library's output."""
    cap_slots = (64 << 20) // 4
    m = cap_slots // 8 + 1
    su_over = np.arange(m, dtype=np.int64) * 8 + 5      # span = cap + 1
    su_under = su_over[:-1]                             # span = cap - 7
    assert int(su_over[-1] - su_over[0]) + 1 == cap_slots + 1
    rng = np.random.default_rng(3)
    raw = np.concatenate([rng.integers(-100, 8 * m + 100, 300_000),
                          su_over[-3:], su_over[:3]]).astype(np.int64)
    assert tnative.map_ids_regime(len(raw), su_over) == "hash"
    assert tnative.map_ids_regime(len(raw), su_under) == "table"
    for su in (su_over, su_under):
        got = tnative.map_ids(raw, su)
        np.testing.assert_array_equal(got, _searchsorted_oracle(raw, su))
        np.testing.assert_array_equal(got, jnative.map_ids(raw, su))


def test_build_csr_matches_numpy(lib):
    rng = np.random.default_rng(2)
    U = 50
    pairs = np.stack([rng.integers(0, U, 3000), rng.integers(0, 200, 3000)], 1).astype(np.int32)
    got_off, got_items = tnative.build_csr(pairs[:, 0], pairs[:, 1], U)

    uniq = np.unique(pairs, axis=0)
    counts = np.bincount(uniq[:, 0], minlength=U)
    want_off = np.zeros(U + 1, np.int32)
    want_off[1:] = np.cumsum(counts)
    np.testing.assert_array_equal(got_off, want_off)
    np.testing.assert_array_equal(got_items, uniq[:, 1].astype(np.int32))
    j_off, j_items = jnative.build_csr(pairs[:, 0], pairs[:, 1], U)
    np.testing.assert_array_equal(got_off, j_off)
    np.testing.assert_array_equal(got_items, j_items)


def test_data_pipeline_native_vs_pandas_end_to_end(lib):
    """map_interactions + build_user_items_csr agree between paths"""
    rng = np.random.default_rng(3)
    raw_u = rng.choice(np.arange(100, 200), 5000)
    raw_i = rng.choice(np.arange(9000, 9100), 5000)
    inter = np.stack([raw_u, raw_i], 1)
    _, u2i = tdata.build_index(inter[:, 0])
    _, i2i = tdata.build_index(inter[:, 1])

    pairs_native, keep_native = tdata.map_interactions(inter, u2i, i2i)

    # force the pandas path by casting ids to object strings
    inter_str = inter.astype(str).astype(object)
    _, u2i_s = tdata.build_index(inter_str[:, 0])
    _, i2i_s = tdata.build_index(inter_str[:, 1])
    pairs_pd, keep_pd = tdata.map_interactions(inter_str, u2i_s, i2i_s)

    # string sort order over equal-length numeric strings == numeric order here
    np.testing.assert_array_equal(pairs_native, pairs_pd)
    np.testing.assert_array_equal(keep_native, keep_pd)


def test_ingest_vocabulary_containing_int64_min(lib):
    """The hash marks empty slots by value -1, not by the key INT64_MIN, so
    a vocabulary CONTAINING that id maps correctly through the full native
    ingest."""
    lo = np.iinfo(np.int64).min
    u = np.array([lo, lo, 5, 5, 9], dtype=np.int64)
    i = np.array([1, 2, 1, 3, 2], dtype=np.int64)
    uids, iids = np.unique(u), np.unique(i)
    pairs, keep, offsets, items = tnative.ingest(u, i, uids, iids)
    assert keep.all()
    want = [[0, 0], [0, 1], [1, 0], [1, 2], [2, 1]]
    np.testing.assert_array_equal(pairs, want)
    # CSR row for user INT64_MIN (index 0) holds items {0, 1}
    assert list(items[offsets[0]:offsets[1]]) == [0, 1]
    for got, ref in zip((pairs, keep, offsets, items),
                        jnative.ingest(u, i, uids, iids)):
        assert got.dtype == ref.dtype
        np.testing.assert_array_equal(got, ref)


def test_ingest_with_previous_csr_and_hash_equal_the_jax_library(lib):
    """`rfm_ingest` with unknown ids, repeated pairs and a previous CSR to
    union, and `rfm_hash_pairs`, against `rankfm_tpu.native`."""
    rng = np.random.default_rng(5)
    uids = np.unique(rng.integers(0, 10**6, 300))
    iids = np.unique(rng.integers(-10**9, 10**9, 500))
    first = (rng.choice(uids, 4000), rng.choice(iids, 4000))
    prev = tnative.ingest(*first, uids, iids)[2:]
    u = np.concatenate([rng.choice(uids, 3000), rng.integers(2 * 10**6, 3 * 10**6, 200)])
    i = np.concatenate([rng.choice(iids, 3100), rng.integers(2 * 10**9, 3 * 10**9, 100)])
    got = tnative.ingest(u, i, uids, iids, prev)
    want = jnative.ingest(u, i, uids, iids, prev)
    assert 0 < got[1].sum() < len(u)
    assert len(got[3]) > len(prev[1])
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert tnative.hash_pairs(u, i) == jnative.hash_pairs(u, i)
    assert tnative.hash_pairs(u, i) != tnative.hash_pairs(i, u)


def test_uint64_ids_above_int63_do_not_wrap():
    """uint64 vocabularies with values >= 2^63 must NOT take the int64
    native path (they would wrap negative and corrupt the sorted order) —
    build_index must fall back and sort them correctly"""
    big = np.uint64(2**63 + 7)
    ids = np.array([big, np.uint64(5), big, np.uint64(9)], dtype=np.uint64)
    assert tdata._int64_view(ids) is None
    vocab, to_index = tdata.build_index(ids)
    assert list(vocab.values) == [np.uint64(5), np.uint64(9), big]
    assert int(to_index.loc[big]) == 2


def test_uint64_ids_small_range_take_native_path():
    ids = np.array([3, 1, 2], dtype=np.uint64)
    iv = tdata._int64_view(ids)
    assert iv is not None and iv.dtype == np.int64


def _same(a, b):
    assert type(a) is type(b)
    if isinstance(a, pd.Series):
        pd.testing.assert_series_equal(a, b)
    else:
        assert a.dtype == b.dtype, (a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fn", ["build_index", "map_interactions",
                                "map_ids_float", "build_user_items_csr"])
@pytest.mark.parametrize("id_dtype", [np.int32, np.int64, np.uint16])
def test_data_functions_native_equals_numpy_path(lib, monkeypatch, fn,
                                                 id_dtype):
    """Each of the `utils.data` functions with an integer fast path returns
    equal arrays (values, dtype, index) through the native library and,
    with the library taken away, through numpy / pandas. `build_index`
    has no native path in the port (numpy's sort is the faster one): it
    must not load the library, and equals the index made from the native
    `unique_sorted` as the JAX package makes it."""
    rng = np.random.default_rng(11)
    known = np.stack([rng.integers(100, 400, 6000),
                      rng.integers(1000, 1900, 6000)], 1).astype(id_dtype)
    mixed = np.concatenate([known[:2000], np.stack(
        [rng.integers(0, 600, 500), rng.integers(900, 2100, 500)], 1
    ).astype(id_dtype)])

    def run():
        ids_u, u2i = tdata.build_index(known[:, 0])
        ids_i, i2i = tdata.build_index(known[:, 1])
        if fn == "build_index":
            return [ids_u, u2i, ids_i, i2i]
        if fn == "map_interactions":
            return list(tdata.map_interactions(mixed, u2i, i2i))
        if fn == "map_ids_float":
            return [tdata.map_ids_float(mixed[:, 0], u2i),
                    tdata.map_ids_float(pd.Series(mixed[:, 1]).values, i2i)]
        pairs, _ = tdata.map_interactions(mixed, u2i, i2i)
        return list(tdata.build_user_items_csr(pairs, len(ids_u)))

    calls = []
    real = tnative.get_lib
    monkeypatch.setattr(tnative, "get_lib",
                        lambda: calls.append(1) or real())
    with_native = run()
    if fn == "build_index":
        assert not calls, "build_index went through the native library"
        with_native = []
        for col in (known[:, 0], known[:, 1]):
            ids = pd.Series(tnative.unique_sorted(
                col.astype(np.int64)).astype(id_dtype, copy=False))
            with_native += [ids, pd.Series(data=ids.index, index=ids.values)]
    else:
        assert calls, "the native path was not taken"
    monkeypatch.setattr(tnative, "get_lib", lambda: None)
    without = run()
    assert len(with_native) == len(without)
    for a, b in zip(with_native, without):
        _same(a, b)
