"""`ImplicitALS` of the port (`rankfm_tpu_torch.baselines`, on the CPU)
against the JAX package's on the same log and seed, and the contract cases
of `tests/test_baselines.py`.
"""

import numpy as np
import pandas as pd
import pytest
import torch

from rankfm_tpu.baselines import ImplicitALS as JaxALS
from rankfm_tpu import baselines as jbase
from rankfm_tpu_torch import baselines as tbase
from rankfm_tpu_torch import evaluation
from rankfm_tpu_torch.baselines import ImplicitALS

from torch_common import one_torch_thread, rel_err  # noqa: F401


def _two_group_data(rng, n_users=120, n_items=80, per_user=14, repeat=False):
    rows = []
    for u in range(n_users):
        g = u % 2
        pool = np.arange(g * n_items // 2, (g + 1) * n_items // 2)
        rows.append(np.stack(
            [np.full(per_user, u), rng.choice(pool, per_user, repeat)], 1))
    arr = np.concatenate(rows)
    mask = rng.random(len(arr)) < 0.75
    return arr[mask], arr[~mask]


@pytest.mark.parametrize("repeat", [False, True], ids=["distinct", "counts"])
def test_als_matches_the_jax_package(repeat):
    """Same log (with repeated pairs: confidences above 1 + alpha), same
    seed, 3 sweeps: factors within rel 1e-3 (f32 solves in another order),
    equal top-10 lists wherever the 10th and 11th scores are 1e-4 apart."""
    rng = np.random.default_rng(0)
    train, _ = _two_group_data(rng, repeat=repeat)
    train = train + np.array([1000, 50])              # offset raw ids
    kw = dict(factors=16, regularization=0.05, alpha=20.0, iterations=3,
              seed=3)
    want = JaxALS(**kw).fit(train)
    got = ImplicitALS(**kw, device="cpu").fit(train)
    assert got.user_factors.dtype == np.float32
    assert rel_err(got.user_factors, want.user_factors) < 1e-3
    assert rel_err(got.item_factors, want.item_factors) < 1e-3
    # `epochs` overrides `iterations`, as in the JAX package
    again = ImplicitALS(**dict(kw, iterations=9), device="cpu").fit(
        train, epochs=3)
    np.testing.assert_array_equal(again.user_factors, got.user_factors)

    users = np.unique(train[:, 0])
    for fp in (False, True):
        rj = want.recommend(users, n_items=10, filter_previous=fp)
        rt = got.recommend(users, n_items=10, filter_previous=fp)
        assert rt.shape == rj.shape and list(rt.index) == list(rj.index)
        scores = want.user_factors @ want.item_factors.T
        if fp:
            for r in range(len(users)):
                a, b = want._ui_offsets[r], want._ui_offsets[r + 1]
                scores[r, want._ui_items[a:b]] = -np.inf
        top = -np.sort(-scores, axis=1)[:, :11]
        clear = np.min(-np.diff(top, axis=1), axis=1) > 1e-4
        assert clear.mean() > 0.5
        pd.testing.assert_frame_equal(rt[clear], rj[clear])


def test_solve_chunk_and_helpers_match_the_jax_package():
    rng = np.random.default_rng(4)
    U, I, F = 37, 23, 6
    lens = rng.integers(0, 9, U)
    offsets = np.concatenate([[0], np.cumsum(lens)]).astype(np.int32)
    items = np.concatenate([np.sort(rng.choice(I, n, False)) for n in lens]
                           ).astype(np.int32)
    conf = (1 + 20 * rng.integers(1, 4, len(items))).astype(np.float32)
    for got, want in zip(tbase._csr_transpose(offsets, items, conf, I),
                         jbase._csr_transpose(offsets, items, conf, I)):
        np.testing.assert_array_equal(got, want)
    Y = rng.normal(0, 0.1, (I, F)).astype(np.float32)
    reg = (Y.T @ Y + 0.05 * np.eye(F)).astype(np.float32)
    t_chunks = tbase._pad_chunks(offsets, items, conf, U, "cpu", B=16)
    j_chunks = jbase._pad_chunks(offsets, items, conf, U, B=16)
    assert len(t_chunks) == len(j_chunks) == 3
    for (ti, tc), (ji, jc) in zip(t_chunks, j_chunks):
        L = ti.shape[1]                               # no power-of-two pad
        assert L <= ji.shape[1]
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji)[:, :L])
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc)[:, :L])
        got = tbase._solve_chunk(torch.from_numpy(Y), torch.from_numpy(reg),
                                 ti, tc).numpy()
        want = np.asarray(jbase._solve_chunk(Y, reg, ji, jc))
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-5)


def test_als_learns_planted_structure_and_eval_contract():
    rng = np.random.default_rng(0)
    train, test = _two_group_data(rng)
    als = ImplicitALS(factors=16, regularization=0.05, alpha=20.0,
                      iterations=8, seed=3, device="cpu")
    als.fit(train)
    # the evaluation module works on the baseline unchanged. Pointwise ALS
    # ranks SEEN items first, so generalization is measured with
    # filter_previous=True.
    mets = evaluation.compute(als, test, k=10, filter_previous=True)
    # per-user filtered popularity baseline on the same split
    pop_order = pd.Series(train[:, 1]).value_counts().index.to_numpy()
    df = pd.DataFrame(train, columns=["u", "i"])
    seen = df.groupby("u")["i"].apply(set)
    test_sets = pd.DataFrame(test, columns=["u", "i"]).groupby("u")["i"] \
        .apply(set)
    hits = []
    for u, wants in test_sets.items():
        top = [it for it in pop_order if it not in seen.get(u, set())][:10]
        hits.append(len(set(top) & wants) > 0)
    pop_hr = float(np.mean(hits))
    assert mets["hit_rate"] > pop_hr, (mets, pop_hr)
    assert 0 < mets["recall"] <= 1


def test_als_recommend_contract_cold_start_and_filter():
    rng = np.random.default_rng(1)
    train, _ = _two_group_data(rng)
    als = ImplicitALS(factors=8, iterations=4, device="cpu").fit(train)
    users = [0, 1, 10_000]  # last one unseen
    recs = als.recommend(users, n_items=5, cold_start="nan")
    assert recs.shape == (3, 5)
    assert recs.loc[10_000].isna().all()
    dropped = als.recommend(users, n_items=5, cold_start="drop")
    assert list(dropped.index) == [0, 1]
    # filter_previous removes every training item of the user
    f = als.recommend([0], n_items=10, filter_previous=True)
    seen = set(train[train[:, 0] == 0][:, 1])
    got = set(int(x) for x in f.loc[0].dropna().values)
    assert not (got & seen)
    # a user who has seen all but 2 items: NaN for the exhausted slots
    full = np.array([[0, i] for i in range(8)] + [[1, 8], [1, 9]])
    row = ImplicitALS(factors=2, iterations=2, device="cpu").fit(full) \
        .recommend([0], n_items=5, filter_previous=True).loc[0]
    assert set(row.dropna()) == {8, 9} and row.isna().sum() == 3
    with pytest.raises(ValueError, match="cold_start"):
        als.recommend(users, cold_start="bogus")
    with pytest.raises(AssertionError, match="fit the model first"):
        ImplicitALS(device="cpu").recommend(users)


def test_als_runs_on_the_card_by_default():
    assert ImplicitALS().device == torch.device("cuda")
    assert ImplicitALS(device="cpu").device == torch.device("cpu")
