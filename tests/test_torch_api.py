"""The API contract of `rankfm_tpu_torch.RankFM` on the CPU: the cases of
`tests/test_rankfm.py` with the same fixtures, each held against
`rankfm_tpu.RankFM` on the same inputs. A refusal must be the JAX package's
own (`_assert_same_error`: the same exception type and message from both
classes); what a fitted model serves and what `evaluation` computes must
equal the JAX package's on the same weights, carried across by a
checkpoint (`_jax_twin`). Only the determinism and PRNG-stream cases
compare the port with itself: the two packages draw from different
generators. The cases that name JAX internals (the epoch program's key)
are left out; the checkpoint cases are in `tests/test_torch_checkpoint.py`."""

import functools
import itertools
import re

import numpy as np
import pandas as pd
import pytest

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu import evaluation as jax_evaluation
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import evaluation
from rankfm_tpu_torch.ops import fused

from torch_common import one_torch_thread  # noqa: F401

RankFM = functools.partial(TorchRankFM, device="cpu")
_twins = itertools.count()


def _jax_twin(model, tmp_path):
    """The JAX package's model with the port model's weights and state."""
    path = str(tmp_path / f"twin{next(_twins)}")
    model.save(path)
    return JaxRankFM.load(path)


def _error_of(fn, *args):
    with pytest.raises(Exception) as info:
        fn(*args)
    return type(info.value), str(info.value)


def _assert_same_error(fn, port_arg=RankFM, jax_arg=JaxRankFM, error=None,
                       match=None):
    """``fn(port_arg)`` raises what ``fn(jax_arg)`` raises: the same type
    and message (and, where given, ``error`` and ``match``)."""
    got, want = _error_of(fn, port_arg), _error_of(fn, jax_arg)
    assert got == want
    if error is not None:
        assert got[0] is error
    if match is not None:
        assert re.search(match, got[1]), (match, got[1])

# ------------------------------
# fixtures (tiny 3-user x 6-item data)
# ------------------------------

intx_train_pd_int = pd.DataFrame([
    (1, 1), (1, 3), (1, 5),
    (2, 1), (2, 2), (2, 6),
    (3, 3), (3, 6), (3, 4)
], columns=['user_id', 'item_id'], dtype=np.int32)

intx_train_pd_str = pd.DataFrame([
    ('X', 'A'), ('X', 'C'), ('X', 'E'),
    ('Y', 'A'), ('Y', 'B'), ('Y', 'F'),
    ('Z', 'C'), ('Z', 'F'), ('Z', 'D')
], columns=['user_id', 'item_id'])

intx_train_np = np.array([
    (1, 1), (1, 3), (1, 5),
    (2, 1), (2, 2), (2, 6),
    (3, 3), (3, 6), (3, 4)
])

intx_train_pd_rating = pd.DataFrame([
    (1, 1, 5), (1, 3, 2), (1, 5, 3),
    (2, 1, 2), (2, 2, 1), (2, 6, 4),
    (3, 3, 3), (3, 6, 4), (3, 4, 5)
], columns=['user_id', 'item_id', 'rating'], dtype=np.int32)

intx_valid_disjoint = pd.DataFrame([
    (1, 1), (1, 3), (1, 5),
    (2, 1), (2, 2), (2, 7),
    (4, 3), (4, 7), (4, 4)
], columns=['user_id', 'item_id'], dtype=np.int32)

uf_pd_good = pd.DataFrame([
    (1, 0, 1, 5, 3.14),
    (2, 1, 0, 6, 2.72),
    (3, 0, 0, 4, 1.62)
], columns=['user_id', 'bin_1', 'bin_2', 'int', 'cnt'])

uf_np_good = np.array([
    (1, 0, 1, 5, 3.14),
    (2, 1, 0, 6, 2.72),
    (3, 0, 0, 4, 1.62)
])

uf_no_id = pd.DataFrame([
    (0, 1, 5, 3.14),
    (1, 0, 6, 2.72),
    (0, 0, 4, 1.62)
], columns=['bin_1', 'bin_2', 'int', 'cnt'])

uf_str_cols = pd.DataFrame([
    (1, 0, 1, "A", 3.14),
    (2, 1, 0, "B", 2.72),
    (3, 0, 0, "C", 1.62)
], columns=['user_id', 'bin_1', 'bin_2', 'str', 'cnt'])

if_pd_good = pd.DataFrame([
    (1, 0, 1, 5, 3.14),
    (2, 1, 0, 6, 2.72),
    (3, 0, 0, 4, 1.62),
    (4, 1, 1, 3, 1.05),
    (5, 1, 0, 6, 0.33),
    (6, 0, 0, 0, 0.00)
], columns=['item_id', 'bin_1', 'bin_2', 'int', 'cnt'])

if_np_good = np.array([
    (1, 0, 1, 5, 3.14),
    (2, 1, 0, 6, 2.72),
    (3, 0, 0, 4, 1.62),
    (4, 1, 1, 3, 1.05),
    (5, 1, 0, 6, 0.33),
    (6, 0, 0, 0, 0.00)
])

if_no_id = pd.DataFrame([
    (0, 1, 5, 3.14),
    (1, 0, 6, 2.72),
    (0, 0, 4, 1.62),
    (1, 1, 3, 1.05),
    (1, 0, 6, 0.33),
    (0, 0, 0, 0.00)
], columns=['bin_1', 'bin_2', 'int', 'cnt'])

if_str_cols = pd.DataFrame([
    (1, 0, 1, "A", 3.14),
    (2, 1, 0, "B", 2.72),
    (3, 0, 0, "C", 1.62),
    (4, 1, 1, "A", 1.05),
    (5, 1, 0, "F", 0.33),
    (6, 0, 0, "G", 0.00)
], columns=['item_id', 'bin_1', 'bin_2', 'str', 'cnt'])

train_users = np.array([1, 2, 3])
valid_users = np.array([1, 2, 4, 5])

# ------------------------------
# model fitting
# ------------------------------

params_good = [
    (intx_train_pd_int,       None,       None),
    (intx_train_pd_str,       None,       None),
    (intx_train_np,           None,       None),
    (intx_train_pd_int, uf_pd_good,       None),
    (intx_train_pd_int,       None, if_pd_good),
    (intx_train_pd_int, uf_pd_good, if_pd_good),
    (intx_train_pd_int, uf_np_good, if_np_good),
]


@pytest.mark.parametrize("interactions, user_features, item_features", params_good)
def test__fit__good(interactions, user_features, item_features):
    model = RankFM(factors=2)
    model.fit(interactions, user_features, item_features, epochs=2, verbose=True)
    assert model.is_fit


@pytest.mark.parametrize("kwargs, error", [
    (dict(interactions=intx_train_pd_rating), AssertionError),
    (dict(interactions=intx_train_pd_int, user_features=uf_no_id), KeyError),
    (dict(interactions=intx_train_pd_int, user_features=uf_str_cols), ValueError),
    (dict(interactions=intx_train_pd_int, item_features=if_no_id), KeyError),
    (dict(interactions=intx_train_pd_int, item_features=if_str_cols), ValueError),
], ids=["rating_col", "uf_no_id", "uf_str_cols", "if_no_id", "if_str_cols"])
def test__fit__bad(kwargs, error):
    _assert_same_error(lambda cls: cls(factors=2).fit(**kwargs), error=error)


@pytest.mark.parametrize("args, kwargs, error, message", [
    ((intx_train_pd_rating,), {}, AssertionError,
     r"\[interactions\] should be: \[user_id, item_id\]"),
    (([(1, 1), (2, 2)],), {}, AssertionError,
     r"\[interactions\] must be np.ndarray or pd.dataframe"),
    ((intx_train_pd_int,), dict(user_features=uf_no_id), KeyError,
     r"the users in \[user_features\] do not match the users in \[interactions\]"),
    ((intx_train_pd_int,), dict(epochs=0), AssertionError,
     r"\[epochs\] must be a positive integer"),
    ((intx_train_pd_int,), dict(verbose=1), AssertionError,
     r"\[verbose\] must be a boolean value"),
    ((intx_train_pd_int,), dict(sample_weight=np.ones(3, np.float32)),
     AssertionError, r"\[sample_weight\] must have the same length"),
], ids=["rating_col", "not_a_frame", "uf_no_id", "epochs", "verbose",
        "sample_weight"])
def test__fit__bad__messages(args, kwargs, error, message):
    _assert_same_error(lambda cls: cls(factors=2).fit(*args, **kwargs),
                       error=error, match=message)


def test__fit_partial__before_fit_then_after():
    model = RankFM(factors=2)
    model.fit_partial(intx_train_pd_int, epochs=1)
    assert model.is_fit
    model.fit_partial(intx_train_pd_int, epochs=1)
    assert model.is_fit


@pytest.mark.parametrize("kwargs, message", [
    (dict(factors=0), r"\[factors\] must be a positive integer"),
    (dict(loss='hinge'), r"\[loss\] must be in \('bpr', 'warp'\)"),
    (dict(learning_schedule='exponential'), r"\[learning_schedule\] must be in"),
    (dict(alpha=0.0), r"\[alpha\] must be a positive float"),
    (dict(alpha=1), r"\[alpha\] must be a positive float"),
    (dict(n_windows=0), r"\[n_windows\] must be None or a positive integer"),
    (dict(tail_windows=0), r"\[tail_windows\] must be None or a positive integer"),
    (dict(train_step="bogus"), r"\[train_step\] must be in"),
])
def test__ctor__bad_hyperparams(kwargs, message):
    _assert_same_error(lambda cls: cls(**kwargs), error=AssertionError,
                       match=message)

# ------------------------------
# score prediction
# ------------------------------


@pytest.mark.parametrize("pairs, cold_start, n_out, n_nan", [
    (intx_train_pd_int, 'nan', 9, 0),
    (intx_valid_disjoint, 'nan', 9, 4),
    (intx_valid_disjoint, 'drop', 5, 0),
], ids=["train", "disjoint_nan", "disjoint_drop"])
def test__predict__good(tmp_path, pairs, cold_start, n_out, n_nan):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    scores = model.predict(pairs, cold_start=cold_start)
    assert scores.shape == (n_out,)
    assert scores.dtype == np.float32
    assert np.sum(np.isnan(scores)) == n_nan
    want = _jax_twin(model, tmp_path).predict(pairs, cold_start=cold_start)
    assert want.dtype == scores.dtype
    np.testing.assert_allclose(scores, want, rtol=0, atol=1e-5)  # NaN == NaN


def test__predict__bad_cold_start(tmp_path):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    _assert_same_error(
        lambda m: m.predict(intx_train_pd_int, cold_start='fail'),
        model, _jax_twin(model, tmp_path), error=ValueError,
        match="param \\[cold_start\\] must be set to either 'nan' or 'drop'")
    _assert_same_error(
        lambda cls: cls(factors=2).predict(intx_train_pd_int),
        error=AssertionError,
        match="you must fit the model prior to generating predictions")

# ------------------------------
# user recommendation
# ------------------------------


def _assert_same_recs(model, tmp_path, recs, users, **kwargs):
    pd.testing.assert_frame_equal(
        recs, _jax_twin(model, tmp_path).recommend(users, **kwargs))


def test__recommend__good__train(tmp_path):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    recs = model.recommend(train_users, n_items=3)
    assert isinstance(recs, pd.DataFrame)
    assert recs.shape == (3, 3)
    assert np.array_equal(recs.index.values, train_users)
    assert recs.isin(intx_train_pd_int['item_id'].values).all().all()
    _assert_same_recs(model, tmp_path, recs, train_users, n_items=3)


def test__recommend__good__train__filter(tmp_path):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    recs = model.recommend(train_users, n_items=3, filter_previous=True)
    _assert_same_recs(model, tmp_path, recs, train_users, n_items=3,
                      filter_previous=True)
    assert isinstance(recs, pd.DataFrame)
    assert recs.shape == (3, 3)
    assert np.array_equal(recs.index.values, train_users)
    assert recs.isin(intx_train_pd_int['item_id'].values).all().all()

    recs_long = recs.stack().reset_index().drop('level_1', axis=1)
    recs_long.columns = ['user_id', 'item_id']
    intersect = pd.merge(
        intx_train_pd_int.astype(np.int64), recs_long.astype(np.int64),
        on=['user_id', 'item_id'], how='inner'
    ).empty
    assert intersect


def test__recommend__good__valid__nan(tmp_path):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    recs = model.recommend(valid_users, n_items=3, cold_start='nan')
    _assert_same_recs(model, tmp_path, recs, valid_users, n_items=3,
                      cold_start='nan')
    assert isinstance(recs, pd.DataFrame)
    assert recs.shape == (4, 3)
    assert np.array_equal(sorted(recs.index.values), sorted(valid_users))
    assert recs.dropna().isin(intx_train_pd_int['item_id'].values).all().all()
    new_users = list(set(valid_users) - set(train_users))
    assert recs.loc[new_users].isnull().all().all()


def test__recommend__good__valid__drop(tmp_path):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    recs = model.recommend(valid_users, n_items=3, cold_start='drop')
    _assert_same_recs(model, tmp_path, recs, valid_users, n_items=3,
                      cold_start='drop')
    assert isinstance(recs, pd.DataFrame)
    assert recs.shape == (2, 3)
    assert np.isin(recs.index.values, valid_users).all()
    assert recs.dropna().isin(intx_train_pd_int['item_id'].values).all().all()
    same_users = list(set(valid_users) & set(train_users))
    assert np.array_equal(sorted(same_users), sorted(recs.index.values))


def test__recommend__bad(tmp_path):
    _assert_same_error(
        lambda cls: cls(factors=2).recommend(train_users),
        error=AssertionError,
        match="you must fit the model prior to generating recommendations")
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    twin = _jax_twin(model, tmp_path)
    _assert_same_error(
        lambda m: m.recommend(train_users, cold_start='bogus'), model, twin,
        error=ValueError,
        match="param \\[cold_start\\] must be set to either 'nan' or 'drop'")
    _assert_same_error(lambda m: m.recommend(1), model, twin,
                       error=AssertionError,
                       match="\\[users\\] must be an iterable")

# ------------------------------
# similar items/users
# ------------------------------


@pytest.mark.parametrize("side, query, n", [("items", 1, 3), ("users", 1, 2)])
def test__similar__good(tmp_path, side, query, n):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    twin = _jax_twin(model, tmp_path)
    if side == "items":
        similar = model.similar_items(query, n_items=n)
        want = twin.similar_items(query, n_items=n)
    else:
        similar = model.similar_users(query, n_users=n)
        want = twin.similar_users(query, n_users=n)
    np.testing.assert_array_equal(np.asarray(similar), np.asarray(want))
    assert similar.shape == (n,)
    assert np.isin(similar, intx_train_pd_int[f'{side[:-1]}_id'].unique()).all()
    assert query not in set(similar.tolist())


@pytest.mark.parametrize("side, query", [("items", 99), ("users", 9)])
def test__similar__bad(tmp_path, side, query):
    model = RankFM(factors=2)
    model.fit(intx_train_pd_int)
    _assert_same_error(
        lambda m: (m.similar_items(query, n_items=3) if side == "items"
                   else m.similar_users(query, n_users=1)),
        model, _jax_twin(model, tmp_path), error=AssertionError,
        match=f"you must select an \\[{side[:-1]}_id\\] present in the training data")


def test_training_step_dispatch_by_catalog_size():
    """window step through 8 blocks, candidate step beyond (quality floor)"""

    def nblk(i):
        return fused.item_pad(i) // fused.block_size(i)

    assert nblk(3706) == 4       # ML-1M -> fused/window regime
    assert nblk(8192) == 8       # window XLA regime
    assert nblk(33362) > 8       # candidate regime
    assert fused.user_pad(6040) > 6040  # guard row always present

def test_fit_partial_unions_histories_and_drops_new_ids():
    """warm-start semantics: new (user, item) pairs with unseen ids are
    silently dropped; known pairs union into the histories"""
    rng = np.random.default_rng(11)
    train = np.stack([rng.integers(0, 20, 300), rng.integers(0, 40, 300)], 1)
    model = RankFM(factors=4, loss='warp', max_samples=3, batch_size=128)
    model.fit(train, epochs=2)
    before = {u: set(v.tolist()) for u, v in model.user_items.items()}

    # second round: half known pairs, half with out-of-vocabulary ids
    new_known = np.stack([rng.integers(0, 20, 50), rng.integers(0, 40, 50)], 1)
    new_oov = np.stack([rng.integers(100, 120, 50), rng.integers(100, 140, 50)], 1)
    mixed = np.concatenate([new_known, new_oov], 0)
    model.fit_partial(mixed, epochs=1)

    assert len(model.interactions) == len(np.unique(new_known, axis=0)) or \
        len(model.interactions) <= 50  # only known pairs survive
    after = {u: set(v.tolist()) for u, v in model.user_items.items()}
    for u, items in before.items():
        assert items.issubset(after.get(u, set())), "history union lost items"
    # id maps frozen: no new users/items appeared
    assert len(model.user_id) == 20 and len(model.item_id) == 40

    # the JAX package keeps the same rows and histories from the same frames
    ref = JaxRankFM(factors=4, loss='warp', max_samples=3, batch_size=128)
    ref.fit(train, epochs=1)
    ref.fit_partial(mixed, epochs=1)
    np.testing.assert_array_equal(model.interactions, ref.interactions)
    assert after == {u: set(v.tolist()) for u, v in ref.user_items.items()}


def test_seeded_fits_are_deterministic():
    """same seed + same init -> identical weights (seeded shuffle and
    negative draws)"""
    rng = np.random.default_rng(12)
    train = np.stack([rng.integers(0, 30, 500), rng.integers(0, 50, 500)], 1)
    outs = []
    for _ in range(2):
        np.random.seed(77)   # weight init uses the global numpy RNG
        m = RankFM(factors=4, loss='warp', max_samples=4, batch_size=256,
                   seed=123)
        m.fit(train, epochs=3)
        outs.append((m.v_u.copy(), m.v_i.copy(), m.w_i.copy()))
    for a, b in zip(outs[0], outs[1]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_fit_partial_continues_prng_stream(engine):
    """fit_partial must NOT replay the same shuffle/negative stream every
    call: with a constant eta, fit(epochs=2) and fit(1)+fit_partial(1) on
    the same data must walk the SAME two epoch streams and land on identical
    weights. The schedule is planned per call from its epoch count (a
    2-epoch fit of a small catalog would close with a candidate or a
    chunk-tail epoch that two 1-epoch calls never run), so each engine is
    pinned: the XLA step, and the fused engine at one layout."""
    rng = np.random.default_rng(5)
    train = np.stack([rng.integers(0, 30, 600), rng.integers(0, 50, 600)], 1)
    cfg = dict(factors=4, loss='warp', max_samples=4, batch_size=256,
               seed=99, learning_schedule='constant')
    if engine == "xla":
        cfg["use_fused"] = False
    else:
        cfg["train_step"] = "window"

    one = RankFM(**cfg)
    one.fit(train, epochs=2)
    plan = one.last_fit_plan_
    assert plan.fused == (engine == "fused")
    assert not plan.n_tail and not plan.chunk_tail

    two = RankFM(**cfg)
    two.fit(train, epochs=1)
    two.fit_partial(train, epochs=1)

    np.testing.assert_array_equal(one.v_u, two.v_u)
    np.testing.assert_array_equal(one.v_i, two.v_i)
    np.testing.assert_array_equal(one.w_i, two.w_i)


def test_evaluation_metrics_match_hand_computed_oracle(tmp_path):
    """pin hit_rate/MRR/DCG/precision/recall definitions on a crafted case
    (one user with two hits, one with one, one with three relevant items)"""
    rng = np.random.default_rng(99)
    train = np.stack([rng.integers(0, 6, 120), rng.integers(0, 12, 120)], 1)
    model = RankFM(factors=4, batch_size=64)
    model.fit(train, epochs=2)

    test = np.array([[0, 1], [0, 2], [1, 3], [2, 4], [2, 5], [2, 6]])
    k = 4
    recs = model.recommend([0, 1, 2], n_items=k, cold_start="drop")
    tui = {0: {1, 2}, 1: {3}, 2: {4, 5, 6}}

    hrs, rrs, dcgs, precs, recalls = [], [], [], [], []
    for u in (0, 1, 2):
        row = list(recs.loc[u].values)
        hits = [it in tui[u] for it in row]
        hrs.append(float(any(hits)))
        rrs.append(1.0 / (hits.index(True) + 1) if any(hits) else 0.0)
        dcgs.append(sum(1.0 / np.log2(r + 2) for r, h in enumerate(hits) if h))
        precs.append(sum(hits) / k)
        recalls.append(sum(hits) / len(tui[u]))

    assert evaluation.hit_rate(model, test, k=k) == pytest.approx(np.mean(hrs))
    assert evaluation.reciprocal_rank(model, test, k=k) == pytest.approx(np.mean(rrs))
    assert evaluation.discounted_cumulative_gain(model, test, k=k) == pytest.approx(np.mean(dcgs))
    assert evaluation.precision(model, test, k=k) == pytest.approx(np.mean(precs))
    assert evaluation.recall(model, test, k=k) == pytest.approx(np.mean(recalls))

    # compute() must accept any iterable (a generator used to be exhausted
    # by validation and silently return {})
    out = evaluation.compute(model, test,
                             metrics=(m for m in ("hit_rate", "recall")), k=k)
    assert out == {"hit_rate": pytest.approx(np.mean(hrs)),
                   "recall": pytest.approx(np.mean(recalls))}

    # and the JAX package's evaluation of the same weights
    assert evaluation.compute(model, test, k=k) == pytest.approx(
        jax_evaluation.compute(_jax_twin(model, tmp_path), test, k=k))


def test_filter_previous_exhausted_catalog_gives_nan_not_seen_items(tmp_path):
    """a user with fewer than n_items unseen items must get NaN for the
    missing slots — never -inf-masked SEEN items back (the reference
    returns uninitialized memory here; we define the edge properly)"""
    # user 0 has seen 8 of 10 items -> only 2 unseen
    inter = np.array([[0, i] for i in range(8)] + [[1, 8], [1, 9]])
    m = RankFM(factors=2, seed=3)
    m.fit(inter, epochs=1)
    recs = m.recommend([0], n_items=5, filter_previous=True)
    row = recs.loc[0].values.astype(float)
    valid = row[~np.isnan(row)]
    assert len(valid) == 2 and set(valid) == {8.0, 9.0}
    assert np.isnan(row[2:]).all()
    _assert_same_recs(m, tmp_path, recs, [0], n_items=5, filter_previous=True)


def test_metrics_survive_k_larger_than_catalog(tmp_path):
    """k > catalog size must degrade gracefully (recommend clamps its
    column count; the metric aggregation must follow, not crash)"""
    inter = np.array([[u, i] for u in range(6) for i in range(4)])
    m = RankFM(factors=2, seed=3)
    m.fit(inter, epochs=1)
    test = np.array([[0, 1], [1, 2], [2, 3]])
    out = evaluation.compute(m, test, k=10)
    assert 0.0 <= out["hit_rate"] <= 1.0
    assert all(np.isfinite(v) for v in out.values())
    assert out == pytest.approx(
        jax_evaluation.compute(_jax_twin(m, tmp_path), test, k=10))


def test_precision_small_catalog_divides_by_k(tmp_path):
    """precision@k divides by the REQUESTED k even when the catalog (and
    therefore the recommend matrix) holds fewer than k items — the
    reference convention divides by `k` unconditionally. A 4-item catalog
    at k=10 where every test row hits must score 4/10 per hit-count, never
    hits/k_eff (which would silently inflate tiny-catalog precision)."""
    inter = np.array([[u, i] for u in range(6) for i in range(4)])
    m = RankFM(factors=2, seed=3)
    m.fit(inter, epochs=1)
    # every user interacted with every item, so all 4 recommended items
    # (k clamped to the 4-item catalog) are relevant for these test rows
    test = np.array([[u, i] for u in range(6) for i in range(4)])
    out = evaluation.compute(m, test, k=10)
    assert out["precision"] == pytest.approx(4 / 10)
    assert evaluation.precision(m, test, k=10) == pytest.approx(4 / 10)
    # recall is unaffected: 4 hits / 4 relevant
    assert out["recall"] == pytest.approx(1.0)
    assert out == pytest.approx(
        jax_evaluation.compute(_jax_twin(m, tmp_path), test, k=10))


def test_recommend_preserves_big_int64_ids(tmp_path):
    """snowflake-scale int64 ids above 2^53 must come back exact, not
    float64-rounded to a nonexistent id"""
    base = 2**60
    inter = pd.DataFrame({
        "user_id": [1, 1, 2, 2, 3, 3],
        "item_id": [base + 1, base + 3, base + 1, base + 5,
                    base + 3, base + 5],
    })
    m = RankFM(factors=2, seed=3)
    m.fit(inter, epochs=1)
    recs = m.recommend([1, 2, 3], n_items=2)
    rec_ids = set(int(x) for x in recs.values.flatten())
    assert rec_ids <= {base + 1, base + 3, base + 5}, rec_ids
    _assert_same_recs(m, tmp_path, recs, [1, 2, 3], n_items=2)


def test_evaluation_vectorized_membership_string_ids_and_nan_cells(tmp_path):
    """the searchsorted membership must reproduce Python-set semantics for
    STRING ids, including NaN cells from filter_previous exhaustion (both
    flow through the shared pandas vocabulary)"""
    items = [f"it{k}" for k in range(10)]
    # user A sees 8 of 10 items -> filtered recs get NaN slots
    inter = pd.DataFrame({
        "u": ["A"] * 8 + ["B", "B"],
        "i": items[:8] + [items[8], items[9]],
    })
    m = RankFM(factors=2, seed=3)
    m.fit(inter, epochs=1)
    test = pd.DataFrame({"u": ["A", "A", "B"],
                         "i": [items[8], items[9], items[0]]})
    out = evaluation.compute(m, test, k=5, filter_previous=True)
    # oracle by hand: A's only unseen items are it8/it9 -> both recommended
    # -> A hits; B's recs exclude it8/it9 -> whether B hits depends on model
    recs = m.recommend(["A", "B"], n_items=5, filter_previous=True,
                       cold_start="nan")
    a_hits = {"it8", "it9"} & set(
        x for x in recs.loc["A"].dropna().values)
    assert a_hits == {"it8", "it9"}
    b_hit = "it0" in set(x for x in recs.loc["B"].dropna().values)
    assert out["hit_rate"] == pytest.approx((1.0 + float(b_hit)) / 2)
    # recall denominators per user: A has 2 relevant, B has 1
    assert out["recall"] == pytest.approx((2 / 2 + float(b_hit) / 1) / 2)
    twin = _jax_twin(m, tmp_path)
    _assert_same_recs(m, tmp_path, recs, ["A", "B"], n_items=5,
                      filter_previous=True, cold_start="nan")
    assert out == pytest.approx(
        jax_evaluation.compute(twin, test, k=5, filter_previous=True))


def test_auto_sample_rounds_resolution():
    """'auto' resolves the smallest R with density^R < 1e-6, clipped [2,8]
    (read from the resolved plan)"""
    rng = np.random.default_rng(5)
    # ~50% density fixture -> rounds clipped to 8
    inter = np.stack([rng.integers(0, 12, 400), rng.integers(0, 12, 400)], 1)
    m = RankFM(factors=2, batch_size=128, use_fused=False,
               train_step="candidate")
    m.fit(inter, epochs=1)
    assert m.last_fit_plan_.rounds == 8
    # sparse fixture (~1% density) -> 3 rounds
    inter = np.stack([rng.integers(0, 300, 3000),
                      rng.integers(0, 1000, 3000)], 1)
    m2 = RankFM(factors=2, batch_size=1024, use_fused=False,
                train_step="candidate", sample_rounds="auto")
    m2.fit(inter, epochs=1)
    assert 2 <= m2.last_fit_plan_.rounds < 8
    m3 = RankFM(factors=2, batch_size=1024, use_fused=False,
                train_step="candidate", sample_rounds=2)
    m3.fit(inter, epochs=1)
    assert m3.last_fit_plan_.rounds == 2


def test_divergence_aborts_early_not_at_fit_end():
    """a diverging fit must raise at (near) the first non-finite epoch —
    the reference asserts finiteness per epoch — not after burning every
    remaining epoch. The lagged poll reads the guarded ll of three epochs
    ago every 4 epochs, so detection must land within ~10 epochs of the
    divergence while the epochs stay queued ahead."""
    rng = np.random.default_rng(0)
    inter = np.stack([rng.integers(0, 50, 2000),
                      rng.integers(0, 40, 2000)], 1)
    sw = np.full(2000, 1e30, dtype=np.float32)  # overflow -> NaN weights
    m = RankFM(factors=4, loss="warp", max_samples=3, learning_rate=0.1)
    with pytest.raises(AssertionError, match="not finite"):
        m.fit(inter, sample_weight=sw, epochs=60)
    assert m._abort_epoch < 10, m._abort_epoch
    # detected within the (async) poll lag of the bad epoch, not at fit end
    assert m._abort_detected_at <= m._abort_epoch + 11, (
        m._abort_epoch, m._abort_detected_at)


def test_diversity_contract(tmp_path):
    """diversity returns cnt/pct of users recommended each catalog item
    of the test users: one row per training
    item, counts conserve users*k, pct = cnt / n_test_users, sorted desc."""
    rng = np.random.default_rng(7)
    train = np.stack([rng.integers(0, 6, 120), rng.integers(0, 12, 120)], 1)
    model = RankFM(factors=4, batch_size=64)
    model.fit(train, epochs=2)

    test = np.array([[0, 1], [1, 3], [2, 4], [5, 2]])
    k = 4
    div = evaluation.diversity(model, test, k=k)
    assert list(div.columns) == ["item_id", "cnt_users", "pct_users"]
    assert set(div["item_id"]) == set(model.item_id.values)  # full catalog
    n_users = 4  # all test users were in training
    assert div["cnt_users"].sum() == n_users * k
    np.testing.assert_allclose(div["pct_users"], div["cnt_users"] / n_users)
    assert (np.diff(div["cnt_users"].values) <= 0).all()  # sorted desc
    pd.testing.assert_frame_equal(
        div, jax_evaluation.diversity(_jax_twin(model, tmp_path), test, k=k))


def test_mixed_train_step_accepted_and_fits():
    """'mixed' is a valid train_step: on large catalogs the fused path
    finishes with a candidate-step tail; on a small one it must still fit
    end to end."""
    _assert_same_error(lambda cls: cls(factors=2, train_step="bogus"),
                       error=AssertionError)
    rng = np.random.default_rng(5)
    inter = np.stack([rng.integers(0, 30, 400), rng.integers(0, 50, 400)], 1)
    model = RankFM(factors=4, loss="warp", max_samples=3, seed=1,
                   train_step="mixed")
    model.fit(inter, epochs=2)
    assert model.is_fit
    assert len(model.training_log_) == 2
    recs = model.recommend(np.arange(10), n_items=5)
    assert recs.shape == (10, 5)


def test_fit_partial_feature_shape_transition_is_pinned(tmp_path):
    """features appearing/disappearing/changing width across fit_partial
    raise a clear assertion instead of a shape crash inside an epoch; a
    same-width transition keeps working."""
    rng = np.random.default_rng(4)
    inter = pd.DataFrame({
        "user_id": rng.integers(0, 10, 200),
        "item_id": rng.integers(0, 15, 200),
    })
    users = np.unique(inter["user_id"])
    uf_wide = pd.DataFrame({
        "user_id": users,
        "f0": rng.uniform(size=len(users)).astype(np.float32),
        "f1": rng.uniform(size=len(users)).astype(np.float32),
    })
    uf_one = uf_wide[["user_id", "f0"]]

    # featureless fit -> multi-column features in fit_partial: refuse
    m = RankFM(factors=3, seed=5)
    m.fit(inter, epochs=1)
    _assert_same_error(
        lambda mm: mm.fit_partial(inter, user_features=uf_wide, epochs=1),
        m, _jax_twin(m, tmp_path), error=AssertionError,
        match="column count changed")

    # featureful fit -> featureless fit_partial (width 2 -> default 1): refuse
    m2 = RankFM(factors=3, seed=5)
    m2.fit(inter, user_features=uf_wide, epochs=1)
    _assert_same_error(lambda mm: mm.fit_partial(inter, epochs=1),
                       m2, _jax_twin(m2, tmp_path), error=AssertionError,
                       match="column count changed")

    # same-width transitions keep working (featureless fit is width 1)
    m3 = RankFM(factors=3, seed=5)
    m3.fit(inter, epochs=1)
    m3.fit_partial(inter, user_features=uf_one, epochs=1)
    assert m3.is_fit and np.isfinite(m3.v_uf).all()


def test_similarity_caches_reps_across_calls(tmp_path):
    """similar_items/users compute the full latent-rep matrix ONCE per fit
    and side: repeated queries reuse the cached tensor, results match a
    numpy oracle, and refitting invalidates the cache."""
    rng = np.random.default_rng(6)
    inter = np.stack([rng.integers(0, 20, 400), rng.integers(0, 30, 400)], 1)
    m = RankFM(factors=4, seed=5)
    m.fit(inter, epochs=2)

    out1 = m.similar_items(3, n_items=5)
    cached = m._sim_cache.get("v_i")
    assert cached is not None
    out2 = m.similar_items(7, n_items=5)
    assert m._sim_cache.get("v_i") is cached  # the same tensor object

    # numpy oracle (the reference's definition of the latent rep)
    reps = m.v_i + m.x_if @ m.v_if
    for query, out in ((3, out1), (7, out2)):
        qi = int(m.item_to_index.loc[query])
        sims = reps @ reps[qi]
        sims[qi] = -np.inf
        expect = m.item_id.values[np.argsort(-sims)[:5]]
        np.testing.assert_array_equal(np.asarray(out), expect)
    np.testing.assert_array_equal(
        np.asarray(out1),
        np.asarray(_jax_twin(m, tmp_path).similar_items(3, n_items=5)))

    m.fit_partial(inter, epochs=1)
    assert m._sim_cache == {}  # weights changed -> cache dropped


def test_similarity_scales_to_1e5_rows(tmp_path):
    """the similarity path at catalog scale: ~1e5 items, repeated queries
    off one cached rep matrix."""
    rng = np.random.default_rng(7)
    n = 100_000
    inter = np.stack([rng.integers(0, 2000, n),
                      np.arange(n, dtype=np.int64) % 99_000], 1)
    m = RankFM(factors=4, seed=5, batch_size=8192)
    m.fit(inter, epochs=1)
    assert len(m.item_id) == 99_000
    first = m.similar_items(42, n_items=10)
    assert len(first) == 10 and 42 not in set(first.tolist())
    np.testing.assert_array_equal(
        np.asarray(first),
        np.asarray(_jax_twin(m, tmp_path).similar_items(42, n_items=10)))
    for q in (7, 123, 9876):
        out = m.similar_items(q, n_items=10)
        assert len(out) == 10 and q not in set(out.tolist())


def test_diversity_shares_compute_pass_and_handles_nan_cells(tmp_path):
    """diversity rides the shared retrieval pass:
    compute() can return it alongside scalar metrics, it equals the
    standalone function, and NaN cells from exhausted filter_previous
    catalogs count toward no item while the user stays in the denominator."""
    # user 0 has seen 8 of 10 items -> filtered recs get NaN slots
    inter = np.array([[0, i] for i in range(8)] + [[1, 8], [1, 9], [2, 0]])
    m = RankFM(factors=2, seed=3)
    m.fit(inter, epochs=1)
    test = np.array([[0, 8], [1, 0], [2, 1]])

    out = evaluation.compute(m, test, metrics=("hit_rate", "diversity"),
                             k=5, filter_previous=True)
    div = out["diversity"]
    pd.testing.assert_frame_equal(
        div, evaluation.diversity(m, test, k=5, filter_previous=True))
    assert list(div.columns) == ["item_id", "cnt_users", "pct_users"]
    assert set(div["item_id"]) == set(m.item_id.values)
    # user 0 contributes only its 2 unseen items; users 1 and 2 a full 5
    assert div["cnt_users"].sum() == 2 + 5 + 5
    np.testing.assert_allclose(div["pct_users"], div["cnt_users"] / 3)
    assert (np.diff(div["cnt_users"].values) <= 0).all()
    ref = jax_evaluation.compute(_jax_twin(m, tmp_path), test,
                                 metrics=("hit_rate", "diversity"), k=5,
                                 filter_previous=True)
    pd.testing.assert_frame_equal(div, ref["diversity"])
    assert out["hit_rate"] == pytest.approx(ref["hit_rate"])
