"""The port's slice as a whole against the JAX package: ingest and weight
init, serving with shared weights, a deterministic whole fit against the
Pallas kernel run in interpret mode, and fit quality against the C++
sequential oracle.
"""

import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

import rankfm_tpu.models.rankfm as jrankfm_mod
from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu import evaluation as jeval
from rankfm_tpu.ops import fused as jfused
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import evaluation as teval
from rankfm_tpu_torch.utils.convert import weights_from_numpy

from parity_common import make_latent_dataset, oracle_metrics
from torch_common import one_torch_thread  # noqa: F401

METRICS = ("hit_rate", "reciprocal_rank", "discounted_cumulative_gain",
           "precision", "recall")


def _log(rng, n_users=60, n_items=90, per_user=12):
    """Grouped implicit log with offset raw ids (exercises id mapping)."""
    rows = []
    for u in range(n_users):
        g = u % 3
        pool = np.arange(g * n_items // 3, (g + 1) * n_items // 3)
        items = rng.choice(pool, per_user, replace=False)
        rows.append(np.stack([np.full(per_user, 1000 + u), 50 + items], 1))
    df = pd.DataFrame(np.concatenate(rows), columns=["user_id", "item_id"])
    train = df.sample(frac=0.8, random_state=0)
    return train, df.drop(train.index)


def _features(rng, train):
    users = np.sort(train["user_id"].unique())
    items = np.sort(train["item_id"].unique())
    uf = pd.DataFrame({"user_id": users, "a": rng.random(len(users)),
                       "b": (rng.random(len(users)) < 0.5).astype(float)})
    itf = pd.DataFrame({"item_id": items, **{
        f"d{k}": (rng.integers(0, 3, len(items)) == k).astype(float)
        for k in range(3)}})
    return uf, itf


def test_ingest_and_init_match():
    rng = np.random.default_rng(0)
    train, _ = _log(rng)
    uf, itf = _features(rng, train)
    sw = pd.Series(rng.uniform(0.5, 2.0, len(train)))
    jm, tm = JaxRankFM(factors=6), TorchRankFM(factors=6, device="cpu")
    for m in (jm, tm):
        m._init_all(train, user_features=uf, item_features=itf,
                    sample_weight=sw)
    np.testing.assert_array_equal(tm.interactions, jm.interactions)
    np.testing.assert_array_equal(tm.sample_weight, jm.sample_weight)
    np.testing.assert_array_equal(tm._ui_offsets, jm._ui_offsets)
    np.testing.assert_array_equal(tm._ui_items, jm._ui_items)
    np.testing.assert_array_equal(tm.user_id.values, jm.user_id.values)
    np.testing.assert_array_equal(tm.item_id.values, jm.item_id.values)
    np.testing.assert_array_equal(tm.x_uf, jm.x_uf)
    np.testing.assert_array_equal(tm.x_if, jm.x_if)
    jw, tw = jm._weights, tm._weights
    assert set(jw) == set(tw)
    for k in jw:
        assert tw[k].dtype == np.float32
        np.testing.assert_array_equal(tw[k], np.asarray(jw[k]))


def _served_pair(neg_sampler):
    """A JAX model and a port model holding the same random weights."""
    rng = np.random.default_rng(1)
    train, test = _log(rng)
    uf, itf = _features(rng, train)
    jm = JaxRankFM(factors=6, neg_sampler=neg_sampler)
    tm = TorchRankFM(factors=6, neg_sampler=neg_sampler, device="cpu")
    jm._init_all(train, user_features=uf, item_features=itf)
    tm._init_all(train, user_features=uf, item_features=itf)
    w = {k: rng.normal(0, 0.3, np.shape(v)).astype(np.float32)
         for k, v in jm._weights.items()}
    jm._weights = {k: jnp.asarray(v) for k, v in w.items()}
    tm._w = weights_from_numpy(w, "cpu")
    jm.is_fit = tm.is_fit = True
    return jm, tm, train, test


@pytest.mark.parametrize("neg_sampler", ["bitmap", "bsearch"])
def test_serving_matches_with_shared_weights(neg_sampler):
    jm, tm, train, test = _served_pair(neg_sampler)
    pairs = np.concatenate([test.values, [[1000, 99_999], [5, 60]]])
    pj, pt = jm.predict(pairs), tm.predict(pairs)
    np.testing.assert_array_equal(np.isnan(pt), np.isnan(pj))
    np.testing.assert_allclose(pt, pj, atol=1e-5, equal_nan=True)
    np.testing.assert_array_equal(tm.predict(pairs, cold_start="drop"),
                                  pt[~np.isnan(pt)])
    users = list(np.unique(train["user_id"])) + [-7]
    for fp in (False, True):
        for k in (10, 100):                  # 100 > catalog: exhausted slots
            pd.testing.assert_frame_equal(
                tm.recommend(users, n_items=k, filter_previous=fp),
                jm.recommend(users, n_items=k, filter_previous=fp))
    for fp in (False, True):
        got = teval.compute(tm, test, metrics=METRICS + ("diversity",),
                            k=10, filter_previous=fp)
        want = jeval.compute(jm, test, metrics=METRICS + ("diversity",),
                             k=10, filter_previous=fp)
        for m in METRICS:
            assert got[m] == want[m], (m, got[m], want[m])
        pd.testing.assert_frame_equal(got["diversity"], want["diversity"])
    for item in train["item_id"].unique()[:5]:
        np.testing.assert_array_equal(tm.similar_items(item, 7),
                                      jm.similar_items(item, 7))
    for user in train["user_id"].unique()[:5]:
        np.testing.assert_array_equal(tm.similar_users(user, 7),
                                      jm.similar_users(user, 7))


@pytest.fixture
def jax_fused_on_cpu(monkeypatch):
    """The JAX package's fused kernel on this CPU: Pallas in TPU interpret
    mode, and the planner told it runs on a TPU."""
    orig = pl.pallas_call

    def interpret_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        kwargs["interpret"] = pltpu.InterpretParams()
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    monkeypatch.setattr(jrankfm_mod, "_on_tpu", lambda: True)
    # kernels cached by an earlier non-interpret build must not be reused
    jfused.make_fused_epoch_fn.cache_clear()
    jfused.make_fused_batch_fn.cache_clear()
    yield
    jfused.make_fused_epoch_fn.cache_clear()
    jfused.make_fused_batch_fn.cache_clear()


@pytest.mark.parametrize("loss", ["bpr", "warp"])
def test_whole_fit_matches_pallas_kernel(jax_fused_on_cpu, loss):
    """8 items, 16 users holding 7 each: one 128-slot window whose pad
    slots are members, so every negative is forced, and 112 rows make one
    chunk per epoch, so shuffle and rotation cannot change the result."""
    users = np.repeat(np.arange(16), 7)
    items = np.concatenate([np.delete(np.arange(8), u % 8) for u in range(16)])
    train = np.stack([users, items], 1)
    cfg = dict(factors=6, loss=loss, max_samples=5, train_step="window",
               batch_size=128, learning_rate=0.2)
    tm = TorchRankFM(**cfg, device="cpu")
    tm._init_all(train)
    w0 = tm._weights
    jm = JaxRankFM(**cfg).fit(train, epochs=3)
    tm.fit(train, epochs=3)
    assert tm.last_fit_plan_.fused
    assert (dataclasses.asdict(tm.last_fit_plan_)
            == dataclasses.asdict(jm.last_fit_plan_))
    jw, tw = jm._weights, tm._weights
    for k in ("w_i", "v_u", "v_i"):
        want = np.asarray(jw[k])
        assert np.abs(want - w0[k]).max() > 0          # training moved it
        rel = np.abs(tw[k] - want).max() / np.abs(want).max()
        assert rel < 2e-2, (k, rel)
    lj = [r["log_likelihood"] for r in jm.training_log_]
    lt = [r["log_likelihood"] for r in tm.training_log_]
    np.testing.assert_allclose(lt, lj, rtol=1e-2)
    pd.testing.assert_frame_equal(tm.recommend(np.arange(16), n_items=3),
                                  jm.recommend(np.arange(16), n_items=3))


def test_fit_quality_matches_sequential_oracle():
    """A 10-epoch port fit (3 window blocks: pure fused plus the chunk-tail)
    lands inside the fused quality band of the C++ sequential oracle run
    from the same data and initial weights (the oracle takes a JAX model
    of the same config: its ingest and init equal the port's, see
    test_ingest_and_init_match)."""
    from rankfm_tpu import native
    if native.get_oracle() is None:
        pytest.skip("no C++ toolchain for the sequential oracle")
    rng = np.random.default_rng(1492)
    train, test = make_latent_dataset(rng, n_users=600, n_items=2500,
                                      sharp=2.0)
    cfg = dict(factors=16, loss="warp", max_samples=10,
               learning_schedule="invscaling")
    tm = TorchRankFM(**cfg, device="cpu").fit(train, epochs=10)
    plan = tm.last_fit_plan_
    assert plan.fused and plan.nblk == 3 and plan.chunk_tail == 1
    got = teval.compute(tm, test, metrics=METRICS, k=10)
    want = oracle_metrics(JaxRankFM(**cfg), train, test, epochs=10)
    gate = {"hit_rate": 0.05, "discounted_cumulative_gain": 0.05,
            "precision": 0.03, "recall": 0.03}
    deltas = {m: got[m] - want[m] for m in METRICS}
    print("port - oracle:", deltas)
    for m, tol in gate.items():
        assert abs(deltas[m]) <= tol, (m, deltas)


def test_port_imports_no_jax():
    code = ("import sys; before = set(sys.modules); "
            "import rankfm_tpu_torch, rankfm_tpu_torch.ops.fused, "
            "rankfm_tpu_torch.ops._build, rankfm_tpu_torch.utils.convert, "
            "rankfm_tpu_torch.ops.training, rankfm_tpu_torch.ops.scatter, "
            "rankfm_tpu_torch.ops.negatives, rankfm_tpu_torch.native, "
            "rankfm_tpu_torch.utils.checkpoint, rankfm_tpu_torch.baselines, "
            "rankfm_tpu_torch.utils.observe, rankfm_tpu_torch.utils.data, "
            "rankfm_tpu_torch.parallel.mesh, rankfm_tpu_torch.parallel.train, "
            "rankfm_tpu_torch.parallel.fused, rankfm_tpu_torch.parallel.tp, "
            "rankfm_tpu_torch.parallel.retrieval; "
            "rankfm_tpu_torch.native.get_lib(); "
            "bad = [m for m in set(sys.modules) - before if m == 'jax' or "
            "m.startswith(('jax.', 'rankfm_tpu.')) or m == 'rankfm_tpu']; "
            "print(bad, 'jax' in sys.modules); sys.exit(1 if bad else 0)")
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=120,
                          cwd=Path(__file__).resolve().parents[1])
    assert proc.returncode == 0, proc.stdout + proc.stderr
