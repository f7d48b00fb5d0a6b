"""The port's fit-time host half: `last_fit_timing_`, the ingest short cut
of a repeated `fit_partial`, the record-layout cache, and the ingest's
arrays against the JAX package's.
"""

import hashlib

import numpy as np
import pandas as pd
import pytest

import rankfm_tpu.models.rankfm as jrankfm_mod
from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu.ops import fused as jfused
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import native as tnative
from rankfm_tpu_torch.ops import fused as tfused

from torch_common import one_torch_thread, pallas_interpret  # noqa: F401

FUSED_KEYS = ["ingest_s", "hist_pack_s", "records_s", "prep_s",
              "epoch0_call_s", "dispatch_s", "block_s"]
XLA_KEYS = ["ingest_s", "epoch0_call_s", "dispatch_s", "block_s"]
CFG = dict(factors=4, loss="warp", max_samples=3, batch_size=256, seed=7)


def _frame(seed=0, n=700, n_users=40, n_items=60):
    """An interaction frame with offset raw ids and repeated pairs."""
    rng = np.random.default_rng(seed)
    return pd.DataFrame({"user_id": 1000 + rng.integers(0, n_users, n),
                         "item_id": 50 + rng.integers(0, n_items, n)})


@pytest.fixture
def builds(monkeypatch):
    """Counts of the calls that build a record layout and a history pack."""
    counts = {"records": 0, "history": 0}
    real_rec, real_hist = tfused.make_records_grouped, tfused.pack_history

    def records(*a, **kw):
        counts["records"] += 1
        return real_rec(*a, **kw)

    def history(*a, **kw):
        counts["history"] += 1
        return real_hist(*a, **kw)

    monkeypatch.setattr(tfused, "make_records_grouped", records)
    monkeypatch.setattr(tfused, "pack_history", history)
    return counts


@pytest.fixture
def jax_fused_on_cpu(pallas_interpret, monkeypatch):  # noqa: F811
    """The JAX package's fused engine on this CPU (Pallas in interpret
    mode, the planner told it runs on a TPU)."""
    monkeypatch.setattr(jrankfm_mod, "_on_tpu", lambda: True)
    jfused.make_fused_epoch_fn.cache_clear()
    jfused.make_fused_batch_fn.cache_clear()
    yield
    jfused.make_fused_epoch_fn.cache_clear()
    jfused.make_fused_batch_fn.cache_clear()


def test_last_fit_timing_fused_has_the_reference_keys(jax_fused_on_cpu):
    users = np.repeat(np.arange(16), 7)
    items = np.concatenate([np.delete(np.arange(8), u % 8) for u in range(16)])
    train = np.stack([users, items], 1)
    cfg = dict(factors=4, loss="warp", max_samples=3, train_step="window",
               batch_size=128)
    jm = JaxRankFM(**cfg).fit(train, epochs=1)
    tm = TorchRankFM(**cfg, device="cpu").fit(train, epochs=1)
    assert jm.last_fit_plan_.fused and tm.last_fit_plan_.fused
    assert list(jm.last_fit_timing_) == FUSED_KEYS
    assert list(tm.last_fit_timing_) == FUSED_KEYS
    _check_timing_values(tm.last_fit_timing_)


def test_last_fit_timing_xla_has_the_reference_keys_and_resets():
    train = _frame()
    cfg = dict(CFG, use_fused=False)
    jm = JaxRankFM(**cfg).fit(train, epochs=1)
    tm = TorchRankFM(**cfg, device="cpu")
    assert tm.last_fit_timing_ == {}
    tm.fit(train, epochs=1)
    assert not tm.last_fit_plan_.fused
    assert list(jm.last_fit_timing_) == XLA_KEYS
    assert list(tm.last_fit_timing_) == XLA_KEYS
    _check_timing_values(tm.last_fit_timing_)
    tm.fit_partial(train, epochs=1)
    assert list(tm.last_fit_timing_) == XLA_KEYS      # replaced, not merged
    tm._reset_state()
    assert tm.last_fit_timing_ == {}


def _check_timing_values(tm):
    for k, v in tm.items():
        assert isinstance(v, float) and v >= 0 and v == round(v, 2), (k, v)
    if "prep_s" in tm:
        assert tm["prep_s"] + 0.011 >= tm["hist_pack_s"] + tm["records_s"]


@pytest.mark.parametrize("schedule", ["one-layout", "chunk-tail",
                                      "candidate-tail"])
def test_repeated_fit_partial_builds_no_layout_and_no_history(builds,
                                                              schedule):
    if schedule == "one-layout":
        train, cfg = _frame(), dict(CFG, train_step="window")
    else:
        train = _frame(n=3000, n_users=300)
        cfg = dict(CFG, batch_size=None)
        if schedule == "chunk-tail":
            cfg["train_step"] = "window"
    m = TorchRankFM(**cfg, device="cpu").fit(train, epochs=2)
    plan = m.last_fit_plan_
    assert plan.fused
    assert bool(plan.chunk_tail) == (schedule == "chunk-tail")
    assert bool(plan.n_tail) == (schedule == "candidate-tail")
    n_layouts = 1 + bool(plan.chunk_tail)             # two keys per fit
    assert builds == {"records": n_layouts, "history": 1}
    assert len(m._rec_cache) == n_layouts
    packed, cached = m._packed_hist, dict(m._rec_cache)
    offsets_dev = m._offsets_dev

    m.fit_partial(train, epochs=2)                    # same frame: all hits
    assert builds == {"records": n_layouts, "history": 1}
    assert m._packed_hist is packed and m._offsets_dev is offsets_dev
    assert all(m._rec_cache[k] is v for k, v in cached.items())

    # a changed sample_weight rebuilds the layouts, not the history
    sw = np.linspace(0.5, 2.0, len(train)).astype(np.float32)
    m.fit_partial(train, sample_weight=sw, epochs=2)
    assert builds == {"records": 2 * n_layouts, "history": 1}
    assert m._packed_hist is packed
    assert set(cached) < set(m._rec_cache)
    np.testing.assert_array_equal(m.sample_weight, sw[m._keep_cache])

    # a changed frame rebuilds both and drops the old layouts
    other = _frame(seed=1, n=len(train), n_users=train["user_id"].nunique())
    m.fit_partial(other, epochs=2)
    assert builds == {"records": 3 * n_layouts, "history": 2}
    assert m._packed_hist is not packed
    assert not set(cached) & set(m._rec_cache)
    assert len(m._rec_cache) == n_layouts


def test_record_cache_key_and_size_limit(builds):
    train = _frame()
    m = TorchRankFM(**CFG, device="cpu").fit(train, epochs=1)
    plan = m.last_fit_plan_
    assert plan.fused and not plan.chunk_tail         # one layout per fit
    first = next(iter(m._rec_cache))
    sw0 = np.ones(len(m.interactions), np.float32)
    assert first == (m._ingest_hash, plan.batch_size, plan.chunk,
                     plan.user_block, len(m.interactions),
                     hashlib.sha256(sw0.tobytes()).digest())
    for k in range(5):                                # five more layouts
        sw = np.full(len(train), 1.0 + 0.1 * (k + 1), np.float32)
        m.fit_partial(train, sample_weight=sw, epochs=1)
        assert len(m._rec_cache) <= 4
    assert builds["records"] == 6 and builds["history"] == 1
    assert first not in m._rec_cache                  # oldest out first
    m.fit_partial(train, sample_weight=sw, epochs=1)  # the newest still hits
    assert builds["records"] == 6


def test_string_ids_are_not_cached_and_still_fit(builds):
    train = _frame().astype(str)
    m = TorchRankFM(**CFG, device="cpu").fit(train, epochs=1)
    assert m._ingest_hash is None and not m._rec_cache
    m.fit_partial(train, epochs=1)
    assert m._ingest_hash is None and not m._rec_cache
    assert builds == {"records": 2, "history": 2}
    assert all(np.isfinite(v).all() for v in m._weights.values())


def _fit_sequence(model, train, sw):
    model.fit(train, epochs=2)
    model.fit_partial(train, epochs=1)
    model.fit_partial(train, sample_weight=sw, epochs=1)
    model.fit_partial(train, epochs=1)
    return model


def test_cached_fits_train_the_same_weights_bit_for_bit(monkeypatch):
    train = _frame()
    sw = np.linspace(0.5, 2.0, len(train)).astype(np.float32)
    cached = _fit_sequence(TorchRankFM(**CFG, device="cpu"), train, sw)
    assert cached._ingest_hash is not None and cached._rec_cache
    # no hash: no short cut and no layout cache
    monkeypatch.setattr(TorchRankFM, "_hash_interactions",
                        lambda self, interactions: None)
    plain = _fit_sequence(TorchRankFM(**CFG, device="cpu"), train, sw)
    assert plain._ingest_hash is None and not plain._rec_cache
    for k, v in cached._weights.items():
        np.testing.assert_array_equal(v, plain._weights[k], err_msg=k)
    assert ([r["log_likelihood"] for r in cached.training_log_]
            == [r["log_likelihood"] for r in plain.training_log_])


@pytest.mark.parametrize("path", ["native", "numpy"])
def test_ingest_arrays_equal_the_jax_package(monkeypatch, path):
    """`interactions`, `sample_weight` and the history CSR after `fit` and
    after a `fit_partial` on a frame with unknown ids and repeated pairs."""
    if path == "numpy":
        monkeypatch.setattr(tnative, "get_lib", lambda: None)
    elif tnative.get_lib() is None:
        pytest.skip("native toolchain unavailable")
    first = _frame()
    rng = np.random.default_rng(4)
    second = pd.concat([_frame(seed=2, n=300), pd.DataFrame({
        "user_id": rng.integers(5000, 5050, 80),
        "item_id": rng.integers(0, 200, 80)})]).sample(frac=1, random_state=0)
    second = pd.concat([second, second.iloc[:40]])    # repeated pairs
    sw1 = pd.Series(rng.uniform(0.5, 2.0, len(first)))
    sw2 = rng.uniform(0.5, 2.0, len(second)).astype(np.float32)
    cfg = dict(CFG, use_fused=False)
    jm, tm = JaxRankFM(**cfg), TorchRankFM(**cfg, device="cpu")

    def same():
        for name in ("interactions", "sample_weight", "_ui_offsets",
                     "_ui_items"):
            a, b = getattr(tm, name), getattr(jm, name)
            assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
            np.testing.assert_array_equal(a, b, err_msg=name)

    for m in (jm, tm):
        m.fit(first, sample_weight=sw1, epochs=1)
    same()
    assert (tm._ingest_hash is None) == (path == "numpy")
    for m in (jm, tm):
        m.fit_partial(second, sample_weight=sw2, epochs=1)
    same()
    assert len(tm.interactions) < len(second)         # unknown ids dropped
    for m in (jm, tm):                                # and the same frame again
        m.fit_partial(second, epochs=1)
    same()
