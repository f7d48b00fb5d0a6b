"""The port's C++ sequential oracle (`rankfm_tpu_torch.native.oracle_fit`)
and its harness (`tests/torch_parity_common.py`) against the JAX package's
(`rankfm_tpu.native.oracle_fit`, `tests/parity_common.py`) on the same
inputs, at small sizes.

Both oracles are the same source built with the same flags, so their
weights and per-epoch log-likelihoods must be bit-equal; the harnesses'
data and metrics must be equal too (the port's ingest and initial weights
equal the JAX package's: `test_torch_slice.py::test_ingest_and_init_match`).
"""

import numpy as np
import pandas as pd
import pytest

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu import native as jnative
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import native as tnative

import parity_common as pc
import torch_parity_common as tpc

CFG = dict(factors=8, loss="warp", max_samples=10, alpha=0.01, beta=0.1,
           learning_rate=0.1, learning_schedule="invscaling")


@pytest.fixture(scope="module")
def oracles():
    if tnative.get_oracle() is None or jnative.get_oracle() is None:
        pytest.skip("no C++ toolchain for the sequential oracle: "
                    f"{tnative.oracle_build_error}")


def _small(seed=3):
    """A 300 x 200 latent log (~4,500 training rows)."""
    return tpc.make_latent_dataset(np.random.default_rng(seed), n_users=300,
                                   n_items=200, per_user=20)


# (case, config overrides, features, sample weights)
ORACLE_CASES = {
    "warp-weights": ({}, False, True),
    "warp-features": ({}, True, False),
    "bpr": (dict(loss="bpr"), False, False),
    "constant-schedule": (dict(learning_schedule="constant"), False, True),
}


@pytest.mark.parametrize("case", list(ORACLE_CASES))
def test_oracle_bit_equal_to_jax_package(oracles, case):
    over, features, weights = ORACLE_CASES[case]
    cfg = {**CFG, **over}
    train, _ = _small()
    rng = np.random.default_rng(5)
    kw = {}
    if features:
        kw["user_features"], kw["item_features"] = tpc.make_features(
            rng, train)
    if weights:
        kw["sample_weight"] = rng.uniform(0.5, 3.0, len(train)).astype(
            np.float32)
    m = TorchRankFM(**cfg, device="cpu")
    m._init_all(train, **kw)
    w0 = m._weights
    max_samples = 1 if cfg["loss"] == "bpr" else cfg["max_samples"]
    args = (m.interactions, m.sample_weight, m._ui_offsets, m._ui_items,
            m.x_uf, m.x_if, w0, cfg["alpha"], cfg["beta"],
            cfg["learning_rate"], cfg["learning_schedule"], 0.25,
            max_samples, 3, 1492)
    got_w, got_ll = tnative.oracle_fit(*args)
    want_w, want_ll = jnative.oracle_fit(*args)
    assert set(got_w) == set(want_w)
    for k in want_w:
        np.testing.assert_array_equal(got_w[k], want_w[k], err_msg=k)
    np.testing.assert_array_equal(got_ll, want_ll)
    assert got_ll.shape == (3,) and np.isfinite(got_ll).all()
    # training moved the weights, and left the initial ones as they were
    assert not np.array_equal(got_w["v_i"], w0["v_i"])
    for k, v in m._weights.items():
        np.testing.assert_array_equal(w0[k], v, err_msg=k)


def test_oracle_fit_rejects_inconsistent_shapes(oracles):
    train, _ = _small()
    m = TorchRankFM(**CFG, device="cpu")
    m._init_all(train)
    w0 = m._weights
    args = [m.interactions, m.sample_weight, m._ui_offsets, m._ui_items,
            m.x_uf, m.x_if, w0, 0.01, 0.1, 0.1, "invscaling", 0.25, 10, 1,
            1492]
    bad = dict(w0, v_i=w0["v_i"][:-1])
    for k, v in ((1, m.sample_weight[:-1]), (2, m._ui_offsets[:-1]),
                 (5, m.x_if[:-1]), (6, bad)):
        with pytest.raises(ValueError, match="inconsistent shapes"):
            tnative.oracle_fit(*args[:k], v, *args[k + 1:])


def test_data_generators_match_parity_common():
    for kw in ({}, dict(n_users=300, n_items=500, per_user=40, sharp=2.0)):
        got = tpc.make_latent_dataset(np.random.default_rng(11), **kw)
        want = pc.make_latent_dataset(np.random.default_rng(11), **kw)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    train = got[0]
    for g, w in zip(tpc.make_features(np.random.default_rng(2), train),
                    pc.make_features(np.random.default_rng(2), train)):
        pd.testing.assert_frame_equal(g, w)


@pytest.mark.parametrize("features", [False, True],
                         ids=["featureless", "features"])
def test_oracle_metrics_match_parity_common(oracles, features):
    """The port's harness on a port model and the JAX package's on a JAX
    model of the same config: the same five metrics, exactly."""
    train, test = _small(7)
    kw = {}
    if features:
        kw["user_features"], kw["item_features"] = tpc.make_features(
            np.random.default_rng(1), train)
        kw["sample_weight"] = np.random.default_rng(2).integers(
            1, 4, len(train)).astype(np.float32)
    got = tpc.oracle_metrics(TorchRankFM(**CFG, device="cpu"), train, test,
                             epochs=3, **kw)
    want = pc.oracle_metrics(JaxRankFM(**CFG), train, test, epochs=3, **kw)
    assert got == want
    assert set(got) == set(tpc.METRICS) and got["hit_rate"] > 0


def test_get_oracle_none_when_the_compiler_fails(tmp_path, monkeypatch):
    """A failing g++ leaves `get_oracle` None with the compiler's message in
    `oracle_build_error`, `oracle_fit` None, and the harness raising it."""
    bin_dir = tmp_path / "bin"
    bin_dir.mkdir()
    gxx = bin_dir / "g++"
    gxx.write_text("#!/bin/sh\necho 'error: fake g++ refuses' >&2\nexit 1\n")
    gxx.chmod(0o755)
    monkeypatch.setenv("PATH", str(bin_dir))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_oracle_lib", None)
    monkeypatch.setattr(tnative, "_oracle_tried", False)
    monkeypatch.setattr(tnative, "oracle_build_error", None)
    assert tnative.get_oracle() is None
    assert "fake g++ refuses" in tnative.oracle_build_error
    train, test = _small()
    m = TorchRankFM(**CFG, device="cpu")
    assert tnative.oracle_fit(
        train, np.ones(len(train), np.float32), np.zeros(301, np.int32),
        np.zeros(0, np.int32), np.zeros((300, 1), np.float32),
        np.zeros((200, 1), np.float32), {}, 0.01, 0.1, 0.1, "constant",
        0.25, 10, 1, 1492) is None
    with pytest.raises(RuntimeError, match="fake g\\+\\+ refuses"):
        tpc.oracle_metrics(m, train, test, epochs=1)


def test_get_oracle_from_many_threads_at_once(tmp_path, monkeypatch):
    """Threads that ask for the oracle while the first one builds it all
    get the library: none sees the attempt begun and its result unset."""
    import sys
    import threading

    if tnative.get_oracle() is None:
        pytest.skip("no C++ toolchain for the sequential oracle")
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_oracle_lib", None)
    monkeypatch.setattr(tnative, "_oracle_tried", False)
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        start = threading.Barrier(8)
        got = []

        def ask():
            start.wait()
            got.append(tnative.get_oracle())

        threads = [threading.Thread(target=ask) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert len(got) == 8 and all(lib is not None for lib in got), got
    assert len({id(lib) for lib in got}) == 1


def test_cases_mirror_the_jax_parity_tests():
    """The configurations the card runs are the JAX package's TPU-gated
    ones: the scaled parametrization, the gates and the ML-1M headline."""
    import test_parity as jp

    mark, = [m for m in jp.test_scaled_parity_vs_cpp_oracle.pytestmark
             if m.name == "parametrize"]
    assert tuple(mark.args[1]) == tpc.SCALED_CONFIGS
    assert (tpc.METRICS, tpc.TIGHT, tpc.FUSED) == (jp.METRICS, jp.TIGHT,
                                                   jp.FUSED)
    assert [c.name for c in tpc.SCALED] == [
        "warp-candidate-weights", "warp-candidate-features", "bpr-candidate",
        "warp-auto-weights", "warp-auto-features"]
    for c in tpc.SCALED:
        assert c.epochs == 10 and c.model["seed"] == 1492
        assert ("use_fused" in c.model) == ("candidate" in c.name)
    assert tpc.MIXED_LARGE.epochs == 18 and tpc.MIXED_LARGE.gates == {
        m: 0.03 for m in tpc.METRICS}
    for seed in tpc.ML1M_SEEDS:
        case = tpc.ml1m_headline(seed)
        assert case.epochs == 20 and case.gates == tpc.FUSED
        assert case.oracle_hr == (0.75, 0.95) and case.model["seed"] == seed


def test_gate_failures():
    case = tpc.ml1m_headline(7)
    oracle = dict.fromkeys(tpc.METRICS, 0.5) | {"hit_rate": 0.8}
    assert tpc.gate_failures(case, dict(oracle), oracle) == []
    build = dict(oracle, precision=0.5 - 0.021, hit_rate=0.8 + 0.029)
    bad = tpc.gate_failures(case, build, oracle)
    assert len(bad) == 1 and bad[0].startswith("precision -0.0210")
    assert tpc.gate_failures(case, oracle | {"hit_rate": 0.96},
                             oracle | {"hit_rate": 0.96})[0].startswith(
        "oracle hit_rate 0.9600")


def test_mixed_large_catalog_plan_equals_jax_plan():
    """The large-catalog case plans as the JAX package plans it on a TPU:
    8 window blocks (8,172 items reach the training split), fused, the last
    3 of 18 epochs at the chunk-tail layout."""
    import dataclasses

    from rankfm_tpu.models import planner as jplanner
    from rankfm_tpu_torch.models import planner as tplanner

    train, _, _ = tpc.MIXED_LARGE.data()
    cfg = tpc.MIXED_LARGE.model
    spec = dict(n=len(train), num_users=len(np.unique(train[:, 0])),
                num_items=len(np.unique(train[:, 1])),
                factors=cfg["factors"], loss=cfg["loss"],
                max_samples=cfg["max_samples"], epochs=tpc.MIXED_LARGE.epochs,
                nnz_hist=len(np.unique(train, axis=0)))
    got = tplanner.plan_fit(tplanner.FitSpec(on_gpu=True, **spec))
    want = jplanner.plan_fit(jplanner.FitSpec(on_tpu=True, **spec))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert spec["num_items"] == 8172 and got.nblk == 8
    assert got.fused and (got.n_main, got.n_tail, got.chunk_tail) == (18, 0, 3)
