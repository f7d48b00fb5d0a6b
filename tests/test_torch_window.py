"""Whole fits through the port's XLA window step (``use_fused=False``),
with and without side features, against the C++ sequential oracle, inside
its quality band (`torch_common`). The JAX package's own window-step fit
of this config sits -0.04 hit rate and -0.046 DCG from the oracle.
"""

import numpy as np

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import evaluation as teval

from parity_common import make_features, oracle_metrics
from torch_common import (CFG, METRICS, assert_in_band,  # noqa: F401
                          data_and_oracle, one_torch_thread)


def test_window_fit_quality_matches_sequential_oracle(data_and_oracle):
    """``use_fused=False`` at 3 window blocks: the window step at batch
    8,192, every epoch."""
    train, test, want = data_and_oracle
    tm = TorchRankFM(**CFG, use_fused=False, device="cpu").fit(train,
                                                              epochs=10)
    plan = tm.last_fit_plan_
    assert not plan.fused and plan.step_kind == "window"
    assert plan.xla_batch == 8192 and plan.n_main == 10
    lls = [r["log_likelihood"] for r in tm.training_log_]
    assert len(lls) == 10 and np.isfinite(lls).all() and lls[-1] > lls[0]
    assert_in_band(teval.compute(tm, test, metrics=METRICS, k=10), want)


def test_featured_window_fit_quality_matches_sequential_oracle(
        data_and_oracle):
    """Side features train on the XLA engines (the fused kernel's feature
    variant is not ported): user and item one-hot features, the window
    step, against the oracle fit with the same features."""
    train, test, _ = data_and_oracle
    uf, itf = make_features(np.random.default_rng(3), train)
    tm = TorchRankFM(**CFG, use_fused=False, device="cpu").fit(
        train, user_features=uf, item_features=itf, epochs=10)
    assert tm.last_fit_plan_.step_kind == "window"
    for k in ("w_if", "v_uf", "v_if"):
        assert np.abs(tm._weights[k]).max() > 0
    want = oracle_metrics(JaxRankFM(**CFG), train, test, epochs=10,
                          user_features=uf, item_features=itf)
    assert_in_band(teval.compute(tm, test, metrics=METRICS, k=10), want)
