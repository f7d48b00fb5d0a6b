"""Whole fits through the port's XLA window step (``use_fused=False``),
with and without side features, against the C++ sequential oracle, inside
its quality band (`torch_common`), and each against the JAX package's own
window-step fit from the same initial weights.

The window step sits below the oracle in the JAX package too: over model
seeds 100-119 its fits of this config sit -0.037 hit rate and -0.040 DCG
from the oracle (sd 0.021 and 0.015), the port's -0.033 / -0.041 with
its counter-based draws and -0.035 / -0.041 with the per-epoch CPU
generators it had before; one fit is inside the band at 65-75% of the
seeds in all three. So one fit's place in the band is a draw (the port's
at seed 1492 lies at -0.063 DCG with the counter-based draws, -0.025 with
the earlier ones; the JAX package's at -0.046), and the band is held by
the mean deltas over the three model seeds of the card's quality gate
(`chip_smoke.py` phase 12), each fit against the oracle from its own
initial weights. Each fit is held on its own against the JAX package's
window fit at its seed: a fault of the port at one seed shows there.
"""

import numpy as np

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu import evaluation as jeval
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import evaluation as teval

from parity_common import make_features, oracle_metrics
from torch_common import (CFG, METRICS, assert_in_band,  # noqa: F401
                          data_and_oracle, one_torch_thread)

SEEDS = (1492, 7, 23)


def _mean_deltas_in_band(fit, train, test, want_1492, **features):
    """Fit at each of `SEEDS` (``fit(seed)``): hold each fit against the
    JAX package's window-step fit from the same initial weights, inside
    the band, and the mean of the five metrics against the mean of the
    oracle's from the same initial weights (``want_1492``: the oracle at
    seed 1492, already computed), inside the band."""
    got, want = [], []
    for seed in SEEDS:
        tm = fit(seed)
        got.append(teval.compute(tm, test, metrics=METRICS, k=10))
        want.append(want_1492 if seed == 1492 else oracle_metrics(
            JaxRankFM(**CFG, seed=seed), train, test, epochs=10, **features))
        ref = jeval.compute(JaxRankFM(**CFG, seed=seed, use_fused=False).fit(
            train, epochs=10, **features), test, metrics=METRICS, k=10)
        print(f"seed {seed}: port - oracle",
              {m: round(got[-1][m] - want[-1][m], 4) for m in METRICS},
              "JAX package - oracle",
              {m: round(ref[m] - want[-1][m], 4) for m in METRICS})
        assert_in_band(got[-1], ref)

    def mean(rows):
        return {m: float(np.mean([r[m] for r in rows])) for m in METRICS}

    assert_in_band(mean(got), mean(want))


def test_window_fit_quality_matches_sequential_oracle(data_and_oracle):
    """``use_fused=False`` at 3 window blocks: the window step at batch
    8,192, every epoch."""
    train, test, want = data_and_oracle

    def fit(seed):
        tm = TorchRankFM(**CFG, seed=seed, use_fused=False,
                         device="cpu").fit(train, epochs=10)
        plan = tm.last_fit_plan_
        assert not plan.fused and plan.step_kind == "window"
        assert plan.xla_batch == 8192 and plan.n_main == 10
        lls = [r["log_likelihood"] for r in tm.training_log_]
        assert len(lls) == 10 and np.isfinite(lls).all() and lls[-1] > lls[0]
        return tm

    _mean_deltas_in_band(fit, train, test, want)


def test_featured_window_fit_quality_matches_sequential_oracle(
        data_and_oracle):
    """Side features on the XLA engines (``use_fused=False``): user and
    item one-hot features, the window step, against the oracle fit with
    the same features."""
    train, test, _ = data_and_oracle
    uf, itf = make_features(np.random.default_rng(3), train)

    def fit(seed):
        tm = TorchRankFM(**CFG, seed=seed, use_fused=False,
                         device="cpu").fit(
            train, user_features=uf, item_features=itf, epochs=10)
        assert tm.last_fit_plan_.step_kind == "window"
        for k in ("w_if", "v_uf", "v_if"):
            assert np.abs(tm._weights[k]).max() > 0
        return tm

    want = oracle_metrics(JaxRankFM(**CFG), train, test, epochs=10,
                          user_features=uf, item_features=itf)
    _mean_deltas_in_band(fit, train, test, want, user_features=uf,
                         item_features=itf)
