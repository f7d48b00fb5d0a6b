"""Whole fits through the port's XLA engines against the C++ sequential
oracle: the mixed schedule (fused epochs, then a candidate-step epoch) and
the candidate step as the main engine, inside the quality band of
`tests/test_torch_slice.py::test_fit_quality_matches_sequential_oracle`
(+-0.05 hit rate and DCG, +-0.03 precision and recall, 600 users x 2,500
items, 10 epochs); the divergence abort and verbose reporting of the XLA
epochs. The oracle takes a JAX model of the same config: its ingest and
initial weights equal the port's. (At this size the XLA steps run 3
batches of 8,192 per epoch; the JAX package's own XLA fits sit as far
from the oracle, e.g. -0.04 hit rate for the candidate step.)
"""

import numpy as np
import pytest

from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import evaluation as teval
from rankfm_tpu_torch.ops import fused as tfused

from torch_common import (CFG, METRICS, assert_in_band,  # noqa: F401
                          data_and_oracle, one_torch_thread)


@pytest.mark.parametrize("kw,fused,n_tail,step_kind", [
    (dict(train_step="mixed"), True, 1, "window"),
    (dict(use_fused=False, train_step="candidate"), False, 0, "candidate"),
    (dict(train_step="mixed", tail_windows=3), True, 1, "window"),
], ids=["mixed", "candidate-step", "mixed-wide-tail"])
def test_fit_quality_matches_sequential_oracle(data_and_oracle, kw, fused,
                                               n_tail, step_kind):
    train, test, want = data_and_oracle
    before = sum(tfused.LAUNCHES.values())
    tm = TorchRankFM(**CFG, **kw, device="cpu").fit(train, epochs=10)
    plan = tm.last_fit_plan_
    assert (plan.fused, plan.n_tail, plan.step_kind) == (fused, n_tail,
                                                         step_kind)
    assert plan.chunk_tail == 0 and plan.n_main + plan.n_tail == 10
    assert plan.tail_windows == kw.get("tail_windows")
    assert sum(tfused.LAUNCHES.values()) == before    # plain versions only
    lls = [r["log_likelihood"] for r in tm.training_log_]
    assert len(lls) == 10 and np.isfinite(lls).all() and lls[-1] > lls[0]
    assert_in_band(teval.compute(tm, test, metrics=METRICS, k=10), want)


@pytest.mark.parametrize("train_step", ["window", "candidate"])
def test_xla_divergence_aborts_early(train_step):
    """A diverging XLA fit raises at (near) the first non-finite epoch, as
    the JAX package's `test_divergence_aborts_early_not_at_fit_end`: the
    guarded ll folds every table's finiteness in, and the lagged poll reads
    it every 4 epochs."""
    rng = np.random.default_rng(0)
    inter = np.stack([rng.integers(0, 50, 2000), rng.integers(0, 40, 2000)], 1)
    sw = np.full(2000, 1e30, dtype=np.float32)  # overflow -> NaN weights
    m = TorchRankFM(factors=4, loss="warp", max_samples=3, learning_rate=0.1,
                    use_fused=False, train_step=train_step, device="cpu")
    with pytest.raises(AssertionError, match="not finite"):
        m.fit(inter, sample_weight=sw, epochs=60)
    assert m.last_fit_plan_.step_kind == train_step
    assert m._abort_epoch < 10, m._abort_epoch
    assert m._abort_detected_at <= m._abort_epoch + 11


def test_xla_fit_verbose_then_fit_partial(capsys):
    """Verbose XLA epochs report the penalized ll each epoch; fit_partial
    continues the epoch stream and the training log."""
    rng = np.random.default_rng(1)
    inter = np.stack([rng.integers(0, 30, 600), rng.integers(0, 300, 600)], 1)
    m = TorchRankFM(factors=4, loss="warp", max_samples=5, use_fused=False,
                    device="cpu")
    m.fit(inter, epochs=2, verbose=True)
    assert capsys.readouterr().out.count("training epoch:") == 2
    w1 = m._weights
    m.fit_partial(inter[:300], epochs=1)
    assert m._epoch_offset == 3 and len(m.training_log_) == 3
    assert np.abs(m._weights["v_i"] - w1["v_i"]).max() > 0
    assert all(np.isfinite(r["log_likelihood"]) for r in m.training_log_)
