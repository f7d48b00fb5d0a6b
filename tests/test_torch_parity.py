"""Metric-level learning parity on the card: the port's fits on
``device='cuda'`` against the port's C++ sequential reference-semantics
oracle, under the JAX package's own gates.

The counterpart of the JAX package's TPU-gated tests
(`tests/test_parity.py:168-262`): the five scaled configs (2,400 x 1,200,
10 epochs; `TIGHT` for the candidate step, `FUSED` for the fused path), the
mixed large catalog (2,000 x 10,000, 18 epochs, +-0.03), and the full
ML-1M headline (6,040 x 3,706, 20 epochs, the auto plan: fused with a
3-epoch chunk-tail) under `FUSED` at three model seeds. The
configurations, gates and harness are `tests/torch_parity_common.py`'s.
Beyond the JAX package's suite: the same headline at seven more model
seeds; its first epoch through the kernel against the plain version on
the CPU; and the hit rate after each epoch of one fit, which must hold
steady over the last ten epochs (the batch-deal fault of `PERF.md`
§6).

Marked ``cuda`` and ``slow``; they skip without a card. This file imports
no JAX; on the GPU machine:

    python -m pytest tests/test_torch_parity.py -m "cuda and slow" --noconftest
"""

import pytest
import torch

import torch_parity_common as tpc
from rankfm_tpu_torch import native


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    if native.get_oracle() is None:
        pytest.fail("the sequential oracle did not build: "
                    f"{native.oracle_build_error}")
    torch.backends.cuda.matmul.allow_tf32 = False


def _check(case):
    from rankfm_tpu_torch import RankFM, evaluation

    train, test, kw = case.data()
    model = RankFM(**case.model, device="cuda").fit(
        train, epochs=case.epochs, **kw)
    build = evaluation.compute(model, test, k=10)
    oracle = tpc.oracle_metrics(model, train, test, epochs=case.epochs, **kw)
    print(case.name, "port - oracle:", tpc.deltas(build, oracle))
    assert not tpc.gate_failures(case, build, oracle), (
        tpc.gate_failures(case, build, oracle))
    return model.last_fit_plan_


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("case", tpc.SCALED, ids=lambda c: c.name)
def test_scaled_parity_vs_cpp_oracle(cuda, case):
    plan = _check(case)
    assert plan.fused == ("use_fused" not in case.model)


@pytest.mark.cuda
@pytest.mark.slow
def test_scaled_parity_mixed_large_catalog(cuda):
    plan = _check(tpc.MIXED_LARGE)
    # 8,172 of the 10,000 items reach the training split: 8 window blocks,
    # so the plan is fused with a chunk-tail (the JAX package's too:
    # test_torch_oracle.py::test_mixed_large_catalog_plan_equals_jax_plan)
    assert plan.fused and plan.chunk_tail == 3


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("seed", tpc.ML1M_SEEDS)
def test_full_ml1m_scale_parity_headline_config(cuda, seed):
    plan = _check(tpc.ml1m_headline(seed))
    assert plan.fused and plan.chunk_tail == 3


@pytest.mark.cuda
@pytest.mark.slow
@pytest.mark.parametrize("seed", tpc.ML1M_MORE_SEEDS)
def test_full_ml1m_scale_parity_more_seeds(cuda, seed):
    plan = _check(tpc.ml1m_headline(seed))
    assert plan.fused and plan.chunk_tail == 3


@pytest.mark.cuda
@pytest.mark.slow
def test_ml1m_headline_first_epoch_card_vs_cpu(cuda):
    """One epoch of the ML-1M headline at seed 1492 through the kernel and
    through the plain version on the CPU (same draws): the plans and the
    epoch log-likelihoods agree; the tables are reported, not gated. A
    selection that flips on a near-tie (0.1% of rows per batch, the
    kernel's tolerance against the plain version) sends the two fits apart
    within an epoch at this size, so their tables are no test of the
    kernel here; `tests/test_torch_cuda.py` holds them at a small size."""
    import numpy as np

    from rankfm_tpu_torch import RankFM

    case = tpc.ml1m_headline(1492)
    train, _, _ = case.data()
    mg = RankFM(**case.model, device="cuda").fit(train, epochs=1)
    mc = RankFM(**case.model, device="cpu").fit(train, epochs=1)
    assert mg.last_fit_plan_ == mc.last_fit_plan_
    for k in ("w_i", "v_u", "v_i"):
        want = mc._weights[k]
        err = float(np.abs(mg._weights[k] - want).max())
        print(f"{k}: max |card - cpu| {err:.4g}, "
              f"{err / float(np.abs(want).max()):.4g} of the largest entry")
    lg, lc = (m.training_log_[0]["log_likelihood"] for m in (mg, mc))
    print(f"epoch ll: card {lg}, cpu {lc}")
    assert abs(lg - lc) <= 1e-4 * abs(lc)


# the hit rate after each of the last ten epochs may range over at most
# this much (the traces with the port's deal: `PERF.md` §6)
EPOCH_HR_RANGE = 0.03


@pytest.mark.cuda
@pytest.mark.slow
def test_ml1m_headline_quality_holds_steady_across_epochs(cuda, monkeypatch):
    """The ML-1M headline at seed 1492, its hit rate and DCG read after
    every epoch (a probe model takes the tables each epoch left): with the
    port's deal of chunks to batches (`fused.deal_by_fraction`) the hit
    rate holds steady over the last ten epochs. The same fit on the JAX
    package's deal (by rank in the group) is traced beside it, reported
    and not gated: it swings with the offset at which each epoch stops."""
    import rankfm_tpu_torch.models.rankfm as rankfm_mod
    from rankfm_tpu_torch import RankFM, evaluation
    from rankfm_tpu_torch.ops import fused

    case = tpc.ml1m_headline(1492)
    train, test, _ = case.data()
    probe = RankFM(**case.model, device="cuda")
    probe._init_all(train)
    probe.is_fit = True
    U, I, F = len(probe.user_idx), len(probe.item_idx), case.model["factors"]
    trace = []
    make = rankfm_mod.make_fused_dp_epoch_fn

    def traced(*args, **kw):
        epoch_fn = make(*args, **kw)

        def run(tab_u, tab_i, *a, **k):
            ll = epoch_fn(tab_u, tab_i, *a, **k)
            w_i, v_u, v_i = fused.extract_tables(tab_u, tab_i, U, I, F)
            probe._w = dict(probe._w, w_i=w_i.clone(), v_u=v_u.clone(),
                            v_i=v_i.clone())
            trace.append(evaluation.compute(
                probe, test, metrics=("hit_rate",
                                      "discounted_cumulative_gain"), k=10))
            return ll
        return run

    monkeypatch.setattr(rankfm_mod, "make_fused_dp_epoch_fn", traced)
    oracle = tpc.oracle_metrics(probe, train, test, epochs=case.epochs)
    hr = {}
    for deal in ("by fraction", "by rank (the JAX package's)"):
        if deal.startswith("by rank"):
            monkeypatch.setattr(fused, "deal_by_fraction",
                                lambda layout, *a, **k: layout)
        trace.clear()
        model = RankFM(**case.model, device="cuda").fit(
            train, epochs=case.epochs)
        hr[deal] = [t["hit_rate"] for t in trace]
        d = tpc.deltas(evaluation.compute(model, test, k=10), oracle)
        print(f"deal {deal}: hit rate after each epoch",
              [round(h, 4) for h in hr[deal]], "dcg",
              [round(t["discounted_cumulative_gain"], 4) for t in trace])
        print(f"deal {deal}: range over the last ten epochs "
              f"{max(hr[deal][-10:]) - min(hr[deal][-10:]):.4f}; "
              f"port - oracle {d}")
        assert len(trace) == case.epochs
        assert hr[deal][-1] == evaluation.hit_rate(model, test, k=10)
    last = hr["by fraction"][-10:]
    assert max(last) - min(last) <= EPOCH_HR_RANGE, hr
