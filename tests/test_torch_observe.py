"""`rankfm_tpu_torch.utils.observe` on the CPU."""

import json

import numpy as np
import pytest
import torch

from rankfm_tpu_torch import RankFM
from rankfm_tpu_torch.utils import observe

from torch_common import one_torch_thread  # noqa: F401


def test_device_memory_stats_on_the_cpu_is_empty():
    assert observe.device_memory_stats("cpu") == {}
    assert observe.device_memory_stats(torch.device("cpu")) == {}
    if not torch.cuda.is_available():
        assert observe.device_memory_stats() == {}


def test_trace_writes_a_chrome_trace(tmp_path):
    rng = np.random.default_rng(0)
    train = np.stack([rng.integers(0, 30, 400), rng.integers(0, 50, 400)], 1)
    log_dir = tmp_path / "traces" / "fit"             # created on demand
    with observe.trace(log_dir):
        model = RankFM(factors=4, device="cpu").fit(train, epochs=1)
    assert model.is_fit
    files = list(log_dir.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(e.get("cat") == "cpu_op" for e in events)


def test_trace_is_written_when_the_block_raises(tmp_path):
    try:
        with observe.trace(tmp_path):
            torch.ones(4).sum()
            raise KeyError("boom")
    except KeyError:
        pass
    assert len(list(tmp_path.glob("trace_*.json"))) == 1


# the spans of a fit and of a request (`observe.span`)

def _spans(prof):
    """``[(name, parent name, start us, end us)]`` of the ``rankfm.*``
    ranges a profiler recorded, in the order they opened; the parent is
    the innermost ``rankfm.*`` range around each."""
    out = []
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if not e.name.startswith("rankfm."):
            continue
        p = e.cpu_parent
        while p is not None and not p.name.startswith("rankfm."):
            p = p.cpu_parent
        out.append((e.name, None if p is None else p.name,
                    e.time_range.start, e.time_range.end))
    return out


def _children(spans, parent):
    return [n for n, p, _, _ in spans if p == parent]


def _log(seed=0, users=120, items=200, rows=1500):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, users, rows),
                     rng.integers(0, items, rows)], 1)


@pytest.fixture(scope="module")
def profiled_fits():
    """A fused fit and a ``use_fused=False`` fit on the CPU, each under
    `torch.profiler`: ``{engine: (model, spans)}``."""
    from torch.profiler import ProfilerActivity, profile

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = {}
    try:
        for engine, kw in (("fused", {}), ("xla", {"use_fused": False})):
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                model = RankFM(factors=4, loss="warp", max_samples=5,
                               device="cpu", **kw).fit(_log(), epochs=2)
            out[engine] = (model, _spans(prof))
    finally:
        torch.set_num_threads(n)
    return out


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_a_fit_emits_its_phase_spans(profiled_fits, engine):
    model, spans = profiled_fits[engine]
    plan = model.last_fit_plan_
    assert plan.fused == (engine == "fused")
    assert _children(spans, None) == ["rankfm.fit"]
    if plan.fused:
        segments = ["rankfm.fit.prep", "rankfm.fit.epochs.fused"]
        if plan.chunk_tail:
            segments.append("rankfm.fit.epochs.chunk_tail")
        if plan.n_tail and plan.tail_windows:
            segments.append("rankfm.fit.epochs.wide_tail")
        segments.append("rankfm.fit.pull")
        if plan.n_tail and not plan.tail_windows:
            segments.append("rankfm.fit.epochs.candidate")
        assert _children(spans, "rankfm.fit.prep") == [
            "rankfm.fit.hist_pack", "rankfm.fit.layout"]
    else:
        segments = [f"rankfm.fit.epochs.{plan.step_kind}"]
    assert _children(spans, "rankfm.fit") == (
        ["rankfm.fit.ingest", "rankfm.fit.plan"] + segments
        + ["rankfm.fit.finish"])
    # on the CPU the epochs run eagerly: no graph is captured or replayed
    assert not [n for n, *_ in spans if n.startswith("rankfm.graph.")]


def test_fit_spans_agree_with_last_fit_timing(profiled_fits):
    """The spans of `last_fit_timing_`'s phases open and close at the
    statements that stamp them: equal up to the dict's rounding to 0.01 s
    (and the few microseconds of the stamps)."""
    model, spans = profiled_fits["fused"]
    dur = {n: (b - a) / 1e6 for n, _, a, b in spans}
    tm = model.last_fit_timing_
    assert list(tm) == ["ingest_s", "hist_pack_s", "records_s", "prep_s",
                        "epoch0_call_s", "dispatch_s", "block_s"]
    for key, name in (("ingest_s", "rankfm.fit.ingest"),
                      ("hist_pack_s", "rankfm.fit.hist_pack"),
                      ("prep_s", "rankfm.fit.prep"),
                      ("block_s", "rankfm.fit.finish")):
        assert tm[key] == round(tm[key], 2)
        assert abs(dur[name] - tm[key]) <= 0.005 + 0.002, (key, dur[name])


def test_recommend_emits_a_score_and_a_sync_span_a_chunk(monkeypatch):
    from torch.profiler import ProfilerActivity, profile

    from rankfm_tpu_torch.models import rankfm as rankfm_mod

    model = RankFM(factors=4, device="cpu").fit(_log(1), epochs=1)
    monkeypatch.setattr(rankfm_mod, "_recommend_chunk", lambda items: 50)
    users = np.concatenate([np.arange(120), [1000, 1001]])  # two unknown
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        df = model.recommend(users, n_items=5, filter_previous=True)
    assert df.shape == (122, 5) and df.iloc[-2:].isna().all().all()
    spans = _spans(prof)
    assert _children(spans, None) == ["rankfm.recommend"]
    assert _children(spans, "rankfm.recommend") == (
        ["rankfm.recommend.ids"]
        + ["rankfm.recommend.score", "rankfm.recommend.sync"] * 3
        + ["rankfm.recommend.frame"])
    assert len(spans) == 1 + 1 + 6 + 1


def test_a_span_is_a_shared_no_op_without_a_profiler(monkeypatch):
    """With no profiler recording, `observe.span` enters no
    ``record_function``: a fit and a request open none, and every span is
    one shared null context."""
    from torch.profiler import ProfilerActivity, profile

    entered = []
    real = torch.profiler.record_function

    class Counting(real):
        def __enter__(self):
            entered.append(self.name)
            return super().__enter__()

    monkeypatch.setattr(torch.profiler, "record_function", Counting)
    assert not torch.autograd._profiler_enabled()
    assert observe.span("rankfm.fit") is observe.span("rankfm.recommend")
    assert observe.span("rankfm.fit") is observe._OFF
    model = RankFM(factors=4, device="cpu").fit(_log(2), epochs=1)
    model.recommend(np.arange(10), n_items=3, filter_previous=True)
    assert entered == []
    # the same calls under a profiler enter one range a span
    with profile(activities=[ProfilerActivity.CPU]):
        model.recommend(np.arange(10), n_items=3, filter_previous=True)
    assert entered == ["rankfm.recommend", "rankfm.recommend.ids",
                       "rankfm.recommend.score", "rankfm.recommend.sync",
                       "rankfm.recommend.frame"]


@pytest.mark.parametrize("engine", ["fused", "xla"])
def test_the_history_builds_are_spans(profiled_fits, engine):
    """``rankfm.fit.hist`` holds the device copy of the history CSR in
    ingest and, in an XLA engine's epochs, the build of what its sampler
    reads; ``rankfm.fit.init``, the draw of the initial tables, follows it
    in ingest."""
    model, spans = profiled_fits[engine]
    assert _children(spans, "rankfm.fit.ingest") == [
        "rankfm.fit.hist", "rankfm.fit.init"]
    if model.last_fit_plan_.fused:
        # the fused engine reads the pack built in `.prep`'s `.hist_pack`
        assert "rankfm.fit.hist" not in _children(
            spans, "rankfm.fit.epochs.fused")
    else:
        assert _children(spans, "rankfm.fit.epochs.candidate")[0] == (
            "rankfm.fit.hist")
