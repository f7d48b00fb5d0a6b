"""`fmbench.spans` and the three readers of the program's spans
(``fit.host_idle_ms``, ``graph.capture_ms``, ``serve.host_ms``): exact
sweeps on synthetic traces, None where the program records no span, and
a tiny traced run on the CPU in which each reads a number."""

from types import SimpleNamespace

import numpy as np
import pytest

import tiny
from fmbench import harness
from fmbench.spans import Spans, complement


def reader(name):
    return harness.load_module(tiny.ROOT / "fmbench" / "metrics"
                               / f"{name}.py")


def trace(host_ops, kernels, window=(0, 100)):
    return SimpleNamespace(host_ops=host_ops, kernels=kernels,
                           window_ns=window)


def covered(intervals, n):
    """The integer points of ``[0, n)`` that the intervals cover."""
    m = np.zeros(n, bool)
    for a, b in intervals:
        m[a:b] = True
    return m


@pytest.mark.parametrize("seed", range(5))
def test_idle_time_agrees_with_counting_points(seed):
    rng = np.random.default_rng(seed)

    def disjoint():
        cuts = np.sort(rng.choice(200, 2 * int(rng.integers(0, 12)),
                                  replace=False))
        return [[int(a), int(b)] for a, b in cuts.reshape(-1, 2)]

    busy, xs = disjoint(), disjoint()
    lo, hi = sorted(rng.choice(200, 2, replace=False).tolist())
    sp = Spans(trace([], [("k", a, b) for a, b in busy], (lo, hi)))
    idle = ~covered(busy, 200)
    idle[:lo] = idle[hi:] = False
    assert (covered(sp.idle, 200) == idle).all()
    assert sp.idle_in(xs) == (covered(xs, 200) & idle).sum()
    assert (covered(complement(xs, lo, hi), 200)
            == ~covered(xs, 200) & covered([[lo, hi]], 200)).all()


def test_a_gap_deep_inside_a_long_span_is_counted():
    # a capture's recording holds thousands of host operations; the gap
    # at its end lies after 200 of them
    ops = [("rankfm.graph.record", 0, 10_000)]
    ops += [("aten::add", 10 * i, 10 * i + 5) for i in range(1, 201)]
    ops += [("rankfm.fit", 0, 10_000), ("aten::sum", 9_100, 9_200)]
    kernels = [("k", 0, 9_000), ("k", 9_500, 10_000)]
    sp = Spans(trace(ops, kernels, (0, 10_000)))
    assert sp.idle_ns("rankfm.graph.record") == 500
    assert sp.idle_ns("rankfm.fit") == 500
    # spans with equal intervals nest, in the order of their names
    assert sp.name[sp.kids[0][0]] == "rankfm.graph.record"


def test_self_time_of_nested_spans():
    ops = [("rankfm.fit", 0, 100), ("rankfm.fit.ingest", 0, 10),
           ("rankfm.fit.prep", 10, 40), ("rankfm.fit.layout", 15, 35),
           ("rankfm.fit.epochs.fused", 40, 90), ("aten::mm", 50, 60),
           ("fmbench.fit", 0, 100)]
    kernels = [("k", 45, 70), ("k", 60, 85)]
    sp = Spans(trace(ops, kernels))
    fit = sp.find("rankfm.fit")[0]
    assert [sp.name[k] for k in sp.kids[fit]] == [
        "rankfm.fit.ingest", "rankfm.fit.prep", "rankfm.fit.epochs.fused"]
    assert [sp.name[k] for k in sp.kids[sp.find("rankfm.fit.prep")[0]]] \
        == ["rankfm.fit.layout"]
    assert sp.by_self() == {
        "rankfm.fit": (10, 10), "rankfm.fit.ingest": (10, 10),
        "rankfm.fit.prep": (10, 10), "rankfm.fit.layout": (20, 20),
        "rankfm.fit.epochs.fused": (50, 10)}
    assert sp.idle_ns("rankfm.fit") == 60
    assert sum(v[1] for v in sp.by_self().values()) == 60
    assert sp.kids_ns(fit) == 90
    assert sp.kids_ns(fit, "rankfm.fit.prep") == 30


def test_spans_are_clipped_to_the_window():
    ops = [("rankfm.fit", -50, 50), ("rankfm.fit", 80, 150)]
    sp = Spans(trace(ops, []))
    assert sp.union("rankfm.fit") == [[0, 50], [80, 100]]
    assert sp.idle_ns("rankfm.fit") == 70


def test_no_program_span_reads_none():
    # the trace of a program that records no span of its own
    ops = [("fmbench.fit", 0, 100), ("aten::add", 10, 20)]
    run = SimpleNamespace(trace=trace(ops, [("k", 30, 40)]),
                          record={"fits": [{}], "latency_s": [0.002]})
    for name in ("fit.host_idle_ms", "graph.capture_ms", "serve.host_ms"):
        assert reader(name).read(run) is None
        assert reader(name).read(SimpleNamespace(
            trace=None, record=run.record)) is None


def test_fit_readers_per_fit():
    ops = [("rankfm.fit", 0, 40), ("rankfm.graph.capture", 5, 25),
           ("rankfm.graph.drain", 5, 10), ("rankfm.fit", 50, 100)]
    kernels = [("k", 0, 8), ("k", 20, 30), ("k", 60, 90)]
    run = SimpleNamespace(trace=trace(ops, kernels),
                          record={"fits": [{}, {}]})
    # idle inside the fits: 8-20, 30-40, 50-60, 90-100
    assert reader("fit.host_idle_ms").read(run) == 42 / 1e6 / 2
    # inside the capture: 8-20 (the drain's 8-10 included)
    assert reader("graph.capture_ms").read(run) == 12 / 1e6 / 2
    run.trace.host_ops = [r for r in ops if r[0] == "rankfm.fit"]
    assert reader("graph.capture_ms").read(run) == 0


def test_serve_host_ms_leaves_out_the_wait_for_the_device():
    ops = []
    for t, sync in ((0, 3), (20, 5), (40, 0)):
        ops += [("rankfm.recommend", t, t + 10),
                ("rankfm.recommend.ids", t, t + 1),
                ("rankfm.recommend.score", t + 1, t + 4)]
        if sync:
            ops.append(("rankfm.recommend.sync", t + 4, t + 4 + sync))
    run = SimpleNamespace(trace=trace(ops, []),
                          record={"latency_s": np.ones(3)})
    # 10 - 3, 10 - 5, 10 - 0
    assert reader("serve.host_ms").read(run) == 7 / 1e6


@pytest.mark.parametrize("cell,metrics", [
    ("ml1m.fit", ("fit.host_idle_ms", "graph.capture_ms")),
    ("ml1m.serve", ("serve.host_ms",))])
def test_tiny_traced_run_reads_the_program_spans(tmp_path, cell, metrics):
    spec, base = tiny.bench(tmp_path)
    out = tiny.run(spec, base, cell, seconds=0.5, trace=True)
    for name in metrics:
        assert out["metrics"][name]["unit"] == "ms"
        assert out["metrics"][name]["value"] >= 0
    if cell.endswith(".fit"):
        # the CPU runs its epochs eagerly: a fit captures no graph
        assert out["metrics"]["graph.capture_ms"]["value"] == 0
        assert out["metrics"]["fit.host_idle_ms"]["value"] > 0
    else:
        assert out["metrics"]["serve.host_ms"]["value"] > 0
