"""The cells ``webscale.fit`` (kind ``fit_loop_sparse``) and
``ml1m.refresh`` (kind ``refresh_loop``) on the CPU at `tiny`'s size: a
sound run is correct and reports its metrics, the planted faults and the
control are not correct, and a program without the step counter (an older
version of the port) gives a run without the metrics that read it, and no
error."""

import json

import pytest
import torch

import tiny
from test_fmbench_faults import alter_lists, half, unchanged

from fmbench import harness

NEW_CELLS = ("webscale.fit", "ml1m.refresh")
# the webscale configuration cut to seconds on the CPU: a catalog of some
# ten thousand items, every epoch on the candidate step with the
# binary-search sampler (at this size the planner would take the fused
# engine and the bitmap), in batches of the reference's 128-row chunk, as
# `tiny` sets the other fit cells' batch
WEBSCALE = {"data": {"maker": "webscale", "users": 2000, "items": 70000,
                     "interactions": 40000, "item_power": 2.5,
                     "train_share": 0.8},
            "epochs": 2,
            "model": {"batch_size": 128, "use_fused": False,
                      "train_step": "candidate", "neg_sampler": "bsearch"}}


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    spec, base = tiny.bench(tmp_path_factory.mktemp("bench"))
    p = base / "configs" / "webscale.json"
    cfg = json.loads(p.read_text())
    cfg["data"], cfg["epochs"] = WEBSCALE["data"], WEBSCALE["epochs"]
    cfg["model"].update(WEBSCALE["model"])
    p.write_text(json.dumps(cfg))
    return spec, base


@pytest.mark.parametrize("cell", NEW_CELLS)
def test_sound_run_is_correct(bench, cell):
    spec, base = bench
    out = tiny.run(spec, base, cell, seconds=0.5)
    assert out["correct"], out["checks"]
    assert set(out["metrics"]) == {"train_rows_per_s", "setup_s"}


def test_traced_runs_report_their_metrics(bench):
    spec, base = bench
    out = tiny.run(spec, base, "webscale.fit", seconds=0.5, trace=True)
    assert {"cand.step_us", "graph.capture_ms",
            "fit.host_idle_ms"} <= set(out["metrics"])
    # the CPU runs no B3 kernel: nothing for its roofline to read
    assert "b3_roofline" not in out["metrics"]
    out = tiny.run(spec, base, "ml1m.refresh", seconds=0.5, trace=True)
    assert {"fit.prep_ms", "fit.host_idle_ms", "graph.capture_ms",
            "fit.mfu"} <= set(out["metrics"])


def test_a_program_without_the_step_counter_leaves_the_metrics_out(
        bench, monkeypatch):
    """An older program keeps no ``training.STEPS``: the kind records no
    steps, and the readers of ``cand.step_us`` and ``b3_roofline`` return
    None for such a record."""
    from fmbench import trace as trace_mod
    from rankfm_tpu_torch.ops import training

    spec, base = bench
    c = harness.Cell(spec, "webscale.fit", base=base)
    run = harness.Run(c, 11, 0.5, "cpu")
    state = c.kind.setup(run)
    with trace_mod.profiled(True) as held:
        run.record = c.kind.window(run, state)
    run.trace = trace_mod.Trace(held.prof)
    assert sum(run.record["steps"].values()) > 0
    del run.record["steps"]
    for name in ("cand.step_us", "b3_roofline"):
        assert c.reader(name).read(run) is None
    monkeypatch.delattr(training, "STEPS")
    assert c.kind.steps_counter() is None


@pytest.mark.parametrize("fault", [unchanged, half],
                         ids=["unchanged", "half"])
def test_webscale_fault_is_not_correct(bench, fault, monkeypatch):
    """A fault in the program fails the cell's limits. The token fault (a
    broken id map under the steps) is left out: on the card only
    ``hr10_gap`` saw it, at 2.3 times the sound runs' reading, so the cell
    compares no hit rate."""
    spec, base = bench
    fault(monkeypatch)
    out = tiny.run(spec, base, "webscale.fit", seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", NEW_CELLS)
def test_control_is_not_correct(bench, cell):
    spec, base = bench
    c = harness.Cell(spec, cell, base=base)
    torch.set_num_threads(2)
    values = c.kind.control(harness.Run(c, 23, 0.5, "cpu"), "bf16")
    ok, checks = harness.judge(c, values)
    assert not ok, checks


def test_refresh_with_altered_lists_is_not_correct(bench, monkeypatch):
    """Lists altered where they are produced (each first item replaced by
    its neighbour) move the hit rate a call returns away from the plain one
    of the same tables: ``eval_gap``."""
    spec, base = bench
    alter_lists(monkeypatch, "token")
    out = tiny.run(spec, base, "ml1m.refresh", seconds=0.5)
    assert not out["correct"]
    c = out["checks"]["eval_gap"]
    assert c["value"] > c["limit"], out["checks"]
