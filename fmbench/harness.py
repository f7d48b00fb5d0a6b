"""One run of one cell: find its pieces by name, set up, measure the window,
judge what the window produced, and print the result line.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name that `BENCHMARK.json` gives it:

- ``configs/<config>.json``: the model's hyperparameters, its job (epochs),
  its data shape, ``source``, ``assumed`` and ``reduced``;
- ``makers/<maker>.py``: the data maker that a configuration's ``data``
  group names, with ``make(rng, spec)``;
- ``traffic/<traffic>.json``: a traffic mix, the parameters of one
  ``kind`` (``kinds/<kind>.py``, which sets up, drives the window and judges
  its outputs against the reference in ``reference/``);
- ``limits/<cell>.json``: each number the judge compares, with its limit;
- ``metrics/<metric>.py``: a reader with ``read(run)`` that returns the
  metric's value, or None when the run holds nothing to read.

So a later change adds a configuration, a data shape, a mix, a cell or a
metric by adding files and entries, and edits none. The counts of work and
the card's peaks that metric readers divide by are in ``counts.py``.
"""

from __future__ import annotations

import argparse
import gc
import hashlib
import importlib.util
import json
import math
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
# top-level modules that no run may load: JAX and the JAX package (names
# compared whole: the port's name begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "rankfm_tpu")


class Refused(Exception):
    """The run cannot be made here (no card, too few cards, a JAX module
    loaded): exit non-zero and print no result."""


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path):
    """Import the Python file ``path`` under a private module name."""
    path = Path(path).resolve()
    tag = hashlib.sha1(str(path).encode()).hexdigest()[:12]
    name = "fmbench_" + "".join(
        ch if ch.isalnum() else "_" for ch in path.stem) + "_" + tag
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """The pieces of one cell, found by name under ``base`` (the benchmark's
    folder) from the entries of ``spec`` (`BENCHMARK.json`)."""

    def __init__(self, spec, name, base=HERE):
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json "
                             f"(have {sorted(cells)})")
        self.entry = cells[name]
        self.name = name
        self.base = Path(base)
        self.config = load_json(self.base / "configs"
                                / f"{self.entry['config']}.json")
        self.traffic = load_json(self.base / "traffic"
                                 / f"{self.entry['traffic']}.json")
        self.kind = load_module(self.base / "kinds"
                                / f"{self.traffic['kind']}.py")
        self.limits = load_json(self.base / "limits" / f"{name}.json")
        self.chips = self.entry["chips"]
        self.end_to_end = [m for m in spec["end_to_end"] if self._has(m)]
        self.per_layer = [m for m in spec["per_layer"] if self._has(m)]

    def _has(self, metric):
        return self.name in metric.get("workloads", [self.name])

    def reader(self, metric):
        return load_module(self.base / "metrics" / f"{metric}.py")


class Run:
    """What a metric reader reads: the cell, the seed, the kind's
    ``record`` of the window, ``trace`` (a `trace.Trace`, traced runs
    only), ``setup_s`` and ``card`` (name and power limit)."""

    def __init__(self, cell, seed, seconds, device):
        # seeds feed numpy's SeedSequence, which takes non-negative words
        self.cell, self.seed, self.seconds = cell, seed % (1 << 64), seconds
        self.device = device
        self.config, self.traffic = cell.config, cell.traffic
        self.record = self.trace = self.setup_s = None
        self.card = None


def card_line():
    """``"<name>, <power limit>"`` from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def forbidden_loaded():
    """The forbidden top-level modules that this process has loaded."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def judge(cell, values):
    """``(correct, checks)``: each number that ``limits/<cell>.json`` names,
    with its value and limit; a number is within its limit when it is no
    greater, and a missing or non-finite number is not."""
    checks, ok = {}, True
    for name, limit in cell.limits.items():
        v = values.get(name)
        v = float("inf") if v is None or not math.isfinite(v) else float(v)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v <= limit
    return ok, checks


def run_cell(cell, seed, seconds, trace_on, device, t_start, card=None):
    """Set up, measure, judge and read one run. Returns the result dict
    (without printing it). ``device`` is a torch device string; the checks
    for a card are the caller's."""
    import torch

    from fmbench import trace as trace_mod

    run = Run(cell, seed, seconds, device)
    run.card = card
    on_cuda = torch.device(device).type == "cuda"
    state = cell.kind.setup(run)
    # what set-up made stays: the window's collections skip it
    gc.collect()
    gc.freeze()
    if on_cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.time() - t_start
    with trace_mod.profiled(trace_on) as held:
        run.record = cell.kind.window(run, state)
    if trace_on:
        run.trace = trace_mod.Trace(held.prof)
        del held.prof
    memory_peak = torch.cuda.max_memory_allocated() if on_cuda else 0
    found = forbidden_loaded()
    if found:
        raise Refused(f"loaded in the window: {', '.join(found)}")
    values = cell.kind.judge(run, state)
    for line in state.get("readings", ()):
        print(line, file=sys.stderr)
    correct, checks = judge(cell, values)
    failed = run.record["failed"]
    correct = correct and failed == 0
    metrics = {}
    for m in (cell.per_layer if trace_on else cell.end_to_end):
        v = run.setup_s if m["name"] == "setup_s" else cell.reader(
            m["name"]).read(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_cuda else "cpu",
           "kind": torch.cuda.get_device_name() if on_cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(memory_peak)}
    out = {"correct": bool(correct), "attempted": run.record["attempted"],
           "failed": failed, "metrics": metrics, "device": dev}
    if trace_on:
        t = run.trace
        dev["busy_s"] = t.busy_s()
        dev["window_s"] = t.window_s
        out["breakdown"] = {"device_ops": t.device_ops(),
                            "idle_gaps": t.idle_gaps()}
    out["card"] = run.card
    out["checks"] = checks
    return out


def parse(argv):
    p = argparse.ArgumentParser(description=(
        "Run one cell of BENCHMARK.json once and print its result as the "
        "last line of standard output."))
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start):
    args = parse(argv)
    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    try:
        import torch
        if not torch.cuda.is_available():
            raise Refused("no CUDA device: this benchmark runs only on a "
                          "card, never on the CPU")
        if torch.cuda.device_count() < cell.chips:
            raise Refused(f"{cell.name} needs {cell.chips} cards, "
                          f"{torch.cuda.device_count()} present")
        card = card_line()
        print(f"card: {card}", file=sys.stderr, flush=True)
        out = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                       "cuda", t_start, card)
        found = forbidden_loaded()
        if found:
            raise Refused(f"loaded: {', '.join(found)}")
    except Refused as e:
        print(f"fmbench: refused: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0
