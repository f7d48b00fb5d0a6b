"""A copy of the benchmark's folder at a size the CPU runs in seconds, for
the harness's own tests: the same kinds, readers, reference and limits,
with each configuration's data cut to some ten thousand rows, its epochs to
six and the program's batch to the reference's 128-row chunk (at this size
the program's own plan would update in batches of a fifth of the data,
which reads far from any chunked fit), and each served mix cut to requests
of 20 users."""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# users enough that a hit rate at 10 reads to about a hundredth
DATA = {"ml1m": {"maker": "ml1m", "users": 2000, "items": 150,
                 "interactions": 40000, "train_share": 0.75},
        "instacart": {"maker": "instacart", "users": 600, "items": 600,
                      "depts": 5, "pairs": 24000, "train_share": 0.678,
                      "sample_weight": "log2_orders_plus_1",
                      "item_features": "department_one_hot"}}
EPOCHS = 6


def bench(tmp_path):
    """``(spec, base)``: `BENCHMARK.json` and a tiny copy of the
    benchmark's folder under ``tmp_path``."""
    base = Path(tmp_path) / "fmbench"
    shutil.copytree(ROOT / "fmbench", base,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    for name, d in DATA.items():
        p = base / "configs" / f"{name}.json"
        cfg = json.loads(p.read_text())
        cfg["data"], cfg["epochs"] = d, EPOCHS
        cfg["model"]["batch_size"] = 128
        p.write_text(json.dumps(cfg))
    for p in (base / "traffic").glob("*.json"):
        mix = json.loads(p.read_text())
        if mix["kind"] == "recommend_open":
            mix.update(rate_per_s=40, users_per_request=20, judged=8,
                       warmup=1)
            p.write_text(json.dumps(mix))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    return spec, base


def run(spec, base, cell, seed=11, seconds=1.0, trace=False):
    """One run of ``cell`` on the CPU, past the harness's look for a card:
    the result dict."""
    import time

    import torch

    from fmbench import harness

    torch.set_num_threads(2)
    c = harness.Cell(spec, cell, base=base)
    return harness.run_cell(c, seed, seconds, trace, "cpu", time.time())
