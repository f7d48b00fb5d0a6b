"""Readings behind a cell's limits, in one process.

    python3 fmbench/proof.py --workload <cell> --seconds <s> \
        --seeds 1 2 ... [--controls bf16 unchanged half token] \
        [--control-seeds 7 8 9] [--out <file.jsonl>]

With ``--rates`` (a served cell) it first runs the window once at each
offered rate and prints the rate served, the latencies and how late the
last request started: the sweep that finds the highest rate the system
sustains. For each of ``--seeds`` it runs the cell as `run.py` does (set-up, a window
of ``--seconds``, the judge) and prints the numbers compared with their
readings; for each of ``--controls`` and ``--control-seeds`` it puts the
kind's control or planted fault in the program's place
(``kinds/<kind>.py``'s ``control``) and prints the same numbers. The lower
reading of a number is the largest over the program's seeds, the upper the
smallest over a control's; `PERF.md` keeps both with the limit set between.
Needs a CUDA card, as the benchmark does.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402

from fmbench import harness  # noqa: E402


def main(argv):
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="*", default=[])
    p.add_argument("--controls", nargs="*", default=[])
    p.add_argument("--control-seeds", type=int, nargs="*", default=[])
    p.add_argument("--rates", type=float, nargs="*", default=[])
    p.add_argument("--device", default="cuda")
    p.add_argument("--out")
    args = p.parse_args(argv)
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        print("proof: no CUDA device", file=sys.stderr)
        return 2
    cell = harness.Cell(harness.load_json(ROOT / "BENCHMARK.json"),
                        args.workload)
    out = open(args.out, "a") if args.out else None

    def emit(rec):
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()

    card = harness.card_line() if args.device == "cuda" else None
    for rate in args.rates:
        run = harness.Run(cell, 1, args.seconds, args.device)
        run.traffic = dict(cell.traffic, rate_per_s=rate)
        state = cell.kind.setup(run)
        rec = cell.kind.window(run, state)
        lat = rec["latency_s"]
        emit({"cell": cell.name, "role": "sweep", "rate_per_s": rate,
              "served_per_s": len(lat) / rec["wall_s"],
              "p50_ms": 1e3 * float(np.percentile(lat, 50)),
              "p95_ms": 1e3 * float(np.percentile(lat, 95)),
              "last_late_ms": 1e3 * float(rec["late_s"][-1]),
              "card": card})
        del state
    for seed in args.seeds:
        t0 = time.time()
        res = harness.run_cell(cell, seed, args.seconds, False, args.device,
                               t0, card)
        emit({"cell": cell.name, "role": "program", "seed": seed,
              "values": {k: c["value"] for k, c in res["checks"].items()},
              "correct": res["correct"], "metrics": res["metrics"],
              "attempted": res["attempted"], "card": card,
              "seconds_all": time.time() - t0})
    for what in args.controls:
        for seed in args.control_seeds:
            t0 = time.time()
            run = harness.Run(cell, seed, args.seconds, args.device)
            values = cell.kind.control(run, what)
            for line in getattr(run, "readings", ()):
                print(line, file=sys.stderr)
            emit({"cell": cell.name, "role": what, "seed": seed,
                  "values": values, "card": card,
                  "seconds_all": time.time() - t0})
    if out:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
