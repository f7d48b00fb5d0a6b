"""On the card: the harness's run at `tiny`'s size comes out correct on the
GPU path (the program's kernels, the reference's graph-replayed fit), and
the control of the served cells, TF32 scoring in the program's place, comes
out not correct at the cells' own size. Each test looks for the card inside
itself and skips without one.

    python -m pytest fmbench/tests -m cuda
"""

import time

import pytest
import torch

import tiny

from fmbench import harness


def need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ml1m.fit", "instacart.fit", "ml1m.serve"])
def test_tiny_run_on_the_card_is_correct(tmp_path, cell):
    need_card()
    spec, base = tiny.bench(tmp_path)
    c = harness.Cell(spec, cell, base=base)
    out = harness.run_cell(c, 2147483649, 1.0, False, "cuda", time.time())
    assert out["device"]["platform"] == "gpu"
    assert out["correct"], out["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["ml1m.serve", "instacart.serve"])
def test_tf32_control_is_not_correct(cell):
    need_card()
    c = harness.Cell(harness.load_json(tiny.ROOT / "BENCHMARK.json"), cell)
    values = c.kind.control(harness.Run(c, 271, 3.0, "cuda"), "tf32")
    ok, checks = harness.judge(c, values)
    assert not ok, checks
