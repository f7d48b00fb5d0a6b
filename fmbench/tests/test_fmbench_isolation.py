"""What a run may load and where it may run: no JAX, no JAX package (names
compared whole, since the port's begins with the JAX package's), a
reference that loads nothing of the program, and no result without a
card."""

import json
import os
import subprocess
import sys

from tiny import ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "rankfm_tpu"}
HERE = ROOT / "fmbench" / "tests"


def python(code, env=None):
    e = dict(os.environ, PYTHONPATH=f"{HERE}:{ROOT}", **(env or {}))
    e.pop("JAX_PLATFORMS", None)
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=e, cwd=ROOT, timeout=600)


TOPS = ("import json, sys\n"
        "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")


def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path):
    code = ("import tiny\n"
            f"spec, base = tiny.bench({str(tmp_path)!r})\n"
            "for cell in ('ml1m.fit', 'ml1m.serve'):\n"
            "    tiny.run(spec, base, cell, seconds=0.3, trace=True)\n" + TOPS)
    p = python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert "rankfm_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_the_reference_loads_nothing_of_the_program():
    code = ("import fmbench.reference.fit, fmbench.reference.fitstats\n"
            "import fmbench.reference.serve\n" + TOPS)
    p = python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1]))
    assert not tops & (FORBIDDEN | {"rankfm_tpu_torch"})


def test_the_check_compares_whole_top_level_names():
    code = ("import sys, types\n"
            "from fmbench import harness\n"
            "sys.modules['rankfm_tpu_torch_extra'] = types.ModuleType('x')\n"
            "assert harness.forbidden_loaded() == [], harness.forbidden_loaded()\n"
            "sys.modules['rankfm_tpu.models'] = types.ModuleType('x')\n"
            "sys.modules['jax.numpy'] = types.ModuleType('x')\n"
            "print(harness.forbidden_loaded())\n")
    p = python(code)
    assert p.returncode == 0, p.stderr[-3000:]
    assert p.stdout.strip() == "['jax', 'rankfm_tpu']"


def test_no_card_no_result():
    e = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    p = subprocess.run(
        [sys.executable, "fmbench/run.py", "--workload", "ml1m.serve",
         "--seed", "2147483648", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, env=e, cwd=ROOT, timeout=600)
    assert p.returncode != 0
    assert "refused" in p.stderr
    for line in p.stdout.splitlines():
        assert not line.strip().startswith("{"), line
