"""`BENCHMARK.json` against the rules a benchmark file keeps: its keys,
names, units and limits, and a file under ``fmbench/`` for every piece it
names."""

import json
import re

import pytest

from tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
E2E = {"train_rows_per_s", "recommend_p50_ms", "setup_s"}
PER_LAYER = {"fit.prep_ms", "fit.idle_share", "b1_roofline", "fit.mfu",
             "serve.idle_share", "serve.device_ms"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def metrics():
    return SPEC["end_to_end"] + SPEC["per_layer"]


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert SPEC["paths"] == ["fmbench"]
    assert SPEC["command"] == ["python3", "fmbench/run.py"]
    assert isinstance(SPEC["run_seconds"], int)
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_paths_and_command_words():
    for p in SPEC["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert len(SPEC["command"]) <= 32
    for w in SPEC["command"]:
        assert LINE.match(w)


def test_names_are_made_of_allowed_characters():
    names = ([c["name"] for c in SPEC["configs"]]
             + [w["name"] for w in SPEC["workloads"]]
             + [m["name"] for m in metrics()]
             + [w["config"] for w in SPEC["workloads"]]
             + [w["traffic"] for w in SPEC["workloads"]]
             + [k for c in SPEC["configs"] for k in c["reduced"]])
    for n in names:
        assert NAME.match(n), n
    for group in (SPEC["configs"], SPEC["workloads"], metrics()):
        got = [x["name"] for x in group]
        assert len(got) == len(set(got))


def test_units_and_better():
    for m in metrics():
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_the_metrics_the_issue_names():
    assert {m["name"] for m in SPEC["end_to_end"]} == E2E
    assert {m["name"] for m in SPEC["per_layer"]} == PER_LAYER


def test_end_to_end_entries():
    for m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in SPEC["workloads"]}
    for w in cells:
        has = [m["name"] for m in SPEC["end_to_end"]
               if w in m.get("workloads", cells)]
        assert "setup_s" in has and len(has) >= 2, w


def test_per_layer_entries():
    e2e = {m["name"]: m for m in SPEC["end_to_end"]}
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert LINE.match(m["layer"])
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        # every listed cell reports the metric it moves
        for w in m["workloads"]:
            assert w in cells
            assert w in e2e[m["moves"]].get("workloads", cells)
        if m["unit"] == "%" and ("roofline" in m["name"]
                                 or "mfu" in m["name"]):
            assert m["better"] == "higher"
    for w in cells:
        assert any(w in m["workloads"] for m in SPEC["per_layer"]), w


def test_configs_and_cells():
    names = {c["name"] for c in SPEC["configs"]}
    files = [c["file"] for c in SPEC["configs"]]
    assert len(files) == len(set(files))
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"] == f"fmbench/configs/{c['name']}.json"
        body = json.loads((ROOT / c["file"]).read_text())
        assert body["source"] == c["source"]
        assert body["reduced"] == c["reduced"]
        assert LINE.match(c["why"]) and LINE.match(c["source"])
    used = {w["config"] for w in SPEC["workloads"]}
    assert used == names
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
        assert LINE.match(w["why"])


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_piece_of_a_cell_is_a_file(cell):
    w = next(x for x in SPEC["workloads"] if x["name"] == cell)
    base = ROOT / "fmbench"
    mix = json.loads((base / "traffic" / f"{w['traffic']}.json").read_text())
    assert (base / "kinds" / f"{mix['kind']}.py").is_file()
    limits = json.loads((base / "limits" / f"{cell}.json").read_text())
    assert limits and all(v >= 0 for v in limits.values())
    for m in SPEC["per_layer"] + SPEC["end_to_end"]:
        if m["name"] != "setup_s":
            assert (base / "metrics" / f"{m['name']}.py").is_file()


def test_run_seconds_fit_the_check_with_all_cells():
    # 2 + 14 runs a cell, each run_seconds + 60, 2 x 90 s a cell to
    # compile, 1200 s spare, with the full 24 cells
    runs = 2 + 14 * 24
    total = runs * (SPEC["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200
