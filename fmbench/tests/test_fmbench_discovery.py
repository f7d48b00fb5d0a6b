"""A configuration (with a data maker of its own), a traffic mix, a cell
and a per-layer metric are added by dropping files into the benchmark's
folder and entries into its spec: no file that is there is edited."""

import json

import tiny


def add_pieces(spec, base):
    cfg = json.loads((base / "configs" / "ml1m.json").read_text())
    cfg["model"]["factors"] = 8
    cfg["data"] = {"maker": "uniform", "users": 80, "items": 60,
                   "interactions": 3000, "train_share": 0.8}
    (base / "makers" / "uniform.py").write_text(
        '"""Uniform users and items."""\n\n\n'
        "def make(rng, spec):\n"
        "    n = spec['interactions']\n"
        "    u = rng.integers(0, spec['users'], n)\n"
        "    i = rng.integers(0, spec['items'], n)\n"
        "    pairs = __import__('numpy').stack([u, i], 1)\n"
        "    return pairs, None, None\n")
    (base / "configs" / "ml1m_f8.json").write_text(json.dumps(cfg))
    (base / "traffic" / "fit_pairs.json").write_text(
        json.dumps({"kind": "fit_loop", "judged_fits": 2}))
    (base / "limits" / "ml1m_f8.fit.json").write_text(
        (base / "limits" / "ml1m.fit.json").read_text())
    (base / "metrics" / "fit.count.py").write_text(
        '"""``fit.count``: whole fits in the window."""\n\n\n'
        "def read(run):\n"
        "    fits = run.record.get('fits')\n"
        "    return float(len(fits)) if fits else None\n")
    spec = json.loads(json.dumps(spec))
    spec["configs"].append({"name": "ml1m_f8", "source": "x",
                            "file": "fmbench/configs/ml1m_f8.json",
                            "reduced": ["factors"], "why": "test"})
    spec["workloads"].append({"name": "ml1m_f8.fit", "config": "ml1m_f8",
                              "traffic": "fit_pairs", "chips": 1,
                              "why": "test"})
    for m in spec["end_to_end"]:
        if "workloads" in m and "ml1m.fit" in m["workloads"]:
            m["workloads"].append("ml1m_f8.fit")
    spec["per_layer"].append({"name": "fit.count", "unit": "fits",
                              "better": "higher",
                              "source": "program_counter", "layer": "test",
                              "moves": "train_rows_per_s",
                              "workloads": ["ml1m_f8.fit"]})
    return spec


def test_dropped_in_cell_runs(tmp_path):
    spec, base = tiny.bench(tmp_path)
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    spec = add_pieces(spec, base)
    for p, data in before.items():
        assert p.read_bytes() == data, p
    out = tiny.run(spec, base, "ml1m_f8.fit", seconds=0.5)
    assert set(out["metrics"]) == {"train_rows_per_s", "setup_s"}
    assert set(out["checks"]) >= {"idmap_mismatch", "hr10_gap"}


def test_dropped_in_metric_is_read_in_the_traced_run(tmp_path):
    spec, base = tiny.bench(tmp_path)
    spec = add_pieces(spec, base)
    out = tiny.run(spec, base, "ml1m_f8.fit", seconds=0.5, trace=True)
    assert out["metrics"]["fit.count"]["value"] == out["attempted"]
    assert out["metrics"]["fit.count"]["unit"] == "fits"
    # the other cells do not list it, so they do not report it
    out = tiny.run(spec, base, "ml1m.fit", seconds=0.5, trace=True)
    assert "fit.count" not in out["metrics"]
