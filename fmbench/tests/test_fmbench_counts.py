"""The operation and byte counts behind ``fit.mfu`` and ``b1_roofline``
(`fmbench.counts`, which both read), against figures reckoned by hand at
the ML-1M and Instacart shapes."""

from types import SimpleNamespace

import pytest

from tiny import ROOT

from fmbench import counts, harness

MFU = harness.load_module(ROOT / "fmbench" / "metrics" / "fit.mfu.py")
B1 = harness.load_module(ROOT / "fmbench" / "metrics" / "b1_roofline.py")

ML1M = {"users": 6040, "items": 3706, "rows": 749724, "nnz_hist": 725000,
        "factors": 20, "max_samples": 20, "item_features": 0,
        "if_nnz_per_item": 0.0}
INSTACART = {"users": 10000, "items": 33362, "rows": 552348,
             "nnz_hist": 552348, "factors": 50, "max_samples": 50,
             "item_features": 21, "if_nnz_per_item": 1.0}


def test_flops_per_row_ml1m():
    # 2 F (M + 1) = 2 * 20 * 21 = 840 for the utilities, 6 F = 120 update
    assert counts.flops_per_row(20, 20, 0.0) == 960


def test_flops_per_row_instacart():
    # one department per product doubles the utilities: 2 * 50 * 51 * 2
    assert counts.flops_per_row(50, 50, 1.0) == 10200 + 300


@pytest.mark.parametrize("reader", [MFU, B1], ids=["fit.mfu", "b1_roofline"])
def test_readers_count_with_the_shared_module(reader):
    assert reader.flops_per_row is counts.flops_per_row
    assert reader.PEAK_F32_OPS is counts.PEAK_F32_OPS


def test_b1_bytes_ml1m():
    tables = 2 * 4 * (6040 * 20 + 3706 * 21)            # 1,589,008
    assert tables == 1_589_008
    want = tables + 12 * 749724 + 4 * 725000 + 4 * 6041
    assert want == 13_509_860
    assert counts.bytes_per_epoch(6040, 3706, 20, 0, 749724, 725000) == want


def test_b1_bytes_instacart():
    tables = 2 * 4 * (10000 * 50 + (33362 + 21) * 51)   # 17,620,264
    assert tables == 17_620_264
    want = tables + 12 * 552348 + 4 * 552348 + 4 * 10001
    assert want == 26_497_836
    assert counts.bytes_per_epoch(10000, 33362, 50, 21, 552348, 552348) == want


def test_b1_bound_ml1m_is_operations():
    # 749,724 * 960 operations at 67 TFLOP/s: 10.742 us; 13.5 MB at 3.35
    # TB/s: 4.03 us
    assert B1.bound_s(ML1M, 1) == pytest.approx(749724 * 960 / 67e12)
    assert B1.bound_s(ML1M, 20) == pytest.approx(20 * 10.7423e-6, rel=1e-4)


def test_b1_epochs_by_plan():
    plan = SimpleNamespace
    assert B1.b1_epochs(plan(fused=True, n_main=20, n_tail=0,
                             tail_windows=None)) == 20
    # the candidate tail runs B2 and B3, not B1
    assert B1.b1_epochs(plan(fused=True, n_main=27, n_tail=3,
                             tail_windows=None)) == 27
    # the wide-window tail runs B1
    assert B1.b1_epochs(plan(fused=True, n_main=27, n_tail=3,
                             tail_windows=8)) == 30
    assert B1.b1_epochs(plan(fused=False, n_main=20, n_tail=0,
                             tail_windows=None)) == 0


def test_fit_mfu_reads_the_window():
    fits = [{"plan": None}] * 3
    run = SimpleNamespace(record={"fits": fits, "wall_s": 2.0, "epochs": 20},
                          shape=ML1M, card=None)
    want = 100 * 3 * 20 * 749724 * 960 / 2.0 / 67e12
    assert MFU.read(run) == pytest.approx(want)


def test_readers_read_nothing_from_the_other_kind():
    serve = SimpleNamespace(record={"latency_s": [0.002, 0.003]},
                            trace=None, shape=None, card=None)
    for name in ("fit.mfu", "fit.prep_ms", "fit.idle_share", "b1_roofline",
                 "train_rows_per_s"):
        mod = harness.load_module(ROOT / "fmbench" / "metrics" / f"{name}.py")
        assert mod.read(serve) is None, name
    fit = SimpleNamespace(record={"fits": [], "wall_s": 1.0}, trace=None,
                          shape=ML1M, card=None)
    for name in ("recommend_p50_ms", "serve.idle_share", "serve.device_ms"):
        mod = harness.load_module(ROOT / "fmbench" / "metrics" / f"{name}.py")
        assert mod.read(fit) is None, name
