"""Each cell's run, past the harness's look for a card and with the timed
path broken underneath, comes out not correct: once for each fault the cell
can have (a step that returns its state unchanged, half of each batch left
out, a token or an answer altered where it is produced), and for the
control, the reference in a lower precision in the program's place. The
same runs unbroken come out correct. All on the CPU, at `tiny`'s size."""

import numpy as np
import pytest
import torch

import tiny

from fmbench import harness

FIT_CELLS = ("ml1m.fit", "instacart.fit")
SERVE_CELLS = ("ml1m.serve", "instacart.serve")
VALID_BIT = 1 << 21          # `fused.unpack_record_cols`: bit 21 of column 0


@pytest.fixture(scope="module")
def bench(tmp_path_factory):
    return tiny.bench(tmp_path_factory.mktemp("bench"))


def unchanged(mp):
    """Every training step returns the tables it was given."""
    from rankfm_tpu_torch.ops import fused, training

    orig = fused.fused_batch

    def frozen(tab_u, tab_i, *a, **kw):
        tabs = [tab_u, tab_i] + [kw[k] for k in ("tab_uf", "tab_if")
                                 if kw.get(k) is not None]
        saved = [t.clone() for t in tabs]
        ll = orig(tab_u, tab_i, *a, **kw)
        for t, s in zip(tabs, saved):
            t.copy_(s)
        return ll

    mp.setattr(fused, "fused_batch", frozen)
    mp.setattr(training, "_apply_pair_updates", lambda w, *a, **k: w)


def half(mp):
    """Every step trains on half of its rows."""
    from rankfm_tpu_torch.ops import fused, training

    orig = fused.fused_batch

    def halved(tab_u, tab_i, rec, *a, **kw):
        rec = rec.clone()
        rec[1::2, 0] &= ~VALID_BIT
        return orig(tab_u, tab_i, rec, *a, **kw)

    mp.setattr(fused, "fused_batch", halved)
    for name in ("make_train_step", "make_window_train_step"):
        maker = getattr(training, name)

        def make(*a, _maker=maker, **k):
            step = _maker(*a, **k)

            def apply(w, x_uf, x_if, hist, u, i, sw, valid, *rest):
                keep = (torch.arange(valid.shape[0], device=valid.device)
                        % 2 == 0).to(valid.dtype)
                return step.apply(w, x_uf, x_if, hist, u, i, sw,
                                  valid * keep, *rest)
            return step._replace(apply=apply)

        mp.setattr(training, name, make)


def token_fit(mp):
    """Ingest hands the steps each positive item under another index."""
    from rankfm_tpu_torch import RankFM

    orig = RankFM._native_ingest

    def ingest(self, interactions, prev_csr):
        out = orig(self, interactions, prev_csr)
        pairs, keep, offsets, items = out
        n = len(self.item_idx)
        perm = np.random.default_rng(0).permutation(n).astype(pairs.dtype)
        pairs = pairs.copy()
        pairs[:, 1] = perm[pairs[:, 1]]
        return pairs, keep, offsets, items

    mp.setattr(RankFM, "_native_ingest", ingest)


def alter_lists(mp, how):
    """Top-k lists altered where they are produced: ``"token"`` replaces
    each list's first item by its neighbour, ``"half"`` leaves every other
    user without a list."""
    from rankfm_tpu_torch.ops import topk

    for name in ("topk_bitmap", "topk_for_users"):
        orig = getattr(topk, name)

        def wrapped(w, *a, _orig=orig, **k):
            items, scores = _orig(w, *a, **k)
            items = items.clone()
            if how == "token":
                items[:, 0] = (items[:, 0] + 1) % w["w_i"].shape[0]
            else:
                items[1::2] = -1
            return items, scores

        mp.setattr(topk, name, wrapped)


@pytest.mark.parametrize("cell", FIT_CELLS + SERVE_CELLS)
def test_sound_run_is_correct(bench, cell):
    spec, base = bench
    out = tiny.run(spec, base, cell, seconds=0.5)
    assert out["correct"], out["checks"]


@pytest.mark.parametrize("fault", [unchanged, half, token_fit],
                         ids=["unchanged", "half", "token"])
@pytest.mark.parametrize("cell", FIT_CELLS)
def test_fit_fault_is_not_correct(bench, cell, fault, monkeypatch):
    spec, base = bench
    fault(monkeypatch)
    out = tiny.run(spec, base, cell, seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("how", ["token", "half"])
@pytest.mark.parametrize("cell", SERVE_CELLS)
def test_serve_fault_is_not_correct(bench, cell, how, monkeypatch):
    spec, base = bench
    alter_lists(monkeypatch, how)
    out = tiny.run(spec, base, cell, seconds=0.5)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", FIT_CELLS + SERVE_CELLS)
def test_control_is_not_correct(bench, cell):
    """bfloat16 in the program's place (TF32, the control on a card, has
    no CPU form: the card's test runs it)."""
    spec, base = bench
    c = harness.Cell(spec, cell, base=base)
    torch.set_num_threads(2)
    values = c.kind.control(harness.Run(c, 23, 0.5, "cpu"), "bf16")
    ok, checks = harness.judge(c, values)
    assert not ok, checks
