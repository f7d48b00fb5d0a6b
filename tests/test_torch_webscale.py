"""The large-catalog path of `rankfm_tpu_torch` (the ``webscale``
configuration: 100,000 users x 1,000,000 items x 5,000,000 rows, F 64,
WARP M 10) on the CPU: its plan from numbers alone, a fit past the fused
engine's 64 window blocks against the benchmark's sparse reference, the
step counter, and the sparse reference against the dense one."""

import numpy as np
import pytest
import torch

from fmbench.reference import fit as ref_fit
from fmbench.reference import fit_sparse, fitstats, fitstats_sparse
from rankfm_tpu_torch import RankFM
from rankfm_tpu_torch.models.planner import FitSpec, plan_fit
from rankfm_tpu_torch.models.rankfm import pick_sampler
from rankfm_tpu_torch.ops import fused, scatter, training

from torch_common import one_torch_thread  # noqa: F401

# the training split of the webscale draw (seed 3 of the example, 80%)
U, I, N, NNZ = 100_000, 909_597, 4_000_589, 3_997_414
MODEL = {"factors": 8, "loss": "warp", "max_samples": 4, "alpha": 0.01,
         "sigma": 0.1, "learning_rate": 0.1,
         "learning_schedule": "invscaling"}


def test_the_webscale_plan_from_numbers():
    plan = plan_fit(FitSpec(n=N, num_users=U, num_items=I, factors=64,
                            loss="warp", max_samples=10, epochs=4,
                            nnz_hist=NNZ, on_gpu=True))
    assert plan.nblk > fused.FUSED_NBLK_CAP
    assert not plan.fused and plan.table_mode is None
    assert plan.step_kind == "candidate" and plan.placement == "single"
    assert plan.post_reject and plan.n_main + plan.n_tail == 4
    B = plan.xla_batch
    assert B == 8192 and B * I > 2**28              # gathered scoring
    # items (2B updates a step) past B2's accumulator, and users, both B3
    assert I * 66 * 4 > scatter.DENSE_ACC_MAX_BYTES
    assert scatter._regime(I, 2 * B, 64) == "sorted"
    assert scatter._regime(U, B, 64) == "sorted"
    # the bitmap would take U * ceil(I / 32) words: 11.4 GB
    assert pick_sampler("auto", U, I) == "bsearch"
    assert pick_sampler("auto", 6040, 3706) == "bitmap"
    assert pick_sampler("bitmap", U, I) == "bitmap"


def _past_64_blocks(seed=3):
    """``(train, test)``: 400 users over 66,000 items, each item trained
    once and 2,000 more rows, so the catalog is 65 window blocks of 1,024
    (the fewest rows that pass the fused engine's 64); 3,000 held out."""
    rng = np.random.default_rng(seed)
    n_i = 66_000
    train = np.concatenate([
        np.stack([rng.integers(0, 400, n_i), rng.permutation(n_i)], 1),
        np.stack([rng.integers(0, 400, 2000), rng.integers(0, n_i, 2000)],
                 1)])
    test = np.stack([rng.integers(0, 400, 3000), rng.integers(0, n_i, 3000)],
                    1)
    return train, test


@pytest.fixture(scope="module")
def webscale_path_fit():
    """One epoch of the port past 64 blocks with the binary-search sampler
    (the auto rule keeps the bitmap at this size), the steps it counted,
    and one epoch of `fit_sparse` on the same data, each with the
    statistics that `webscale.fit` compares."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        train, test = _past_64_blocks()
        before = training.STEPS.copy()
        model = RankFM(**MODEL, neg_sampler="bsearch", seed=7,
                       device="cpu").fit(train, epochs=1)
        steps = training.STEPS - before
        frame = fitstats_sparse.Frame(train, test, "cpu")
        tables, lls = fit_sparse.fit(frame.train, None, len(frame.users),
                                     len(frame.items), MODEL, 1, seed=9,
                                     device="cpu")
        ref = fitstats_sparse.stats(frame, tables, lls, None)
        got = fitstats_sparse.stats(
            frame, {k: getattr(model, k) for k in ("v_u", "v_i", "w_i")},
            [e["log_likelihood"] for e in model.training_log_], None)
    finally:
        torch.set_num_threads(n)
    return model, steps, fitstats_sparse.gaps(got, ref)


def test_a_fit_past_64_blocks_runs_the_candidate_path(webscale_path_fit):
    model, _, _ = webscale_path_fit
    plan = model.last_fit_plan_
    assert plan.nblk == 65 and not plan.fused
    assert plan.step_kind == "candidate" and plan.post_reject
    assert model._sampler == "bsearch"
    assert plan.xla_batch * len(model.item_idx) > 2**28


def test_a_fit_past_64_blocks_agrees_with_the_sparse_reference(
        webscale_path_fit):
    """The port's epoch and the reference's part at their first near-tied
    negatives, so they are compared by `webscale.fit`'s statistics.
    Tolerances, each with its reason (readings 0.0025, 0.0020, 0.025,
    0.0014, 0.0094):

    - ``hr10_gap`` <= 0.02: 400 users on uniform data, where both read about
      0; one user is 0.0025;
    - ``ll_gap`` <= 0.02: the port updates in synchronous batches of 8,192
      rows and the reference every 128, which lowers an epoch's
      log-likelihood by a few tenths of a percent here (`PERF.md` §2: 11% at
      Instacart's denser rows); the unchanged state reads ~0.1;
    - ``rms_gap.<table>`` <= 0.1: a user row here takes ~170 rows an epoch
      in 9 batches, so its table reads a few percent from the reference's
      per-chunk decay; an item row takes about one."""
    _, _, gaps = webscale_path_fit
    assert gaps["hr10_gap"] <= 0.02
    assert gaps["ll_gap"] <= 0.02
    for n in ("v_u", "v_i", "w_i"):
        assert gaps[f"rms_gap.{n}"] <= 0.1, (n, gaps)


def test_the_steps_counter_counts_one_a_batch(webscale_path_fit):
    model, steps, _ = webscale_path_fit
    plan = model.last_fit_plan_
    n_pad_batches = -(-len(model.interactions) // plan.xla_batch)
    assert dict(steps) == {
        ("candidate", "bsearch", True, "gathered"): n_pad_batches}


def test_the_steps_counter_keys_dense_scoring_and_the_window_step():
    rng = np.random.default_rng(0)
    train = np.stack([rng.integers(0, 50, 600), rng.integers(0, 80, 600)], 1)
    for kw, key in (({"train_step": "candidate"},
                     ("candidate", "bitmap", False, "dense")),
                    ({"train_step": "window", "batch_size": 256},
                     ("window", "packed", False, "dense"))):
        before = training.STEPS.copy()
        model = RankFM(factors=4, loss="warp", max_samples=5,
                       use_fused=False, device="cpu", **kw).fit(train,
                                                                epochs=2)
        nb = -(-len(model.interactions) // model.last_fit_plan_.xla_batch)
        assert dict(training.STEPS - before) == {key: 2 * nb}


def test_a_graph_of_one_batch_trains_the_epoch_it_replaces(monkeypatch):
    """`graph.BatchGraph` over `training.epoch_parts`, its captured batch
    replaced by the batch run eagerly at each replay, trains what
    `training.epoch_body` trains, to the bit, epoch after epoch (the
    rows of a later epoch copied into the first epoch's buffers, the
    batch counter and the ll sum reset), and counts one replay an epoch
    and one step a batch."""
    from collections import Counter

    from rankfm_tpu_torch.ops import graph

    class Eager:
        def __init__(self, g):
            self.g = g

        def replay(self):
            self.g.fn(self.g.tables, self.g.epoch, self.g.eta)

    def capture(self):
        self.graph, self.ll = Eager(self), self.ll_sum
        self.launches = (Counter(), Counter(), Counter())

    monkeypatch.setattr(graph.EpochGraph, "capture", capture)
    rng = np.random.default_rng(4)
    train = np.stack([rng.integers(0, 40, 900), rng.integers(0, 120, 900)],
                     1)
    m = RankFM(factors=4, loss="warp", max_samples=5, use_fused=False,
               device="cpu").fit(train, epochs=1)
    plan, B = m.last_fit_plan_, 256
    n = len(m.interactions)
    n_pad = -(-n // B) * B
    cols = [torch.zeros(n_pad, dtype=dt) for dt in (torch.int64,
                                                     torch.int64,
                                                     torch.float32)]
    cols[0][:n] = torch.from_numpy(m.interactions[:, 0].astype(np.int64))
    cols[1][:n] = torch.from_numpy(m.interactions[:, 1].astype(np.int64))
    cols[2][:n] = torch.from_numpy(m.sample_weight)
    step = training.make_train_step(len(m.item_idx), plan.max_samples,
                                    False, False, sample_rounds=plan.rounds,
                                    sampler="bsearch", post_reject=True,
                                    max_row_len=int(np.diff(
                                        m._ui_offsets).max()))
    hist = {"offsets": m._offsets_dev, "flat": m._flat_items_dev}
    body = training.epoch_body(step, B)
    make_rows, batch = training.epoch_parts(step, B)
    w = m.gather_weights()
    te = {k: v.clone() for k, v in w.items()}
    tg = {k: v.clone() for k, v in w.items()}
    g = graph.BatchGraph(
        lambda e: make_rows(*cols, n, m.seed, e),
        lambda t, rows, eta: batch(t, m._x_uf_dev, m._x_if_dev, hist, rows,
                                   eta, m.alpha, m.beta)[1],
        n_pad // B, tg, "cpu", "candidate")
    for epoch, eta in ((3, 0.1), (4, 0.07)):
        runs, steps = dict(graph.RUNS), training.STEPS.copy()
        ll_g = g(epoch, eta)
        assert graph.RUNS["replay"] - runs.get("replay", 0) == 1
        assert sum((training.STEPS - steps).values()) == n_pad // B
        _, ll_e = body(te, m._x_uf_dev, m._x_if_dev, hist, *cols, n, eta,
                       m.alpha, m.beta, m.seed, epoch)
        assert torch.equal(ll_g, ll_e.reshape(ll_g.shape)), epoch
        for k in te:
            assert torch.equal(te[k], tg[k]), (epoch, k)


def test_a_fit_through_graphs_of_one_batch_equals_the_eager_fit(
        monkeypatch):
    """`RankFM`'s XLA epochs through `graph.BatchGraph` (its captured batch
    run eagerly at each replay, the CPU standing in for the card) train
    what the eager epochs train, to the bit: the wiring of the rows, the
    batch and the feature tables copied back."""
    from collections import Counter

    from rankfm_tpu_torch.ops import graph

    class Eager:
        def __init__(self, g):
            self.g = g

        def replay(self):
            self.g.fn(self.g.tables, self.g.epoch, self.g.eta)

    def capture(self):
        self.graph, self.ll = Eager(self), self.ll_sum
        self.launches = (Counter(), Counter(), Counter())

    rng = np.random.default_rng(6)
    train = np.stack([rng.integers(0, 40, 900), rng.integers(0, 120, 900)],
                     1)
    import pandas as pd
    ids = np.unique(train[:, 1])
    x_if = pd.DataFrame(np.eye(3, dtype=np.float32)[
        rng.integers(0, 3, len(ids))], columns=["a", "b", "c"])
    x_if.insert(0, "item_id", ids)
    kw = dict(factors=4, loss="warp", max_samples=5, use_fused=False,
              batch_size=256, device="cpu")
    want = RankFM(**kw).fit(train, item_features=x_if, epochs=3)
    made = []

    def runner(fn, tables, device, mesh=None, name="epoch", cache=None,
               key=None, deps=(), batches=None):
        made.append(graph.BatchGraph(*batches, tables, device, name))
        return made[-1]

    monkeypatch.setattr(graph.EpochGraph, "capture", capture)
    monkeypatch.setattr(graph, "epoch_runner", runner)
    got = RankFM(**kw).fit(train, item_features=x_if, epochs=3)
    assert len(made) == 1 and made[0].count * 256 >= len(train)
    for k in ("v_u", "v_i", "w_i", "v_if", "w_if"):
        assert getattr(got, k).tobytes() == getattr(want, k).tobytes(), k
    assert [e["log_likelihood"] for e in got.training_log_] == [
        e["log_likelihood"] for e in want.training_log_]


def _log(U_, I_, n, seed):
    rng = np.random.default_rng(seed)
    return np.stack([rng.integers(0, U_, n),
                     (I_ * rng.random(n) ** 2).astype(np.int64)], 1)


@pytest.mark.parametrize("fault", [None, "half", "token", "unchanged"])
@pytest.mark.parametrize("shape,loss", [((60, 300, 1500), "warp"),
                                        ((50, 5000, 1200), "warp"),
                                        ((50, 5000, 1200), "bpr")])
def test_fit_sparse_equals_fit(shape, loss, fault):
    """The sparse reference against `fmbench.reference.fit` from one seed:
    the whole catalog as the window (300 items) and a 4,096-item window of
    5,000, weighted rows; tables to 1e-5 and every epoch's
    log-likelihood."""
    U_, I_, n = shape
    train = _log(U_, I_, n, 1)
    sw = np.random.default_rng(2).uniform(0.5, 2.0, n).astype(np.float32)
    model = dict(MODEL, loss=loss)
    a_t, a_ll = ref_fit.fit(train, sw, None, U_, I_, model, 3, seed=5,
                            device="cpu", fault=fault)
    b_t, b_ll = fit_sparse.fit(train, sw, U_, I_, model, 3, seed=5,
                               device="cpu", fault=fault)
    np.testing.assert_allclose(b_ll, a_ll, rtol=1e-6)
    assert set(b_t) == {"v_u", "v_i", "w_i"}
    for k in b_t:
        np.testing.assert_allclose(b_t[k], a_t[k], atol=1e-5, rtol=0)


def test_fit_sparse_starts_from_given_tables():
    """``init``: the tables are loaded as given (a fit whose updates are
    left out returns them to the bit), the caller's arrays are not trained
    on, and an epoch from a warm start at epoch 0's rate reads the
    log-likelihood of a scratch fit's second epoch within 5%."""
    train = _log(60, 300, 1500, 1)
    t1, ll2 = fit_sparse.fit(train, None, 60, 300, MODEL, 2, seed=5,
                             device="cpu")
    start = {k: v.copy() for k, v in t1.items()}
    same, _ = fit_sparse.fit(train, None, 60, 300, MODEL, 1, seed=6,
                             device="cpu", init=t1, fault="unchanged")
    warm, ll = fit_sparse.fit(train, None, 60, 300, MODEL, 1, seed=6,
                              device="cpu", init=t1)
    for k in t1:
        np.testing.assert_array_equal(t1[k], start[k])
        np.testing.assert_array_equal(same[k], start[k])
        assert not np.array_equal(warm[k], start[k])
    np.testing.assert_allclose(ll, ll2[1:], rtol=0.05)


@pytest.mark.parametrize("block", [37, 2048])
def test_sparse_hit_rate_equals_the_dense_one(block):
    rng = np.random.default_rng(1)
    pairs = np.stack([rng.integers(0, 300, 9000),
                      rng.integers(0, 2000, 9000)], 1)
    keep = rng.random(9000) < 0.8
    dense = fitstats.Frame(pairs[keep], pairs[~keep], "cpu")
    sparse = fitstats_sparse.Frame(pairs[keep], pairs[~keep], "cpu")
    tables = {"v_u": rng.normal(size=(len(dense.users), 8)),
              "v_i": rng.normal(size=(len(dense.items), 8)),
              "w_i": rng.normal(size=len(dense.items))}
    tables = {k: v.astype(np.float32) for k, v in tables.items()}
    users = torch.arange(len(dense.users))
    for pairs_ in (dense.train, dense.test):
        assert torch.equal(dense._mask(pairs_)[users],
                           sparse._mask(pairs_)[users])
    assert fitstats.hit_rate(sparse, tables, None, block=block) == (
        fitstats.hit_rate(dense, tables, None, block=block))
