"""The port's data-parallel mesh (`rankfm_tpu_torch.parallel`) on the CPU:
the `init_distributed` policy, the planner's mesh branches against the JAX
package's plans, and one 2-rank gloo ring (`torch_common.ring_dp`) whose
results the tests below read: the fused engine's and the XLA steps' epochs
merged by one delta all-reduce per sync group, counted exactly and against
the JAX package's `make_fused_dp_epoch_fn` (its Pallas kernel in interpret
mode) and its DP XLA epoch (each rank fed that epoch's rows and draws),
and `RankFM(mesh=...)` end to end.
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankfm_tpu.models import planner as jplanner
from rankfm_tpu.ops import fused as jfused
from rankfm_tpu.parallel import fused as jpfused
from rankfm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rankfm_tpu_torch import RankFM, evaluation
from rankfm_tpu_torch.models import planner as tplanner
from rankfm_tpu_torch.ops import fused as tfused
from rankfm_tpu_torch.ops import training
from rankfm_tpu_torch.parallel import mesh as tmesh
from rankfm_tpu_torch.parallel import train as ptrain
from rankfm_tpu_torch.parallel.mesh import make_mesh, weight_shardings

import torch_common as tc
from torch_common import one_torch_thread, pallas_interpret  # noqa: F401
from test_sharding import _fake_batch_fn

REL = 2e-2
# the XLA steps against the JAX package's, fed its draws: f32 on both sides
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def ring():
    """Both ranks' results of `torch_common.ring_dp` on a (2, 1) mesh."""
    return tc.run_ring("ring_dp", 2, tc.jax_feeds(2, dp=True))


# ---------------------------------------------------------------------------
# init_distributed policy (counterparts of tests/test_distributed.py)
# ---------------------------------------------------------------------------

@pytest.fixture
def fake_init(monkeypatch):
    """`init_distributed` with `torch.distributed.init_process_group`
    replaced by a failing recorder and no cluster in the environment."""
    calls = []

    def fail(*args, **kwargs):
        calls.append((args, kwargs))
        raise RuntimeError("bootstrap failed (simulated)")

    monkeypatch.setattr(tmesh.dist, "init_process_group", fail)
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: False)
    for var in ("MASTER_ADDR", "WORLD_SIZE"):
        monkeypatch.delenv(var, raising=False)
    return calls


def test_init_distributed_raises_with_explicit_init_method(fake_init):
    with pytest.raises(RuntimeError, match="simulated"):
        tmesh.init_distributed(init_method="tcp://10.0.0.1:1234",
                               world_size=2, rank=0)
    (args, kwargs), = fake_init
    assert kwargs == dict(init_method="tcp://10.0.0.1:1234", world_size=2,
                          rank=0)


@pytest.mark.parametrize("var,value", [("MASTER_ADDR", "10.0.0.1"),
                                       ("WORLD_SIZE", "2")])
def test_init_distributed_raises_when_env_expects_cluster(
        fake_init, monkeypatch, var, value):
    monkeypatch.setenv(var, value)
    with pytest.raises(RuntimeError, match="simulated"):
        tmesh.init_distributed()


def test_init_distributed_zero_arg_single_process_does_nothing(
        fake_init, monkeypatch):
    monkeypatch.setenv("WORLD_SIZE", "1")
    tmesh.init_distributed()
    assert fake_init == []


def test_init_distributed_skips_when_already_initialized(fake_init,
                                                         monkeypatch):
    monkeypatch.setattr(tmesh.dist, "is_initialized", lambda: True)
    tmesh.init_distributed(init_method="tcp://10.0.0.1:1234", world_size=2,
                           rank=0)
    assert fake_init == []


def test_make_mesh_checks_its_arguments(monkeypatch):
    """The JAX assert message; no card without asking for the CPU raises;
    NCCL wants CUDA tensors. Nothing falls back."""
    with pytest.raises(AssertionError, match=r"mesh 2x1 != 1 devices"):
        make_mesh(data=2, model=1, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(ValueError, match="nccl backend needs a CUDA"):
        make_mesh(device="cpu", backend="nccl")
    mesh = make_mesh(device="cpu")
    assert mesh.shape == {"data": 1, "model": 1} and mesh.size == 1
    assert (mesh.rank, mesh.data_rank, mesh.model_rank) == (0, 0, 0)


def test_weight_shardings_cover_pytree():
    ws = weight_shardings(None)
    assert set(ws) == {"w_i", "w_if", "v_u", "v_i", "v_uf", "v_if"}
    assert [k for k, v in ws.items() if v[:1] == ("model",)] == [
        "w_i", "v_u", "v_i"]


# ---------------------------------------------------------------------------
# the planner on a mesh
# ---------------------------------------------------------------------------

ML1M = dict(n=749_724, num_users=6040, num_items=3706, factors=20,
            loss="warp", max_samples=20, epochs=20, nnz_hist=700_000)
INSTACART = dict(n=340_000, num_users=10_000, num_items=33_362, factors=50,
                 loss="warp", max_samples=50, epochs=6, nnz_hist=340_000,
                 mean_sample_weight=1.8)
# the web-scale table shape (examples/webscale_smoke.py): ~286 MB of
# weights, above the 256 MiB data-parallel budget
WEBSCALE = dict(n=500_000, num_users=100_000, num_items=1_000_000,
                factors=64, loss="warp", max_samples=10, epochs=1,
                nnz_hist=500_000,
                table_bytes=4 * (1_000_000 + 1 + 1_101_002 * 64))


@pytest.mark.parametrize("spec,shape", [
    (ML1M, (2, 1)), (ML1M, (1, 2)), (ML1M, (2, 2)),
    (INSTACART, (2, 1)),
    (dict(ML1M, use_fused=False), (2, 1)),
    (dict(ML1M, n=1000, nnz_hist=1000), (3, 1)),
    (WEBSCALE, (1, 2)),
    (dict(ML1M, table_bytes=300 * 2**20), (2, 1)),
], ids=["ml1m-2x1", "ml1m-1x2", "ml1m-2x2", "instacart-2x1",
        "not-fused-2x1", "batch-rounding-3x1", "webscale-tp-1x2",
        "over-budget-tp-2x1"])
def test_mesh_plan_equals_jax_plan(spec, shape):
    data, model = shape
    jmesh = jax_make_mesh(data=data, model=model,
                          devices=jax.devices()[:data * model])
    got = tplanner.plan_fit(tplanner.FitSpec(
        on_gpu=True, mesh=SimpleNamespace(shape={"data": data,
                                                 "model": model}), **spec))
    want = jplanner.plan_fit(jplanner.FitSpec(on_tpu=True, mesh=jmesh,
                                              **spec))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_mesh_plans_place_and_gate_as_the_jax_package():
    """Data-parallel fused on a small mesh, the chunk-tail gated off, the
    batches rounded to whole ranks, table-parallel XLA past the budget."""
    def plan(spec, data, model):
        return tplanner.plan_fit(tplanner.FitSpec(
            on_gpu=True, mesh=SimpleNamespace(shape={"data": data,
                                                     "model": model}),
            **spec))
    single = tplanner.plan_fit(tplanner.FitSpec(on_gpu=True, **ML1M))
    dp = plan(ML1M, 2, 2)
    assert single.chunk_tail > 0 and dp.chunk_tail == 0
    assert dp.fused and dp.placement == "dp" and dp.n_dev == 4
    assert dp.batch_size % (128 * 4) == 0
    small = plan(dict(ML1M, n=1000, nnz_hist=1000), 3, 1)
    assert small.batch_size == 1152 and small.xla_batch % 3 == 0
    tp = plan(WEBSCALE, 1, 2)
    assert WEBSCALE["table_bytes"] > ptrain.DP_TABLE_BYTES
    assert not tp.fused and tp.placement == "tp"
    assert tp.step_kind == "candidate" and tp.post_reject


# ---------------------------------------------------------------------------
# the fused engine, data-parallel
# ---------------------------------------------------------------------------

def _jax_counts(u, i, U, I, bs, sync_every, epoch):
    """Column 0 of the JAX package's merged tables after one epoch of its
    fused DP epoch with its counting stand-in, on 2 devices."""
    n = len(u)
    chunk = jfused.pick_chunk(bs // 2, U, I, n)
    rec, group, cids, ublk, iblk = jfused.make_records_grouped(
        u, i, np.ones(n, np.float32), U, I, bs, chunk)
    split = jfused.split_layout_for_mesh(cids, ublk, iblk, 2)
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    fn = jpfused.make_fused_dp_epoch_fn(
        mesh, U, I, 8, 1, bs, chunk, sync_every=sync_every,
        batch_fn=_fake_batch_fn(chunk, U, I))
    tab_u = jnp.zeros((jfused.user_pad(U), 128), jnp.float32)
    tab_i = jnp.zeros((jfused.item_pad(I), 128), jnp.float32)
    tab_u, tab_i, ll = fn(tab_u, tab_i, jnp.zeros((1, 128), jnp.int32),
                          jnp.asarray(rec), jnp.asarray(group),
                          *map(jnp.asarray, split), 0.1, 0.01,
                          jax.random.PRNGKey(0), epoch)
    return np.asarray(tab_u[:, 0]), np.asarray(tab_i[:, 0]), float(ll)


@pytest.mark.parametrize("sync_every", [1, 4])
def test_fused_dp_epoch_visits_every_row_once(ring, sync_every):
    """Over both ranks one epoch visits every real interaction exactly
    once and the delta merge adds the ranks' visits: exactly `bincount`,
    on both ranks, and the same numbers as the JAX package's DP epoch."""
    c0, c1 = (r[f"fused_counts_sync{sync_every}"][0] for r in ring)
    np.testing.assert_array_equal(
        c0["tab_u"], np.bincount(c0["u"], minlength=len(c0["tab_u"])))
    np.testing.assert_array_equal(c0["tab_i"][:300],
                                  np.bincount(c0["i"], minlength=300))
    assert c0["ll"] == c1["ll"] == len(c0["u"])
    np.testing.assert_array_equal(c0["tab_u"], c1["tab_u"])
    np.testing.assert_array_equal(c0["tab_i"], c1["tab_i"])
    ju, ji, jll = _jax_counts(c0["u"], c0["i"], 500, 300, 1024, sync_every, 0)
    np.testing.assert_array_equal(c0["tab_u"], ju)
    np.testing.assert_array_equal(c0["tab_i"], ji)
    assert jll == c0["ll"]


def test_fused_dp_epoch_shuffles_but_conserves_counts(ring):
    """Epochs 0, 1 and 7 shuffle and rotate differently (shared by the
    ranks) and still visit each row once."""
    for c in ring[0]["fused_counts_epochs"]:
        np.testing.assert_array_equal(
            c["tab_u"], np.bincount(c["u"], minlength=len(c["tab_u"])))
        assert c["ll"] == len(c["u"])


def test_fused_dp_epoch_feature_variant(ring):
    """The feature tables ride the same delta merge."""
    c, = ring[1]["fused_counts_features"]
    np.testing.assert_array_equal(
        c["tab_u"], np.bincount(c["u"], minlength=len(c["tab_u"])))
    assert c["uf"] == len(c["u"]) and c["if_"] == 2 * len(c["u"])
    assert c["ll"] == len(c["u"])


def test_split_layout_for_mesh_equals_jax():
    rng = np.random.default_rng(0)
    cids, ublk, iblk = (rng.integers(0, 99, (6, 8)).astype(np.int32)
                        for _ in range(3))
    for got, want in zip(tfused.split_layout_for_mesh(cids, ublk, iblk, 4),
                         jfused.split_layout_for_mesh(cids, ublk, iblk, 4)):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.fixture
def pallas_interpret_fresh(pallas_interpret):
    """Pallas in interpret mode, with no kernel cached from an earlier
    build."""
    caches = (jfused.make_fused_batch_fn, jpfused._cached_fused_dp_epoch)
    for c in caches:
        c.cache_clear()
    yield
    for c in caches:
        c.cache_clear()


@pytest.mark.parametrize("M", [1, 5], ids=["bpr", "warp"])
def test_forced_negative_dp_epochs_match_pallas_kernel(
        ring, pallas_interpret_fresh, M):
    """Three DP fused epochs on the (2, 1) mesh against the JAX package's
    `make_fused_dp_epoch_fn` on a 2-device slice of its CPU mesh: every
    negative is forced and each rank's chunk is one whole group, so neither
    the draws nor the shuffles can matter."""
    c = tc.FORCED_DP
    _, packed, (rec, group, cids, ublk, iblk), (w_i, v_u, v_i) = \
        tc.forced_dp_problem()
    mesh = jax_make_mesh(data=2, model=1, devices=jax.devices()[:2])
    fn = jpfused.make_fused_dp_epoch_fn(
        mesh, c["U"], c["I"], c["F"], M, c["batch_size"], c["chunk"],
        ub=c["ub"])
    tu, ti = jfused.extend_tables(jnp.asarray(w_i), jnp.asarray(v_u),
                                  jnp.asarray(v_i),
                                  jfused.user_pad(c["U"], c["ub"]),
                                  jfused.item_pad(c["I"]))
    before = np.asarray(ti)[:, :c["F"] + 2]
    win_cols = jfused.pack_win_cols(jnp.asarray(packed), c["U"], c["I"],
                                    ub=c["ub"])
    split = jfused.split_layout_for_mesh(cids, ublk, iblk, 2)
    lls = []
    for epoch in range(c["epochs"]):
        tu, ti, ll = fn(tu, ti, win_cols, jnp.asarray(rec),
                        jnp.asarray(group), *map(jnp.asarray, split),
                        c["eta"], c["alpha"], jax.random.PRNGKey(0), epoch)
        lls.append(float(ll))
    (tu_t, ti_t, ll_t), (tu_1, ti_1, ll_1) = (r[f"forced_M{M}"] for r in ring)
    np.testing.assert_array_equal(tu_t, tu_1)
    np.testing.assert_array_equal(ti_t, ti_1)
    assert ll_t == ll_1
    U = c["U"]
    tu_j = np.asarray(tu)[:U, :c["F"] + 2]
    ti_j = np.asarray(ti)[:, :c["F"] + 2]
    assert np.abs(ti_j - before).max() > 0
    assert tc.rel_err(tu_t[:U], tu_j) < REL
    assert tc.rel_err(ti_t, ti_j) < REL
    assert tc.rel_err(ti_t - before, ti_j - before) < REL
    np.testing.assert_allclose(ll_t, lls, rtol=REL)


def test_data_1_mesh_is_the_single_device_epoch_bit_for_bit():
    """A one-rank mesh draws what one device draws: `dp_fused_epoch` equals
    `fused_epoch` and the DP XLA epochs equal `training.epoch_body`."""
    mesh = make_mesh(data=1, device="cpu")
    prob = tc.xla_problem(4, U=120, I=200, n=1500)
    U, I = prob["U"], prob["I"]
    rec, group, cids, ublk, iblk = tfused.make_records_grouped(
        prob["pairs"][:, 0], prob["pairs"][:, 1], np.ones(prob["n"],
                                                          np.float32),
        U, I, 512, 128)
    layout = tuple(torch.from_numpy(a) for a in (rec, group, cids, ublk,
                                                 iblk))
    packed = torch.from_numpy(prob["packed"])
    kw = dict(num_users=U, num_items=I, factors=8, max_samples=5,
              batch_size=512, chunk=128, ub=None)
    out = []
    for dp in (False, True):
        w = {k: torch.from_numpy(v) for k, v in prob["w"].items()}
        tabs = tfused.extend_tables(w["w_i"], w["v_u"], w["v_i"],
                                    tfused.user_pad(U), tfused.item_pad(I))
        split = layout[:2] + tfused.split_layout_for_mesh(*layout[2:], 1)
        for epoch in (0, 1):
            if dp:
                ll = tfused.dp_fused_epoch(*tabs, packed, split, 0.1, 0.01,
                                           1492, epoch, mesh=mesh,
                                           sync_every=2, **kw)
            else:
                ll = tfused.fused_epoch(*tabs, packed, layout, 0.1, 0.01,
                                        1492, epoch, **kw)
        out.append((tabs, ll))
    (tu0, ti0), ll0 = out[0]
    (tu1, ti1), ll1 = out[1]
    assert torch.equal(tu0, tu1) and torch.equal(ti0, ti1)
    assert float(ll0) == float(ll1)

    u, i, sw = tc.xla_columns(prob, 256)
    x_uf, x_if = torch.zeros((U, 3)), torch.zeros((I, 2))
    for kind in ("window", "candidate"):
        if kind == "window":
            step = training.make_window_train_step(I, 4, False, False)
            hist = packed
        else:
            step = training.make_train_step(I, 4, False, False, 3, "bsearch")
            hist = {"offsets": torch.from_numpy(prob["offsets"]),
                    "flat": torch.from_numpy(prob["flat"])}
        res = []
        for fn in (training.epoch_body(step, 256),
                   ptrain.dp_epoch_body(step, 256, mesh, sync_every=2)):
            w = {k: torch.from_numpy(v.copy()) for k, v in prob["w"].items()}
            w, ll = fn(w, x_uf, x_if, hist, u, i, sw, prob["n"], 0.1, 0.01,
                       0.1, 1492, 3)
            res.append((w, float(ll)))
        assert res[0][1] == res[1][1]
        for k in res[0][0]:
            assert torch.equal(res[0][0][k], res[1][0][k]), (kind, k)


# ---------------------------------------------------------------------------
# the XLA steps, data-parallel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sync_every,groups", [(1, 16), (3, 8), (1000, 1)])
def test_dp_xla_epoch_visits_every_row_once(ring, sync_every, groups):
    """Each rank takes its half of every global batch; ONE delta all-reduce
    per group of batches (3 does not divide the 16 batches: clamped to 2;
    1000 to all 16) of both tables' deltas adds them up exactly, and one
    more sums the epoch's ll."""
    for r in ring:
        c = r[f"xla_counts_sync{sync_every}"]
        assert c["merges"] == (groups, groups * (50 + 70) * 4 * 4)
        assert c["ll_reduces"] == 1
        np.testing.assert_array_equal(c["v_u"], np.bincount(c["u"],
                                                            minlength=50))
        np.testing.assert_array_equal(c["v_i"], np.bincount(c["i"],
                                                            minlength=70))
        assert c["ll"] == len(c["u"])


@pytest.mark.parametrize("kind", ["window", "candidate", "window_sync1000"])
def test_dp_xla_epochs_train_identical_replicas(ring, kind):
    """The window and candidate steps on the (2, 1) mesh: both ranks hold
    bit-equal tables and the same ll after every epoch, the lls finite and
    rising, the tables moved."""
    (w0, l0), (w1, l1) = (r[f"xla_{kind}"] for r in ring)
    assert l0 == l1 and np.isfinite(l0).all()
    if len(l0) > 1:
        assert l0[-1] > l0[0]
    prob = tc.xla_problem(11)
    for k in w0:
        np.testing.assert_array_equal(w0[k], w1[k])
    assert not np.allclose(w0["v_i"], prob["w"]["v_i"])


@pytest.mark.parametrize("kind", list(tc.DP_JAX_CASES))
def test_dp_xla_epoch_matches_jax(ring, kind):
    """One global batch of the window or candidate step with side features
    on the (2, 1) mesh, each rank fed its rows and draws of the JAX
    package's DP epoch (`tc.jax_feed`): the merged tables and the ll agree
    with that epoch's (dyadic weights: the JAX bf16 scoring is exact)."""
    case = tc.DP_JAX_CASES[kind]
    want, want_lls, prob = tc.jax_epochs(case, 2, dp=True)
    (got, lls, used), (got1, lls1, used1) = (r[f"dp_jax_{kind}"]
                                             for r in ring)
    assert used == used1 == 1 and lls == lls1
    for k in got:
        np.testing.assert_array_equal(got[k], got1[k])
    tc.assert_epochs_match_jax(got, lls, want, want_lls, prob["w"], JAX_TOL)


def test_dp_sync_every_clamps_to_batch_count():
    """K larger than the epoch's batch count clamps (tests/test_sharding.py:
    test_dp_sync_every_clamps_to_batch_count)."""
    assert tfused.sync_group_size(1000, 16) == 16
    assert tfused.sync_group_size(3, 16) == 2
    assert tfused.sync_group_size(0, 5) == 1


# ---------------------------------------------------------------------------
# RankFM on the mesh
# ---------------------------------------------------------------------------

def test_model_end_to_end_on_mesh(ring):
    """fit (fused data-parallel, then a data-parallel candidate tail),
    predict and filtered recommend on the (2, 1) mesh, inside the JAX
    test's band of the single-device model (tests/test_sharding.py:
    test_model_end_to_end_on_mesh)."""
    train, test = tc.two_group_frame(5)
    e0, e1 = ring[0]["e2e"], ring[1]["e2e"]
    plan = e0["plan"]
    assert plan.fused and plan.placement == "dp" and plan.n_dev == 2
    assert plan.n_tail == 1 and plan.chunk_tail == 0
    assert e0["predict"].shape == (10,) and np.isfinite(e0["predict"]).all()
    np.testing.assert_array_equal(e0["recs"], e1["recs"])
    for k in e0["weights"]:
        np.testing.assert_array_equal(e0["weights"][k], e1["weights"][k])
    tr_sets = train.groupby("user_id")["item_id"].apply(set)
    for u in range(48):
        assert not (set(e0["recs"][u]) & tr_sets.get(u, set()))
    m0 = RankFM(**tc.E2E_CFG, device="cpu").fit(train, epochs=8)
    hr0 = evaluation.hit_rate(m0, test, k=8)
    assert e0["hr"] > 0.2 and abs(e0["hr"] - hr0) < 0.35, (e0["hr"], hr0)
