"""The port's table-parallel path (`rankfm_tpu_torch.parallel.tp`) and its
sharded retrieval (`parallel.retrieval`) on gloo rings of the CPU: a
(1, 2) ring (`torch_common.ring_tp`) held against the port's single-device
epochs and top-k lists and the JAX package's `make_sharded_topk`; a (2, 1)
ring (`torch_common.ring_tp_fed`) and a (2, 2) ring of four processes
(`torch_common.ring_tp_2x2`) held against the JAX package's TP epochs,
each data rank fed that epoch's rows and draws.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankfm_tpu.parallel.mesh import make_mesh as jax_make_mesh
from rankfm_tpu.parallel.retrieval import make_sharded_topk
from rankfm_tpu_torch.ops import topk, training
from rankfm_tpu_torch.utils.data import csr_row_pairs

import torch_common as tc
from torch_common import one_torch_thread  # noqa: F401

TOL = 1e-5
# against the JAX package's TP epochs, fed its draws: f32 on both sides
JAX_TOL = 1e-4


@pytest.fixture(scope="module")
def ring():
    return tc.run_ring("ring_tp", 2)


@pytest.fixture(scope="module")
def ring4():
    return tc.run_ring("ring_tp_2x2", 4, tc.jax_feeds(2, 2))


@pytest.fixture(scope="module")
def ring21():
    return tc.run_ring("ring_tp_fed", 2, tc.jax_feeds(2, 1))


def _single_device_epochs(prob, kind, bs, epochs, features=False,
                          post_reject=False):
    """The port's single-device epochs with the draws the TP epochs make
    on a ``data=1`` mesh."""
    U, I = prob["U"], prob["I"]
    w, x_uf, x_if = tc.tp_inputs(prob, features)
    if kind == "window":
        step = training.make_window_train_step(I, 4, features, features)
        hist = torch.from_numpy(prob["packed"])
    else:
        step = training.make_train_step(I, 4, features, features, 3,
                                        "bsearch", post_reject=post_reject,
                                        max_row_len=prob["mrl"])
        hist = {"offsets": torch.from_numpy(prob["offsets"]),
                "flat": torch.from_numpy(prob["flat"])}
    fn = training.epoch_body(step, bs)
    u, i, sw = tc.xla_columns(prob, bs)
    lls = []
    for epoch in epochs:
        w, ll = fn(w, x_uf, x_if, hist, u, i, sw, prob["n"], 0.1, 0.01, 0.1,
                   1492, epoch)
        lls.append(float(ll))
    return {k: v.numpy() for k, v in w.items()}, lls


@pytest.mark.parametrize("case", list(tc.TP_CASES))
def test_tp_epochs_match_single_device_epochs(ring, case):
    """data=1, model=2: the TP epochs draw what one device draws, so two
    candidate or window epochs (the window step with its groups split over
    the model axis too; with side features) land within 1e-5 of the port's
    single-device epochs, on both ranks alike, with the shards' pad rows
    untouched."""
    prob = tc.xla_problem(21)
    want, lls = _single_device_epochs(prob, epochs=[0, 1],
                                      **tc.TP_CASES[case])
    (got, got_lls, pad), (got1, lls1, _) = (r[case] for r in ring)
    assert pad == 0.0
    assert got_lls == lls1
    np.testing.assert_allclose(got_lls, lls, rtol=TOL)
    for k in want:
        np.testing.assert_array_equal(got[k], got1[k])
        if k in ("w_i", "v_u", "v_i") or "features" in case:
            assert np.abs(want[k] - prob["w"][k]).max() > 0, k
        assert tc.rel_err(got[k], want[k]) < TOL, (k, tc.rel_err(got[k],
                                                                 want[k]))


@pytest.mark.parametrize("kind", ["window", "candidate"])
def test_tp_epochs_train_on_data_model_mesh(ring4, kind):
    """(2, 2) on four processes: every rank gathers the same whole tables
    and the same ll, the ll finite and rising, the pad rows untouched."""
    prob = tc.xla_problem(8)
    w0, lls0, _ = ring4[0][kind]
    assert [r["coords"] for r in ring4] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    for r in ring4:
        w, lls, pad = r[kind]
        assert lls == lls0 and pad == 0.0
        for k in w0:
            np.testing.assert_array_equal(w[k], w0[k])
    assert np.isfinite(lls0).all() and max(lls0[3:]) > lls0[0], lls0
    assert not np.allclose(w0["v_u"], prob["w"]["v_u"])


@pytest.mark.parametrize("case", list(tc.TP_JAX_CASES))
@pytest.mark.parametrize("shape", ["2x1", "2x2"])
def test_tp_epochs_match_jax(ring21, ring4, shape, case):
    """data=2 (model 1 and 2): each data rank fed its rows and draws of the
    JAX package's TP epoch (`tc.jax_feed`), the port's TP epochs (two
    candidate epochs of 12 batches; one window batch on dyadic weights,
    its groups split over model on (2, 2)), with side features, agree with
    `rankfm_tpu.parallel.tp.tp_epoch_fn`'s on the same slice of the JAX CPU
    mesh: the payload all-gather, the feature-gradient all-reduce and the
    owned-row updates over both data ranks' halves of every batch."""
    model = {"2x1": 1, "2x2": 2}[shape]
    ranks = ring21 if model == 1 else ring4
    c = tc.TP_JAX_CASES[case]
    want, want_lls, prob = tc.jax_epochs(c, 2, model)
    key = case if model == 1 else f"tp_jax_{case}"
    got, lls, _, _ = ranks[0][key]
    nb = -(-prob["n"] // c["bs"])
    for r in ranks:
        g, l, p, n_fed = r[key]
        assert l == lls and p == 0.0 and n_fed == nb * len(c["epochs"])
        for k in g:
            np.testing.assert_array_equal(g[k], got[k])
    tc.assert_epochs_match_jax(got, lls, want, want_lls, prob["w"], JAX_TOL)


def test_tp_batches_split_over_data_ranks(ring4):
    """(2, 2), `tp.tp_epoch_fn` with a step that records what it is handed:
    the two data ranks' valid rows make every interaction exactly once per
    epoch, the model replicas of one data rank get the same rows and the
    same draws, the data ranks other draws, and the epoch ll (valid rows)
    is summed over data alone."""
    prob = tc.xla_problem(8)
    seen = [r["visits"][0] for r in ring4]
    lls = [r["visits"][1] for r in ring4]
    assert all(x == [prob["n"]] * 2 for x in lls), lls
    nb = len(seen[0]) // 2
    for a, b in ((0, 1), (2, 3)):
        for (ua, ia, da), (ub, ib, db) in zip(seen[a], seen[b]):
            np.testing.assert_array_equal(ua, ub)
            np.testing.assert_array_equal(ia, ib)
            np.testing.assert_array_equal(da, db)
    for t in range(len(seen[0])):
        assert not np.array_equal(seen[0][t][2], seen[2][t][2])
    want = np.sort(prob["pairs"][:, 0] * prob["I"] + prob["pairs"][:, 1])
    for e in (0, 1):
        got = np.concatenate([u * prob["I"] + i for r in (0, 2)
                              for u, i, _ in seen[r][e * nb:(e + 1) * nb]])
        np.testing.assert_array_equal(np.sort(got), want)


@pytest.mark.parametrize("filtered", [False, True])
@pytest.mark.parametrize("sharded", [False, True], ids=["whole", "shards"])
def test_sharded_topk_equals_single_device_and_jax(ring, filtered, sharded):
    """(1, 2): the merged per-shard lists are exactly the single-device
    `topk_for_users` lists and the JAX package's `make_sharded_topk`'s,
    from whole tables or from the TP shards, with and without the seen
    items filtered."""
    prob = tc.xla_problem(21)
    users = np.arange(0, prob["U"], 5)
    (idx, vals), (idx1, _) = (r[f"topk_{filtered}_{sharded}"] for r in ring)
    np.testing.assert_array_equal(idx, idx1)
    w, x_uf, x_if = tc.tp_inputs(prob, True)
    rows = cols = torch.zeros(0, dtype=torch.int64)
    r_np = c_np = np.zeros(0, np.int32)
    if filtered:
        r_np, c_np = csr_row_pairs(prob["offsets"], prob["flat"], users)
        rows, cols = (torch.from_numpy(a.astype(np.int64))
                      for a in (r_np, c_np))
    want, _ = topk.topk_for_users(w, x_uf, x_if, torch.from_numpy(users), 10,
                                  rows, cols)
    np.testing.assert_array_equal(idx, want.numpy())

    I = prob["I"]
    v_u, v_i = w["v_u"].numpy(), w["v_i"].numpy()
    ur = v_u + x_uf.numpy() @ w["v_uf"].numpy()
    ir = v_i + x_if.numpy() @ w["v_if"].numpy()
    ib = w["w_i"].numpy() + x_if.numpy() @ w["w_if"].numpy()
    u_mat = np.concatenate([ur[users], v_u[users]], 1)
    i_mat = np.pad(np.concatenate([v_i, ir - v_i], 1), ((0, I % 2), (0, 0)))
    ib = np.pad(ib, (0, I % 2), constant_values=-np.inf)
    mesh = jax_make_mesh(data=1, model=2, devices=jax.devices()[:2])
    fn = make_sharded_topk(mesh, 10, I + I % 2)
    j_idx, _ = fn(jnp.asarray(u_mat), jnp.asarray(i_mat), jnp.asarray(ib),
                  jnp.asarray(r_np), jnp.asarray(c_np))
    np.testing.assert_array_equal(idx, np.asarray(j_idx))


def test_model_routes_tp_past_the_budget_and_serves_from_shards(ring):
    """`DP_TABLE_BYTES` at 0: `RankFM(mesh=...)` places the weights
    table-parallel, keeps half the item rows per rank, and its filtered
    `recommend`, its `predict` and its `similar_items` equal a
    single-device model's loaded from its `save` (which gathers the
    tables). `predict` fetches the pairs' rows from their owners (two
    exchanges, no gather of the tables), `similar_items` gathers once,
    and reading `_w` raises instead of gathering behind the caller."""
    got, got1 = ring[0]["model"], ring[1]["model"]
    plan = got["plan"]
    assert plan.placement == "tp" and not plan.fused
    assert plan.step_kind == "candidate"
    prob = tc.xla_problem(21)
    assert got["shard_rows"] == -(-prob["I"] // 2)
    np.testing.assert_array_equal(got["recs"], got["single_recs"])
    np.testing.assert_array_equal(got["recs"], got1["recs"])
    np.testing.assert_array_equal(got["predict"], got["single_predict"])
    np.testing.assert_array_equal(got["similar"], got["single_similar"])
    assert got["collectives"] == {
        "predict": {("owner_gather", "model"): 2},
        "similar": {("extract", "model"): 1}}
    assert not got["hidden_gather"] and not got1["hidden_gather"]
    assert np.isfinite(got["lls"]).all() and got["lls"] == got1["lls"]
    for k in got["weights"]:
        np.testing.assert_array_equal(got["weights"][k], got1["weights"][k])


def test_model_tp_window_step_verbose(ring):
    """The window step on the shards (`run_tp` with the sharded history
    pack), verbose: every rank reports each epoch from the gathered
    tables; the same weights and lists on both ranks and on a
    single-device model holding them."""
    got, got1 = ring[0]["model_window"], ring[1]["model_window"]
    assert got["plan"].placement == "tp"
    assert got["plan"].step_kind == "window"
    assert np.isfinite(got["lls"]).all() and got["lls"] == got1["lls"]
    for k in got["weights"]:
        np.testing.assert_array_equal(got["weights"][k], got1["weights"][k])
    np.testing.assert_array_equal(got["recs"], got["single_recs"])
    np.testing.assert_array_equal(got["recs"], got1["recs"])
