"""The fit features the port took over last: pre-shuffled layouts cycled
over the epochs (``shuffle_layouts``), the wide-window fused tail
(``tail_windows``), and the row-sharded step API of `parallel.train`,
against the JAX package where it has the same function.

The shuffle is host and tensor code (bitwise against
`rankfm_tpu.ops.fused.make_shuffle_fn` fed the same 32-bit draws); one
batch at a wide window count runs through the plain chunk step and the
JAX Pallas kernel in interpret mode (forced negatives, rel 2e-2 as in
`tests/test_torch_fused.py`); whole fits run on the CPU through the plain
versions; the mesh runs on a 2-rank gloo ring (`torch_common.run_ring`).
"""

import inspect

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankfm_tpu.ops import fused as jfused
from rankfm_tpu.parallel import train as jtrain
from rankfm_tpu_torch import RankFM
from rankfm_tpu_torch.ops import fused as tfused
from rankfm_tpu_torch.parallel import train as ptrain
from rankfm_tpu_torch.utils.convert import tables_from_jax

import torch_common as tc
from torch_common import (FORCED_SHAPE, forced_case,  # noqa: F401
                          one_torch_thread, pallas_interpret, rel_err)

REL = 2e-2


def _layout(U=3000, I=2500, B=2048, C=128, n=5000, seed=0):
    rng = np.random.default_rng(seed)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    sw = (rng.random(n) + 0.5).astype(np.float32)
    return tfused.make_records_grouped(u, i, sw, U, I, B, C)


def test_shuffle_fn_equals_jax_shuffle_fn():
    """The port's segmented shuffle fed the 32-bit draws of the key that
    `rankfm_tpu.ops.fused.make_shuffle_fn` gets for layout 2 of seed 5
    gives that function's layout: bitwise where the sort keys are unique,
    the same records under each run of equal keys."""
    U, I = 3000, 2500
    rec, group, *_ = _layout(U, I)
    key = jax.random.fold_in(jax.random.fold_in(jax.random.PRNGKey(5),
                                                2**31 - 7), 2)
    want = np.asarray(jfused.make_shuffle_fn(U, I)(
        jnp.asarray(rec), jnp.asarray(group), key))
    rnd = np.asarray(jax.random.bits(key, (rec.shape[0],), jnp.uint32))
    got = tfused.make_shuffle_fn(U, I)(
        torch.from_numpy(rec), torch.from_numpy(group),
        torch.from_numpy(rnd.astype(np.int64))).numpy()
    keys = tfused.group_keys(torch.from_numpy(group),
                             tfused.shuffle_rnd_bits(U, I),
                             torch.from_numpy(rnd.astype(np.int64))).numpy()
    ks = np.sort(keys)
    assert not np.array_equal(got, rec)                # it did shuffle
    unique = np.ones(len(ks), bool)
    unique[1:] &= ks[1:] != ks[:-1]
    unique[:-1] &= ks[1:] != ks[:-1]
    np.testing.assert_array_equal(got[unique], want[unique])
    for k in np.unique(ks[~unique]):
        run = ks == k
        np.testing.assert_array_equal(np.sort(got[run], 0),
                                      np.sort(want[run], 0))


def _epoch(layout, pre_shuffled, tabs):
    """One plain-version epoch of `_layout`'s log on copies of ``tabs``."""
    tu, ti = (t.clone() for t in tabs)
    rec, group, cids, ublk, iblk = layout
    packed = torch.from_numpy(tfused.pack_history(
        np.zeros(3001, np.int32), np.zeros(0, np.int32), 3000, 2500))
    ll = tfused.fused_epoch(
        tu, ti, packed, (rec, group, cids, ublk, iblk), 0.1, 0.01, 7, 3,
        num_users=3000, num_items=2500, factors=8, max_samples=5,
        batch_size=2048, chunk=128, ub=None, pre_shuffled=pre_shuffled)
    return tu, ti, float(ll)


def test_pre_shuffled_epoch_equals_sorting_epoch():
    """Given the layout the sorting epoch draws for itself, the
    pre-shuffled epoch (no sort; the shuffle's draws taken and dropped)
    trains the same tables and ll, bit for bit."""
    rec, group, cids, ublk, iblk = (torch.from_numpy(a) for a in _layout())
    rng = np.random.default_rng(1)
    tabs = tfused.extend_tables(
        torch.from_numpy(rng.normal(0, 0.05, 2500).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.1, (3000, 8)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.1, (2500, 8)).astype(np.float32)),
        tfused.user_pad(3000), tfused.item_pad(2500))
    keys = tfused.shuffle_keys(group, tfused.shuffle_rnd_bits(3000, 2500),
                               tfused.epoch_generator(7, 3))
    rec_s = rec[torch.sort(keys, stable=True).indices]
    want = _epoch((rec, group, cids, ublk, iblk), False, tabs)
    got = _epoch((rec_s, group, cids, ublk, iblk), True, tabs)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert got[2] == want[2]
    # another layout trains other tables
    other = _epoch((rec, group, cids, ublk, iblk), True, tabs)
    assert not torch.equal(other[1], want[1])


def test_shuffle_layouts_cycle_across_fit_and_fit_partial(monkeypatch):
    """R = 4: each epoch trains on layout ``(epoch stream position) % 4``,
    built when first used and once per call; ``fit_partial`` continues the
    cycle. The epochs never sort."""
    built, rounds = [], []
    layout_generator = tfused.layout_generator
    shuffle_keys = tfused.shuffle_keys

    def spy_layout(seed, r):
        built.append(r)
        return layout_generator(seed, r)

    def spy_keys(*a):
        rounds.append(1)
        return shuffle_keys(*a)

    monkeypatch.setattr(tfused, "layout_generator", spy_layout)
    monkeypatch.setattr(tfused, "shuffle_keys", spy_keys)
    rng = np.random.default_rng(2)
    users = np.repeat(np.arange(300), 20)
    train = np.stack([users, rng.integers(0, 2500, len(users))], 1)
    m = RankFM(factors=4, loss="warp", max_samples=5, shuffle_layouts=4,
               device="cpu")
    m.fit(train, epochs=3)
    plan = m.last_fit_plan_
    assert plan.shuffle_layouts == 4 and plan.nblk == 3
    assert plan.chunk_tail == 0 and plan.n_tail == 0
    assert built == [0, 1, 2]
    m.fit_partial(train, epochs=3)
    assert built == [0, 1, 2, 3, 0, 1]
    assert rounds == []
    lls = [r["log_likelihood"] for r in m.training_log_]
    assert len(lls) == 6 and np.isfinite(lls).all()


def test_wide_window_batch_matches_pallas_kernel(pallas_interpret):
    """One batch at 3 windows a chunk, every window block of the catalog
    (one block repeated, so the negative stays forced) through the plain
    chunk step and through the JAX Pallas kernel built with
    ``n_windows=3`` in interpret mode: the same tables and ll within the
    bf16 tolerance of `tests/test_torch_fused.py`."""
    U, I, F, UB, C, NT = FORCED_SHAPE
    rng = np.random.default_rng(3)
    packed, rec, blk, ublk, iblk, (w_i, v_u, v_i) = forced_case(rng)
    blk = np.repeat(blk, 3, axis=1)
    eta, dreg = 0.1, float(np.float32(0.1) * np.float32(0.02))
    tu, ti = jfused.extend_tables(jnp.asarray(w_i), jnp.asarray(v_u),
                                  jnp.asarray(v_i), jfused.user_pad(U, UB),
                                  jfused.item_pad(I))
    fn = jfused.make_fused_batch_fn.__wrapped__(U, I, F, 5, NT * C, C,
                                                n_windows=3, ub=UB)
    tu_j, ti_j, _, _, ll_j = fn(
        tu, ti, jnp.asarray(rec),
        jfused.pack_win_cols(jnp.asarray(packed), U, I, ub=UB),
        jnp.arange(NT, dtype=jnp.int32), jnp.asarray(blk),
        jnp.asarray(ublk), jnp.asarray(iblk), jnp.array([7], jnp.int32),
        jnp.array([eta], jnp.float32), jnp.array([dreg, 0.0], jnp.float32))
    tab_u, tab_i = (tables_from_jax(t, F, "cpu") for t in (tu, ti))
    ll_t = float(tfused.fused_batch_reference(
        tab_u, tab_i, torch.from_numpy(rec), torch.from_numpy(packed),
        torch.from_numpy(blk), torch.from_numpy(ublk),
        torch.from_numpy(iblk), 7, eta, (dreg, 0.0), factors=F,
        max_samples=5, ub_rows=UB, num_items=I))
    ll_j = float(ll_j)
    assert ll_j < 0 and abs(ll_t - ll_j) / abs(ll_j) < REL
    ti_j = np.asarray(ti_j)[:, :F + 2]
    old = np.asarray(ti)[:, :F + 2]
    assert rel_err(tab_i.numpy(), ti_j) < REL
    assert rel_err(tab_i.numpy() - old, ti_j - old) < REL
    assert rel_err(tab_u[:U].numpy(), np.asarray(tu_j)[:U, :F + 2]) < REL


def test_sharded_signatures_carry_the_jax_parameters():
    for name in ("make_sharded_epoch_fn", "make_sharded_train_step",
                 "sharded_train_step", "place_weights",
                 "place_weights_replicated"):
        got = inspect.signature(getattr(ptrain, name)).parameters
        want = inspect.signature(getattr(jtrain, name)).parameters
        assert list(got) == list(want), name
        assert [p.default for p in got.values()] == [
            p.default for p in want.values()], name


@pytest.fixture(scope="module")
def ring():
    return tc.run_ring("ring_fit_features", 2)


def test_sharded_train_step_matches_single_device_step(ring):
    """One candidate batch over row shards on a ``(1, 2)`` mesh, every
    rank called with the whole batch and the single-device step's draws:
    the gathered tables within 1e-5 of the single-device step's, the same
    ll."""
    for r in ring:
        out = r["step"]
        for k, want in out["single"].items():
            assert np.abs(out["sharded"][k] - want).max() <= 1e-5, k
        assert abs(out["ll"] - out["single_ll"]) <= 1e-5 * abs(
            out["single_ll"])
    assert all(np.array_equal(ring[0]["step"]["sharded"][k],
                              ring[1]["step"]["sharded"][k])
               for k in ring[0]["step"]["sharded"])


def test_sharded_epoch_without_dp_is_the_tp_epoch(ring):
    """``make_sharded_epoch_fn(dp=False)`` (and ``dp=None`` past the
    table budget) is `tp.tp_epoch_fn`: equal shards and lls; ``dp=True``
    gives the data-parallel epoch on replicated weights."""
    for r in ring:
        out = r["epoch"]
        for name in ("forced", "by_bytes"):
            for k, want in out["tp"][0].items():
                assert np.array_equal(out[name][0][k], want), (name, k)
            assert out[name][1] == out["tp"][1]
        assert out["dp_is_dp"]


def test_wide_tail_on_a_data_parallel_mesh(ring):
    """``RankFM(train_step='mixed', tail_windows=3, mesh=data 2)``: the
    closing epoch runs the data-parallel fused epoch at 3 windows a chunk,
    the main epochs at 1, and no table update (B2/B3) runs; both ranks
    end with equal weights."""
    a, b = (r["wide_tail"] for r in ring)
    assert a["plan"].tail_windows == 3 and a["plan"].n_tail == 1
    assert a["plan"].placement == "dp"
    n_main = a["plan"].n_main
    assert a["nw_by_epoch"][:n_main] == [1] * n_main
    assert a["nw_by_epoch"][n_main:] == [3]
    assert a["table_updates"] == 0 and b["table_updates"] == 0
    for k in a["weights"]:
        assert np.array_equal(a["weights"][k], b["weights"][k]), k
