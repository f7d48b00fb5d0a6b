"""The port's fused-engine layout and planner against the JAX package's.

Every layout function is deterministic host code, so the arrays must be
bitwise equal; the planner must resolve the same `FitPlan`, field by
field, for the same spec (``on_gpu`` in the port, ``on_tpu`` in JAX).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rankfm_tpu.models import planner as jplanner
from rankfm_tpu.ops import fused as jfused
from rankfm_tpu_torch.models import planner as tplanner
from rankfm_tpu_torch.ops import fused as tfused
from rankfm_tpu_torch.utils.convert import tables_from_jax, tables_to_jax


def _histories(rng, U, I, max_len):
    lens = rng.integers(0, max_len, U)
    sets = [np.sort(rng.choice(I, size=min(n, I), replace=False)) for n in lens]
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = np.concatenate(sets).astype(np.int32)
    return offsets, flat


@pytest.mark.parametrize("num_items", [60, 128, 1000, 2500, 3706])
def test_pack_history_and_pad_row_bitwise(num_items):
    rng = np.random.default_rng(num_items)
    U = 40
    offsets, flat = _histories(rng, U, num_items, 300)
    np.testing.assert_array_equal(
        tfused.pack_history(offsets, flat, U, num_items),
        jfused.pack_history(offsets, flat, U, num_items))
    np.testing.assert_array_equal(tfused.pad_row(num_items),
                                  jfused.pad_row(num_items))
    items = np.arange(jfused.item_pad(num_items), dtype=np.int64)
    blk = jfused.block_size(num_items)
    for a, b in zip(tfused._pack_coords(items, blk),
                    jfused._pack_coords(items, blk)):
        np.testing.assert_array_equal(a, b)


def test_size_helpers_match():
    for U in (1, 7, 255, 256, 700, 1023, 1024, 3000, 6040, 100_000):
        for ub in (None, 256, 1024):
            assert tfused.user_block(U, ub) == jfused.user_block(U, ub)
            assert tfused.user_pad(U, ub) == jfused.user_pad(U, ub)
            assert tfused.num_user_blocks(U, ub) == jfused.num_user_blocks(U, ub)
    for I in (1, 60, 128, 129, 1000, 1024, 2500, 3706, 9500, 70_000):
        assert tfused.block_size(I) == jfused.block_size(I)
        assert tfused.item_pad(I) == jfused.item_pad(I)
        np.testing.assert_array_equal(tfused.window_block_cdf(I),
                                      jfused.window_block_cdf(I))
        for U, F in ((6040, 20), (10_000, 50), (500, 126), (500, 127)):
            for x_if in (False, True):
                args = (U, I, F, False, x_if)
                assert (tfused.fused_table_mode(*args, num_if=21)
                        == jfused.fused_table_mode(*args, num_if=21))
                assert (tfused.fused_eligible(*args, num_if=21)
                        == jfused.fused_eligible(*args, num_if=21))
            assert (tfused.max_n_windows(U, I, False)
                    == jfused.max_n_windows(U, I, False))
    for nblk in range(1, 70):
        assert tfused.default_n_windows(nblk) == jfused.default_n_windows(nblk)
    for bs in (128, 384, 640, 1024, 8192, 32768):
        for U, I, n in ((64, 128, 256), (6040, 3706, 749_724),
                        (100, 40_000, 1000)):
            assert (tfused.pick_chunk(bs, U, I, n)
                    == jfused.pick_chunk(bs, U, I, n))
            assert (tfused.pick_user_block(U, I, n, 256)
                    == jfused.pick_user_block(U, I, n, 256))


@pytest.mark.parametrize("shape", [
    # (U, I, n, batch, chunk, ub): the ML-1M headline at both fit layouts,
    # and the 3-user-block layout of tests/test_fused.py
    (6040, 3706, 749_724, 32768, 256, None),
    (6040, 3706, 749_724, 32768, 128, 256),
    (3000, 256, 3 * 2048 - 300, 2048, 128, None),
], ids=["ml1m-c256", "ml1m-c128-ub256", "3-user-blocks"])
def test_make_records_grouped_bitwise(shape):
    U, I, n, B, C, ub = shape
    rng = np.random.default_rng(0)
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    sw = (rng.random(n) + 0.5).astype(np.float32)
    got = tfused.make_records_grouped(u, i, sw, U, I, B, C, ub=ub)
    want = jfused.make_records_grouped(u, i, sw, U, I, B, C, ub=ub)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    for g, w in zip(tfused.unpack_record_cols(got[0][:, 0]),
                    jfused.unpack_record_cols(want[0][:, 0])):
        np.testing.assert_array_equal(g, w)


def test_segmented_shuffle_keeps_layout_invariants():
    """The port's per-epoch shuffle (single packed key, stable sort) keeps
    every invariant of tests/test_fused.py's grouped-layout test: guard
    rows stay all-zero, chunks stay pure, and the multiset of (u, i, sw)
    is conserved."""
    U, I, B, C = 3000, 256, 2048, 128
    rng = np.random.default_rng(0)
    n = 3 * B - 300
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    sw = rng.random(n).astype(np.float32) + 0.5
    rec, group, cids, ublk, iblk = tfused.make_records_grouped(
        u, i, sw, U, I, B, C)
    n_pad = rec.shape[0]
    BLK, UBW = tfused.block_size(I), tfused.user_block(U)
    NG = tfused.num_user_blocks(U) * (tfused.item_pad(I) // BLK)
    rnd_bits = 31 - int(NG + 1).bit_length()
    keys = tfused.shuffle_keys(torch.from_numpy(group), rnd_bits,
                               tfused.epoch_generator(5, 0))
    order = torch.sort(keys, stable=True).indices.numpy()
    shuffled = rec[order]
    assert not np.array_equal(shuffled, rec)        # it did shuffle

    u_loc, i1, v = tfused.unpack_record_cols(shuffled[:, 0])
    valid = v == 1
    assert (i1[~valid] == 0).all() and (shuffled[~valid] == 0).all()
    cid_f, ub_f, ib_f = cids.reshape(-1), ublk.reshape(-1), iblk.reshape(-1)
    u_abs = np.zeros(n_pad, np.int64)
    i_abs = np.zeros(n_pad, np.int64)
    for p in range(n_pad // C):
        s = slice(cid_f[p] * C, (cid_f[p] + 1) * C)
        u_abs[s] = ub_f[p] * UBW + u_loc[s]
        i_abs[s] = ib_f[p] * BLK + i1[s] - 1
    got = np.stack([u_abs[valid], i_abs[valid], shuffled[valid][:, 1]], 1)
    want = np.stack([u, i, sw.view(np.int32)], 1)
    np.testing.assert_array_equal(
        got[np.lexsort((got[:, 2], got[:, 1], got[:, 0]))],
        want[np.lexsort((want[:, 2], want[:, 1], want[:, 0]))])
    # rows never leave their group
    np.testing.assert_array_equal(group[order], np.sort(group))


def test_tables_convert_both_ways():
    rng = np.random.default_rng(1)
    U, I, F = 11, 300, 7
    w_i = rng.normal(size=I).astype(np.float32)
    v_u = rng.normal(size=(U, F)).astype(np.float32)
    v_i = rng.normal(size=(I, F)).astype(np.float32)
    tu_j, ti_j = jfused.extend_tables(jnp.asarray(w_i), jnp.asarray(v_u),
                                      jnp.asarray(v_i), 16, 512)
    tu_t, ti_t = tfused.extend_tables(torch.from_numpy(w_i),
                                      torch.from_numpy(v_u),
                                      torch.from_numpy(v_i), 16, 512)
    np.testing.assert_array_equal(tables_from_jax(tu_j, F, "cpu"), tu_t)
    np.testing.assert_array_equal(tables_from_jax(ti_j, F, "cpu"), ti_t)
    np.testing.assert_array_equal(tables_to_jax(tu_t), np.asarray(tu_j))
    np.testing.assert_array_equal(tables_to_jax(ti_t), np.asarray(ti_j))
    for got, want in zip(tfused.extract_tables(tu_t, ti_t, U, I, F),
                         (w_i, v_u, v_i)):
        np.testing.assert_array_equal(got.numpy(), want)


ML1M = dict(n=749_724, num_users=6040, num_items=3706, factors=20,
            loss="warp", max_samples=20, epochs=20, nnz_hist=700_000)
# the Instacart headline (examples/instacart_style.py): 68% of a ~500k-row
# reorder log, log2(orders + 1) sample weights
INSTACART = dict(n=340_000, num_users=10_000, num_items=33_362, factors=50,
                 loss="warp", max_samples=50, epochs=30, nnz_hist=340_000,
                 mean_sample_weight=1.8)
# side features: the 21 department one-hots of the Instacart example on
# items, a 21-column one-hot on users; the ML-1M users.dat / movies.dat
# schemas (gender 2 + age 7 + occupation 21; 18 genres)
INSTACART_FEATURES = dict(x_uf_any=True, num_uf=21, x_if_any=True, num_if=21)
ML1M_FEATURES = dict(x_uf_any=True, num_uf=30, x_if_any=True, num_if=18)


@pytest.mark.parametrize("spec", [
    ML1M,
    dict(n=30_000, num_users=700, num_items=2500, factors=16, loss="warp",
         max_samples=10, epochs=10, nnz_hist=25_000, train_step="window"),
    dict(ML1M, loss="bpr", epochs=12),
    INSTACART,
    dict(INSTACART, epochs=6),
    dict(ML1M, use_fused=False),
    dict(ML1M, on_gpu=False),
    dict(ML1M, num_items=100),                       # 1 block: candidate tail
    dict(ML1M, use_fused=False, x_if_any=True, num_if=4),
    dict(ML1M, train_step="mixed"),
    dict(INSTACART, epochs=6, **INSTACART_FEATURES),
    dict(INSTACART, epochs=10, x_if_any=True, num_if=21),
    dict(ML1M, **ML1M_FEATURES),
    dict(INSTACART, epochs=6, tail_windows=8),
    dict(INSTACART, num_items=32_655, tail_windows=64),
    dict(ML1M, train_step="mixed", tail_windows=8),
    dict(ML1M, num_items=9500, train_step="mixed", tail_windows=8),
    dict(INSTACART, epochs=6, tail_windows=3),
    dict(ML1M, shuffle_layouts=4),
    dict(INSTACART, shuffle_layouts=4, tail_windows=8),
    dict(ML1M, shuffle_layouts=4, use_fused=False),
], ids=["ml1m-headline", "3-block-window", "bpr", "instacart",
        "instacart-6-epochs", "not-fused", "no-backend", "candidate-tail",
        "features-not-fused", "ml1m-mixed", "instacart-features-6-epochs",
        "instacart-item-features-10-epochs", "ml1m-features-chunk-tail",
        "instacart-wide-tail", "instacart-wide-tail-clamped",
        "ml1m-wide-tail", "9500-items-wide-tail", "instacart-tail-3-windows",
        "ml1m-shuffle-layouts", "instacart-layouts-and-wide-tail",
        "layouts-not-fused"])
def test_plan_equals_jax_plan(spec):
    on_gpu = spec.get("on_gpu", True)
    spec = {k: v for k, v in spec.items() if k != "on_gpu"}
    got = tplanner.plan_fit(tplanner.FitSpec(on_gpu=on_gpu, **spec))
    want = jplanner.plan_fit(jplanner.FitSpec(on_tpu=on_gpu, **spec))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_instacart_plan_is_the_mixed_schedule():
    """The Instacart headline: 33 window blocks, fused main epochs (chunk
    128 @ user block 1,024, 4 windows per chunk), then a candidate tail at
    batch 8,192 with post-hoc rejection."""
    plan = tplanner.plan_fit(tplanner.FitSpec(on_gpu=True, **INSTACART))
    assert plan.fused and plan.nblk == 33 and plan.table_mode == "bf16"
    assert (plan.batch_size, plan.chunk, plan.user_block) == (32768, 128, 1024)
    assert tfused.default_n_windows(plan.nblk) == 4 and plan.n_windows is None
    assert (plan.n_main, plan.n_tail, plan.chunk_tail) == (27, 3, 0)
    assert (plan.xla_batch, plan.post_reject, plan.rounds) == (8192, True, 3)
    short = tplanner.plan_fit(tplanner.FitSpec(
        on_gpu=True, **dict(INSTACART, epochs=6)))
    assert (short.n_main, short.n_tail) == (5, 1)
    assert tplanner.plan_fit(tplanner.FitSpec(
        on_gpu=True, **dict(ML1M, use_fused=False))).step_kind == "window"


def test_featured_plans_are_fused():
    """Side features stay on the fused engine: the featured Instacart plans
    are the mixed schedule (bf16 table mode on the TPU, batch 32,768,
    chunk 128 @ user block 1,024, 4 windows), the featured ML-1M plan the
    main layout plus its chunk-tail."""
    for epochs, n_main in ((6, 5), (10, 9)):
        for feats in (INSTACART_FEATURES, dict(x_if_any=True, num_if=21)):
            plan = tplanner.plan_fit(tplanner.FitSpec(
                on_gpu=True, **dict(INSTACART, epochs=epochs, **feats)))
            assert plan.fused and plan.table_mode == "bf16"
            assert (plan.batch_size, plan.chunk, plan.user_block) == (
                32768, 128, 1024)
            assert (plan.n_main, plan.n_tail, plan.step_kind) == (
                n_main, 1, "candidate")
    plan = tplanner.plan_fit(tplanner.FitSpec(
        on_gpu=True, **dict(ML1M, epochs=3, **ML1M_FEATURES)))
    assert plan.fused and (plan.chunk, plan.user_block) == (256, 1024)
    assert (plan.n_main, plan.chunk_tail, plan.tail_chunk,
            plan.tail_user_block) == (3, 1, 128, 256)


def test_wide_tail_and_layouts_resolve_as_in_the_jax_package():
    """The Instacart headline (32,655 products) plans in bf16 table mode,
    where the window budget admits 9 windows a chunk: ``tail_windows=8``
    resolves to 8 and larger requests to 9; ML-1M (4 blocks) caps the tail
    at 4. Cycled layouts turn the chunk-tail schedule off."""
    assert tfused.max_n_windows(10_000, 32_655, True) == 9
    for want, tw in ((8, 8), (9, 64)):
        plan = tplanner.plan_fit(tplanner.FitSpec(
            on_gpu=True, **dict(INSTACART, num_items=32_655, epochs=6,
                                tail_windows=tw)))
        assert plan.table_bf16 and plan.tail_windows == want
        assert (plan.n_main, plan.n_tail) == (5, 1)
    plan = tplanner.plan_fit(tplanner.FitSpec(
        on_gpu=True, **dict(ML1M, train_step="mixed", tail_windows=8)))
    assert plan.nblk == 4 and plan.tail_windows == 4
    plan = tplanner.plan_fit(tplanner.FitSpec(
        on_gpu=True, **dict(ML1M, shuffle_layouts=4)))
    assert plan.shuffle_layouts == 4 and plan.chunk_tail == 0
