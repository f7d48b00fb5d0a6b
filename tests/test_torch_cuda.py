"""The kernels on the card (the fused chunk step, with and without side
features, the sorted and dense table updates, filtered top-N retrieval,
the initial tables' normal draws, numpy's bit for bit), the build and dispatch rules around them, and the host half on a CUDA model (checkpoints between
card and CPU, the record cache, the ALS baseline).

Tests marked ``cuda`` need an NVIDIA GPU with nvcc and skip without one;
run them there with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
This file imports no JAX, so it runs where only the port is installed.

Fused kernel vs plain version on the same inputs and the same Philox
draws: the kernel sums in 64-bit fixed point and in other orders than the
plain version's f32 products, so the tables agree to ~1e-5 absolute
(checked at 1e-4), the log-likelihood to 1e-4 relative, and at least 99.9%
of the rows choose the same negative.

Table-update kernels vs `table_update_reference` on the same inputs: the
kernels sum a row's updates in 64-bit fixed point, ``index_add_`` in f32
in its own order, so the tables agree to ~1e-7 absolute even for a row
that takes all 16,384 updates; checked at 1e-5. Rows that no update
touches stay bit-equal.

Every kernel sums in an order fixed by its inputs: the same call twice
gives equal bytes, and so do two fits from the same seed.
"""

from collections import Counter

import numpy as np
import pytest
import torch

from rankfm_tpu_torch.ops import _build
from rankfm_tpu_torch.ops import fused
from rankfm_tpu_torch.ops import init
from rankfm_tpu_torch.ops import scatter
from rankfm_tpu_torch.ops import topk


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# shapes at the edges of the kernel's score tiles (32 rows x 64 slots,
# depth steps of 32): an odd and small row width, one above a depth step,
# the smallest window block, a user block that is no power of two
EDGES = {"base": {}, "F7": dict(F=7), "F50": dict(F=50),
         "BLK128": dict(I=120), "UB608": dict(U=600, ub=None)}


def _case(dev, nw, rng, n_uf=0, n_if=0, U=700, I=2500, F=20, ub=256):
    """A 2,048-row batch at chunk 128 @ user block ``ub`` (256: three user
    blocks) over the window blocks of ``I`` items (2,500: 3 blocks of
    1,024), with ``n_uf`` user / ``n_if`` item feature columns (one-hot
    plus a multi-hot column; none when 0). Groups are padded to whole
    chunks, so chunks end in guard records."""
    C = 128
    hist = rng.random((U, I)) < 0.3
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(hist.sum(1))
    flat = np.nonzero(hist)[1].astype(np.int32)
    packed = torch.from_numpy(fused.pack_history(offsets, flat, U, I)).to(dev)
    u, i = np.nonzero(hist)
    pick = rng.choice(len(u), 6000, replace=False)
    rec, _, cids, ublk, iblk = fused.make_records_grouped(
        u[pick], i[pick], rng.uniform(0.5, 2.0, 6000).astype(np.float32),
        U, I, 2048, C, ub=ub)
    # the fullest batch that still holds guard records
    n_valid = ((rec[:, 0] >> 21) & 1).reshape(-1, C).sum(1)[cids].sum(1)
    nT = cids.shape[1]
    b = int(np.argmax(np.where(n_valid < nT * C, n_valid, -1)))
    rec_b = torch.from_numpy(rec).to(dev).view(-1, C, 2)[
        torch.from_numpy(cids[b]).to(dev).long()].reshape(-1, 2)
    ublk, iblk = ublk[b:b + 1], iblk[b:b + 1]
    # windows: random blocks, a repeated block, and the positive block
    nblk = fused.item_pad(I) // fused.block_size(I)
    blk = rng.integers(0, nblk, (nT, nw)).astype(np.int32)
    blk[:, 0] = iblk[0]
    if nw > 1:
        blk[::2, 1] = blk[::2, 0]
    tabs = fused.extend_tables(
        torch.from_numpy(rng.normal(0, 0.05, I).astype(np.float32)).to(dev),
        torch.from_numpy(rng.normal(0, 0.1, (U, F)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.normal(0, 0.1, (I, F)).astype(np.float32)).to(dev),
        fused.user_pad(U, ub), fused.item_pad(I))
    feats = {}
    for side, n, rows, pad in (("uf", n_uf, U, fused.user_pad(U, ub)),
                               ("if", n_if, I, fused.item_pad(I))):
        if n:
            x = np.zeros((rows, n), np.float32)
            x[np.arange(rows), rng.integers(0, n, rows)] = 1.0
            x[:, 0] = np.maximum(x[:, 0], rng.random(rows) < 0.2)
            feats[f"x_{side}"] = fused.pad_feature_cols(
                torch.from_numpy(x).to(dev), pad)
    if feats:
        tuf, tif = fused.extend_feature_tables(
            *(torch.from_numpy(rng.normal(0, sd, shape).astype(
                np.float32)).to(dev)
              for sd, shape in ((0.1, (max(n_uf, 1), F)), (0.05, max(n_if, 1)),
                                (0.1, (max(n_if, 1), F)))))
        if n_uf:
            feats["tab_uf"] = tuf
        if n_if:
            feats["tab_if"] = tif
    dreg = (float(np.float32(0.1) * np.float32(0.02)),
            float(np.float32(0.1) * np.float32(0.2)))
    args = (rec_b, packed, torch.from_numpy(blk).to(dev),
            torch.from_numpy(ublk[0]).to(dev), torch.from_numpy(iblk[0]).to(dev),
            77, 0.1, dreg)
    kw = dict(factors=F, ub_rows=fused.user_block(U, ub), num_items=I)
    return (tabs, feats) if feats else tabs, args, kw, nT * C


@pytest.mark.cuda
@pytest.mark.parametrize("M,nw,edge", [
    (1, 1, "base"), (20, 1, "base"), (20, 4, "base"), (20, 4, "F7"),
    (1, 1, "F7"), (20, 4, "F50"), (20, 1, "BLK128"), (20, 4, "BLK128"),
    (20, 4, "UB608"), (1, 4, "UB608")])
def test_kernel_matches_plain_version(cuda, M, nw, edge):
    rng = np.random.default_rng(M * 10 + nw)
    tabs, args, kw, rows = _case(cuda, nw, rng, **EDGES[edge])
    assert not ((args[0][:, 0] >> 21) & 1).bool().all()   # guard records
    tk = [t.clone() for t in tabs]
    tr = [t.clone() for t in tabs]
    ch_k = torch.empty(rows, dtype=torch.int32, device=cuda)
    ch_r = torch.empty_like(ch_k)
    before = dict(fused.LAUNCHES)
    ll_k = float(fused.fused_batch(*tk, *args, max_samples=M, chosen=ch_k, **kw))
    assert sum(fused.LAUNCHES.values()) == sum(before.values()) + 1
    ll_r = float(fused.fused_batch_reference(*tr, *args, max_samples=M,
                                             chosen=ch_r, **kw))
    assert abs(ll_k - ll_r) <= 1e-4 * abs(ll_r)
    valid = ((args[0][:, 0] >> 21) & 1).bool()
    assert (ch_k == ch_r)[valid].float().mean() >= 0.999
    assert ((ch_k[~valid] == -1).all() and (ch_r[~valid] == -1).all())
    for a, b, t0 in zip(tk, tr, tabs):
        assert float((a - b).abs().max()) <= 1e-4
        assert float((a - t0).abs().max()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("n_uf,n_if,edge", [
    (21, 18, "base"), (30, 0, "base"), (0, 18, "base"), (21, 18, "F7"),
    (21, 18, "F50"), (0, 18, "F50"), (21, 18, "BLK128"), (30, 0, "UB608")],
    ids=["both", "user-only", "item-only", "both-F7", "both-F50",
         "item-only-F50", "both-BLK128", "user-only-UB608"])
def test_featured_kernel_matches_plain_version(cuda, n_uf, n_if, edge):
    """The featured kernel against its plain version: the row tables and
    the feature tables to 1e-4 absolute (fixed-point sums in other orders),
    the ll to 1e-4 relative, 99.9% of the negatives equal."""
    rng = np.random.default_rng(n_uf + n_if)
    (tabs, feats), args, kw, rows = _case(cuda, 4, rng, n_uf, n_if,
                                          **EDGES[edge])
    tk = [t.clone() for t in tabs]
    tr = [t.clone() for t in tabs]
    fk = {k: v.clone() for k, v in feats.items()}
    fr = {k: v.clone() for k, v in feats.items()}
    ch_k = torch.empty(rows, dtype=torch.int32, device=cuda)
    ch_r = torch.empty_like(ch_k)
    key = (128, kw["ub_rows"], n_uf > 0, n_if > 0, 4)
    before = fused.LAUNCHES[key]
    ll_k = float(fused.fused_batch(*tk, *args, max_samples=20, chosen=ch_k,
                                   **kw, **fk))
    assert fused.LAUNCHES[key] == before + 1
    ll_r = float(fused.fused_batch_reference(*tr, *args, max_samples=20,
                                             chosen=ch_r, **kw, **fr))
    assert abs(ll_k - ll_r) <= 1e-4 * abs(ll_r)
    valid = ((args[0][:, 0] >> 21) & 1).bool()
    assert (ch_k == ch_r)[valid].float().mean() >= 0.999
    for a, b, t0 in zip(tk, tr, tabs):
        assert float((a - b).abs().max()) <= 1e-4
        assert float((a - t0).abs().max()) > 0
    for name in ("tab_uf", "tab_if"):
        if name in feats:
            assert float((fk[name] - fr[name]).abs().max()) <= 1e-4
            assert float((fk[name] - feats[name]).abs().max()) > 0


def _ties_case(dev, rng, nw=4, free_windows=False):
    """A batch whose rows see many exactly tied keys: every item row has
    the same factors, the positives (items of the first three blocks) a
    bias of 2.5 and the window items (blocks 3 to 8) one of 1.0, so every
    window slot is a non-violator at pw = 1.5 and every slot of the
    Bernoulli subset ties at the key maximum (those off it tie at the 1e6
    offset). ``free_windows``: no history member past block 2, the
    windows among the full blocks 3 to 7, and no item factors, so every
    window slot is a non-member at exactly the same pw."""
    U, I, F, C, ub = 700, 9000, 20, 128, 256
    hist = rng.random((U, I)) < 0.05
    if free_windows:
        hist[:, 3072:] = False
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(hist.sum(1))
    packed = torch.from_numpy(fused.pack_history(
        offsets, np.nonzero(hist)[1].astype(np.int32), U, I)).to(dev)
    u, i = np.nonzero(hist[:, :3072])
    pick = rng.choice(len(u), 6000, replace=False)
    rec, _, cids, ublk, iblk = fused.make_records_grouped(
        u[pick], i[pick], np.ones(6000, np.float32), U, I, 2048, C, ub=ub)
    nT = cids.shape[1]
    rec_b = torch.from_numpy(rec).to(dev).view(-1, C, 2)[
        torch.from_numpy(cids[0]).to(dev).long()].reshape(-1, 2)
    blk = rng.integers(3, 8 if free_windows else 9, (nT, nw)).astype(np.int32)
    w_i = np.where(np.arange(I) < 3072, 2.5, 1.0).astype(np.float32)
    v_i = np.tile(rng.normal(0, 0.1, F).astype(np.float32), (I, 1))
    if free_windows:
        v_i[:] = 0.0
    tabs = fused.extend_tables(
        torch.from_numpy(w_i).to(dev),
        torch.from_numpy(rng.normal(0, 0.1, (U, F)).astype(np.float32)).to(dev),
        torch.from_numpy(v_i).to(dev), fused.user_pad(U, ub),
        fused.item_pad(I))
    args = (rec_b, packed, torch.from_numpy(blk).to(dev),
            torch.from_numpy(ublk[0]).to(dev),
            torch.from_numpy(iblk[0]).to(dev), 5, 0.1, (0.002, 0.02))
    kw = dict(factors=F, ub_rows=fused.user_block(U, ub), num_items=I)
    return tabs, args, kw, nT * C


# (name, max_samples, windows, user / item feature columns, _case shape);
# "instacart-nw*": chunk 128 @ user block 1,024 over 9 blocks of 1,024
# items at F 50, with 4 windows per chunk (the main epochs) and 8 (the
# wide tail)
REPEAT_CASES = (
    ("base", 20, 4, 0, 0, {}),
    ("bpr", 1, 1, 0, 0, {}),
    ("featured", 20, 4, 21, 18, {}),
    ("user-features", 20, 1, 30, 0, dict(F=50)),
    ("instacart-nw4", 50, 4, 0, 0, dict(I=9000, F=50, ub=1024)),
    ("instacart-nw8", 50, 8, 0, 0, dict(I=9000, F=50, ub=1024)),
    ("ties", 50, 4, 0, 0, None),
)


@pytest.mark.cuda
@pytest.mark.parametrize("name,M,nw,n_uf,n_if,shape", REPEAT_CASES,
                         ids=[c[0] for c in REPEAT_CASES])
def test_kernel_repeats_bit_for_bit(cuda, name, M, nw, n_uf, n_if, shape):
    """The same batch twice from the same tables: every table, every ll
    term and every chosen slot equal to the byte (the kernel sums in an
    order fixed by its inputs). The tied case does tie: many rows have
    more than one slot at the key maximum."""
    rng = np.random.default_rng(11)
    if shape is None:
        tabs, args, kw, rows = _ties_case(cuda, rng, nw)
        feats = {}
    else:
        case, args, kw, rows = _case(cuda, nw, rng, n_uf, n_if, **shape)
        tabs, feats = case if n_uf or n_if else (case, {})
    outs = []
    for _ in range(2):
        tk = [t.clone() for t in tabs]
        fk = {k: v.clone() for k, v in feats.items()}
        ch = torch.empty(rows, dtype=torch.int32, device=cuda)
        ll = torch.empty(rows, dtype=torch.float32, device=cuda)
        fused.fused_batch(*tk, *args, max_samples=M, chosen=ch, ll_rows=ll,
                          **kw, **fk)
        outs.append(tk + [fk[k] for k in sorted(fk)] + [ch, ll])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert torch.isfinite(outs[0][-1]).all()
    if shape is None:
        keys = []
        tr = [t.clone() for t in tabs]
        fused.fused_batch_reference(*tr, *args, max_samples=M, keys=keys,
                                    **kw)
        n_max = torch.cat([(k == k.max(1, keepdim=True).values).sum(1)
                           for k in keys])
        assert int((n_max > 1).sum()) >= rows // 4
        assert int(n_max.max()) >= 20


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [4, 8])
def test_kernel_lists_every_window_slot_when_all_tie(cuda, nw):
    """No window slot is a member and ``max_samples`` is the window's
    width, so the Bernoulli subset holds every slot and, in the first
    chunk (later chunks see the rows it moved), all ``nw * 1,024`` of
    them tie at the key maximum: the tied-slot list fills the whole of
    its shared-memory row. Two calls give equal bytes, and the kernel
    agrees with its plain version."""
    W2 = nw * 1024
    rng = np.random.default_rng(12)
    tabs, args, kw, rows = _ties_case(cuda, rng, nw, free_windows=True)
    keys = []
    tr = [t.clone() for t in tabs]
    ch_r = torch.empty(rows, dtype=torch.int32, device=cuda)
    ll_r = float(fused.fused_batch_reference(
        *tr, *args, max_samples=W2, chosen=ch_r, keys=keys, **kw))
    n_max = (keys[0] == keys[0].max(1, keepdim=True).values).sum(1)
    valid = ((args[0][:, 0] >> 21) & 1).bool()
    assert int(valid[:len(n_max)].sum()) >= 64
    assert bool((n_max[valid[:len(n_max)]] == W2).all())
    outs = []
    for _ in range(2):
        tk = [t.clone() for t in tabs]
        ch = torch.empty(rows, dtype=torch.int32, device=cuda)
        ll = torch.empty(rows, dtype=torch.float32, device=cuda)
        fused.fused_batch(*tk, *args, max_samples=W2, chosen=ch, ll_rows=ll,
                          **kw)
        torch.cuda.synchronize()
        outs.append(tk + [ch, ll])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert abs(float(outs[0][-1].sum()) - ll_r) <= 1e-4 * abs(ll_r)
    assert (outs[0][-2] == ch_r)[valid].float().mean() >= 0.999
    for a, b in zip(outs[0][:len(tabs)], tr):
        assert float((a - b).abs().max()) <= 1e-4


@pytest.mark.cuda
def test_kernel_refuses_windows_beyond_shared_memory(cuda):
    """A row's keys and its tied-slot list live in shared memory: 40
    windows of 1,024 items need more than a block of an H100 has, and the
    wrapper says so instead of launching (the tables are left as they
    were); 36 windows still fit."""
    rng = np.random.default_rng(8)
    tabs, args, kw, _ = _case(cuda, 1, rng, U=64, I=41_000, ub=None)
    before = [t.clone() for t in tabs]
    for nw, fits in ((40, False), (36, True)):
        blk = torch.from_numpy(rng.integers(
            0, 41, (args[2].shape[0], nw)).astype(np.int32)).to(cuda)
        call = lambda: fused.fused_batch(  # noqa: E731
            *tabs, args[0], args[1], blk, *args[3:], max_samples=5, **kw)
        if fits:
            call()
            torch.cuda.synchronize()
        else:
            with pytest.raises(ValueError, match="shared memory"):
                call()
            for t, t0 in zip(tabs, before):
                assert torch.equal(t, t0)


@pytest.mark.cuda
def test_featured_kernel_wrapper_rejects_bad_feature_shapes(cuda):
    rng = np.random.default_rng(0)
    (tabs, feats), args, kw, _ = _case(cuda, 1, rng, 5, 6)
    kw = dict(kw, max_samples=5)
    bad = dict(feats, tab_if=feats["tab_if"][:, :-1].contiguous())
    with pytest.raises(ValueError, match="inconsistent shapes"):
        fused.fused_batch(*tabs, *args, **kw, **bad)
    bad = dict(feats, x_if=feats["x_if"][:, :4].contiguous())
    with pytest.raises(ValueError, match="inconsistent shapes"):
        fused.fused_batch(*tabs, *args, **kw, **bad)
    bad = dict(feats, x_uf=feats["x_uf"].double())
    with pytest.raises(ValueError, match="x_uf"):
        fused.fused_batch(*tabs, *args, **kw, **bad)
    bad = dict(feats, tab_uf=feats["tab_uf"].cpu())
    with pytest.raises(ValueError, match="tab_uf"):
        fused.fused_batch(*tabs, *args, **kw, **bad)


@pytest.mark.cuda
def test_gpu_fit_matches_cpu_fit(cuda):
    """A whole fit through the kernel and through the plain version: both
    draw the same shuffles, windows and Philox bits, so they differ only by
    f32 summation order (both layouts run: 3 epochs end in the
    chunk-tail)."""
    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(500), 30)
    train = np.stack([users, rng.integers(0, 2300, len(users))], 1)
    cfg = dict(factors=12, loss="warp", max_samples=10,
               learning_schedule="invscaling")
    before = sum(fused.LAUNCHES.values())
    mg = RankFM(**cfg, device="cuda").fit(train, epochs=3)
    assert sum(fused.LAUNCHES.values()) > before
    mc = RankFM(**cfg, device="cpu").fit(train, epochs=3)
    assert mg.last_fit_plan_ == mc.last_fit_plan_
    assert mg.last_fit_plan_.chunk_tail == 1
    for k in ("w_i", "v_u", "v_i"):
        want = mc._weights[k]
        assert np.abs(mg._weights[k] - want).max() <= 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(
        [r["log_likelihood"] for r in mg.training_log_],
        [r["log_likelihood"] for r in mc.training_log_], rtol=1e-4)


@pytest.mark.cuda
def test_gpu_featured_fit_matches_cpu_fit(cuda):
    """A featured fit through the featured kernel and through the plain
    version (3 epochs: main layout, then the chunk-tail with the user
    features re-padded): the same draws, so the six weight tensors differ
    only by f32 summation order."""
    import pandas as pd

    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(4)
    users = np.repeat(np.arange(500), 30)
    train = np.stack([users, rng.integers(0, 2300, len(users))], 1)
    uids, iids = np.unique(train[:, 0]), np.unique(train[:, 1])
    uf = pd.DataFrame({"user_id": uids})
    for k in range(4):
        uf[f"uf{k}"] = (uids % 4 == k).astype(np.float32)
    itf = pd.DataFrame({"item_id": iids})
    for k in range(6):
        itf[f"if{k}"] = (iids % 6 == k).astype(np.float32)
    cfg = dict(factors=12, loss="warp", max_samples=10,
               learning_schedule="invscaling")
    fused.LAUNCHES.clear()
    mg = RankFM(**cfg, device="cuda").fit(
        train, user_features=uf, item_features=itf, epochs=3)
    plan = mg.last_fit_plan_
    assert plan.fused and plan.chunk_tail == 1
    by_layout = Counter()
    for k, n in fused.LAUNCHES.items():
        by_layout[k[:4]] += n
    assert by_layout[(plan.chunk, fused.user_block(500), True, True)] > 0
    assert by_layout[(plan.tail_chunk, plan.tail_user_block, True, True)] > 0
    assert not any(not (k[2] and k[3]) for k in fused.LAUNCHES)
    mc = RankFM(**cfg, device="cpu").fit(
        train, user_features=uf, item_features=itf, epochs=3)
    assert mg.last_fit_plan_ == mc.last_fit_plan_
    for k in ("w_i", "v_u", "v_i", "w_if", "v_uf", "v_if"):
        want = mc._weights[k]
        assert np.abs(mg._weights[k] - want).max() <= 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(
        [r["log_likelihood"] for r in mg.training_log_],
        [r["log_likelihood"] for r in mc.training_log_], rtol=1e-4)


# (name, RankFM keyword arguments, with side features): one fit per engine
# and fit feature, run twice from one seed
REPEAT_FITS = (
    ("fused-chunk-tail", dict(epochs=3), False),
    ("fused-features", dict(epochs=3), True),
    ("mixed", dict(train_step="mixed", epochs=6), False),
    ("mixed-features", dict(train_step="mixed", epochs=6), True),
    ("window-step", dict(use_fused=False, train_step="window", epochs=2),
     False),
    ("candidate-step", dict(use_fused=False, train_step="candidate",
                            epochs=2), False),
    ("wide-tail", dict(train_step="mixed", tail_windows=3, epochs=6), False),
    ("shuffle-layouts", dict(shuffle_layouts=4, epochs=5), False),
)


@pytest.mark.cuda
@pytest.mark.parametrize("name,kw,features", REPEAT_FITS,
                         ids=[f[0] for f in REPEAT_FITS])
def test_same_seed_fits_on_the_card_are_equal(cuda, name, kw, features):
    """Two fits from one seed on the card end with equal weights, to the
    byte, on every engine (the kernels sum in an order fixed by their
    inputs); the plan is the one named."""
    import pandas as pd

    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(6)
    users = np.repeat(np.arange(600), 25)
    train = np.stack([users, rng.integers(0, 2500, len(users))], 1)
    fkw = {}
    if features:
        uids, iids = np.unique(train[:, 0]), np.unique(train[:, 1])
        fkw = dict(
            user_features=pd.DataFrame({"user_id": uids, **{
                f"uf{k}": (uids % 4 == k).astype(np.float32)
                for k in range(4)}}),
            item_features=pd.DataFrame({"item_id": iids, **{
                f"if{k}": (iids % 6 == k).astype(np.float32)
                for k in range(6)}}))
    kw = dict(kw)
    epochs = kw.pop("epochs")
    cfg = dict(factors=12, loss="warp", max_samples=10,
               learning_schedule="invscaling", device="cuda", **kw)
    models = [RankFM(**cfg).fit(train, epochs=epochs, **fkw)
              for _ in range(2)]
    plan = models[0].last_fit_plan_
    assert plan.fused == (kw.get("use_fused") is not False)
    if "tail_windows" in kw:
        assert plan.tail_windows == 3 and plan.n_tail == 1
    if "shuffle_layouts" in kw:
        assert plan.shuffle_layouts == 4
    for k, v in models[0]._weights.items():
        assert np.array_equal(v, models[1]._weights[k]), k


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    tabs, args, kw, _ = _case(cuda, 1, rng)
    bad_rec = args[0].to(torch.int64)
    with pytest.raises(ValueError, match="rec"):
        fused.fused_batch(*tabs, bad_rec, *args[1:], max_samples=5, **kw)
    with pytest.raises(ValueError, match="packed"):
        fused.fused_batch(*tabs, args[0], args[1].cpu(), *args[2:],
                          max_samples=5, **kw)


def _table_case(dev, N, B2, F, pattern, with_bias, seed=0):
    """``pattern``: 'uniform' rows; 'one-row' (every update on row 7);
    'popular' (power-law rows); 'validity-0' (live updates of validity 0,
    and rows whose updates all carry validity 0); 'skipped' (every ``idx``
    is -1). A tenth of the updates is skipped in every pattern."""
    rng = np.random.default_rng(seed)
    tab = torch.from_numpy(rng.normal(0, 0.1, (N, F)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(0, 0.1, N).astype(np.float32))
    if pattern == "one-row":
        idx = np.full(B2, 7, np.int32)
    elif pattern == "popular":
        pop = 1.0 / np.arange(1, N + 1) ** 0.9
        idx = rng.choice(N, size=B2, p=pop / pop.sum()).astype(np.int32)
    else:
        idx = rng.integers(0, N, B2).astype(np.int32)
    idx[rng.random(B2) < 0.1] = -1                    # skipped rows
    if pattern == "skipped":
        idx[:] = -1
    upd = rng.normal(0, 0.1, (B2, F + 2)).astype(np.float32)
    upd[:, F + 1] = (idx >= 0).astype(np.float32)
    if pattern == "validity-0":
        upd[(idx % 5 == 0) | (rng.random(B2) < 0.3), F + 1] = 0.0
    return (tab.to(dev), bias.to(dev) if with_bias else None,
            torch.from_numpy(idx).to(dev), torch.from_numpy(upd).to(dev))


def _assert_update_matches(tk, bk, tab, bias, idx, upd, eta, c):
    """The kernel's ``tk`` / ``bk`` against the plain version applied to
    ``tab`` / ``bias``: touched rows within 1e-5, every other row
    bit-equal. Returns the plain version's result."""
    N = tab.shape[0]
    tr, br = scatter.table_update_reference(
        tab.clone(), None if bias is None else bias.clone(), idx, upd, eta, c)
    assert float((tk - tr).abs().max()) <= 1e-5
    touched = torch.zeros(N, dtype=torch.bool, device=tab.device)
    touched[idx[(idx >= 0) & (idx < N)].long()] = True
    assert torch.equal(tk[~touched], tab[~touched])       # only touched rows
    if touched.any():
        assert float((tk[touched] - tab[touched]).abs().max()) > 0
    if bias is not None:
        assert float((bk - br).abs().max()) <= 1e-5
        assert torch.equal(bk[~touched], bias[~touched])
    return tr, br


@pytest.mark.cuda
@pytest.mark.parametrize("N,B2,F,kernel,pattern,with_bias", [
    (33_362, 16_384, 50, "sorted", "uniform", True),   # Instacart item table
    (10_000, 8_192, 50, "dense", "uniform", False),    # Instacart user table
    (33_362, 16_384, 50, "sorted", "one-row", True),   # all on one row
    (33_362, 16_384, 50, "dense", "one-row", True),
    (1_000_000, 16_384, 64, "sorted", "uniform", True),    # web-scale items
    (3_706, 16_384, 20, "dense", "popular", True),     # ML-1M window step
    (6_040, 8_192, 20, "dense", "uniform", False),
    (20_000, 4_096, 7, "sorted", "uniform", False),    # odd rows: scalar adds
    (9_000, 4_096, 7, "dense", "uniform", False),
    (33_362, 16_384, 50, "sorted", "validity-0", True),
    (33_362, 16_384, 50, "dense", "validity-0", True),
    (33_362, 16_384, 50, "sorted", "skipped", True),   # every idx is -1
    (10_000, 8_192, 50, "dense", "skipped", True),
    (20_000, 4_099, 50, "sorted", "uniform", True),    # B2 % 8 != 0
    (3_000, 1_001, 20, "dense", "uniform", True),
], ids=["items-sorted", "users-dense", "concentrated-sorted",
        "concentrated-dense", "webscale-sorted", "ml1m-items-dense",
        "ml1m-users-dense", "F7-no-bias-sorted", "F7-no-bias-dense",
        "validity0-sorted", "validity0-dense", "all-skipped-sorted",
        "all-skipped-dense", "ragged-sorted", "ragged-dense"])
def test_table_update_kernels_match_plain_version(cuda, N, B2, F, kernel,
                                                  pattern, with_bias):
    tab, bias, idx, upd = _table_case(cuda, N, B2, F, pattern, with_bias)
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    if pattern not in ("one-row", "validity-0"):    # those go through both
        assert scatter._regime(N, B2, F) == kernel
    tk = tab.clone()
    bk = None if bias is None else bias.clone()
    before = scatter.LAUNCHES[kernel]
    launch = getattr(scatter, f"table_update_{kernel}")
    out = launch(tk, bk, idx, upd, eta, c)
    torch.cuda.synchronize()
    assert out[0] is tk and out[1] is bk
    assert scatter.LAUNCHES[kernel] == before + 1
    _assert_update_matches(tk, bk, tab, bias, idx, upd, eta, c)
    # the kernel left its scratch clean (the accumulator, 'sorted': and the
    # claims)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not scatter.scratch(tab.device, stream, N, kernel, F, B2).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,N,B2", [("sorted", 33_362, 16_384),
                                         ("dense", 10_000, 8_192)])
def test_table_updates_in_a_row_share_clean_scratch(cuda, kernel, N, B2):
    """Two tables of equal shape updated in turns, twice each, with
    different rows each time: they share one scratch (same device, stream
    and shape), which every call must leave clean for the next."""
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    launch = getattr(scatter, f"table_update_{kernel}")
    cases = [_table_case(cuda, N, B2, 50, "uniform", True, seed=s)
             for s in range(4)]
    tabs = [[cases[k][0].clone(), cases[k][1].clone()] for k in (0, 1)]
    want = [[cases[k][0].clone(), cases[k][1].clone()] for k in (0, 1)]
    for step, (_, _, idx, upd) in enumerate(cases):
        k = step % 2
        launch(*tabs[k], idx, upd, eta, c)
        before = [t.clone() for t in want[k]]
        scatter.table_update_reference(*want[k], idx, upd, eta, c)
        _assert_update_matches(*tabs[k], *before, idx, upd, eta, c)
        # the chain stays on the plain version's values
        for t, w in zip(tabs[k], want[k]):
            assert float((t - w).abs().max()) <= 1e-5
            t.copy_(w)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not scatter.scratch(tabs[0][0].device, stream, N, kernel, 50,
                               B2).any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,N,B2,pattern", [
    ("sorted", 33_362, 16_384, "uniform"), ("dense", 10_000, 8_192, "uniform"),
    ("sorted", 33_362, 16_384, "one-row"), ("dense", 33_362, 16_384, "one-row"),
    ("sorted", 3_706, 16_384, "popular"), ("dense", 3_706, 16_384, "popular")],
    ids=["items-sorted", "users-dense", "hot-row-sorted", "hot-row-dense",
         "popular-sorted", "popular-dense"])
def test_table_update_repeats_bit_for_bit(cuda, kernel, N, B2, pattern):
    """The same update twice on copies of one table: equal bytes, also when
    every update lands on one row (integer sums do not depend on the order
    of the atomics)."""
    tab, bias, idx, upd = _table_case(cuda, N, B2, 50, pattern, True)
    launch = getattr(scatter, f"table_update_{kernel}")
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    got = [launch(tab.clone(), bias.clone(), idx, upd, eta, c)
           for _ in range(2)]
    assert torch.equal(got[0][0], got[1][0])
    assert torch.equal(got[0][1], got[1][1])


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sorted", "dense"])
def test_table_update_marks_rows_it_cannot_sum(cuda, kernel):
    """A gradient that is not finite, or too large for the fixed point,
    turns its row (and only its row) to NaN, as an f32 sum would have; the
    scratch is left clean for the next call."""
    tab, bias, idx, upd = _table_case(cuda, 3_000, 1_024, 20, "uniform", True)
    live = idx.cpu().numpy() >= 0
    p_inf, p_big = np.flatnonzero(live)[:2]
    upd[p_inf, 3] = float("inf")
    upd[p_big, 0] = 1e9
    bad_rows = {int(idx[p_inf]), int(idx[p_big])}
    launch = getattr(scatter, f"table_update_{kernel}")
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    tk, bk = launch(tab.clone(), bias.clone(), idx, upd, eta, c)
    nan_rows = set(torch.nonzero(torch.isnan(tk).any(1)).flatten().tolist())
    assert nan_rows == bad_rows
    stream = torch.cuda.current_stream(cuda).cuda_stream
    assert not scatter.scratch(tab.device, stream, 3_000, kernel, 20,
                               1_024).any()


@pytest.mark.cuda
def test_table_update_wrappers_reject_bad_inputs(cuda):
    tab, bias, idx, upd = _table_case(cuda, 3000, 1024, 8, "uniform", True)
    for launch in (scatter.table_update_sorted, scatter.table_update_dense):
        with pytest.raises(ValueError, match="idx"):
            launch(tab, bias, idx.long(), upd, 0.1, 0.998)
        with pytest.raises(ValueError, match="inconsistent shapes"):
            launch(tab, bias, idx, upd[:, :9].contiguous(), 0.1, 0.998)
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(tab.cpu(), bias.cpu(), idx.cpu(), upd.cpu(), 0.1, 0.998)


def _latent_log(rng, n_users=600, n_items=2500, per_user=50, sharp=2.0):
    """A learnable implicit log: Gumbel-top-k samples of a rank-6 latent
    score row plus a lognormal popularity skew (the generator of
    `tests/parity_common.make_latent_dataset`, which imports JAX)."""
    zu = rng.normal(size=(n_users, 6))
    zi = rng.normal(size=(n_items, 6))
    logits = (sharp * (zu @ zi.T) / np.sqrt(6)
              + np.log(rng.lognormal(0.0, 1.0, n_items))[None, :])
    gumbel = -np.log(-np.log(rng.random((n_users, n_items))))
    picks = np.argsort(-(logits + gumbel), axis=1)[:, :per_user]
    arr = np.stack([np.repeat(np.arange(n_users), per_user),
                    picks.reshape(-1)], 1).astype(np.int64)
    mask = rng.random(len(arr)) < 0.75
    return arr[mask], arr[~mask]


@pytest.mark.cuda
def test_gpu_mixed_fit_matches_cpu_mixed_fit(cuda):
    """The mixed schedule (9 fused epochs, then 1 candidate epoch through
    both table-update kernels) on the card and on the CPU: both draw the
    same bits (`_philox`), but the candidate step's full-catalog scoring
    sums in another order on each, so the two fits are held to each other
    within the oracle band (+-0.05 hit rate and DCG, +-0.03 precision and
    recall)."""
    from rankfm_tpu_torch import RankFM, evaluation

    train, test = _latent_log(np.random.default_rng(1492))
    cfg = dict(factors=16, loss="warp", max_samples=10,
               learning_schedule="invscaling", train_step="mixed")
    before = dict(scatter.LAUNCHES)
    mg = RankFM(**cfg, device="cuda").fit(train, epochs=10)
    assert mg.last_fit_plan_.fused and mg.last_fit_plan_.n_tail == 1
    assert scatter.LAUNCHES["dense"] > before.get("dense", 0)
    mc = RankFM(**cfg, device="cpu").fit(train, epochs=10)
    assert mg.last_fit_plan_ == mc.last_fit_plan_
    metrics = ("hit_rate", "discounted_cumulative_gain", "precision",
               "recall")
    got = evaluation.compute(mg, test, metrics=metrics, k=10)
    want = evaluation.compute(mc, test, metrics=metrics, k=10)
    gate = {"hit_rate": 0.05, "discounted_cumulative_gain": 0.05,
            "precision": 0.03, "recall": 0.03}
    for m, tol in gate.items():
        assert abs(got[m] - want[m]) <= tol, (m, got, want)


@pytest.mark.cuda
def test_gpu_window_fit_matches_cpu_window_fit(cuda):
    """``use_fused=False`` at 3 window blocks: the window step, both tables
    through the dense kernel on the card; held to the CPU fit within the
    oracle band, as the mixed fit above."""
    from rankfm_tpu_torch import RankFM, evaluation

    train, test = _latent_log(np.random.default_rng(7))
    cfg = dict(factors=16, loss="warp", max_samples=10,
               learning_schedule="invscaling", use_fused=False)
    scatter.LAUNCHES.clear()
    mg = RankFM(**cfg, device="cuda").fit(train, epochs=10)
    assert mg.last_fit_plan_.step_kind == "window"
    assert scatter.LAUNCHES["dense"] > 0 and scatter.LAUNCHES["sorted"] == 0
    mc = RankFM(**cfg, device="cpu").fit(train, epochs=10)
    metrics = ("hit_rate", "discounted_cumulative_gain", "precision",
               "recall")
    got = evaluation.compute(mg, test, metrics=metrics, k=10)
    want = evaluation.compute(mc, test, metrics=metrics, k=10)
    gate = {"hit_rate": 0.05, "discounted_cumulative_gain": 0.05,
            "precision": 0.03, "recall": 0.03}
    for m, tol in gate.items():
        assert abs(got[m] - want[m]) <= tol, (m, got, want)


@pytest.mark.cuda
def test_large_table_with_few_updates_takes_the_sorted_kernel(cuda):
    """512 updates on 1,000,000 x F 64: the dense accumulator would hold
    264 MB, over `scatter.DENSE_ACC_MAX_BYTES`, so the dispatch takes B3."""
    tab, bias, idx, upd = _table_case(cuda, 1_000_000, 512, 64, "uniform",
                                      True)
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    want = scatter.table_update_reference(tab.clone(), bias.clone(), idx, upd,
                                          eta, c)
    before = dict(scatter.LAUNCHES)
    got = scatter.apply_table_update(tab, bias, idx, upd, eta, c)
    assert scatter.LAUNCHES["sorted"] == before.get("sorted", 0) + 1
    assert scatter.LAUNCHES["dense"] == before.get("dense", 0)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_checkpoint_moves_between_card_and_cpu(cuda, tmp_path):
    """Saved on the card, loaded on the CPU and back: equal lists, scores
    within 1e-5, and `fit_partial` after `load` on the card follows the
    model that was never saved (same epoch stream; f32 summation order
    differs from run to run)."""
    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(500), 30)
    train = np.stack([1000 + users, rng.integers(0, 2300, len(users))], 1)
    cfg = dict(factors=12, loss="warp", max_samples=10,
               learning_schedule="invscaling")
    mg = RankFM(**cfg, device="cuda").fit(train, epochs=2)
    path = str(tmp_path / "card")
    mg.save(path)
    mc = RankFM.load(path, device="cpu")
    assert mc.device.type == "cpu" and mc._w["v_u"].device.type == "cpu"
    mc.save(str(tmp_path / "cpu"))
    mb = RankFM.load(str(tmp_path / "cpu"))           # the default: the card
    assert mb.device.type == "cuda" and mb._offsets_dev.is_cuda
    assert mb._rec_cache is None                      # no tensor carried over
    ids = np.unique(train[:, 0])[:200]
    for other in (mc, mb):
        for k, v in mg._weights.items():
            np.testing.assert_array_equal(v, other._weights[k])
        np.testing.assert_allclose(other.predict(train[:500]),
                                   mg.predict(train[:500]), atol=1e-5)
    assert mb.recommend(ids, 10, filter_previous=True).equals(
        mg.recommend(ids, 10, filter_previous=True))
    for m in (mg, mb):
        m.fit_partial(train, epochs=2)
    assert mg._epoch_offset == mb._epoch_offset == 4
    for k in ("w_i", "v_u", "v_i"):
        want = mg._weights[k]
        assert np.abs(mb._weights[k] - want).max() <= 1e-3 * np.abs(want).max()


@pytest.mark.cuda
def test_record_cache_on_the_card(cuda):
    """A second `fit_partial` on the same frame reuses the history pack and
    the record layouts on the card; a new `sample_weight` builds new
    layouts only; `last_fit_timing_` has the fused keys."""
    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(500), 30)
    train = np.stack([1000 + users, rng.integers(0, 2300, len(users))], 1)
    m = RankFM(factors=12, loss="warp", max_samples=10).fit(train, epochs=3)
    assert list(m.last_fit_timing_) == [
        "ingest_s", "hist_pack_s", "records_s", "prep_s", "epoch0_call_s",
        "dispatch_s", "block_s"]
    assert m.last_fit_plan_.chunk_tail == 1 and len(m._rec_cache) == 2
    packed, cached = m._packed_hist, dict(m._rec_cache)
    assert all(v[0].is_cuda for v in cached.values())
    m.fit_partial(train, epochs=3)
    assert m._packed_hist is packed
    assert all(m._rec_cache[k] is v for k, v in cached.items())
    m.fit_partial(train, sample_weight=np.full(len(train), 2.0, np.float32),
                  epochs=3)
    assert m._packed_hist is packed and len(m._rec_cache) == 4
    assert all(np.isfinite(v).all() for v in m._weights.values())


@pytest.mark.cuda
def test_als_on_the_card_matches_the_cpu(cuda):
    from rankfm_tpu_torch.baselines import ImplicitALS

    rng = np.random.default_rng(5)
    users = np.repeat(np.arange(600), 25)
    train = np.stack([users, rng.integers(0, 2500, len(users))], 1)
    kw = dict(factors=32, regularization=0.05, alpha=20.0, iterations=3)
    card = ImplicitALS(**kw).fit(train)               # 'cuda' by default
    cpu = ImplicitALS(**kw, device="cpu").fit(train)
    for a, b in ((card.user_factors, cpu.user_factors),
                 (card.item_factors, cpu.item_factors)):
        assert np.isfinite(a).all()
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max()


def test_table_update_refuses_other_devices():
    t = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        scatter.apply_table_update(t, None, torch.zeros(2, dtype=torch.int32,
                                                        device="meta"),
                                   torch.zeros((2, 6), device="meta"), 0.1,
                                   0.998)


def test_fused_batch_refuses_other_devices():
    t = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused.fused_batch(t, t, t, t, t, t, t, 0, 0.1, (0.002, 0.0), factors=2,
                          max_samples=1, ub_rows=8, num_items=8)


def test_build_raises_on_compiler_failure(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: fake nvcc refuses' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake nvcc refuses"):
        _build.build()


def test_build_is_keyed_by_content(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    # a stand-in compiler: count the call, write the -o file
    nvcc.write_text('#!/bin/sh\necho x >> "%s"\nwhile [ "$1" != "-o" ]; do '
                    'shift; done\ntouch "$2"\n' % calls)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    # four of fused_chunk.cu, one of table_update.cu, one of topk_select.cu,
    # one of pcg_normal.cu
    n_lib = len(_build.LIBS)
    assert n_lib == 7 and {src for src, _ in _build.LIBS.values()} \
        == set(_build.SOURCES)
    first = _build.build()
    assert _build.build() == first and first.exists()
    assert all((first / f"lib{name}.so").exists() for name in _build.LIBS)
    assert calls.read_text().count("x") == n_lib      # one nvcc per library
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.build() != first
    assert calls.read_text().count("x") == 2 * n_lib


def test_build_is_keyed_by_its_headers(tmp_path, monkeypatch):
    """A header the sources include is part of the content key: an edited
    ``ziggurat.h`` rebuilds every library."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text('#!/bin/sh\nwhile [ "$1" != "-o" ]; do shift; done\n'
                    'touch "$2"\n')
    nvcc.chmod(0o755)
    assert [h.name for h in _build.HEADERS] == ["ziggurat.h"]
    header = tmp_path / "ziggurat.h"
    header.write_bytes(_build.HEADERS[0].read_bytes())
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(_build, "HEADERS", (header,))
    first = _build.build()
    header.write_text(header.read_text() + "\n// edited\n")
    assert _build.build() != first


# ---------------------------------------------------------------------------
# the epoch on the card: device draws, device-memory scalars, CUDA graphs
# ---------------------------------------------------------------------------

def _graph_case(features=False):
    """A small log, fitted for one epoch on the card: the model whose
    engines the graph tests run."""
    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(5)
    users = np.repeat(np.arange(500), 24)
    train = np.stack([users, rng.integers(0, 2300, len(users))], 1)
    kw = {}
    if features:
        import pandas as pd

        for side, n, k in (("user", 500, 4), ("item", 2300, 3)):
            ids = np.unique(train[:, int(side == "item")])
            df = pd.DataFrame(np.eye(k, dtype=np.float32)[
                rng.integers(0, k, len(ids))],
                columns=[f"{side}{j}" for j in range(k)])
            df.insert(0, f"{side}_id", ids)
            kw[f"{side}_features"] = df
    return train, kw


def _engine_epoch(model, kind, batches=False):
    """``(fn, tables)`` of one epoch of the fitted model's fused engine
    (main layout) or of its candidate step, as `RankFM` runs them; with
    ``batches`` (candidate only) also the epoch's ``(rows, step, count)``
    for `graph.BatchGraph`."""
    from rankfm_tpu_torch.ops import training

    plan = model.last_fit_plan_
    U, I, F = len(model.user_idx), len(model.item_idx), model.factors
    dev = model.device
    w = model._w
    if kind == "fused":
        layout = tuple(torch.from_numpy(a).to(dev) for a in
                       fused.deal_by_fraction(fused.make_records_grouped(
                           model.interactions[:, 0], model.interactions[:, 1],
                           model.sample_weight, U, I, plan.batch_size,
                           plan.chunk, ub=plan.user_block), plan.chunk, U, I,
                           ub=plan.user_block))
        U_pad = fused.user_pad(U, plan.user_block)
        tu, ti = fused.extend_tables(w["w_i"], w["v_u"], w["v_i"], U_pad,
                                     fused.item_pad(I))
        tuf, tif = fused.extend_feature_tables(w["v_uf"], w["w_if"],
                                               w["v_if"])
        featured = bool(model.x_uf.any())
        tables = dict(tab_u=tu, tab_i=ti, tab_uf=tuf if featured else None,
                      tab_if=tif if featured else None)
        feats = {}
        if featured:
            feats = dict(
                x_uf=fused.pad_feature_cols(model._x_uf_dev, U_pad),
                x_if=fused.pad_feature_cols(model._x_if_dev,
                                            fused.item_pad(I)))
        packed = model._ensure_packed_hist()

        def fn(t, epoch, eta):
            return fused.fused_epoch(
                t["tab_u"], t["tab_i"], packed, layout, eta, model.alpha,
                model.seed, epoch, num_users=U, num_items=I, factors=F,
                max_samples=plan.max_samples, batch_size=plan.batch_size,
                chunk=plan.chunk, ub=plan.user_block, tab_uf=t["tab_uf"],
                tab_if=t["tab_if"], beta=model.beta, **feats)

        return fn, tables
    n = len(model.interactions)
    bs = plan.xla_batch
    n_pad = -(-n // bs) * bs
    cols = [torch.zeros(n_pad, dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.float32)]
    cols[0][:n] = torch.from_numpy(model.interactions[:, 0].astype(np.int64))
    cols[1][:n] = torch.from_numpy(model.interactions[:, 1].astype(np.int64))
    cols[2][:n] = torch.from_numpy(model.sample_weight)
    step = training.make_train_step(I, plan.max_samples, False, False,
                                    sample_rounds=plan.rounds)
    hist = {"offsets": model._offsets_dev, "flat": model._flat_items_dev}
    body = training.epoch_body(step, bs)

    def fn(t, epoch, eta):
        t_new, ll = body(t, model._x_uf_dev, model._x_if_dev, hist, *cols, n,
                         eta, model.alpha, model.beta, model.seed, epoch)
        for k, v in t_new.items():
            if v is not t[k]:
                t[k].copy_(v)
        return ll

    if batches:
        make_rows, batch = training.epoch_parts(step, bs)

        def one(t, rows, eta):
            return batch(t, model._x_uf_dev, model._x_if_dev, hist, rows,
                         eta, model.alpha, model.beta)[1]

        return fn, {k: v.clone() for k, v in w.items()}, (
            lambda e: make_rows(*cols, n, model.seed, e), one, n_pad // bs)
    return fn, {k: v.clone() for k, v in w.items()}


def _same_bytes(a, b):
    return torch.equal(a.reshape(-1).view(torch.uint8),
                       b.reshape(-1).view(torch.uint8))


@pytest.mark.cuda
@pytest.mark.parametrize("kind,features", [("fused", False),
                                           ("fused", True),
                                           ("candidate", False)])
def test_graph_epoch_equals_eager_epoch(cuda, kind, features):
    """Three epochs through one captured graph and three eager epochs from
    copies of the same tables: equal to the byte, tables and ll; a replay
    counts the launches and the batch steps its capture recorded."""
    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch.ops import graph, training

    train, kw = _graph_case(features)
    m = RankFM(factors=8, loss="warp", max_samples=10, beta=0.1,
               use_fused=kind == "fused", device="cuda").fit(
        train, epochs=1, **kw)
    fn, tables = _engine_epoch(m, "fused" if kind == "fused" else kind)
    te = {k: None if v is None else v.clone() for k, v in tables.items()}
    tg = {k: None if v is None else v.clone() for k, v in tables.items()}
    runner = graph.EpochGraph(fn, tg, cuda, kind, keep_graph=True)
    for epoch, eta in ((3, 0.1), (4, 0.07), (5, 0.05)):
        counters = (fused.LAUNCHES, scatter.LAUNCHES, training.STEPS)
        before = [Counter(c) for c in counters]
        ll_g = runner(epoch, eta)
        # the capture at the first call counts nothing, the replay all
        assert tuple(Counter(c) - b for c, b in zip(counters, before)) == (
            runner.launches)
        ll_e = fn(te, epoch, eta)
        torch.cuda.synchronize()
        assert _same_bytes(ll_g, ll_e)
        for k in te:
            if te[k] is not None:
                assert _same_bytes(te[k], tg[k]), (epoch, k)
    assert sum(runner.launches[0 if kind == "fused" else 1].values()) > 0
    assert runner.stats["capture_s"] > 0 and _graph_nodes(runner.graph) > 0


@pytest.mark.cuda
def test_graph_of_one_batch_equals_eager_epoch(cuda):
    """The candidate epoch as one captured batch replayed per batch
    (`graph.BatchGraph`, as `RankFM` runs the XLA steps) and eager epochs
    from copies of the same tables: equal to the byte, tables and ll, over
    epochs whose rows differ; a replay counts one batch's launches and
    steps per batch."""
    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch.ops import graph, training

    train, kw = _graph_case(False)
    m = RankFM(factors=8, loss="warp", max_samples=10, beta=0.1,
               use_fused=False, device="cuda").fit(train, epochs=1, **kw)
    fn, tables, batches = _engine_epoch(m, "candidate", batches=True)
    te = {k: None if v is None else v.clone() for k, v in tables.items()}
    tg = {k: None if v is None else v.clone() for k, v in tables.items()}
    runner = graph.BatchGraph(*batches, tg, cuda, "candidate")
    for epoch, eta in ((3, 0.1), (4, 0.07), (5, 0.05)):
        counters = (fused.LAUNCHES, scatter.LAUNCHES, training.STEPS)
        before = [Counter(c) for c in counters]
        ll_g = runner(epoch, eta)
        assert sum((training.STEPS - before[2]).values()) == batches[2]
        assert Counter(scatter.LAUNCHES) - before[1] == Counter(
            {k: v * batches[2] for k, v in runner.launches[1].items()})
        ll_e = fn(te, epoch, eta)
        torch.cuda.synchronize()
        assert _same_bytes(ll_g, ll_e)
        for k in te:
            if te[k] is not None:
                assert _same_bytes(te[k], tg[k]), (epoch, k)
    assert sum(runner.launches[1].values()) > 0


def _graph_nodes(g):
    """Nodes of a graph captured with ``keep_graph`` (the driver's count)."""
    import ctypes
    n = ctypes.c_size_t(0)
    assert ctypes.CDLL("libcuda.so.1").cuGraphGetNodes(
        ctypes.c_void_p(g.raw_cuda_graph()), None, ctypes.byref(n)) == 0
    return n.value


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["xla", "fused"])
def test_fit_partial_replays_the_graphs_of_the_call_before(cuda, engine):
    """``fit(1)`` + ``fit_partial(1)`` on the same data equals ``fit(2)``
    on the card, to the byte, and the ``fit_partial`` captures no graph:
    it replays the one the fit captured, with its own tables copied in;
    on other data it captures anew."""
    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch.ops import graph

    rng = np.random.default_rng(5)
    train = np.stack([rng.integers(0, 30, 600), rng.integers(0, 50, 600)], 1)
    cfg = dict(factors=4, loss="warp", max_samples=4, batch_size=256,
               seed=99, learning_schedule="constant", device="cuda")
    if engine == "xla":
        cfg["use_fused"] = False
    else:
        cfg["train_step"] = "window"
    one = RankFM(**cfg).fit(train, epochs=2)
    two = RankFM(**cfg).fit(train, epochs=1)
    before = dict(graph.RUNS)
    two.fit_partial(train, epochs=1)
    assert (graph.RUNS["capture"] - before["capture"],
            graph.RUNS["replay"] - before["replay"]) == (0, 1)
    for k in ("v_u", "v_i", "w_i"):
        assert getattr(one, k).tobytes() == getattr(two, k).tobytes(), k
    before = dict(graph.RUNS)
    two.fit_partial(train[:500], epochs=1)
    assert graph.RUNS["capture"] - before["capture"] == 1


@pytest.mark.cuda
def test_graph_captures_are_spans_of_their_fit(cuda):
    """Under `torch.profiler`, a fit on the card (fused epochs, then a
    candidate epoch: two layouts) opens one ``rankfm.graph.capture`` a
    layout inside its engine's epochs, each holding its ``drain``,
    ``release`` and ``record``, and one ``rankfm.graph.replay`` an epoch; a
    ``fit_partial`` on the same data replays the graphs the fit kept and
    opens no capture."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch.ops import graph

    rng = np.random.default_rng(5)
    train = np.stack([rng.integers(0, 30, 600), rng.integers(0, 50, 600)], 1)
    model = RankFM(factors=4, loss="warp", max_samples=4, seed=99,
                   device="cuda")

    def traced(call):
        before = dict(graph.RUNS)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            call(train, epochs=6)
        runs = {k: graph.RUNS[k] - before.get(k, 0) for k in graph.RUNS}
        spans = []
        for e in prof.events():
            if (e.device_type == DeviceType.CPU
                    and e.name.startswith("rankfm.")):
                p = e.cpu_parent
                while p is not None and not p.name.startswith("rankfm."):
                    p = p.cpu_parent
                spans.append((e.name, p.name if p else None))
        return runs, spans

    runs, spans = traced(model.fit)
    plan = model.last_fit_plan_
    assert plan.fused and plan.n_tail == 1 and not plan.tail_windows
    captures = [p for n, p in spans if n == "rankfm.graph.capture"]
    assert runs["capture"] == len(captures) == 2
    assert sorted(captures) == ["rankfm.fit.epochs.candidate",
                                "rankfm.fit.epochs.fused"]
    for child in ("drain", "release", "record"):
        assert [p for n, p in spans if n == f"rankfm.graph.{child}"] == [
            "rankfm.graph.capture"] * 2
    assert runs["replay"] == 6
    assert sum(n == "rankfm.graph.replay" for n, _ in spans) == 6

    runs, spans = traced(model.fit_partial)
    assert runs.get("capture", 0) == 0 and runs["replay"] == 6
    assert {n for n, _ in spans if n.startswith("rankfm.graph.")} == {
        "rankfm.graph.replay"}
    assert sum(n == "rankfm.graph.replay" for n, _ in spans) == 6


COLD_FIT = """
import sys, numpy as np, torch
sys.path.insert(0, {root!r})
from rankfm_tpu_torch import RankFM
from rankfm_tpu_torch.ops import graph
rng = np.random.default_rng(5)
train = np.stack([rng.integers(0, 300, 6000), rng.integers(0, {items}, 6000)],
                 1)
kw = dict(factors=8, loss="warp", max_samples=10, use_fused={fused},
          device="cuda")
# the first CUDA work of this process: every kernel, library and module is
# loaded while the fit's first layout is captured
cold = RankFM(**kw).fit(train, epochs=2)
runs = dict(graph.RUNS)
warm = RankFM(**kw).fit(train, epochs=2)
assert runs["replay"] == 2 and runs["capture"] >= 1, runs
for k, v in cold._weights.items():
    assert np.isfinite(v).all(), k
    assert v.tobytes() == warm._weights[k].tobytes(), k
print("cold", runs)
"""


@pytest.mark.cuda
@pytest.mark.parametrize("fused,items", [(True, 500), (False, 500),
                                         (False, 40_000)])
def test_first_capture_of_a_process_needs_no_warm_up(cuda, fused, items):
    """A fit whose epoch graph is the first CUDA work of its process (the
    fused epoch, the window step, the candidate step) captures without a
    warm-up epoch, and trains what the same fit trains once everything is
    loaded, to the byte."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c", COLD_FIT.format(
        root=root, fused=fused, items=items)], capture_output=True,
        text=True, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "cold" in out.stdout


@pytest.mark.cuda
@pytest.mark.parametrize("epoch,rank", [(0, 0), (2, 1), (7, 3)])
def test_card_draws_equal_cpu_draws(cuda, epoch, rank):
    from rankfm_tpu_torch.ops import training

    def draws(dev):
        key = fused.epoch_key(1492, epoch, rank, device=dev)
        perm, keys = training.epoch_draws(1492, epoch, 40_960, 5, dev, rank)
        return [key, fused.shuffle_bits(key, 100_003),
                fused.rotation(key, 23), fused.batch_seeds(key, 23),
                fused.draw_window_blocks(key, (23, 16, 4), 33_362), perm,
                keys, training.make_train_step(33_362, 50, False, False).draw(
                    keys[1], 512),
                *training.make_window_train_step(3_706, 20, False,
                                                 False).draw(keys[2], 1024),
                fused.layout_key(1492, epoch, device=dev)]

    for got, want in zip(draws(cuda), draws(torch.device("cpu"))):
        assert got.device.type == "cuda" and _same_bytes(got.cpu(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n_uf,n_if", [(0, 0), (3, 4)])
def test_kernel_scalars_from_device_memory(cuda, n_uf, n_if):
    """B1 given its seed and scalars as views into device buffers (what an
    epoch hands it) equals B1 given numbers, to the byte, and leaves its
    persistent scratch as it found it; called again it gives the same."""
    rng = np.random.default_rng(9)
    case, args, kw, _ = _case(cuda, 4, rng, n_uf=n_uf, n_if=n_if)
    tabs, feats = case if n_uf or n_if else (case, {})
    seed, eta, dreg = args[5:]
    seeds = torch.tensor([5, seed, 9], dtype=torch.int32, device=cuda)
    scal = torch.tensor([0.3, eta, *dreg], dtype=torch.float32, device=cuda)
    outs = []
    for by_value in (True, False, True):
        t = [x.clone() for x in tabs]
        f = {k: v.clone() if k.startswith("tab") else v
             for k, v in feats.items()}
        s = args[5:] if by_value else (seeds[1], scal[1], scal[2:])
        ll = fused.fused_batch(*t, *args[:5], *s, max_samples=20, **kw, **f)
        torch.cuda.synchronize()
        outs.append((t, f, ll))
    for t, f, ll in outs[1:]:
        assert _same_bytes(ll, outs[0][2])
        assert all(_same_bytes(a, b) for a, b in zip(t, outs[0][0]))
        assert all(_same_bytes(f[k], outs[0][1][k]) for k in f)
    stream = torch.cuda.current_stream(cuda).cuda_stream
    nT, NW = args[2].shape
    BLK = fused.block_size(kw["num_items"])
    D = kw["factors"] + 2
    scr = fused.scratch(cuda, stream, nT, args[0].shape[0] // nT,
                        kw["ub_rows"], BLK, NW, D, n_uf, n_if, n_uf > 0,
                        n_if > 0)
    assert not scr["acc"].any() and not scr["cnt"].any()
    if n_uf or n_if:
        nrep = (kw["ub_rows"] + (1 + NW) * BLK) * D
        assert not scr["facc"][nrep:nrep + n_uf + n_if].any()


@pytest.mark.cuda
@pytest.mark.parametrize("kernel", ["sorted", "dense"])
def test_table_update_scalars_from_device_memory(cuda, kernel):
    tab, bias, idx, upd = _table_case(cuda, 33_362, 16_384, 50, "uniform",
                                      True)
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    launch = getattr(scatter, f"table_update_{kernel}")
    a = [tab.clone(), bias.clone()]
    launch(*a, idx, upd, eta, c)
    scal = torch.tensor([1.0, eta, c], dtype=torch.float32, device=cuda)
    b = [tab.clone(), bias.clone()]
    launch(*b, idx, upd, scal[1], scal[2])
    torch.cuda.synchronize()
    assert _same_bytes(a[0], b[0]) and _same_bytes(a[1], b[1])


CAPTURE_FAILS = """
import sys, torch
sys.path.insert(0, {root!r})
from rankfm_tpu_torch.ops import graph
t = {{"x": torch.ones(4, device="cuda")}}

def fn(tables, epoch, eta):
    tables["x"].mul_(2.0)
    if float(tables["x"].sum()) > 0:       # a host read: not capturable
        tables["x"].add_(eta)
    return tables["x"].sum()

run = graph.epoch_runner(fn, t, torch.device("cuda"))
try:
    run(0, 0.1)
except graph.GraphCaptureError as e:
    print("raised:", e)
    sys.exit(3)
print("no error")
"""


@pytest.mark.cuda
def test_capture_failure_raises(cuda):
    """An epoch that reads a device value on the host cannot be captured:
    the runner raises with the CUDA error, and runs nothing eagerly
    instead (a process of its own: a failed capture leaves torch's CUDA
    generator unusable in that process)."""
    import subprocess
    import sys
    from pathlib import Path

    root = str(Path(__file__).resolve().parents[1])
    out = subprocess.run([sys.executable, "-c",
                          CAPTURE_FAILS.format(root=root)],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 3, out.stdout + out.stderr
    assert "raised: capturing the epoch (epoch) as a CUDA graph failed" \
        in out.stdout


# ---------------------------------------------------------------------------
# filtered top-N retrieval: the kernel of csrc/topk_select.cu, its rule
# ---------------------------------------------------------------------------


# the serve cells' shapes (users a request, items, F, item feature columns)
TOPK_SHAPES = {"instacart": (1000, 33_362, 50, 21),
               "ml1m": (1000, 3_706, 20, 0)}


def _topk_case(dev, B, I, F, n_if, U=None, seen=0.05, dyadic=False, seed=0):
    """Weights, features, users and a seen-item bitmap as a `RankFM` holds
    them: ``x_uf [U, 1]`` zeros, ``x_if`` one-hot over ``n_if`` columns (a
    zero column when 0), each user has seen ~``seen`` of the items. Dyadic
    weights (multiples of 1/8 in [-1, 1]) make every score exact in f32,
    whatever the order of its sum."""
    rng = np.random.default_rng(seed)
    U = U or max(B, 1) + 7
    Q = max(n_if, 1)

    def draw(*shape):
        if dyadic:
            return rng.integers(-8, 9, shape).astype(np.float32) / 8
        return rng.normal(0, 0.5, shape).astype(np.float32)

    x_if = np.zeros((I, Q), np.float32)
    if n_if:
        x_if[np.arange(I), rng.integers(0, n_if, I)] = 1
    w = {"w_i": draw(I), "w_if": draw(Q), "v_u": draw(U, F), "v_i": draw(I, F),
         "v_uf": np.zeros((1, F), np.float32),
         "v_if": draw(Q, F) if n_if else np.zeros((Q, F), np.float32)}
    hist = rng.random((U, I)) < seen
    bm = np.zeros((U, (I + 31) // 32), np.uint32)
    uu, ii = np.nonzero(hist)
    np.bitwise_or.at(bm, (uu, ii >> 5), np.uint32(1) << (ii & 31).astype(
        np.uint32))
    users = rng.choice(U, B, replace=False).astype(np.int64)
    t = {k: torch.from_numpy(v).to(dev) for k, v in w.items()}
    return (t, torch.zeros((U, 1), device=dev), torch.from_numpy(x_if).to(dev),
            torch.from_numpy(users).to(dev),
            torch.from_numpy(bm.view(np.int32)).to(dev))


def _plain_scores(w, x_uf, x_if, u_idx, bm):
    """The f32 scores ``[B, I]`` of the plain version, seen items -inf."""
    from rankfm_tpu_torch.ops import scoring
    s = scoring.score_all_items(w, x_uf, x_if, u_idx)
    if bm is not None:
        col = torch.arange(s.shape[1], device=s.device)
        seen = ((bm[u_idx][:, col >> 5] >> (col & 31)) & 1).bool()
        s = s.masked_fill(seen, float("-inf"))
    return s


def _assert_lists(items, scores, plain_scores, k, atol=1e-4):
    """The kernel's lists against the plain version's scores: each listed
    item is unseen, listed once, and carries its own score; the lists are
    sorted; the slot-wise gap below the plain version's sorted top ``k`` is
    within ``atol`` (0 for exact scores); a -1 slot only where fewer than
    ``k`` items are unseen. Returns the plain version's lists."""
    items, scores = items.cpu(), scores.cpu()
    ps = plain_scores.cpu()
    B, I = ps.shape
    want_s, want_i = torch.topk(ps, min(k, I), dim=1)
    want_i = torch.where(torch.isneginf(want_s), -1, want_i)
    if k > I:
        want_s = torch.cat([want_s, torch.full((B, k - I), float("-inf"))], 1)
        want_i = torch.cat([want_i, torch.full((B, k - I), -1)], 1)
    assert items.shape == scores.shape == (B, k)
    assert items.dtype == torch.int32 and scores.dtype == torch.float32
    empty = items < 0
    assert torch.equal(empty, want_i < 0)
    assert torch.isneginf(scores[empty]).all()
    got = ps.gather(1, items.clamp(min=0).long())
    live = ~empty
    assert torch.isfinite(got[live]).all(), "a seen item was listed"
    assert ((got - scores)[live].abs() <= atol).all()
    for r in range(B):
        row = items[r][items[r] >= 0]
        assert len(torch.unique(row)) == len(row), f"row {r} repeats an item"
    assert (scores[:, :-1][live[:, 1:]] >= scores[:, 1:][live[:, 1:]]).all()
    gap = (want_s - got)[live]
    assert gap.numel() == 0 or gap.max().item() <= atol
    return want_i.int(), want_s


@pytest.mark.cuda
@pytest.mark.parametrize("shape", sorted(TOPK_SHAPES))
@pytest.mark.parametrize("filtered", [True, False])
def test_topk_kernel_matches_plain_at_serve_shapes(cuda, shape, filtered):
    """At the serve cells' shapes with random weights, the kernel's lists
    are the plain version's: every slot's score gap is within f32 rounding
    of two summation orders, and a slot lists another item than
    ``torch.topk`` only at a near tie."""
    B, I, F, n_if = TOPK_SHAPES[shape]
    w, x_uf, x_if, u, bm = _topk_case(cuda, B, I, F, n_if, U=6_000)
    bm = bm if filtered else None
    items, scores = topk.topk_select(w, x_uf, x_if, u, 10, bm)
    torch.cuda.synchronize()
    ps = _plain_scores(w, x_uf, x_if, u, bm)
    want_i, want_s = _assert_lists(items, scores, ps, 10)
    differ = items.cpu() != want_i
    near = (scores.cpu() - want_s).abs() <= 1e-4
    assert (near | ~differ).all()
    assert differ.float().mean().item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("B,I,F,n_if,k", [
    (1, 300, 7, 0, 10), (129, 129, 3, 4, 10), (5, 7, 4, 0, 10),
    (200, 1_000, 20, 0, 1), (200, 1_000, 20, 5, topk.K_MAX),
    (1, 40, 6, 3, topk.K_MAX), (300, 5_000, 50, 21, topk.K_MAX),
    (257, 385, 33, 2, 17)])
def test_topk_kernel_ragged_shapes(cuda, B, I, F, n_if, k):
    """B and I off the 128-row tiles, one user, fewer items than slots (the
    rest are -1), k = 1 and k = K_MAX; dyadic weights make the scores exact,
    so every gap is 0."""
    w, x_uf, x_if, u, bm = _topk_case(cuda, B, I, F, n_if, dyadic=True,
                                      seed=B + I)
    for b in (bm, None):
        items, scores = topk.topk_select(w, x_uf, x_if, u, k, b)
        _assert_lists(items, scores, _plain_scores(w, x_uf, x_if, u, b), k,
                      atol=0.0)


@pytest.mark.cuda
def test_topk_kernel_planted_ties(cuda):
    """Items in groups of four with equal operands tie exactly: the lists
    may order them otherwise than ``torch.topk``, and every slot's score
    gap is 0."""
    w, x_uf, x_if, u, bm = _topk_case(cuda, 300, 4_000, 16, 3, dyadic=True)
    for name in ("v_i", "w_i", "x_if"):
        t = w[name] if name != "x_if" else x_if
        t.copy_(t[torch.arange(t.shape[0], device=cuda) // 4 * 4])
    items, scores = topk.topk_select(w, x_uf, x_if, u, 10, None)
    want_i, want_s = _assert_lists(
        items, scores, _plain_scores(w, x_uf, x_if, u, None), 10, atol=0.0)
    assert torch.equal(scores.cpu(), want_s)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 10, topk.K_MAX])
def test_topk_kernel_exhausted_users(cuda, k):
    """A user who has seen every item gets only -1 slots; one with fewer
    unseen items than ``k`` gets them, then -1 slots; a user index outside
    the table gets an empty list."""
    I = 700
    w, x_uf, x_if, u, bm = _topk_case(cuda, 40, I, 12, 0, dyadic=True)
    bm[u[0]] = -1                                  # every item seen
    bm[u[1]] = -1
    bm[u[1], 3] = ~0b10110000                      # but 100, 101 and 103
    items, scores = topk.topk_select(w, x_uf, x_if, u, k, bm)
    _assert_lists(items, scores, _plain_scores(w, x_uf, x_if, u, bm), k,
                  atol=0.0)
    items = items.cpu()
    assert (items[0] == -1).all()
    n1 = min(k, 3)
    assert set(items[1][:n1].tolist()) <= {100, 101, 103}
    assert (items[1][n1:] == -1).all()
    bad = u.clone()
    bad[2] = w["v_u"].shape[0]
    bad[3] = -5
    items, scores = topk.topk_select(w, x_uf, x_if, bad, k, bm)
    assert (items[2:4].cpu() == -1).all()
    assert torch.isneginf(scores[2:4].cpu()).all()


@pytest.mark.cuda
def test_topk_kernel_repeats_bit_for_bit(cuda):
    """The same call twice gives equal bytes (the Instacart shape)."""
    B, I, F, n_if = TOPK_SHAPES["instacart"]
    w, x_uf, x_if, u, bm = _topk_case(cuda, B, I, F, n_if, U=3_000)
    a = topk.topk_select(w, x_uf, x_if, u, 10, bm)
    b = topk.topk_select(w, x_uf, x_if, u, 10, bm)
    for x, y in zip(a, b):
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_topk_unfiltered_equals_empty_bitmap(cuda):
    """No filter and an all-zero bitmap give the same bytes, through both
    public entry points."""
    w, x_uf, x_if, u, bm = _topk_case(cuda, 500, 3_706, 20, 0)
    none = torch.zeros(0, dtype=torch.int64, device=cuda)
    a = topk.topk_for_users(w, x_uf, x_if, u, 10, none, none)
    b = topk.topk_bitmap(w, x_uf, x_if, u, 10, torch.zeros_like(bm))
    for x, y in zip(a, b):
        assert x.cpu().numpy().tobytes() == y.cpu().numpy().tobytes()


@pytest.mark.cuda
def test_topk_above_k_max_takes_the_plain_version(cuda):
    """``n_items = K_MAX + 1`` on the card runs the plain version and counts
    in `topk.PLAIN`; ``K_MAX`` runs the kernel and counts in
    `topk.LAUNCHES`."""
    w, x_uf, x_if, u, bm = _topk_case(cuda, 50, 1_000, 8, 0, dyadic=True)
    launches, plain = Counter(topk.LAUNCHES), Counter(topk.PLAIN)
    k = topk.K_MAX + 1
    items, scores = topk.topk_bitmap(w, x_uf, x_if, u, k, bm)
    assert topk.LAUNCHES == launches
    assert topk.PLAIN - plain == Counter({(k, "bitmap"): 1})
    want = topk.topk_bitmap_plain(w, x_uf, x_if, u, k, bm)
    assert torch.equal(items, want[0]) and torch.equal(scores, want[1])
    topk.topk_bitmap(w, x_uf, x_if, u, topk.K_MAX, bm)
    assert topk.LAUNCHES - launches == Counter({(topk.K_MAX, True): 1})
    assert topk.PLAIN - plain == Counter({(k, "bitmap"): 1})


@pytest.mark.cuda
def test_topk_wrapper_rejects_bad_inputs(cuda):
    w, x_uf, x_if, u, bm = _topk_case(cuda, 20, 300, 8, 2)
    cases = [
        ("needs CUDA tensors", dict(u=u.cpu())),
        ("u_idx must be", dict(u=u.int())),
        ("w\\['v_i'\\] must be", dict(w=dict(w, v_i=w["v_i"].double()))),
        ("w\\['v_u'\\] must be", dict(w=dict(w, v_u=w["v_u"].t().contiguous()
                                               .t()))),
        ("x_if must be", dict(x_if=x_if.cpu())),
        ("bitmap_words must be", dict(bm=bm.long())),
        ("bitmap_words has shape", dict(bm=bm[:, :-1].contiguous())),
        ("w\\['v_if'\\] has shape", dict(w=dict(w, v_if=w["v_if"][:1]))),
        ("n_items must be", dict(k=topk.K_MAX + 1)),
        ("n_items must be", dict(k=0)),
    ]
    for match, bad in cases:
        a = dict(dict(w=w, x_uf=x_uf, x_if=x_if, u=u, bm=bm, k=10), **bad)
        with pytest.raises(ValueError, match=match):
            topk.topk_select(a["w"], a["x_uf"], a["x_if"], a["u"], a["k"],
                             a["bm"])


def _recommend_model(dev, n_users=300, n_items=900):
    from rankfm_tpu_torch import RankFM
    rng = np.random.default_rng(11)
    train = np.stack([rng.integers(0, n_users, 9_000) + 1_000,
                      rng.integers(0, n_items, 9_000) + 50_000], 1)
    model = RankFM(factors=8, loss="warp", max_samples=5, seed=3,
                   device=dev).fit(train, epochs=1)
    return model, np.unique(train[:, 0])


@pytest.mark.cuda
@pytest.mark.parametrize("filter_previous", [True, False])
def test_recommend_runs_one_kernel_call_a_chunk(cuda, monkeypatch,
                                                filter_previous):
    """`RankFM.recommend` on the card calls the kernel once per chunk of
    users and the plain version never, and its lists are the CPU model's
    on the same weights (the CPU runs the plain version)."""
    from rankfm_tpu_torch.models import rankfm as rankfm_mod

    model, users = _recommend_model("cuda")
    assert model._sampler == "bitmap"
    cpu, _ = _recommend_model("cpu")
    cpu._weights = model._weights
    monkeypatch.setattr(rankfm_mod, "_recommend_chunk", lambda n: 64)
    launches, plain = Counter(topk.LAUNCHES), Counter(topk.PLAIN)
    got = model.recommend(users, n_items=10, filter_previous=filter_previous)
    assert topk.LAUNCHES - launches == Counter(
        {(10, filter_previous): -(-len(users) // 64)})
    assert topk.PLAIN == plain
    want = cpu.recommend(users, n_items=10, filter_previous=filter_previous)
    assert (got.values == want.values).mean() > 0.999


@pytest.mark.cuda
def test_recommend_chunk_is_three_launches_and_two_copies(cuda):
    """Under `torch.profiler`, a 1,000-user filtered request over 33,362
    items runs three kernels, one copy to the card and one back, no
    ``torch.topk`` or matrix product, and allocates nothing near a ``[B,
    I]`` matrix."""
    import time

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(2)
    n_users, n_items = 3_000, 33_362
    train = np.stack([rng.integers(0, n_users, 60_000),
                      rng.integers(0, n_items, 60_000)], 1)
    model = RankFM(factors=50, loss="warp", max_samples=5, seed=3,
                   device="cuda").fit(train, epochs=1)
    users = np.unique(train[:, 0])[:1_000]
    model.recommend(users, n_items=10, filter_previous=True)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    # idle at both ends: the tracer drops device records stamped outside
    # its window (`chip_smoke.profile_call`)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(0.005)
        model.recommend(users, n_items=10, filter_previous=True)
        torch.cuda.synchronize()
        time.sleep(0.005)
    peak = torch.cuda.max_memory_allocated() - base
    kernels, copies, ops = [], Counter(), set()
    for e in prof.events():
        if e.device_type == DeviceType.CPU:
            ops.add(e.name)
        elif "Memcpy" in e.name:
            copies["HtoD" if "HtoD" in e.name else "DtoH"] += 1
        elif "Memset" not in e.name and not e.name.startswith("rankfm."):
            kernels.append(e.name)        # not the spans' device copies
    assert len(kernels) == 3 and all("_kernel" in n for n in kernels), kernels
    assert copies == Counter({"HtoD": 1, "DtoH": 1}), copies
    assert not ops & {"aten::topk", "aten::mm", "aten::matmul",
                      "aten::addmm"}, ops
    assert peak < len(users) * n_items * 4 // 4, peak


def test_topk_rule():
    """The kernel takes a chunk on a CUDA device with 1 <= n_items <=
    K_MAX; every other chunk takes the plain version."""
    cuda, cpu = torch.device("cuda"), torch.device("cpu")
    assert topk.runs_kernel(cuda, 1) and topk.runs_kernel(cuda, 10)
    assert topk.runs_kernel(cuda, topk.K_MAX)
    assert not topk.runs_kernel(cuda, topk.K_MAX + 1)
    assert not topk.runs_kernel(cuda, 0)
    assert not topk.runs_kernel(cpu, 10)
    assert not topk.runs_kernel(torch.device("meta"), 10)
    assert topk.K_MAX >= 100


def _np_scores(w, x_uf, x_if, u, seen=None):
    """An independent float64 numpy score ``[B, I]``, seen items -inf."""
    w = {n: t.numpy().astype(np.float64) for n, t in w.items()}
    x_uf, x_if = x_uf.numpy().astype(np.float64), x_if.numpy().astype(
        np.float64)
    u = u.numpy()
    s = (w["w_i"] + x_if @ w["w_if"])[None, :] + (
        w["v_u"][u] + x_uf[u] @ w["v_uf"]) @ w["v_i"].T + w["v_u"][u] @ (
        x_if @ w["v_if"]).T
    if seen is not None:
        s[seen] = -np.inf
    return s


@pytest.mark.parametrize("k", [1, 10, topk.K_MAX + 1])
@pytest.mark.parametrize("filt", ["bitmap", "none", "pairs"])
def test_topk_on_cpu_takes_the_plain_version(monkeypatch, k, filt):
    """CPU tensors take the plain version at every ``n_items``, K_MAX + 1
    included: the kernel's wrapper is never called, no counter moves, and
    the lists are those of an independent float64 score (dyadic weights:
    exact in f32; equal scores in either order)."""
    monkeypatch.setattr(topk, "topk_select", lambda *a, **kw: pytest.fail(
        "the kernel's wrapper ran on the CPU"))
    cpu = torch.device("cpu")
    w, x_uf, x_if, u, bm = _topk_case(cpu, 40, 300, 6, 3, dyadic=True,
                                      seen=0.3)
    seen = ((bm[u][:, torch.arange(300) >> 5] >> (torch.arange(300) & 31))
            & 1).bool().numpy()
    launches, plain = Counter(topk.LAUNCHES), Counter(topk.PLAIN)
    if filt == "bitmap":
        items, scores = topk.topk_bitmap(w, x_uf, x_if, u, k, bm)
    else:
        rows, cols = (torch.from_numpy(np.nonzero(seen)[i]) for i in (0, 1))
        if filt == "none":
            rows = cols = torch.zeros(0, dtype=torch.int64)
            seen = None
        items, scores = topk.topk_for_users(w, x_uf, x_if, u, k, rows, cols)
    assert topk.LAUNCHES == launches and topk.PLAIN == plain
    assert items.dtype == torch.int32 and scores.dtype == torch.float32
    assert items.shape == scores.shape == (40, k)
    s = _np_scores(w, x_uf, x_if, u, seen)
    want = -np.sort(-s, axis=1)[:, :k]
    np.testing.assert_array_equal(scores.numpy(), want.astype(np.float32))
    items = items.numpy()
    np.testing.assert_array_equal(items < 0, np.isneginf(want))
    got = np.take_along_axis(s, np.maximum(items, 0), 1)
    np.testing.assert_array_equal(got[items >= 0], want[items >= 0])


def test_topk_entry_points_keep_their_names():
    """`topk_bitmap` and `topk_for_users` keep the names and arguments that
    callers wrap (the benchmark's fault wrapper replaces them by name)."""
    import inspect
    assert list(inspect.signature(topk.topk_bitmap).parameters) == [
        "w", "x_uf", "x_if", "u_idx", "n_items", "bitmap_words"]
    assert list(inspect.signature(topk.topk_for_users).parameters) == [
        "w", "x_uf", "x_if", "u_idx", "n_items", "seen_rows", "seen_cols"]


def test_topk_select_refuses_cpu_tensors():
    w, x_uf, x_if, u, bm = _topk_case(torch.device("cpu"), 4, 50, 3, 0)
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        topk.topk_select(w, x_uf, x_if, u, 10, bm)


@pytest.mark.parametrize("B,I,F,k,n_sm,S", [
    (1000, 33_362, 50, 10, 132, 33), (1000, 3_706, 20, 10, 132, 29),
    (1, 300, 7, 10, 132, 3), (4096, 33_362, 50, 10, 132, 9),
    (1000, 33_362, 50, topk.K_MAX, 132, 17), (300, 100_000, 64, 10, 132, 88),
    (1, 100_000, 8, topk.K_MAX, 132, 47)])
def test_topk_launch_plan(B, I, F, k, n_sm, S):
    """One wave of blocks fills every SM (two a SM while shared memory
    allows), no split is empty, the merge can stage a user's candidates,
    and the scratch holds the padded operands, the item biases and each
    split's candidates."""
    got, words = topk.launch_plan(B, I, F, k, n_sm)
    assert got == S
    Kp, Ip, Bp = -(-2 * F // 8) * 8, -(-I // 128) * 128, -(-B // 128) * 128
    assert S <= Ip // 128 and S * (k * 8 + 4) <= topk.MERGE_BYTES
    assert words == (Ip + Bp) * Kp + Ip + 2 * B * S * k
    assert topk.shared_bytes(topk.K_MAX) <= 232_448   # a block's limit


# ---------------------------------------------------------------------------
# the initial factor tables drawn on the card (`ops/init.py`,
# `csrc/pcg_normal.cu`): numpy's draw bit for bit
# ---------------------------------------------------------------------------

def _f32_bits(a):
    if isinstance(a, torch.Tensor):
        a = a.cpu().numpy()
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).ravel()


def _slow_since(before):
    return {k: init.SLOW[k] - before[k] for k in ("wedge", "tail", "words")}


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [1492, 7, 2**31 + 12345])
def test_card_draw_equals_numpy_at_webscale(cuda, seed):
    """``v_u`` then ``v_i`` of the webscale configuration (100,000 and
    909,936 rows, F 64, sigma 0.1) equal numpy's float32 draw, the
    generator ends where numpy's ends, and the walk resolved the wedge and
    tail attempts (~1.4% and ~0.03% of the stream's words)."""
    U, I, F = 100_000, 909_936, 64
    rng = np.random.default_rng(seed)
    before = init.SLOW.copy()
    a, b = init.normal_pair(rng.bit_generator, 0.1, U * F, I * F, cuda)
    assert a.is_cuda and b.is_cuda
    ref = np.random.default_rng(seed)
    np.testing.assert_array_equal(
        _f32_bits(a), _f32_bits(ref.normal(0, 0.1, (U, F)).astype(np.float32)))
    np.testing.assert_array_equal(
        _f32_bits(b), _f32_bits(ref.normal(0, 0.1, (I, F)).astype(np.float32)))
    assert rng.bit_generator.state == ref.bit_generator.state
    d = _slow_since(before)
    assert d["tail"] > 0 and 0.010 < d["wedge"] / d["words"] < 0.020


@pytest.mark.cuda
@pytest.mark.parametrize("n0,n1", [(1, 0), (5, 17), (1000, 2049),
                                   (0, 70_000), (64 * 2048 + 3, 5)])
def test_card_draw_ragged_sizes(cuda, n0, n1):
    """Sizes off every segment and word boundary."""
    rng = np.random.default_rng(n0 + 3 * n1)
    a, b = init.normal_pair(rng.bit_generator, 0.01, n0, n1, cuda)
    ref = np.random.default_rng(n0 + 3 * n1)
    np.testing.assert_array_equal(
        _f32_bits(a), _f32_bits(ref.normal(0, 0.01, n0).astype(np.float32)))
    np.testing.assert_array_equal(
        _f32_bits(b), _f32_bits(ref.normal(0, 0.01, n1).astype(np.float32)))
    assert rng.bit_generator.state == ref.bit_generator.state


@pytest.mark.cuda
@pytest.mark.parametrize("n0,n1,n_pos", [(40_000, 30_000, 50_000),
                                         (300, 200, 1)])
def test_card_draw_short_range_raises(cuda, monkeypatch, n0, n1, n_pos):
    """A range of positions that falls short of the draws raises, naming
    the range, and leaves the generator where it was."""
    monkeypatch.setattr(init, "n_positions", lambda n: n_pos)
    rng = np.random.default_rng(n0 + 3 * n1)
    st = rng.bit_generator.state
    with pytest.raises(RuntimeError, match=f"{n_pos} stream positions hold"):
        init.normal_pair(rng.bit_generator, 0.01, n0, n1, cuda)
    assert rng.bit_generator.state == st


@pytest.mark.cuda
@pytest.mark.parametrize("shape", ["ml1m", "instacart"])
def test_model_init_on_the_card_equals_numpys(cuda, shape):
    """`RankFM._init_all` on the card at the ML-1M shape (6,040 x 3,706,
    F 20) and the featured Instacart shape (10,000 x 33,362, F 50, 21 item
    feature columns, ``v_if`` drawn on the host after ``v_i``): every table
    equals numpy's draw, and the draws are counted by path."""
    import pandas as pd

    from rankfm_tpu_torch import RankFM

    U, I, F, Q = {"ml1m": (6040, 3706, 20, 0),
                  "instacart": (10_000, 33_362, 50, 21)}[shape]
    n = max(U, I)
    df = pd.DataFrame({"u": np.arange(n) % U, "i": np.arange(n) % I})
    feats = None
    if Q:
        feats = pd.DataFrame({"i": np.arange(I), **{
            f"d{k}": (np.arange(I) % Q == k).astype(np.float32)
            for k in range(Q)}})
    model = RankFM(factors=F, loss="warp", device="cuda", seed=2**31 + 5)
    draws, slow = init.DRAWS.copy(), init.SLOW.copy()
    model._init_all(df, item_features=feats)
    ref = np.random.default_rng(2**31 + 5)
    want = {"v_u": ref.normal(0, model.sigma, (U, F)),
            "v_i": ref.normal(0, model.sigma, (I, F))}
    if Q:
        want["v_if"] = ref.normal(0, model.alpha / model.beta * model.sigma,
                                  (Q, F))
    for k, v in want.items():
        assert model._w[k].is_cuda
        np.testing.assert_array_equal(_f32_bits(model._w[k]),
                                      _f32_bits(v.astype(np.float32)), k)
    counted = init.DRAWS - draws
    assert counted == {("card", "v_u"): 1, ("card", "v_i"): 1,
                       **({("host", "v_if"): 1} if Q else {})}
    assert _slow_since(slow)["wedge"] > 0


@pytest.mark.cuda
def test_card_fit_equals_the_fit_from_numpys_tables(cuda, monkeypatch):
    """A fit whose tables the card drew and the same fit started from
    numpy's tables (the draw swapped for numpy's on the host) end with
    equal weights and log-likelihoods, to the byte."""
    from rankfm_tpu_torch import RankFM

    def numpy_pair(bit_generator, sigma, n0, n1, device):
        g = np.random.Generator(bit_generator)
        return tuple(torch.from_numpy(g.normal(0, sigma, n).astype(
            np.float32)).to(device) for n in (n0, n1))

    rng = np.random.default_rng(8)
    users = np.repeat(np.arange(600), 25)
    train = np.stack([users, rng.integers(0, 2500, len(users))], 1)
    cfg = dict(factors=12, loss="warp", max_samples=10,
               learning_schedule="invscaling", device="cuda", seed=23)
    card = RankFM(**cfg).fit(train, epochs=3)
    monkeypatch.setattr(init, "normal_pair", numpy_pair)
    host = RankFM(**cfg).fit(train, epochs=3)
    for k, v in card._weights.items():
        assert np.array_equal(v, host._weights[k]), k
    assert ([r["log_likelihood"] for r in card.training_log_]
            == [r["log_likelihood"] for r in host.training_log_])
