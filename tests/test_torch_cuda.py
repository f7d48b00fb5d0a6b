"""The kernels on the card (the fused chunk step, with and without side
features, the sorted and dense table updates), the build and dispatch
rules around them, and the host half on a CUDA model (checkpoints between
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
from rankfm_tpu_torch.ops import scatter


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
    both table-update kernels) on the card and on the CPU: the candidate
    epoch draws from the device's generator, so the two fits are held to
    each other within the oracle band (+-0.05 hit rate and DCG, +-0.03
    precision and recall)."""
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
    n_lib = len(_build.LIBS)         # four of fused_chunk.cu, one more
    assert n_lib == 5 and {src for src, _ in _build.LIBS.values()} \
        == set(_build.SOURCES)
    first = _build.build()
    assert _build.build() == first and first.exists()
    assert all((first / f"lib{name}.so").exists() for name in _build.LIBS)
    assert calls.read_text().count("x") == n_lib      # one nvcc per library
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.build() != first
    assert calls.read_text().count("x") == 2 * n_lib
