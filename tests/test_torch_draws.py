"""The port's random draws: every draw of an epoch is a pure function of
``(seed, epoch, rank)``, computed with int64 tensor ops (`_philox`), so it
is the same on the CPU and on the card, in an eager epoch and in the CUDA
graph that replays it. CPU only; the card's draws against these are held
by `tests/test_torch_cuda.py` and `chip_smoke.py`.

Checked: repeat calls give equal draws, other epochs and ranks other
draws; a key given its epoch as a tensor (what a graph reads) is the key
of that epoch; the segmented shuffle permutes rows only within each
group's run; the window blocks follow `fused.window_block_cdf`'s weights
(a chi-square test at 10^5 draws); the XLA permutation is a permutation;
a one-rank mesh draws, and trains, what one device does.
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
from scipy import stats

from rankfm_tpu_torch.ops import _philox
from rankfm_tpu_torch.ops import fused
from rankfm_tpu_torch.ops import training
from rankfm_tpu_torch.parallel import train as ptrain

SEED = 1492


def _draws(kind, seed, epoch, rank=0):
    """One kind of an epoch's draws, as a tensor."""
    key = fused.epoch_key(seed, epoch, rank)
    if kind == "shuffle":
        return fused.shuffle_bits(key, 1000)
    if kind == "rotation":
        return fused.rotation(key, 97)
    if kind == "seeds":
        return fused.batch_seeds(key, 50)
    if kind == "blocks":
        return fused.draw_window_blocks(key, (20, 8, 4), 33_362)
    if kind == "perm":
        return training.epoch_draws(seed, epoch, 4096, 16, "cpu", rank)[0]
    if kind == "batch_keys":
        return training.epoch_draws(seed, epoch, 4096, 16, "cpu", rank)[1]
    step_key = training.epoch_draws(seed, epoch, 4096, 16, "cpu", rank)[1][3]
    if kind == "candidates":
        return training.make_train_step(3000, 20, False, False).draw(
            step_key, 256)
    draws = training.make_window_train_step(3000, 20, False, False).draw(
        step_key, 256)
    return torch.cat([d.to(torch.float64).reshape(-1) for d in draws])


KINDS = ["shuffle", "rotation", "seeds", "blocks", "perm", "batch_keys",
         "candidates", "window_step"]


@pytest.mark.parametrize("kind", KINDS)
def test_draws_are_a_function_of_seed_epoch_and_rank(kind):
    a = _draws(kind, SEED, 3)
    assert torch.equal(a, _draws(kind, SEED, 3))
    assert not torch.equal(a, _draws(kind, SEED, 4))
    assert not torch.equal(a, _draws(kind, SEED + 1, 3))
    if kind not in ("shuffle", "rotation", "perm"):   # shared by the ranks
        assert not torch.equal(a, _draws(kind, SEED, 3, rank=1))


@pytest.mark.parametrize("seed,epoch,rank", [(1492, 0, 0), (1492, 2, 1),
                                             (7, 2**31 + 5, 3),
                                             (2**40 + 3, 9, 0)])
def test_key_of_an_epoch_tensor_is_the_key_of_the_epoch(seed, epoch, rank):
    """A CUDA graph reads its epoch from an int64 buffer: the key it makes
    is the one an eager epoch makes from the number; ``philox4x32`` takes
    its key as a tensor or as ints, with the same bits."""
    k = fused.epoch_key(seed, epoch, rank)
    assert k.dim() == 0 and k.dtype == torch.int64
    assert torch.equal(k, fused.epoch_key(
        seed, torch.tensor(epoch, dtype=torch.int64), rank))
    k0, k1 = _philox.key_words(k)
    c = torch.arange(8, dtype=torch.int64)
    got = _philox.philox4x32(c, 1, 2, 3, k0, k1)
    want = _philox.philox4x32(c, 1, 2, 3, int(k0), int(k1))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert all(((w >= 0) & (w < 2**32)).all() for w in got)


def test_rank_zero_draws_the_single_device_key():
    assert torch.equal(fused.epoch_key(SEED, 5, 0), fused.epoch_key(SEED, 5))
    keys = {int(fused.epoch_key(SEED, 5, r)) for r in range(8)}
    keys |= {int(fused.layout_key(SEED, r)) for r in range(8)}
    assert len(keys) == 16


@pytest.mark.parametrize("U,I,B,C,epoch", [(3000, 256, 2048, 128, 0),
                                           (3000, 2500, 2048, 128, 7),
                                           (700, 9000, 1024, 256, 2)])
def test_shuffle_permutes_rows_within_their_group(U, I, B, C, epoch):
    """The sorted layout keeps every group's run where it was and only
    reorders rows inside it: the multiset of records is unchanged, and so
    is each run's."""
    rng = np.random.default_rng(epoch)
    n = 3 * B - 300
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    sw = (rng.random(n) + 0.5).astype(np.float32)
    rec, group, *_ = fused.make_records_grouped(u, i, sw, U, I, B, C)
    shuffle = fused.make_shuffle_fn(U, I)
    key = fused.epoch_key(SEED, epoch)
    rec_t, group_t = torch.from_numpy(rec), torch.from_numpy(group)
    n_pad = len(rec)
    out = shuffle(rec_t, group_t, fused.shuffle_bits(key, n_pad))
    assert not torch.equal(out, rec_t)
    # sorting by the same keys by hand: `shuffle_keys` drew these bits
    keys = fused.shuffle_keys(group_t, fused.shuffle_rnd_bits(U, I), key)
    assert torch.equal(out, rec_t[torch.sort(keys, stable=True).indices])

    def rows(a):
        return sorted(map(tuple, np.asarray(a).tolist()))

    assert rows(out) == rows(rec)
    bounds = np.flatnonzero(np.diff(group)) + 1
    for lo, hi in zip(np.r_[0, bounds], np.r_[bounds, n_pad]):
        assert rows(out[lo:hi]) == rows(rec[lo:hi])


@pytest.mark.parametrize("num_items,seed", [(2500, 3), (33_362, 4),
                                            (1000, 5)])
def test_window_blocks_follow_the_catalog_weights(num_items, seed):
    """10^5 window blocks against `window_block_cdf`'s real item counts:
    a chi-square test at the 0.1% level."""
    blocks = fused.draw_window_blocks(fused.epoch_key(seed, 0), (100_000,),
                                      num_items)
    cum = fused.window_block_cdf(num_items)
    sizes = np.diff(np.r_[0, cum])
    got = np.bincount(blocks.numpy(), minlength=len(sizes))
    assert len(got) == len(sizes) and blocks.dtype == torch.int32
    want = 100_000 * sizes / num_items
    if len(sizes) == 1:
        assert got[0] == 100_000
        return
    chi2 = float(((got - want) ** 2 / want).sum())
    assert chi2 < stats.chi2.ppf(0.999, len(sizes) - 1), (got, want)


@pytest.mark.parametrize("n_pad,nb", [(1, 1), (1024, 4), (65_536, 8),
                                      (10_007 * 8, 8)])
def test_xla_permutation_is_a_permutation(n_pad, nb):
    perm, keys = training.epoch_draws(SEED, 3, n_pad, nb, "cpu")
    assert torch.equal(torch.sort(perm).values, torch.arange(n_pad))
    assert keys.shape == (nb,) and len(set(keys.tolist())) == nb
    if n_pad > 1:
        assert not torch.equal(perm, torch.arange(n_pad))


def _fused_problem():
    rng = np.random.default_rng(11)
    U, I, n = 300, 2500, 4000
    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    layout = fused.make_records_grouped(u, i, np.ones(n, np.float32), U, I,
                                        1024, 128)
    offsets = np.r_[0, np.cumsum(np.bincount(u, minlength=U))]
    flat = i[np.argsort(u, kind="stable")]
    packed = torch.from_numpy(fused.pack_history(offsets, flat, U, I))
    tabs = fused.extend_tables(
        torch.from_numpy(rng.normal(0, 0.05, I).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.1, (U, 6)).astype(np.float32)),
        torch.from_numpy(rng.normal(0, 0.1, (I, 6)).astype(np.float32)),
        fused.user_pad(U), fused.item_pad(I))
    return U, I, layout, packed, tabs, (u, i, offsets, flat)


@pytest.mark.parametrize("engine", ["fused", "window", "candidate"])
def test_one_rank_mesh_draws_and_trains_what_one_device_does(engine):
    """The mesh drivers stay eager and take the same key-based draws:
    rank 0 of a one-rank mesh is the single device, bit for bit."""
    mesh = SimpleNamespace(size=1, rank=0)
    U, I, layout, packed, tabs, (u, i, offsets, flat) = _fused_problem()
    if engine == "fused":
        kw = dict(num_users=U, num_items=I, factors=6, max_samples=5,
                  batch_size=1024, chunk=128, ub=None)
        lay = tuple(torch.from_numpy(a) for a in layout)
        split = lay[:2] + fused.split_layout_for_mesh(*lay[2:], 1)
        out = []
        for dp in (False, True):
            tu, ti = (t.clone() for t in tabs)
            if dp:
                ll = fused.dp_fused_epoch(tu, ti, packed, split, 0.1, 0.01,
                                          SEED, 2, mesh=mesh, **kw)
            else:
                ll = fused.fused_epoch(tu, ti, packed, lay, 0.1, 0.01, SEED,
                                       2, **kw)
            out.append((tu, ti, float(ll)))
        assert torch.equal(out[0][0], out[1][0])
        assert torch.equal(out[0][1], out[1][1]) and out[0][2] == out[1][2]
        return
    B = 512
    n = len(u)
    n_pad = -(-n // B) * B
    cols = [torch.zeros(n_pad, dtype=torch.int64) for _ in range(2)]
    cols[0][:n], cols[1][:n] = torch.from_numpy(u), torch.from_numpy(i)
    sw = torch.zeros(n_pad)
    sw[:n] = 1.0
    if engine == "window":
        step = training.make_window_train_step(I, 5, False, False)
        hist = packed
    else:
        step = training.make_train_step(I, 5, False, False, 3, "bsearch")
        hist = {"offsets": torch.from_numpy(offsets.astype(np.int32)),
                "flat": torch.from_numpy(flat.astype(np.int32))}
    w0 = {"w_i": tabs[1][:I, 6].clone(), "v_u": tabs[0][:U, :6].clone(),
          "v_i": tabs[1][:I, :6].clone(), "w_if": torch.zeros(2),
          "v_uf": torch.zeros((3, 6)), "v_if": torch.zeros((2, 6))}
    x_uf, x_if = torch.zeros((U, 3)), torch.zeros((I, 2))
    res = []
    for fn in (training.epoch_body(step, B),
               ptrain.dp_epoch_body(step, B, mesh)):
        w = {k: v.clone() for k, v in w0.items()}
        w, ll = fn(w, x_uf, x_if, hist, cols[0], cols[1], sw, n, 0.1, 0.01,
                   0.1, SEED, 2)
        res.append((w, float(ll)))
    assert res[0][1] == res[1][1]
    for k in w0:
        assert torch.equal(res[0][0][k], res[1][0][k]), k
