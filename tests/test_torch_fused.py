"""The port's fused chunk step against the JAX package's Pallas kernel.

`rankfm_tpu.ops.fused.make_fused_batch_fn` runs here on the CPU in Pallas
TPU interpret mode (the `pallas_interpret` fixture patches
`pl.pallas_call` from the test side; nothing in the JAX package changes).
The port's plain version `fused_batch_reference` gets the same numpy-seeded
inputs. Forced-negative data makes the negative choice independent of the
two implementations' different random streams: every user's history holds
every item of each window block but one.

Tolerance: tables and log-likelihood within rel 2e-2 of their largest
entry, the bf16-MXU tolerance of `tests/test_fused.py` (the TPU kernel
gathers, scores and scatters through bf16 matmuls; the port computes in
f32).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from rankfm_tpu.ops import fused as jfused
from rankfm_tpu.ops.training import window_warp_select
from rankfm_tpu_torch.ops import _philox
from rankfm_tpu_torch.ops import fused as tfused
from rankfm_tpu_torch.utils.convert import tables_from_jax

from torch_common import (FORCED_SHAPE, forced_case,  # noqa: F401
                          pallas_interpret, rel_err)

REL = 2e-2
U, I, F, UB, C, NT = FORCED_SHAPE


def _run_both(loss_m, full_history=False, seed=0):
    rng = np.random.default_rng(seed)
    packed, rec, blk, ublk, iblk, (w_i, v_u, v_i) = forced_case(
        rng, full_history)
    eta, alpha = 0.1, 0.01
    dreg = np.float32(eta) * np.float32(2 * np.float32(alpha))
    U_pad, I_pad = jfused.user_pad(U, UB), jfused.item_pad(I)
    tu, ti = jfused.extend_tables(jnp.asarray(w_i), jnp.asarray(v_u),
                                  jnp.asarray(v_i), U_pad, I_pad)
    # the lru_cache may hold a compiled (non-interpret) kernel
    fn = jfused.make_fused_batch_fn.__wrapped__(
        U, I, F, loss_m, NT * C, C, ub=UB)
    win_cols = jfused.pack_win_cols(jnp.asarray(packed), U, I, ub=UB)
    tu_j, ti_j, _, _, ll_j = fn(
        tu, ti, jnp.asarray(rec), win_cols, jnp.arange(NT, dtype=jnp.int32),
        jnp.asarray(blk), jnp.asarray(ublk), jnp.asarray(iblk),
        jnp.array([7], jnp.int32), jnp.array([eta], jnp.float32),
        jnp.array([dreg, 0.0], jnp.float32))

    tab_u = tables_from_jax(tu, F, "cpu")
    tab_i = tables_from_jax(ti, F, "cpu")
    ll_t = tfused.fused_batch_reference(
        tab_u, tab_i, torch.from_numpy(rec), torch.from_numpy(packed),
        torch.from_numpy(blk), torch.from_numpy(ublk), torch.from_numpy(iblk),
        7, eta, (float(dreg), 0.0), factors=F, max_samples=loss_m, ub_rows=UB,
        num_items=I)
    # user rows past U are padding: the TPU kernel resets their col F to
    # 1 when it rewrites a block, the port leaves them alone
    before = (np.asarray(tu)[:U, :F + 2], np.asarray(ti)[:, :F + 2])
    jax_out = (np.asarray(tu_j)[:U], np.asarray(ti_j), float(ll_j))
    return before, jax_out, (tab_u[:U].numpy(), tab_i.numpy(), float(ll_t))


@pytest.mark.parametrize("loss_m", [1, 5], ids=["bpr", "warp"])
def test_batch_matches_pallas_kernel_forced_negatives(pallas_interpret,
                                                      loss_m):
    before, (tu_j, ti_j, ll_j), (tu_t, ti_t, ll_t) = _run_both(loss_m)
    # the JAX tables keep lanes beyond F+1 at zero
    assert not tu_j[:, F + 2:].any() and not ti_j[:, F + 2:].any()
    tu_j, ti_j = tu_j[:, :F + 2], ti_j[:, :F + 2]
    assert rel_err(tu_t, tu_j) < REL and rel_err(ti_t, ti_j) < REL
    # the updates themselves, not only the tables they land in
    for got, want, old in ((tu_t, tu_j, before[0]), (ti_t, ti_j, before[1])):
        moved = want - old
        assert np.abs(moved).max() > 0
        assert rel_err(got - old, moved) < REL, rel_err(got - old, moved)
        # the same rows moved on both sides
        np.testing.assert_array_equal(np.abs(got - old).max(1) > 0,
                                      np.abs(moved).max(1) > 0)
    assert ll_j < 0 and abs(ll_t - ll_j) / abs(ll_j) < REL


def test_full_history_users_get_no_updates(pallas_interpret):
    """No legal negative anywhere: ll is exactly 0 on both sides and the
    tables move only by the touched rows' decay."""
    _, (tu_j, ti_j, ll_j), (tu_t, ti_t, ll_t) = _run_both(5, full_history=True)
    assert ll_j == 0.0 and ll_t == 0.0
    np.testing.assert_allclose(tu_t, tu_j[:, :F + 2], rtol=1e-6, atol=0)
    np.testing.assert_allclose(ti_t, ti_j[:, :F + 2], rtol=1e-6, atol=0)


@pytest.mark.parametrize("M", [1, 5, 20])
def test_selection_matches_window_warp_select(monkeypatch, M):
    """`select_key` makes the same choice as the JAX package's CPU twin of
    the kernel's selection, fed the same uniforms: identical j, sampled and
    has_j. (`window_warp_select` takes log(r1) where the kernel takes
    log(1 - r1); dyadic r1 keeps 1 - r1 exact.)"""
    rng = np.random.default_rng(M)
    Cn, W = 256, 512
    pw = rng.normal(1.5, 1.0, (Cn, W)).astype(np.float32)
    nonmem = rng.random((Cn, W)) < rng.uniform(0.0, 1.0, (Cn, 1))
    nonmem[:4] = False                       # no legal negative
    pw[4:8] = 5.0                            # no violator
    u01 = rng.uniform(1e-7, 1.0, (Cn, W)).astype(np.float32)
    r1 = (rng.integers(1, 2**20, Cn) / 2.0**20).astype(np.float32)

    def fake_uniform(key, shape, minval=0.0, maxval=1.0):
        return jnp.asarray(u01.reshape(shape) if len(shape) == 3
                           else r1.reshape(shape))

    monkeypatch.setattr(jax.random, "uniform", fake_uniform)
    jloc, sampled, has_j = window_warp_select(
        jnp.asarray(pw)[None], jnp.asarray(nonmem)[None],
        jax.random.PRNGKey(0), jax.random.PRNGKey(1), M)

    key, s_t, _ = tfused.select_key(
        torch.from_numpy(pw), torch.from_numpy(nonmem),
        torch.from_numpy(u01), torch.from_numpy(1.0 - r1), M, 3706)
    has_t = key.max(1).values > float("-inf")
    np.testing.assert_array_equal(has_t.numpy(), np.asarray(has_j))
    ok = has_t.numpy()
    np.testing.assert_array_equal(key.argmax(1).numpy()[ok],
                                  np.asarray(jloc)[0][ok])
    np.testing.assert_array_equal(s_t.numpy().astype(np.int32),
                                  np.asarray(sampled))


def test_philox_known_answers():
    """Philox4x32-10 test vectors (Random123 kat_vectors)."""
    M = 0xFFFFFFFF
    cases = [
        ((0, 0, 0, 0, 0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
        ((M, M, M, M, M, M), (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
        ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344, 0xA4093822,
          0x299F31D0), (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
    ]
    for args, want in cases:
        t = [torch.tensor([a], dtype=torch.int64) for a in args[:4]]
        got = _philox.philox4x32(*t, args[4], args[5])
        assert tuple(int(g[0]) for g in got) == want


def test_philox_draws_uniform_and_distinct():
    """The chunk draws are uniform on [0, 1), and no two (chunk, row, slot,
    stream) counters share an output block."""
    u01 = torch.cat([_philox.chunk_draws(11, k, 128, 1024)[0].reshape(-1)
                     for k in range(4)]).numpy()
    assert u01.min() >= 0.0 and u01.max() < 1.0
    hist, _ = np.histogram(u01, bins=64, range=(0.0, 1.0))
    expected = len(u01) / 64
    chi2 = float(((hist - expected) ** 2 / expected).sum())
    assert chi2 < 130.0, chi2          # 63 dof: p < 1e-6 beyond ~130
    assert abs(u01.mean() - 0.5) < 0.005

    k = torch.arange(4)[:, None, None, None]
    row = torch.arange(64)[None, :, None, None]
    slot = torch.arange(256)[None, None, :, None]
    stream = torch.arange(2)[None, None, None, :]
    words = _philox.philox4x32(slot, row, k, stream, 11)
    words = torch.stack([w.expand(4, 64, 256, 2).reshape(-1) for w in words], 1)
    assert len(np.unique(words.numpy(), axis=0)) == words.shape[0]
    # the CPU twin of the kernel's r1 is the stream-1 word of slot 0
    _, r1 = _philox.chunk_draws(11, 2, 64, 256)
    want = (words.reshape(4, 64, 256, 2, 4)[2, :, 0, 1, 0] >> 8).float() * 2.0**-24
    np.testing.assert_array_equal(r1.numpy(), want.numpy())
