"""The port's XLA-engine pieces against the JAX package's: membership tests,
samplers, the window selection, one candidate step, one window step, and
the epoch loop.

Random draws differ between the packages, so every JAX draw a step makes
is recomputed here from the same key and handed to the port as a tensor.
Weights are multiples of 1/64 with small numerators, so the JAX steps'
bf16 casts of their scoring operands are exact and both packages make the
same negative choices; what remains is f32 summation order. Tolerance on
tables and log-likelihood: rel 2e-2 of the largest entry (the bf16
tolerance of `tests/test_torch_fused.py`); with ``pallas_scatter=True``
the JAX tables carry the bf16 rounding of the update rows, 3e-3 absolute
(`tests/test_scatter.py`).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rankfm_tpu.ops import fused as jfused
from rankfm_tpu.ops import negatives as jneg
from rankfm_tpu.ops import scatter as jscatter
from rankfm_tpu.ops import training as jtraining
from rankfm_tpu_torch.ops import negatives as tneg
from rankfm_tpu_torch.ops import scatter as tscatter
from rankfm_tpu_torch.ops import training as ttraining

REL = 2e-2
ETA, ALPHA, BETA = 0.1, 0.01, 0.1


def _rel(got, want):
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1e-12))


def _histories(rng, U, I, max_len):
    sets = [np.sort(rng.choice(I, size=int(rng.integers(0, max_len)),
                               replace=False)) for _ in range(U)]
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum([len(s) for s in sets])
    flat = (np.concatenate(sets).astype(np.int32) if offsets[-1]
            else np.zeros(0, np.int32))
    return sets, offsets, flat


def test_csr_and_bitmap_member_bit_equal():
    rng = np.random.default_rng(2)
    U, I = 30, 300
    _, offsets, flat = _histories(rng, U, I, 120)
    u = np.repeat(np.arange(U, dtype=np.int32), I)
    j = np.tile(np.arange(I, dtype=np.int32), U)
    mrl = int(np.diff(offsets).max())
    for max_row_len in (None, mrl):
        want = np.asarray(jneg.csr_member(
            jnp.asarray(flat), jnp.asarray(offsets), jnp.asarray(u),
            jnp.asarray(j), max_row_len))
        got = tneg.csr_member(torch.from_numpy(flat),
                              torch.from_numpy(offsets), torch.from_numpy(u),
                              torch.from_numpy(j), max_row_len).numpy()
        np.testing.assert_array_equal(got, want)
    empty = tneg.csr_member(torch.zeros(0, dtype=torch.int32),
                            torch.zeros(U + 1, dtype=torch.int32),
                            torch.from_numpy(u), torch.from_numpy(j))
    assert not empty.any()

    bm = jneg.build_bitmap_words(offsets, flat, U, I)
    np.testing.assert_array_equal(
        tneg.build_bitmap_words(offsets, flat, U, I), bm)
    jj = j.reshape(U, I)
    want = np.asarray(jneg.bitmap_member(
        jnp.asarray(bm), jnp.arange(U, dtype=jnp.int32), jnp.asarray(jj)))
    got = tneg.bitmap_member(torch.from_numpy(bm.view(np.int32)),
                             torch.arange(U), torch.from_numpy(jj)).numpy()
    np.testing.assert_array_equal(got, want)
    assert want.any() and not want.all()


def _jax_candidate_draws(key, B, M, I, sampler, rounds, post_reject):
    """The draws the JAX candidate step makes from ``key``."""
    def randint(k):
        return jax.random.randint(k, (B, M), 0, I, dtype=jnp.int32)

    if post_reject:
        return np.array(randint(key))[None]
    if sampler == "bitmap":
        keys = jax.random.split(key, max(1, rounds))
        return np.stack([np.asarray(randint(k)) for k in keys])
    keys = jax.random.split(key, rounds + 1)
    return np.stack([np.asarray(randint(keys[0]))] + [
        np.asarray(randint(jax.random.fold_in(keys[1], r)))
        for r in range(rounds)])


@pytest.mark.parametrize("sampler", ["bitmap", "bsearch"])
def test_samplers_equal_given_jax_draws(sampler):
    rng = np.random.default_rng(3)
    U, I, B, M, R = 12, 200, 96, 8, 3
    _, offsets, flat = _histories(rng, U, I, 150)    # dense: some residue
    bm = jneg.build_bitmap_words(offsets, flat, U, I)
    u = rng.integers(0, U, B).astype(np.int32)
    key = jax.random.PRNGKey(5)
    if sampler == "bitmap":
        want = jneg.sample_negatives_bitmap(key, jnp.asarray(u),
                                            jnp.asarray(bm), I, M, rounds=R)
        got = tneg.sample_negatives_bitmap(
            torch.from_numpy(u), torch.from_numpy(bm.view(np.int32)), I, M,
            torch.from_numpy(_jax_candidate_draws(key, B, M, I, sampler, R,
                                                  False)))
    else:
        mrl = int(np.diff(offsets).max())
        want = jneg.sample_negatives(key, jnp.asarray(u), jnp.asarray(offsets),
                                     jnp.asarray(flat), I, M, rounds=R,
                                     max_row_len=mrl)
        got = tneg.sample_negatives(
            torch.from_numpy(u), torch.from_numpy(offsets),
            torch.from_numpy(flat), I, M,
            torch.from_numpy(_jax_candidate_draws(key, B, M, I, sampler, R,
                                                  False)), mrl)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert not np.asarray(want[1]).all()             # residual members flagged


@pytest.mark.parametrize("M", [1, 5, 20])
def test_window_warp_select_equals_jax(M):
    """Exactly equal given JAX's own u01 and r1 (the same keys), ties and
    rows without a legal negative included."""
    rng = np.random.default_rng(M)
    G, Bg, W = 2, 128, 512
    pw = rng.integers(-64, 192, (G, Bg, W)).astype(np.float32) / 64
    nonmem = rng.random((G, Bg, W)) < rng.uniform(0, 1, (G, Bg, 1))
    nonmem[0, :4] = False                      # no legal negative
    pw[1, :4] = 5.0                            # no violator
    kc, kg = jax.random.PRNGKey(1), jax.random.PRNGKey(2)
    jloc, sampled, has_j = jtraining.window_warp_select(
        jnp.asarray(pw), jnp.asarray(nonmem), kc, kg, M)
    u01 = jax.random.uniform(kc, (G, Bg, W), minval=1e-7, maxval=1.0)
    r1 = jax.random.uniform(kg, (G, Bg), minval=1e-7, maxval=1.0)
    got = ttraining.window_warp_select(
        torch.from_numpy(pw), torch.from_numpy(nonmem),
        torch.from_numpy(np.array(u01)), torch.from_numpy(np.array(r1)), M)
    for g, w in zip(got, (jloc, sampled, has_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_small_helpers_match():
    for B in (1, 128, 256, 512, 640, 4096, 8192, 32768):
        assert ttraining.pick_window_groups(B) == jtraining.pick_window_groups(B)
    rng = np.random.default_rng(0)
    wt = rng.normal(size=(50, 6)).astype(np.float32)
    g = rng.normal(size=(50, 6)).astype(np.float32)
    k = rng.integers(0, 5, 50).astype(np.float32)
    want = jtraining._decay_apply(jnp.asarray(wt), jnp.asarray(g),
                                  jnp.asarray(k), jnp.float32(ETA),
                                  jnp.float32(ALPHA))
    got = ttraining._decay_apply(torch.from_numpy(wt), torch.from_numpy(g),
                                 torch.from_numpy(k), ETA, ALPHA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)


def _dyadic(rng, shape, k):
    return (rng.integers(-k, k + 1, shape) / 64).astype(np.float32)


def _step_case(U, I, B, features, seed=0, max_len=60):
    rng = np.random.default_rng(seed)
    sets, offsets, flat = _histories(rng, U, I, max_len)
    P, Q = (3, 4) if features else (1, 1)
    w = {"w_i": _dyadic(rng, I, 4), "v_u": _dyadic(rng, (U, 8), 16),
         "v_i": _dyadic(rng, (I, 8), 16),
         "w_if": _dyadic(rng, Q, 4) if features else np.zeros(Q, np.float32),
         "v_uf": (_dyadic(rng, (P, 8), 8) if features
                  else np.zeros((P, 8), np.float32)),
         "v_if": (_dyadic(rng, (Q, 8), 8) if features
                  else np.zeros((Q, 8), np.float32))}
    if features:
        x_uf = (rng.random((U, P)) < 0.5).astype(np.float32)
        x_if = (rng.random((I, Q)) < 0.3).astype(np.float32)
    else:
        x_uf = np.zeros((U, 1), np.float32)
        x_if = np.zeros((I, 1), np.float32)
    u = rng.integers(0, U, B).astype(np.int32)
    pos = [sets[x] if len(sets[x]) else np.arange(I) for x in u]
    i = np.array([rng.choice(p) for p in pos], np.int32)
    sw = rng.uniform(0.5, 2.0, B).astype(np.float32)
    valid = np.ones(B, bool)
    valid[-10:] = False                                 # pad rows
    bm = jneg.build_bitmap_words(offsets, flat, U, I)
    return dict(w=w, x_uf=x_uf, x_if=x_if, offsets=offsets, flat=flat, bm=bm,
                u=u, i=i, sw=sw, valid=valid,
                mrl=int(np.diff(offsets).max()),
                packed=jfused.pack_history(offsets, flat, U, I))


def _run_jax_step(step, case, hist, key):
    w = {k: jnp.asarray(v) for k, v in case["w"].items()}
    new_w, ll = jax.jit(step)(
        w, jnp.asarray(case["x_uf"]), jnp.asarray(case["x_if"]),
                     hist, jnp.asarray(case["u"]), jnp.asarray(case["i"]),
                     jnp.asarray(case["sw"]), jnp.asarray(case["valid"]),
                     jnp.float32(ETA), jnp.float32(ALPHA), jnp.float32(BETA),
                     key)
    return {k: np.asarray(v) for k, v in new_w.items()}, float(ll)


def _run_port_step(step, case, hist, draws):
    w = {k: torch.from_numpy(v.copy()) for k, v in case["w"].items()}
    new_w, ll = step.apply(
        w, torch.from_numpy(case["x_uf"]), torch.from_numpy(case["x_if"]),
        hist, torch.from_numpy(case["u"]).long(),
        torch.from_numpy(case["i"]).long(), torch.from_numpy(case["sw"]),
        torch.from_numpy(case["valid"]), ETA, ALPHA, BETA, draws)
    return {k: v.numpy() for k, v in new_w.items()}, float(ll)


def _assert_steps_agree(case, want, got, names, atol=None):
    w_j, ll_j = want
    w_t, ll_t = got
    for k in names:
        moved = w_j[k] - case["w"][k]
        assert np.abs(moved).max() > 0, k            # the step moved it
        if atol is None:
            assert _rel(w_t[k], w_j[k]) < REL, k
            assert _rel(w_t[k] - case["w"][k], moved) < REL, k
        else:
            assert np.abs(w_t[k] - w_j[k]).max() < atol, k
        np.testing.assert_array_equal(                  # the same rows moved
            np.abs(w_t[k] - case["w"][k]).reshape(len(moved), -1).max(1) > 0,
            np.abs(moved).reshape(len(moved), -1).max(1) > 0)
    assert ll_j < 0 and abs(ll_t - ll_j) <= REL * abs(ll_j)


def _candidate_pair(case, I, sampler, post_reject, features, rounds=3,
                    pallas_scatter=False):
    M = 10
    jstep = jtraining.make_train_step(
        I, M, features, features, sample_rounds=rounds, sampler=sampler,
        pallas_scatter=pallas_scatter, post_reject=post_reject,
        max_row_len=case["mrl"])
    tstep = ttraining.make_train_step(
        I, M, features, features, sample_rounds=rounds, sampler=sampler,
        post_reject=post_reject, max_row_len=case["mrl"])
    key = jax.random.PRNGKey(11)
    hist_j = {"offsets": jnp.asarray(case["offsets"]),
              "flat": jnp.asarray(case["flat"]), "bitmap": jnp.asarray(case["bm"])}
    hist_t = {"offsets": torch.from_numpy(case["offsets"]),
              "flat": torch.from_numpy(case["flat"]),
              "bitmap": torch.from_numpy(case["bm"].view(np.int32))}
    draws = torch.from_numpy(_jax_candidate_draws(
        key, len(case["u"]), M, I, sampler, rounds, post_reject))
    assert draws.shape == tstep.draw(torch.Generator(), len(case["u"])).shape
    return (_run_jax_step(jstep, case, hist_j, key),
            _run_port_step(tstep, case, hist_t, draws))


@pytest.mark.parametrize("sampler,post_reject,I,B", [
    ("bitmap", True, 3000, 256),
    ("bsearch", True, 3000, 256),
    ("bitmap", False, 3000, 256),
    ("bsearch", False, 3000, 256),
    ("bitmap", True, 2**20 + 5, 256),      # B*I > 2^28: row-gather scoring
], ids=["post-reject-bitmap", "post-reject-bsearch", "prefilter-bitmap",
        "prefilter-bsearch", "post-reject-large-catalog"])
def test_candidate_step_matches_jax(sampler, post_reject, I, B):
    case = _step_case(48, I, B, features=False)
    want, got = _candidate_pair(case, I, sampler, post_reject, False)
    _assert_steps_agree(case, want, got, ("w_i", "v_u", "v_i"))


def test_featured_candidate_step_matches_jax():
    """x_uf and x_if nonzero: the beta-decayed feature tables too."""
    case = _step_case(48, 3000, 256, features=True, seed=4)
    want, got = _candidate_pair(case, 3000, "bitmap", True, True)
    _assert_steps_agree(case, want, got,
                        ("w_i", "v_u", "v_i", "w_if", "v_uf", "v_if"))


@pytest.mark.parametrize("features", [False, True])
def test_window_step_matches_jax(features):
    I, B = 2500, 512
    case = _step_case(40, I, B, features=features, seed=7, max_len=400)
    M = 10
    key = jax.random.PRNGKey(3)
    jstep = jtraining.make_window_train_step(I, M, features, features)
    want = _run_jax_step(jstep, case, jnp.asarray(case["packed"]), key)
    G = jtraining.pick_window_groups(B)
    kblk, kcand, kgeo = jax.random.split(key, 3)
    BLK = jfused.block_size(I)
    draws = (
        torch.from_numpy(np.array(jfused.draw_window_blocks(kblk, (G,), I))),
        torch.from_numpy(np.array(jax.random.uniform(
            kcand, (G, B // G, BLK), minval=1e-7, maxval=1.0))),
        torch.from_numpy(np.array(jax.random.uniform(
            kgeo, (G, B // G), minval=1e-7, maxval=1.0))))
    tstep = ttraining.make_window_train_step(I, M, features, features)
    assert [d.shape for d in draws] == [
        d.shape for d in tstep.draw(torch.Generator(), B)]
    got = _run_port_step(tstep, case, torch.from_numpy(case["packed"]), draws)
    names = ("w_i", "v_u", "v_i") + (("w_if", "v_uf", "v_if") if features
                                     else ())
    _assert_steps_agree(case, want, got, names)


@pytest.fixture
def pallas_interpret(monkeypatch):
    orig = pl.pallas_call

    def interpret_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        kwargs["interpret"] = pltpu.InterpretParams()
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpret_call)
    jscatter._make_dense_call.cache_clear()
    jscatter._make_sorted_call.cache_clear()
    yield
    jscatter._make_dense_call.cache_clear()
    jscatter._make_sorted_call.cache_clear()


def test_pallas_scatter_step_matches_port_cpu_path(pallas_interpret):
    """The JAX step's Pallas table update (interpret mode; the item table
    in the sorted regime, the user table in the dense one) against the
    port's CPU path."""
    I, B = 20_000, 1024
    assert tscatter._regime(I, 2 * B) == "sorted"
    case = _step_case(64, I, B, features=False, seed=9)
    want, got = _candidate_pair(case, I, "bitmap", True, False,
                                pallas_scatter=True)
    _assert_steps_agree(case, want, got, ("w_i", "v_u", "v_i"), atol=3e-3)


def test_epoch_body_visits_every_row_once():
    """One permutation per epoch: every real row once with valid=True, pad
    rows invalid; the same (seed, epoch) replays the same epoch."""
    seen = []

    def draw(gen, B):
        return torch.rand(B, generator=gen, device=gen.device)

    def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, draws):
        seen.append((u.clone(), valid.clone(), draws.clone()))
        return w, (sw * valid).sum()

    n_real, n_pad, B = 1000, 1024, 256
    u = torch.arange(n_pad)
    sw = torch.ones(n_pad)
    body = ttraining.epoch_body(ttraining.TrainStep(draw, apply), B)
    _, ll = body({}, None, None, None, u, u, sw, n_real, ETA, ALPHA, BETA,
                 1492, 3)
    assert float(ll) == n_real and len(seen) == n_pad // B
    us = torch.cat([s[0] for s in seen])
    vs = torch.cat([s[1] for s in seen])
    assert sorted(us.tolist()) == list(range(n_pad))
    assert torch.equal(vs, us < n_real)
    first = [s[2] for s in seen]
    seen.clear()
    body({}, None, None, None, u, u, sw, n_real, ETA, ALPHA, BETA, 1492, 3)
    assert all(torch.equal(a, b[2]) for a, b in zip(first, seen))
    seen.clear()
    body({}, None, None, None, u, u, sw, n_real, ETA, ALPHA, BETA, 1492, 4)
    assert not torch.equal(torch.cat([s[0] for s in seen]), us)
