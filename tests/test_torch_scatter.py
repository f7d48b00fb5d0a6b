"""The port's table update against the JAX package's.

`rankfm_tpu_torch.ops.scatter.table_update_reference` is the plain version
that the port's CPU path runs and that the Hopper kernels are held to on
the card. Here it meets:

* the JAX `apply_table_update` with its Pallas kernels run in TPU
  interpret mode (the `pallas_interpret` fixture patches `pl.pallas_call`
  from the test side), in the dense regime, the sorted regime and the
  sorted regime's concentrated-span fallback. Tolerance 3e-3 absolute in
  the dense regime and 5e-3 in the sorted one, those of
  `tests/test_scatter.py`: the TPU kernels round ``upd`` to bf16 before
  their one-hot contraction, and the port does not;
* the JAX f32 path (``.at[].add`` scatters, then `_decay_apply`), to 1e-6
  absolute: the same f32 arithmetic with the sums in another order.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rankfm_tpu.ops import scatter as jscatter
from rankfm_tpu.ops.training import _decay_apply
from rankfm_tpu_torch.ops import scatter as tscatter

ETA, REG = 0.1, 0.01


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run the Pallas TPU kernels in interpret mode on the CPU; no cached
    compiled call is reused."""
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


def _case(N, B2, F, concentrated=False, seed=0):
    rng = np.random.default_rng(seed)
    tab = rng.normal(0, 0.1, (N, F)).astype(np.float32)
    bias = rng.normal(0, 0.1, N).astype(np.float32)
    idx = (np.full(B2, 7, np.int32) if concentrated
           else rng.integers(0, N, B2).astype(np.int32))
    idx[rng.random(B2) < 0.1] = -1                 # skipped update rows
    upd = rng.normal(0, 0.1, (B2, F + 2)).astype(np.float32)
    upd[:, F + 1] = (idx >= 0).astype(np.float32)
    return tab, bias, idx, upd


def _port(tab, bias, idx, upd, with_bias=True):
    c = tscatter.decay_c(ETA, REG)
    t, b = tscatter.table_update_reference(
        torch.from_numpy(tab.copy()),
        torch.from_numpy(bias.copy()) if with_bias else None,
        torch.from_numpy(idx), torch.from_numpy(upd), ETA, c)
    return t.numpy(), None if b is None else b.numpy()


def _jax_f32(tab, bias, idx, upd):
    """The JAX package's f32 path: `.at[].add` scatters + `_decay_apply`."""
    ok = idx >= 0
    F = tab.shape[1]
    ii = jnp.asarray(np.where(ok, idx, 0))
    okf = jnp.asarray(ok.astype(np.float32))
    g_tab = jnp.zeros_like(jnp.asarray(tab)).at[ii].add(
        jnp.asarray(upd[:, :F]) * okf[:, None])
    g_b = jnp.zeros(len(bias), jnp.float32).at[ii].add(
        jnp.asarray(upd[:, F]) * okf)
    cnt = jnp.zeros(len(bias), jnp.float32).at[ii].add(
        jnp.asarray(upd[:, F + 1]) * okf)
    eta, reg = jnp.float32(ETA), jnp.float32(REG)
    return (np.asarray(_decay_apply(jnp.asarray(tab), g_tab, cnt, eta, reg)),
            np.asarray(_decay_apply(jnp.asarray(bias), g_b, cnt, eta, reg)))


@pytest.mark.parametrize("N,B2,concentrated,with_bias,atol", [
    (3000, 4096, False, True, 3e-3),      # nT = 2: dense
    (3000, 4096, False, False, 3e-3),     # the user table: no bias
    (20_000, 2048, False, True, 5e-3),    # nT = 10, tb 1024: sorted
    (20_000, 2048, True, True, 5e-3),     # span overflow: dense fallback
], ids=["dense", "dense-no-bias", "sorted", "sorted-concentrated"])
def test_reference_matches_pallas_kernels(pallas_interpret, N, B2,
                                          concentrated, with_bias, atol):
    tab, bias, idx, upd = _case(N, B2, 50, concentrated)
    kind = "dense" if N == 3000 else "sorted"
    assert tscatter._regime(N, B2) == kind
    c = jnp.maximum(jnp.float32(1) - jnp.float32(ETA) * 2 * jnp.float32(REG),
                    1e-8)
    tab_j, bias_j = jscatter.apply_table_update(
        jnp.asarray(tab), jnp.asarray(bias if with_bias else 0 * bias),
        jnp.asarray(idx), jnp.asarray(upd), jnp.float32(ETA), c)
    tab_t, bias_t = _port(tab, bias, idx, upd, with_bias)
    assert np.abs(tab_t - np.asarray(tab_j)).max() < atol
    assert np.abs(tab_t - tab).max() > 10 * atol        # it did move
    if with_bias:
        assert np.abs(bias_t - np.asarray(bias_j)).max() < atol
    else:
        assert bias_t is None


@pytest.mark.parametrize("N,B2,concentrated", [
    (3000, 4096, False), (33_362, 16_384, False), (20_000, 2048, True)])
def test_reference_matches_jax_f32_path(N, B2, concentrated):
    tab, bias, idx, upd = _case(N, B2, 50, concentrated, seed=1)
    tab_t, bias_t = _port(tab, bias, idx, upd)
    tab_j, bias_j = _jax_f32(tab, bias, idx, upd)
    np.testing.assert_allclose(tab_t, tab_j, rtol=0, atol=1e-6)
    np.testing.assert_allclose(bias_t, bias_j, rtol=0, atol=1e-6)
    untouched = np.setdiff1d(np.arange(N), idx[idx >= 0])
    np.testing.assert_array_equal(tab_t[untouched], tab[untouched])


def test_regime_equals_the_jax_rule(monkeypatch):
    """The JAX wrapper builds its sorted kernel exactly when it takes the
    sorted regime (the `lax.cond` fallback traces both); record which
    kernels a trace builds, for a grid of table and update counts."""
    built = []

    def fake_dense(n_pad, F, B2, tile):
        built.append("dense")
        return lambda *a: (a[-2], a[-1])

    def fake_sorted(n_pad, F, B2, tile, tb):
        built.append("sorted")
        return lambda *a: (a[-2], a[-1])

    monkeypatch.setattr(jscatter, "_make_dense_call", fake_dense)
    monkeypatch.setattr(jscatter, "_make_sorted_call", fake_sorted)
    F = 4
    seen = set()
    for N in (1, 7, 100, 2048, 3000, 10_000, 14_336, 16_384, 16_385, 20_000,
              33_362, 100_000):
        for B2 in (8, 100, 1000, 1023, 2048, 4096, 8192, 16_384, 40_000):
            built.clear()
            jax.eval_shape(
                lambda t, b, i, u: jscatter.apply_table_update(
                    t, b, i, u, jnp.float32(0.1), jnp.float32(0.998)),
                jax.ShapeDtypeStruct((N, F), jnp.float32),
                jax.ShapeDtypeStruct((N,), jnp.float32),
                jax.ShapeDtypeStruct((B2,), jnp.int32),
                jax.ShapeDtypeStruct((B2, F + 2), jnp.float32))
            want = "sorted" if "sorted" in built else "dense"
            assert tscatter._regime(N, B2) == want, (N, B2, built)
            seen.add(want)
    assert seen == {"sorted", "dense"}


def test_apply_table_update_takes_the_plain_version_on_cpu():
    tab, bias, idx, upd = _case(3000, 512, 8)
    c = tscatter.decay_c(ETA, REG)
    want = _port(tab, bias, idx, upd)
    t, b = torch.from_numpy(tab.copy()), torch.from_numpy(bias.copy())
    before = dict(tscatter.LAUNCHES)
    out = tscatter.apply_table_update(t, b, torch.from_numpy(idx),
                                      torch.from_numpy(upd), ETA, c)
    assert out[0] is t and out[1] is b                 # updated in place
    np.testing.assert_array_equal(t.numpy(), want[0])
    np.testing.assert_array_equal(b.numpy(), want[1])
    assert dict(tscatter.LAUNCHES) == before           # no kernel launched
    with pytest.raises(ValueError, match="CUDA tensors"):
        tscatter.table_update_sorted(t, b, torch.from_numpy(idx),
                                     torch.from_numpy(upd), ETA, c)
