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

The card's sorted kernel (``csrc/table_update.cu``) applies the update in
place: it scales each touched row by ``c^cnt`` and then adds every update
row, times ``eta * f``, into it. `_emulate_inplace` repeats that order of
operations step by step in f32, and is held to the plain version and to
the JAX f32 path at 1e-6 absolute: the same products, rounded once more
per update row (values of ~0.1, so a few ulp of 1e-8 each).
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


def _case_validity0(N, B2, F, seed=2):
    """Live updates of validity 0: 30% of them at random, and every update
    of the rows divisible by 5 (such a row is touched with count 0)."""
    tab, bias, idx, upd = _case(N, B2, F, seed=seed)
    rng = np.random.default_rng(seed + 100)
    upd[(idx % 5 == 0) | (rng.random(B2) < 0.3), F + 1] = 0.0
    return tab, bias, idx, upd


def _emulate_inplace(tab, bias, idx, upd, eta, c):
    """The sorted kernel's arithmetic, phase by phase, in f32 numpy:
    `count` the validity per row, `scale` every touched row (and its bias)
    by ``ck``, then `add` ``gf * upd[p]`` into the row, update by update."""
    N, F = tab.shape
    f32 = np.float32
    tab = tab.copy()
    bias = None if bias is None else bias.copy()
    live = np.flatnonzero((idx >= 0) & (idx < N))
    rows = idx[live]
    cnt = np.zeros(N, f32)
    np.add.at(cnt, rows, upd[live, F + 1])                       # count
    ck = np.exp(cnt * np.log(f32(c)), dtype=f32)
    denom = cnt * (f32(1) - f32(c))
    gf = f32(eta) * np.where(denom > f32(1e-12),
                             (f32(1) - ck) / np.maximum(denom, f32(1e-12)),
                             f32(1)).astype(f32)
    touched = np.unique(rows)
    tab[touched] *= ck[touched, None]                            # scale
    if bias is not None:
        bias[touched] *= ck[touched]
    for p, row in zip(live, rows):                               # add
        tab[row] += gf[row] * upd[p, :F]
        if bias is not None:
            bias[row] += gf[row] * upd[p, F]
    assert tab.dtype == f32
    return tab, bias


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
    assert tscatter._regime(N, B2, 50) == kind
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
    kernels a trace builds, for a grid of table and update counts whose
    dense accumulators are under the port's cap."""
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
            for width in (F, 64, 76):
                assert N * (width + 2) * 4 <= tscatter.DENSE_ACC_MAX_BYTES
                assert tscatter._regime(N, B2, width) == want, (N, B2, width)
            seen.add(want)
    assert seen == {"sorted", "dense"}


def test_regime_caps_the_dense_accumulator():
    """Few updates on a large table: the JAX rule says dense, whose
    accumulator ``[N, F+2]`` f32 grows with the table; above
    `DENSE_ACC_MAX_BYTES` (32 MiB) the port takes the sorted kernel."""
    cap = tscatter.DENSE_ACC_MAX_BYTES
    assert cap == 32 << 20
    assert tscatter._regime(1_000_000, 512, 2) == "dense"    # 16 MB: JAX rule
    assert tscatter._regime(1_000_000, 512, 64) == "sorted"  # 264 MB
    assert tscatter._regime(1_000_000, 16_384, 64) == "sorted"
    F = 62                                             # 256 bytes a row
    rows = cap // ((F + 2) * 4)
    assert tscatter._regime(rows, 512, F) == "dense"          # at the cap
    assert tscatter._regime(rows + 1, 512, F) == "sorted"     # one row over
    # the chip smoke's shapes stay where they were
    for N, B2, width, want in ((33_362, 16_384, 50, "sorted"),
                               (10_000, 8_192, 50, "dense"),
                               (3_706, 16_384, 20, "dense"),
                               (33_362, 8, 50, "dense")):
        assert tscatter._regime(N, B2, width) == want


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


@pytest.mark.parametrize("N,B2,F,kind,with_bias", [
    (33_362, 16_384, 50, "uniform", True),     # the Instacart item table
    (20_000, 4_096, 7, "uniform", False),      # odd row width, no bias
    (33_362, 16_384, 50, "validity-0", True),
    (33_362, 16_384, 50, "concentrated", True),
], ids=["instacart-items", "F7-no-bias", "validity-0", "concentrated"])
def test_inplace_order_matches_reference_and_jax_f32(N, B2, F, kind,
                                                     with_bias):
    """Scale, then add ``gf * upd_p`` update by update (the card's sorted
    kernel) against the plain version's ``ck * tab + gf * sum`` and the JAX
    f32 path, 1e-6 absolute: each update row is rounded once more, a few
    ulp of values near 0.1."""
    if kind == "validity-0":
        tab, bias, idx, upd = _case_validity0(N, B2, F)
    else:
        tab, bias, idx, upd = _case(N, B2, F, kind == "concentrated", seed=3)
    c = tscatter.decay_c(ETA, REG)
    tab_e, bias_e = _emulate_inplace(tab, bias if with_bias else None, idx,
                                     upd, ETA, c)
    tab_t, bias_t = _port(tab, bias, idx, upd, with_bias)
    tab_j, bias_j = _jax_f32(tab, bias, idx, upd)
    np.testing.assert_allclose(tab_e, tab_t, rtol=0, atol=1e-6)
    np.testing.assert_allclose(tab_e, tab_j, rtol=0, atol=1e-6)
    if with_bias:
        np.testing.assert_allclose(bias_e, bias_t, rtol=0, atol=1e-6)
        np.testing.assert_allclose(bias_e, bias_j, rtol=0, atol=1e-6)
    else:
        assert bias_e is None and bias_t is None
    live = idx[idx >= 0]
    untouched = np.setdiff1d(np.arange(N), live)
    np.testing.assert_array_equal(tab_e[untouched], tab[untouched])
    assert np.abs(tab_e[live] - tab[live]).max() > 1e-3         # it did move
    if kind == "validity-0":
        # a touched row of count 0 gets tab += eta * sum(upd)
        zero = np.setdiff1d(live[live % 5 == 0], live[live % 5 != 0])
        row = zero[0]
        want = tab[row] + np.float32(ETA) * upd[idx == row, :F].sum(0)
        np.testing.assert_allclose(tab_t[row], want, rtol=0, atol=1e-6)
        np.testing.assert_allclose(tab_e[row], want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("B2,F,n_live,n_rows,with_bias,ops,nbytes,bound_ms", [
    # the Instacart candidate tail's item and user updates
    (16_384, 50, 14_746, 11_887, True, 1_964_520, 8_323_304, 0.00248),
    (8_192, 50, 7_373, 5_186, False, 887_250, 3_811_104, 0.00114),
], ids=["instacart-items", "instacart-users"])
def test_update_work_matches_hand_computed_figures(B2, F, n_live, n_rows,
                                                   with_bias, ops, nbytes,
                                                   bound_ms):
    """Bytes: ``B2`` update rows of ``F + 2`` floats and their int32 index,
    each touched row (and bias) read and written. Operations: an add per
    live update element, a multiply-add per touched element. The bound is
    the larger of operations / 67 TFLOP/s and bytes / 3.35 TB/s."""
    assert tscatter.update_work(B2, F, n_live, n_rows, with_bias) == (
        ops, nbytes)
    cols = F + with_bias
    assert nbytes == B2 * (4 + 4 * (F + 2)) + 2 * n_rows * cols * 4
    assert ops == n_live * cols + 2 * n_rows * cols
    assert round(1e3 * max(ops / 67e12, nbytes / 3.35e12), 5) == bound_ms


def test_scratch_sizes_say_what_the_kernels_keep():
    # 'sorted': a 64-bit accumulator row of F + 3 words per update, and one
    # claim per table row
    assert tscatter.scratch_sizes(33_362, 50, "sorted", 16_384) == {
        "acc": 2 * 16_384 * 53, "claim": 33_362}
    # its accumulator does not grow with the table
    assert tscatter.scratch_sizes(1_000_000, 64, "sorted", 512)["acc"] == \
        tscatter.scratch_sizes(33_362, 64, "sorted", 512)["acc"]
    assert sum(tscatter.scratch_sizes(1_000_000, 64, "sorted", 512).values()) \
        * 4 == 4_000_000 + 512 * 67 * 8            # 4 bytes a row + 8 * 67
    assert tscatter.scratch_sizes(10_000, 50, "dense") == {
        "acc": 2 * 10_000 * 53}
    assert tscatter.scratch_sizes(3_706, 20, "dense") == {
        "acc": 2 * 3_706 * 23}
    with pytest.raises(ValueError, match="sorted.*dense"):
        tscatter.scratch_sizes(8, 4, "span")


@pytest.mark.parametrize("N,B2,F,with_bias", [
    (33_362, 16_384, 50, True), (10_000, 8_192, 50, False),
    (20_000, 4_096, 7, False), (3_706, 16_384, 20, True)],
    ids=["sorted-regime", "dense-regime", "F7-no-bias", "ml1m-items"])
def test_apply_table_update_on_cpu_is_the_plain_version(N, B2, F, with_bias):
    """On CPU tensors, in either regime, `apply_table_update` is
    `table_update_reference` bit for bit, in place, with no launch."""
    tab, bias, idx, upd = _case(N, B2, F, seed=5)
    c = tscatter.decay_c(ETA, REG)
    want = _port(tab, bias, idx, upd, with_bias)
    t = torch.from_numpy(tab.copy())
    b = torch.from_numpy(bias.copy()) if with_bias else None
    before = dict(tscatter.LAUNCHES)
    out = tscatter.apply_table_update(t, b, torch.from_numpy(idx),
                                      torch.from_numpy(upd), ETA, c)
    assert out[0] is t and out[1] is b
    np.testing.assert_array_equal(t.numpy(), want[0])
    if with_bias:
        np.testing.assert_array_equal(b.numpy(), want[1])
    assert dict(tscatter.LAUNCHES) == before
    for launch in (tscatter.table_update_sorted, tscatter.table_update_dense):
        with pytest.raises(ValueError, match="CUDA tensors"):
            launch(t, b, torch.from_numpy(idx), torch.from_numpy(upd), ETA, c)
