"""The fused chunk step with side features (the TPU kernel's ``HAS_UF`` /
``HAS_IF``) against the JAX package, and featured fused fits on the CPU.

* The port's plain featured batch against
  `rankfm_tpu.ops.fused.make_fused_batch_fn` run in Pallas TPU interpret
  mode, on the forced-negative batch of `torch_common.forced_case` with
  side features added, the weights moved between the packages by
  `rankfm_tpu_torch.utils.convert`. Tolerance: all six weight tensors, their
  updates and the log-likelihood within rel 2e-2 of their largest entry,
  the bf16-MXU tolerance of `tests/test_fused.py` (the TPU kernel gathers,
  scores and scatters through bf16 matmuls; the port computes in f32).
* The numpy oracle of `tests/test_fused.py::test_fused_feature_path_exact_
  parity` (reference gradient and decay semantics, one BPR chunk with every
  negative forced), which runs only on a TPU there, mirrored against the
  port's plain version. Both sides compute in f32 or wider, so the
  tolerance is rel 1e-5.
* Whole featured fits through the fused engine: inside the C++ oracle
  band, with a chunk-tail, and verbose + ``fit_partial``.
"""

import numpy as np
import pandas as pd
import pytest
import torch

import jax.numpy as jnp

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu.ops import fused as jfused
from rankfm_tpu_torch import RankFM as TorchRankFM
from rankfm_tpu_torch import evaluation as teval
from rankfm_tpu_torch.ops import fused as tfused
from rankfm_tpu_torch.utils.convert import (feature_tables_from_jax,
                                            feature_tables_to_jax,
                                            tables_from_jax)

from parity_common import make_features, oracle_metrics
from torch_common import (CFG, FORCED_SHAPE, METRICS,  # noqa: F401
                          assert_in_band, data_and_oracle, forced_case,
                          one_torch_thread, pallas_interpret, rel_err)

REL = 2e-2       # against the Pallas kernel (bf16 MXU)
ORACLE_REL = 1e-5  # against the f32/f64 numpy oracle
U, I, F, UB, C, NT = FORCED_SHAPE
P, Q = 5, 6      # user / item feature columns of the forced batch


def _features(rng):
    """One-hot columns plus a multi-hot one and a graded one (values on a
    1/8 grid, exact in bf16), as numpy."""
    x_uf = np.zeros((U, P), np.float32)
    x_uf[np.arange(U), rng.integers(0, P - 1, U)] = 1.0
    x_uf[:, P - 1] = rng.integers(0, 8, U) / 8.0
    x_if = np.zeros((I, Q), np.float32)
    x_if[np.arange(I), rng.integers(0, Q, I)] = 1.0
    x_if[:, 0] = np.maximum(x_if[:, 0], rng.random(I) < 0.2)
    return x_uf, x_if


def _run_both(loss_m, has_uf, has_if, seed=0):
    """One forced-negative batch through the Pallas kernel (interpret mode)
    and the port's plain version; returns the six weights and the ll of
    each side, and the initial weights."""
    rng = np.random.default_rng(seed)
    packed, rec, blk, ublk, iblk, (w_i, v_u, v_i) = forced_case(rng)
    x_uf, x_if = _features(rng)
    v_uf = rng.normal(0, 0.1, (P, F)).astype(np.float32)
    w_if = rng.normal(0, 0.05, Q).astype(np.float32)
    v_if = rng.normal(0, 0.1, (Q, F)).astype(np.float32)
    eta, alpha, beta = 0.1, 0.01, 0.1
    dreg = tuple(float(np.float32(eta) * np.float32(2 * np.float32(r)))
                 for r in (alpha, beta))
    U_pad, I_pad = jfused.user_pad(U, UB), jfused.item_pad(I)

    tu, ti = jfused.extend_tables(jnp.asarray(w_i), jnp.asarray(v_u),
                                  jnp.asarray(v_i), U_pad, I_pad)
    tuf, tif = jfused.extend_feature_tables(
        jnp.asarray(v_uf), jnp.asarray(w_if), jnp.asarray(v_if))
    # the lru_cache may hold a compiled (non-interpret) kernel
    fn = jfused.make_fused_batch_fn.__wrapped__(
        U, I, F, loss_m, NT * C, C, has_uf=has_uf, has_if=has_if, ub=UB)
    win_cols = jfused.pack_win_cols(jnp.asarray(packed), U, I, ub=UB)
    out = fn(tu, ti, jnp.asarray(rec), win_cols,
             jnp.arange(NT, dtype=jnp.int32), jnp.asarray(blk),
             jnp.asarray(ublk), jnp.asarray(iblk), jnp.array([7], jnp.int32),
             jnp.array([eta], jnp.float32), jnp.array(dreg, jnp.float32),
             x_uf=jfused.pad_feature_cols(jnp.asarray(x_uf), U_pad)
             if has_uf else None,
             x_if=jfused.pad_feature_cols(jnp.asarray(x_if), I_pad)
             if has_if else None,
             tab_uf=tuf if has_uf else None, tab_if=tif if has_if else None)
    tu_j, ti_j, tuf_j, tif_j, ll_j = out
    got_j = (jfused.extract_tables(tu_j, ti_j, U, I, F)
             + jfused.extract_feature_tables(
                 tuf_j if has_uf else tuf, tif_j if has_if else tif, P, Q, F))

    tab_u = tables_from_jax(tu, F, "cpu")
    tab_i = tables_from_jax(ti, F, "cpu")
    tuf_t, tif_t = feature_tables_from_jax(tuf, tif, P, Q, F, "cpu")
    feats = {}
    if has_uf:
        feats.update(x_uf=tfused.pad_feature_cols(torch.from_numpy(x_uf),
                                                  U_pad), tab_uf=tuf_t)
    if has_if:
        feats.update(x_if=tfused.pad_feature_cols(torch.from_numpy(x_if),
                                                  I_pad), tab_if=tif_t)
    ll_t = tfused.fused_batch_reference(
        tab_u, tab_i, torch.from_numpy(rec), torch.from_numpy(packed),
        torch.from_numpy(blk), torch.from_numpy(ublk), torch.from_numpy(iblk),
        7, eta, dreg, factors=F, max_samples=loss_m, ub_rows=UB,
        num_items=I, **feats)
    got_t = (tfused.extract_tables(tab_u, tab_i, U, I, F)
             + tfused.extract_feature_tables(tuf_t, tif_t, P, Q, F))
    names = ("w_i", "v_u", "v_i", "v_uf", "w_if", "v_if")
    before = dict(zip(names, (w_i, v_u, v_i, v_uf, w_if, v_if)))
    jax_w = {k: np.asarray(v) for k, v in zip(names, got_j)}
    port_w = {k: v.numpy() for k, v in zip(names, got_t)}
    return before, (jax_w, float(ll_j)), (port_w, float(ll_t))


@pytest.mark.parametrize("loss_m,has_uf,has_if", [
    (5, True, True), (1, True, True), (5, True, False), (5, False, True),
], ids=["warp-both", "bpr-both", "warp-user-only", "warp-item-only"])
def test_featured_batch_matches_pallas_kernel(pallas_interpret, loss_m,
                                              has_uf, has_if):
    before, (jw, ll_j), (tw, ll_t) = _run_both(loss_m, has_uf, has_if)
    moving = {"w_i", "v_u", "v_i"} | ({"v_uf"} if has_uf else set()) | (
        {"w_if", "v_if"} if has_if else set())
    for k, want in jw.items():
        assert rel_err(tw[k], want) < REL, (k, rel_err(tw[k], want))
        moved = want - before[k]
        if k in moving:
            # the updates themselves, not only the tables they land in
            assert np.abs(moved).max() > 0, k
            assert rel_err(tw[k] - before[k], moved) < REL, (
                k, rel_err(tw[k] - before[k], moved))
        else:
            # a side without features keeps its (zero-gradient) table
            np.testing.assert_array_equal(tw[k], before[k])
            np.testing.assert_array_equal(want, before[k])
    assert ll_j < 0 and abs(ll_t - ll_j) / abs(ll_j) < REL


def test_featured_chunk_matches_numpy_oracle():
    """`tests/test_fused.py::test_fused_feature_path_exact_parity` on the
    port: one-block catalog, every user's history all items but one, one
    BPR chunk of 128 rows; the numpy oracle implements the reference
    gradient and decay semantics (full-utility v_u gradient, augmented v_i
    gradient, v_if touched on a nonzero feature difference, w_if decayed
    on every sample, geometric per-touch decay)."""
    rng = np.random.default_rng(3)
    U, I, F, ND, P, C = 48, 128, 10, 6, 5, 128
    j_u = rng.integers(0, I, U)
    offsets = np.zeros(U + 1, np.int32)
    flat = []
    for u in range(U):
        its = np.setdiff1d(np.arange(I), [j_u[u]])
        flat.append(its)
        offsets[u + 1] = offsets[u] + len(its)
    flat = np.concatenate(flat).astype(np.int32)
    u_rows = rng.integers(0, U, C).astype(np.int32)
    i_rows = np.array([(j_u[u] + 1 + rng.integers(0, I - 1)) % I
                       for u in u_rows], np.int32)
    sw = rng.uniform(0.5, 2.0, C).astype(np.float32)
    dept = rng.integers(0, ND, I)
    x_if = np.zeros((I, ND), np.float32)
    x_if[np.arange(I), dept] = 1.0
    x_uf = (rng.uniform(0, 1, (U, P)).astype(np.float32)
            * (rng.uniform(size=(U, P)) < 0.4))
    w_i = rng.normal(0, 0.1, I).astype(np.float32)
    v_u = rng.normal(0, 0.1, (U, F)).astype(np.float32)
    v_i = rng.normal(0, 0.1, (I, F)).astype(np.float32)
    w_if = rng.normal(0, 0.05, ND).astype(np.float32)
    v_if = rng.normal(0, 0.05, (ND, F)).astype(np.float32)
    v_uf = rng.normal(0, 0.05, (P, F)).astype(np.float32)
    eta, alpha, beta = 0.07, 0.01, 0.1

    # numpy oracle (chunk-synchronous, reference semantics)
    uf_rep, if_rep = x_uf @ v_uf, x_if @ v_if
    b_i = w_i + x_if @ w_if

    def score(u, i):
        return b_i[i] + (v_u[u] + uf_rep[u]) @ v_i[i] + v_u[u] @ if_rep[i]

    j_o = j_u[u_rows]
    pw = np.array([score(u, i) - score(u, j)
                   for u, i, j in zip(u_rows, i_rows, j_o)])
    mult = np.log(I - 1) / np.log(I)
    d = sw * mult / (1.0 + np.exp(pw))
    g_vu = np.zeros_like(v_u)
    g_vi_p, g_vi_n = np.zeros_like(v_i), np.zeros_like(v_i)
    g_wi_p, g_wi_n = np.zeros_like(w_i), np.zeros_like(w_i)
    g_wif = np.zeros_like(w_if)
    g_vif, g_vuf = np.zeros_like(v_if), np.zeros_like(v_uf)
    cnt_u = np.zeros(U)
    cnt_ip, cnt_in = np.zeros(I), np.zeros(I)
    cnt_q, cnt_p = np.zeros(ND), np.zeros(P)
    for c in range(C):
        u, i, j, dc = u_rows[c], i_rows[c], j_o[c], d[c]
        g_vu[u] += dc * (v_i[i] - v_i[j] + if_rep[i] - if_rep[j])
        cnt_u[u] += 1
        g_vi_p[i] += dc * (v_u[u] + uf_rep[u])
        g_wi_p[i] += dc
        cnt_ip[i] += 1
        g_vi_n[j] -= dc * (v_u[u] + uf_rep[u])
        g_wi_n[j] -= dc
        cnt_in[j] += 1
        g_wif += dc * (x_if[i] - x_if[j])
        g_vif += dc * np.outer(x_if[i] - x_if[j], v_u[u])
        cnt_q += x_if[i] != x_if[j]
        g_vuf += dc * np.outer(x_uf[u], v_i[i] - v_i[j])
        cnt_p += x_uf[u] != 0
    dra, drb = eta * 2 * alpha, eta * 2 * beta

    def geo(cnt, dr):
        c = 1 - dr
        ck = c ** cnt
        f = np.where(cnt > 0,
                     (1 - ck) / np.maximum(cnt * (1 - c), 1e-12), 1.0)
        return ck, eta * f

    # the kernel's pass order: user scatter, the positive item block, then
    # the negative window block (the same block here)
    ck_u, gf_u = geo(cnt_u, dra)
    v_u_n = v_u * ck_u[:, None] + gf_u[:, None] * g_vu
    ck_ip, gf_ip = geo(cnt_ip, dra)
    v_i_1 = v_i * ck_ip[:, None] + gf_ip[:, None] * g_vi_p
    w_i_1 = w_i * ck_ip + gf_ip * g_wi_p
    ck_in, gf_in = geo(cnt_in, dra)
    v_i_n = v_i_1 * ck_in[:, None] + gf_in[:, None] * g_vi_n
    w_i_n = w_i_1 * ck_in + gf_in * g_wi_n
    ck_w, gf_w = geo(float(C), drb)
    ck_v, gf_v = geo(cnt_q, drb)
    ck_p, gf_p = geo(cnt_p, drb)
    w_if_n = w_if * ck_w + gf_w * g_wif
    v_if_n = v_if * ck_v[:, None] + gf_v[:, None] * g_vif
    v_uf_n = v_uf * ck_p[:, None] + gf_p[:, None] * g_vuf

    # the port's plain version, one batch == one chunk
    U_pad, I_pad = tfused.user_pad(U), tfused.item_pad(I)
    tab_u, tab_i = tfused.extend_tables(
        torch.from_numpy(w_i), torch.from_numpy(v_u), torch.from_numpy(v_i),
        U_pad, I_pad)
    tab_uf, tab_if = tfused.extend_feature_tables(
        torch.from_numpy(v_uf), torch.from_numpy(w_if), torch.from_numpy(v_if))
    packed = tfused.pack_history(offsets, flat, U, I)
    rec, _, cids, ublk, iblk = tfused.make_records_grouped(
        u_rows, i_rows, sw, U, I, C, C)
    assert cids.shape == (1, 1)
    ll = tfused.fused_batch_reference(
        tab_u, tab_i, torch.from_numpy(rec), torch.from_numpy(packed),
        torch.zeros((1, 1), dtype=torch.int32), torch.from_numpy(ublk[0]),
        torch.from_numpy(iblk[0]), 0, eta,
        (float(np.float32(eta) * np.float32(2 * np.float32(alpha))),
         float(np.float32(eta) * np.float32(2 * np.float32(beta)))),
        factors=F, max_samples=1, ub_rows=tfused.user_block(U),
        num_items=I,
        x_uf=tfused.pad_feature_cols(torch.from_numpy(x_uf), U_pad),
        x_if=tfused.pad_feature_cols(torch.from_numpy(x_if), I_pad),
        tab_uf=tab_uf, tab_if=tab_if)
    w_i2, v_u2, v_i2 = tfused.extract_tables(tab_u, tab_i, U, I, F)
    v_uf2, w_if2, v_if2 = tfused.extract_feature_tables(tab_uf, tab_if, P,
                                                        ND, F)

    ll_o = np.sum(-np.log1p(np.exp(-pw)))
    assert abs(ll_o - float(ll)) / abs(ll_o) < ORACLE_REL
    for name, got, want in [("v_u", v_u2, v_u_n), ("v_i", v_i2, v_i_n),
                            ("w_i", w_i2, w_i_n), ("w_if", w_if2, w_if_n),
                            ("v_if", v_if2, v_if_n),
                            ("v_uf", v_uf2, v_uf_n)]:
        assert rel_err(got.numpy(), want) < ORACLE_REL, (
            name, rel_err(got.numpy(), want))
    # tab_uf col F stays 0, tab_if's spare col F+1 too
    assert not tab_uf[:, F:].any() and not tab_if[:, F + 1].any()


def test_feature_layout_and_converters_match_jax():
    rng = np.random.default_rng(2)
    Fn, Pn, Qn = 7, 4, 9
    v_uf = rng.normal(size=(Pn, Fn)).astype(np.float32)
    w_if = rng.normal(size=Qn).astype(np.float32)
    v_if = rng.normal(size=(Qn, Fn)).astype(np.float32)
    tuf_j, tif_j = jfused.extend_feature_tables(
        jnp.asarray(v_uf), jnp.asarray(w_if), jnp.asarray(v_if))
    tuf_t, tif_t = tfused.extend_feature_tables(
        torch.from_numpy(v_uf), torch.from_numpy(w_if), torch.from_numpy(v_if))
    assert tuf_t.shape == (Pn, Fn + 2) and tif_t.shape == (Qn, Fn + 2)
    for got, want in zip(feature_tables_from_jax(tuf_j, tif_j, Pn, Qn, Fn,
                                                 "cpu"), (tuf_t, tif_t)):
        np.testing.assert_array_equal(got, want)
    for got, want in zip(feature_tables_to_jax(tuf_t, tif_t), (tuf_j, tif_j)):
        np.testing.assert_array_equal(got, np.asarray(want))
    for got, want in zip(
            tfused.extract_feature_tables(tuf_t, tif_t, Pn, Qn, Fn),
            jfused.extract_feature_tables(tuf_j, tif_j, Pn, Qn, Fn)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert tfused.extract_feature_tables(None, tif_t, Pn, Qn, Fn)[0] is None
    assert tfused.extract_feature_tables(tuf_t, None, Pn, Qn, Fn)[1:] == (
        None, None)
    x = rng.normal(size=(13, 5)).astype(np.float32)
    got = tfused.pad_feature_cols(torch.from_numpy(x), 16)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jfused.pad_feature_cols(jnp.asarray(x),
                                                        16))[:, :5])


def test_featured_batch_rejects_bad_feature_arguments():
    """A feature matrix without its table, and features not padded to the
    table's rows, raise."""
    rng = np.random.default_rng(0)
    packed, rec, blk, ublk, iblk, (w_i, v_u, v_i) = forced_case(rng)
    x_uf, _ = _features(rng)
    U_pad = tfused.user_pad(U, UB)
    tabs = tfused.extend_tables(torch.from_numpy(w_i), torch.from_numpy(v_u),
                                torch.from_numpy(v_i), U_pad,
                                tfused.item_pad(I))
    tab_uf = torch.zeros((P, F + 2))
    args = (torch.from_numpy(rec), torch.from_numpy(packed),
            torch.from_numpy(blk), torch.from_numpy(ublk),
            torch.from_numpy(iblk), 7, 0.1)
    kw = dict(factors=F, max_samples=5, ub_rows=UB, num_items=I)
    x_pad = tfused.pad_feature_cols(torch.from_numpy(x_uf), U_pad)
    with pytest.raises(ValueError, match="come together"):
        tfused.fused_batch(*tabs, *args, (0.002, 0.02), x_uf=x_pad, **kw)
    with pytest.raises(ValueError, match="pad_feature_cols"):
        tfused.fused_batch(*tabs, *args, (0.002, 0.02),
                           x_uf=torch.from_numpy(x_uf), tab_uf=tab_uf, **kw)


def test_featured_fused_fit_matches_sequential_oracle(data_and_oracle):
    """User and item one-hot features through the fused engine (3 window
    blocks: 9 main epochs, then the chunk-tail), against the oracle fit
    with the same features."""
    train, test, _ = data_and_oracle
    uf, itf = make_features(np.random.default_rng(3), train)
    tm = TorchRankFM(**CFG, device="cpu")
    tm._init_all(train, user_features=uf, item_features=itf)
    w0 = tm._weights
    tm.fit(train, user_features=uf, item_features=itf, epochs=10)
    plan = tm.last_fit_plan_
    assert plan.fused and plan.nblk == 3 and plan.chunk_tail == 1
    lls = [r["log_likelihood"] for r in tm.training_log_]
    assert len(lls) == 10 and np.isfinite(lls).all() and lls[-1] > lls[0]
    for k in ("w_if", "v_uf", "v_if"):
        assert np.abs(tm._weights[k] - w0[k]).max() > 0, k
    want = oracle_metrics(JaxRankFM(**CFG), train, test, epochs=10,
                          user_features=uf, item_features=itf)
    assert_in_band(teval.compute(tm, test, metrics=METRICS, k=10), want)


def _small_featured_log(rng, n_users=300, n_items=120, n=3000):
    """A log whose fused plan (``train_step='window'``: no candidate tail)
    has one user block and one window block at chunk 256, so 2 epochs end
    in a chunk-tail epoch at chunk 128 @ user block 256, which pads the
    user table (and the user features) to 512 rows instead of 304."""
    pairs = np.unique(np.stack([rng.integers(0, n_users, n),
                                rng.integers(0, n_items, n)], 1), axis=0)
    users, items = np.unique(pairs[:, 0]), np.unique(pairs[:, 1])
    uf = pd.DataFrame({"user_id": users})
    for k in range(3):
        uf[f"uf{k}"] = (users % 3 == k).astype(np.float32)
    itf = pd.DataFrame({"item_id": items})
    for k in range(4):
        itf[f"if{k}"] = (items % 4 == k).astype(np.float32)
    return pairs, uf, itf


def test_featured_plan_with_chunk_tail_trains():
    pairs, uf, itf = _small_featured_log(np.random.default_rng(5))
    m = TorchRankFM(factors=6, loss="warp", max_samples=5,
                    train_step="window", device="cpu")
    m.fit(pairs, user_features=uf, item_features=itf, epochs=2)
    plan = m.last_fit_plan_
    assert plan.fused and plan.chunk == 256 and plan.user_block == 1024
    assert (plan.chunk_tail, plan.tail_chunk, plan.tail_user_block) == (
        1, 128, 256)
    assert tfused.user_pad(len(m.user_idx), plan.user_block) == 304
    assert tfused.user_pad(len(m.user_idx), plan.tail_user_block) == 512
    lls = [r["log_likelihood"] for r in m.training_log_]
    assert len(lls) == 2 and np.isfinite(lls).all()
    for v in m._weights.values():
        assert np.isfinite(v).all()


def test_featured_fused_fit_verbose_then_fit_partial(capsys):
    """Verbose featured fused epochs report the penalized ll each epoch;
    fit_partial continues, moves the feature tables, and leaves the weights
    handed out before it as they were."""
    pairs, uf, itf = _small_featured_log(np.random.default_rng(6))
    m = TorchRankFM(factors=6, loss="warp", max_samples=5,
                    train_step="window", device="cpu")
    m.fit(pairs, user_features=uf, item_features=itf, epochs=2,
          verbose=True)
    assert m.last_fit_plan_.fused
    assert capsys.readouterr().out.count("training epoch:") == 2
    w1 = m._weights
    w1_copy = {k: v.copy() for k, v in w1.items()}
    m.fit_partial(pairs[:1500], user_features=uf, item_features=itf,
                  epochs=1)
    assert m.last_fit_plan_.fused
    assert m._epoch_offset == 3 and len(m.training_log_) == 3
    for k in w1:
        np.testing.assert_array_equal(w1[k], w1_copy[k])
    for k in ("w_if", "v_uf", "v_if", "v_i"):
        assert np.abs(m._weights[k] - w1[k]).max() > 0, k
    assert all(np.isfinite(r["log_likelihood"]) for r in m.training_log_)
