#!/usr/bin/env python3
"""Smoke test of rankfm_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each asserts; the first failure exits non-zero without the final
result line):

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels from ``rankfm_tpu_torch/csrc`` (nvcc, sm_90a, one
   compiler per source, all at once);
3. the fused chunk kernel (B1) against its plain PyTorch version on the
   card, on the same inputs and the same Philox draws: at the ML-1M shapes
   of both fit layouts (chunk 256 @ user block 1024, chunk 128 @ user
   block 256; F 20, M 20, 1 window) and at the Instacart shape (chunk 128
   @ user block 1024; F 50, M 50, 4 windows);
4. the table-update kernels (B3 sorted, B2 dense) against
   ``table_update_reference`` at the Instacart candidate tail's shapes
   (items: 33,362 rows, 16,384 updates; users: 10,000 rows, 8,192
   updates), and a concentrated case (every update on one row) through
   both; skipped (``idx = -1``) update rows in every case;
5. the ML-1M path: ``RankFM(factors=20, loss='warp', max_samples=20,
   learning_schedule='invscaling').fit(...)`` for 6 epochs on an
   ML-1M-shaped synthetic log (80% of it), so that the main layout and the
   chunk-tail layout both run through B1; then serving: ``recommend``
   (top 10, filter_previous), ``predict``, ``similar_items`` and
   ``evaluation.hit_rate`` on the held-out 20%;
6. the Instacart path (the mixed schedule): ``RankFM(factors=50,
   loss='warp', max_samples=50, learning_schedule='invscaling')`` fit for
   6 epochs with log2(orders + 1) sample weights on 68% of an
   Instacart-shaped synthetic log: 5 fused epochs through B1, then one
   candidate-step epoch through B3 (item table) and B2 (user table); the
   epochs of both engines timed again with the device synced; then
   ``recommend`` for 1,000 users and ``hit_rate@10`` on the held-out 32%
   against the untrained model's;
7. the window step: the ML-1M log with ``use_fused=False`` for 2 epochs,
   both tables through B2.

Each path runs with the launch counts set to 0 just before it and reads
them just after. The second-to-last line is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_USERS, N_ITEMS, N_INTER = 6040, 3706, 749_724
IC_USERS, IC_ITEMS, IC_DEPTS = 10_000, 33_362, 21
SEED = 1492
# fused kernel vs plain version on the same inputs: f32 atomics sum in a
# run-dependent order, so the tables agree to ~1e-5 absolute
TABLE_ATOL = 1e-4
LL_RTOL = 1e-4
MATCH_MIN = 0.999          # share of rows choosing the same negative
TIE_RTOL = 1e-5            # a mismatch must be a near-tie of keys
# table-update kernels vs plain version: both sum a row's updates in f32 in
# different orders (the dense kernel and index_add_ with atomics); the
# concentrated row (all 16,384 updates) stays ~1e-7 off after the eta*f
# scaling
UPDATE_ATOL = 1e-5


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def make_synthetic(rng):
    """ML-1M-shaped implicit log: user activity and item popularity both
    power-law, truncated to distinct (u, i) pairs like a ratings log."""
    item_p = 1.0 / np.arange(1, N_ITEMS + 1) ** 0.9
    item_p /= item_p.sum()
    act = np.minimum(np.maximum(
        rng.lognormal(mean=4.0, sigma=0.9, size=N_USERS), 20), 1500)
    target = np.round(np.cumsum(act * (N_INTER / act.sum()))).astype(np.int64)
    act = np.maximum(np.diff(np.concatenate([[0], target])), 5)
    users = np.repeat(np.arange(N_USERS), act)[:N_INTER]
    items = rng.choice(N_ITEMS, size=len(users), p=item_p)
    return np.stack([users, items], 1).astype(np.int64)


def make_instacart(rng):
    """Instacart-shaped reorder log with the shapes of
    ``examples/instacart_style.py:21-45``, vectorized: 10,000 users x 33,362
    products in 21 departments, Dirichlet(0.2) department tastes, power-law
    (0.8) popularity, lognormal(3.6, 0.8) basket sizes clipped to [5, 400]
    and geometric(0.35) order counts. A user's products are drawn with
    replacement from p ~ popularity * taste[department] (twice the basket
    size) and deduplicated in draw order, so a few users hold fewer than
    their basket size. Returns ``(pairs [n, 2] int64, n_orders [n])``."""
    dept_of_item = rng.integers(0, IC_DEPTS, IC_ITEMS)
    pop = 1.0 / np.arange(1, IC_ITEMS + 1) ** 0.8
    taste = rng.dirichlet(np.ones(IC_DEPTS) * 0.2, size=IC_USERS)
    basket = np.clip(rng.lognormal(3.6, 0.8, IC_USERS), 5, 400).astype(np.int64)
    # items grouped by department, with each department's popularity CDF
    by_dept = np.argsort(dept_of_item, kind="stable")
    cum = np.cumsum(pop[by_dept])
    lo = np.searchsorted(dept_of_item[by_dept], np.arange(IC_DEPTS))
    hi = np.append(lo[1:], IC_ITEMS)
    mass = np.bincount(dept_of_item, weights=pop, minlength=IC_DEPTS)
    before = np.concatenate([[0.0], cum])[lo]
    # department of each draw ~ taste * department mass, then an item of it
    users = np.repeat(np.arange(IC_USERS), 2 * basket)
    q = np.cumsum(taste * mass[None, :], 1)
    q /= q[:, -1:]
    dept = np.minimum((rng.random(len(users))[:, None] > q[users]).sum(1),
                      IC_DEPTS - 1)
    pos = np.searchsorted(cum, before[dept] + rng.random(len(users))
                          * mass[dept], side="right")
    items = by_dept[np.clip(pos, lo[dept], hi[dept] - 1)]
    # first occurrence of each (user, item), in draw order, up to the basket
    _, first = np.unique(users * IC_ITEMS + items, return_index=True)
    first.sort()
    u, i = users[first], items[first]
    rank = np.arange(len(u)) - np.searchsorted(u, u)
    keep = rank < basket[u]
    pairs = np.stack([u[keep], i[keep]], 1).astype(np.int64)
    return pairs, rng.geometric(0.35, size=len(pairs))


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, fused, train, dev, U, I, F, M, layouts, nw=1,
                 sw=None, tag="ML-1M"):
    """B1 against its plain version on ``train``'s records at each
    ``(chunk, user block)`` layout, ``nw`` windows per chunk."""
    rng = np.random.default_rng(SEED)
    pairs = np.unique(train, axis=0)
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(pairs[:, 0], minlength=U))
    packed = torch.from_numpy(fused.pack_history(
        offsets, pairs[:, 1].astype(np.int32), U, I)).to(dev)
    v_u = torch.from_numpy(rng.normal(0, 0.1, (U, F)).astype(np.float32))
    v_i = torch.from_numpy(rng.normal(0, 0.1, (I, F)).astype(np.float32))
    w_i = torch.from_numpy(rng.normal(0, 0.05, I).astype(np.float32))
    if sw is None:
        sw = np.ones(len(train), np.float32)
    eta, dreg = 0.1, float(np.float32(0.1) * np.float32(2 * np.float32(0.01)))
    out = {"max_abs_err": 0.0}
    for chunk, ub in layouts:
        rec, _, cids, ublk, iblk = fused.make_records_grouped(
            train[:, 0], train[:, 1], sw, U, I, 32768, chunk, ub=ub)
        UB = fused.user_block(U, ub)
        nT = cids.shape[1]
        rec_d = torch.from_numpy(rec).to(dev).view(-1, chunk, 2)
        gen = torch.Generator().manual_seed(SEED + chunk)
        batches = []
        for b in range(2):
            batches.append((
                rec_d[torch.from_numpy(cids[b]).to(dev).long()].reshape(-1, 2),
                fused.draw_window_blocks(gen, (nT, nw), I).to(dev),
                torch.from_numpy(ublk[b]).to(dev),
                torch.from_numpy(iblk[b]).to(dev), 1000 + b))
        tabs = fused.extend_tables(w_i.to(dev), v_u.to(dev), v_i.to(dev),
                                   fused.user_pad(U, ub), fused.item_pad(I))
        kw = dict(factors=F, max_samples=M, ub_rows=UB, num_items=I)
        tk = [t.clone() for t in tabs]
        tr = [t.clone() for t in tabs]
        n_rows = n_match = 0
        for rec_b, blk_b, ub_b, ib_b, seed in batches:
            ch_k = torch.empty(nT * chunk, dtype=torch.int32, device=dev)
            ch_r = torch.empty_like(ch_k)
            keys = []
            ll_k = float(fused.fused_batch(*tk, rec_b, packed, blk_b, ub_b,
                                           ib_b, seed, eta, dreg, chosen=ch_k,
                                           **kw))
            ll_r = float(fused.fused_batch_reference(
                *tr, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg,
                chosen=ch_r, keys=keys, **kw))
            check(np.isfinite(ll_k) and abs(ll_k - ll_r) <= LL_RTOL * abs(ll_r),
                  f"ll kernel {ll_k} vs plain {ll_r} ({tag} chunk {chunk})")
            ck, cr = ch_k.cpu().numpy(), ch_r.cpu().numpy()
            valid = (rec_b[:, 0].cpu().numpy() >> 21) & 1 == 1
            n_rows += int(valid.sum())
            n_match += int((ck == cr)[valid].sum())
            for r in np.flatnonzero((ck != cr) & valid):
                key = keys[r // chunk][r % chunk]
                kk = float(key[ck[r]]) if ck[r] >= 0 else float("-inf")
                kr = float(key[cr[r]]) if cr[r] >= 0 else float("-inf")
                check(abs(kk - kr) <= TIE_RTOL * max(1.0, abs(kr)),
                      f"row {r}: kernel chose slot {ck[r]} (key {kk}), plain "
                      f"chose {cr[r]} (key {kr}) ({tag} chunk {chunk})")
        err = max(float((a - b).abs().max()) for a, b in zip(tk, tr))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(err <= TABLE_ATOL, f"tables differ by {err} ({tag} chunk {chunk})")
        check(n_match >= MATCH_MIN * n_rows,
              f"negatives match on {n_match}/{n_rows} rows ({tag} chunk {chunk})")
        rec_b, blk_b, ub_b, ib_b, seed = batches[0]
        ms = cuda_ms(torch, lambda: fused.fused_batch(
            *tk, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg, **kw), 5)
        plain_ms = cuda_ms(torch, lambda: fused.fused_batch_reference(
            *tr, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg, **kw), 1)
        out[f"c{chunk}"] = {"ms": ms, "plain_ms": plain_ms,
                            "match": n_match / n_rows, "max_abs_err": err}
        print(f"B1 vs plain, {tag} (F {F}, M {M}, {nw} window(s)), "
              f"chunk {chunk} @ user block {UB}: "
              f"{nT} chunks/batch, negatives match {n_match}/{n_rows}, "
              f"max |table diff| {err:.3g}, batch {ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms", flush=True)
    return out


def update_phase(torch, scatter, dev):
    """B3 and B2 against ``table_update_reference`` on the same inputs."""
    rng = np.random.default_rng(SEED)
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    out = {"sorted": {"max_abs_err": 0.0}, "dense": {"max_abs_err": 0.0}}
    cases = (("items", IC_ITEMS, 16_384, True, False, ("sorted",)),
             ("users", IC_USERS, 8_192, False, False, ("dense",)),
             ("concentrated", IC_ITEMS, 16_384, True, True,
              ("sorted", "dense")))
    for name, N, B2, with_bias, concentrated, kernels in cases:
        tab = torch.from_numpy(rng.normal(0, 0.1, (N, 50)).astype(
            np.float32)).to(dev)
        bias = (torch.from_numpy(rng.normal(0, 0.1, N).astype(
            np.float32)).to(dev) if with_bias else None)
        idx = (np.full(B2, 7, np.int32) if concentrated
               else rng.integers(0, N, B2).astype(np.int32))
        idx[rng.random(B2) < 0.1] = -1
        upd = rng.normal(0, 0.1, (B2, 52)).astype(np.float32)
        upd[:, 51] = (idx >= 0).astype(np.float32)
        idx, upd = torch.from_numpy(idx).to(dev), torch.from_numpy(upd).to(dev)
        if not concentrated:
            check(scatter._regime(N, B2) == kernels[0],
                  f"{name}: regime {scatter._regime(N, B2)}")

        def copies():
            return tab.clone(), None if bias is None else bias.clone()

        want = scatter.table_update_reference(*copies(), idx, upd, eta, c)
        for kernel in kernels:
            launch = getattr(scatter, f"table_update_{kernel}")
            got = launch(*copies(), idx, upd, eta, c)
            torch.cuda.synchronize()
            err = max(float((g - w).abs().max())
                      for g, w in zip(got, want) if g is not None)
            check(err <= UPDATE_ATOL,
                  f"table_update_{kernel} ({name}) differs by {err}")
            moved = float((got[0] - tab).abs().max())
            check(moved > 0, f"table_update_{kernel} ({name}) moved nothing")
            rec = out[kernel]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            tk, bk = copies()
            ms = cuda_ms(torch, lambda: launch(tk, bk, idx, upd, eta, c), 20)
            plain_ms = cuda_ms(torch, lambda: scatter.table_update_reference(
                tk, bk, idx, upd, eta, c), 20)
            if not concentrated:
                rec["ms"], rec["plain_ms"] = ms, plain_ms
            print(f"table_update_{kernel} vs plain, {name} ({N} rows, {B2} "
                  f"updates, F 50): max |diff| {err:.3g}, {ms:.4f} ms vs "
                  f"plain {plain_ms:.4f} ms", flush=True)
    return out


def launches_of(fused, scatter):
    return {"fused_chunk": sum(fused.LAUNCHES.values()),
            "table_update_sorted": scatter.LAUNCHES["sorted"],
            "table_update_dense": scatter.LAUNCHES["dense"]}


def reset_launches(torch, fused, scatter):
    torch.cuda.synchronize()
    fused.LAUNCHES.clear()
    scatter.LAUNCHES.clear()


def check_lls(model, n, tag):
    lls = [r["log_likelihood"] for r in model.training_log_]
    check(len(lls) == n and np.isfinite(lls).all(),
          f"{tag}: epoch log-likelihoods {lls}")
    return lls


def ml1m_path(torch, RankFM, evaluation, fused, scatter, train, test):
    """The ML-1M fit (main layout + chunk-tail through B1), then serving."""
    cfg = dict(factors=20, loss="warp", max_samples=20,
               learning_schedule="invscaling", device="cuda")
    reset_launches(torch, fused, scatter)
    t0 = time.time()
    model = RankFM(**cfg).fit(train, epochs=6)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = dict(fused.LAUNCHES)
    counts = launches_of(fused, scatter)
    plan = model.last_fit_plan_
    check(plan.fused and plan.chunk_tail == 1, f"plan {plan}")
    main_key = (plan.chunk, fused.user_block(N_USERS, plan.user_block))
    tail_key = (plan.tail_chunk,
                fused.user_block(N_USERS, plan.tail_user_block))
    check(launches.get(main_key, 0) > 0 and launches.get(tail_key, 0) > 0,
          f"kernel launches by layout {launches}")
    lls = check_lls(model, 6, "ML-1M")
    check(lls[-1] > lls[0], f"ML-1M log-likelihoods {lls}")
    for r in model.training_log_:
        print(f"epoch {r['epoch']}: ll {r['log_likelihood']:.1f}, "
              f"{r['seconds']:.3f} s (fit average), "
              f"{r['interactions_per_s']:.0f} interactions/s", flush=True)
    print(f"ML-1M fit: {fit_s:.2f} s for 6 epochs of {len(model.interactions)} "
          f"rows; plan chunk {plan.chunk} @ ub {plan.user_block}, tail "
          f"{plan.chunk_tail} epoch(s) at chunk {plan.tail_chunk} @ ub "
          f"{plan.tail_user_block}; launches {launches}", flush=True)

    users = np.unique(test[:, 0])[:1000]
    t0 = time.time()
    recs = model.recommend(users, n_items=10, filter_previous=True)
    rec_s = time.time() - t0
    check(recs.shape == (len(users), 10), f"recommend shape {recs.shape}")
    check(not recs.isna().any().any(), "recommend returned NaN for known users")
    seen = set(map(tuple, train))
    check(not any((u, int(i)) in seen for u, row in zip(users, recs.values)
                  for i in row), "filter_previous returned a seen item")
    unknown = model.recommend([-1], n_items=10)
    check(unknown.isna().all().all(), "unknown user did not get a NaN row")
    t0 = time.time()
    scores = model.predict(test)
    pred_s = time.time() - t0
    check(scores.shape == (len(test),) and np.isfinite(scores).all(),
          "predict returned non-finite scores for known pairs")
    check(np.isnan(model.predict(np.array([[-1, 0]]))).all(),
          "predict of an unknown user is not NaN")
    sim = model.similar_items(int(train[0, 1]), n_items=10)
    check(len(sim) == 10 and int(train[0, 1]) not in sim, f"similar_items {sim}")
    t0 = time.time()
    hr = evaluation.hit_rate(model, test, k=10)
    hr_s = time.time() - t0
    base = RankFM(**cfg)
    base._init_all(train)
    base.is_fit = True
    hr0 = evaluation.hit_rate(base, test, k=10)
    check(hr > hr0, f"hit rate {hr} does not beat the untrained model's {hr0}")
    print(f"ML-1M serving: recommend 1000 users {rec_s:.3f} s, predict "
          f"{len(test)} pairs {pred_s:.3f} s, hit_rate@10 {hr:.4f} "
          f"(untrained {hr0:.4f}) in {hr_s:.3f} s", flush=True)
    return counts


def time_engine_epochs(torch, model, fused, training):
    """CUDA-synced wall time of one more fused epoch and one more candidate
    epoch on the fitted model's tables, at the fit's plan."""
    plan = model.last_fit_plan_
    U, I, F = len(model.user_idx), len(model.item_idx), model.factors
    dev = model.device
    rec, group, cids, ublk, iblk = fused.make_records_grouped(
        model.interactions[:, 0], model.interactions[:, 1],
        model.sample_weight, U, I, plan.batch_size, plan.chunk,
        ub=plan.user_block)
    layout = (torch.from_numpy(rec).to(dev), torch.from_numpy(group),
              torch.from_numpy(cids), torch.from_numpy(ublk),
              torch.from_numpy(iblk))
    w = model._w
    tab_u, tab_i = fused.extend_tables(
        w["w_i"], w["v_u"], w["v_i"], fused.user_pad(U, plan.user_block),
        fused.item_pad(I))
    packed = model._ensure_packed_hist()
    out = {}
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        fused.fused_epoch(tab_u, tab_i, packed, layout, 0.05, model.alpha,
                          model.seed, 100 + rep, num_users=U, num_items=I,
                          factors=F, max_samples=plan.max_samples,
                          batch_size=plan.batch_size, chunk=plan.chunk,
                          ub=plan.user_block, n_windows=plan.n_windows)
        torch.cuda.synchronize()
        out.setdefault("fused", []).append(time.time() - t0)
    n = len(model.interactions)
    nb = -(-n // plan.xla_batch)
    n_pad = nb * plan.xla_batch
    cols = [torch.zeros(n_pad, dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.float32)]
    cols[0][:n] = torch.from_numpy(model.interactions[:, 0].astype(np.int64))
    cols[1][:n] = torch.from_numpy(model.interactions[:, 1].astype(np.int64))
    cols[2][:n] = torch.from_numpy(model.sample_weight)
    step = training.make_train_step(
        I, plan.max_samples, False, False, sample_rounds=plan.rounds,
        sampler=model._sampler, post_reject=plan.post_reject,
        max_row_len=int(np.diff(model._ui_offsets).max()))
    hist = {"offsets": model._offsets_dev, "flat": model._flat_items_dev,
            "bitmap": model._ensure_bitmap()}
    body = training.epoch_body(step, plan.xla_batch)
    wc = {k: v.clone() for k, v in w.items()}
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        wc, ll = body(wc, model._x_uf_dev, model._x_if_dev, hist, *cols, n,
                      0.05, model.alpha, model.beta, model.seed, 100 + rep)
        torch.cuda.synchronize()
        out.setdefault("candidate", []).append(time.time() - t0)
        check(np.isfinite(float(ll)), "timed candidate epoch ll")
    out["candidate_batches"] = nb
    return out


def instacart_path(torch, RankFM, evaluation, fused, scatter, training):
    """The mixed schedule at the Instacart shape, then serving."""
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    pairs, n_orders = make_instacart(rng)
    mask = rng.random(len(pairs)) < 0.68
    train, test = pairs[mask], pairs[~mask]
    sw = np.log2(n_orders[mask] + 1).astype(np.float32)
    print(f"Instacart data: {len(pairs)} rows ({len(train)} train), "
          f"{len(np.unique(pairs[:, 1]))} products, {time.time() - t0:.2f} s",
          flush=True)
    cfg = dict(factors=50, loss="warp", max_samples=50, alpha=0.01,
               learning_rate=0.1, learning_schedule="invscaling",
               device="cuda")
    reset_launches(torch, fused, scatter)
    t0 = time.time()
    model = RankFM(**cfg).fit(train, sample_weight=sw, epochs=6)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    counts = launches_of(fused, scatter)
    plan = model.last_fit_plan_
    check(plan.fused and plan.n_main == 5 and plan.n_tail == 1
          and plan.step_kind == "candidate", f"Instacart plan {plan}")
    check(counts["fused_chunk"] > 0, f"B1 did not launch: {counts}")
    check(counts["table_update_sorted"] > 0 and counts["table_update_dense"] > 0,
          f"the candidate epoch did not launch both table updates: {counts}")
    lls = check_lls(model, 6, "Instacart")
    print(f"Instacart fit: {fit_s:.2f} s for 6 epochs of "
          f"{len(model.interactions)} rows ({len(model.user_idx)} users x "
          f"{len(model.item_idx)} items); plan {plan.nblk} blocks, batch "
          f"{plan.batch_size}, chunk {plan.chunk} @ ub {plan.user_block}, "
          f"{plan.n_main} fused + {plan.n_tail} candidate epoch(s) at batch "
          f"{plan.xla_batch} (post_reject {plan.post_reject}, rounds "
          f"{plan.rounds}); lls {[round(x, 1) for x in lls]}; launches "
          f"{counts}", flush=True)

    users = np.unique(test[:, 0])[:1000]
    t0 = time.time()
    recs = model.recommend(users, n_items=10, filter_previous=True)
    rec_s = time.time() - t0
    check(recs.shape == (len(users), 10) and not recs.isna().any().any(),
          f"Instacart recommend {recs.shape}")
    t0 = time.time()
    hr = evaluation.hit_rate(model, test, k=10)
    hr_s = time.time() - t0
    base = RankFM(**cfg)
    base._init_all(train, sample_weight=sw)
    base.is_fit = True
    hr0 = evaluation.hit_rate(base, test, k=10)
    check(hr > hr0, f"Instacart hit rate {hr} does not beat the untrained "
                    f"model's {hr0}")
    print(f"Instacart serving: recommend 1000 users {rec_s:.3f} s, "
          f"hit_rate@10 {hr:.4f} (untrained {hr0:.4f}) in {hr_s:.3f} s",
          flush=True)

    tm = time_engine_epochs(torch, model, fused, training)
    print(f"Instacart epochs, device synced: fused "
          f"{', '.join(f'{x:.3f}' for x in tm['fused'])} s; candidate "
          f"{', '.join(f'{x:.3f}' for x in tm['candidate'])} s "
          f"({tm['candidate_batches']} batches)", flush=True)
    return counts


def window_path(torch, RankFM, fused, scatter, train):
    """The window step on the ML-1M log: both tables through B2."""
    reset_launches(torch, fused, scatter)
    t0 = time.time()
    model = RankFM(factors=20, loss="warp", max_samples=20,
                   learning_schedule="invscaling", use_fused=False,
                   device="cuda").fit(train, epochs=2)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    counts = launches_of(fused, scatter)
    plan = model.last_fit_plan_
    check(not plan.fused and plan.step_kind == "window"
          and plan.xla_batch == 8192, f"window plan {plan}")
    check(counts["table_update_dense"] > 0 and counts["fused_chunk"] == 0
          and counts["table_update_sorted"] == 0,
          f"window-step launches {counts}")
    lls = check_lls(model, 2, "window step")
    print(f"window step: {fit_s:.2f} s for 2 epochs at batch "
          f"{plan.xla_batch}; lls {[round(x, 1) for x in lls]}; launches "
          f"{counts}", flush=True)
    return counts


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import rankfm_tpu_torch
        from rankfm_tpu_torch import RankFM, evaluation
        from rankfm_tpu_torch.ops import _build, fused, scatter, training
    except ImportError as e:
        print(f"chip_smoke: rankfm_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 1
    check(Path(rankfm_tpu_torch.__file__).resolve().parent.parent == ROOT,
          f"imported rankfm_tpu_torch from {rankfm_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.time()

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"card: {card}", flush=True)

    # 2. build
    t0 = time.time()
    _build.build()
    for name in ("fused_chunk", "table_update"):
        _build.load(name)
    print(f"build: {time.time() - t0:.2f} s (nvcc, all sources at once: "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)", flush=True)

    rng = np.random.default_rng(SEED)
    data = make_synthetic(rng)
    mask = rng.random(len(data)) < 0.8
    train, test = data[mask], data[~mask]

    # 3. B1 vs plain at the ML-1M and Instacart shapes
    kp = kernel_phase(torch, fused, train, dev, N_USERS, N_ITEMS, 20, 20,
                      ((256, 1024), (128, 256)))
    ic_pairs, _ = make_instacart(np.random.default_rng(SEED + 1))
    kp_ic = kernel_phase(torch, fused, ic_pairs, dev, IC_USERS, IC_ITEMS, 50,
                         50, ((128, 1024),), nw=4, tag="Instacart")

    # 4. B3 / B2 vs plain
    up = update_phase(torch, scatter, dev)

    # 5-7. the paths, each with its own launch counts
    paths = [ml1m_path(torch, RankFM, evaluation, fused, scatter, train, test),
             instacart_path(torch, RankFM, evaluation, fused, scatter,
                            training),
             window_path(torch, RankFM, fused, scatter, train)]
    total = {k: sum(p[k] for p in paths) for k in paths[0]}

    check("jax" not in sys.modules, "jax was imported")
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    record = {"kernels": [
        {"name": "fused_chunk", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/fused_chunk.cu",
         "replaces": "rankfm_tpu/ops/fused.py:542",
         "launches": total["fused_chunk"],
         "max_abs_err": max(kp["max_abs_err"], kp_ic["max_abs_err"]),
         "ms": kp["c256"]["ms"], "plain_ms": kp["c256"]["plain_ms"]},
        {"name": "table_update_sorted", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/table_update.cu",
         "replaces": "rankfm_tpu/ops/scatter.py:73",
         "launches": total["table_update_sorted"],
         "max_abs_err": up["sorted"]["max_abs_err"],
         "ms": up["sorted"]["ms"], "plain_ms": up["sorted"]["plain_ms"]},
        {"name": "table_update_dense", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/table_update.cu",
         "replaces": "rankfm_tpu/ops/scatter.py:61",
         "launches": total["table_update_dense"],
         "max_abs_err": up["dense"]["max_abs_err"],
         "ms": up["dense"]["ms"], "plain_ms": up["dense"]["plain_ms"]},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    try:
        return run()
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
