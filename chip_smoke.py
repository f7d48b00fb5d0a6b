#!/usr/bin/env python3
"""Smoke test of rankfm_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py

Phases (each asserts; the first failure exits non-zero without the final
result line):

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels from ``rankfm_tpu_torch/csrc`` (nvcc, sm_90a);
3. the fused chunk kernel against its plain PyTorch version on the card, at
   the ML-1M shapes of both fit layouts (chunk 256 @ user block 1024, chunk
   128 @ user block 256), on the same inputs and the same Philox draws;
4. the main path: ``RankFM(factors=20, loss='warp', max_samples=20,
   learning_schedule='invscaling').fit(...)`` for 6 epochs on an
   ML-1M-shaped synthetic log (80% of it), so that the main layout and the
   chunk-tail layout both run through the kernel;
5. serving: ``recommend`` (top 10, filter_previous), ``predict``,
   ``similar_items`` and ``evaluation.hit_rate`` on the held-out 20%.

The second-to-last line is the kernels' JSON record; the last line is
``{"ok": true, "device": {...}}``. The script imports nothing of JAX.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
N_USERS, N_ITEMS, N_INTER = 6040, 3706, 749_724
SEED = 1492
# kernel vs plain version on the same inputs: f32 atomics sum in a
# run-dependent order, so the tables agree to ~1e-5 absolute
TABLE_ATOL = 1e-4
LL_RTOL = 1e-4
MATCH_MIN = 0.999          # share of rows choosing the same negative
TIE_RTOL = 1e-5            # a mismatch must be a near-tie of keys


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


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def kernel_phase(torch, fused, train, dev):
    """The kernel against the plain version at both fit layouts."""
    U, I, F, M = N_USERS, N_ITEMS, 20, 20
    rng = np.random.default_rng(SEED)
    pairs = np.unique(train, axis=0)
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(pairs[:, 0], minlength=U))
    packed = torch.from_numpy(fused.pack_history(
        offsets, pairs[:, 1].astype(np.int32), U, I)).to(dev)
    v_u = torch.from_numpy(rng.normal(0, 0.1, (U, F)).astype(np.float32))
    v_i = torch.from_numpy(rng.normal(0, 0.1, (I, F)).astype(np.float32))
    w_i = torch.from_numpy(rng.normal(0, 0.05, I).astype(np.float32))
    sw = np.ones(len(train), np.float32)
    eta, dreg = 0.1, float(np.float32(0.1) * np.float32(2 * np.float32(0.01)))
    out = {"max_abs_err": 0.0}
    for chunk, ub in ((256, 1024), (128, 256)):
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
                fused.draw_window_blocks(gen, (nT, 1), I).to(dev),
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
                  f"ll kernel {ll_k} vs plain {ll_r} (chunk {chunk})")
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
                      f"chose {cr[r]} (key {kr}) (chunk {chunk})")
        err = max(float((a - b).abs().max()) for a, b in zip(tk, tr))
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(err <= TABLE_ATOL, f"tables differ by {err} (chunk {chunk})")
        check(n_match >= MATCH_MIN * n_rows,
              f"negatives match on {n_match}/{n_rows} rows (chunk {chunk})")
        rec_b, blk_b, ub_b, ib_b, seed = batches[0]
        ms = cuda_ms(torch, lambda: fused.fused_batch(
            *tk, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg, **kw), 5)
        plain_ms = cuda_ms(torch, lambda: fused.fused_batch_reference(
            *tr, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg, **kw), 1)
        out[f"c{chunk}"] = {"ms": ms, "plain_ms": plain_ms,
                            "match": n_match / n_rows, "max_abs_err": err}
        print(f"kernel vs plain, chunk {chunk} @ user block {UB}: "
              f"{nT} chunks/batch, negatives match {n_match}/{n_rows}, "
              f"max |table diff| {err:.3g}, batch {ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms", flush=True)
    return out


def run():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    try:
        import rankfm_tpu_torch
        from rankfm_tpu_torch import RankFM, evaluation
        from rankfm_tpu_torch.ops import _build, fused
    except ImportError as e:
        print(f"chip_smoke: rankfm_tpu_torch not found beside the script: {e}",
              file=sys.stderr)
        return 1
    check(Path(rankfm_tpu_torch.__file__).resolve().parent.parent == ROOT,
          f"imported rankfm_tpu_torch from {rankfm_tpu_torch.__file__}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"card: {card}", flush=True)

    # 2. build
    t0 = time.time()
    _build.load()
    print(f"build: {time.time() - t0:.2f} s (nvcc "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)", flush=True)

    rng = np.random.default_rng(SEED)
    data = make_synthetic(rng)
    mask = rng.random(len(data)) < 0.8
    train, test = data[mask], data[~mask]

    # 3. kernel vs plain version
    kp = kernel_phase(torch, fused, train, torch.device("cuda"))

    # 4. main path
    cfg = dict(factors=20, loss="warp", max_samples=20,
               learning_schedule="invscaling", device="cuda")
    fused.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.time()
    model = RankFM(**cfg).fit(train, epochs=6)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = dict(fused.LAUNCHES)
    plan = model.last_fit_plan_
    check(plan.fused and plan.chunk_tail == 1, f"plan {plan}")
    main_key = (plan.chunk, fused.user_block(N_USERS, plan.user_block))
    tail_key = (plan.tail_chunk,
                fused.user_block(N_USERS, plan.tail_user_block))
    check(launches.get(main_key, 0) > 0 and launches.get(tail_key, 0) > 0,
          f"kernel launches by layout {launches}")
    lls = [r["log_likelihood"] for r in model.training_log_]
    check(len(lls) == 6 and np.isfinite(lls).all() and lls[-1] > lls[0],
          f"epoch log-likelihoods {lls}")
    for r in model.training_log_:
        print(f"epoch {r['epoch']}: ll {r['log_likelihood']:.1f}, "
              f"{r['seconds']:.3f} s (fit average), "
              f"{r['interactions_per_s']:.0f} interactions/s", flush=True)
    print(f"fit: {fit_s:.2f} s for 6 epochs of {len(model.interactions)} "
          f"rows; plan chunk {plan.chunk} @ ub {plan.user_block}, tail "
          f"{plan.chunk_tail} epoch(s) at chunk {plan.tail_chunk} @ ub "
          f"{plan.tail_user_block}; launches {launches}", flush=True)

    # 5. serving
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
    print(f"serving: recommend 1000 users {rec_s:.3f} s, predict "
          f"{len(test)} pairs {pred_s:.3f} s, hit_rate@10 {hr:.4f} "
          f"(untrained {hr0:.4f}) in {hr_s:.3f} s", flush=True)

    check("jax" not in sys.modules, "jax was imported")
    record = {"kernels": [{
        "name": "fused_chunk",
        "route": "cuda",
        "source": "rankfm_tpu_torch/csrc/fused_chunk.cu",
        "replaces": "rankfm_tpu/ops/fused.py:542",
        "launches": int(sum(launches.values())),
        "max_abs_err": kp["max_abs_err"],
        "ms": kp["c256"]["ms"],
        "plain_ms": kp["c256"]["plain_ms"],
    }]}
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
