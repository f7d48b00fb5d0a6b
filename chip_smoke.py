#!/usr/bin/env python3
"""Smoke test of rankfm_tpu_torch on one NVIDIA GPU, end to end.

    python3 chip_smoke.py [--parent DIR | --only-updates | --only-host-half
                           | --only-mesh | --only-quality | --only-repro
                           | --profiler-windows N]

``--only-updates`` stops after phase 4, ``--only-host-half`` runs phase 10
alone, ``--only-mesh`` phase 11 after the single-device fit of phase 5,
``--only-quality`` phase 12 alone, ``--only-repro`` phase 13 alone,
``--profiler-windows N`` counts the ``torch.profiler`` traces that
come back without device time in N short windows with and without the
idle margin the script leaves in each; none prints a result line.
``--parent DIR`` also measures another tree of this repository (an
unpacked ``git archive`` of the parent commit) on the same card, before
and after this one, each time in a process of its own, and prints its B1
batch times and phase clocks, its table-update times and its
candidate-step, window-step and fused epochs (ML-1M and Instacart) beside
this tree's.

Phases (each asserts; the first failure exits non-zero without the final
result line):

1. require CUDA and print the card's name and power limit;
2. build the CUDA kernels from ``rankfm_tpu_torch/csrc`` (nvcc, sm_90a, one
   compiler per library, all at once), and the native ingest library from
   ``rankfm_tpu_torch/native`` (g++; the script fails if it does not build);
3. what a phase boundary of B1 costs: grid barriers inside one
   cooperative launch against empty dependent launches; then the fused
   chunk kernel (B1) against its plain PyTorch version on the
   card, on the same inputs and the same Philox draws, with its roofline
   bound and the time of each of its phases: at the ML-1M shapes
   of both fit layouts (chunk 256 @ user block 1024, chunk 128 @ user
   block 256; F 20, M 20, 1 window) and at the Instacart shape (chunk 128
   @ user block 1024; F 50, M 50, 4 windows); then its side-feature
   variant at the Instacart shape (21 department one-hots on items, a
   21-column one-hot of each user's dominant taste department on users)
   and at the ML-1M shapes with the public ML-1M feature schemas (users:
   gender 2 + age bucket 7 + occupation 21 one-hots; movies: an 18-genre
   multi-hot; values drawn from the seed): both feature sets at both fit
   layouts, user-only and item-only features at the main layout; and
   featureless at the Instacart shape with 8 windows a chunk (the wide
   tail's). Every shape also runs the same batch twice from the same
   tables: every table, ll term and chosen slot must be equal to the byte;
4. the table-update kernels (B3 sorted, B2 dense) against
   ``table_update_reference`` (touched rows within the tolerance, every
   other row bit-equal, two batches in a row on one table) at the
   Instacart candidate tail's shapes (items: 33,362 rows, 16,384 updates;
   users: 10,000 rows, 8,192 updates), a concentrated case (every update
   on one row, through both; B3 must not be slower than the plain
   version), the web-scale item table (1,000,000 rows, F 64: B3's time
   beside its time at 33,362 rows), the ML-1M window step's shapes
   (power-law item rows), an odd row width without bias and live updates
   of validity 0 through both, the user table through B3 as well, 8
   updates (what a call costs before any work), and 512 updates on the
   web-scale table through both (B2's pass over its 264 MB accumulator
   against B3, then both at four table sizes between: what set
   ``scatter.DENSE_ACC_MAX_BYTES``); skipped (``idx = -1``) update rows in every
   case, and every case called twice on copies of its table, which must give
   equal bytes. Per case: ``ms`` (CUDA events over 20 back-to-back calls), the
   host's enqueue time per call, the device time and the launches per call
   under ``torch.profiler``, the plain version's time, and the time of
   ``index_add_`` on the same updates (a yardstick for the sum without the
   decay; the port never calls it on the card);
5. the ML-1M path: ``RankFM(factors=20, loss='warp', max_samples=20,
   learning_schedule='invscaling').fit(...)`` for 6 epochs on an
   ML-1M-shaped synthetic log (80% of it), so that the main layout and the
   chunk-tail layout both run through B1; then serving: ``recommend``
   (top 10, filter_previous), ``predict``, ``similar_items`` and
   ``evaluation.hit_rate`` on the held-out 20%; then the same fit with
   ``shuffle_layouts=4``: 4 layouts built, no sort inside an epoch, its
   epochs timed beside the sorting ones;
6. the Instacart path (the mixed schedule): ``RankFM(factors=50,
   loss='warp', max_samples=50, learning_schedule='invscaling')`` fit for
   6 epochs with log2(orders + 1) sample weights on 68% of an
   Instacart-shaped synthetic log: 5 fused epochs through B1, then one
   candidate-step epoch through B3 (item table) and B2 (user table); the
   epochs of both engines timed again with the device synced; then
   ``recommend`` for 1,000 users and ``hit_rate@10`` on the held-out 32%
   against the untrained model's; then the same fit with
   ``tail_windows=8``: 5 fused epochs at 4 windows a chunk, then one
   wide-tail fused epoch at 8 (no table update), its ``hit_rate@10`` and
   its tail epoch beside the candidate tail's;
7. the featured Instacart path: the same fit with ``beta=0.1`` and the
   user and item features of phase 3: 5 fused epochs through featured B1,
   then one featured candidate epoch through B3 and B2; every table
   finite, the feature tables moved; the featured epochs timed with the
   device synced beside the featureless ones; ``recommend`` for 1,000
   users and ``hit_rate@10`` against the untrained featured model's;
8. the featured ML-1M path: 3 epochs with the ML-1M-schema features, 2 at
   the main layout and 1 at the chunk-tail layout (the user features
   re-padded), all through featured B1;
9. the window step: the ML-1M log with ``use_fused=False`` for 2 epochs,
   both tables through B2; two more epochs timed with the device synced;
10. ingest, resume, checkpoint, baseline, at the ML-1M shape of phase 5 with
   raw ids offset and shuffled: the native ingest library is loaded
   (the script fails without it), and the native and numpy paths of
   ``map_interactions`` and ``build_user_items_csr`` give equal arrays,
   each path timed, as does ``build_index`` (numpy only in the port)
   beside the library's ``unique_sorted``;
   ``fit(epochs=2)`` through B1 and its ``last_fit_timing_``; ``fit_partial``
   on the same frame reuses the history pack and both record layouts (the
   cached tensors are the same objects), its ``last_fit_timing_`` and both
   calls' synced wall; ``fit_partial`` on another frame rebuilds them;
   ``save`` then ``load(device='cuda')`` serves equal ``recommend`` lists
   (1,000 users, top 10, filtered) and equal ``predict`` scores, and
   ``fit_partial`` after ``load`` equals the model that was never saved,
   bit for bit (same epoch stream); ``ImplicitALS(factors=50)`` for 3 sweeps on the
   Instacart-shaped log of phase 6 (finite factors, ``hit_rate@10`` above
   the untrained factors', seconds per sweep) and at 600 x 2,500 against
   ``device='cpu'``; ``observe.device_memory_stats`` (peak allocated bytes)
   and ``observe.trace`` around one epoch (a trace file);
11. the mesh (``rankfm_tpu_torch.parallel``): first, in this process,
   ``dp_fused_epoch`` on a ``data=1`` mesh against ``fused_epoch`` from the
   same tables (run 6, an identity check of rank 0's draws: the same draws
   and records at every B1 launch, the same tables; a group of one rank
   runs no collective, so one NCCL all-reduce of a known tensor on the
   one-rank group checks that NCCL starts on the card); then two ranks
   spawned with
   ``torch.multiprocessing``, one card each over NCCL when there are two,
   else both on ``cuda:0`` over gloo: (1) the ML-1M fit of phase 5 on
   ``data=2`` with ``dp_sync_every`` 1 and 4, its hit rate and DCG at 10 at
   most 0.05 below phase 5's, and one more epoch under ``torch.profiler``;
   (2) the Instacart mixed schedule of phase 6 on ``data=2`` (B1, then B2
   and B3 per rank); (3) the window step of phase 9 on ``data=2``; (4)
   table parallelism on ``(data=1, model=2)`` at the table shape of
   ``examples/webscale_smoke.py`` (100,000 users x 1,000,000 items, F 64,
   WARP M=10, each item once: 1,000,000 rows), one epoch, the planner
   placing it ``tp``; (5) ``recommend`` for 1,000 users (top 10, filtered)
   from the shards, equal to a single-device model loaded from the mesh
   model's ``save``. Both ranks' lls and table hashes must be equal; per
   rank and run the launches, the epochs and the collectives (calls, bytes
   and ms each: the delta all-reduce per sync group, the owner-gather
   all-reduces and all-gathers of the table-parallel run);
12. quality against the oracle on the card: the port's C++ sequential
   oracle (``rankfm_tpu_torch/native/oracle.cpp``, g++; the script fails
   if it does not build) and its harness ``tests/torch_parity_common.py``
   (imported by path), then, through the public API on ``cuda``: the full
   ML-1M headline (6,040 x 3,706, 165 per user, 20 epochs, the auto plan:
   fused with a 3-epoch chunk-tail) at model seeds 1492, 7 and 23, each
   inside the JAX package's ``FUSED`` gate with the oracle's hit rate in
   (0.75, 0.95); the large catalog (2,000 x 10,000, 18 epochs, +-0.03);
   the five scaled configs of the JAX package's parity tests (2,400 x
   1,200, 10 epochs: the candidate step under ``TIGHT``, the fused path
   under ``FUSED``); the Instacart headline of phase 6 at 30 epochs with
   its log2 weights (reported, not gated), and reported beside the oracle
   of the same data and seed, not gated: the ML-1M headline at seed 1492
   with ``shuffle_layouts=4`` and the Instacart headline with
   ``tail_windows=8``. The oracle fits run on a thread
   pool while the card fits. Prints each case's five deltas (port -
   oracle), the worst ML-1M seed's hit rate and DCG beside the JAX
   package's, the phase's seconds and its launches (B1 with and without
   features, B2 and B3 must all launch); then runs
   ``examples/torch/movielens_style.py``, ``instacart_style.py`` and
   ``features_and_weights.py``, each in a process of its own, all at once,
   each required to exit 0;
13. the same fit twice from one seed, at full width: ML-1M (6 epochs, main
   and chunk-tail), the Instacart mixed schedule (B1, B3, B2), with
   features, the window step (B2), the Instacart wide tail and ML-1M on 4
   cycled layouts; the SHA-256 of their weights printed and required
   equal. Then one fit of each engine under
   ``torch.use_deterministic_algorithms(True)`` with
   ``CUBLAS_WORKSPACE_CONFIG=:4096:8``, in a process of its own, which must
   raise on no operation.

Each path runs with the launch counts set to 0 just before it and reads
them just after (on each rank, on the mesh); the kernels' JSON adds the
mesh ranks' launches in ``launches`` and lists them in ``mesh_launches``,
and B1's launches at 8 windows a chunk or more in ``launches_wide_tail``.
The second-to-last line is the kernels' JSON record; the
last line is ``{"ok": true, "device": {...}}``. The script imports nothing
of JAX.
"""

import argparse
import dataclasses
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pandas as pd

ROOT = Path(__file__).resolve().parent
N_USERS, N_ITEMS, N_INTER = 6040, 3706, 749_724
IC_USERS, IC_ITEMS, IC_DEPTS = 10_000, 33_362, 21
# ML-1M side-feature schemas: users.dat gender, age bucket, occupation;
# movies.dat genres
ML_USER_COLS, ML_GENRES = (2, 7, 21), 18
SEED = 1492
# fused kernel vs plain version on the same inputs: the kernel sums in 64-bit
# fixed point and in other orders than the plain version's f32 products, so
# the tables agree to ~1e-5 absolute
TABLE_ATOL = 1e-4
LL_RTOL = 1e-4
MATCH_MIN = 0.999          # share of rows choosing the same negative
TIE_RTOL = 1e-5            # a mismatch must be a near-tie of keys
# table-update kernels vs plain version: the kernels sum a row's updates in
# 64-bit fixed point, index_add_ in f32 in its own order; the concentrated
# row (all 16,384 updates) stays ~1e-7 off after the eta*f scaling
UPDATE_ATOL = 1e-5
CARD = "?"   # nvidia-smi's name and power limit, printed beside each time
# the card's published peaks (NVIDIA H100 SXM data sheet): f32 outside the
# tensor cores, and device memory
PEAK_F32_OPS, PEAK_BYTES = 67e12, 3.35e12
B1_KEYS = ("ms", "plain_ms", "bound_ms", "bound_by", "chunks_per_batch")
# the wide-window tail's window count at the Instacart shape
WIDE_NW = 8
B1_PHASES = ("feature_reps", "score_tiles", "select_scatter", "apply_updates")
UPDATE_TIME_KEYS = ("ms", "plain_ms", "device_ms", "enqueue_us",
                    "index_add_ms")
UPDATE_KEYS = UPDATE_TIME_KEYS + ("bound_ms", "bound_by")
UPDATE_PROFILE_CALLS = 41      # the table updates of one candidate epoch
PROFILE_MARGIN_S = 0.005       # idle time inside a profiler window, each end
FIT_TIMING_KEYS = ("ingest_s", "hist_pack_s", "records_s", "prep_s",
                   "epoch0_call_s", "dispatch_s", "block_s")
# every kernel sums in an order fixed by its inputs, so a CUDA model after
# `load` equals the one never saved after the same `fit_partial`, bit for
# bit; started over from epoch 0 it must differ by more than this (relative)
REPLAY_MIN = 1e-2
ALS_RTOL = 1e-3            # ALS factors, card vs CPU, relative to the largest
# (name, table rows, F, updates, bias, row pattern, kernels, the kernel
# whose main-path shape this is): the Instacart candidate tail's two tables
# (the user table through B3 too: why the small tables keep a kernel of
# their own), every update on one row, the web-scale item table
# (`examples/webscale_smoke.py`: 1M items, f=64), the ML-1M window step's
# two tables, an odd row width without bias, live updates of validity 0,
# and 8 updates (what a call costs before any work)
UPDATE_CASES = (
    ("items", IC_ITEMS, 50, 16_384, True, "uniform", ("sorted",), "sorted"),
    ("users", IC_USERS, 50, 8_192, False, "uniform", ("dense", "sorted"),
     "dense"),
    ("concentrated", IC_ITEMS, 50, 16_384, True, "one-row",
     ("sorted", "dense"), None),
    ("web-scale items", 1_000_000, 64, 16_384, True, "uniform", ("sorted",),
     None),
    ("ML-1M window items", N_ITEMS, 20, 16_384, True, "popular", ("dense",),
     None),
    ("ML-1M window users", N_USERS, 20, 8_192, False, "uniform", ("dense",),
     None),
    ("F 7, no bias", 20_000, 7, 4_096, False, "uniform", ("sorted", "dense"),
     None),
    ("validity 0", IC_ITEMS, 50, 16_384, True, "validity-0",
     ("sorted", "dense"), None),
    ("8 updates", IC_ITEMS, 50, 8, True, "uniform", ("dense", "sorted"),
     None),
    ("web-scale, 512 updates", 1_000_000, 64, 512, True, "uniform",
     ("sorted", "dense"), None),
)
# rows of the F 64 tables on which both kernels are timed with 512 updates:
# where B3 overtakes B2, whose pass and accumulator grow with the table
SWEEP_ROWS = (65_536, 131_072, 262_144, 524_288)
# the mesh phase: the data-parallel ML-1M fit's hit rate and DCG at 10 may
# fall at most the oracle band below the single-device fit's; the
# table-parallel run's table shape (`examples/webscale_smoke.py:18`)
MESH_BAND = 0.05
WEB_USERS, WEB_ITEMS, WEB_F = 100_000, 1_000_000, 64
MESH_TIMEOUT_S = 600
# phase 12: the Instacart headline's epochs (`examples/instacart_style.py`),
# and how long the card waits for the oracle's last fit
QUALITY_IC_EPOCHS = 30
QUALITY_ORACLE_TIMEOUT_S = 900
# the examples run after phase 12, all at once, each within the timeout
EXAMPLES = ("movielens_style.py", "instacart_style.py",
            "features_and_weights.py")
EXAMPLE_TIMEOUT_S = 600


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
    their basket size. Returns ``(pairs [n, 2] int64, n_orders [n],
    depts)``: ``depts`` holds each product's department and each user's
    dominant taste department (the argmax of the Dirichlet draw; a
    synthetic user feature, the example has none)."""
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
    depts = {"item": dept_of_item, "user": taste.argmax(1)}
    return pairs, rng.geometric(0.35, size=len(pairs)), depts


def one_hot(codes, n):
    x = np.zeros((len(codes), n), np.float32)
    x[np.arange(len(codes)), codes] = 1.0
    return x


def ml1m_features(rng):
    """Side features in the public ML-1M schema, drawn from the seed:
    ``x_uf [6040, 30]``, one-hots of gender, age bucket and occupation
    (``users.dat``), and ``x_if [3706, 18]``, a multi-hot of 1-3 genres
    (``movies.dat``)."""
    x_uf = np.concatenate([one_hot(rng.integers(0, n, N_USERS), n)
                           for n in ML_USER_COLS], 1)
    x_if = np.zeros((N_ITEMS, ML_GENRES), np.float32)
    n_genres = rng.integers(1, 4, N_ITEMS)
    for k in range(3):
        rows = np.flatnonzero(n_genres > k)
        x_if[rows, rng.integers(0, ML_GENRES, len(rows))] = 1.0
    return x_uf, x_if


def feature_frame(x, ids, name):
    """Rows ``ids`` of ``x`` as a feature frame ``[<name>_id, f0, ...]``
    (a fit takes features for exactly its interactions' ids)."""
    df = pd.DataFrame(x[ids], columns=[f"{name}{k}" for k in range(x.shape[1])])
    df.insert(0, f"{name}_id", ids)
    return df


def cuda_ms(torch, fn, reps):
    """Mean milliseconds of ``fn()`` on the card (CUDA events)."""
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(ops, nbytes):
    """``(bound_ms, bound_by)``: the least time the card could take for
    ``ops`` f32 operations over ``nbytes`` of device memory traffic."""
    t_ops, t_bytes = ops / PEAK_F32_OPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops > t_bytes else "bytes")


def probe_phase_boundaries(torch, fused):
    """Grid barriers of one cooperative launch against empty dependent
    launches, 3 per chunk at 128 and 256 chunks: what decided B1's one
    launch per batch."""
    for nT in (128, 256):
        n = 3 * nT
        fused.phase_probe(n, True)
        fused.phase_probe(n, False)
        sync_ms = cuda_ms(torch, lambda: fused.phase_probe(n, True), 5)
        launch_ms = cuda_ms(torch, lambda: fused.phase_probe(n, False), 5)
        check(sync_ms > 0 and launch_ms > 0, "phase probe measured nothing")
        print(f"phase boundaries, {nT} chunks x 3: {n} grid barriers "
              f"{sync_ms:.4f} ms ({1e3 * sync_ms / n:.2f} us each) vs {n} "
              f"empty dependent launches {launch_ms:.4f} ms "
              f"({1e3 * launch_ms / n:.2f} us each) ({CARD})", flush=True)


def kernel_phase(torch, fused, train, dev, U, I, F, M, layouts, nw=1,
                 sw=None, tag="ML-1M", x_uf=None, x_if=None, other_tree=False):
    """B1 against its plain version on ``train``'s records at each
    ``(chunk, user block)`` layout, ``nw`` windows per chunk; with side
    features when ``x_uf [U, P]`` and/or ``x_if [I, Q]`` are given (the
    four tables are compared); then the same batch twice from the same
    tables, which must give equal bytes (left out for another tree's
    kernel)."""
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
    # dreg = (eta*2*alpha, eta*2*beta) at alpha 0.01, beta 0.1
    eta = 0.1
    dreg = tuple(float(np.float32(eta) * np.float32(2 * np.float32(r)))
                 for r in (0.01, 0.1))
    feats = {}
    if x_uf is not None or x_if is not None:
        P = 1 if x_uf is None else x_uf.shape[1]
        Q = 1 if x_if is None else x_if.shape[1]
        tuf, tif = fused.extend_feature_tables(*(
            torch.from_numpy(rng.normal(0, 0.05, shape).astype(
                np.float32)).to(dev) for shape in ((P, F), Q, (Q, F))))
        if x_if is not None:
            feats.update(x_if=fused.pad_feature_cols(
                torch.from_numpy(x_if).to(dev), fused.item_pad(I)), tab_if=tif)
        if x_uf is not None:
            feats["tab_uf"] = tuf
        tag += (f" + features (user {0 if x_uf is None else P}, item "
                f"{0 if x_if is None else Q})")
    out = {"max_abs_err": 0.0}
    for chunk, ub in layouts:
        if x_uf is not None:
            feats["x_uf"] = fused.pad_feature_cols(
                torch.from_numpy(x_uf).to(dev), fused.user_pad(U, ub))
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
        fk = {k: v.clone() for k, v in feats.items()}
        fr = {k: v.clone() for k, v in feats.items()}
        n_rows = n_match = 0
        plain = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        for rec_b, blk_b, ub_b, ib_b, seed in batches:
            ch_k = torch.empty(nT * chunk, dtype=torch.int32, device=dev)
            ch_r = torch.empty_like(ch_k)
            keys = []
            ll_k = float(fused.fused_batch(*tk, rec_b, packed, blk_b, ub_b,
                                           ib_b, seed, eta, dreg, chosen=ch_k,
                                           **kw, **fk))
            plain[0].record()
            ll_r = fused.fused_batch_reference(
                *tr, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg,
                chosen=ch_r, keys=keys, **kw, **fr)
            plain[1].record()
            ll_r = float(ll_r)
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
        pairs_kr = list(zip(tk, tr)) + [(fk[k], fr[k]) for k in
                                        ("tab_uf", "tab_if") if k in feats]
        err = max(float((a - b).abs().max()) for a, b in pairs_kr)
        out["max_abs_err"] = max(out["max_abs_err"], err)
        check(err <= TABLE_ATOL, f"tables differ by {err} ({tag} chunk {chunk})")
        check(n_match >= MATCH_MIN * n_rows,
              f"negatives match on {n_match}/{n_rows} rows ({tag} chunk {chunk})")
        rec_b, blk_b, ub_b, ib_b, seed = batches[0]
        if not other_tree:
            # the same batch twice from the same tables: every table, ll
            # term and chosen slot equal to the byte
            runs = []
            for _ in range(2):
                tt = [t.clone() for t in tabs]
                ft = {k: v.clone() for k, v in feats.items()}
                ch = torch.empty(nT * chunk, dtype=torch.int32, device=dev)
                llr = torch.empty(nT * chunk, dtype=torch.float32, device=dev)
                fused.fused_batch(*tt, rec_b, packed, blk_b, ub_b, ib_b, seed,
                                  eta, dreg, chosen=ch, ll_rows=llr, **kw,
                                  **ft)
                runs.append(tt + [ft[k] for k in ("tab_uf", "tab_if")
                                  if k in ft] + [ch, llr])
            check(all(torch.equal(a, b) for a, b in zip(*runs)),
                  f"B1 gave other bytes on a second run ({tag} chunk {chunk})")
        ms = cuda_ms(torch, lambda: fused.fused_batch(
            *tk, rec_b, packed, blk_b, ub_b, ib_b, seed, eta, dreg, **kw,
            **fk), 5)
        plain_ms = plain[0].elapsed_time(plain[1])   # the last batch compared
        # the bound of this batch, from its shapes and the features' density
        ops, nbytes = fused.chunk_work(
            chunk, UB, fused.block_size(I), nw, F + 2, x_uf is not None,
            x_if is not None, 0 if x_uf is None else x_uf.shape[1],
            0 if x_if is None else x_if.shape[1],
            None if x_uf is None else float((x_uf != 0).sum(1).mean()),
            None if x_if is None else float((x_if != 0).sum(1).mean()))
        bound_ms, bound_by = bound(nT * ops, nT * nbytes)
        # the phases of 3 more batches, as block 0 saw them
        phase_ns = torch.zeros(4, dtype=torch.int64, device=dev)
        for _ in range(3):
            fused.fused_batch(*tk, rec_b, packed, blk_b, ub_b, ib_b, seed, eta,
                              dreg, phase_ns=phase_ns, **kw, **fk)
        phase_us = [x / (3 * nT) / 1e3 for x in phase_ns.tolist()]
        check(sum(phase_us) > 0, f"no phase times ({tag} chunk {chunk})")
        out[f"c{chunk}"] = {"ms": ms, "plain_ms": plain_ms,
                            "match": n_match / n_rows, "max_abs_err": err,
                            "bound_ms": bound_ms, "bound_by": bound_by,
                            "chunks_per_batch": nT, "phase_us": phase_us}
        print(f"B1 vs plain, {tag} (F {F}, M {M}, {nw} window(s)), "
              f"chunk {chunk} @ user block {UB}: "
              f"{nT} chunks/batch, negatives match {n_match}/{n_rows}, "
              f"max |table diff| {err:.3g}"
              + ("" if other_tree else ", equal bytes on a second run")
              + f", batch {ms:.3f} ms vs plain "
              f"{plain_ms:.3f} ms; bound {bound_ms:.4f} ms ({bound_by}: "
              f"{ops / 1e6:.1f} MFLOP, {nbytes / 1e6:.2f} MB per chunk), "
              f"{100 * bound_ms / ms:.2f}% reached ({CARD})", flush=True)
        print(f"B1 phases, {tag} ({nw} window(s)), chunk {chunk}: "
              + ", ".join(f"{n} {us:.2f}" for n, us in
                          zip(B1_PHASES, phase_us) if us > 0)
              + f" us per chunk, barrier included; {sum(phase_us):.2f} us "
              f"per chunk ({CARD})", flush=True)
    return out


def update_inputs(torch, dev, rng, N, F, B2, with_bias, pattern):
    """``(tab, bias, idx, upd)`` on the card. ``pattern``: 'uniform' rows,
    'popular' (power-law 0.9 row popularity, the hot rows of an item
    table), 'one-row' (every update on row 7) or 'validity-0' (uniform;
    30% of the live updates, and every update of the rows divisible by 5,
    carry validity 0). A tenth of the updates is skipped (``idx = -1``)."""
    tab = torch.from_numpy(rng.normal(0, 0.1, (N, F)).astype(np.float32))
    bias = (torch.from_numpy(rng.normal(0, 0.1, N).astype(np.float32)).to(dev)
            if with_bias else None)
    if pattern == "one-row":
        idx = np.full(B2, 7, np.int32)
    elif pattern == "popular":
        pop = 1.0 / np.arange(1, N + 1) ** 0.9
        idx = rng.choice(N, size=B2, p=pop / pop.sum()).astype(np.int32)
    else:
        idx = rng.integers(0, N, B2).astype(np.int32)
    idx[rng.random(B2) < 0.1] = -1
    upd = rng.normal(0, 0.1, (B2, F + 2)).astype(np.float32)
    upd[:, F + 1] = (idx >= 0).astype(np.float32)
    if pattern == "validity-0":
        upd[(idx % 5 == 0) | (rng.random(B2) < 0.3), F + 1] = 0.0
    return (tab.to(dev), bias, torch.from_numpy(idx).to(dev),
            torch.from_numpy(upd).to(dev))


def check_update(torch, scatter, launch, tab, bias, idx, upd, eta, c, tag):
    """One kernel call against ``table_update_reference`` on copies of
    ``tab`` / ``bias``: touched rows within `UPDATE_ATOL`, every other row
    bit-equal. Returns ``(max |diff|, the kernel's tab, the kernel's
    bias)``."""
    N = tab.shape[0]
    want = scatter.table_update_reference(
        tab.clone(), None if bias is None else bias.clone(), idx, upd, eta, c)
    got = launch(tab.clone(), None if bias is None else bias.clone(), idx, upd,
                 eta, c)
    torch.cuda.synchronize()
    err = max(float((g - w).abs().max())
              for g, w in zip(got, want) if g is not None)
    check(err <= UPDATE_ATOL, f"{tag} differs by {err}")
    live = idx[(idx >= 0) & (idx < N)].long()
    untouched = torch.ones(N, dtype=torch.bool, device=tab.device)
    untouched[live] = False
    for g, t in zip(got, (tab, bias)):
        if g is not None:
            check(torch.equal(g[untouched], t[untouched]),
                  f"{tag} wrote an untouched row")
    if live.numel():
        check(float((got[0] - tab).abs().max()) > 0, f"{tag} moved nothing")
    return err, got[0], got[1]


def time_update(torch, launch, plain, tab, bias, idx, upd, eta, c):
    """Times of one wrapper on its own copies of the table: ``ms`` (CUDA
    events over 20 back-to-back calls), ``plain_ms`` (the same for the
    plain version), ``enqueue_us`` (host wall per call, no sync),
    ``device_ms`` (device time per call under ``torch.profiler``, 41
    calls), and per call what ran on the device: ``activities`` and
    ``by_kernel`` ``[(name, us, launches), ...]``."""
    tk, bk = tab.clone(), None if bias is None else bias.clone()

    def call():
        launch(tk, bk, idx, upd, eta, c)

    call()
    ms = cuda_ms(torch, call, 20)
    plain_ms = cuda_ms(torch, lambda: plain(tk, bk, idx, upd, eta, c), 20)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(UPDATE_PROFILE_CALLS):
        call()
    enqueue_us = 1e6 * (time.perf_counter() - t0) / UPDATE_PROFILE_CALLS
    _, busy, rows = profile_call(
        torch, lambda: [call() for _ in range(UPDATE_PROFILE_CALLS)],
        top=None)
    check(busy is not None, "torch.profiler traced no device time")
    n = UPDATE_PROFILE_CALLS
    return {"ms": ms, "plain_ms": plain_ms, "enqueue_us": enqueue_us,
            "device_ms": 1e3 * busy / n,
            "activities": sum(r[2] for r in rows) / n,
            "by_kernel": [(k, 1e3 * t / n, cnt / n) for k, t, cnt in rows]}


def update_phase(torch, scatter, dev, other_tree=False):
    """B3 and B2 against ``table_update_reference`` on the same inputs at
    every shape of `UPDATE_CASES`, then their times. Returns
    ``{kernel: record of its main-path shape}`` and ``{"case/kernel":
    times}``. For the kernels of another tree (``other_tree``) the
    roofline bound (`scatter.update_work`) and the check that B3 on one
    row is no slower than the plain version are left out."""
    rng = np.random.default_rng(SEED)
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    out = {"sorted": {"max_abs_err": 0.0}, "dense": {"max_abs_err": 0.0}}
    times = {}
    for name, N, F, B2, with_bias, pattern, kernels, main in UPDATE_CASES:
        tab, bias, idx, upd = update_inputs(torch, dev, rng, N, F, B2,
                                            with_bias, pattern)
        if pattern != "one-row" and not other_tree:
            check(scatter._regime(N, B2, F) == kernels[0],
                  f"{name}: regime {scatter._regime(N, B2, F)}")
        ok = (idx >= 0) & (idx < N)
        live = idx[ok].long()
        n_rows = int(torch.unique(live).numel())
        # the yardstick for the sum without the decay; not a library
        # version of the update, and the port never calls it on the card
        acc = torch.zeros((N, F + 2), dtype=torch.float32, device=dev)
        upd_ok = upd[ok]
        acc.index_add_(0, live, upd_ok)
        index_add_ms = cuda_ms(
            torch, lambda: acc.index_add_(0, live, upd_ok), 20)
        del acc, upd_ok
        # a second batch for the same table: other rows, the scratch of the
        # first call must have been left clean
        idx2 = torch.from_numpy(np.where(
            rng.random(B2) < 0.1, -1, rng.integers(0, N, B2)).astype(
                np.int32)).to(dev)
        upd2 = upd.flip(0).contiguous()
        upd2[:, F + 1] = (idx2 >= 0).to(torch.float32)
        for kernel in kernels:
            launch = getattr(scatter, f"table_update_{kernel}")
            tag = f"table_update_{kernel} ({name})"
            err, t1, b1 = check_update(torch, scatter, launch, tab, bias, idx,
                                       upd, eta, c, tag)
            err2, _, _ = check_update(torch, scatter, launch, t1, b1, idx2,
                                      upd2, eta, c, tag + ", second batch")
            del t1, b1
            if not other_tree:
                # the same call twice on copies of the table: equal bytes
                runs = [launch(tab.clone(),
                               None if bias is None else bias.clone(), idx,
                               upd, eta, c) for _ in range(2)]
                check(all(a is None or torch.equal(a, b)
                          for a, b in zip(*runs)),
                      f"{tag} gave other bytes on a second run")
                del runs
            err = max(err, err2)
            rec = out[kernel]
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
            tm = time_update(torch, launch, scatter.table_update_reference,
                             tab, bias, idx, upd, eta, c)
            tm["index_add_ms"] = index_add_ms
            check(other_tree or round(tm["activities"]) == 1,
                  f"{tag}: {tm['activities']} device launches per call, "
                  f"not one: {tm['by_kernel']}")
            times[f"{name}/{kernel}"] = tm
            line = (f"{tag}: {N} rows, F {F}, {B2} updates ({pattern}, "
                    f"{n_rows} rows touched): max |diff| {err:.3g} (two "
                    f"batches in a row{'' if other_tree else '; equal bytes on a second run'}), "
                    f"{tm['ms']:.4f} ms per call (device "
                    f"{tm['device_ms']:.4f} ms in {tm['activities']:.0f} "
                    f"launch(es), host enqueue {tm['enqueue_us']:.1f} us) vs "
                    f"plain {tm['plain_ms']:.4f} ms; index_add_ of the same "
                    f"updates alone {index_add_ms:.4f} ms")
            if not other_tree:
                ops, nbytes = scatter.update_work(
                    B2, F, int(live.numel()), n_rows, bias is not None)
                bound_ms, bound_by = bound(ops, nbytes)
                line += (f"; bound {bound_ms:.5f} ms ({bound_by}), "
                         f"{100 * bound_ms / tm['ms']:.1f}% reached")
                if main == kernel:
                    rec.update({k: tm[k] for k in UPDATE_TIME_KEYS},
                               bound_ms=bound_ms, bound_by=bound_by)
            print(line + f" ({CARD})", flush=True)
            print(f"  device activities per call, {tag}: " + "; ".join(
                f"{k[:48]} {us:.2f} us x {cnt:.0f}"
                for k, us, cnt in tm["by_kernel"]), flush=True)
        del tab, bias, idx, upd, idx2, upd2
    one = times["concentrated/sorted"]
    check(other_tree or one["ms"] <= one["plain_ms"],
          f"table_update_sorted on one row: {one['ms']} ms, slower than the "
          f"plain version's {one['plain_ms']} ms")
    web, items = times["web-scale items/sorted"], times["items/sorted"]
    print(f"table_update_sorted, 1,000,000 rows vs 33,362 rows (16,384 "
          f"updates each): {web['ms']:.4f} vs {items['ms']:.4f} ms per call, "
          f"device {web['device_ms']:.4f} vs {items['device_ms']:.4f} ms "
          f"({CARD})", flush=True)
    small = times["web-scale, 512 updates/dense"]
    small3 = times["web-scale, 512 updates/sorted"]
    print("1,000,000 rows x F 64, 512 updates: table_update_dense "
          f"{small['ms']:.4f} ms (device {small['device_ms']:.4f} ms, scratch "
          f"{scratch_bytes(scatter, 1_000_000, 64, 'dense', 512, other_tree)} "
          f"bytes) vs table_update_sorted {small3['ms']:.4f} ms (device "
          f"{small3['device_ms']:.4f} ms, scratch "
          f"{scratch_bytes(scatter, 1_000_000, 64, 'sorted', 512, other_tree)}"
          f" bytes) ({CARD})", flush=True)
    if not other_tree:
        sweep_rows(torch, scatter, dev, rng, eta, c)
    return out, times


def scratch_bytes(scatter, N, F, kind, B2, other_tree=False):
    """Bytes of the persistent scratch of kernel ``kind`` (another tree's
    `scatter.scratch_sizes` takes no update count)."""
    sizes = (scatter.scratch_sizes(N, F, kind) if other_tree
             else scatter.scratch_sizes(N, F, kind, B2))
    return 4 * sum(sizes.values())


def sweep_rows(torch, scatter, dev, rng, eta, c):
    """Both kernels with 512 updates on F 64 tables of `SWEEP_ROWS` rows:
    ``ms`` per call (CUDA events over 50 back-to-back calls) beside the
    bytes of B2's accumulator."""
    for N in SWEEP_ROWS:
        tab, bias, idx, upd = update_inputs(torch, dev, rng, N, 64, 512, True,
                                            "uniform")
        ms = {}
        for kernel in ("dense", "sorted"):
            launch = getattr(scatter, f"table_update_{kernel}")
            launch(tab, bias, idx, upd, eta, c)
            ms[kernel] = cuda_ms(
                torch, lambda: launch(tab, bias, idx, upd, eta, c), 50)
        print(f"512 updates, {N} rows x F 64: table_update_dense "
              f"{ms['dense']:.4f} ms (accumulator "
              f"{scratch_bytes(scatter, N, 64, 'dense', 512)} bytes) vs "
              f"table_update_sorted {ms['sorted']:.4f} ms ({CARD})",
              flush=True)


def launches_by_nw(fused):
    """B1's launches by windows a chunk, the last field of its keys (a
    tree whose keys end in the feature flags counts none)."""
    out = {}
    for k, n in fused.LAUNCHES.items():
        if len(k) > 4:
            out[k[4]] = out.get(k[4], 0) + n
    return out


def launches_by_layout(fused):
    """B1's launches by (chunk rows, user block rows, user features, item
    features), the first four fields of its keys."""
    out = {}
    for k, n in fused.LAUNCHES.items():
        out[k[:4]] = out.get(k[:4], 0) + n
    return out


def launches_of(fused, scatter):
    """Launch counts by kernel; B1's keys hold its two feature flags at 2
    and 3. ``fused_chunk_wide``: B1's launches (with or without features)
    at `WIDE_NW` windows a chunk or more."""
    return {"fused_chunk": sum(n for k, n in fused.LAUNCHES.items()
                               if not (k[2] or k[3])),
            "fused_chunk_features": sum(n for k, n in fused.LAUNCHES.items()
                                        if k[2] or k[3]),
            "table_update_sorted": scatter.LAUNCHES["sorted"],
            "table_update_dense": scatter.LAUNCHES["dense"],
            "fused_chunk_wide": sum(n for nw, n in launches_by_nw(fused).items()
                                    if nw >= WIDE_NW)}


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
    launches = launches_by_layout(fused)
    counts = launches_of(fused, scatter)
    plan = model.last_fit_plan_
    check(plan.fused and plan.chunk_tail == 1, f"plan {plan}")
    main_key = (plan.chunk, fused.user_block(N_USERS, plan.user_block),
                False, False)
    tail_key = (plan.tail_chunk,
                fused.user_block(N_USERS, plan.tail_user_block), False, False)
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
    ref = {"hr": hr, "dcg": evaluation.discounted_cumulative_gain(
        model, test, k=10)}
    tm = time_engine_epochs(torch, model, fused, None, "ML-1M",
                            candidate=False)
    ref["fused"] = tm["fused"]
    print("ML-1M fused epochs (main layout), device synced: "
          f"{', '.join(f'{x:.3f}' for x in tm['fused'])} s ({CARD})",
          flush=True)
    print(f"ML-1M serving: recommend 1000 users {rec_s:.3f} s, predict "
          f"{len(test)} pairs {pred_s:.3f} s, hit_rate@10 {hr:.4f} "
          f"(untrained {hr0:.4f}) in {hr_s:.3f} s; dcg@10 {ref['dcg']:.4f}",
          flush=True)
    return counts, ref


def ml1m_layouts_path(torch, RankFM, fused, scatter, train, r1_epochs):
    """The ML-1M fit of phase 5 with ``shuffle_layouts=4`` for 6 epochs:
    every epoch through B1 at the main layout, 4 layouts built (one per
    layout), no sort inside an epoch; then two synced epochs on one
    pre-shuffled layout beside ``r1_epochs``, phase 5's sorting epochs."""
    calls = {"layouts": 0, "sorts": 0}
    layout_generator, shuffle_keys = fused.layout_generator, fused.shuffle_keys

    def spy_layout(seed, r):
        calls["layouts"] += 1
        return layout_generator(seed, r)

    def spy_keys(*a):
        calls["sorts"] += 1
        return shuffle_keys(*a)

    reset_launches(torch, fused, scatter)
    fused.layout_generator, fused.shuffle_keys = spy_layout, spy_keys
    try:
        model, fit_s = timed(torch, lambda: RankFM(
            factors=20, loss="warp", max_samples=20,
            learning_schedule="invscaling", shuffle_layouts=4,
            device="cuda").fit(train, epochs=6))
    finally:
        fused.layout_generator, fused.shuffle_keys = layout_generator, \
            shuffle_keys
    counts = launches_of(fused, scatter)
    plan = model.last_fit_plan_
    check(plan.fused and plan.shuffle_layouts == 4 and plan.chunk_tail == 0
          and plan.n_main == 6, f"R = 4 plan {plan}")
    check(calls == {"layouts": 4, "sorts": 0},
          f"R = 4: {calls['layouts']} layouts built, {calls['sorts']} sorts "
          f"inside the epochs")
    check(counts["fused_chunk"] > 0 and counts["table_update_sorted"] == 0
          and counts["table_update_dense"] == 0, f"R = 4 launches {counts}")
    lls = check_lls(model, 6, "ML-1M R = 4")
    tm = time_engine_epochs(torch, model, fused, None, "ML-1M R = 4",
                            candidate=False, pre_shuffled=True)
    print(f"ML-1M shuffle_layouts=4: fit {fit_s:.2f} s for 6 epochs, 4 "
          f"layouts built, no sort inside an epoch; lls "
          f"{[round(x, 1) for x in lls]}; fused epoch, device synced: "
          f"pre-shuffled {', '.join(f'{x:.3f}' for x in tm['fused'])} s vs "
          f"sorting (R = 1) {', '.join(f'{x:.3f}' for x in r1_epochs)} s; "
          f"launches {counts} ({CARD})", flush=True)
    return counts


def profile_call(torch, run, top=4, margin=PROFILE_MARGIN_S):
    """``(wall seconds, device-busy seconds, [(name, ms, count), ...])`` of
    one ``run()`` ending in a device sync, traced with ``torch.profiler``:
    the ``top`` device activities (kernels, memsets, copies) by device time,
    all of them with ``top=None``. Busy seconds are the union of the device
    activities' intervals (`busy_union`), so work on concurrent streams (an
    NCCL kernel beside a compute kernel) counts once; None when the trace
    holds no device time.

    The tracer drops every device record whose timestamp lies outside the
    window between its start and its stop, and the device's clock can lag
    the host's by more than the time to the first launch: a short run
    launched right at the start now and then loses all its records. So
    ``margin`` seconds are left idle at both ends of the window
    (`profiler_windows` counts the empty traces with and without)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin)
        t0 = time.time()
        run()
        torch.cuda.synchronize()
        wall = time.time() - t0
        time.sleep(margin)
    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        us = getattr(e, "self_device_time_total", None)
        if us is None:
            us = e.self_cuda_time_total
        rows.append((e.key, us / 1e3, e.count))
    rows.sort(key=lambda r: -r[1])
    busy = busy_union(
        (e.time_range.start, e.time_range.end) for e in prof.events()
        if e.device_type == DeviceType.CUDA) / 1e6
    return wall, (busy if busy > 0 else None), rows[:top]


def busy_union(spans):
    """The length of the union of the ``(start, end)`` intervals."""
    total, cur = 0.0, None
    for a, b in sorted(spans):
        if cur is not None and a <= cur[1]:
            cur[1] = max(cur[1], b)
            continue
        if cur is not None:
            total += cur[1] - cur[0]
        cur = [a, b]
    return total + (cur[1] - cur[0] if cur is not None else 0.0)


def profiler_windows(torch, scatter, dev, n):
    """``--profiler-windows N``: ``N`` windows of `UPDATE_PROFILE_CALLS`
    8-update calls of B3 (2-3 ms each) with no idle margin and ``N`` with
    `PROFILE_MARGIN_S`, in turns: how many traces hold no device time.
    Fails if one does with the margin."""
    rng = np.random.default_rng(SEED)
    eta, c = 0.1, scatter.decay_c(0.1, 0.01)
    tab, bias, idx, upd = update_inputs(torch, dev, rng, IC_ITEMS, 50, 8, True,
                                        "uniform")

    def run():
        for _ in range(UPDATE_PROFILE_CALLS):
            scatter.table_update_sorted(tab, bias, idx, upd, eta, c)

    run()
    empty = {0.0: 0, PROFILE_MARGIN_S: 0}
    for k in range(2 * n):
        margin = PROFILE_MARGIN_S if k % 2 else 0.0
        empty[margin] += profile_call(torch, run, margin=margin)[1] is None
    print(f"torch.profiler, {n} windows of {UPDATE_PROFILE_CALLS} B3 calls "
          f"each way: {empty[0.0]} traces without device time with no "
          f"margin, {empty[PROFILE_MARGIN_S]} with {PROFILE_MARGIN_S} s idle "
          f"at both ends ({CARD})", flush=True)
    check(empty[PROFILE_MARGIN_S] == 0,
          "torch.profiler traced no device time inside the margin")


def time_engine_epochs(torch, model, fused, training, tag, candidate=True,
                       n_windows=None, pre_shuffled=False):
    """CUDA-synced wall time of two more fused epochs and (``candidate``)
    two more candidate epochs on the fitted model's tables, at the fit's
    plan (with the model's side features, if it has any); then one more
    fused epoch under ``torch.profiler`` for the device's busy share. The
    fused epochs run at ``n_windows`` windows a chunk (default: the plan's
    main epochs'), and with ``pre_shuffled`` on one layout shuffled before
    the clock starts (`fused.make_shuffle_fn`), so that they do not sort."""
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
    if pre_shuffled:
        shuffle = fused.make_shuffle_fn(U, I, ub=plan.user_block)
        layout = (shuffle(layout[0], layout[1], fused.shuffle_bits(
            fused.layout_generator(model.seed, 0), rec.shape[0])),) + \
            layout[1:]
    if n_windows is None:
        n_windows = plan.n_windows
    extra = {"pre_shuffled": True} if pre_shuffled else {}
    w = model._w
    U_pad = fused.user_pad(U, plan.user_block)
    tab_u, tab_i = fused.extend_tables(
        w["w_i"], w["v_u"], w["v_i"], U_pad, fused.item_pad(I))
    has_uf, has_if = bool(model.x_uf.any()), bool(model.x_if.any())
    feats = {}
    if has_uf or has_if:
        tuf, tif = fused.extend_feature_tables(w["v_uf"], w["w_if"],
                                               w["v_if"])
        if has_uf:
            feats.update(x_uf=fused.pad_feature_cols(model._x_uf_dev, U_pad),
                         tab_uf=tuf)
        if has_if:
            feats.update(x_if=fused.pad_feature_cols(model._x_if_dev,
                                                     fused.item_pad(I)),
                         tab_if=tif)
    packed = model._ensure_packed_hist()
    out = {}

    def fused_epoch(epoch):
        fused.fused_epoch(tab_u, tab_i, packed, layout, 0.05, model.alpha,
                          model.seed, epoch, num_users=U, num_items=I,
                          factors=F, max_samples=plan.max_samples,
                          batch_size=plan.batch_size, chunk=plan.chunk,
                          ub=plan.user_block, n_windows=n_windows,
                          beta=model.beta, **feats, **extra)

    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        fused_epoch(100 + rep)
        torch.cuda.synchronize()
        out.setdefault("fused", []).append(time.time() - t0)
    wall, busy, top = profile_call(torch, lambda: fused_epoch(102))
    nb, nT = cids.shape
    print(f"{tag} fused epoch under torch.profiler: {nb} batches of {nT} "
          f"chunks (chunk {plan.chunk}), wall {1e3 * wall:.1f} ms, device "
          + ("time not traced" if busy is None else
             f"busy {1e3 * busy:.1f} ms ({100 * busy / wall:.0f}%)")
          + "; top: " + "; ".join(f"{k[:60]} {ms:.2f} ms" for k, ms, _ in top)
          + f" ({CARD})", flush=True)
    if candidate:
        out["candidate"], out["candidate_batches"] = time_xla_epochs(
            torch, model, training, "candidate")
    return out


def time_xla_epochs(torch, model, training, kind):
    """``([seconds, seconds], batches)``: CUDA-synced wall time of two more
    epochs of the candidate or the window step (``kind``) on copies of the
    fitted model's tables, at the fit's plan."""
    plan = model.last_fit_plan_
    I, dev = len(model.item_idx), model.device
    has_uf, has_if = bool(model.x_uf.any()), bool(model.x_if.any())
    n = len(model.interactions)
    nb = -(-n // plan.xla_batch)
    n_pad = nb * plan.xla_batch
    cols = [torch.zeros(n_pad, dtype=dt, device=dev)
            for dt in (torch.int64, torch.int64, torch.float32)]
    cols[0][:n] = torch.from_numpy(model.interactions[:, 0].astype(np.int64))
    cols[1][:n] = torch.from_numpy(model.interactions[:, 1].astype(np.int64))
    cols[2][:n] = torch.from_numpy(model.sample_weight)
    if kind == "candidate":
        step = training.make_train_step(
            I, plan.max_samples, has_uf, has_if, sample_rounds=plan.rounds,
            sampler=model._sampler, post_reject=plan.post_reject,
            max_row_len=int(np.diff(model._ui_offsets).max()))
        hist = {"offsets": model._offsets_dev, "flat": model._flat_items_dev,
                "bitmap": model._ensure_bitmap()}
    else:
        step = training.make_window_train_step(I, plan.max_samples, has_uf,
                                               has_if)
        hist = model._ensure_packed_hist()
    body = training.epoch_body(step, plan.xla_batch)
    wc = {k: v.clone() for k, v in model._w.items()}
    seconds = []
    for rep in range(2):
        torch.cuda.synchronize()
        t0 = time.time()
        wc, ll = body(wc, model._x_uf_dev, model._x_if_dev, hist, *cols, n,
                      0.05, model.alpha, model.beta, model.seed, 100 + rep)
        torch.cuda.synchronize()
        seconds.append(time.time() - t0)
        check(np.isfinite(float(ll)), f"timed {kind} epoch ll")
    return seconds, nb


def instacart_data():
    """``(train, test, sw, x_uf, x_if)``: 68% of the Instacart-shaped log
    with log2(orders + 1) weights, and the users' / products' one-hot
    department features (all 10,000 users, all 33,362 products)."""
    rng = np.random.default_rng(SEED)
    t0 = time.time()
    pairs, n_orders, depts = make_instacart(rng)
    mask = rng.random(len(pairs)) < 0.68
    train, test = pairs[mask], pairs[~mask]
    sw = np.log2(n_orders[mask] + 1).astype(np.float32)
    print(f"Instacart data: {len(pairs)} rows ({len(train)} train), "
          f"{len(np.unique(pairs[:, 1]))} products, {time.time() - t0:.2f} s",
          flush=True)
    return (train, test, sw, one_hot(depts["user"], IC_DEPTS),
            one_hot(depts["item"], IC_DEPTS))


def instacart_path(torch, RankFM, evaluation, fused, scatter, training, data,
                   features=False, tail_windows=None):
    """The mixed schedule at the Instacart shape, then serving; with
    ``features``, the same fit with the user and item department features
    through featured B1 and the featured candidate epoch; with
    ``tail_windows``, the closing epoch is the wide-window fused tail (B1
    at that window count, no table update). Returns the launch counts and
    ``{"fused": [s, s], "candidate" or "tail": [s, s], "hr": hit rate}``."""
    train, test, sw, x_uf, x_if = data
    tag = ("featured Instacart" if features else "Instacart"
           + (" wide tail" if tail_windows else ""))
    fkw = {}
    if features:
        fkw = dict(user_features=feature_frame(x_uf, np.unique(train[:, 0]),
                                               "user"),
                   item_features=feature_frame(x_if, np.unique(train[:, 1]),
                                               "item"))
    cfg = dict(factors=50, loss="warp", max_samples=50, alpha=0.01,
               beta=0.1, learning_rate=0.1, learning_schedule="invscaling",
               device="cuda")
    if tail_windows:
        cfg["tail_windows"] = tail_windows
    reset_launches(torch, fused, scatter)
    t0 = time.time()
    model = RankFM(**cfg).fit(train, sample_weight=sw, epochs=6, **fkw)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    counts = launches_of(fused, scatter)
    by_nw = launches_by_nw(fused)
    plan = model.last_fit_plan_
    check(plan.fused and plan.n_main == 5 and plan.n_tail == 1
          and plan.step_kind == "candidate"
          and plan.tail_windows == tail_windows, f"{tag} plan {plan}")
    b1, other = (("fused_chunk_features", "fused_chunk") if features
                 else ("fused_chunk", "fused_chunk_features"))
    check(counts[b1] > 0 and counts[other] == 0,
          f"{tag}: {b1} did not launch alone: {counts}")
    if tail_windows:
        # 5 main epochs at 4 windows, the tail epoch at tail_windows
        nb = counts[b1] // 6
        check(by_nw == {4: 5 * nb, tail_windows: nb},
              f"{tag}: B1 launches by window count {by_nw}")
        check(counts["table_update_sorted"] == 0
              and counts["table_update_dense"] == 0,
              f"the wide tail launched a table update: {counts}")
    else:
        check(counts["table_update_sorted"] > 0
              and counts["table_update_dense"] > 0,
              f"the candidate epoch did not launch both table updates: "
              f"{counts}")
    lls = check_lls(model, 6, tag)
    base = RankFM(**cfg)
    base._init_all(train, sample_weight=sw, **fkw)
    base.is_fit = True
    for k, v in model._weights.items():
        check(np.isfinite(v).all(), f"{tag}: {k} is not finite")
    if features:
        for k in ("v_uf", "w_if", "v_if"):
            moved = float(np.abs(model._weights[k] - base._weights[k]).max())
            check(moved > 0, f"{tag}: {k} did not move")
    print(f"{tag} fit: {fit_s:.2f} s for 6 epochs of "
          f"{len(model.interactions)} rows ({len(model.user_idx)} users x "
          f"{len(model.item_idx)} items); plan {plan.nblk} blocks, batch "
          f"{plan.batch_size}, chunk {plan.chunk} @ ub {plan.user_block}, "
          f"{plan.n_main} fused + {plan.n_tail} "
          + (f"wide-tail fused epoch(s) at {tail_windows} windows"
             if tail_windows else
             f"candidate epoch(s) at batch {plan.xla_batch} (post_reject "
             f"{plan.post_reject}, rounds {plan.rounds})")
          + f"; lls {[round(x, 1) for x in lls]}; launches {counts}, B1 by "
          f"windows a chunk {by_nw}", flush=True)

    users = np.unique(test[:, 0])[:1000]
    t0 = time.time()
    recs = model.recommend(users, n_items=10, filter_previous=True)
    rec_s = time.time() - t0
    check(recs.shape == (len(users), 10) and not recs.isna().any().any(),
          f"{tag} recommend {recs.shape}")
    t0 = time.time()
    hr = evaluation.hit_rate(model, test, k=10)
    hr_s = time.time() - t0
    hr0 = evaluation.hit_rate(base, test, k=10)
    check(hr > hr0, f"{tag} hit rate {hr} does not beat the untrained "
                    f"model's {hr0}")
    print(f"{tag} serving: recommend 1000 users {rec_s:.3f} s, "
          f"hit_rate@10 {hr:.4f} (untrained {hr0:.4f}) in {hr_s:.3f} s",
          flush=True)

    if tail_windows:
        tm = time_engine_epochs(torch, model, fused, training, tag,
                                candidate=False)
        tm["tail"] = time_engine_epochs(torch, model, fused, training,
                                        tag + f" ({tail_windows} windows)",
                                        candidate=False,
                                        n_windows=tail_windows)["fused"]
        print(f"{tag} epochs, device synced: fused "
              f"{', '.join(f'{x:.3f}' for x in tm['fused'])} s; wide tail "
              f"({tail_windows} windows) "
              f"{', '.join(f'{x:.3f}' for x in tm['tail'])} s ({CARD})",
              flush=True)
    else:
        tm = time_engine_epochs(torch, model, fused, training, tag)
        print(f"{tag} epochs, device synced: fused "
              f"{', '.join(f'{x:.3f}' for x in tm['fused'])} s; candidate "
              f"{', '.join(f'{x:.3f}' for x in tm['candidate'])} s "
              f"({tm['candidate_batches']} batches; {CARD})", flush=True)
    tm["hr"] = hr
    return counts, tm


def ml1m_features_path(torch, RankFM, fused, scatter, train, x_uf, x_if):
    """A featured ML-1M fit of 3 epochs: 2 at the main layout, 1 at the
    chunk-tail layout (user features re-padded), all through featured B1."""
    fkw = dict(user_features=feature_frame(x_uf, np.unique(train[:, 0]),
                                           "user"),
               item_features=feature_frame(x_if, np.unique(train[:, 1]),
                                           "item"))
    reset_launches(torch, fused, scatter)
    t0 = time.time()
    model = RankFM(factors=20, loss="warp", max_samples=20, beta=0.1,
                   learning_schedule="invscaling", device="cuda").fit(
        train, epochs=3, **fkw)
    torch.cuda.synchronize()
    fit_s = time.time() - t0
    launches = launches_by_layout(fused)
    counts = launches_of(fused, scatter)
    plan = model.last_fit_plan_
    check(plan.fused and plan.n_main == 3 and plan.chunk_tail == 1,
          f"featured ML-1M plan {plan}")
    main_key = (plan.chunk, fused.user_block(N_USERS, plan.user_block),
                True, True)
    tail_key = (plan.tail_chunk,
                fused.user_block(N_USERS, plan.tail_user_block), True, True)
    check(launches.get(main_key, 0) > 0 and launches.get(tail_key, 0) > 0
          and counts["fused_chunk"] == 0,
          f"featured ML-1M launches by layout {launches}")
    lls = check_lls(model, 3, "featured ML-1M")
    for k, v in model._weights.items():
        check(np.isfinite(v).all(), f"featured ML-1M: {k} is not finite")
    tm = time_engine_epochs(torch, model, fused, None, "featured ML-1M",
                            candidate=False)
    print("featured ML-1M fused epochs (main layout), device synced: "
          f"{', '.join(f'{x:.3f}' for x in tm['fused'])} s ({CARD})",
          flush=True)
    print(f"featured ML-1M fit: {fit_s:.2f} s for 3 epochs (plan chunk "
          f"{plan.chunk} @ ub {plan.user_block}, tail chunk {plan.tail_chunk}"
          f" @ ub {plan.tail_user_block}); lls "
          f"{[round(x, 1) for x in lls]}; launches {launches}", flush=True)
    return counts


def window_path(torch, RankFM, fused, scatter, training, train):
    """The window step on the ML-1M log: both tables through B2. Returns
    the launch counts and two more epochs' synced times."""
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
    seconds, nb = time_xla_epochs(torch, model, training, "window")
    print("window-step epochs, device synced: "
          f"{', '.join(f'{x:.3f}' for x in seconds)} s ({nb} batches; "
          f"{CARD})", flush=True)
    return counts, seconds


def timed(torch, fn):
    """``(result, seconds)`` of ``fn()``, the device synced before and
    after."""
    torch.cuda.synchronize()
    t0 = time.time()
    out = fn()
    torch.cuda.synchronize()
    return out, time.time() - t0


def same_arrays(a, b):
    """Equal values, dtype and (for pandas objects) index."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same_arrays(x, y) for x, y in zip(a, b))
    if isinstance(a, pd.Series):
        return isinstance(b, pd.Series) and a.dtype == b.dtype and a.equals(b)
    return a.dtype == b.dtype and np.array_equal(a, b)


def ingest_paths(native, tdata, raw):
    """`map_interactions` and `build_user_items_csr` on the frame ``raw``
    through the native library and, with the library taken away, through
    numpy / pandas; and `build_index` (numpy's sort, the port's only path)
    beside the index made from the library's `unique_sorted` as the JAX
    package makes it: equal arrays, the seconds of each."""
    _, u2i = tdata.build_index(raw["user_id"].values)
    _, i2i = tdata.build_index(raw["item_id"].values)
    pairs, _ = tdata.map_interactions(raw, u2i, i2i)

    def native_index(col):
        ids = pd.Series(native.unique_sorted(col).astype(col.dtype,
                                                         copy=False))
        return ids, pd.Series(data=ids.index, index=ids.values)

    def without_native(fn):
        real, native.get_lib = native.get_lib, lambda: None
        try:
            return fn()
        finally:
            native.get_lib = real

    calls = (
        ("build_index (native: unique_sorted, not the port's path)",
         lambda: native_index(raw["user_id"].values)
         + native_index(raw["item_id"].values),
         lambda: tdata.build_index(raw["user_id"].values)
         + tdata.build_index(raw["item_id"].values)),
        ("map_interactions", lambda: tdata.map_interactions(raw, u2i, i2i),
         None),
        ("build_user_items_csr",
         lambda: tdata.build_user_items_csr(pairs, len(u2i)), None))
    for name, fn, plain in calls:
        t0 = time.time()
        with_native = fn()
        t_native = time.time() - t0
        t0 = time.time()
        without = plain() if plain else without_native(fn)
        t_numpy = time.time() - t0
        check(same_arrays(with_native, without),
              f"{name}: the native and the numpy path disagree")
        print(f"{name}, {len(raw)} rows: native {t_native:.4f} s, numpy / "
              f"pandas {t_numpy:.4f} s, equal arrays ({CARD})", flush=True)


def host_half_path(torch, RankFM, evaluation, fused, scatter, train, test,
                   ic_data):
    """Phase 10: ingest, resume, checkpoint, baseline, observe. Returns the
    launch counts of its fits."""
    from rankfm_tpu_torch import native
    from rankfm_tpu_torch.baselines import ImplicitALS
    from rankfm_tpu_torch.utils import data as tdata
    from rankfm_tpu_torch.utils import observe

    check(native.get_lib() is not None,
          f"the native ingest library did not build: {native.build_error}")
    # raw ids offset and shuffled, so that the id mapping does work
    rng = np.random.default_rng(SEED + 10)
    user_ids = 10_000_000 + 7 * rng.permutation(N_USERS)
    item_ids = 500_000 + 3 * rng.permutation(N_ITEMS)
    raw = pd.DataFrame({"user_id": user_ids[train[:, 0]],
                        "item_id": item_ids[train[:, 1]]})
    raw_test = np.stack([user_ids[test[:, 0]], item_ids[test[:, 1]]], 1)
    ingest_paths(native, tdata, raw)

    # fit, then fit_partial on the same frame and on another one
    cfg = dict(factors=20, loss="warp", max_samples=20,
               learning_schedule="invscaling", device="cuda")
    reset_launches(torch, fused, scatter)
    model, wall_fit = timed(torch, lambda: RankFM(**cfg).fit(raw, epochs=2))
    tm_fit = dict(model.last_fit_timing_)
    plan = model.last_fit_plan_
    check(plan.fused and plan.chunk_tail == 1, f"phase 10 plan {plan}")
    check(tuple(tm_fit) == FIT_TIMING_KEYS, f"last_fit_timing_ {tm_fit}")
    check(model._ingest_hash is not None and len(model._rec_cache) == 2,
          "the fit cached no record layouts")
    packed, cached = model._packed_hist, dict(model._rec_cache)
    offsets_dev = model._offsets_dev
    _, wall_again = timed(torch, lambda: model.fit_partial(raw, epochs=2))
    tm_again = dict(model.last_fit_timing_)
    check(model._packed_hist is packed and model._offsets_dev is offsets_dev,
          "fit_partial on the same frame rebuilt the history")
    check(len(model._rec_cache) == 2 and all(
        model._rec_cache.get(k) is v for k, v in cached.items()),
          "fit_partial on the same frame rebuilt a record layout")
    check(tuple(tm_again) == FIT_TIMING_KEYS, f"last_fit_timing_ {tm_again}")
    print(f"fit(epochs=2), {len(raw)} rows: wall {wall_fit:.3f} s, "
          f"last_fit_timing_ {tm_fit}; fit_partial on the same frame (ingest "
          f"short cut, history pack and both record layouts reused): wall "
          f"{wall_again:.3f} s, last_fit_timing_ {tm_again} ({CARD})",
          flush=True)
    other = raw.iloc[rng.permutation(len(raw))[:len(raw) * 9 // 10]]
    _, wall_other = timed(torch, lambda: model.fit_partial(other, epochs=2))
    check(model._packed_hist is not packed and len(model._rec_cache) == 2
          and not set(cached) & set(model._rec_cache),
          "fit_partial on another frame reused the caches")
    print(f"fit_partial on another frame ({len(other)} rows; all rebuilt): "
          f"wall {wall_other:.3f} s, last_fit_timing_ "
          f"{model.last_fit_timing_} ({CARD})", flush=True)
    check_lls(model, 6, "phase 10")

    # save -> load on the card
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_"))
    try:
        _, save_s = timed(torch, lambda: model.save(str(tmp / "model")))
        loaded, load_s = timed(
            torch, lambda: RankFM.load(str(tmp / "model"), device="cuda"))
        size = (tmp / "model.npz").stat().st_size
        check(loaded.device.type == "cuda" and loaded._w["v_u"].is_cuda
              and loaded._epoch_offset == 6, "load did not restore the model")
        users = np.unique(raw_test[:, 0])[:1000]
        recs = model.recommend(users, n_items=10, filter_previous=True)
        check(recs.shape == (1000, 10) and not recs.isna().any().any()
              and recs.equals(loaded.recommend(users, n_items=10,
                                               filter_previous=True)),
              "the loaded model recommends other lists")
        scores = model.predict(raw_test)
        check(np.isfinite(scores).all()
              and np.array_equal(scores, loaded.predict(raw_test)),
              "the loaded model predicts other scores")
        # the same fit_partial on both, and on a copy whose epoch stream
        # starts over
        replay = RankFM.load(str(tmp / "model"), device="cuda")
        replay._epoch_offset = 0
        for m in (model, loaded, replay):
            m.fit_partial(raw, epochs=1)
        torch.cuda.synchronize()
        w, wl, wr = model._weights, loaded._weights, replay._weights
        err = max(float(np.abs(wl[k] - w[k]).max() / np.abs(w[k]).max())
                  for k in ("w_i", "v_u", "v_i"))
        err_replay = max(float(np.abs(wr[k] - w[k]).max() / np.abs(w[k]).max())
                         for k in ("w_i", "v_u", "v_i"))
        check(all(np.array_equal(wl[k], w[k]) for k in w),
              f"fit_partial after load differs from the model never saved "
              f"(max relative diff {err})")
        check(err_replay > REPLAY_MIN, "fit_partial does not depend on "
              f"the epoch offset ({err_replay})")
        print(f"checkpoint: save {save_s:.3f} s, load {load_s:.3f} s, {size} "
              f"bytes; equal recommend (1000 users) and predict "
              f"({len(raw_test)} pairs); fit_partial after load equals the "
              f"model never saved, bit for bit (with the epoch stream started "
              f"over: max relative diff {err_replay:.2e}) ({CARD})",
              flush=True)

        # observe: one traced epoch, then the allocator's peak
        with observe.trace(tmp / "trace"):
            model.fit_partial(raw, epochs=1)
        traces = list((tmp / "trace").glob("trace_*.json"))
        check(len(traces) == 1 and traces[0].stat().st_size > 0,
              f"observe.trace wrote {traces}")
        trace_bytes = traces[0].stat().st_size
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    counts = launches_of(fused, scatter)
    check(counts["fused_chunk"] > 0, f"phase 10 launches {counts}")

    # ImplicitALS on the Instacart-shaped log, and card vs CPU
    ic_train, ic_test = ic_data[0], ic_data[1]
    kw = dict(factors=50, device="cuda")
    base, setup_s = timed(torch, lambda: ImplicitALS(**kw).fit(ic_train,
                                                               epochs=0))
    als, fit_s = timed(torch, lambda: ImplicitALS(**kw).fit(ic_train,
                                                            epochs=3))
    check(np.isfinite(als.user_factors).all()
          and np.isfinite(als.item_factors).all(), "ALS factors not finite")
    hr, hr_s = timed(torch, lambda: evaluation.hit_rate(
        als, ic_test, k=10, filter_previous=True))
    hr0 = evaluation.hit_rate(base, ic_test, k=10, filter_previous=True)
    check(hr > hr0, f"ALS hit rate {hr} does not beat the untrained {hr0}")
    rng = np.random.default_rng(SEED + 11)
    small = np.stack([np.repeat(np.arange(600), 25),
                      rng.integers(0, 2500, 600 * 25)], 1)
    card = ImplicitALS(**kw).fit(small, epochs=3)
    cpu = ImplicitALS(factors=50, device="cpu").fit(small, epochs=3)
    als_err = max(float(np.abs(a - b).max() / np.abs(b).max()) for a, b in (
        (card.user_factors, cpu.user_factors),
        (card.item_factors, cpu.item_factors)))
    check(als_err <= ALS_RTOL, f"ALS card vs CPU differ by {als_err}")
    print(f"ImplicitALS(factors=50), {len(ic_train)} rows, "
          f"{len(als.user_id)} x {len(als.item_id)}: set-up {setup_s:.3f} s, "
          f"{(fit_s - setup_s) / 3:.3f} s per sweep (3 sweeps), hit_rate@10 "
          f"{hr:.4f} (untrained {hr0:.4f}) in {hr_s:.3f} s; 600 x 2500 card "
          f"vs CPU: max relative diff {als_err:.2e} (limit {ALS_RTOL}) "
          f"({CARD})", flush=True)
    stats = observe.device_memory_stats()
    check(stats.get("allocated_bytes.all.peak", 0) > 0,
          "device_memory_stats has no peak")
    print(f"observe: peak allocated {stats['allocated_bytes.all.peak']} "
          f"bytes (reserved {stats['reserved_bytes.all.peak']}); trace of "
          f"one epoch {trace_bytes} bytes ({CARD})", flush=True)
    return counts


# ---------------------------------------------------------------------------
# 11. the mesh (rankfm_tpu_torch.parallel)
# ---------------------------------------------------------------------------

def table_digest(weights):
    """sha256 of the weight arrays, in key order."""
    h = hashlib.sha256()
    for k in sorted(weights):
        h.update(np.ascontiguousarray(weights[k]).tobytes())
    return h.hexdigest()


def webscale_data():
    """The web-scale table shape (``examples/webscale_smoke.py:18``):
    100,000 users x 1,000,000 items, every item once (the catalog is built
    from the interactions, so the 1M-item table needs 1M rows: the 5M rows
    of the example cut to 1M), users uniform."""
    rng = np.random.default_rng(3)
    items = rng.permutation(WEB_ITEMS)
    users = rng.integers(0, WEB_USERS, WEB_ITEMS)
    return np.stack([users, items], 1).astype(np.int64)


def mesh_fit(torch, mesh, fused, scatter, fit):
    """``(model, record)`` of ``fit()`` on this rank, the launch counts and
    the collective trace set to 0 just before it and read just after."""
    reset_launches(torch, fused, scatter)
    mesh.trace = []
    model, fit_s = timed(torch, fit)
    rec = {"fit_s": fit_s, "counts": launches_of(fused, scatter),
           "collectives": collective_record(mesh),
           "lls": [r["log_likelihood"] for r in model.training_log_],
           "epoch_s": [r["seconds"] for r in model.training_log_],
           "plan": dataclasses.asdict(model.last_fit_plan_),
           "digest": table_digest(model._weights)}
    return model, rec


def collective_record(mesh):
    """The traced collectives as ``{"tag/axis": {calls, bytes, ms}}``; the
    trace is switched off."""
    out = {f"{tag}/{axis}": {"calls": n, "bytes": b, "ms": ms}
           for (tag, axis), (n, b, ms) in mesh.collective_stats().items()}
    mesh.trace = None
    return out


def mesh_rank(rank, world, work, devices, backend, card):
    """One rank of the mesh phase (spawned): runs 1-5, its record written
    to ``work/rank<rank>.json``."""
    import torch
    import torch.distributed as dist

    global CARD
    CARD = card
    sys.path.insert(0, str(ROOT))
    torch.backends.cuda.matmul.allow_tf32 = False
    from rankfm_tpu_torch import RankFM, evaluation
    from rankfm_tpu_torch.ops import fused, scatter
    from rankfm_tpu_torch.parallel import init_distributed, make_mesh

    init_distributed(init_method=f"file://{work}/rendezvous",
                     world_size=world, rank=rank, backend=backend)
    mesh = make_mesh(data=world, device=devices[rank], backend=backend)
    out = {"device": str(mesh.device), "backend": backend}
    rng = np.random.default_rng(SEED)
    data = make_synthetic(rng)
    mask = rng.random(len(data)) < 0.8
    train, test = data[mask], data[~mask]
    cfg = dict(factors=20, loss="warp", max_samples=20,
               learning_schedule="invscaling")

    # 1. the ML-1M headline on data=2, merging every batch and every 4
    for k in (1, 4):
        model, rec = mesh_fit(torch, mesh, fused, scatter, lambda: RankFM(
            **cfg, mesh=mesh, dp_sync_every=k).fit(train, epochs=6))
        rec["hr"] = evaluation.hit_rate(model, test, k=10)
        rec["dcg"] = evaluation.discounted_cumulative_gain(model, test, k=10)
        wall, busy, _ = profile_call(
            torch, lambda: model.fit_partial(train, epochs=1))
        rec.update(profile_wall=wall, profile_busy=busy)
        out[f"ml1m_sync{k}"] = rec
    # 2. the Instacart mixed schedule: 5 fused + 1 candidate epoch
    ic_train, _, ic_sw, _, _ = instacart_data()
    _, out["instacart"] = mesh_fit(torch, mesh, fused, scatter, lambda: RankFM(
        factors=50, loss="warp", max_samples=50, alpha=0.01, beta=0.1,
        learning_rate=0.1, learning_schedule="invscaling", mesh=mesh).fit(
        ic_train, sample_weight=ic_sw, epochs=6))
    # 3. the window step
    _, out["window"] = mesh_fit(torch, mesh, fused, scatter, lambda: RankFM(
        **cfg, use_fused=False, mesh=mesh).fit(train, epochs=2))

    # 4. table parallelism on (data=1, model=2) at the web-scale shape
    mesh_tp = make_mesh(data=1, model=world, device=devices[rank],
                        backend=backend)
    web = webscale_data()
    model, out["tp"] = mesh_fit(torch, mesh_tp, fused, scatter, lambda: RankFM(
        factors=WEB_F, loss="warp", max_samples=10, alpha=0.01,
        learning_rate=0.1, learning_schedule="invscaling",
        mesh=mesh_tp).fit(web, epochs=1))
    out["tp"]["shard_rows"] = model._w_tp["v_i"].shape[0]
    # 5. sharded recommend from the shards, against a single-device model
    # holding the same weights (saved: one all-gather of the shards)
    users = np.arange(1000)
    mesh_tp.trace = []
    recs, rec_s = timed(torch, lambda: model.recommend(
        users, n_items=10, filter_previous=True))
    path = Path(work) / f"tp{rank}.npz"
    _, save_s = timed(torch, lambda: model.save(str(path)))
    out["recommend"] = {"s": rec_s, "save_s": save_s,
                        "collectives": collective_record(mesh_tp),
                        "lists": recs.values.tolist()}
    single = RankFM.load(str(path), device=devices[rank])
    path.unlink()
    srecs, srec_s = timed(torch, lambda: single.recommend(
        users, n_items=10, filter_previous=True))
    out["recommend"].update(
        single_s=srec_s,
        same_as_single=bool(np.array_equal(recs.values, srecs.values,
                                           equal_nan=True)))
    with open(Path(work) / f"rank{rank}.json", "w") as f:
        json.dump(out, f)
    dist.destroy_process_group()


def mesh_data1_check(torch, fused, train):
    """Run 6: `dp_fused_epoch` on a data=1 mesh in this process against
    `fused_epoch` from the same tables, at the ML-1M main layout: an
    identity check of rank 0's draws (the same draws and records reach B1,
    recorded at each launch, and the same tables come out: bit for bit
    where B1 is bit for bit the same run to run). A group of one rank runs
    no collective, so the epoch sends nothing through NCCL: one NCCL
    all-reduce of a known tensor on the one-rank group checks that NCCL
    starts and launches on the card."""
    import torch.distributed as dist

    from rankfm_tpu_torch.parallel import init_distributed, make_mesh

    work = tempfile.mkdtemp(prefix="chip_smoke_mesh1_")
    init_distributed(init_method=f"file://{work}/rendezvous", world_size=1,
                     rank=0, backend="nccl")
    mesh = make_mesh(data=1, device="cuda:0", backend="nccl")
    dev = mesh.device
    probe = torch.arange(1 << 20, dtype=torch.float32, device=dev)
    dist.all_reduce(probe)
    torch.cuda.synchronize()
    check(torch.equal(probe, torch.arange(1 << 20, dtype=torch.float32,
                                          device=dev)),
          "a one-rank NCCL all-reduce changed its tensor")
    bs, chunk, ub = 32768, 256, 1024
    rec, group, cids, ublk, iblk = fused.make_records_grouped(
        train[:, 0], train[:, 1], np.ones(len(train), np.float32), N_USERS,
        N_ITEMS, bs, chunk, ub=ub)
    layout = (torch.from_numpy(rec).to(dev), torch.from_numpy(group),
              torch.from_numpy(cids), torch.from_numpy(ublk),
              torch.from_numpy(iblk))
    split = layout[:2] + fused.split_layout_for_mesh(*layout[2:], 1)
    offsets = np.zeros(N_USERS + 1, np.int64)
    pairs = np.unique(train, axis=0)
    offsets[1:] = np.cumsum(np.bincount(pairs[:, 0], minlength=N_USERS))
    packed = torch.from_numpy(fused.pack_history(
        offsets, pairs[:, 1].astype(np.int32), N_USERS, N_ITEMS)).to(dev)
    rng = np.random.default_rng(SEED + 6)
    w0 = [torch.from_numpy(rng.normal(0, s, shape).astype(np.float32)).to(dev)
          for s, shape in ((0.05, N_ITEMS), (0.1, (N_USERS, 20)),
                           (0.1, (N_ITEMS, 20)))]
    kw = dict(num_users=N_USERS, num_items=N_ITEMS, factors=20,
              max_samples=20, batch_size=bs, chunk=chunk, ub=ub)
    seen = []
    real = fused.fused_batch

    def spy(tab_u, tab_i, rec_b, packed_, blk, ublk_b, iblk_b, seed, *a,
            **k):
        seen[-1].append((int(seed), blk.cpu().numpy().tobytes(),
                         ublk_b.cpu().numpy().tobytes(),
                         iblk_b.cpu().numpy().tobytes(),
                         hashlib.sha256(rec_b.cpu().numpy()).hexdigest()))
        return real(tab_u, tab_i, rec_b, packed_, blk, ublk_b, iblk_b, seed,
                    *a, **k)

    outs = []
    fused.fused_batch = spy
    try:
        for dp in (False, True, False):
            seen.append([])
            tabs = fused.extend_tables(*w0, fused.user_pad(N_USERS, ub),
                                       fused.item_pad(N_ITEMS))
            if dp:
                ll = fused.dp_fused_epoch(*tabs, packed, split, 0.05, 0.01,
                                          SEED, 3, mesh=mesh, **kw)
            else:
                ll = fused.fused_epoch(*tabs, packed, layout, 0.05, 0.01,
                                       SEED, 3, **kw)
            outs.append((tabs, float(ll)))
    finally:
        fused.fused_batch = real
    dist.destroy_process_group()
    check(seen[0] == seen[1] == seen[2] and len(seen[0]) > 0,
          "data=1 mesh: B1 received other draws than fused_epoch's")
    (a, lla), (b, llb), (c, llc) = outs
    kernel_exact = all(torch.equal(x, y) for x, y in zip(a, c))
    err = max(float((x - y).abs().max()) for x, y in zip(a, b))
    if kernel_exact:
        check(err == 0.0 and lla == llb,
              f"data=1 mesh differs from fused_epoch by {err}")
    else:
        check(err <= TABLE_ATOL, f"data=1 mesh differs by {err}")
    print(f"mesh run 6: one NCCL all-reduce of 2^20 f32 on a one-rank group "
          f"returned its tensor; dp_fused_epoch on a data=1 mesh (no "
          f"collective: an identity check of rank 0's draws) vs fused_epoch, "
          f"ML-1M main layout, {len(seen[0])} batches: the same draws and "
          f"records at every B1 launch; tables "
          + ("bit-equal (B1 is bit for bit the same run to run)"
             if kernel_exact else
             f"within {err:.2e} (B1 itself differs run to run: f32 atomics)")
          + f"; ll {lla:.3f} / {llb:.3f} ({CARD})", flush=True)


def print_mesh_record(rank, tag, rec):
    """One line per rank and run: epochs, busy share, collectives."""
    coll = "; ".join(
        f"{k} {c['calls']} x {c['bytes'] / max(c['calls'], 1) / 1e6:.3f} MB, "
        f"{c['ms'] / max(c['calls'], 1):.3f} ms each"
        for k, c in sorted(rec["collectives"].items()))
    busy = ""
    if "profile_wall" in rec:
        busy = (f"; one more epoch (fit_partial) wall "
                f"{1e3 * rec['profile_wall']:.1f} ms, device "
                + ("time not traced" if rec["profile_busy"] is None else
                   f"busy {100 * rec['profile_busy'] / rec['profile_wall']:.0f}%"))
    print(f"mesh {tag}, rank {rank}: fit {rec['fit_s']:.2f} s, epochs "
          f"{', '.join(f'{x:.3f}' for x in rec['epoch_s'])} s (fit average)"
          f"{busy}; launches {rec['counts']}; collectives: {coll} ({CARD})",
          flush=True)


def mesh_phase(torch, fused, train, ref):
    """Phase 11: two ranks spawned on the card(s) (runs 1-5), then run 6
    in this process. Returns the launch counts of the ranks' runs, summed."""
    n_cards = torch.cuda.device_count()
    if n_cards >= 2:
        devices, backend = ["cuda:0", "cuda:1"], "nccl"
        how = "one card each, NCCL"
    else:
        devices, backend = ["cuda:0", "cuda:0"], "gloo"
        how = ("both on cuda:0, gloo through the host (NCCL refuses two "
               "ranks on one device)")
    print(f"mesh: 2 ranks, {how}", flush=True)
    mesh_data1_check(torch, fused, train)

    work = tempfile.mkdtemp(prefix="chip_smoke_mesh_")
    t0 = time.time()
    ctx = torch.multiprocessing.start_processes(
        mesh_rank, args=(2, work, devices, backend, CARD), nprocs=2,
        join=False, start_method="spawn")
    while not ctx.join(timeout=5):
        if time.time() - t0 > MESH_TIMEOUT_S:
            for p in ctx.processes:
                p.kill()
            check(False, f"the mesh ranks ran past {MESH_TIMEOUT_S} s")
    res = []
    for r in range(2):
        with open(Path(work) / f"rank{r}.json") as f:
            res.append(json.load(f))
    print(f"mesh ranks: {time.time() - t0:.1f} s for runs 1-5", flush=True)

    runs = ("ml1m_sync1", "ml1m_sync4", "instacart", "window", "tp")
    for run in runs:
        a, b = res[0][run], res[1][run]
        check(a["lls"] == b["lls"] and np.isfinite(a["lls"]).all(),
              f"mesh {run}: the ranks' lls differ or are not finite: "
              f"{a['lls']} / {b['lls']}")
        check(a["digest"] == b["digest"],
              f"mesh {run}: the ranks' final tables differ")
        for r, rec in enumerate((a, b)):
            print_mesh_record(r, run, rec)
    for run in runs[:2]:
        plan = res[0][run]["plan"]
        check(plan["fused"] and plan["placement"] == "dp"
              and plan["n_dev"] == 2 and plan["chunk_tail"] == 0,
              f"mesh {run} plan {plan}")
        for rec in (res[0][run], res[1][run]):
            check(rec["counts"]["fused_chunk"] > 0,
                  f"mesh {run}: B1 did not launch on a rank: {rec['counts']}")
            for m in ("hr", "dcg"):
                check(rec[m] >= ref[m] - MESH_BAND,
                      f"mesh {run}: {m}@10 {rec[m]:.4f} more than "
                      f"{MESH_BAND} below the single-device {ref[m]:.4f}")
        print(f"mesh {run}: hit_rate@10 {res[0][run]['hr']:.4f}, dcg@10 "
              f"{res[0][run]['dcg']:.4f} (single device {ref['hr']:.4f}, "
              f"{ref['dcg']:.4f})", flush=True)
    plan = res[0]["instacart"]["plan"]
    check(plan["fused"] and plan["n_main"] == 5 and plan["n_tail"] == 1
          and plan["placement"] == "dp", f"mesh instacart plan {plan}")
    plan = res[0]["window"]["plan"]
    check(not plan["fused"] and plan["step_kind"] == "window"
          and plan["placement"] == "dp", f"mesh window plan {plan}")
    plan = res[0]["tp"]["plan"]
    check(plan["placement"] == "tp" and not plan["fused"],
          f"mesh tp plan {plan}")
    for rec in (res[0]["instacart"], res[1]["instacart"]):
        c = rec["counts"]
        check(c["fused_chunk"] > 0 and c["table_update_sorted"] > 0
              and c["table_update_dense"] > 0,
              f"mesh instacart: B1, B2 and B3 did not all launch: {c}")
    for run in ("window", "tp"):
        for rec in (res[0][run], res[1][run]):
            c = rec["counts"]
            check(c["table_update_sorted"] + c["table_update_dense"] > 0,
                  f"mesh {run}: no table update launched: {c}")
    rec0, rec1 = res[0]["recommend"], res[1]["recommend"]
    check(rec0["lists"] == rec1["lists"], "mesh: the ranks' lists differ")
    check(rec0["same_as_single"] and rec1["same_as_single"],
          "mesh: the sharded lists differ from the single-device lists")
    print(f"mesh run 4: TP fit of {WEB_USERS} users x {WEB_ITEMS} items, F "
          f"{WEB_F}, {res[0]['tp']['shard_rows']} item rows per rank; run 5: "
          f"recommend 1000 users, top 10, filtered, from the shards "
          f"{rec0['s']:.3f} s (rank 0) / {rec1['s']:.3f} s; the same lists "
          f"as a single-device model ({rec0['single_s']:.3f} s); save with "
          f"its all-gather {rec0['save_s']:.3f} s; collectives "
          f"{rec0['collectives']} ({CARD})", flush=True)
    return {k: sum(r[run]["counts"][k] for r in res for run in runs)
            for k in res[0]["tp"]["counts"]}


# ---------------------------------------------------------------------------
# 12. quality against the oracle on the card
# ---------------------------------------------------------------------------

def parity_common():
    """`tests/torch_parity_common.py` of this tree, imported by path: the
    oracle harness, the JAX package's gates and the configurations."""
    import importlib.util
    if "torch_parity_common" not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            "torch_parity_common", ROOT / "tests" / "torch_parity_common.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = mod      # dataclasses look the module up
        spec.loader.exec_module(mod)
    return sys.modules["torch_parity_common"]


def quality_phase(torch, RankFM, evaluation, fused, scatter, ic_data):
    """Phase 12: the full ML-1M headline at three model seeds, the mixed
    large catalog, the five scaled configs and the 30-epoch Instacart
    headline, each fitted on the card through the public API and held
    against the port's C++ sequential oracle on the same data and initial
    weights; the oracle fits run on threads while the card fits. Returns
    the launch counts of the card's fits."""
    from concurrent.futures import ThreadPoolExecutor

    from rankfm_tpu_torch import native

    tpc = parity_common()
    t_phase = time.time()
    t0 = time.time()
    check(native.get_oracle() is not None,
          f"the sequential oracle did not build: {native.oracle_build_error}")
    print(f"build: sequential oracle {time.time() - t0:.2f} s (g++)",
          flush=True)
    ic_train, ic_test, ic_sw = ic_data[:3]
    instacart = tpc.Case(
        "instacart-headline", lambda: (ic_train, ic_test,
                                       {"sample_weight": ic_sw}),
        dict(factors=50, loss="warp", max_samples=50, alpha=0.01, beta=0.1,
             learning_rate=0.1, learning_schedule="invscaling", seed=SEED),
        QUALITY_IC_EPOCHS, None)
    # the longest oracle fits first
    cases = ([instacart] + [tpc.ml1m_headline(s) for s in tpc.ML1M_SEEDS]
             + [tpc.MIXED_LARGE] + list(tpc.SCALED))
    t0 = time.time()
    data = {}   # by generator: the three ML-1M seeds share one log
    for case in cases:
        if case.data not in data:
            data[case.data] = case.data()
    print(f"quality data: {time.time() - t0:.2f} s", flush=True)

    workers = max(2, min(len(cases), (os.cpu_count() or 4) - 2))
    with ThreadPoolExecutor(max_workers=workers) as pool:
        oracles = [pool.submit(tpc.oracle_metrics,
                               RankFM(**case.model, device="cpu"),
                               data[case.data][0], data[case.data][1],
                               case.epochs, **data[case.data][2])
                   for case in cases]
        reset_launches(torch, fused, scatter)
        fits = []
        for case in cases:
            train, test, kw = data[case.data]
            t0 = time.time()
            model = RankFM(**case.model, device="cuda").fit(
                train, epochs=case.epochs, **kw)
            torch.cuda.synchronize()
            fit_s = time.time() - t0
            check_lls(model, case.epochs, case.name)
            fits.append((model.last_fit_plan_, fit_s,
                         evaluation.compute(model, test, k=10)))
        # reported beside the oracle of the same data and seed, not gated
        # (the JAX package left both ungated): the ML-1M headline at seed
        # 1492 on 4 cycled layouts, the Instacart headline with the wide tail
        extra = []
        for base, kw in ((cases[1], dict(shuffle_layouts=4)),
                         (instacart, dict(tail_windows=WIDE_NW))):
            train, test, fkw = data[base.data]
            t0 = time.time()
            model = RankFM(**base.model, **kw, device="cuda").fit(
                train, epochs=base.epochs, **fkw)
            torch.cuda.synchronize()
            check_lls(model, base.epochs, f"{base.name} {kw}")
            extra.append((base, kw, model.last_fit_plan_, time.time() - t0,
                          evaluation.compute(model, test, k=10)))
        counts = launches_of(fused, scatter)
        t0 = time.time()
        oracles = [f.result(timeout=QUALITY_ORACLE_TIMEOUT_S)
                   for f in oracles]
    print(f"quality: card fits done, then {time.time() - t0:.2f} s waiting "
          f"for the oracle ({workers} threads)", flush=True)

    failures, ml1m = [], {}
    for case, (plan, fit_s, build), oracle in zip(cases, fits, oracles):
        d = tpc.deltas(build, oracle)
        bad = tpc.gate_failures(case, build, oracle)
        failures += [f"{case.name}: {b}" for b in bad]
        if case.name.startswith("ml1m"):
            ml1m[case.model["seed"]] = d
            if not (plan.fused and plan.chunk_tail == 3):
                failures.append(f"{case.name}: plan {plan}")
        if case is tpc.MIXED_LARGE and not (plan.fused
                                            and plan.chunk_tail == 3):
            failures.append(f"{case.name}: plan {plan}")
        gate = ("not gated" if case.gates is None else
                "FAIL " + "; ".join(bad) if bad else "inside the gate")
        if case.gates is None:
            beyond = [m for m in tpc.METRICS if abs(d[m]) > 0.03]
            gate += (f", beyond +-0.03: {beyond}" if beyond
                     else ", every delta inside +-0.03")
        print(f"quality {case.name}: port - oracle "
              + ", ".join(f"{m} {d[m]:+.4f}" for m in tpc.METRICS)
              + f" ({gate}); port hit_rate {build['hit_rate']:.4f}, oracle "
              f"{oracle['hit_rate']:.4f}; fit {fit_s:.2f} s for "
              f"{case.epochs} epochs, plan "
              + (f"fused, chunk {plan.chunk}, {plan.n_main} main + "
                 f"{plan.n_tail} {plan.step_kind} tail + {plan.chunk_tail} "
                 f"chunk-tail" if plan.fused else f"{plan.step_kind} step")
              + f" ({CARD})", flush=True)
    for base, kw, plan, fit_s, build in extra:
        d = tpc.deltas(build, oracles[cases.index(base)])
        print(f"quality {base.name} with {kw}: port - oracle "
              + ", ".join(f"{m} {d[m]:+.4f}" for m in tpc.METRICS)
              + " (not gated"
              + ("; the JAX package's R = 4 worst seed: HR -0.011 to -0.013, "
                 "BENCHMARKS.md" if "shuffle_layouts" in kw else "")
              + f"); fit {fit_s:.2f} s, plan "
              f"{plan.n_main} main + {plan.n_tail} tail (tail_windows "
              f"{plan.tail_windows}), shuffle_layouts {plan.shuffle_layouts}, "
              f"chunk-tail {plan.chunk_tail} ({CARD})", flush=True)
        if kw.get("tail_windows") and not plan.tail_windows:
            failures.append(f"{base.name} {kw}: plan {plan}")
        if kw.get("shuffle_layouts") and plan.shuffle_layouts != 4:
            failures.append(f"{base.name} {kw}: plan {plan}")
    for m in ("hit_rate", "discounted_cumulative_gain"):
        seed = min(ml1m, key=lambda s: ml1m[s][m])
        print(f"quality ML-1M headline, worst seed by {m}: {seed}, "
              f"{ml1m[seed][m]:+.4f} (the JAX package on a TPU: "
              f"{tpc.JAX_WORST_ML1M[m]:+.3f}, BENCHMARKS.md)", flush=True)
    check(counts["fused_chunk"] > 0 and counts["fused_chunk_features"] > 0
          and counts["table_update_sorted"] > 0
          and counts["table_update_dense"] > 0,
          f"phase 12 did not launch B1, featured B1, B2 and B3: {counts}")
    print(f"quality phase: {time.time() - t_phase:.1f} s; launches {counts}",
          flush=True)
    check(not failures, "quality against the oracle: " + "; ".join(failures))
    return counts


def run_examples():
    """The examples of `examples/torch/` that this script runs, each as a
    user runs it (a process of its own, on the card), all at once: each
    must exit 0 within `EXAMPLE_TIMEOUT_S`; their output is printed."""
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        [str(ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
    t0 = time.time()
    procs = {}
    try:
        for name in EXAMPLES:
            out = tempfile.TemporaryFile(mode="w+")
            procs[name] = (subprocess.Popen(
                [sys.executable, str(ROOT / "examples" / "torch" / name)],
                cwd=ROOT, env=env, stdout=out, stderr=subprocess.STDOUT,
                text=True), out)
        failed = []
        for name, (proc, out) in procs.items():
            try:
                rc = proc.wait(timeout=max(1.0, EXAMPLE_TIMEOUT_S
                                           - (time.time() - t0)))
            except subprocess.TimeoutExpired:
                rc = f"no exit within {EXAMPLE_TIMEOUT_S} s"
            out.seek(0)
            for line in out.read().splitlines():
                print(f"example {name}: {line}", flush=True)
            if rc != 0:
                failed.append(f"{name}: {rc}")
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    print(f"examples: {time.time() - t0:.1f} s for {', '.join(EXAMPLES)} "
          f"({CARD})", flush=True)
    check(not failed, f"examples failed: {failed}")


def b1_phase(torch, fused, train, dev, other_tree=False):
    """Phase 3's B1 runs (`kernel_phase`) at the ML-1M shapes (both
    layouts), the Instacart shape at 4 windows and (this tree only) at the
    wide tail's `WIDE_NW`, featured at the Instacart and ML-1M shapes.
    Returns ``{name: kernel_phase's record}`` and ``{"name cC": {"ms",
    "phase_us"}}``."""
    ic_pairs, _, ic_depts = make_instacart(np.random.default_rng(SEED + 1))
    ml_uf, ml_if = ml1m_features(np.random.default_rng(SEED + 2))
    kw = dict(other_tree=other_tree)
    out = {"ml1m": kernel_phase(torch, fused, train, dev, N_USERS, N_ITEMS,
                                20, 20, ((256, 1024), (128, 256)), **kw),
           "instacart": kernel_phase(torch, fused, ic_pairs, dev, IC_USERS,
                                     IC_ITEMS, 50, 50, ((128, 1024),), nw=4,
                                     tag="Instacart", **kw)}
    if not other_tree:
        out["instacart wide"] = kernel_phase(
            torch, fused, ic_pairs, dev, IC_USERS, IC_ITEMS, 50, 50,
            ((128, 1024),), nw=WIDE_NW, tag="Instacart wide tail")
    out["instacart featured"] = kernel_phase(
        torch, fused, ic_pairs, dev, IC_USERS, IC_ITEMS, 50, 50,
        ((128, 1024),), nw=4, tag="Instacart",
        x_uf=one_hot(ic_depts["user"], IC_DEPTS),
        x_if=one_hot(ic_depts["item"], IC_DEPTS), **kw)
    # both feature sets at both layouts of the featured ML-1M fit (main and
    # chunk-tail, the user features re-padded to the tail's rows)
    for name, xu, xi, layouts in (
            ("ml1m featured", ml_uf, ml_if, ((256, 1024), (128, 256))),
            ("ml1m user features", ml_uf, None, ((256, 1024),)),
            ("ml1m item features", None, ml_if, ((256, 1024),))):
        out[name] = kernel_phase(torch, fused, train, dev, N_USERS, N_ITEMS,
                                 20, 20, layouts, x_uf=xu, x_if=xi, **kw)
    times = {f"{name} c{c[1:]}": {"ms": rec["ms"], "phase_us": rec["phase_us"]}
             for name, kp in out.items() for c, rec in kp.items()
             if c.startswith("c")}
    return out, times


def weight_digest(model):
    """SHA-256 of every weight tensor of ``model``, in name order."""
    h = hashlib.sha256()
    for k, v in sorted(model._weights.items()):
        h.update(k.encode())
        h.update(np.ascontiguousarray(v).tobytes())
    return h.hexdigest()


def repro_fits(RankFM, train, ic_data):
    """``[(name, fit)]``: the fits phase 13 runs twice, each ``fit()``
    returning a fitted model on the card."""
    ic_train, _, sw, x_uf, x_if = ic_data
    ml = dict(factors=20, loss="warp", max_samples=20,
              learning_schedule="invscaling", device="cuda")
    ic = dict(factors=50, loss="warp", max_samples=50, alpha=0.01, beta=0.1,
              learning_rate=0.1, learning_schedule="invscaling",
              device="cuda")
    fkw = dict(user_features=feature_frame(x_uf, np.unique(ic_train[:, 0]),
                                           "user"),
               item_features=feature_frame(x_if, np.unique(ic_train[:, 1]),
                                           "item"))
    return [
        ("ML-1M, 6 epochs (main + chunk-tail; B1)",
         lambda: RankFM(**ml).fit(train, epochs=6)),
        ("Instacart mixed, 5 fused + 1 candidate (B1, B3, B2)",
         lambda: RankFM(**ic).fit(ic_train, sample_weight=sw, epochs=6)),
        ("Instacart with features (featured B1, B3, B2)",
         lambda: RankFM(**ic).fit(ic_train, sample_weight=sw, epochs=6,
                                  **fkw)),
        ("window step, 2 epochs (B2)",
         lambda: RankFM(**ml, use_fused=False).fit(train, epochs=2)),
        (f"Instacart wide tail, 5 + 1 at {WIDE_NW} windows (B1)",
         lambda: RankFM(**ic, tail_windows=WIDE_NW).fit(
             ic_train, sample_weight=sw, epochs=6)),
        ("ML-1M shuffle_layouts=4, 6 epochs (B1)",
         lambda: RankFM(**ml, shuffle_layouts=4).fit(train, epochs=6)),
    ]


def repro_phase(torch, RankFM, fused, scatter, train, ic_data):
    """Phase 13: each fit of `repro_fits` twice from the same seed; the
    SHA-256 of the weights must be equal. Then one fit of each engine under
    ``torch.use_deterministic_algorithms(True)`` in a process of its own
    (``--deterministic-fits``). Returns the launch counts of the fits."""
    t0 = time.time()
    reset_launches(torch, fused, scatter)
    for name, fit in repro_fits(RankFM, train, ic_data):
        digests = [weight_digest(fit()) for _ in range(2)]
        print(f"repro {name}: weights sha256 {digests[0]} / {digests[1]}",
              flush=True)
        check(digests[0] == digests[1],
              f"two fits from one seed differ: {name}")
    counts = launches_of(fused, scatter)
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()),
         "--deterministic-fits"], capture_output=True, text=True,
        timeout=600, env=env, cwd=ROOT)
    for line in proc.stdout.strip().splitlines():
        print(f"deterministic algorithms: {line}", flush=True)
    check(proc.returncode == 0,
          f"a fit under torch.use_deterministic_algorithms(True) failed "
          f"({proc.returncode}):\n{proc.stderr[-3000:]}")
    print(f"repro phase: {time.time() - t0:.1f} s; launches {counts}",
          flush=True)
    return counts


def deterministic_fits(torch, RankFM, train, ic_data):
    """``--deterministic-fits``: one fit of each engine (fused with its
    chunk-tail, the mixed schedule's candidate step, the window step, the
    featured fused and candidate steps) with
    ``torch.use_deterministic_algorithms(True)``, which raises on an
    operation that has no deterministic implementation on the card."""
    torch.use_deterministic_algorithms(True)
    fits = repro_fits(RankFM, train, ic_data)
    for name, fit in fits[:4]:
        t0 = time.time()
        model = fit()
        torch.cuda.synchronize()
        check(all(np.isfinite(v).all() for v in model._weights.values()),
              f"{name}: weights not finite")
        print(f"{name}: {time.time() - t0:.2f} s, no operation without a "
              f"deterministic implementation", flush=True)


def tree_times(tree):
    """The times of another tree of this repository (``--times-of`` in a
    process of its own): ``{"b1": {"shape": times}, "update": {"case/kernel":
    times}, "candidate": [s, s], "window": [s, s], "fused": [s, s],
    "ml1m_fused": [s, s]}``."""
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--times-of",
         str(tree)], capture_output=True, text=True, timeout=900)
    check(proc.returncode == 0,
          f"--times-of {tree} failed ({proc.returncode}):\n"
          f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def print_parent_table(parents, b1, times, candidate, window, fused,
                       ml1m_fused):
    """This tree's B1, table-update and epoch times beside the parent
    tree's, measured before and after them on the same card."""
    for key, tm in b1.items():
        old = [p.get("b1", {}).get(key) for p in parents]
        if None in old:
            continue
        print(f"parent vs new, B1 {key}: batch ms "
              + " / ".join(f"{o['ms']:.4f}" for o in old)
              + f" -> {tm['ms']:.4f}; us per chunk by phase ("
              + ", ".join(B1_PHASES) + ") "
              + " / ".join("[" + ", ".join(f"{x:.2f}" for x in o["phase_us"])
                           + "]" for o in old)
              + " -> [" + ", ".join(f"{x:.2f}" for x in tm["phase_us"])
              + f"] ({CARD})", flush=True)
    for key, tm in times.items():
        old = [p["update"].get(key) for p in parents]
        if None in old:
            print(f"parent vs new, {key}: the parent has no such time",
                  flush=True)
            continue
        print(f"parent vs new, {key}: ms "
              + " / ".join(f"{o['ms']:.4f}" for o in old)
              + f" -> {tm['ms']:.4f}; device ms "
              + " / ".join(f"{o['device_ms']:.4f}" for o in old)
              + f" -> {tm['device_ms']:.4f}; enqueue us "
              + " / ".join(f"{o['enqueue_us']:.1f}" for o in old)
              + f" -> {tm['enqueue_us']:.1f}; launches per call "
              + " / ".join(f"{o['activities']:.0f}" for o in old)
              + f" -> {tm['activities']:.0f}"
              + ("" if tm["ms"] <= min(o["ms"] for o in old)
                 else "  SLOWER than the parent") + f" ({CARD})", flush=True)
    for name, what, new in (
            ("candidate", "Instacart candidate-step", candidate),
            ("window", "ML-1M window-step", window),
            ("fused", "Instacart fused", fused),
            ("ml1m_fused", "ML-1M fused", ml1m_fused)):
        if any(name not in p for p in parents):
            continue
        print(f"parent vs new, {what} epoch, device synced: "
              + " / ".join(", ".join(f"{x:.3f}" for x in p[name])
                           for p in parents)
              + " -> " + ", ".join(f"{x:.3f}" for x in new)
              + f" s ({CARD})", flush=True)


def run(args):
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    global ROOT
    if args.times_of:
        ROOT = Path(args.times_of).resolve()
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
    global CARD
    CARD = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else "?"
    print(f"card: {CARD}", flush=True)

    # 2. build
    t0 = time.time()
    _build.build()
    for name in _build.LIBS:
        _build.load(name)
    print(f"build: {time.time() - t0:.2f} s (nvcc, all sources at once: "
          f"{_build.build_info.get('seconds', 0.0):.2f} s)", flush=True)
    if not args.times_of:
        # the host's library too, so that no fit below is charged its g++
        from rankfm_tpu_torch import native
        t0 = time.time()
        check(native.get_lib() is not None,
              f"the native ingest library did not build: {native.build_error}")
        print(f"build: native ingest library {time.time() - t0:.2f} s (g++)",
              flush=True)

    rng = np.random.default_rng(SEED)
    data = make_synthetic(rng)
    mask = rng.random(len(data)) < 0.8
    train, test = data[mask], data[~mask]

    if args.only_updates:
        update_phase(torch, scatter, dev)
        return 0
    if args.profiler_windows:
        profiler_windows(torch, scatter, dev, args.profiler_windows)
        return 0
    if args.only_host_half:
        host_half_path(torch, RankFM, evaluation, fused, scatter, train, test,
                       instacart_data())
        return 0
    if args.only_quality:
        quality_phase(torch, RankFM, evaluation, fused, scatter,
                      instacart_data())
        return 0
    if args.only_mesh:
        # the single-device ML-1M fit the mesh's is held against, then 11
        _, ref = ml1m_path(torch, RankFM, evaluation, fused, scatter, train,
                           test)
        mesh_phase(torch, fused, train, ref)
        return 0
    if args.only_repro:
        repro_phase(torch, RankFM, fused, scatter, train, instacart_data())
        return 0
    if args.deterministic_fits:
        deterministic_fits(torch, RankFM, train, instacart_data())
        return 0
    if args.times_of:
        # phases 3, 4, 5, 6 and 9 of another tree, through what both trees
        # have
        _, b1 = b1_phase(torch, fused, train, dev, other_tree=True)
        _, times = update_phase(torch, scatter, dev, other_tree=True)
        _, ref = ml1m_path(torch, RankFM, evaluation, fused, scatter, train,
                           test)
        _, tm = instacart_path(torch, RankFM, evaluation, fused, scatter,
                               training, instacart_data())
        _, win = window_path(torch, RankFM, fused, scatter, training, train)
        print(json.dumps({"b1": b1, "update": times,
                          "candidate": tm["candidate"], "window": win,
                          "fused": tm["fused"], "ml1m_fused": ref["fused"]}))
        return 0
    parents = [tree_times(args.parent)] if args.parent else []

    # 3. B1: its phase boundaries, then vs plain at the ML-1M and Instacart
    # shapes (and the wide tail's window count), without and with side
    # features
    probe_phase_boundaries(torch, fused)
    kps, b1_times = b1_phase(torch, fused, train, dev)

    # 4. B3 / B2 vs plain
    up, up_times = update_phase(torch, scatter, dev)

    # 5-10. the paths, each with its own launch counts
    ic_data = instacart_data()
    counts, ml1m_ref = ml1m_path(torch, RankFM, evaluation, fused, scatter,
                                 train, test)
    paths = [counts]
    paths.append(ml1m_layouts_path(torch, RankFM, fused, scatter, train,
                                   ml1m_ref["fused"]))
    counts, tm_ic = instacart_path(torch, RankFM, evaluation, fused, scatter,
                                   training, ic_data)
    paths.append(counts)
    counts, tmw_ic = instacart_path(torch, RankFM, evaluation, fused, scatter,
                                    training, ic_data, tail_windows=WIDE_NW)
    paths.append(counts)
    print(f"Instacart closing epoch: wide tail ({WIDE_NW} windows) "
          f"hit_rate@10 {tmw_ic['hr']:.4f} vs candidate tail "
          f"{tm_ic['hr']:.4f}; tail epoch, device synced "
          f"{', '.join(f'{x:.3f}' for x in tmw_ic['tail'])} s vs candidate "
          f"epoch {', '.join(f'{x:.3f}' for x in tm_ic['candidate'])} s "
          f"({CARD})", flush=True)
    counts, tmf_ic = instacart_path(torch, RankFM, evaluation, fused, scatter,
                                    training, ic_data, features=True)
    paths.append(counts)
    print("Instacart fused epoch, device synced: featured "
          f"{', '.join(f'{x:.3f}' for x in tmf_ic['fused'])} s vs "
          f"featureless {', '.join(f'{x:.3f}' for x in tm_ic['fused'])} s; "
          f"candidate epoch featured "
          f"{', '.join(f'{x:.3f}' for x in tmf_ic['candidate'])} s vs "
          f"{', '.join(f'{x:.3f}' for x in tm_ic['candidate'])} s ({CARD})",
          flush=True)
    ml_uf, ml_if = ml1m_features(np.random.default_rng(SEED + 2))
    paths.append(ml1m_features_path(torch, RankFM, fused, scatter, train,
                                    ml_uf, ml_if))
    counts, win_s = window_path(torch, RankFM, fused, scatter, training,
                                train)
    paths.append(counts)

    # 10. ingest, resume, checkpoint, baseline
    paths.append(host_half_path(torch, RankFM, evaluation, fused, scatter,
                                train, test, ic_data))

    # 11. the mesh: two ranks (runs 1-5), a data=1 mesh in this process
    mesh_counts = mesh_phase(torch, fused, train, ml1m_ref)
    paths.append(mesh_counts)

    # 12. quality against the oracle on the card, then the examples
    paths.append(quality_phase(torch, RankFM, evaluation, fused, scatter,
                               ic_data))
    run_examples()

    # 13. the same fits twice from one seed
    paths.append(repro_phase(torch, RankFM, fused, scatter, train, ic_data))
    if args.parent:
        parents.append(tree_times(args.parent))
        print_parent_table(parents, b1_times, up_times, tm_ic["candidate"],
                           win_s, tm_ic["fused"], ml1m_ref["fused"])
    total = {k: sum(p[k] for p in paths) for k in paths[0]}
    check(all(total[k] > 0 for k in total),
          f"a kernel was never launched on the paths: {total}")

    check("jax" not in sys.modules, "jax was imported")
    print(f"total {time.time() - t_start:.1f} s", flush=True)
    # no `library_ms`: no one PyTorch call computes a whole fused train step,
    # nor a scatter-sum with per-touch decay (`index_add_` has no decay)
    kp, kp_ic, kpf_ic = (kps[k] for k in ("ml1m", "instacart",
                                          "instacart featured"))
    kpf_ml = [kps[k] for k in ("ml1m featured", "ml1m user features",
                               "ml1m item features")]
    record = {"kernels": [
        {"name": "fused_chunk", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/fused_chunk.cu",
         "replaces": "rankfm_tpu/ops/fused.py:542",
         "launches": total["fused_chunk"],
         "launches_wide_tail": total["fused_chunk_wide"],
         "mesh_launches": mesh_counts["fused_chunk"],
         "max_abs_err": max(kp["max_abs_err"], kp_ic["max_abs_err"],
                            kps["instacart wide"]["max_abs_err"]),
         **{k: kp["c256"][k] for k in B1_KEYS}, "library_ms": None},
        {"name": "fused_chunk_features", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/fused_chunk.cu",
         "replaces": "rankfm_tpu/ops/fused.py:545",
         "launches": total["fused_chunk_features"],
         "mesh_launches": mesh_counts["fused_chunk_features"],
         "max_abs_err": max(k["max_abs_err"] for k in [kpf_ic] + kpf_ml),
         **{k: kpf_ic["c128"][k] for k in B1_KEYS}, "library_ms": None},
        {"name": "table_update_sorted", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/table_update.cu",
         "replaces": "rankfm_tpu/ops/scatter.py:73",
         "launches": total["table_update_sorted"],
         "mesh_launches": mesh_counts["table_update_sorted"],
         "max_abs_err": up["sorted"]["max_abs_err"],
         **{k: up["sorted"][k] for k in UPDATE_KEYS}, "library_ms": None},
        {"name": "table_update_dense", "route": "cuda",
         "source": "rankfm_tpu_torch/csrc/table_update.cu",
         "replaces": "rankfm_tpu/ops/scatter.py:61",
         "launches": total["table_update_dense"],
         "mesh_launches": mesh_counts["table_update_dense"],
         "max_abs_err": up["dense"]["max_abs_err"],
         **{k: up["dense"][k] for k in UPDATE_KEYS}, "library_ms": None},
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only-updates", action="store_true",
                    help="phases 1, 2 and 4 only; prints no result line")
    ap.add_argument("--only-host-half", action="store_true",
                    help="phases 1, 2 and 10 only; prints no result line")
    ap.add_argument("--only-quality", action="store_true",
                    help="phases 1, 2 and 12 only; prints no result line")
    ap.add_argument("--only-mesh", action="store_true",
                    help="phases 1, 2, 5 (the single-device reference) and "
                         "11 only; prints no result line")
    ap.add_argument("--profiler-windows", type=int, metavar="N",
                    help="phases 1 and 2, then N short torch.profiler "
                         "windows with and N without the idle margin; "
                         "prints no result line")
    ap.add_argument("--parent", metavar="DIR",
                    help="also measure the tree of this repository in DIR "
                         "(an unpacked `git archive` of the parent commit) "
                         "before and after this one, and print both")
    ap.add_argument("--times-of", metavar="DIR",
                    help="phases 3, 4, 5, 6 and 9 of the tree in DIR; prints "
                         "their times as one JSON line and no result line")
    ap.add_argument("--only-repro", action="store_true",
                    help="phases 1, 2 and 13 only; prints no result line")
    ap.add_argument("--deterministic-fits", action="store_true",
                    help="one fit of each engine under "
                         "torch.use_deterministic_algorithms(True) (phase 13 "
                         "runs it in a process of its own); prints no result "
                         "line")
    args = ap.parse_args()
    try:
        return run(args)
    except SmokeFailure as e:
        print(f"chip_smoke: FAIL: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
