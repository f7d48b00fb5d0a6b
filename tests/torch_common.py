"""Shared pieces of the port's tests on the CPU: one torch thread per test;
the C++ sequential oracle's quality band with its data (600 users x 2,500
items, 10 epochs; +-0.05 hit rate and DCG, +-0.03 precision and recall,
the band of
`tests/test_torch_slice.py::test_fit_quality_matches_sequential_oracle`);
for the chunk step against the JAX package's Pallas kernel, the
interpret-mode fixture and the forced-negative batch; and `run_ring`, which
runs a function of this module on several gloo ranks.

This module imports no JAX at its top (the JAX pieces import it where they
are used): the ranks of `run_ring` import it, and they run the port alone.
"""

import contextlib
import os
import pickle
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]

METRICS = ("hit_rate", "reciprocal_rank", "discounted_cumulative_gain",
           "precision", "recall")
GATE = {"hit_rate": 0.05, "discounted_cumulative_gain": 0.05,
        "precision": 0.03, "recall": 0.03}
CFG = dict(factors=16, loss="warp", max_samples=10,
           learning_schedule="invscaling")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """The plain versions run thousands of small ops per epoch; with
    several test processes on the machine, torch's intra-op thread pools
    oversubscribe the cores and their barriers spin (two fused fits side by
    side took over ten times as long). One thread per test keeps each
    process to one core."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data_and_oracle():
    """``(train, test, oracle metrics)`` of the latent 600 x 2,500 log."""
    from rankfm_tpu import RankFM as JaxRankFM
    from rankfm_tpu import native
    from parity_common import make_latent_dataset, oracle_metrics

    if native.get_oracle() is None:
        pytest.skip("no C++ toolchain for the sequential oracle")
    rng = np.random.default_rng(1492)
    train, test = make_latent_dataset(rng, n_users=600, n_items=2500,
                                      sharp=2.0)
    return train, test, oracle_metrics(JaxRankFM(**CFG), train, test,
                                       epochs=10)


def assert_in_band(got, want):
    deltas = {m: got[m] - want[m] for m in METRICS}
    print("port - oracle:", deltas)
    for m, tol in GATE.items():
        assert abs(deltas[m]) <= tol, (m, deltas)


@pytest.fixture
def pallas_interpret(monkeypatch):
    """Run Pallas TPU kernels in interpret mode on the CPU."""
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import tpu as pltpu

    orig = pl.pallas_call

    def interpret_call(*args, **kwargs):
        kwargs.pop("compiler_params", None)
        kwargs["interpret"] = pltpu.InterpretParams()
        return orig(*args, **kwargs)

    monkeypatch.setattr(pl, "pallas_call", interpret_call)


def rel_err(got, want):
    """max |got - want| relative to the largest entry of ``want``."""
    return float(np.max(np.abs(got - want))
                 / max(np.max(np.abs(want)), 1e-12))


# the forced-negative batch: 3 user blocks of 256 (U_pad 768) x a 3-block
# catalog (BLK 1024, I_pad 3072); (U, I, F, UB, C, nT)
FORCED_SHAPE = (700, 2500, 8, 256, 128, 4)
# per chunk: (user block, positive block, window block); chunk 1 draws its
# positive block as the window
FORCED_CHUNKS = [(0, 0, 1), (1, 2, 2), (2, 1, 0), (0, 2, 1)]


def forced_case(rng, full_history=False):
    """Histories holding all items but one per block (or all of them), a
    batch of nT chunks of C rows (8 guard rows each) and initial tables:
    every row's negative is forced, whatever the random stream."""
    from rankfm_tpu.ops import fused as jfused

    U, I, F, UB, C, NT = FORCED_SHAPE
    BLK = jfused.block_size(I)
    nblk = jfused.item_pad(I) // BLK
    free = np.stack([rng.integers(0, min(BLK, I - b * BLK), U) + b * BLK
                     for b in range(nblk)], 1)                 # [U, nblk]
    hist = np.ones((U, I), bool)
    if not full_history:
        hist[np.arange(U)[:, None], free] = False
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(hist.sum(1))
    flat = np.nonzero(hist)[1].astype(np.int32)
    packed = jfused.pack_history(offsets, flat, U, I)

    rec = np.zeros((NT * C, 2), np.int32)
    for k, (ub_k, ib_k, _) in enumerate(FORCED_CHUNKS):
        n_real = min(UB, U - ub_k * UB)
        for r in range(C - 8):
            u_loc = int(rng.integers(0, n_real))
            u = ub_k * UB + u_loc
            items = np.flatnonzero(hist[u, ib_k * BLK:(ib_k + 1) * BLK])
            i_loc = int(rng.choice(items))
            sw = np.float32(rng.uniform(0.5, 2.0))
            rec[k * C + r, 0] = u_loc | ((i_loc + 1) << 10) | (1 << 21)
            rec[k * C + r, 1] = np.array(sw).view(np.int32)
    blk = np.array([[w] for _, _, w in FORCED_CHUNKS], np.int32)
    ublk = np.array([c[0] for c in FORCED_CHUNKS], np.int32)
    iblk = np.array([c[1] for c in FORCED_CHUNKS], np.int32)
    w_i = rng.normal(0, 0.05, I).astype(np.float32)
    v_u = rng.normal(0, 0.1, (U, F)).astype(np.float32)
    v_i = rng.normal(0, 0.1, (I, F)).astype(np.float32)
    return packed, rec, blk, ublk, iblk, (w_i, v_u, v_i)


# ---------------------------------------------------------------------------
# several ranks on the CPU (gloo)
# ---------------------------------------------------------------------------

RING_TIMEOUT = 240


def _ring_logs(work, world):
    out = []
    for r in range(world):
        log = Path(work) / f"log{r}.txt"
        out.append(f"--- rank {r} ---\n"
                   + (log.read_text() if log.exists() else "(no output)"))
    return "\n".join(out)


def run_ring(body, world, *args, timeout=RING_TIMEOUT):
    """Run ``body(mesh_args..)``, the function of this module named
    ``body``, as ``body(rank, world, *args)`` in ``world`` fresh processes
    joined into one gloo process group (``file://`` rendezvous in a private
    directory, so concurrent test workers never share a port), one torch
    thread each. Returns the ranks' results in rank order.

    Fails when a rank fails (the others are killed at once) or when the
    ring outlives ``timeout`` seconds; either way after draining every
    rank's output into the message."""
    work = tempfile.mkdtemp(prefix="ring-")
    with open(Path(work) / "args.pkl", "wb") as f:
        pickle.dump(args, f)
    env = dict(os.environ, OMP_NUM_THREADS="1",
               PYTHONPATH=os.pathsep.join([str(REPO), str(REPO / "tests")]))
    env.setdefault("GLOO_SOCKET_IFNAME", "lo")
    procs = []
    for r in range(world):
        with open(Path(work) / f"log{r}.txt", "w") as log:
            procs.append(subprocess.Popen(
                [sys.executable, __file__, body, str(r), str(world), work],
                stdout=log, stderr=subprocess.STDOUT, cwd=REPO, env=env))
    deadline = time.time() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break
            if time.time() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    rcs = [p.returncode for p in procs]
    if any(rc != 0 for rc in rcs):
        why = ("timed out after %d s" % timeout if time.time() > deadline
               else f"exit codes {rcs}")
        pytest.fail(f"ring {body} on {world} ranks {why}:\n"
                    + _ring_logs(work, world))
    out = []
    for r in range(world):
        with open(Path(work) / f"result{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


def _rank_main(body, rank, world, work):
    from rankfm_tpu_torch.parallel import init_distributed

    torch.set_num_threads(1)
    init_distributed(init_method=f"file://{work}/rendezvous",
                     world_size=world, rank=rank, backend="gloo")
    with open(Path(work) / "args.pkl", "rb") as f:
        args = pickle.load(f)
    out = globals()[body](rank, world, *args)
    with open(Path(work) / f"result{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    torch.distributed.destroy_process_group()



# ---------------------------------------------------------------------------
# rank bodies (tests/test_torch_parallel.py, tests/test_torch_tp.py)
# ---------------------------------------------------------------------------

def counting_batch_fn(chunk, num_users, num_items):
    """Stand-in for `fused_batch` (same signature): adds each VALID record's
    visit to column 0 of its user and item rows (the guard row takes the
    invalid ones), one visit per valid row to cell [0, 0] of the feature
    tables (two to ``tab_if``'s), and returns the count of valid rows as
    the log-likelihood. Additive, so a delta merge must make the epoch
    totals exact whatever the split and the sync cadence."""
    from rankfm_tpu_torch.ops import fused

    BLK = fused.block_size(num_items)

    def fn(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg, *,
           factors, max_samples, ub_rows, num_items, x_uf=None, x_if=None,
           tab_uf=None, tab_if=None):
        u_loc, i1, v = fused.unpack_record_cols(rec[:, 0])
        valid = v.to(torch.float32)
        u_abs = ublk.long().repeat_interleave(chunk) * ub_rows + u_loc
        i_blk = iblk.long().repeat_interleave(chunk) * BLK
        i_abs = torch.where(i1 > 0, i_blk + i1 - 1, tab_i.shape[0] - 1)
        tab_u[:, 0].index_add_(0, u_abs.long(), valid)
        tab_i[:, 0].index_add_(0, i_abs.long(), valid)
        if tab_uf is not None:
            tab_uf[0, 0] += valid.sum()
        if tab_if is not None:
            tab_if[0, 0] += 2.0 * valid.sum()
        return valid.sum()

    return fn


def _unit_draws(key, B):
    """``B`` uniforms in [0, 1) under a batch's key."""
    from rankfm_tpu_torch.ops import _philox

    return _philox.to_unit(_philox.bits(key, _philox.STREAM_STEP, B))


def counting_step():
    """Stand-in for an XLA `TrainStep`: one uniform per row drawn, then each
    valid row's visit added to column 0 of its user and item rows; the
    log-likelihood is the count of valid rows."""
    from rankfm_tpu_torch.ops.training import TrainStep

    def draw(key, B):
        return _unit_draws(key, B)

    def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, draws):
        v = valid.to(torch.float32)
        w["v_u"][:, 0].index_add_(0, u, v)
        w["v_i"][:, 0].index_add_(0, i, v)
        return w, v.sum()

    return TrainStep(draw, apply)


def count_layout(rng, U, I, n, bs, n_dev):
    """``(u, i, layout with the split chunk order, chunk)`` of ``n`` random
    interactions at global batch ``bs``."""
    from rankfm_tpu_torch.ops import fused

    u = rng.integers(0, U, n).astype(np.int32)
    i = rng.integers(0, I, n).astype(np.int32)
    chunk = fused.pick_chunk(bs // n_dev, U, I, n)
    rec, group, cids, ublk, iblk = fused.make_records_grouped(
        u, i, np.ones(n, np.float32), U, I, bs, chunk)
    layout = (torch.from_numpy(rec), torch.from_numpy(group),
              *fused.split_layout_for_mesh(cids, ublk, iblk, n_dev))
    return u, i, layout, chunk


def fused_counts(mesh, U, I, n, bs, sync_every, epochs, features, seed):
    """Column 0 of the merged tables and the ll after each epoch of
    `make_fused_dp_epoch_fn` with `counting_batch_fn`, from zero tables."""
    from rankfm_tpu_torch.ops import fused
    from rankfm_tpu_torch.parallel.fused import make_fused_dp_epoch_fn

    rng = np.random.default_rng(seed)
    u, i, layout, chunk = count_layout(rng, U, I, n, bs, mesh.size)
    fn = make_fused_dp_epoch_fn(mesh, U, I, 8, 1, bs, chunk,
                                sync_every=sync_every,
                                batch_fn=counting_batch_fn(chunk, U, I))
    packed = torch.zeros((U, fused.item_pad(I) // 16), dtype=torch.int32)
    out = []
    for epoch in epochs:
        tab_u = torch.zeros((fused.user_pad(U), 10))
        tab_i = torch.zeros((fused.item_pad(I), 10))
        feats = {}
        if features:
            feats = dict(x_uf=torch.zeros((fused.user_pad(U), 3)),
                         x_if=torch.zeros((fused.item_pad(I), 2)),
                         tab_uf=torch.zeros((3, 10)),
                         tab_if=torch.zeros((2, 10)), beta=0.05)
        ll = fn(tab_u, tab_i, packed, layout, 0.1, 0.01, 1492, epoch,
                **feats)
        out.append(dict(u=u, i=i, tab_u=tab_u[:, 0].numpy().copy(),
                        tab_i=tab_i[:, 0].numpy().copy(), ll=float(ll),
                        uf=float(feats["tab_uf"][0, 0]) if features else 0.0,
                        if_=float(feats["tab_if"][0, 0]) if features else 0.0))
    return out


def xla_counts(mesh, U, I, n, bs, sync_every, seed):
    """Column 0 of the merged tables and the ll of one `dp_epoch_body`
    epoch of `counting_step`, from zero tables."""
    from rankfm_tpu_torch.parallel.train import dp_epoch_body

    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.integers(0, U, n))
    i = torch.from_numpy(rng.integers(0, I, n))
    n_pad = -(-n // bs) * bs
    cols = [torch.zeros(n_pad, dtype=torch.int64) for _ in range(2)]
    cols[0][:n], cols[1][:n] = u, i
    sw = torch.zeros(n_pad)
    w = {"v_u": torch.zeros((U, 4)), "v_i": torch.zeros((I, 4))}
    fn = dp_epoch_body(counting_step(), bs, mesh, sync_every)
    mesh.trace = []
    w, ll = fn(w, None, None, None, cols[0], cols[1], sw, n, 0.1, 0.01, 0.1,
               7, 0)
    stats = mesh.collective_stats()
    mesh.trace = None
    return dict(u=u.numpy(), i=i.numpy(), v_u=w["v_u"][:, 0].numpy().copy(),
                v_i=w["v_i"][:, 0].numpy().copy(), ll=float(ll),
                merges=stats[("delta_merge", "world")][:2],
                ll_reduces=stats[("epoch_ll", "world")][0])


def xla_problem(seed, U=200, I=300, n=3000, F=8, dyadic=False):
    """A random history, its CSR and blocked pack, padded columns and
    initial weights, for the XLA epochs: ``(cols, w, x_uf, x_if, hist,
    packed, mrl, n)``, all numpy. ``dyadic`` puts the weights on a 1/64
    grid, where the JAX package's bf16 scoring is exact."""
    from rankfm_tpu_torch.ops import fused

    rng = np.random.default_rng(seed)
    pairs = np.unique(np.stack([rng.integers(0, U, n),
                                rng.integers(0, I, n)], 1), axis=0)
    rng.shuffle(pairs)
    n = len(pairs)
    counts = np.bincount(pairs[:, 0], minlength=U)
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(counts)
    flat = pairs[np.lexsort((pairs[:, 1], pairs[:, 0])), 1].astype(np.int32)
    shapes = {"w_i": (I,), "w_if": (2,), "v_u": (U, F), "v_i": (I, F),
              "v_uf": (3, F), "v_if": (2, F)}
    if dyadic:
        k = {"w_i": 4, "w_if": 4, "v_u": 16, "v_i": 16, "v_uf": 8, "v_if": 8}
        w = {name: (rng.integers(-k[name], k[name] + 1, shape) / 64).astype(
            np.float32) for name, shape in shapes.items()}
    else:
        sd = {"w_i": 0.05, "w_if": 0.05, "v_u": 0.1, "v_i": 0.1,
              "v_uf": 0.05, "v_if": 0.05}
        w = {name: rng.normal(0, sd[name], shape).astype(np.float32)
             for name, shape in shapes.items()}
    x_uf = (rng.random((U, 3)) < 0.3).astype(np.float32)
    x_if = (rng.random((I, 2)) < 0.3).astype(np.float32)
    return dict(pairs=pairs, w=w, x_uf=x_uf, x_if=x_if, offsets=offsets,
                flat=flat, packed=fused.pack_history(offsets, flat, U, I),
                mrl=int(counts.max()), n=n, U=U, I=I)


def xla_columns(prob, bs):
    """Padded ``(u, i, sw)`` tensors of `xla_problem`'s interactions."""
    n = prob["n"]
    n_pad = -(-n // bs) * bs
    u = torch.zeros(n_pad, dtype=torch.int64)
    i = torch.zeros(n_pad, dtype=torch.int64)
    sw = torch.zeros(n_pad)
    u[:n] = torch.from_numpy(prob["pairs"][:, 0])
    i[:n] = torch.from_numpy(prob["pairs"][:, 1])
    sw[:n] = 1.0
    return u, i, sw


def xla_epochs(mesh, kind, prob, bs, epochs, sync_every=1, features=False):
    """The weights (numpy) and lls after ``epochs`` data-parallel XLA epochs
    of ``kind`` ('window' / 'candidate') on `xla_problem` ``prob``."""
    from rankfm_tpu_torch.parallel.train import make_sharded_epoch_fn

    I = prob["I"]
    w = {k: torch.from_numpy(v.copy()) for k, v in prob["w"].items()}
    if features:
        x_uf, x_if = (torch.from_numpy(prob[k]) for k in ("x_uf", "x_if"))
    else:
        x_uf = torch.zeros((prob["U"], 3))
        x_if = torch.zeros((I, 2))
    fn = make_sharded_epoch_fn(mesh, I, 4, features, features, bs,
                               sample_rounds=3, sampler="bsearch",
                               step_kind=kind, dp_sync_every=sync_every)
    hist = (torch.from_numpy(prob["packed"]) if kind == "window" else
            {"offsets": torch.from_numpy(prob["offsets"]),
             "flat": torch.from_numpy(prob["flat"]),
             "bitmap": torch.zeros((1, 1), dtype=torch.int32)})
    u, i, sw = xla_columns(prob, bs)
    lls = []
    for epoch in epochs:
        w, ll = fn(w, x_uf, x_if, hist, u, i, sw, prob["n"], 0.1, 0.01, 0.1,
                   1492, epoch)
        lls.append(float(ll))
    return {k: v.numpy().copy() for k, v in w.items()}, lls


# ---------------------------------------------------------------------------
# the JAX package's permutation and draws, fed to the port's epochs
# ---------------------------------------------------------------------------

# the epochs held against the JAX package: ``prob`` names the problem
# (`JAX_PROBLEMS`); a dyadic problem runs one batch (the JAX steps score
# the windows in bf16, exact on the 1/64 grid until the first update)
JAX_PROBLEMS = {"normal": dict(seed=21),
                "dyadic": dict(seed=31, n=500, dyadic=True)}
TP_JAX_CASES = {
    "candidate-features": dict(kind="candidate", bs=256, prob="normal",
                               epochs=[0, 1]),
    "window-features": dict(kind="window", bs=512, prob="dyadic",
                            epochs=[0]),
}
DP_JAX_CASES = {kind: dict(kind=kind, bs=512, prob="dyadic", epochs=[0])
                for kind in ("window", "candidate")}
JAX_SEED, JAX_M, JAX_ROUNDS = 1492, 4, 3


def jax_step_draws(key, kind, B, I, model=1):
    """The draws a JAX step makes from ``key`` for ``B`` rows, in the
    port's layout: the candidate sampler's ``[rounds + 1, B, M]`` sets, or
    the window step's ``(blocks [G], u01 [G, Bg, BLK], r1 [G, Bg])``; with
    ``model > 1`` dividing ``G``, the TP window step's uniforms, which each
    ``model`` rank draws for its own groups from the key folded with its
    index."""
    import jax
    import jax.numpy as jnp

    from rankfm_tpu.ops import fused as jfused
    from rankfm_tpu.ops.training import pick_window_groups

    if kind == "candidate":
        keys = jax.random.split(key, JAX_ROUNDS + 1)
        ks = [keys[0]] + [jax.random.fold_in(keys[1], r)
                          for r in range(JAX_ROUNDS)]
        return np.stack([np.asarray(jax.random.randint(
            k, (B, JAX_M), 0, I, dtype=jnp.int32)) for k in ks])
    G = pick_window_groups(B)
    BLK = jfused.block_size(I)
    kblk, kcand, kgeo = jax.random.split(key, 3)
    split = model > 1 and G % model == 0
    parts = range(model) if split else [None]
    Gs = G // len(parts)

    def unif(k, shape):
        return np.asarray(jax.random.uniform(k, shape, minval=1e-7,
                                             maxval=1.0))

    def fold(k, m):
        return k if m is None else jax.random.fold_in(k, m)

    return (np.asarray(jfused.draw_window_blocks(kblk, (G,), I)),
            np.concatenate([unif(fold(kcand, m), (Gs, B // G, BLK))
                            for m in parts]),
            np.concatenate([unif(fold(kgeo, m), (Gs, B // G))
                            for m in parts]))


def jax_feed(case, data, model=1, dp=False):
    """Per batch of ``case``'s epochs, in order: per ``data`` rank, its
    rows ``(u, i, sw, valid)`` and its draws, as the JAX package's TP epoch
    (`rankfm_tpu.parallel.tp.make_tp_epoch_fn`) or, ``dp``, its DP epoch
    (`_cached_dp_epoch`, one batch per sync group) makes them from
    ``PRNGKey(JAX_SEED)``."""
    import jax

    prob = xla_problem(**JAX_PROBLEMS[case["prob"]])
    bs = case["bs"]
    u, i, sw = (a.numpy() for a in xla_columns(prob, bs))
    n_pad, Bd = len(u), bs // data
    key = jax.random.PRNGKey(JAX_SEED)
    feed = []
    for epoch in case["epochs"]:
        kperm, ksamp = jax.random.split(jax.random.fold_in(key, epoch))
        perm = np.asarray(jax.random.permutation(kperm, n_pad))
        for t in range(n_pad // bs):
            per = []
            for d in range(data):
                r = perm[t * bs + d * Bd:t * bs + (d + 1) * Bd]
                k = jax.random.fold_in(ksamp, t)
                if dp:   # the device's fold, then local step 0 of the group
                    k = jax.random.fold_in(jax.random.fold_in(k, d), 0)
                elif data > 1:
                    k = jax.random.fold_in(k, d)
                per.append(((u[r], i[r], sw[r], r < prob["n"]),
                            jax_step_draws(k, case["kind"], Bd, prob["I"],
                                           1 if dp else model)))
            feed.append(per)
    return feed


def jax_epochs(case, data, model=1, dp=False):
    """``(whole weights, lls, problem)`` after ``case``'s epochs of the JAX
    package's TP epoch (`rankfm_tpu.parallel.tp.tp_epoch_fn`) or, ``dp``,
    its DP epoch (`make_sharded_epoch_fn(dp=True)`) on a ``(data, model)``
    slice of its CPU mesh, with side features."""
    import jax
    import jax.numpy as jnp

    from rankfm_tpu.parallel import tp as jtp
    from rankfm_tpu.parallel.mesh import make_mesh as jax_make_mesh
    from rankfm_tpu.parallel.train import make_sharded_epoch_fn

    prob = xla_problem(**JAX_PROBLEMS[case["prob"]])
    U, I, kind, bs = prob["U"], prob["I"], case["kind"], case["bs"]
    mesh = jax_make_mesh(data=data, model=model,
                         devices=jax.devices()[:data * model])
    csr = {"offsets": jnp.asarray(prob["offsets"]),
           "flat": jnp.asarray(prob["flat"]),
           "bitmap": jnp.zeros((1, 1), jnp.uint32)}
    if dp:
        w = {k: jnp.asarray(v) for k, v in prob["w"].items()}
        x_uf, x_if = jnp.asarray(prob["x_uf"]), jnp.asarray(prob["x_if"])
        hist = jnp.asarray(prob["packed"]) if kind == "window" else csr
        fn = make_sharded_epoch_fn(mesh, I, JAX_M, True, True, bs,
                                   sample_rounds=JAX_ROUNDS,
                                   sampler="bsearch", step_kind=kind,
                                   dp=True)
    else:
        w, x_uf, x_if = jtp.pad_and_place(mesh, prob["w"], prob["x_uf"],
                                          prob["x_if"])
        hist = ({"packed": jtp.pad_packed_hist(mesh, prob["packed"], U)}
                if kind == "window" else csr)
        fn = jtp.tp_epoch_fn(mesh, I, JAX_M, True, True, bs, JAX_ROUNDS,
                             prob["mrl"], False, kind)
    u, i, sw = (jnp.asarray(a.numpy().astype(np.float32 if a.is_floating_point()
                                             else np.int32))
                for a in xla_columns(prob, bs))
    lls = []
    for epoch in case["epochs"]:
        w, ll = fn(w, x_uf, x_if, hist, u, i, sw, prob["n"], 0.1, 0.01, 0.1,
                   jax.random.PRNGKey(JAX_SEED), epoch)
        lls.append(float(ll))
    if not dp:
        w = jtp.extract(w, U, I)
    return {k: np.asarray(v) for k, v in w.items()}, lls, prob


def assert_epochs_match_jax(got, got_lls, want, want_lls, w0, tol):
    """Every weight within ``tol`` of the JAX package's, relative to its
    largest entry, and its change from ``w0`` within ``tol`` of the JAX
    change; the same rows moved; the lls within ``tol``."""
    for k in want:
        moved = want[k] - w0[k]
        assert np.abs(moved).max() > 0, k
        assert rel_err(got[k], want[k]) < tol, (k, rel_err(got[k], want[k]))
        assert rel_err(got[k] - w0[k], moved) < tol, (
            k, rel_err(got[k] - w0[k], moved))
        np.testing.assert_array_equal(
            np.abs(got[k] - w0[k]).reshape(len(moved), -1).max(1) > 0,
            np.abs(moved).reshape(len(moved), -1).max(1) > 0, err_msg=k)
    np.testing.assert_allclose(got_lls, want_lls, rtol=tol)


@contextlib.contextmanager
def patched(module, **fns):
    """``module``'s attributes replaced by ``fns`` inside the block."""
    saved = {k: getattr(module, k) for k in fns}
    for k, v in fns.items():
        setattr(module, k, v)
    try:
        yield
    finally:
        for k, v in saved.items():
            setattr(module, k, v)


def fed_builder(build, feed, data_rank, used):
    """A step builder like ``build`` whose steps take each batch's rows and
    draws from ``feed`` (`jax_feed`, this ``data_rank``'s entries, batch
    after batch) instead of the epoch's own; ``used`` counts the batches
    fed. The step's own `apply` runs on them."""
    from rankfm_tpu_torch.ops.training import TrainStep

    def built(*args, **kwargs):
        step = build(*args, **kwargs)
        cur = {}

        def draw(key, B):
            rows, draws = feed[used[0]][data_rank]
            used[0] += 1
            assert len(rows[0]) == B, (len(rows[0]), B)
            cur["rows"] = rows
            if isinstance(draws, tuple):
                return tuple(torch.from_numpy(a) for a in draws)
            return torch.from_numpy(draws)

        def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta,
                  draws):
            uu, ii, ss, vv = (torch.from_numpy(a) for a in cur["rows"])
            return step.apply(w, x_uf, x_if, hist, uu.long(), ii.long(), ss,
                              vv, eta, alpha, beta, draws)

        return TrainStep(draw, apply)

    return built


def tp_fed_epochs(mesh, case, feed):
    """`tp_epochs` of ``case`` with the JAX package's rows and draws
    (`fed_builder`); also the batches fed."""
    from rankfm_tpu_torch.parallel import tp

    used = [0]
    build = {"candidate": "make_tp_train_step",
             "window": "make_tp_window_step"}[case["kind"]]
    with patched(tp, **{build: fed_builder(getattr(tp, build), feed,
                                           mesh.data_rank, used)}):
        out = tp_epochs(mesh, xla_problem(**JAX_PROBLEMS[case["prob"]]),
                        case["kind"], case["bs"], case["epochs"],
                        features=True)
    return out + (used[0],)


def dp_fed_epochs(mesh, case, feed):
    """`xla_epochs` of ``case`` with the JAX package's rows and draws; also
    the batches fed."""
    from rankfm_tpu_torch.ops import training

    used = [0]
    build = {"candidate": "make_train_step",
             "window": "make_window_train_step"}[case["kind"]]
    with patched(training, **{build: fed_builder(getattr(training, build),
                                                 feed, mesh.rank, used)}):
        out = xla_epochs(mesh, case["kind"],
                         xla_problem(**JAX_PROBLEMS[case["prob"]]),
                         case["bs"], case["epochs"], features=True)
    return out + (used[0],)


def jax_feeds(data, model=1, dp=False):
    """The feeds (`jax_feed`) of the TP cases on a ``(data, model)`` ring,
    or, ``dp``, of the DP cases on a ``(data, 1)`` ring."""
    if dp:
        return {f"dp_{k}": jax_feed(c, data, dp=True)
                for k, c in DP_JAX_CASES.items()}
    return {f"tp_{k}": jax_feed(c, data, model)
            for k, c in TP_JAX_CASES.items()}


def tp_visits(mesh, prob, bs, epochs):
    """The rows each batch of `tp.tp_epoch_fn` hands this rank's step, its
    draws, and the epochs' lls, with a step that records them and
    changes nothing (its ll: the count of valid rows)."""
    from rankfm_tpu_torch.ops.training import TrainStep
    from rankfm_tpu_torch.parallel import tp

    seen = []

    def build(*args, **kwargs):
        def draw(key, B):
            return _unit_draws(key, B)

        def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta,
                  draws):
            seen.append((u[valid].numpy().copy(), i[valid].numpy().copy(),
                         draws.numpy().copy()))
            return w, valid.sum().to(torch.float32)

        return TrainStep(draw, apply)

    w, x_uf, x_if = tp_inputs(prob, False)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    u, i, sw = xla_columns(prob, bs)
    lls = []
    with patched(tp, make_tp_train_step=build):
        fn = tp.tp_epoch_fn(mesh, prob["I"], 4, False, False, bs)
        for epoch in epochs:
            w_tp, ll = fn(w_tp, xu_tp, xi_tp, None, u, i, sw, prob["n"], 0.1,
                          0.01, 0.1, 1492, epoch)
            lls.append(float(ll))
    return seen, lls


def two_group_frame(seed, n_users=48, frac=0.75):
    """The two-group log of `tests/test_sharding.py::
    test_model_end_to_end_on_mesh`: ``(train, test)`` frames."""
    import pandas as pd

    rng = np.random.default_rng(seed)
    rows = []
    for u in range(n_users):
        g = u % 2
        for it in rng.choice(np.arange(g * 16, (g + 1) * 16), 8,
                             replace=False):
            rows.append((u, it))
    df = pd.DataFrame(rows, columns=["user_id", "item_id"])
    train = df.sample(frac=frac, random_state=0)
    return train, df.drop(train.index)


E2E_CFG = dict(factors=4, loss="warp", max_samples=4, learning_rate=0.1,
               batch_size=256)
# forced negatives on two ranks: 32 users holding 7 of 8 items (one
# 128-slot window whose pad slots are members: every negative is forced),
# user blocks of 16 users, so the 224 rows make one batch of two chunks,
# each one whole (user block, item block) group: whatever the shuffle, each
# rank's chunk holds the same rows
FORCED_DP = dict(U=32, I=8, F=6, ub=16, batch_size=256, chunk=128,
                 eta=0.2, alpha=0.01, epochs=3)


def forced_dp_problem():
    """``(pairs, packed, layout, (w_i, v_u, v_i))`` of `FORCED_DP`, numpy;
    the layout is `make_records_grouped`'s (one batch of two chunks)."""
    from rankfm_tpu_torch.ops import fused

    c = FORCED_DP
    users = np.repeat(np.arange(c["U"]), 7)
    items = np.concatenate([np.delete(np.arange(c["I"]), u % c["I"])
                            for u in range(c["U"])])
    pairs = np.stack([users, items], 1).astype(np.int32)
    offsets = np.zeros(c["U"] + 1, np.int32)
    offsets[1:] = np.cumsum(np.bincount(users, minlength=c["U"]))
    packed = fused.pack_history(offsets, items.astype(np.int32), c["U"],
                                c["I"])
    layout = fused.make_records_grouped(
        users, items, np.ones(len(users), np.float32), c["U"], c["I"],
        c["batch_size"], c["chunk"], ub=c["ub"])
    assert layout[2].shape == (1, 2), layout[2].shape
    rng = np.random.default_rng(3)
    w = (rng.normal(0, 0.05, c["I"]).astype(np.float32),
         rng.normal(0, 0.1, (c["U"], c["F"])).astype(np.float32),
         rng.normal(0, 0.1, (c["I"], c["F"])).astype(np.float32))
    return pairs, packed, layout, w


def forced_dp_epochs(mesh, M):
    """``(tab_u, tab_i, lls)`` after `FORCED_DP`'s epochs of
    `dp_fused_epoch` on this rank, from `forced_dp_problem`."""
    from rankfm_tpu_torch.ops import fused

    c = FORCED_DP
    _, packed, layout, (w_i, v_u, v_i) = forced_dp_problem()
    rec, group, cids, ublk, iblk = (torch.from_numpy(a) for a in layout)
    split = (rec, group) + fused.split_layout_for_mesh(cids, ublk, iblk,
                                                       mesh.size)
    tab_u, tab_i = fused.extend_tables(
        torch.from_numpy(w_i), torch.from_numpy(v_u), torch.from_numpy(v_i),
        fused.user_pad(c["U"], c["ub"]), fused.item_pad(c["I"]))
    lls = []
    for epoch in range(c["epochs"]):
        lls.append(float(fused.dp_fused_epoch(
            tab_u, tab_i, torch.from_numpy(packed), split, c["eta"],
            c["alpha"], 1492, epoch, mesh=mesh, num_users=c["U"],
            num_items=c["I"], factors=c["F"], max_samples=M,
            batch_size=c["batch_size"], chunk=c["chunk"], ub=c["ub"])))
    return tab_u.numpy(), tab_i.numpy(), lls


def ring_dp(rank, world, feeds):
    """Every data-parallel check of tests/test_torch_parallel.py on this
    rank of a ``(world, 1)`` mesh; ``feeds`` are `jax_feeds`'."""
    from rankfm_tpu_torch import RankFM, evaluation
    from rankfm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=world, device="cpu")
    out = {"rank": mesh.rank, "shape": mesh.shape}
    for k in (1, 4):
        out[f"fused_counts_sync{k}"] = fused_counts(
            mesh, 500, 300, 3000, 1024, k, [0], False, 3)
    out["fused_counts_epochs"] = fused_counts(mesh, 64, 96, 800, 1024, 1,
                                              [0, 1, 7], False, 5)
    out["fused_counts_features"] = fused_counts(mesh, 200, 150, 1500, 1024,
                                                1, [0], True, 7)
    for k in (1, 3, 1000):
        out[f"xla_counts_sync{k}"] = xla_counts(mesh, 50, 70, 1000, 64, k, 9)
    prob = xla_problem(11)
    for kind in ("window", "candidate"):
        out[f"xla_{kind}"] = xla_epochs(mesh, kind, prob, 256, [0, 1, 2])
    out["xla_window_sync1000"] = xla_epochs(mesh, "window", prob, 256, [0],
                                            sync_every=1000)

    train, test = two_group_frame(5)
    m = RankFM(**E2E_CFG, mesh=mesh).fit(train, epochs=8)
    recs = m.recommend(np.arange(48), n_items=4, filter_previous=True)
    out["e2e"] = dict(plan=m.last_fit_plan_, predict=m.predict(train.head(10)),
                      recs=recs.values, hr=evaluation.hit_rate(m, test, k=8),
                      weights=m._weights)
    for M in (1, 5):
        out[f"forced_M{M}"] = forced_dp_epochs(mesh, M)
    for k, case in DP_JAX_CASES.items():
        out[f"dp_jax_{k}"] = dp_fed_epochs(mesh, case, feeds[f"dp_{k}"])
    return out


def tp_inputs(prob, features):
    """``(w, x_uf, x_if)`` tensors of `xla_problem` ``prob``, the feature
    matrices zero without ``features``."""
    w = {k: torch.from_numpy(v.copy()) for k, v in prob["w"].items()}
    if features:
        return (w, torch.from_numpy(prob["x_uf"]),
                torch.from_numpy(prob["x_if"]))
    return w, torch.zeros((prob["U"], 3)), torch.zeros((prob["I"], 2))


def tp_epochs(mesh, prob, kind, bs, epochs, features=False,
              post_reject=False):
    """The whole weights (numpy), the lls and the largest entry of the
    shards' pad rows after TP epochs of ``kind`` on `xla_problem`
    ``prob``."""
    from rankfm_tpu_torch.parallel import tp

    U, I = prob["U"], prob["I"]
    w, x_uf, x_if = tp_inputs(prob, features)
    w_tp, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    if kind == "window":
        hist = {"packed": tp.pad_packed_hist(
            mesh, torch.from_numpy(prob["packed"]), U)}
    else:
        hist = {"offsets": torch.from_numpy(prob["offsets"]),
                "flat": torch.from_numpy(prob["flat"])}
    fn = tp.tp_epoch_fn(mesh, I, 4, features, features, bs, sample_rounds=3,
                        max_row_len=prob["mrl"], post_reject=post_reject,
                        step_kind=kind)
    u, i, sw = xla_columns(prob, bs)
    lls = []
    for epoch in epochs:
        w_tp, ll = fn(w_tp, xu_tp, xi_tp, hist, u, i, sw, prob["n"], 0.1,
                      0.01, 0.1, 1492, epoch)
        lls.append(float(ll))
    R_i, R_u = w_tp["v_i"].shape[0], w_tp["v_u"].shape[0]
    lo_i, lo_u = mesh.model_rank * R_i, mesh.model_rank * R_u
    pad = max(float(w_tp["v_i"][max(0, I - lo_i):].abs().sum()),
              float(w_tp["w_i"][max(0, I - lo_i):].abs().sum()),
              float(w_tp["v_u"][max(0, U - lo_u):].abs().sum()))
    full = tp.extract(mesh, w_tp, U, I)
    return {k: v.numpy().copy() for k, v in full.items()}, lls, pad


TP_CASES = {
    "candidate": dict(kind="candidate", bs=256),
    "candidate-post-reject": dict(kind="candidate", bs=256,
                                  post_reject=True),
    "candidate-features": dict(kind="candidate", bs=256, features=True),
    "window": dict(kind="window", bs=256),
    "window-split": dict(kind="window", bs=512),
    "window-features": dict(kind="window", bs=256, features=True),
}


def sharded_lists(mesh, prob, users, n, filtered, sharded):
    """`retrieval.sharded_topk`'s top-``n`` items of ``users`` from
    `xla_problem` ``prob``'s weights (with its features), the tables whole
    on every rank or (``sharded``) this rank's `tp.pad_and_place` shards."""
    from rankfm_tpu_torch.parallel import retrieval, tp
    from rankfm_tpu_torch.utils.data import csr_row_pairs

    w, x_uf, x_if = tp_inputs(prob, True)
    if sharded:
        w = tp.pad_and_place(mesh, w, x_uf, x_if)[0]
    rows = cols = torch.zeros(0, dtype=torch.int64)
    if filtered:
        r, c = csr_row_pairs(prob["offsets"], prob["flat"], users)
        rows, cols = torch.from_numpy(r.astype(np.int64)), \
            torch.from_numpy(c.astype(np.int64))
    i_mat, ib = retrieval.item_operands(mesh, w, x_if, prob["I"], sharded)
    u_mat = retrieval.user_operands(mesh, w, x_uf, torch.from_numpy(users),
                                    sharded)
    idx, vals = retrieval.sharded_topk(mesh, u_mat, i_mat, ib, rows, cols, n)
    return idx.numpy(), vals.numpy()


def ring_tp(rank, world):
    """The table-parallel checks of tests/test_torch_tp.py on this rank of
    a ``(1, world)`` mesh."""
    import tempfile as _tempfile

    import pandas as pd

    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch.parallel import make_mesh
    from rankfm_tpu_torch.parallel import train as ptrain

    mesh = make_mesh(data=1, model=world, device="cpu")
    out = {"shape": mesh.shape}
    prob = xla_problem(21)
    for name, case in TP_CASES.items():
        out[name] = tp_epochs(mesh, prob, epochs=[0, 1], **case)
    users = np.arange(0, prob["U"], 5)
    for filtered in (False, True):
        for sharded in (False, True):
            out[f"topk_{filtered}_{sharded}"] = sharded_lists(
                mesh, prob, users, 10, filtered, sharded)

    # past the data-parallel budget the planner places the weights
    # table-parallel; the model keeps its shards
    ptrain.DP_TABLE_BYTES = 0
    frame = pd.DataFrame(prob["pairs"], columns=["user_id", "item_id"])
    m = RankFM(factors=8, loss="warp", max_samples=4, use_fused=False,
               mesh=mesh).fit(frame, epochs=2)
    recs = m.recommend(users, n_items=10, filter_previous=True)
    path = Path(_tempfile.mkdtemp()) / f"tp{rank}.npz"
    m.save(path)
    single = RankFM.load(path, device="cpu")
    colls = {}

    def traced(name, fn):
        mesh.trace = []
        res = fn()
        colls[name] = {k: v[0] for k, v in mesh.collective_stats().items()}
        mesh.trace = None
        return res

    item = frame["item_id"].iloc[0]
    try:
        m._w
        hidden_gather = True
    except RuntimeError:
        hidden_gather = False
    out["model"] = dict(
        plan=m.last_fit_plan_, shard_rows=m._w_tp["v_i"].shape[0],
        recs=recs.values, single_recs=single.recommend(
            users, n_items=10, filter_previous=True).values,
        predict=traced("predict", lambda: m.predict(frame.head(20))),
        single_predict=single.predict(frame.head(20)),
        similar=traced("similar", lambda: m.similar_items(item, 5)),
        single_similar=single.similar_items(item, 5),
        weights=m._weights, collectives=colls, hidden_gather=hidden_gather,
        lls=[r["log_likelihood"] for r in m.training_log_])
    # the window step on the shards, verbose: each epoch's report gathers
    # the tables on every rank
    mw = RankFM(factors=8, loss="warp", max_samples=4, use_fused=False,
                train_step="window", mesh=mesh).fit(frame, epochs=2,
                                                    verbose=True)
    single = RankFM(factors=8, loss="warp", max_samples=4, device="cpu")
    single._init_all(frame)
    single._weights = mw._weights
    single.is_fit = True
    out["model_window"] = dict(
        plan=mw.last_fit_plan_, weights=mw._weights,
        recs=mw.recommend(users, n_items=10, filter_previous=True).values,
        single_recs=single.recommend(users, n_items=10,
                                     filter_previous=True).values,
        lls=[r["log_likelihood"] for r in mw.training_log_])
    return out


def ring_tp_fed(rank, world, feeds):
    """The TP epochs of `TP_JAX_CASES` on this rank of a ``(world, 1)``
    mesh, the JAX package's rows and draws fed (``feeds``: `jax_feeds`')."""
    from rankfm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=world, model=1, device="cpu")
    return {k: tp_fed_epochs(mesh, case, feeds[f"tp_{k}"])
            for k, case in TP_JAX_CASES.items()}


def ring_tp_2x2(rank, world, feeds):
    """Table-parallel epochs on this rank of a (2, 2) mesh: the port's own,
    the JAX package's rows and draws fed (``feeds``: `jax_feeds`'), and the
    rows each step is handed."""
    from rankfm_tpu_torch.parallel import make_mesh

    mesh = make_mesh(data=2, model=2, device="cpu")
    prob = xla_problem(8)
    out = {"coords": (mesh.data_rank, mesh.model_rank),
           **{kind: tp_epochs(mesh, prob, kind, 512, range(6))
              for kind in ("window", "candidate")}}
    for k, case in TP_JAX_CASES.items():
        out[f"tp_jax_{k}"] = tp_fed_epochs(mesh, case, feeds[f"tp_{k}"])
    out["visits"] = tp_visits(mesh, prob, 512, [0, 1])
    return out


def ring_fit_features(rank, world):
    """The checks of tests/test_torch_fit_features.py on this rank: the
    row-sharded step and epoch of `parallel.train` on a ``(1, world)``
    mesh against the single-device step and `tp.tp_epoch_fn`, then the
    wide-window tail of a fused fit on a ``(world, 1)`` data-parallel
    mesh."""
    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch.ops import fused, training
    from rankfm_tpu_torch.parallel import make_mesh, tp
    from rankfm_tpu_torch.parallel import train as ptrain

    out = {}
    mesh = make_mesh(data=1, model=world, device="cpu")
    prob = xla_problem(21)
    U, I, B = prob["U"], prob["I"], 256
    w, x_uf, x_if = tp_inputs(prob, True)
    hist = {"offsets": torch.from_numpy(prob["offsets"]),
            "flat": torch.from_numpy(prob["flat"])}
    u, i, sw = xla_columns(prob, B)
    valid = torch.ones(B, dtype=torch.bool)
    single = training.make_train_step(I, 4, True, True, 3, "bsearch")
    draws = single.draw(fused.epoch_key(5, 0), B)
    w1, ll1 = single.apply({k: v.clone() for k, v in w.items()}, x_uf, x_if,
                           hist, u[:B], i[:B], sw[:B], valid, 0.1, 0.01,
                           0.1, draws)
    step = ptrain.sharded_train_step(mesh, I, 4, True, True, 3)
    _, xu_tp, xi_tp = tp.pad_and_place(mesh, w, x_uf, x_if)
    w_tp, ll = step.apply(ptrain.place_weights(mesh, w), xu_tp, xi_tp, hist,
                          u[:B], i[:B], sw[:B], valid, 0.1, 0.01, 0.1, draws)
    out["step"] = dict(
        single={k: v.numpy().copy() for k, v in w1.items()},
        sharded={k: v.numpy().copy()
                 for k, v in tp.extract(mesh, w_tp, U, I).items()},
        ll=float(ll), single_ll=float(ll1))

    def epoch(fn):
        wt, ll = fn(ptrain.place_weights(mesh, w), xu_tp, xi_tp, hist, u, i,
                    sw, prob["n"], 0.1, 0.01, 0.1, 1492, 0)
        return {k: v.numpy().copy() for k, v in wt.items()}, float(ll)

    args = (mesh, I, 4, True, True, B, 3)
    out["epoch"] = dict(
        tp=epoch(tp.tp_epoch_fn(*args, step_kind="candidate")),
        forced=epoch(ptrain.make_sharded_epoch_fn(
            *args, step_kind="candidate", dp=False)),
        by_bytes=epoch(ptrain.make_sharded_epoch_fn(
            *args, step_kind="candidate",
            table_bytes=ptrain.DP_TABLE_BYTES + 1)),
        dp_is_dp=ptrain.make_sharded_epoch_fn(
            *args, step_kind="candidate", dp=True).__qualname__.startswith(
                "dp_epoch_body"))

    # the wide tail on the data-parallel mesh: the window count of every
    # fused epoch and of every batch in it, and the table updates
    dmesh = make_mesh(data=world, model=1, device="cpu")
    nw_by_epoch, batch_nws, n_updates = [], [], [0]
    dp_epoch, batch, update = (fused.dp_fused_epoch, fused.fused_batch,
                               training.apply_table_update)

    def spy_epoch(*a, **kw):
        nblk = fused.item_pad(kw["num_items"]) // fused.block_size(
            kw["num_items"])
        nw_by_epoch.append(kw["n_windows"] or fused.default_n_windows(nblk))
        return dp_epoch(*a, **kw)

    def spy_batch(*a, **kw):
        batch_nws.append(a[4].shape[1])
        return batch(*a, **kw)

    def spy_update(*a, **kw):
        n_updates[0] += 1
        return update(*a, **kw)

    rng = np.random.default_rng(9)
    train = np.stack([np.repeat(np.arange(300), 20),
                      rng.integers(0, 2500, 6000)], 1)       # 3 blocks
    with patched(fused, dp_fused_epoch=spy_epoch, fused_batch=spy_batch), \
            patched(training, apply_table_update=spy_update):
        m = RankFM(factors=8, loss="warp", max_samples=5, train_step="mixed",
                   tail_windows=3, mesh=dmesh).fit(train, epochs=6)
    out["wide_tail"] = dict(plan=m.last_fit_plan_, nw_by_epoch=nw_by_epoch,
                            batch_nws=sorted(set(batch_nws)),
                            table_updates=n_updates[0], weights=m._weights)
    return out


if __name__ == "__main__":
    _rank_main(sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
