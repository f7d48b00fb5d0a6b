"""Shared pieces of the port's tests on the CPU: one torch thread per test;
the C++ sequential oracle's quality band with its data (600 users x 2,500
items, 10 epochs; +-0.05 hit rate and DCG, +-0.03 precision and recall,
the band of
`tests/test_torch_slice.py::test_fit_quality_matches_sequential_oracle`);
and, for the chunk step against the JAX package's Pallas kernel, the
interpret-mode fixture and the forced-negative batch.
"""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu import native
from rankfm_tpu.ops import fused as jfused

from parity_common import make_latent_dataset, oracle_metrics

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
