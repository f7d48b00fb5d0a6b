"""Shared pieces of the port's whole-fit tests on the CPU: one torch thread
per test, and the C++ sequential oracle's quality band with its data (600
users x 2,500 items, 10 epochs; +-0.05 hit rate and DCG, +-0.03 precision
and recall, the band of
`tests/test_torch_slice.py::test_fit_quality_matches_sequential_oracle`).
"""

import numpy as np
import pytest
import torch

from rankfm_tpu import RankFM as JaxRankFM
from rankfm_tpu import native

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
