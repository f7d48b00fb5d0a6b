"""`examples/webscale_smoke.py` on the PyTorch + CUDA port: 100k users x
1M items x 5M interactions on ONE NVIDIA GPU.

The reference (single-core Cython) cannot realistically touch this regime.
This exercises the large-catalog machinery end to end: candidate-step
training with post-hoc CSR membership rejection (the catalog is too big
for a word bitmap), the sorted table-update kernel, and chunked
million-item retrieval.

Run from the repository root: PYTHONPATH=. python examples/torch/webscale_smoke.py
"""

import time

import numpy as np

from rankfm_tpu_torch import RankFM

N_USERS, N_ITEMS, N_INTER = 100_000, 1_000_000, 5_000_000
DEVICE = "cuda"


def main():
    rng = np.random.default_rng(3)
    t0 = time.time()
    users = rng.integers(0, N_USERS, N_INTER)
    items = (N_ITEMS * rng.random(N_INTER) ** 2.5).astype(np.int64)  # power-law
    inter = np.stack([users, items], 1)
    print(f"data: {len(inter)} pairs, {len(np.unique(items))} distinct items "
          f"({time.time() - t0:.0f}s)")

    model = RankFM(factors=64, loss="warp", max_samples=10, alpha=0.01,
                   learning_rate=0.1, learning_schedule="invscaling",
                   device=DEVICE)
    t0 = time.time()
    model.fit(inter, epochs=1)
    print(f"fit 1 epoch (incl kernel build): {time.time() - t0:.0f}s "
          f"[sampler={model._sampler}, step={model.last_fit_plan_.step_kind}]")
    t0 = time.time()
    model.fit_partial(inter, epochs=3)
    el = time.time() - t0
    n = len(model.interactions)
    print(f"steady 3 epochs: {el:.1f}s -> {n * 3 / el / 1e6:.2f} M interaction-updates/s")

    # the first call pays what a first call costs (allocations, the
    # history's device copies); the second is the steady serving number
    t0 = time.time()
    recs = model.recommend(np.arange(1000), n_items=10, filter_previous=True)
    cold_rec = time.time() - t0
    t0 = time.time()
    recs = model.recommend(np.arange(1000, 2000), n_items=10,
                           filter_previous=True)
    print(f"recommend 1000 users over {len(model.item_idx)} items: "
          f"first={cold_rec:.1f}s steady={time.time() - t0:.1f}s; "
          f"shape={recs.shape}")

    t0 = time.time()
    scores = model.predict(inter[:100_000])
    print(f"predict 100k pairs: {time.time() - t0:.1f}s "
          f"(finite: {np.isfinite(scores).all()})")


if __name__ == "__main__":
    main()
