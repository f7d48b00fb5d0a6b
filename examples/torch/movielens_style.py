"""`examples/movielens_style.py` on the PyTorch + CUDA port: the same
ML-1M-shaped synthetic implicit log (same user/item counts, power-law
popularity, planted taste structure), the same WARP fit and the same five
ranking metrics against a popularity baseline, trained and served by
`rankfm_tpu_torch` on one NVIDIA GPU.

Run from the repository root: PYTHONPATH=. python examples/torch/movielens_style.py
"""

import time

import numpy as np
import pandas as pd

from rankfm_tpu_torch import RankFM, evaluation

DEVICE = "cuda"


def make_ml1m_like(rng, n_users=6040, n_items=3706, n_genres=18):
    """implicit log with genre-structured preferences + popularity skew"""
    item_genre = rng.integers(0, n_genres, n_items)
    item_pop = 1.0 / np.arange(1, n_items + 1) ** 0.9
    rows = []
    for u in range(n_users):
        taste = rng.dirichlet(np.ones(n_genres) * 0.3)
        n_r = int(np.clip(rng.lognormal(4.3, 0.8), 20, 1200))
        genre_w = taste[item_genre]
        p = item_pop * genre_w
        p /= p.sum()
        items = rng.choice(n_items, size=n_r, replace=False, p=p)
        rows.extend((u, it) for it in items)
    return pd.DataFrame(rows, columns=["user_id", "item_id"])


def main():
    rng = np.random.default_rng(1492)
    print("generating ML-1M-shaped synthetic data...")
    df = make_ml1m_like(rng)
    train = df.sample(frac=0.75, random_state=1492)
    valid = df.drop(train.index)
    print(f"train={len(train)} valid={len(valid)}")

    model = RankFM(factors=20, loss="warp", max_samples=20, alpha=0.01,
                   sigma=0.1, learning_rate=0.1,
                   learning_schedule="invscaling", device=DEVICE)
    t0 = time.time()
    model.fit(train, epochs=20, verbose=False)   # returns with the card idle
    fit_s = time.time() - t0
    # steady-state throughput: the kernels are built and the fit-time
    # layout is cached for this frame now
    t0 = time.time()
    model.fit_partial(train, epochs=20)
    steady = time.time() - t0
    print(f"fit: {fit_s:.1f}s incl kernel build; steady 20 epochs "
          f"{steady:.2f}s ({len(train) * 20 / steady / 1e6:.1f}M "
          f"interaction-updates/s; reference: 29.7s on a 2.3 GHz i5)")

    t0 = time.time()
    # one shared retrieval for all five metrics
    metrics = evaluation.compute(model, valid, k=10)
    print(f"eval wall: {time.time() - t0:.1f}s")
    for k, v in metrics.items():
        print(f"  {k}@10 = {v:.3f}")

    # popularity baseline (reference notebook cell 41-42)
    top_pop = train.groupby("item_id").size().nlargest(10).index
    tui = valid.groupby("user_id")["item_id"].apply(set)
    hr_pop = float(np.mean([len(set(top_pop) & s) > 0 for s in tui]))
    print(f"  popularity hit_rate@10 = {hr_pop:.3f}")

    div = evaluation.diversity(model, valid, k=10)
    coverage = (div["cnt_users"] > 0).mean()
    print(f"  item coverage@10 = {coverage:.3f}")


if __name__ == "__main__":
    main()
