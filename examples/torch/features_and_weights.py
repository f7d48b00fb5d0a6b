"""`examples/features_and_weights.py` on the PyTorch + CUDA port: repeat
purchases as sample weights + item side features, evaluated with and
without filter_previous, on the same synthetic basket-shaped data, trained
and served by `rankfm_tpu_torch` on one NVIDIA GPU.

Run from the repository root: PYTHONPATH=. python examples/torch/features_and_weights.py
"""

import time

import numpy as np
import pandas as pd

from rankfm_tpu_torch import RankFM, evaluation

DEVICE = "cuda"


def make_basket_data(rng, n_users=2000, n_items=800, n_aisles=20):
    item_aisle = rng.integers(0, n_aisles, n_items)
    rows = []
    for u in range(n_users):
        fav = rng.choice(n_aisles, size=3, replace=False)
        for _ in range(rng.integers(20, 60)):
            aisle = rng.choice(fav) if rng.random() < 0.8 else rng.integers(n_aisles)
            pool = np.where(item_aisle == aisle)[0]
            rows.append((u, int(rng.choice(pool)), int(rng.integers(1, 12))))
    df = (pd.DataFrame(rows, columns=["user_id", "item_id", "orders"])
          .groupby(["user_id", "item_id"], as_index=False)["orders"].sum())
    feats = pd.get_dummies(pd.Series(item_aisle, name="aisle"), prefix="aisle")
    item_features = pd.concat(
        [pd.Series(np.arange(n_items), name="item_id"), feats.astype(float)], axis=1)
    return df, item_features


def main():
    rng = np.random.default_rng(0)
    df, item_features = make_basket_data(rng)
    train = df.sample(frac=0.8, random_state=0)
    valid = df.drop(train.index)[["user_id", "item_id"]]
    print(f"train={len(train)} valid={len(valid)} items={item_features.shape}")

    # log2(orders+1) sample weights, like the reference notebook
    sw = np.log2(train["orders"].values + 1).astype(np.float32)
    inter = train[["user_id", "item_id"]]

    # item features must cover exactly the training items
    feats = item_features[item_features["item_id"].isin(inter["item_id"].unique())]

    # NOTE: this synthetic catalog is small (800 items); factors=16 and a
    # moderate WARP width fit it well. (The reference's Instacart notebook
    # uses factors=50/max_samples=50 against 33k items.)
    model = RankFM(factors=16, loss="warp", max_samples=10, alpha=0.01,
                   learning_rate=0.1, learning_schedule="invscaling",
                   device=DEVICE)
    t0 = time.time()
    model.fit(inter, item_features=feats, sample_weight=pd.Series(sw), epochs=20)
    print(f"fit: {time.time()-t0:.1f}s")

    # valid pairs are disjoint from train here, so unfiltered top-10 is
    # crowded out by each user's already-seen items — the filtered numbers
    # are the meaningful ones for this split
    for fp in (False, True):
        m = evaluation.compute(model, valid, k=10, filter_previous=fp,
                               metrics=("hit_rate", "precision", "recall"))
        print(f"filter_previous={fp}: HR@10={m['hit_rate']:.3f} "
              f"P@10={m['precision']:.3f} R@10={m['recall']:.3f}")

    print("similar to item 0:", model.similar_items(0, n_items=5))


if __name__ == "__main__":
    main()
