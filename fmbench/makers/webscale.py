"""Data maker ``webscale``: the synthetic log of
`examples/torch/webscale_smoke.py`, drawn from the run's generator with its
shape taken from the configuration's ``data`` group (``users``, ``items``,
``interactions``, ``item_power``).

Users are uniform; items are ``floor(items * U^item_power)`` for a uniform
``U``, a power law that puts most rows on the low ids. Duplicate pairs are
kept, as the example keeps them."""

import numpy as np


def make(rng, spec):
    """``(pairs [n, 2] int64, None, None)``: no weights, no features."""
    n = spec["interactions"]
    users = rng.integers(0, spec["users"], n)
    items = (spec["items"] * rng.random(n) ** spec["item_power"]).astype(
        np.int64)
    return np.stack([users, items], 1).astype(np.int64), None, None
