"""Data maker ``ml1m``: an ML-1M-shaped implicit log, a copy of
`chip_smoke.py`'s ``make_synthetic`` with its shape taken from the
configuration's ``data`` group (``users``, ``items``, ``interactions``).

User activity is lognormal(4.0, 0.9) clipped to [20, 1500] and scaled to
``interactions`` rows in all; item popularity is a power law (0.9)."""

import numpy as np


def make(rng, spec):
    """``(pairs [n, 2] int64, None, None)``: no weights, no features."""
    users, items, interactions = (spec["users"], spec["items"],
                                  spec["interactions"])
    item_p = 1.0 / np.arange(1, items + 1) ** 0.9
    item_p /= item_p.sum()
    act = np.minimum(np.maximum(
        rng.lognormal(mean=4.0, sigma=0.9, size=users), 20), 1500)
    target = np.round(np.cumsum(act * (interactions / act.sum()))).astype(
        np.int64)
    act = np.maximum(np.diff(np.concatenate([[0], target])), 5)
    u = np.repeat(np.arange(users), act)[:interactions]
    i = rng.choice(items, size=len(u), p=item_p)
    return np.stack([u, i], 1).astype(np.int64), None, None
