"""Data maker ``instacart``: an Instacart-shaped reorder log, a copy of
`chip_smoke.py`'s ``make_instacart`` with its shape taken from the
configuration's ``data`` group (``users``, ``items``, ``depts``, ``pairs``).

``items`` products fall into ``depts`` departments; each user has
Dirichlet(0.2) department tastes, products a power-law (0.8) popularity
within their department. Basket sizes (distinct products a user bought) are
lognormal(3.6, 0.8), scaled so that they sum to ``pairs`` and clipped to
[5, 400]; order counts are geometric(0.35). With ``sample_weight:
"log2_orders_plus_1"`` each pair is weighted ``log2(orders + 1)``, and with
``item_features: "department_one_hot"`` each product's feature row is its
department as a one-hot."""

import numpy as np

BASKET_CLIP = (5, 400)


def baskets(rng, users, pairs):
    """Lognormal basket sizes summing to about ``pairs``, clipped."""
    raw = rng.lognormal(3.6, 0.8, users)
    scale = pairs / raw.sum()
    for _ in range(30):
        b = np.clip(np.round(raw * scale), *BASKET_CLIP)
        scale *= pairs / b.sum()
    return np.clip(np.round(raw * scale), *BASKET_CLIP).astype(np.int64)


def make(rng, spec):
    """``(pairs [n, 2] int64, weights [n] or None, x_if [items, depts] or
    None)``."""
    users, items, depts = spec["users"], spec["items"], spec["depts"]
    dept_of_item = rng.integers(0, depts, items)
    pop = 1.0 / np.arange(1, items + 1) ** 0.8
    taste = rng.dirichlet(np.ones(depts) * 0.2, size=users)
    basket = baskets(rng, users, spec["pairs"])
    by_dept = np.argsort(dept_of_item, kind="stable")
    cum = np.cumsum(pop[by_dept])
    lo = np.searchsorted(dept_of_item[by_dept], np.arange(depts))
    hi = np.append(lo[1:], items)
    mass = np.bincount(dept_of_item, weights=pop, minlength=depts)
    before = np.concatenate([[0.0], cum])[lo]
    u_draw = np.repeat(np.arange(users), 2 * basket)
    q = np.cumsum(taste * mass[None, :], 1)
    q /= q[:, -1:]
    dept = np.minimum((rng.random(len(u_draw))[:, None] > q[u_draw]).sum(1),
                      depts - 1)
    pos = np.searchsorted(cum, before[dept] + rng.random(len(u_draw))
                          * mass[dept], side="right")
    i_draw = by_dept[np.clip(pos, lo[dept], hi[dept] - 1)]
    _, first = np.unique(u_draw * items + i_draw, return_index=True)
    first.sort()
    u, i = u_draw[first], i_draw[first]
    rank = np.arange(len(u)) - np.searchsorted(u, u)
    keep = rank < basket[u]
    pairs = np.stack([u[keep], i[keep]], 1).astype(np.int64)
    n_orders = rng.geometric(0.35, size=len(pairs))
    sw = x_if = None
    if spec.get("sample_weight") == "log2_orders_plus_1":
        sw = np.log2(n_orders + 1).astype(np.float32)
    if spec.get("item_features") == "department_one_hot":
        x_if = np.zeros((items, depts), np.float32)
        x_if[np.arange(items), dept_of_item] = 1.0
    return pairs, sw, x_if
