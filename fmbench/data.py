"""The inputs of a run, made from a seed, and the relabelling of each fit.

A configuration's ``data`` group names its maker: ``makers/<maker>.py``,
found by that name, makes the interaction log of the published shape (the
makers are copies of `chip_smoke.py`'s ``make_synthetic`` and
``make_instacart``); `make` splits it and returns the inputs that both the
program and the reference are handed. A configuration with another data
shape adds a maker file, and edits nothing here.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd

MAKERS = Path(__file__).resolve().parent / "makers"


def make(spec, seed, base=None):
    """The inputs of one run: a dict with ``train`` and ``test`` pairs
    ``[n, 2] int64`` of raw ids, ``sw`` (training weights or None), ``x_if``
    (item features by raw item id, ``[items, Q]``, or None) and
    ``id_bound`` (one past the largest user and item id).
    ``spec`` is a configuration's ``data`` group; its maker is read from
    ``base/makers`` (the benchmark's folder by default)."""
    from fmbench.harness import load_module

    folder = MAKERS if base is None else Path(base) / "makers"
    maker = load_module(folder / f"{spec['maker']}.py")
    rng = np.random.default_rng([seed, 0x5EED])
    pairs, sw_all, x_if = maker.make(rng, spec)
    mask = rng.random(len(pairs)) < spec["train_share"]
    n_i = max(int(pairs[:, 1].max()) + 1, 0 if x_if is None else len(x_if))
    return {"train": pairs[mask], "test": pairs[~mask],
            "sw": None if sw_all is None else sw_all[mask], "x_if": x_if,
            "id_bound": (int(pairs[:, 0].max()) + 1, n_i)}


RELABEL_BLOCKS = 64


def relabel(inputs, seed, k):
    """The inputs of fit ``k`` (from -1) of a run: user and item ids
    relabelled by permutations drawn from ``(seed, k)``, and the training
    rows reordered (`RELABEL_BLOCKS` contiguous blocks in a drawn order), so
    that no fit sees data that a fit before it saw. Returns ``(relabelled,
    pu, pi)``: the relabelled ``train``, ``sw`` and ``x_if`` (rows by new
    id), and the permutations (the new id of each old one)."""
    rng = np.random.default_rng([seed, 0xF17, k + 1])
    train = inputs["train"]
    pu = rng.permutation(inputs["id_bound"][0])
    pi = rng.permutation(inputs["id_bound"][1])
    n = len(train)
    step = -(-n // RELABEL_BLOCKS)
    order = (rng.permutation(RELABEL_BLOCKS)[:, None] * step
             + np.arange(step)[None, :]).ravel()
    order = order[order < n]
    tr = np.empty_like(train)
    tr[:, 0] = pu[train[order, 0]]
    tr[:, 1] = pi[train[order, 1]]
    sw = None if inputs["sw"] is None else inputs["sw"][order]
    x_if = None
    if inputs["x_if"] is not None:
        x_if = np.empty_like(inputs["x_if"])
        x_if[pi[:len(inputs["x_if"])]] = inputs["x_if"]
    return {"train": tr, "sw": sw, "x_if": x_if}, pu, pi


def fit_args(inputs):
    """``RankFM.fit`` keyword arguments for one data set: the interactions
    frame, the sample weights and the item features (one row for each item
    of the interactions, as ``fit`` takes them)."""
    tr = inputs["train"]
    kw = {"interactions": pd.DataFrame({"user_id": tr[:, 0],
                                        "item_id": tr[:, 1]})}
    if inputs["sw"] is not None:
        kw["sample_weight"] = inputs["sw"]
    if inputs["x_if"] is not None:
        ids = np.unique(tr[:, 1])
        x = inputs["x_if"][ids]
        df = pd.DataFrame(x, columns=[f"f{q}" for q in range(x.shape[1])])
        df.insert(0, "item_id", ids)
        kw["item_features"] = df
    return kw
