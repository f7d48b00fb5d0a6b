"""The numbers by which a fit's outputs are compared with the reference's.

A fit's outputs are its tables and the log-likelihood of each epoch. Two
correct fits from different draws part after their first chunks (WARP picks
among near-tied negatives), so they are compared by statistics that many
rows average over:

- ``hr10``: hit rate at 10 on the held-out rows, training items filtered
  (the share of held-out users with a held-out item among their ten best
  unseen items);
- ``ll``: each epoch's log-likelihood;
- ``rms``: each table's root mean square (a fit's user and item tables
  settle where the per-touch decay balances the gradients; a lower
  precision, a step left out or rows left out move that).

All of it is plain PyTorch on the tables as handed in, with TF32 off.
"""

from __future__ import annotations

import contextlib

import numpy as np
import torch


@contextlib.contextmanager
def no_tf32(tf32=False):
    """Float32 matrix products in float32 inside the block, or in TF32 with
    ``tf32`` (the control's precision); the flags are restored after it, so
    the program's own setting is left as it was."""
    m = torch.backends.cuda.matmul.allow_tf32
    c = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = m
        torch.backends.cudnn.allow_tf32 = c


class Frame:
    """The held-out users and the filters of one data set, in the
    reference's own index (ids sorted ascending, as ``np.unique`` gives
    them): ``users``, ``items`` the raw ids of the training rows, ``train``
    and ``test`` pairs of indices (test rows of unknown ids dropped)."""

    def __init__(self, train_raw, test_raw, device):
        self.users = np.unique(train_raw[:, 0])
        self.items = np.unique(train_raw[:, 1])
        self.train = np.stack([np.searchsorted(self.users, train_raw[:, 0]),
                               np.searchsorted(self.items, train_raw[:, 1])],
                              1)
        known = (np.isin(test_raw[:, 0], self.users)
                 & np.isin(test_raw[:, 1], self.items))
        t = test_raw[known]
        self.test = np.stack([np.searchsorted(self.users, t[:, 0]),
                              np.searchsorted(self.items, t[:, 1])], 1)
        self.device = torch.device(device)

    def _mask(self, pairs):
        m = torch.zeros(len(self.users), len(self.items), dtype=torch.bool,
                        device=self.device)
        p = torch.as_tensor(pairs, device=self.device)
        m[p[:, 0], p[:, 1]] = True
        return m


def hit_rate(frame, tables, x_if, k=10, block=2048):
    """Hit rate at ``k`` of ``tables`` (index order of ``frame``), training
    items filtered."""
    dev = frame.device
    with no_tf32():
        t = {n: torch.as_tensor(v, device=dev) for n, v in tables.items()}
        ir, ib = t["v_i"], t["w_i"]
        if x_if is not None:
            xf = torch.as_tensor(x_if, device=dev)
            ir = ir + xf @ t["v_if"]
            ib = ib + xf @ t["w_if"]
        seen, rel = frame._mask(frame.train), frame._mask(frame.test)
        users = torch.as_tensor(np.unique(frame.test[:, 0]), device=dev)
        hits = 0
        for s in range(0, len(users), block):
            u = users[s:s + block]
            scores = t["v_u"][u] @ ir.T + ib[None, :]
            scores = scores.masked_fill(seen[u], float("-inf"))
            top = scores.topk(k, dim=1).indices
            hits += int(rel[u].gather(1, top).any(1).sum())
    return hits / max(len(users), 1)


def stats(frame, tables, lls, x_if):
    """``{"hr10", "ll", "rms"}`` of one fit's outputs."""
    return {"hr10": hit_rate(frame, tables, x_if),
            "ll": np.asarray(lls, dtype=np.float64),
            "rms": {n: float(np.sqrt(np.mean(np.square(v, dtype=np.float64))))
                    for n, v in tables.items()}}


def gaps(got, ref):
    """The gaps of one fit's statistics ``got`` from the reference's
    ``ref``: ``hr10_gap`` (absolute), ``ll_gap`` (the worst epoch's, relative
    to the reference's) and ``rms_gap.<table>`` for each table, the gap of
    its root mean square relative to the larger of the reference's for that
    table and for the median table. Each table has a number, and a limit, of
    its own: the user table's reads alike to a few thousandths from fit to
    fit, the 21-row item-feature tables' swing by a tenth."""
    out = {"hr10_gap": abs(got["hr10"] - ref["hr10"])}
    if len(got["ll"]) != len(ref["ll"]):
        out["ll_gap"] = float("inf")
    else:
        out["ll_gap"] = float(np.max(np.abs(got["ll"] - ref["ll"])
                                     / np.abs(ref["ll"])))
    med = float(np.median(list(ref["rms"].values())))
    for n, r in ref["rms"].items():
        out[f"rms_gap.{n}"] = abs(got["rms"].get(n, float("inf")) - r) / max(
            r, med)
    return out
