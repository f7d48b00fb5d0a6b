"""Plain PyTorch judge of top-N lists.

Scores every item for each user with the weights the benchmark made,
``s(u, i) = w_i[i] + x_if[i]·w_if + v_u[u]·(v_i[i] + v_ifᵀ x_if[i])``, in
float32 with TF32 off, filters the user's training items, and reads each
list it is handed against that: an answer is bad when it names no item, an
item outside the catalog, a training item of the user or an item twice; the
gap of rank ``k`` is by how much the reference's ``k``-th best unseen score
lies above the score of the item the list puts at ``k``.
"""

from __future__ import annotations

import numpy as np
import torch

from fmbench.reference.fitstats import no_tf32


class Catalog:
    """The weights and filters of one served model in the reference's own
    index (raw ids sorted ascending): ``weights`` by that index (``v_u``,
    ``v_i``, ``w_i``, and ``v_if``, ``w_if`` with item features ``x_if``),
    and the training pairs ``train_raw`` of raw ids."""

    def __init__(self, users, items, weights, x_if, train_raw, device):
        self.users, self.items = users, items
        self.device = torch.device(device)
        self.w = {k: torch.as_tensor(v, device=self.device)
                  for k, v in weights.items()}
        self.x_if = (None if x_if is None
                     else torch.as_tensor(x_if, device=self.device))
        u = np.searchsorted(users, train_raw[:, 0])
        i = np.searchsorted(items, train_raw[:, 1])
        self.seen = torch.zeros(len(users), len(items), dtype=torch.bool,
                                device=self.device)
        self.seen[torch.as_tensor(u, device=self.device),
                  torch.as_tensor(i, device=self.device)] = True

    def scores(self, u_idx, dtype=torch.float32):
        """``[B, I]`` utilities of every item for the users ``u_idx`` in
        ``dtype``, training items at -inf."""
        w = {k: v.to(dtype) for k, v in self.w.items()}
        ir, ib = w["v_i"], w["w_i"]
        if self.x_if is not None:
            xf = self.x_if.to(dtype)
            ir = ir + xf @ w["v_if"]
            ib = ib + xf @ w["w_if"]
        s = w["v_u"][u_idx] @ ir.T + ib[None, :]
        return s.masked_fill(self.seen[u_idx], float("-inf"))


def judge(cat, users_raw, answers):
    """``{"bad_answers", "topk_gap"}`` of the lists ``answers [B, k]`` (raw
    item ids, NaN for none) served to ``users_raw [B]``."""
    dev = cat.device
    k = answers.shape[1]
    u_idx = np.searchsorted(cat.users, users_raw)
    if np.any(cat.users[np.minimum(u_idx, len(cat.users) - 1)] != users_raw):
        return {"bad_answers": float(len(users_raw) * k),
                "topk_gap": float("inf")}
    a = np.nan_to_num(answers, nan=-1.0).astype(np.int64)
    a_idx = np.searchsorted(cat.items, a)
    a_idx = np.minimum(a_idx, len(cat.items) - 1)
    valid = (cat.items[a_idx] == a) & ~np.isnan(answers)
    with no_tf32():
        ut = torch.as_tensor(u_idx, device=dev)
        s = cat.scores(ut)
        best = s.topk(k, dim=1).values
        ai = torch.as_tensor(a_idx, device=dev)
        got = s.gather(1, ai)
        vt = torch.as_tensor(valid, device=dev)
        seen = cat.seen[ut].gather(1, ai)
        bad_t = ~vt | seen
        # an item named twice in one list (invalid slots kept apart)
        keyed = torch.where(vt, ai, -1 - torch.arange(k, device=dev))
        srt = keyed.sort(1).values
        bad = int(bad_t.sum()) + int((srt[:, 1:] == srt[:, :-1]).sum())
        gap = torch.where(bad_t, torch.zeros_like(got), best - got)
        topk_gap = float(gap.max()) if gap.numel() else 0.0
    return {"bad_answers": float(bad), "topk_gap": topk_gap}


def lists(cat, users_raw, k, dtype=torch.float32, tf32=False):
    """The top-``k`` lists (raw item ids) that the reference itself serves
    in ``dtype``, its matrix products in TF32 with ``tf32``: with a lower
    precision than float32 with TF32 off, the control."""
    with no_tf32(tf32):
        u_idx = torch.as_tensor(np.searchsorted(cat.users, users_raw),
                                device=cat.device)
        top = cat.scores(u_idx, dtype).topk(k, dim=1).indices
    return cat.items[top.cpu().numpy()].astype(np.float64)
