"""Top-N retrieval (port of `rankfm_tpu/ops/topk.py`): one matmul over the
whole catalog, previously seen items masked to -inf, one ``torch.topk``.

A slot whose score is -inf (the user has fewer than ``n_items`` unseen
items) comes back as item -1; `RankFM.recommend` turns it into NaN.
"""

from __future__ import annotations

import torch

from rankfm_tpu_torch.ops import scoring


def _top(scores, n_items):
    top_scores, top_items = torch.topk(scores, n_items, dim=1)
    top_items = torch.where(torch.isneginf(top_scores), -1, top_items)
    return top_items.to(torch.int32), top_scores


def topk_for_users(w, x_uf, x_if, u_idx, n_items, seen_rows, seen_cols):
    """Top-``n_items`` item indices (and scores) for each user in ``u_idx``.

    ``seen_rows``/``seen_cols`` are flat int tensors of (batch-row, item)
    pairs to exclude; empty tensors disable filtering and a negative row
    disables one pair.
    """
    scores = scoring.score_all_items(w, x_uf, x_if, u_idx)          # [B, I]
    if seen_rows.shape[0] > 0:
        ok = seen_rows >= 0
        scores[seen_rows[ok].long(), seen_cols[ok].long()] = float("-inf")
    return _top(scores, n_items)


def topk_bitmap(w, x_uf, x_if, u_idx, n_items, bitmap_words):
    """Top-N with previously seen items masked from the packed membership
    bitmap (`negatives.build_bitmap_words`, held as int32 words)."""
    scores = scoring.score_all_items(w, x_uf, x_if, u_idx)          # [B, I]
    col = torch.arange(scores.shape[1], device=scores.device)
    words = bitmap_words[u_idx][:, col >> 5]                        # [B, I]
    seen = ((words >> (col & 31)) & 1).bool()
    scores = scores.masked_fill(seen, float("-inf"))
    return _top(scores, n_items)
