"""Negative sampling against ragged user histories (port of
`rankfm_tpu/ops/negatives.py`).

Histories live in a CSR pair ``(offsets [U+1], flat [nnz])`` with rows sorted
ascending, or in the packed membership bitmap (`build_bitmap_words`).
Membership is a fixed-trip binary search (`csr_member`) or one bitmap row
gather plus a bit test (`bitmap_member`); rejection re-draws run for a fixed
number of rounds, and candidates still in the history afterwards are flagged
invalid.

The samplers take their random candidates as one int32 tensor argument
``draws [R, B, M]`` (`draw_candidates` makes it from a key), so tests
can hand them the JAX package's own draws. Retrieval with
``filter_previous=True`` also reads the bitmap.
"""

from __future__ import annotations

import numpy as np
import torch

from rankfm_tpu_torch.ops import _philox


def build_bitmap_words(offsets, flat_items, num_users, num_items):
    """Host-side: pack each user's item history into a [U, ceil(I/32)] uint32
    bitmap; item ``i`` is bit ``i & 31`` of word ``i >> 5``."""
    words = (num_items + 31) // 32
    bm = np.zeros((num_users, words), dtype=np.uint32)
    counts = np.diff(offsets).astype(np.int64)
    users = np.repeat(np.arange(num_users, dtype=np.int64), counts)
    items = flat_items.astype(np.int64)
    np.bitwise_or.at(bm, (users, items >> 5), (np.uint32(1) << (items & 31).astype(np.uint32)))
    return bm


def csr_member(flat_items, offsets, u, j, max_row_len=None):
    """Is item ``j`` in user ``u``'s sorted row? ``u`` and ``j`` are integer
    tensors of one shape; returns a bool tensor of that shape.

    Binary search with the fixed trip count ``bit_length(max_row_len)``
    (the total nnz when the longest row is not given), so nothing depends
    on the data on the host."""
    nnz = flat_items.shape[0]
    if nnz == 0:
        return torch.zeros(u.shape, dtype=torch.bool, device=u.device)
    u = u.long()
    lo = offsets[u].long()
    end = offsets[u + 1].long()
    hi = end
    iters = max(1, int(max_row_len if max_row_len else nnz).bit_length())
    for _ in range(iters):
        mid = (lo + hi) // 2
        mid_val = flat_items[mid.clamp(0, nnz - 1)]
        go_right = (mid_val < j) & (lo < hi)
        lo, hi = (torch.where(go_right, mid + 1, lo),
                  torch.where(go_right | (lo >= hi), hi, mid))
    found_val = flat_items[lo.clamp(0, nnz - 1)]
    return (lo < end) & (found_val == j)


def _rows_member(rows, j):
    """Bit test of items ``j [B, K]`` against gathered bitmap rows
    ``rows [B, words]`` (int32 words). The shift is arithmetic on int32, but
    only bit 0 of the shifted word is kept, which is bit ``j & 31`` of the
    word either way."""
    word = rows.gather(1, (j >> 5).long())
    return ((word >> (j & 31).to(word.dtype)) & 1).bool()


def bitmap_member(bitmap_words, u, j):
    """``u [B]``, ``j [B, K]`` -> bool [B, K]: one row gather of the int32
    bitmap (`build_bitmap_words` viewed as int32) plus an in-row bit test."""
    return _rows_member(bitmap_words[u.long()], j)


def draw_candidates(key, n_draws, batch, max_samples, num_items):
    """``n_draws`` uniform candidate sets ``[n_draws, B, M]`` int32 drawn
    under ``key`` (a batch's key, `_philox.fold`), on the key's device."""
    x = _philox.bits(key, _philox.STREAM_STEP, n_draws * batch * max_samples)
    return _philox.below(x, num_items).to(torch.int32).reshape(
        n_draws, batch, max_samples)


def sample_negatives_bitmap(u, bitmap_words, num_items, max_samples, draws):
    """Bitmap-backed rejection sampling: ``draws [R, B, M]`` are R candidate
    sets; each slot keeps the first non-member. Returns ``(candidates int32
    [B, M], valid bool [B, M])``; a slot that was a member in every round
    is flagged invalid."""
    rows = bitmap_words[u.long()]                              # [B, words]
    chosen = draws[0]
    still_member = _rows_member(rows, chosen)
    for r in range(1, draws.shape[0]):
        fresh = draws[r]
        chosen = torch.where(still_member, fresh, chosen)
        still_member = torch.where(still_member, _rows_member(rows, fresh),
                                   still_member)
    return chosen, ~still_member


def sample_negatives(u, offsets, flat_items, num_items, max_samples, draws,
                     max_row_len=None):
    """CSR-backed rejection sampling: ``draws [R+1, B, M]`` are the first
    candidate set and R re-draws; a slot re-draws while it is a member.
    Returns ``(candidates int32 [B, M], valid bool [B, M])``."""
    u_bm = u[:, None].expand(-1, max_samples)
    cand = draws[0]
    member = csr_member(flat_items, offsets, u_bm, cand, max_row_len)
    for r in range(1, draws.shape[0]):
        cand = torch.where(member, draws[r], cand)
        member = csr_member(flat_items, offsets, u_bm, cand, max_row_len)
    return cand, ~member
