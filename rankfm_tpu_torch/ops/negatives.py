"""Packed membership bitmap of user histories (port of
`rankfm_tpu/ops/negatives.py:build_bitmap_words`).

Retrieval with ``filter_previous=True`` masks each user's seen items from
this bitmap. The samplers of the XLA engines that also read it are not
ported yet.
"""

from __future__ import annotations

import numpy as np


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
