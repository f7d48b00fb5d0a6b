"""`fmbench.reference.fitstats` at catalogs whose ``[users, items]`` masks do
not fit: the same numbers, with the seen and relevant masks built one block
of users at a time from sorted pairs.

`fitstats.hit_rate` scores its held-out users a block at a time and reads
``seen[u]`` and ``rel[u]`` for the block ``u`` only, from two dense
``[U, I]`` masks (two 85 GB matrices at 100,000 users by 910,000 items).
`Frame` hands it `RowMasks` in their place: each builds the rows of a block
on the device from its pairs, sorted by user. Everything else, the scores,
the top-k, the log-likelihoods and the root mean squares, is `fitstats`'s
own code, so both give the same numbers; `stats` and `gaps` are
`fitstats.stats` and `fitstats.gaps`.
"""

from __future__ import annotations

import numpy as np
import torch

from fmbench.reference import fitstats
from fmbench.reference.fitstats import gaps, stats

__all__ = ["Frame", "RowMasks", "gaps", "stats"]


class RowMasks:
    """The ``[U, I]`` bool mask of ``pairs`` (user, item indices), of
    which only blocks of rows are ever made: ``masks[u]`` for an int64
    tensor of users ``u`` is the ``[len(u), I]`` mask of their rows."""

    def __init__(self, pairs, num_users, num_items, device):
        order = np.lexsort((pairs[:, 1], pairs[:, 0]))
        p = pairs[order]
        self.items = torch.as_tensor(p[:, 1], device=device)
        self.offsets = torch.as_tensor(np.searchsorted(
            p[:, 0], np.arange(num_users + 1)), device=device)
        self.num_items = num_items

    def __getitem__(self, u):
        u = u.long()
        start, end = self.offsets[u], self.offsets[u + 1]
        lens = end - start
        row = torch.repeat_interleave(torch.arange(len(u), device=u.device),
                                      lens)
        first = torch.cumsum(lens, 0) - lens
        pos = start[row] + torch.arange(len(row), device=u.device) - first[row]
        m = torch.zeros(len(u), self.num_items, dtype=torch.bool,
                        device=u.device)
        m[row, self.items[pos]] = True
        return m


class Frame(fitstats.Frame):
    """`fitstats.Frame` whose masks are `RowMasks`."""

    def _mask(self, pairs):
        return RowMasks(pairs, len(self.users), len(self.items), self.device)
