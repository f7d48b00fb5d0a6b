"""The fused engine on the data-parallel mesh (port of
`rankfm_tpu/parallel/fused.py`).

Every rank runs the unmodified single-device batch step (`fused_batch`:
the Hopper kernel on the card, its plain version on the CPU) on its share
of each global batch's chunks; tables replicate, and the replicas re-merge
with ONE table-sized delta all-reduce per sync group
(`rankfm_tpu_torch.ops.fused.dp_fused_epoch`).

Layout contract: the fit-time `make_records_grouped` layout is built once
for the GLOBAL batch size; `split_layout_for_mesh` deals each batch's
chunks to the ranks device-major; every rank re-shuffles the same record
array each epoch under the shared epoch key (no communication), or takes
the same pre-shuffled layout (``pre_shuffled``), and each rank draws its
own negatives under its own key (`fused.epoch_key` with its rank).
"""

from __future__ import annotations

from functools import partial

from rankfm_tpu_torch.ops import fused as fused_mod


def make_fused_dp_epoch_fn(mesh, num_users, num_items, factors, max_samples,
                           batch_size, chunk, ub=None, n_windows=None,
                           sync_every=1, batch_fn=None, pre_shuffled=False):
    """``epoch_fn(tab_u, tab_i, packed, layout, eta, alpha, seed, epoch,
    x_uf=None, x_if=None, tab_uf=None, tab_if=None, beta=0.0) -> ll``: one
    data-parallel fused epoch on this rank, with `fused_epoch`'s arguments
    except that ``layout``'s chunk ids and block ids are
    `split_layout_for_mesh`'s split and ``batch_size`` is the GLOBAL batch.
    ``sync_every=K`` merges the replicas every K batches (local SGD, as the
    XLA path's ``dp_sync_every``). ``batch_fn`` replaces the batch step
    (same signature as `fused_batch`). ``pre_shuffled``: ``layout``'s
    records come shuffled and the epoch does not sort
    (`rankfm_tpu/parallel/fused.py:139-166`). ``mesh=None`` is one device
    (`fused_epoch`): `RankFM`'s fused fits run through this builder."""
    n_dev = 1 if mesh is None else mesh.size
    assert (batch_size // n_dev) % chunk == 0, (batch_size, n_dev, chunk)
    return partial(fused_mod.dp_fused_epoch, mesh=mesh, num_users=num_users,
                   num_items=num_items, factors=factors,
                   max_samples=max_samples, batch_size=batch_size,
                   chunk=chunk, ub=ub, n_windows=n_windows,
                   sync_every=sync_every, batch_fn=batch_fn,
                   pre_shuffled=pre_shuffled)
