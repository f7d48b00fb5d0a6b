"""Data-parallel training of the XLA engine's steps (port of the DP half
of `rankfm_tpu/parallel/train.py`).

Two regimes, chosen by where the bytes live (`uses_dp`):

* **DP: tables fit per device** (the common case: even a 1M x 64 f32 item
  table is 256 MB). Tables replicate; every rank takes its contiguous
  ``1/n_dev`` of each global batch, runs the unmodified single-device step
  (`ops.training.TrainStep`, whose table updates are kernels B2/B3 on the
  card) ``k`` times on its replica with its own draws, and one delta
  all-reduce per sync group re-merges the replicas (`dp_epoch_body`).
* **TP: tables bigger than that**: row-sharded tables with explicit
  owner-shard exchanges (`rankfm_tpu_torch.parallel.tp`).

The JAX package's GSPMD lowering of the step over row-sharded tables
(`make_sharded_train_step`, the ``dp=False`` epoch) is not ported: `fit`
never reaches it, a table-parallel plan runs `parallel.tp`.
"""

from __future__ import annotations

import torch

from rankfm_tpu_torch.ops import fused as fused_mod
from rankfm_tpu_torch.ops import training

# weight pytrees under this many bytes replicate per device and train
# data-parallel; larger tables row-shard (the JAX package's rule)
DP_TABLE_BYTES = 256 * 2**20


def uses_dp(mesh, batch_size, table_bytes):
    """The DP-vs-TP choice: data-parallel needs the weights to fit per
    device AND the batch to split evenly over the ranks
    (`rankfm_tpu/parallel/train.py:255-265`)."""
    n_dev = 1
    for v in mesh.shape.values():
        n_dev *= v
    return table_bytes <= DP_TABLE_BYTES and batch_size % n_dev == 0


def dp_epoch_body(step, batch_size, mesh, sync_every=1):
    """One data-parallel epoch of an XLA step on this rank
    (`_cached_dp_epoch`, `rankfm_tpu/parallel/train.py:148-247`), with
    `training.epoch_body`'s signature.

    The permutation comes from the epoch's device generator and so is the
    same on every rank; each rank takes its contiguous ``1/n_dev`` of every
    global batch and draws its candidates from its own generator
    (`fused.rank_generator`: rank 0 continues the shared one, so a one-rank
    mesh is `training.epoch_body` bit for bit). After each group of
    `fused.sync_group_size` batches, ONE all-reduce sums the ranks' deltas
    to all six weight tensors; the epoch log-likelihood is summed at the
    end."""
    n_dev, rank = mesh.size, mesh.rank
    assert batch_size % n_dev == 0, (batch_size, n_dev)
    bd = batch_size // n_dev
    cols = slice(rank * bd, (rank + 1) * bd)

    def epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha, beta,
                 seed, epoch):
        n_pad = u.shape[0]
        nb = n_pad // batch_size
        k = fused_mod.sync_group_size(sync_every, nb)
        gen = training.device_generator(seed, epoch, u.device)
        perm = torch.randperm(n_pad, generator=gen, device=u.device)
        valid = (perm < n_real).reshape(nb, batch_size)[:, cols]
        ub, ib, swb = (a[perm].reshape(nb, batch_size)[:, cols]
                       for a in (u, i, sw))
        rgen = fused_mod.rank_generator(gen, seed, epoch, rank)
        ll = torch.zeros((), dtype=torch.float32, device=u.device)
        for t in range(nb):
            if n_dev > 1 and t % k == 0:
                snap = {name: v.clone() for name, v in w.items()}
            w, ll_t = step.apply(w, x_uf, x_if, hist, ub[t], ib[t], swb[t],
                                 valid[t], eta, alpha, beta,
                                 step.draw(rgen, bd))
            ll = ll + ll_t
            if n_dev > 1 and t % k == k - 1:
                mesh.merge_deltas([w[n] for n in snap],
                                  [snap[n] for n in snap])
        if n_dev > 1:
            mesh.all_reduce(ll.reshape(1), tag="epoch_ll")
        return w, ll

    return epoch_fn


def make_sharded_epoch_fn(mesh, num_items, max_samples, x_uf_any, x_if_any,
                          batch_size, sample_rounds=8, sampler="bsearch",
                          step_kind="window", dp_sync_every=1):
    """The data-parallel epoch of the XLA ``step_kind`` step on this rank
    (`dp_epoch_body`), with `training.epoch_body`'s signature (``hist`` is
    the blocked history pack for ``step_kind='window'``, the CSR/bitmap dict
    for ``'candidate'``). Placement is the planner's (`uses_dp`); a
    table-parallel plan runs `rankfm_tpu_torch.parallel.tp`.

    The candidate step is built as the JAX package's DP path builds it:
    without post-hoc rejection and without the row-length bound.
    ``dp_sync_every=K`` runs K local batches per replica between merges
    (local SGD); K = 1 merges every batch."""
    if step_kind == "window":
        step = training.make_window_train_step(num_items, max_samples,
                                               x_uf_any, x_if_any)
    else:
        step = training.make_train_step(num_items, max_samples, x_uf_any,
                                        x_if_any, sample_rounds, sampler)
    return dp_epoch_body(step, batch_size, mesh, int(dp_sync_every))
