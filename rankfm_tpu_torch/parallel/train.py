"""Sharded training of the XLA engine's steps (port of
`rankfm_tpu/parallel/train.py`), in the regime that fits where the bytes
live (`uses_dp`):

* **DP: tables fit per device** (the common case: even a 1M x 64 f32 item
  table is 256 MB). Tables replicate (`place_weights_replicated`); every
  rank takes its contiguous ``1/n_dev`` of each global batch, runs the
  unmodified single-device step (`ops.training.TrainStep`, whose table
  updates are kernels B2/B3 on the card) ``k`` times on its replica with
  its own draws, and one delta all-reduce per sync group re-merges the
  replicas (`dp_epoch_body`).
* **Row-sharded: tables bigger than that** (`place_weights`): the JAX
  package lowers the single-device step over row-sharded tables with
  GSPMD; here the same step runs with explicit owner-shard exchanges
  (`rankfm_tpu_torch.parallel.tp`): one batch through
  `make_sharded_train_step`, a whole epoch through
  `make_sharded_epoch_fn(dp=False)`.
"""

from __future__ import annotations

import torch

from rankfm_tpu_torch.ops import fused as fused_mod
from rankfm_tpu_torch.ops import training
from rankfm_tpu_torch.parallel import tp

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

    The permutation is drawn under the epoch's key and so is the same on
    every rank; each rank takes its contiguous ``1/n_dev`` of every global
    batch and draws its candidates under its own batch keys
    (`training.epoch_draws` with its rank: rank 0's are the epoch's own, so
    a one-rank mesh is `training.epoch_body` bit for bit). After each group of
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
        perm, keys = training.epoch_draws(seed, epoch, n_pad, nb, u.device,
                                          rank)
        valid = (perm < n_real).reshape(nb, batch_size)[:, cols]
        ub, ib, swb = (a[perm].reshape(nb, batch_size)[:, cols]
                       for a in (u, i, sw))
        ll = torch.zeros((), dtype=torch.float32, device=u.device)
        for t in range(nb):
            if n_dev > 1 and t % k == 0:
                snap = {name: v.clone() for name, v in w.items()}
            w, ll_t = step.apply(w, x_uf, x_if, hist, ub[t], ib[t], swb[t],
                                 valid[t], eta, alpha, beta,
                                 step.draw(keys[t], bd))
            ll = ll + ll_t
            if n_dev > 1 and t % k == k - 1:
                mesh.merge_deltas([w[n] for n in snap],
                                  [snap[n] for n in snap])
        if n_dev > 1:
            mesh.all_reduce(ll.reshape(1), tag="epoch_ll")
        return w, ll

    return epoch_fn


def make_sharded_train_step(mesh, num_items, max_samples, x_uf_any,
                            x_if_any, sample_rounds=8, sampler="bsearch"):
    """One batch of the candidate step over row-sharded tables
    (`rankfm_tpu/parallel/train.py:37-66`), with the single-device step's
    signature and semantics (`training.make_train_step`): ``draw(key, B)``
    and ``apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta,
    draws) -> (w, ll)`` on the WHOLE batch, every rank calling it with the
    same arguments. ``w`` / ``x_uf`` / ``x_if`` are `place_weights`'s
    shards, ``hist`` the replicated history dict (``{'offsets', 'flat'}``,
    and ``'bitmap'`` for ``sampler='bitmap'``).

    Each ``data`` rank runs its contiguous ``1/data`` of the batch and of
    the draws through `tp.make_tp_train_step` (owner-shard exchanges over
    ``model``, the pair payloads gathered over ``data``), so every rank ends
    with its shards of the single-device step's tables; ``ll`` is the
    batch's, summed over ``data``."""
    D = mesh.shape["data"]
    step = tp.make_tp_train_step(mesh, num_items, max_samples, x_uf_any,
                                 x_if_any, sample_rounds, sampler=sampler)

    def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, draws):
        B = u.shape[0]
        assert B % D == 0, (B, D)
        cols = slice(mesh.data_rank * (B // D), (mesh.data_rank + 1) * (B // D))
        w, ll = step.apply(w, x_uf, x_if, hist, u[cols], i[cols], sw[cols],
                           valid[cols], eta, alpha, beta, draws[:, cols])
        ll = mesh.all_reduce(ll.reshape(1).clone(), "data", tag="step_ll")
        return w, ll[0]

    return training.TrainStep(step.draw, apply)


def sharded_train_step(mesh, num_items, max_samples, x_uf_any, x_if_any,
                       sample_rounds=8, sampler="bsearch"):
    """`make_sharded_train_step` under the JAX package's name. The JAX
    accessor caches a traced program; nothing here is traced, so the
    step is built anew."""
    return make_sharded_train_step(mesh, num_items, max_samples, x_uf_any,
                                   x_if_any, sample_rounds, sampler)


def place_weights(mesh, w):
    """This rank's part of the weights in the row-sharded layout
    (`parallel.mesh.weight_shardings`): its ``model`` shard of ``w_i``,
    ``v_i`` and ``v_u`` (zero pad rows), copies of the rest
    (`tp.pad_and_place`)."""
    return tp.pad_and_place(mesh, w, None, None)[0]


def place_weights_replicated(mesh, w):
    """The weights whole on this rank (the DP layout): copies on the mesh's
    device."""
    return {k: torch.as_tensor(v).to(mesh.device, copy=True)
            for k, v in w.items()}


def make_sharded_epoch_fn(mesh, num_items, max_samples, x_uf_any, x_if_any,
                          batch_size, sample_rounds=8, sampler="bsearch",
                          step_kind="window", dp=None, table_bytes=0,
                          dp_sync_every=1):
    """One epoch of the XLA ``step_kind`` step on this rank of ``mesh``,
    with `training.epoch_body`'s signature (``hist`` is the blocked history
    pack for ``step_kind='window'``, the CSR/bitmap dict for
    ``'candidate'``).

    ``dp=None`` picks data-parallel (`dp_epoch_body`: replicated weights,
    one delta all-reduce per sync group) when ``table_bytes`` fits
    `DP_TABLE_BYTES` and the batch splits over the ranks, else the
    row-sharded epoch (`tp.tp_epoch_fn`: ``w`` / ``x_uf`` / ``x_if`` are
    `place_weights`'s shards, and the window step's ``hist`` is ``{'packed':
    tp.pad_packed_hist(...)}``); ``dp=True`` / ``False`` forces it, DP only
    where the batch splits (`rankfm_tpu/parallel/train.py:267-296`).

    The candidate step is built as the JAX package's mesh paths build it:
    without post-hoc rejection and without the row-length bound.
    ``dp_sync_every=K`` runs K local batches per replica between merges
    (local SGD); K = 1 merges every batch."""
    if dp is None:
        dp = uses_dp(mesh, batch_size, table_bytes)
    else:
        dp = dp and uses_dp(mesh, batch_size, 0)
    if not dp:
        return tp.tp_epoch_fn(mesh, num_items, max_samples, x_uf_any,
                              x_if_any, batch_size, sample_rounds,
                              step_kind=step_kind, sampler=sampler)
    if step_kind == "window":
        step = training.make_window_train_step(num_items, max_samples,
                                               x_uf_any, x_if_any)
    else:
        step = training.make_train_step(num_items, max_samples, x_uf_any,
                                        x_if_any, sample_rounds, sampler)
    return dp_epoch_body(step, batch_size, mesh, int(dp_sync_every))
