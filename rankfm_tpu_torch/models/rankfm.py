"""RankFM on PyTorch (port of `rankfm_tpu/models/rankfm.py`).

Same constructor hyperparameters, assert messages and exception types, and
the same public methods (`fit`, `fit_partial`, `predict`, `recommend`,
`similar_items`, `similar_users`). Weights are a dict of tensors on the
model's device (keyword-only ``device``, default ``'cuda'``). Training runs
the engines of the JAX package as its planner resolves them: the fused
WARP/BPR engine (`rankfm_tpu_torch.ops.fused`, with its chunk-tail, its
candidate tail or its wide-window tail, sorting every epoch or cycling
pre-shuffled layouts) and the XLA window and candidate engines
(`rankfm_tpu_torch.ops.training`), each with or without side features.
Their kernels (the fused chunk step and the table update) run on a GPU; on
the CPU their plain versions run.

Ingest goes through the C++ library of `rankfm_tpu_torch.native` for integer
ids, a repeated ``fit_partial`` on the same interactions reuses the history
and the record layouts of the call before, ``last_fit_timing_`` holds the
host phases of the last call in seconds, and `save` / `load` write and read
the JAX package's ``.npz`` checkpoint.

On a mesh (``mesh=rankfm_tpu_torch.parallel.make_mesh(data, model)``, one
process per device, every rank calling the same methods on the same data)
the planner places the weights data-parallel (replicated tables, one delta
all-reduce per sync group: the fused engine through
`fused.dp_fused_epoch`, the XLA steps through `parallel.train`) or, past
`parallel.train.DP_TABLE_BYTES`, table-parallel (`parallel.tp`: each rank
keeps its row shards, `predict` and `recommend` score from them, and
`RankFM.gather_weights` gathers them: a collective, which `save`, the
weight properties and `similar_items` / `similar_users` call on every
rank); `recommend` merges per-shard top-k lists over the
``model`` axis (`parallel.retrieval`).
"""

from __future__ import annotations

import hashlib
import math
import time

import numpy as np
import pandas as pd
import torch

from rankfm_tpu_torch import native
from rankfm_tpu_torch.models.planner import FitSpec, plan_fit
from rankfm_tpu_torch.ops import fused as fused_mod
from rankfm_tpu_torch.ops import scoring, topk, training
from rankfm_tpu_torch.ops.negatives import build_bitmap_words
from rankfm_tpu_torch.parallel.fused import make_fused_dp_epoch_fn
from rankfm_tpu_torch.utils.convert import weights_from_numpy, weights_to_numpy
from rankfm_tpu_torch.utils.data import (
    _int64_view,
    build_index,
    build_user_items_csr,
    csr_row_pairs,
    csr_to_dict,
    get_data,
    map_ids_float,
    map_interactions,
    merge_user_items_csr,
    remap_indices,
    validate_features,
)

_WEIGHT_NAMES = ("w_i", "w_if", "v_u", "v_i", "v_uf", "v_if")


def _recommend_chunk(num_items):
    """User-chunk size for top-N retrieval: bounded so the [chunk, I] score
    matrix stays ~1 GB even for million-item catalogs."""
    return int(min(4096, max(256, 2**28 // max(num_items, 1))))


def _ll_guard(ll, tensors):
    """The epoch log-likelihood, or NaN when ANY table holds a non-finite
    value. Non-finite weights stay non-finite under the SGD update, so a
    later check of one guarded ll catches a divergence at whatever epoch it
    happened, without a host sync per epoch."""
    ok = torch.stack([torch.isfinite(t).all() for t in tensors]).all()
    return torch.where(ok, ll, torch.full_like(ll, float("nan")))


class _FitRun:
    """One ``fit_partial`` execution: epoch scheduling, the per-epoch
    training log, the lagged divergence check and the fused and XLA
    engines' epochs. Every regime decision arrives pre-resolved in a
    `FitPlan`."""

    def __init__(self, model, plan, verbose):
        self.m = model
        self.plan = plan
        self.verbose = verbose
        self.n = len(model.interactions)
        self.U = len(model.user_idx)
        self.I = len(model.item_idx)
        self.F = model.factors
        self.x_uf_any = bool(model.x_uf.any())
        self.x_if_any = bool(model.x_if.any())
        # the epoch stream continues across fit_partial calls (a warm-start
        # loop must not replay the same shuffle/negative stream); the eta
        # schedule restarts per call
        self.rng_off = model._epoch_offset
        self.epoch_lls = []
        self.epoch_secs = []
        # pulls the packed tables back into model._w (set while training)
        self.pull = None
        self.t0 = time.time()

    def eta(self, epoch):
        m = self.m
        if m.learning_schedule == 'constant':
            return m.learning_rate
        return m.learning_rate / (epoch + 1) ** m.learning_exponent

    def _raise_divergence(self, first_bad):
        m = self.m
        m._abort_epoch = first_bad  # first non-finite epoch index
        m._abort_detected_at = len(self.epoch_lls)  # epochs dispatched
        if self.pull is not None:
            self.pull()
        m._assert_finite()  # names the offending tensor; raises
        raise AssertionError(
            "log likelihood is not finite - try decreasing "
            "feature/sample_weight magnitudes")

    def _check_lls(self, vals):
        for e, v in enumerate(vals):
            if not np.isfinite(v):
                self._raise_divergence(e)

    def log_epoch(self, epoch, ll, dt):
        self.epoch_lls.append(ll)
        self.epoch_secs.append(dt)
        if self.verbose:
            if self.pull is not None:
                self.pull()
            self.m._assert_finite()
            penalty = self.m._reg_penalty()
            print("\ntraining epoch:", epoch)
            print("log likelihood:", round(float(ll) - penalty, 2))
        elif len(self.epoch_lls) % 4 == 0:
            # lagged divergence poll: read the guarded ll of 3 epochs ago
            # (long finished on the device), so the queue stays 2 epochs deep
            if not math.isfinite(float(self.epoch_lls[-3])):
                self._check_lls([float(x) for x in self.epoch_lls])

    def finish(self):
        lls = [float(x) for x in self.epoch_lls]  # syncs
        self._check_lls(lls)  # raises at the FIRST bad epoch index
        if not self.verbose and self.epoch_secs:
            # epochs were only enqueued: report the synced average instead
            avg = (time.time() - self.t0) / len(self.epoch_secs)
            self.epoch_secs[:] = [avg] * len(self.epoch_secs)
        for epoch, (llv, dt) in enumerate(zip(lls, self.epoch_secs)):
            self.m.training_log_.append({
                "epoch": epoch, "eta": self.eta(epoch), "log_likelihood": llv,
                "seconds": dt,
                "interactions_per_s": self.n / dt if dt > 0 else float("inf"),
            })

    def run(self):
        plan = self.plan
        t0 = time.time()
        if plan.fused:
            self.run_fused()
        else:
            self.run_xla(range(plan.n_main + plan.n_tail))
        t_disp = time.time()
        # epoch 0's call holds whatever the first use costs (the kernels'
        # build and load); grab it before finish() rewrites epoch_secs with
        # the synced average
        ep0 = self.epoch_secs[0] if self.epoch_secs else 0.0
        # finish() reads every epoch's ll on the host, which waits for the
        # last epoch; the explicit sync also covers what was enqueued after
        # the last ll (the tables pulled back into the model), so block_s
        # ends with the device idle
        self.finish()
        if self.m.device.type == 'cuda':
            torch.cuda.synchronize(self.m.device)
        tm = self.m.last_fit_timing_
        tm["epoch0_call_s"] = round(ep0, 2)
        tm["dispatch_s"] = round(t_disp - t0, 2)   # host-side: all epochs enqueued
        tm["block_s"] = round(time.time() - t_disp, 2)  # device drain + ll sync

    def run_xla(self, epochs, step_kind=None):
        """Epochs of the XLA window or candidate step, on one device or
        placed on the mesh as the plan says, continuing the global epoch
        numbering so the eta schedule and the random streams line up with
        any fused epochs before them."""
        m, plan = self.m, self.plan
        self.pull = None  # m._w is updated every epoch here
        n, num_items = self.n, self.I
        dev = m.device
        bs_x = plan.xla_batch
        if step_kind is None:
            step_kind = plan.step_kind
        # the batch count quantized into ~3%-wide buckets, as in the JAX
        # package (its compiled shapes); pad rows are invalid
        nb_x = max(1, math.ceil(n / bs_x))
        qb = 1 << max(0, nb_x.bit_length() - 6)
        n_pad = -(-nb_x // qb) * qb * bs_x
        u = torch.zeros(n_pad, dtype=torch.int64)
        i = torch.zeros(n_pad, dtype=torch.int64)
        sw = torch.zeros(n_pad, dtype=torch.float32)
        u[:n] = torch.from_numpy(m.interactions[:, 0].astype(np.int64))
        i[:n] = torch.from_numpy(m.interactions[:, 1].astype(np.int64))
        sw[:n] = torch.from_numpy(m.sample_weight)
        u, i, sw = u.to(dev), i.to(dev), sw.to(dev)
        mrl = (int(np.diff(m._ui_offsets).max())
               if len(m._ui_offsets) > 1 else 1)
        if plan.placement == 'tp':
            self.run_tp(epochs, step_kind, u, i, sw, mrl)
            return
        if step_kind == 'candidate':
            hist = {"offsets": m._offsets_dev, "flat": m._flat_items_dev,
                    "bitmap": m._ensure_bitmap()}
        else:
            hist = m._ensure_packed_hist()
        if m.mesh is not None:
            # data-parallel: replicated tables, one delta all-reduce per
            # sync group (the JAX DP path's step, `parallel.train`)
            from rankfm_tpu_torch.parallel.train import make_sharded_epoch_fn
            epoch_fn = make_sharded_epoch_fn(
                m.mesh, num_items, plan.max_samples, self.x_uf_any,
                self.x_if_any, bs_x, sample_rounds=plan.rounds,
                sampler=m._sampler, step_kind=step_kind,
                dp_sync_every=m.dp_sync_every)
        else:
            if step_kind == 'candidate':
                step = training.make_train_step(
                    num_items, plan.max_samples, self.x_uf_any,
                    self.x_if_any, sample_rounds=plan.rounds,
                    sampler=m._sampler, post_reject=plan.post_reject,
                    max_row_len=mrl)
            else:
                step = training.make_window_train_step(
                    num_items, plan.max_samples, self.x_uf_any,
                    self.x_if_any)
            epoch_fn = training.epoch_body(step, bs_x)
        # the steps update the item and user tables in place: train copies,
        # so arrays handed out before this fit (`_weights`, `v_i`, ...; on
        # the CPU these are views) keep their values
        w = {k: v.clone() for k, v in m.gather_weights().items()}
        for epoch in epochs:
            t0 = time.time()
            w, ll = epoch_fn(
                w, m._x_uf_dev, m._x_if_dev, hist, u, i, sw, n,
                self.eta(epoch), m.alpha, m.beta, m.seed, self.rng_off + epoch)
            m._w = w
            self.log_epoch(epoch, _ll_guard(ll, list(w.values())),
                           time.time() - t0)

    def run_tp(self, epochs, step_kind, u, i, sw, mrl):
        """Table-parallel epochs (`parallel.tp`): each rank trains its row
        shards and keeps them on the model. The epoch function returns the
        log-likelihood already summed and guarded over every rank."""
        from rankfm_tpu_torch.parallel import tp as tp_mod

        m, plan = self.m, self.plan
        fn = tp_mod.tp_epoch_fn(
            m.mesh, self.I, plan.max_samples, self.x_uf_any, self.x_if_any,
            plan.xla_batch, sample_rounds=plan.rounds, max_row_len=mrl,
            post_reject=plan.post_reject, step_kind=step_kind)
        w_tp, xu_tp, xi_tp = tp_mod.pad_and_place(
            m.mesh, m.gather_weights(), m._x_uf_dev, m._x_if_dev)
        m._w_tp, m._w_full = w_tp, None
        if step_kind == 'window':
            hist = {"packed": tp_mod.pad_packed_hist(
                m.mesh, m._ensure_packed_hist(), self.U)}
        else:
            hist = {"offsets": m._offsets_dev, "flat": m._flat_items_dev}
        for epoch in epochs:
            t0 = time.time()
            w_tp, ll = fn(w_tp, xu_tp, xi_tp, hist, u, i, sw, self.n,
                          self.eta(epoch), m.alpha, m.beta, m.seed,
                          self.rng_off + epoch)
            m._w_tp = w_tp
            self.log_epoch(epoch, ll, time.time() - t0)

    def run_fused(self):
        m, plan = self.m, self.plan
        U, num_items, F = self.U, self.I, self.F
        dev = m.device
        tm, tm0 = m.last_fit_timing_, time.time()
        I_pad = fused_mod.item_pad(num_items)
        packed = m._ensure_packed_hist()
        tm["hist_pack_s"] = round(time.time() - tm0, 2)

        # the tables are fresh tensors (copies): arrays handed out before
        # this fit (`_weights`, `v_i`, ...) keep their values
        w = m.gather_weights()
        U_pad = fused_mod.user_pad(U, plan.user_block)
        tab_u, tab_i = fused_mod.extend_tables(
            w["w_i"], w["v_u"], w["v_i"], U_pad, I_pad)

        # grouped records are ~16 B/row; cache across fit_partial calls
        # (repeated fits on identical data would otherwise pay the host
        # layout + a multi-MB host->device transfer per call).
        # sha256, not a weak checksum: a collision here silently trains
        # every epoch with STALE per-row weights baked into the cached
        # record layout (~10 ms for ML-1M-sized vectors, paid once)
        sw_hash = hashlib.sha256(
            np.ascontiguousarray(m.sample_weight).tobytes()).digest()

        def layout_for(chunk, ub):
            """``(rec on the device, group, cids, ublk, iblk on the host)``,
            cached on the model under the ingest hash (no hash, no cache)."""
            rec_key = (m._ingest_hash, plan.batch_size, chunk, ub, self.n,
                       sw_hash)
            cache = m._rec_cache if isinstance(m._rec_cache, dict) else {}
            if rec_key in cache and m._ingest_hash is not None:
                return cache[rec_key]
            rec, group, cids, ublk, iblk = fused_mod.deal_by_fraction(
                fused_mod.make_records_grouped(
                    m.interactions[:, 0], m.interactions[:, 1],
                    m.sample_weight, U, num_items, plan.batch_size, chunk,
                    ub=ub),
                chunk, U, num_items, ub=ub)
            layout = (torch.from_numpy(rec).to(dev), torch.from_numpy(group),
                      torch.from_numpy(cids), torch.from_numpy(ublk),
                      torch.from_numpy(iblk))
            if m._ingest_hash is not None:
                while len(cache) >= 4:  # both schedule layouts + headroom
                    cache.pop(next(iter(cache)))
                cache[rec_key] = layout
                m._rec_cache = cache
            return layout

        main_layout = layout_for(plan.chunk, plan.user_block)
        # R pre-shuffled layouts cycled over the epochs (`shuffle_layouts`):
        # R sorts a fit instead of one an epoch, built when first used;
        # layout r = (epoch stream position) % R, keyed by (seed, r), so a
        # fit_partial continues the cycle
        R = plan.shuffle_layouts
        shuffled = {}
        shuffle = fused_mod.make_shuffle_fn(U, num_items, ub=plan.user_block)

        def rec_for(epoch):
            r = (self.rng_off + epoch) % R
            if r not in shuffled:
                rec, group = main_layout[:2]
                shuffled[r] = shuffle(rec, group, fused_mod.shuffle_bits(
                    fused_mod.layout_generator(m.seed, r), rec.shape[0]))
            return shuffled[r]

        if m.mesh is not None:
            # each batch's chunks dealt to the ranks (device-major)
            main_layout = main_layout[:2] + fused_mod.split_layout_for_mesh(
                *main_layout[2:], plan.n_dev)
        # grouped record layout: host numpy segmented shuffle + the multi-MB
        # host->device copy
        tm["records_s"] = round(time.time() - tm0 - tm["hist_pack_s"], 2)
        # side features: the padded feature matrices and the small packed
        # feature tables (v_uf; v_if with w_if in col F)
        x_uf = x_if = tab_uf = tab_if = None
        if self.x_uf_any or self.x_if_any:
            tab_uf, tab_if = fused_mod.extend_feature_tables(
                w["v_uf"], w["w_if"], w["v_if"])
            if self.x_uf_any:
                x_uf = fused_mod.pad_feature_cols(m._x_uf_dev, U_pad)
            else:
                tab_uf = None
            if self.x_if_any:
                x_if = fused_mod.pad_feature_cols(m._x_if_dev, I_pad)
            else:
                tab_if = None

        def pull_back():
            w_i, v_u, v_i = fused_mod.extract_tables(
                tab_u, tab_i, U, num_items, F)
            upd = dict(w_i=w_i, v_u=v_u, v_i=v_i)
            v_uf, w_if, v_if = fused_mod.extract_feature_tables(
                tab_uf, tab_if, m.x_uf.shape[1], m.x_if.shape[1], F)
            if tab_uf is not None:
                upd["v_uf"] = v_uf
            if tab_if is not None:
                upd.update(w_if=w_if, v_if=v_if)
            m._w = dict(m._w, **upd)

        self.pull = pull_back

        def run_epochs(epochs, chunk, ub, layout, n_windows, pre_shuffled):
            live = [t for t in (tab_u, tab_i, tab_uf, tab_if) if t is not None]
            # one device, or this rank of the data-parallel mesh
            epoch_fn = make_fused_dp_epoch_fn(
                m.mesh, U, num_items, F, plan.max_samples, plan.batch_size,
                chunk, ub=ub, n_windows=n_windows,
                sync_every=m.dp_sync_every, pre_shuffled=pre_shuffled)
            for epoch in epochs:
                t0 = time.time()
                lay = ((rec_for(epoch),) + layout[1:] if pre_shuffled
                       else layout)
                ll = epoch_fn(
                    tab_u, tab_i, packed, lay, self.eta(epoch), m.alpha,
                    m.seed, self.rng_off + epoch, x_uf=x_uf, x_if=x_if,
                    tab_uf=tab_uf, tab_if=tab_if, beta=m.beta)
                self.log_epoch(epoch, _ll_guard(ll, live), time.time() - t0)

        # chunk-tail schedule: the closing epochs run at the oracle-parity
        # layout (tail_chunk rows @ tail_user_block users), which pads the
        # user table differently — the live tables (and the padded user
        # features) are re-extended
        tm["prep_s"] = round(time.time() - tm0, 2)  # everything pre-epoch-0
        n_ct = plan.chunk_tail
        run_epochs(range(plan.n_main - n_ct), plan.chunk, plan.user_block,
                   main_layout, plan.n_windows, R > 1)
        if n_ct:
            ub_t = plan.tail_user_block
            U_pad_t = fused_mod.user_pad(U, ub_t)
            w_i, v_u, v_i = fused_mod.extract_tables(
                tab_u, tab_i, U, num_items, F)
            tab_u, tab_i = fused_mod.extend_tables(
                w_i, v_u, v_i, U_pad_t, I_pad)
            if x_uf is not None:
                x_uf = fused_mod.pad_feature_cols(m._x_uf_dev, U_pad_t)
            run_epochs(range(plan.n_main - n_ct, plan.n_main),
                       plan.tail_chunk, ub_t,
                       layout_for(plan.tail_chunk, ub_t), plan.n_windows,
                       False)
        tail = range(plan.n_main, plan.n_main + plan.n_tail)
        if plan.n_tail and plan.tail_windows:
            # wide-window tail: the closing epochs run the fused engine at
            # more windows a chunk, on the main layout
            run_epochs(tail, plan.chunk, plan.user_block, main_layout,
                       plan.tail_windows, R > 1)
        pull_back()
        if plan.n_tail and not plan.tail_windows:
            # mixed schedule: the closing epochs run the candidate step,
            # whose negatives are drawn from the whole catalog
            self.run_xla(tail, step_kind='candidate')


class RankFM:
    """Factorization Machines for Ranking Problems with Implicit Feedback Data"""

    def __init__(self, factors=10, loss='bpr', max_samples=10, alpha=0.01, beta=0.1,
                 sigma=0.1, learning_rate=0.1, learning_schedule='constant',
                 learning_exponent=0.25, *, batch_size=None, seed=1492,
                 sample_rounds='auto', neg_sampler='auto', use_fused='auto',
                 train_step='auto', n_windows=None, tail_windows=None,
                 shuffle_layouts='auto', mesh=None, dp_sync_every=1,
                 device='cuda'):
        """store hyperparameters and initialize internal model state

        :param factors: latent factor rank
        :param loss: optimization/loss function to use for training: ['bpr', 'warp']
        :param max_samples: maximum number of negative samples to draw for WARP loss
        :param alpha: L2 regularization penalty on [user, item] model weights
        :param beta: L2 regularization penalty on [user-feature, item-feature] model weights
        :param sigma: standard deviation to use for random initialization of factor weights
        :param learning_rate: initial learning rate for gradient step updates
        :param learning_schedule: schedule for adjusting learning rates by training epoch: ['constant', 'invscaling']
        :param learning_exponent: exponent applied to epoch number to adjust learning rate: scaling = 1 / pow(epoch + 1, learning_exponent)

        Keyword-only extras, as in `rankfm_tpu.RankFM` (see its docstring
        for each), plus:

        :param device: torch device of the weights and of training
            ('cuda' by default; 'cpu' runs the fused engine's plain version)
        :param mesh: a `rankfm_tpu_torch.parallel.make_mesh` mesh: every
            rank trains its placement of the model (the mesh's device
            replaces ``device``)
        :param dp_sync_every: on the data-parallel mesh path, the batches
            each replica runs between two delta all-reduces
        """

        # validate user input
        assert isinstance(factors, int) and factors >= 1, "[factors] must be a positive integer"
        assert isinstance(loss, str) and loss in ('bpr', 'warp'), "[loss] must be in ('bpr', 'warp')"
        assert isinstance(max_samples, int) and max_samples > 0, "[max_samples] must be a positive integer"
        assert isinstance(alpha, float) and alpha > 0.0, "[alpha] must be a positive float"
        assert isinstance(beta, float) and beta > 0.0, "[beta] must be a positive float"
        assert isinstance(sigma, float) and sigma > 0.0, "[sigma] must be a positive float"
        assert isinstance(learning_rate, float) and learning_rate > 0.0, "[learning_rate] must be a positive float"
        assert isinstance(learning_schedule, str) and learning_schedule in ('constant', 'invscaling'), "[learning_schedule] must be in ('constant', 'invscaling')"
        assert isinstance(learning_exponent, float) and learning_exponent > 0.0, "[learning_exponent] must be a positive float"

        self.factors = factors
        self.loss = loss
        self.max_samples = max_samples
        self.alpha = alpha
        self.beta = beta
        self.sigma = sigma
        self.learning_rate = learning_rate
        self.learning_schedule = learning_schedule
        self.learning_exponent = learning_exponent

        assert neg_sampler in ('auto', 'bitmap', 'bsearch'), \
            "[neg_sampler] must be in ('auto', 'bitmap', 'bsearch')"
        assert sample_rounds == 'auto' or (
            isinstance(sample_rounds, int) and sample_rounds >= 1), \
            "[sample_rounds] must be 'auto' or a positive integer"
        assert use_fused in (True, False, 'auto'), \
            "[use_fused] must be in (True, False, 'auto')"
        assert train_step in ('auto', 'window', 'candidate', 'mixed'), \
            "[train_step] must be in ('auto', 'window', 'candidate', 'mixed')"
        assert n_windows is None or (
            isinstance(n_windows, int) and n_windows >= 1), \
            "[n_windows] must be None or a positive integer"
        assert tail_windows is None or (
            isinstance(tail_windows, int) and tail_windows >= 1), \
            "[tail_windows] must be None or a positive integer"
        assert shuffle_layouts == 'auto' or (
            isinstance(shuffle_layouts, int) and shuffle_layouts >= 1), \
            "[shuffle_layouts] must be 'auto' or a positive integer"
        assert isinstance(dp_sync_every, int) and dp_sync_every >= 1, \
            "[dp_sync_every] must be a positive integer"
        self.train_step = train_step
        self.n_windows = n_windows
        self.tail_windows = tail_windows
        self.shuffle_layouts = shuffle_layouts
        self.dp_sync_every = dp_sync_every
        self.batch_size = batch_size
        self.seed = seed
        self.sample_rounds = sample_rounds
        self.neg_sampler = neg_sampler
        self.use_fused = use_fused
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else torch.device(device)

        self._reset_state()

    # --------------------------------
    # private methods
    # --------------------------------

    def _reset_state(self):
        """initialize or reset internal model state"""

        self.user_id = None
        self.item_id = None
        self.user_idx = None
        self.item_idx = None

        self.index_to_user = None
        self.index_to_item = None
        self.user_to_index = None
        self.item_to_index = None

        self.interactions = None
        self.sample_weight = None

        # CSR user -> sorted distinct item history (host numpy), and its
        # device copies for the binary-search sampler
        self._ui_offsets = None
        self._ui_items = None
        self._offsets_dev = None
        self._flat_items_dev = None

        self.x_uf = None
        self.x_if = None

        # weights: dict of tensors on self.device (w_i, w_if, v_u, v_i, v_uf,
        # v_if); after a table-parallel fit, this rank's row shards instead
        self._w = None
        self._x_uf_dev = None
        self._x_if_dev = None
        self._sampler = None
        self._bitmap_dev = None
        self._packed_hist = None
        # fit_partial on the interactions of the call before: their hash,
        # their keep mask, and the record layouts built from them
        self._rec_cache = None
        self._ingest_hash = None
        self._keep_cache = None

        self._user_items_view = None
        self._sim_cache = {}
        self._epoch_offset = 0  # epoch stream position across fit_partial

        # structured per-epoch training log
        self.training_log_ = []
        self.last_fit_plan_ = None
        # wall-clock phases of the most recent fit_partial call (host-side
        # ingest / layout / dispatch and the final device sync), in seconds
        self.last_fit_timing_ = {}

        self.is_fit = False

    # -- weight views (numpy copies on the host) --

    @property
    def _w(self):
        """The weights held whole on this rank, a dict of tensors on the
        model's device. After a table-parallel fit the rank holds only its
        row shards (``_w_tp``): `gather_weights` returns the whole tables
        then, and reading ``_w`` raises."""
        if self._w_tp is not None:
            raise RuntimeError(
                "this rank holds table-parallel row shards: gather_weights(), "
                "called on every rank of the mesh, returns the whole tables")
        return self._w_full

    @_w.setter
    def _w(self, w):
        self._w_full, self._w_tp = w, None

    def gather_weights(self):
        """The whole weights, a dict of tensors on the model's device.

        After a table-parallel fit this is a collective: ONE all-gather of
        the row shards over ``model``, which every rank of the mesh must
        call (as every process reads a JAX global array). `save`,
        ``_weights`` and the weight properties (``v_u``, ``v_i``, ...) call
        it; a read on one rank alone hangs the job."""
        if self._w_tp is None:
            return self._w_full
        from rankfm_tpu_torch.parallel import tp
        return tp.extract(self.mesh, self._w_tp, len(self.user_idx),
                          len(self.item_idx))

    @property
    def _weights(self):
        """The weights as host numpy arrays, keyed as in `rankfm_tpu`
        (`gather_weights`: a collective after a table-parallel fit)."""
        w = self.gather_weights()
        return None if w is None else weights_to_numpy(w)

    @_weights.setter
    def _weights(self, w):
        """Takes numpy arrays or tensors; the model keeps f32 copies on its
        device."""
        self._w = None if w is None else weights_from_numpy(
            {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else v
             for k, v in w.items()}, self.device)

    def _np_weight(self, name):
        w = self.gather_weights()
        return None if w is None else w[name].cpu().numpy()

    @property
    def w_i(self):
        return self._np_weight("w_i")

    @property
    def w_if(self):
        return self._np_weight("w_if")

    @property
    def v_u(self):
        return self._np_weight("v_u")

    @property
    def v_i(self):
        return self._np_weight("v_i")

    @property
    def v_uf(self):
        return self._np_weight("v_uf")

    @property
    def v_if(self):
        return self._np_weight("v_if")

    @property
    def user_items(self):
        """dict view of per-user item histories, cached"""
        if self._ui_offsets is None:
            return None
        if self._user_items_view is None:
            self._user_items_view = csr_to_dict(
                self._ui_offsets, self._ui_items)
        return self._user_items_view

    def _init_all(self, interactions, user_features=None, item_features=None, sample_weight=None):
        """index interactions/features and initialize weights"""

        assert isinstance(interactions, (np.ndarray, pd.DataFrame)), "[interactions] must be np.ndarray or pd.dataframe"
        assert interactions.shape[1] == 2, "[interactions] should be: [user_id, item_id]"

        arr = get_data(interactions)
        self.user_id, self.user_to_index = build_index(arr[:, 0])
        self.item_id, self.item_to_index = build_index(arr[:, 1])
        self.index_to_user = self.user_id
        self.index_to_item = self.item_id
        self.user_idx = np.arange(len(self.user_id), dtype=np.int32)
        self.item_idx = np.arange(len(self.item_id), dtype=np.int32)

        self._init_interactions(interactions, sample_weight)
        self._init_features(user_features, item_features)
        self._init_weights(user_features, item_features)

    def _init_interactions(self, interactions, sample_weight):
        """map new interactions to the existing internal indexes

        Unknown (user, item) pairs are silently dropped; ``sample_weight`` rows
        for dropped pairs are dropped with them.
        """

        assert isinstance(interactions, (np.ndarray, pd.DataFrame)), "[interactions] must be np.ndarray or pd.dataframe"
        assert interactions.shape[1] == 2, "[interactions] should be: [user_id, item_id]"

        # re-presenting identical interactions (warm-start loops, repeated
        # fit_partial) skips the whole map/CSR/pack rebuild: the history
        # union with itself is a no-op
        h = self._hash_interactions(interactions)
        if (self.is_fit and h is not None and h == self._ingest_hash
                and self._keep_cache is not None):
            keep = self._keep_cache
            unchanged = True
        else:
            unchanged = False
            prev_csr = (self._ui_offsets, self._ui_items) if self.is_fit else None
            ingested = self._native_ingest(interactions, prev_csr)
            if ingested is not None:
                pairs, keep, offsets, items = ingested
                self.interactions = pairs
            else:
                pairs, keep = map_interactions(interactions, self.user_to_index, self.item_to_index)
                self.interactions = pairs
                offsets, items = build_user_items_csr(pairs, len(self.user_idx))
                if prev_csr is not None:
                    # fit_partial: union with previous histories
                    offsets, items = merge_user_items_csr(
                        prev_csr[0], prev_csr[1], offsets, items, len(self.user_idx))
            self._ingest_hash = h
            self._keep_cache = keep

        if sample_weight is not None:
            assert isinstance(sample_weight, (np.ndarray, pd.Series)), "[sample_weight] must be np.ndarray or pd.series"
            assert sample_weight.ndim == 1, "[sample_weight] must a vector (ndim=1)"
            assert len(sample_weight) == len(interactions), "[sample_weight] must have the same length as [interactions]"
            self.sample_weight = np.ascontiguousarray(get_data(sample_weight)[keep], dtype=np.float32)
        else:
            self.sample_weight = np.ones(len(self.interactions), dtype=np.float32)
        if unchanged:
            return
        self._ui_offsets, self._ui_items = offsets, items
        self._offsets_dev = torch.from_numpy(offsets).to(self.device)
        self._flat_items_dev = torch.from_numpy(items).to(self.device)
        self._packed_hist = None  # history changed: rebuild lazily
        self._rec_cache = None
        self._user_items_view = None

        # retrieval filters seen items through the packed bitmap when it
        # fits in ~512 MB, else by scattering the seen pairs
        U, I = len(self.user_idx), len(self.item_idx)
        words = (I + 31) // 32
        if self.neg_sampler == 'bitmap' or (
                self.neg_sampler == 'auto' and U * words * 4 <= 512 * 2**20):
            self._sampler = 'bitmap'
        else:
            self._sampler = 'bsearch'
        self._bitmap_dev = None

    def _raw_id_columns(self, interactions):
        """The raw user and item id columns as int64, or None unless both
        are integer columns (`_int64_view`)."""
        arr = get_data(interactions)
        u_raw, i_raw = _int64_view(arr[:, 0]), _int64_view(arr[:, 1])
        if u_raw is None or i_raw is None:
            return None
        return u_raw, i_raw

    def _hash_interactions(self, interactions):
        """native content hash of the raw id columns; None when unavailable"""
        raw = self._raw_id_columns(interactions)
        return None if raw is None else native.hash_pairs(*raw)

    def _native_ingest(self, interactions, prev_csr):
        """One-pass C++ map+filter+CSR ingest (int ids only); None -> fallback."""
        raw = self._raw_id_columns(interactions)
        uids = _int64_view(self.user_to_index.index.values)
        iids = _int64_view(self.item_to_index.index.values)
        if raw is None or uids is None or iids is None:
            return None
        return native.ingest(*raw, uids, iids, prev_csr)

    def _ensure_bitmap(self):
        """The packed membership bitmap (int32 words) on first use; a 1x1
        placeholder when the binary-search sampler is in use."""
        if self._bitmap_dev is None:
            if self._sampler == 'bitmap':
                bm = build_bitmap_words(self._ui_offsets, self._ui_items,
                                        len(self.user_idx), len(self.item_idx))
                self._bitmap_dev = torch.from_numpy(
                    bm.view(np.int32)).to(self.device)
            else:
                self._bitmap_dev = torch.zeros((1, 1), dtype=torch.int32,
                                               device=self.device)
        return self._bitmap_dev

    def _ensure_packed_hist(self):
        """The blocked 16-bit history pack (`fused.pack_history`) that the
        fused engine and the window step read, on first use."""
        if self._packed_hist is None:
            self._packed_hist = torch.from_numpy(fused_mod.pack_history(
                self._ui_offsets, self._ui_items, len(self.user_idx),
                len(self.item_idx))).to(self.device)
        return self._packed_hist

    def _init_features(self, user_features=None, item_features=None):
        """store user/item feature matrices row-ordered by index"""

        if user_features is not None:
            self.x_uf = validate_features(user_features, self.user_to_index, self.user_idx, "user")
        else:
            self.x_uf = np.zeros([len(self.user_idx), 1], dtype=np.float32)

        if item_features is not None:
            self.x_if = validate_features(item_features, self.item_to_index, self.item_idx, "item")
        else:
            self.x_if = np.zeros([len(self.item_idx), 1], dtype=np.float32)

        self._x_uf_dev = torch.from_numpy(self.x_uf).to(self.device)
        self._x_if_dev = torch.from_numpy(self.x_if).to(self.device)

    def _init_weights(self, user_features=None, item_features=None):
        """initialize model weights: biases zero, factors ~ N(0, sigma),
        feature factors ~ N(0, (alpha/beta)*sigma) when features are
        supplied else zero. The draws come from a generator seeded with
        ``self.seed``, so they equal `rankfm_tpu`'s bit for bit."""

        U, I, F = len(self.user_idx), len(self.item_idx), self.factors
        P, Q = self.x_uf.shape[1], self.x_if.shape[1]
        rng = np.random.default_rng(self.seed)

        w_i = np.zeros(I, dtype=np.float32)
        w_if = np.zeros(Q, dtype=np.float32)
        v_u = rng.normal(0, self.sigma, (U, F)).astype(np.float32)
        v_i = rng.normal(0, self.sigma, (I, F)).astype(np.float32)

        feat_scale = (self.alpha / self.beta) * self.sigma
        if user_features is not None:
            v_uf = rng.normal(0, feat_scale, (P, F)).astype(np.float32)
        else:
            v_uf = np.zeros((P, F), dtype=np.float32)
        if item_features is not None:
            v_if = rng.normal(0, feat_scale, (Q, F)).astype(np.float32)
        else:
            v_if = np.zeros((Q, F), dtype=np.float32)

        w = {"w_i": w_i, "w_if": w_if, "v_u": v_u, "v_i": v_i,
             "v_uf": v_uf, "v_if": v_if}
        self._w = {k: torch.from_numpy(w[k]).to(self.device) for k in _WEIGHT_NAMES}

    def _assert_finite(self):
        """divergence guard: name the first non-finite weight tensor"""
        names = {
            "w_i": "item weights [w_i]",
            "w_if": "item feature weights [w_if]",
            "v_u": "user factors [v_u]",
            "v_i": "item factors [v_i]",
            "v_uf": "user-feature factors [v_uf]",
            "v_if": "item-feature factors [v_if]",
        }
        w = self.gather_weights()
        for k, label in names.items():
            assert bool(torch.isfinite(w[k]).all()), \
                f"{label} are not finite - try decreasing feature/sample_weight magnitudes"

    def _reg_penalty(self):
        """total L2 penalty over all weights"""
        w = self.gather_weights()
        pen = 0.0
        for k in ("w_i", "v_u", "v_i"):
            pen += self.alpha * float(torch.sum(torch.square(w[k])))
        for k in ("w_if", "v_uf", "v_if"):
            pen += self.beta * float(torch.sum(torch.square(w[k])))
        return pen

    # --------------------------------
    # public methods
    # --------------------------------

    def fit(self, interactions, user_features=None, item_features=None,
            sample_weight=None, epochs=1, verbose=False):
        """clear previous model state and learn new model weights using the input data

        :param interactions: dataframe of observed user/item interactions: [user_id, item_id]
        :param user_features: dataframe of user metadata features: [user_id, uf_1, ..., uf_n]
        :param item_features: dataframe of item metadata features: [item_id, if_1, ..., if_n]
        :param sample_weight: vector of importance weights for each observed interaction
        :param epochs: number of training epochs (full passes through observed interactions)
        :param verbose: whether to print epoch number and log-likelihood during training
        :return: self
        """
        self._reset_state()
        self.fit_partial(interactions, user_features, item_features, sample_weight, epochs, verbose)
        return self

    def fit_partial(self, interactions, user_features=None, item_features=None,
                    sample_weight=None, epochs=1, verbose=False):
        """learn or update model weights resuming from the current state

        The regime decisions are resolved by the pure planner
        (`rankfm_tpu_torch.models.planner.plan_fit`); the resolved `FitPlan`
        is exposed as ``self.last_fit_plan_``.
        """

        assert isinstance(epochs, int) and epochs >= 1, "[epochs] must be a positive integer"
        assert isinstance(verbose, bool), "[verbose] must be a boolean value"

        t_fp0 = time.time()
        if self.is_fit:
            self._init_interactions(interactions, sample_weight)
            self._init_features(user_features, item_features)
            # the feature tables replicate on every placement: no gather
            w = self._w_full if self._w_tp is None else self._w_tp
            for side, x, vf in (("user", self.x_uf, w["v_uf"]),
                                ("item", self.x_if, w["v_if"])):
                assert x.shape[1] == vf.shape[0], (
                    f"[{side}_features] column count changed since fit() "
                    f"({x.shape[1]} vs {vf.shape[0]}): feature weights are "
                    "frozen across fit_partial - call fit() to rebuild them")
        else:
            self._init_all(interactions, user_features, item_features, sample_weight)
        # ingest = id mapping + CSR history + weight init, all host work
        # (plus the copies to the device); _FitRun fills in the other phases
        self.last_fit_timing_ = {"ingest_s": round(time.time() - t_fp0, 2)}

        sw = self.sample_weight
        U, I, F = len(self.user_idx), len(self.item_idx), self.factors
        P, Q = self.x_uf.shape[1], self.x_if.shape[1]
        spec = FitSpec(
            n=len(self.interactions),
            num_users=len(self.user_idx), num_items=len(self.item_idx),
            factors=self.factors, loss=self.loss,
            max_samples=self.max_samples, epochs=epochs,
            x_uf_any=bool(self.x_uf.any()), x_if_any=bool(self.x_if.any()),
            num_uf=self.x_uf.shape[1], num_if=self.x_if.shape[1],
            nnz_hist=len(self._ui_items),
            mean_sample_weight=float(np.mean(sw)) if len(sw) else 1.0,
            # the fused engine runs on every device the port supports: the
            # CUDA kernel on a GPU, its plain version on the CPU
            on_gpu=True, mesh=self.mesh,
            # the bytes of the six weight tensors, from their shapes
            table_bytes=4 * (I + Q + (U + I + P + Q) * F),
            batch_size=self.batch_size, train_step=self.train_step,
            use_fused=self.use_fused, n_windows=self.n_windows,
            tail_windows=self.tail_windows, sample_rounds=self.sample_rounds,
            shuffle_layouts=self.shuffle_layouts,
        )
        plan = plan_fit(spec)
        self.last_fit_plan_ = plan
        _FitRun(self, plan, verbose).run()

        self._epoch_offset += epochs  # fresh streams on the next fit_partial
        self._sim_cache = {}  # weights changed: cached latent reps are stale
        self.is_fit = True
        return self

    def predict(self, pairs, cold_start='nan'):
        """calculate the predicted pointwise utilities for all (user, item) pairs

        :param pairs: dataframe of [user, item] pairs to score
        :param cold_start: 'nan' to emit NaN for unseen users/items, 'drop' to remove them
        :return: np.array of real-valued model scores (float32)
        """
        assert isinstance(pairs, (np.ndarray, pd.DataFrame)), "[pairs] must be np.ndarray or pd.dataframe"
        assert pairs.shape[1] == 2, "[pairs] should be: [user_id, item_id]"
        assert self.is_fit, "you must fit the model prior to generating predictions"

        arr = get_data(pairs)
        u = map_ids_float(arr[:, 0], self.user_to_index)
        i = map_ids_float(arr[:, 1], self.item_to_index)
        known = ~(np.isnan(u) | np.isnan(i))
        u_idx = torch.from_numpy(np.where(known, u, 0).astype(np.int64)).to(self.device)
        i_idx = torch.from_numpy(np.where(known, i, 0).astype(np.int64)).to(self.device)
        if self._w_tp is not None:
            # the pairs' rows from their owners' shards: two exchanges
            from rankfm_tpu_torch.parallel import tp
            scores = tp.score_pairs(self.mesh, self._w_tp, self._x_uf_dev,
                                    self._x_if_dev, u_idx, i_idx)
        else:
            scores = scoring.score_pairs(self._w, self._x_uf_dev,
                                         self._x_if_dev, u_idx, i_idx)
        scores = scores.cpu().numpy()
        scores = np.where(known, scores, np.nan).astype(np.float32)

        if cold_start == 'nan':
            return scores
        elif cold_start == 'drop':
            return scores[~np.isnan(scores)]
        else:
            raise ValueError("param [cold_start] must be set to either 'nan' or 'drop'")

    def _seen_pairs_for(self, user_idx_batch):
        """host-side (row, col) pairs of previously seen items for a user batch"""
        return csr_row_pairs(self._ui_offsets, self._ui_items, user_idx_batch)

    def recommend(self, users, n_items=10, filter_previous=False, cold_start='nan'):
        """calculate the topN items for each user

        :param users: iterable of user identifiers for which to generate recommendations
        :param n_items: number of recommended items to generate for each user
        :param filter_previous: remove observed training items from generated recommendations
        :param cold_start: 'nan' to emit NaN rows for unseen users, 'drop' to remove them
        :return: pandas dataframe indexed by user id with recommended items as columns
        """
        assert getattr(users, '__iter__', False), "[users] must be an iterable (e.g. list, array, series)"
        assert self.is_fit, "you must fit the model prior to generating recommendations"

        users_arr = pd.Series(users).values
        user_idx = map_ids_float(users_arr, self.user_to_index)
        known = ~np.isnan(user_idx)
        known_idx = user_idx[known].astype(np.int64)

        # can't recommend more items than the catalog holds
        n_items = min(int(n_items), len(self.item_idx))
        use_bitmap_filter = (filter_previous and self.mesh is None
                             and self._sampler == 'bitmap')

        out = np.full((len(user_idx), n_items), np.nan, dtype=np.float64)
        if len(known_idx):
            chunks = []
            chunk_sz = _recommend_chunk(len(self.item_idx))
            no_seen = torch.zeros(0, dtype=torch.int64, device=self.device)
            if self.mesh is not None:
                # this rank's item shard: the rows it owns after a
                # table-parallel fit, else its slice of the whole tables
                from rankfm_tpu_torch.parallel import retrieval
                sharded = self._w_tp is not None
                w = self._w_tp if sharded else self._w
                i_mat, ib = retrieval.item_operands(
                    self.mesh, w, self._x_if_dev, len(self.item_idx), sharded)
            for s in range(0, len(known_idx), chunk_sz):
                batch = known_idx[s:s + chunk_sz]
                u_dev = torch.from_numpy(batch).to(self.device)
                if use_bitmap_filter:
                    top_items, _ = topk.topk_bitmap(
                        self._w, self._x_uf_dev, self._x_if_dev, u_dev,
                        n_items, self._ensure_bitmap())
                else:
                    rows = cols = no_seen
                    if filter_previous:
                        r, c = self._seen_pairs_for(batch)
                        rows = torch.from_numpy(r.astype(np.int64)).to(self.device)
                        cols = torch.from_numpy(c.astype(np.int64)).to(self.device)
                    if self.mesh is not None:
                        u_mat = retrieval.user_operands(
                            self.mesh, w, self._x_uf_dev, u_dev, sharded)
                        top_items, _ = retrieval.sharded_topk(
                            self.mesh, u_mat, i_mat, ib, rows, cols, n_items)
                    else:
                        top_items, _ = topk.topk_for_users(
                            self._w, self._x_uf_dev, self._x_if_dev, u_dev,
                            n_items, rows, cols)
                chunks.append(top_items.cpu().numpy())
            out[known] = np.concatenate(chunks, axis=0)
            # -1 = exhausted-catalog slot -> NaN, never a wrapped-around id
            out[out < 0] = np.nan

        rec_items = pd.DataFrame(
            remap_indices(self.index_to_item.values, out),
            index=pd.Index(users_arr),
        )

        if cold_start == 'nan':
            return rec_items
        elif cold_start == 'drop':
            return rec_items.dropna(how='any')
        else:
            raise ValueError("param [cold_start] must be set to either 'nan' or 'drop'")

    def _similar_rows(self, idx, factor_key, feat_factor_key, feats,
                      index_map, n):
        """top-n rows by latent-rep dot product, the search row excluded;
        the rep matrix ``V + feats @ V_f`` is cached until the weights
        change"""
        reps = self._sim_cache.get(factor_key)
        if reps is None:
            w = self.gather_weights()
            reps = w[factor_key] + feats @ w[feat_factor_key]
            self._sim_cache[factor_key] = reps
        k = min(n, reps.shape[0] - 1)
        sims = reps @ reps[idx]
        sims[idx] = float("-inf")
        top = torch.topk(sims, k).indices.cpu().numpy()
        return pd.Series(top).map(index_map).values

    def similar_items(self, item_id, n_items=10):
        """find the most similar items wrt latent factor space representation

        :param item_id: item to search
        :param n_items: number of similar items to return
        :return: np.array of topN most similar items
        """
        assert item_id in self.item_id.values, "you must select an [item_id] present in the training data"
        assert self.is_fit, "you must fit the model prior to generating similarities"

        item_idx = int(self.item_to_index.loc[item_id])
        return self._similar_rows(item_idx, "v_i", "v_if", self._x_if_dev,
                                  self.index_to_item, n_items)

    def similar_users(self, user_id, n_users=10):
        """find the most similar users wrt latent factor space representation

        :param user_id: user to search
        :param n_users: number of similar users to return
        :return: np.array of topN most similar users
        """
        assert user_id in self.user_id.values, "you must select an [user_id] present in the training data"
        assert self.is_fit, "you must fit the model prior to generating similarities"

        user_idx = int(self.user_to_index.loc[user_id])
        return self._similar_rows(user_idx, "v_u", "v_uf", self._x_uf_dev,
                                  self.index_to_user, n_users)

    # --------------------------------
    # checkpointing
    # --------------------------------

    def save(self, path):
        """serialize the fitted model (weights + id maps + config) to ``path``"""
        from rankfm_tpu_torch.utils.checkpoint import save_model
        save_model(self, path)

    @classmethod
    def load(cls, path, allow_pickle=False, device='cuda'):
        """restore a model saved with :meth:`save`, by this package or by
        `rankfm_tpu`

        :param allow_pickle: opt-in for old checkpoints that stored string
            ids as pickled object arrays. Current checkpoints are
            pickle-free and load with the safe default — never enable this
            for an untrusted file.
        :param device: torch device of the restored model (the file does
            not name one)
        """
        from rankfm_tpu_torch.utils.checkpoint import load_model
        return load_model(cls, path, allow_pickle=allow_pickle, device=device)
