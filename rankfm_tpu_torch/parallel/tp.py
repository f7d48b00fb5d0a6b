"""Explicit table-parallel (TP) training: row-sharded embedding tables with
owner-shard exchanges (port of `rankfm_tpu/parallel/tp.py`), for weights
too large to replicate per device.

* **tables** (``v_u``, ``v_i``, ``w_i`` and the feature matrices) are
  row-sharded over ``model``, padded to even shards (`pad_and_place`); the
  small dense feature weights replicate;
* **batch**: each ``data`` rank takes its ``1/data`` of every global batch;
  the ``model`` ranks of one ``data`` rank run the same rows;
* **lookups** are owner-masked local gathers plus ONE all-reduce over
  ``model`` per lookup group (`owner_gather`: a rank that does not own a
  row contributes zeros): one for the batch's user rows, one for the item
  rows (positive and candidates, or positive and windows);
* **selection** runs identically on every ``model`` replica (the same
  inputs after the exchange, the same draws: their keys are those of the
  ``data`` rank), with the single-device steps' code
  (`ops.training.warp_select`, `window_warp_select`); the window step
  splits its groups over ``model`` when their count allows and gathers the
  per-row outcomes back;
* **updates**: the selected pairs' payloads ride ONE all-gather over
  ``data`` (O(batch * F), never table-sized); every rank applies the rows it
  owns through `scatter.apply_table_update` (kernels B2/B3 on the card) with
  its indices made local and the others masked; the dense feature-weight
  gradients are summed over ``data`` by one all-reduce.

After each epoch one all-reduce sums the log-likelihood over ``data`` and
every shard's count of non-finite values over all ranks, so that every rank
sees the same divergence verdict.
"""

from __future__ import annotations

import math

import torch

from rankfm_tpu_torch.ops import fused as fused_mod
from rankfm_tpu_torch.ops import training
from rankfm_tpu_torch.ops.negatives import (
    bitmap_member, csr_member, draw_candidates)
from rankfm_tpu_torch.ops.scatter import apply_table_update, decay_c
from rankfm_tpu_torch.parallel.mesh import feature_shardings, weight_shardings

ROW_SHARDED = ("w_i", "v_i", "v_u")


def _pad_rows(n, shards):
    return -(-n // shards) * shards


def shard_rows(mesh, a, rows_pad):
    """This rank's ``model`` shard of the row table ``a`` (tensor or numpy)
    padded with zero rows to ``rows_pad``: rows ``[m * R, (m + 1) * R)``
    with ``R = rows_pad / model``, a new f32 tensor on the mesh's device."""
    R = rows_pad // mesh.shape["model"]
    lo = mesh.model_rank * R
    a = torch.as_tensor(a)
    out = torch.zeros((R,) + tuple(a.shape[1:]), dtype=a.dtype,
                      device=mesh.device)
    hi = min(lo + R, a.shape[0])
    if hi > lo:
        out[:hi - lo] = a[lo:hi]
    return out


def pad_and_place(mesh, w, x_uf, x_if):
    """``(w_tp, x_uf_tp, x_if_tp)``: this rank's row shards of the tables
    that `weight_shardings` splits over ``model`` and of the feature
    matrices (None stays None), the rest copied; pad rows are zeros (a zero
    row scores 0 and no index points at it)."""
    m = mesh.shape["model"]
    U_pad = _pad_rows(w["v_u"].shape[0], m)
    I_pad = _pad_rows(w["v_i"].shape[0], m)
    rows = {"w_i": I_pad, "v_i": I_pad, "v_u": U_pad, "x_uf": U_pad,
            "x_if": I_pad}
    specs = dict(weight_shardings(mesh), **feature_shardings(mesh))

    def place(k, v):
        if v is None:
            return None
        if specs[k][:1] == ("model",):
            return shard_rows(mesh, v, rows[k])
        return torch.as_tensor(v).to(mesh.device, copy=True)

    return ({k: place(k, v) for k, v in w.items()}, place("x_uf", x_uf),
            place("x_if", x_if))


def extract(mesh, w_tp, num_users, num_items):
    """The whole tables from every rank's shards: ONE all-gather over
    ``model`` (every rank must call it), the padding sliced off."""
    parts = [w_tp[k] for k in ROW_SHARDED]
    flat = torch.cat([p.reshape(-1) for p in parts])
    shards = mesh.all_gather(flat, "model", tag="extract")
    out = {k: v for k, v in w_tp.items() if k not in ROW_SHARDED}
    off = 0
    for k, p, n in zip(ROW_SHARDED, parts,
                       (num_items, num_items, num_users)):
        rows = [s[off:off + p.numel()].view_as(p) for s in shards]
        out[k] = torch.cat(rows, 0)[:n].clone()
        off += p.numel()
    return out


def pad_packed_hist(mesh, packed, num_users):
    """This rank's ``model`` shard of the blocked history pack (pad rows
    are zeros: pad users never appear in a batch)."""
    return shard_rows(mesh, packed, _pad_rows(num_users, mesh.shape["model"]))


def owned(mesh, idx, rows):
    """``(safe local row, owned)`` of global rows ``idx`` on this rank's
    ``rows``-row shard."""
    local = idx - mesh.model_rank * rows
    ok = (local >= 0) & (local < rows)
    return torch.where(ok, local, 0), ok


def exchange(mesh, ok, cols):
    """Each entry of ``cols`` (``[N, ...]`` values this rank read at its
    safe rows) masked to the rows it owns, then ONE all-reduce over
    ``model`` of them side by side: every rank gets every row from its
    owner. Returns f32 ``[N, width]`` tensors in the order of ``cols``
    (int32 history words are < 2^16, so they ride exactly as f32)."""
    n = ok.shape[0]
    flat = [c.reshape(n, -1).to(torch.float32) for c in cols]
    widths = [c.shape[1] for c in flat]
    flat = torch.where(ok[:, None], torch.cat(flat, 1), 0.0)
    mesh.all_reduce(flat, "model", tag="owner_gather")
    return list(torch.split(flat, widths, 1))


def owner_gather(mesh, idx, shards):
    """Rows ``idx`` of row-sharded tables (each ``[R, ...]`` on this rank)
    from their owners, through one `exchange`."""
    safe, ok = owned(mesh, idx, shards[0].shape[0])
    return exchange(mesh, ok, [s[safe] for s in shards])


def score_pairs(mesh, w_tp, x_uf, x_if, u_idx, i_idx):
    """`ops.scoring.score_pairs` of the pairs ``(u_idx, i_idx)`` from the
    row shards ``w_tp``: the pairs' user rows and item rows from their
    owners (two exchanges over ``model``, every rank calls it), scored with
    the whole feature matrices ``x_uf`` / ``x_if``."""
    from rankfm_tpu_torch.ops.scoring import score_pairs as score

    v_u, = owner_gather(mesh, u_idx, [w_tp["v_u"]])
    v_i, w_i = owner_gather(mesh, i_idx, [w_tp["v_i"], w_tp["w_i"]])
    rows = torch.arange(u_idx.shape[0], device=u_idx.device)
    w = dict(w_tp, v_u=v_u, v_i=v_i, w_i=w_i[:, 0])
    return score(w, x_uf[u_idx], x_if[i_idx], rows, rows)


def _local_index(mesh, idx, rows):
    """int32 rows of global ``idx`` on this rank's shard, -1 where another
    rank owns the row (or ``idx`` is -1)."""
    safe, ok = owned(mesh, idx, rows)
    return torch.where(ok, safe, -1).to(torch.int32)


def _apply_updates(mesh, w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b,
                   v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos,
                   feat_rep_j, eta, alpha, beta, x_uf_any, x_if_any):
    """The TP update block of both steps (`_tp_apply_updates`,
    `rankfm_tpu/parallel/tp.py:96-165`): the feature-weight gradients
    summed over ``data``, the pair payloads gathered over ``data``, then
    each rank's owned rows through `apply_table_update`."""
    D = mesh.shape["data"]
    grads = training.feature_grads(w, d, row_ok, v_u_b, x_uf_b, v_i_pos,
                                   v_i_j, x_if_pos, x_if_j, x_uf_any,
                                   x_if_any)
    if D > 1:
        parts = [t for g in grads.values() for t in g]
        flat = torch.cat([t.reshape(-1) for t in parts])
        mesh.all_reduce(flat, "data", tag="feature_grads")
        out, off = [], 0
        for t in parts:
            out.append(flat[off:off + t.numel()].view_as(t))
            off += t.numel()
        grads = {k: (out[2 * n], out[2 * n + 1])
                 for n, k in enumerate(grads)}
    new_w = {k: training._decay_apply(w[k], g, cnt, eta, beta)
             for k, (g, cnt) in grads.items()}

    g_u_rows = training.user_row_grads(d, v_i_pos, v_i_j, feat_rep_pos,
                                       feat_rep_j)
    if D > 1:
        F = user_rep_b.shape[1]
        # the indices ride as their int32 bits: an all-gather only copies
        ids = torch.stack([u, i, j], 1).to(torch.int32).view(torch.float32)
        pay = torch.cat([ids, d[:, None], row_ok[:, None], user_rep_b,
                         g_u_rows], 1)
        pay = torch.cat(mesh.all_gather(pay, "data", tag="payload"), 0)
        u, i, j = pay[:, :3].contiguous().view(torch.int32).long().unbind(1)
        d, row_ok = pay[:, 3], pay[:, 4]
        user_rep_b, g_u_rows = pay[:, 5:5 + F], pay[:, 5 + F:]
    idx_i2, upd_i2, idx_u, upd_u = training.table_rows(
        u, i, j, d, row_ok, user_rep_b, g_u_rows)
    c_a = decay_c(eta, alpha)
    new_w["v_i"], new_w["w_i"] = apply_table_update(
        w["v_i"], w["w_i"], _local_index(mesh, idx_i2, w["v_i"].shape[0]),
        upd_i2, eta, c_a)
    new_w["v_u"], _ = apply_table_update(
        w["v_u"], None, _local_index(mesh, idx_u, w["v_u"].shape[0]), upd_u,
        eta, c_a)
    return new_w


def _user_side(mesh, w, x_uf, u, x_uf_any, extra=()):
    """``(v_u_b, x_uf_b, *extra)``: the batch's user rows and feature rows,
    and the values of ``extra`` (functions of the safe local rows), through
    one exchange."""
    safe, ok = owned(mesh, u, w["v_u"].shape[0])
    cols = [w["v_u"][safe]] + ([x_uf[safe]] if x_uf_any else [])
    got = exchange(mesh, ok, cols + [f(safe) for f in extra])
    v_u_b = got[0]
    x_uf_b = got[1] if x_uf_any else torch.zeros(
        (u.shape[0], x_uf.shape[1]), device=u.device)
    return (v_u_b, x_uf_b) + tuple(got[1 + x_uf_any:])


def _item_side(mesh, w, x_if, idx, x_if_any):
    """``(v_i rows, feature reps, biases, x_if rows)`` of items ``idx``
    through one exchange."""
    shards = [w["v_i"], w["w_i"]] + ([x_if] if x_if_any else [])
    got = owner_gather(mesh, idx, shards)
    v_i_rows, w_i_rows = got[0], got[1][:, 0]
    if x_if_any:
        x_if_rows = got[2]
        return (v_i_rows, x_if_rows @ w["v_if"],
                w_i_rows + x_if_rows @ w["w_if"], x_if_rows)
    x_if_rows = torch.zeros((idx.shape[0], x_if.shape[1]), device=idx.device)
    return v_i_rows, torch.zeros_like(v_i_rows), w_i_rows, x_if_rows


def make_tp_train_step(mesh, num_items, max_samples, x_uf_any, x_if_any,
                       sample_rounds=8, max_row_len=None, post_reject=False,
                       sampler="bsearch"):
    """The candidate step over row-sharded tables (`_make_tp_step`,
    `rankfm_tpu/parallel/tp.py:168-291`), as a `training.TrainStep`: the
    binary-search sampler over the replicated CSR history (``hist =
    {'offsets', 'flat'}``), or ``sampler='bitmap'`` over the replicated
    membership bitmap (``hist['bitmap']``), or post-hoc rejection of the
    selected negative."""
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    post_reject = post_reject and M > 1
    n_draws = training.candidate_draw_count(sampler, sample_rounds,
                                            post_reject)

    def draw(key, B):
        return draw_candidates(key, n_draws, B, M, num_items)

    def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, draws):
        B = u.shape[0]
        cands, cand_ok = training.candidates(hist, u, num_items, M, draws,
                                             sampler, post_reject,
                                             max_row_len)
        v_u_b, x_uf_b = _user_side(mesh, w, x_uf, u, x_uf_any)
        user_rep_b = v_u_b + x_uf_b @ w["v_uf"]
        idx_items = torch.cat([i[:, None], cands.long()], 1).reshape(-1)
        v_i_rows, feat_rows, bias_rows, x_if_rows = _item_side(
            mesh, w, x_if, idx_items, x_if_any)
        if x_uf_any or x_if_any:
            u_mat = torch.cat([user_rep_b, v_u_b], 1)
            i_rows_mat = torch.cat([v_i_rows, feat_rows], 1)
        else:
            u_mat, i_rows_mat = v_u_b, v_i_rows
        scores = ((u_mat.repeat_interleave(M + 1, 0) * i_rows_mat).sum(1)
                  + bias_rows).reshape(B, M + 1)
        pairwise = torch.where(cand_ok, scores[:, :1] - scores[:, 1:],
                               float("inf"))
        picked = training.warp_select(pairwise, cands, cand_ok, M)
        if post_reject:
            def member_of_j(jj):
                if sampler == "bitmap":
                    return bitmap_member(hist["bitmap"], u, jj[:, None])[:, 0]
                return csr_member(hist["flat"], hist["offsets"], u, jj,
                                  max_row_len)
            picked = training.reselect_members(pairwise, cands, cand_ok,
                                               picked, member_of_j, M)
        sel, sampled, j, pw, ok_sel = picked
        row_ok = (valid & ok_sel & torch.isfinite(pw)).to(torch.float32)
        d, ll = training.candidate_terms(row_ok, sw, sampled, pw, num_items,
                                         log_I)
        # the selected pair's rows, sliced out of the exchanged rows
        grid = torch.arange(B, device=u.device) * (M + 1)
        sel_flat = grid + 1 + sel
        new_w = _apply_updates(
            mesh, w, u, i, j.long(), d, row_ok, v_u_b, user_rep_b, x_uf_b,
            v_i_rows[grid], v_i_rows[sel_flat], x_if_rows[grid],
            x_if_rows[sel_flat], feat_rows[grid], feat_rows[sel_flat], eta,
            alpha, beta, x_uf_any, x_if_any)
        return new_w, ll

    return training.TrainStep(draw, apply)


def make_tp_window_step(mesh, num_items, max_samples, x_uf_any, x_if_any):
    """The window step over row-sharded tables (`_make_tp_window_step`,
    `rankfm_tpu/parallel/tp.py:294-476`), as a `training.TrainStep` with
    the single-device window step's draws. ``hist = {'packed': this rank's
    shard of the history pack}`` (`pad_packed_hist`).

    Per batch: one exchange of the user rows with each row's window history
    words, one of the window and positive item rows; the selection splits
    its groups over ``model`` when their count allows (every rank reads
    the same uniforms, so the split changes no draw) and one all-gather
    brings the per-row outcomes back."""
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    BLK = fused_mod.block_size(num_items)
    LW = BLK // fused_mod.BITS_PER_LANE
    msz = mesh.shape["model"]
    draw = training.make_window_train_step(num_items, max_samples, x_uf_any,
                                           x_if_any).draw

    def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta,
              draws):
        blkg, u01, r1 = draws
        B = u.shape[0]
        G = blkg.shape[0]
        Bg = B // G
        dev = u.device
        blk_l = blkg.long()
        lanes = blk_l[:, None] * LW + torch.arange(LW, device=dev)[None, :]

        def window_words(safe):
            return hist["packed"][safe.reshape(G, Bg, 1), lanes[:, None, :]]

        v_u_b, x_uf_b, words = _user_side(mesh, w, x_uf, u, x_uf_any,
                                          (window_words,))
        user_rep_b = v_u_b + x_uf_b @ w["v_uf"]
        win_idx = (blk_l[:, None] * BLK
                   + torch.arange(BLK, device=dev)[None, :]).reshape(-1)
        rows, feat, bias, x_if_rows = _item_side(
            mesh, w, x_if, torch.cat([win_idx, i]), x_if_any)
        nw = G * BLK
        v_i_win, v_i_pos = rows[:nw], rows[nw:]
        feat_win, feat_rep_pos = feat[:nw], feat[nw:]
        bias_win, bias_pos = bias[:nw], bias[nw:]
        x_if_win, x_if_pos = x_if_rows[:nw], x_if_rows[nw:]
        if x_uf_any or x_if_any:
            u_mat = torch.cat([user_rep_b, v_u_b], 1)
            i_pos_mat = torch.cat([v_i_pos, feat_rep_pos], 1)
            i_win_mat = torch.cat([v_i_win, feat_win], 1)
        else:
            u_mat, i_pos_mat, i_win_mat = v_u_b, v_i_pos, v_i_win
        ut_ui = (u_mat * i_pos_mat).sum(1) + bias_pos

        # this rank's contiguous groups when the model axis splits them
        split = msz > 1 and G % msz == 0
        Gs = G // msz if split else G
        gs = slice(mesh.model_rank * Gs, (mesh.model_rank + 1) * Gs) \
            if split else slice(0, G)
        rs = slice(gs.start * Bg, gs.stop * Bg)
        nonmem = training.window_nonmember(
            words.to(torch.int32).reshape(G, Bg, LW)[gs], BLK)
        pw = training.window_pairwise(
            u_mat[rs], ut_ui[rs], i_win_mat.reshape(G, BLK, -1)[gs],
            bias_win.reshape(G, BLK)[gs])
        jloc, sampled, has_j = training.window_warp_select(
            pw, nonmem, u01[gs], r1[gs], M)
        if split:
            out = torch.stack([jloc.reshape(-1), sampled,
                               has_j.to(torch.int32)]).to(torch.int32)
            out = torch.cat(mesh.all_gather(out, "model", tag="selection"), 1)
            jloc, sampled, has_j = out[0].reshape(G, Bg), out[1], out[2] > 0
        j = (blk_l[:, None] * BLK + jloc).reshape(B)
        j = torch.clamp(j, max=num_items - 1)  # only when has_j is False
        row_ok = (valid & has_j).to(torch.float32)

        # the selected negatives' rows, sliced out of the window rows
        flat_sel = (torch.arange(G, device=dev)[:, None] * BLK
                    + jloc).reshape(B)
        v_i_j, x_if_j = v_i_win[flat_sel], x_if_win[flat_sel]
        feat_rep_j = feat_win[flat_sel]
        j_mat = (torch.cat([v_i_j, feat_rep_j], 1)
                 if x_uf_any or x_if_any else v_i_j)
        ut_uj = (u_mat * j_mat).sum(1) + bias_win[flat_sel]
        d, ll = training.window_terms(row_ok, sw, sampled, ut_ui - ut_uj,
                                      num_items, log_I)
        new_w = _apply_updates(
            mesh, w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b, v_i_pos,
            v_i_j, x_if_pos, x_if_j, feat_rep_pos, feat_rep_j, eta, alpha,
            beta, x_uf_any, x_if_any)
        return new_w, ll

    return training.TrainStep(draw, apply)


def tp_epoch_fn(mesh, num_items, max_samples, x_uf_any, x_if_any, batch_size,
                sample_rounds=8, max_row_len=None, post_reject=False,
                step_kind="candidate", sampler="bsearch"):
    """One TP epoch on this rank (`make_tp_epoch_fn`,
    `rankfm_tpu/parallel/tp.py:489-573`), with `training.epoch_body`'s
    signature; ``w``, ``x_uf``, ``x_if`` are `pad_and_place`'s shards and
    ``hist`` the replicated CSR dict (candidate step) or ``{'packed':
    pad_packed_hist(...)}`` (window step).

    The permutation is shared by every rank; each ``data`` rank takes its
    contiguous ``1/data`` of every global batch and draws under the batch
    keys of its ``data`` rank (`training.epoch_draws`: a ``data=1`` mesh
    draws what one device draws). Returns the log-likelihood summed
    over ``data``, NaN on every rank when any rank's shard holds a
    non-finite value."""
    D = mesh.shape["data"]
    assert batch_size % D == 0, (batch_size, D)
    if step_kind == "window":
        step = make_tp_window_step(mesh, num_items, max_samples, x_uf_any,
                                   x_if_any)
    else:
        step = make_tp_train_step(mesh, num_items, max_samples, x_uf_any,
                                  x_if_any, sample_rounds, max_row_len,
                                  post_reject, sampler)
    bd = batch_size // D
    cols = slice(mesh.data_rank * bd, (mesh.data_rank + 1) * bd)

    def epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha, beta,
                 seed, epoch):
        n_pad = u.shape[0]
        nb = n_pad // batch_size
        perm, keys = training.epoch_draws(seed, epoch, n_pad, nb, u.device,
                                          mesh.data_rank)
        valid = (perm < n_real).reshape(nb, batch_size)[:, cols]
        ub, ib, swb = (a[perm].reshape(nb, batch_size)[:, cols]
                       for a in (u, i, sw))
        ll = torch.zeros((), dtype=torch.float32, device=u.device)
        for t in range(nb):
            w, ll_t = step.apply(w, x_uf, x_if, hist, ub[t], ib[t], swb[t],
                                 valid[t], eta, alpha, beta,
                                 step.draw(keys[t], bd))
            ll = ll + ll_t
        # the ll of one model rank per data rank, and every shard's
        # non-finite count: one all-reduce over every rank
        bad = sum((~torch.isfinite(t)).sum() for t in w.values())
        mine = ll if mesh.model_rank == 0 else torch.zeros_like(ll)
        vec = torch.stack([mine, bad.to(torch.float32)])
        mesh.all_reduce(vec, tag="epoch_ll")
        return w, torch.where(vec[1] == 0, vec[0],
                              torch.full_like(vec[0], float("nan")))

    return epoch_fn
