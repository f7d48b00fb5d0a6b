"""XLA-engine training steps (port of `rankfm_tpu/ops/training.py`).

Two batched WARP/BPR steps, as in the JAX package:

* the **window step** (`make_window_train_step`): negatives come from G
  size-weighted contiguous item blocks per batch, scored by one batched
  matmul, with the fused kernel's closed-form selection
  (`window_warp_select`);
* the **candidate step** (`make_train_step`): a ``[B, max_samples]``
  candidate matrix per batch, membership-rejected before the draw (bitmap
  or binary-search samplers) or after it on the selected negative only
  (``post_reject``); the first margin violator, else the hardest candidate.

Every gradient reads the batch-start tables, and each table is updated once
per batch (`_apply_pair_updates`): the item and user tables through
`rankfm_tpu_torch.ops.scatter.apply_table_update` (the Hopper kernels on
CUDA tensors, the plain version on CPU tensors), the feature tables through
`_decay_apply`. The item and user tables are updated in place.

A step is a `TrainStep`: ``draw(gen, B)`` makes the batch's random draws on
the generator's device, and ``apply(w, x_uf, x_if, hist, u, i, sw, valid,
eta, alpha, beta, draws)`` is the JAX step with ``draws`` in place of its
PRNG key, so tests can hand it the JAX package's own draws. The port scores
in f32 where the JAX steps cast the scoring operands to bf16.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import torch

from rankfm_tpu_torch.ops import fused as fused_mod
from rankfm_tpu_torch.ops.negatives import (
    bitmap_member, csr_member, draw_candidates, sample_negatives,
    sample_negatives_bitmap)
from rankfm_tpu_torch.ops.scatter import apply_table_update, decay_c, decay_rows

MARGIN = 1.0
# the JAX steps draw their window uniforms from [U01_MIN, 1)
U01_MIN = 1e-7


class TrainStep(NamedTuple):
    draw: Callable    # draw(gen, B) -> the batch's random draws
    apply: Callable   # apply(w, x_uf, x_if, hist, u, i, sw, valid, eta,
    #                         alpha, beta, draws) -> (w, ll)


def _decay_apply(wt, grad, counts, eta, reg):
    """The geometric-corrected per-touch decay plus the accumulated gradient
    (`rankfm_tpu/ops/training.py:71-83`); ``counts`` is the per-row touch
    count, broadcast over trailing dims."""
    return decay_rows(wt, grad, counts, eta, decay_c(eta, reg))


def _uniform(gen, shape):
    """f32 uniforms in [U01_MIN, 1) on the generator's device."""
    x = torch.rand(shape, generator=gen, device=gen.device)
    return x * (1.0 - U01_MIN) + U01_MIN


def window_warp_select(pw, nonmem, u01, r1, M):
    """Window-WARP selection with the JAX package's semantics
    (`rankfm_tpu/ops/training.py:86-130`), its uniforms passed in: ``pw``,
    ``nonmem`` and ``u01`` are ``[G, Bg, W]``, ``r1`` is ``[G, Bg]``, both
    in [1e-7, 1). Returns ``(jloc [G, Bg], sampled [G*Bg] int32, has_j
    [G*Bg] bool)``.

    Unlike the fused kernel's `select_key` it takes the FIRST maximal slot
    (no split of ties) and draws the count as ``floor(log(r1) /
    log(1 - p)) + 1``."""
    G, Bg, _ = pw.shape
    B = G * Bg
    neg_inf = float("-inf")
    if M == 1:
        key_m = torch.where(nonmem, u01, neg_inf)
        sampled = torch.ones(B, dtype=torch.int32, device=pw.device)
    else:
        viol = (pw < MARGIN) & nonmem
        nv = viol.to(torch.float32).sum(2)                       # [G, Bg]
        n_nonmem = nonmem.to(torch.float32).sum(2)
        p_c = torch.clamp(nv / torch.clamp(n_nonmem, min=1.0), 1e-9,
                          1.0 - 1e-7)
        geo = torch.floor(torch.log(r1) / torch.log(1.0 - p_c)) + 1.0
        geo = torch.where(nv > 0, geo, float(M))
        found = (nv > 0) & (geo <= M)
        sampled = torch.clamp(geo, max=float(M)).to(torch.int32).reshape(B)
        pthr = (M / torch.clamp(n_nonmem, min=1.0))[:, :, None]
        off_subset = (u01 >= pthr).to(torch.float32) * 1e6
        key_m = torch.where(
            found[:, :, None],
            torch.where(viol, u01, neg_inf),
            torch.where(nonmem & ~viol, -pw - off_subset, neg_inf))
    mx, jloc = key_m.max(2)       # the first maximal slot, as jnp.argmax
    has_j = (mx > float("-inf")).reshape(B)
    return jloc, sampled, has_j


def pick_window_groups(B):
    """Independent negative windows per batch: double until each group
    lands in [128, 256) rows (`rankfm_tpu/ops/training.py:133-141`)."""
    G = 1
    while G < 64 and B % (2 * G) == 0 and B // (2 * G) >= 128:
        G *= 2
    return G


def _apply_pair_updates(w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b,
                        v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos,
                        feat_rep_j, eta, alpha, beta, x_uf_any, x_if_any):
    """Gradients of a batch of selected (u, i, j) pairs and the per-touch
    decayed table updates (`rankfm_tpu/ops/training.py:144-226`). ``d`` is
    the per-row outer derivative, already masked by ``row_ok`` and scaled by
    sample weight and the WARP multiplier. Every gradient term is formed
    before the first table is written."""
    d_col = d[:, None]
    dx_if = x_if_pos - x_if_j
    g_w_if = d @ dx_if                                          # b,bq->q
    g_v_uf = (d_col * x_uf_b).T @ (v_i_pos - v_i_j)             # b,bp,bf->pf
    g_v_if = (d_col * dx_if).T @ v_u_b                          # b,bq,bf->qf

    if x_if_any:
        k_w_if = row_ok.sum().expand(w["w_if"].shape)
        # v_if[q] touched when x_if[i,q] != x_if[j,q]  (`_rankfm.pyx:321-326`)
        k_v_if = row_ok @ (x_if_pos != x_if_j).to(torch.float32)
    else:
        k_w_if = torch.zeros_like(w["w_if"])
        k_v_if = torch.zeros(w["v_if"].shape[0], device=d.device)
    if x_uf_any:
        # v_uf[p] touched when x_uf[u,p] != 0  (`_rankfm.pyx:313-318`)
        k_v_uf = row_ok @ (x_uf_b != 0).to(torch.float32)
    else:
        k_v_uf = torch.zeros(w["v_uf"].shape[0], device=d.device)

    # d_v_u = (v_i[i] - v_i[j]) + v_ifᵀ(x_if[i] - x_if[j])  (`_rankfm.pyx:292,305`)
    g_u_rows = d_col * ((v_i_pos - v_i_j) + (feat_rep_pos - feat_rep_j))
    okb = row_ok > 0
    c_a = decay_c(eta, alpha)
    ones = row_ok[:, None]
    gi = d_col * user_rep_b
    idx_i2 = torch.cat([torch.where(okb, i, -1),
                        torch.where(okb, j, -1)]).to(torch.int32)
    upd_i2 = torch.cat([torch.cat([gi, d_col, ones], 1),
                        torch.cat([-gi, -d_col, ones], 1)], 0)
    idx_u = torch.where(okb, u, -1).to(torch.int32)
    upd_u = torch.cat([g_u_rows, torch.zeros_like(d_col), ones], 1)
    new_w = {
        "w_if": _decay_apply(w["w_if"], g_w_if, k_w_if, eta, beta),
        "v_uf": _decay_apply(w["v_uf"], g_v_uf, k_v_uf, eta, beta),
        "v_if": _decay_apply(w["v_if"], g_v_if, k_v_if, eta, beta),
    }
    new_w["v_i"], new_w["w_i"] = apply_table_update(
        w["v_i"], w["w_i"], idx_i2, upd_i2.contiguous(), eta, c_a)
    new_w["v_u"], _ = apply_table_update(
        w["v_u"], None, idx_u, upd_u.contiguous(), eta, c_a)
    return new_w


def _rank_multiplier(num_items, sampled, log_I):
    """``log((I-1) // sampled) / log(I)`` with C integer division
    (`_rankfm.pyx:269`)."""
    ratio = torch.clamp((num_items - 1) // sampled, min=1).to(torch.float32)
    return torch.log(ratio) / log_I


def _user_and_items(w, x_uf, x_if, u, x_uf_any, x_if_any):
    """User-side rows of the batch and the catalog-side score operands:
    ``(v_u_b, x_uf_b, user_rep_b, u_mat [B, F or 2F], i_mat [I, F or 2F],
    item_bias [I])``; featureless fits skip the zero feature half."""
    v_u_b = w["v_u"][u]
    x_uf_b = x_uf[u]
    user_rep_b = v_u_b + x_uf_b @ w["v_uf"]
    if x_uf_any or x_if_any:
        item_rep = w["v_i"] + x_if @ w["v_if"]
        item_bias = w["w_i"] + x_if @ w["w_if"]
        u_mat = torch.cat([user_rep_b, v_u_b], 1)
        i_mat = torch.cat([w["v_i"], item_rep - w["v_i"]], 1)
    else:
        item_bias = w["w_i"]
        u_mat = v_u_b
        i_mat = w["v_i"]
    return v_u_b, x_uf_b, user_rep_b, u_mat, i_mat, item_bias


def make_train_step(num_items, max_samples, x_uf_any, x_if_any,
                    sample_rounds=8, sampler="bsearch", post_reject=False,
                    max_row_len=None):
    """The candidate step (`rankfm_tpu/ops/training.py:229-392`).

    ``hist = {'offsets', 'flat', 'bitmap'}``; only the arrays the sampler
    reads are touched. ``draws`` are the candidate sets ``[R, B, M]`` int32:
    one with ``post_reject``, ``max(1, sample_rounds)`` for the bitmap
    sampler, ``sample_rounds + 1`` for the binary-search sampler."""
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    post_reject = post_reject and M > 1
    if post_reject:
        n_draws = 1
    elif sampler == "bitmap":
        n_draws = max(1, sample_rounds)
    else:
        n_draws = sample_rounds + 1

    def draw(gen, B):
        return draw_candidates(gen, n_draws, B, M, num_items)

    def select(pw_mat, cands, ok_mat):
        """First margin violator, else the hardest candidate: ``(sel,
        sampled, j, pw, ok)`` per row."""
        viol = pw_mat < MARGIN
        any_viol = viol.any(1)
        first_viol = viol.to(torch.uint8).argmax(1)
        sel = torch.where(any_viol, first_viol, pw_mat.argmin(1))
        sampled = torch.where(any_viol, first_viol + 1,
                              torch.full_like(first_viol, M)).to(torch.int32)

        def take(a):
            return a.gather(1, sel[:, None])[:, 0]

        return sel, sampled, take(cands), take(pw_mat), take(ok_mat)

    def apply(w, x_uf, x_if, hist, u, i, sw, valid, eta, alpha, beta, draws):
        B = u.shape[0]
        if post_reject:
            cands = draws[0]
            cand_ok = torch.ones((B, M), dtype=torch.bool, device=u.device)
        elif sampler == "bitmap":
            cands, cand_ok = sample_negatives_bitmap(
                u, hist["bitmap"], num_items, M, draws)
        else:
            cands, cand_ok = sample_negatives(
                u, hist["offsets"], hist["flat"], num_items, M, draws,
                max_row_len)
        cands_l = cands.long()

        v_u_b, x_uf_b, user_rep_b, u_mat, i_mat, item_bias = _user_and_items(
            w, x_uf, x_if, u, x_uf_any, x_if_any)
        if B * num_items <= 2**28:
            # small catalog: one [B, 2F] x [2F, I] product scores everything
            scores_all = u_mat @ i_mat.T + item_bias[None, :]
            ut_ui = scores_all.gather(1, i[:, None])[:, 0]
            ut_uj = scores_all.gather(1, cands_l)
        else:
            # large catalog: gather only the M candidate rows, the bias
            # riding as an extra column; 2-D throughout ([B*M, 2F+1])
            i_ext = torch.cat([i_mat, item_bias[:, None]], 1)
            u_ext = torch.cat([u_mat, torch.ones((B, 1), device=u.device)], 1)
            cand_flat = i_ext[cands_l.reshape(-1)]
            u_rep = u_ext.repeat_interleave(M, 0)
            ut_uj = (cand_flat * u_rep).sum(1).reshape(B, M)
            ut_ui = (u_mat * i_mat[i]).sum(1) + item_bias[i]

        pairwise = torch.where(cand_ok, ut_ui[:, None] - ut_uj, float("inf"))
        sel, sampled, j, pw, ok_sel = select(pairwise, cands, cand_ok)
        if post_reject:
            if sampler == "bitmap":
                def member_of_j(jj):
                    return bitmap_member(hist["bitmap"], u, jj[:, None])[:, 0]
            else:
                def member_of_j(jj):
                    return csr_member(hist["flat"], hist["offsets"], u, jj,
                                      max_row_len)
            # test only the selected negative; mask a member slot and
            # re-select (second members are ~(h/I)^2-rare: drop the row)
            slots = torch.arange(M, device=u.device)[None, :]
            for _ in range(2):
                is_mem = member_of_j(j)
                pairwise = torch.where(
                    is_mem[:, None] & (slots == sel[:, None]), float("inf"),
                    pairwise)
                sel, sampled, j, pw, ok_sel = select(pairwise, cands, cand_ok)
            ok_sel = ok_sel & ~member_of_j(j)
        row_ok = (valid & ok_sel & torch.isfinite(pw)).to(torch.float32)

        multiplier = _rank_multiplier(num_items, sampled, log_I)
        pw_safe = torch.where(torch.isfinite(pw), pw, 0.0)
        d = row_ok * sw * multiplier * torch.sigmoid(-pw_safe)
        ll = (row_ok * torch.nn.functional.logsigmoid(pw_safe)).sum()

        j_l = j.long()
        v_i_pos = w["v_i"][i]
        x_if_pos = x_if[i]
        feat_rep_pos = x_if_pos @ w["v_if"]
        v_i_j = w["v_i"][j_l]
        x_if_j = x_if[j_l]
        feat_rep_j = x_if_j @ w["v_if"]
        new_w = _apply_pair_updates(
            w, u, i, j_l, d, row_ok, v_u_b, user_rep_b, x_uf_b,
            v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos, feat_rep_j,
            eta, alpha, beta, x_uf_any, x_if_any)
        return new_w, ll

    return TrainStep(draw, apply)


def make_window_train_step(num_items, max_samples, x_uf_any, x_if_any):
    """The window step (`rankfm_tpu/ops/training.py:395-510`). ``hist`` is
    the blocked 16-bit history pack (`fused.pack_history`); ``draws`` are
    ``(blkg [G] int32 window blocks, u01 [G, Bg, BLK], r1 [G, Bg])``."""
    M = max_samples
    log_I = math.log(num_items) if num_items > 1 else 1.0
    BLK = fused_mod.block_size(num_items)
    I_pad = fused_mod.item_pad(num_items)
    LW = BLK // fused_mod.BITS_PER_LANE
    lg_lw = LW.bit_length() - 1

    def draw(gen, B):
        G = pick_window_groups(B)
        blkg = fused_mod.draw_window_blocks(gen, (G,), num_items)
        return (blkg, _uniform(gen, (G, B // G, BLK)),
                _uniform(gen, (G, B // G)))

    def apply(w, x_uf, x_if, packed_hist, u, i, sw, valid, eta, alpha, beta,
              draws):
        blkg, u01, r1 = draws
        B = u.shape[0]
        G = blkg.shape[0]
        Bg = B // G
        dev = u.device
        blk_l = blkg.long()

        # membership bits of each group's window: the LW pack words of the
        # window block, tiled so that slot L reads bit L // LW of word L % LW
        lanes = blk_l[:, None] * LW + torch.arange(LW, device=dev)[None, :]
        rows = packed_hist[u.reshape(G, Bg, 1), lanes[:, None, :]]  # [G,Bg,LW]
        col = torch.arange(BLK, device=dev)[None, None, :]
        bits = rows.repeat(1, 1, fused_mod.BITS_PER_LANE)             # [G,Bg,BLK]
        nonmem = ((bits >> (col >> lg_lw).to(bits.dtype)) & 1) == 0

        v_u_b, x_uf_b, user_rep_b, u_mat, i_mat, item_bias = _user_and_items(
            w, x_uf, x_if, u, x_uf_any, x_if_any)
        slots = (blk_l[:, None] * BLK
                 + torch.arange(BLK, device=dev)[None, :])           # [G, BLK]
        i_pad_mat = torch.nn.functional.pad(
            i_mat, (0, 0, 0, I_pad - i_mat.shape[0]))
        bias_pad = torch.nn.functional.pad(
            item_bias, (0, I_pad - item_bias.shape[0]))
        scores_win = (torch.bmm(u_mat.reshape(G, Bg, -1),
                                i_pad_mat[slots].transpose(1, 2))
                      + bias_pad[slots][:, None, :])                 # [G,Bg,BLK]
        v_i_pos = w["v_i"][i]
        x_if_pos = x_if[i]
        feat_rep_pos = x_if_pos @ w["v_if"]
        if x_uf_any or x_if_any:
            i_rows = torch.cat([v_i_pos, feat_rep_pos], 1)
        else:
            i_rows = v_i_pos
        ut_ui = (u_mat * i_rows).sum(1) + item_bias[i]
        pw = ut_ui.reshape(G, Bg)[:, :, None] - scores_win

        jloc, sampled, has_j = window_warp_select(pw, nonmem, u01, r1, M)
        j = (blk_l[:, None] * BLK + jloc).reshape(B)
        j = torch.clamp(j, max=num_items - 1)  # only when has_j is False
        row_ok = (valid & has_j).to(torch.float32)

        # exact pointwise recompute at the selected j
        v_i_j = w["v_i"][j]
        x_if_j = x_if[j]
        feat_rep_j = x_if_j @ w["v_if"]
        if x_uf_any or x_if_any:
            j_rows = torch.cat([v_i_j, feat_rep_j], 1)
        else:
            j_rows = v_i_j
        ut_uj = (u_mat * j_rows).sum(1) + item_bias[j]
        pw_sel = ut_ui - ut_uj

        multiplier = _rank_multiplier(num_items, sampled, log_I)
        d = row_ok * sw * multiplier * torch.sigmoid(-pw_sel)
        ll = (row_ok * torch.nn.functional.logsigmoid(pw_sel)).sum()
        new_w = _apply_pair_updates(
            w, u, i, j, d, row_ok, v_u_b, user_rep_b, x_uf_b,
            v_i_pos, v_i_j, x_if_pos, x_if_j, feat_rep_pos, feat_rep_j,
            eta, alpha, beta, x_uf_any, x_if_any)
        return new_w, ll

    return TrainStep(draw, apply)


def device_generator(seed, epoch, device):
    """The generator of one XLA epoch's draws on ``device``, seeded from the
    epoch's CPU generator (`fused.epoch_generator`)."""
    s = int(torch.randint(0, 2**62, (), generator=fused_mod.epoch_generator(
        seed, epoch)))
    return torch.Generator(device=device).manual_seed(s)


def epoch_body(step, batch_size):
    """One epoch of an XLA step (`rankfm_tpu/ops/training.py:556-591`): one
    permutation of the padded rows, the validity mask of the pad rows
    (index ``>= n_real``), then the batches in order. No host sync.

    Returns ``epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha,
    beta, seed, epoch) -> (w, ll)``; ``u``/``i`` are int64 and ``sw`` f32
    padded columns on the device."""

    def epoch_fn(w, x_uf, x_if, hist, u, i, sw, n_real, eta, alpha, beta,
                 seed, epoch):
        n_pad = u.shape[0]
        nb = n_pad // batch_size
        gen = device_generator(seed, epoch, u.device)
        perm = torch.randperm(n_pad, generator=gen, device=u.device)
        valid = (perm < n_real).reshape(nb, batch_size)
        ub, ib, swb = (a[perm].reshape(nb, batch_size) for a in (u, i, sw))
        ll = torch.zeros((), dtype=torch.float32, device=u.device)
        for t in range(nb):
            w, ll_t = step.apply(w, x_uf, x_if, hist, ub[t], ib[t], swb[t],
                                 valid[t], eta, alpha, beta,
                                 step.draw(gen, batch_size))
            ll = ll + ll_t
        return w, ll

    return epoch_fn
