"""Sharded top-N retrieval: per-shard scoring, a local top-k and a merge
over the ``model`` axis (port of `rankfm_tpu/parallel/retrieval.py`).

Each ``model`` rank scores only its own item rows (the rows it owns after a
table-parallel fit, or its slice of whole tables), masks the seen pairs
that fall on its shard, takes a local top-``min(n, I_shard)``, and the
candidate lists are all-gathered over ``model`` and merged: an exact
distributed top-k whose communication is O(shards * B * k), never
O(B * I). Pad rows carry bias ``-inf`` so they never surface; ``-inf``
slots come back as item -1 (`ops.topk`'s convention).
"""

from __future__ import annotations

import torch

from rankfm_tpu_torch.parallel import tp

NEG_INF = float("-inf")


def sharded_topk(mesh, u_mat, i_mat, item_bias, seen_rows, seen_cols,
                 n_items):
    """``(top_idx [B, n] int32, top_vals [B, n])`` from this rank's item
    shard (``i_mat [I_shard, K]``, ``item_bias [I_shard]``: rows ``[m *
    I_shard, (m+1) * I_shard)`` of the padded catalog) and the whole
    ``u_mat [B, K]``. ``seen_rows``/``seen_cols`` are global (batch row,
    item) pairs to exclude (a negative row disables a pair)."""
    ips = i_mat.shape[0]
    offset = mesh.model_rank * ips
    scores = u_mat @ i_mat.T + item_bias[None, :]                # [B, I_shard]
    if seen_rows.shape[0] > 0:
        local = seen_cols - offset
        on = (seen_rows >= 0) & (local >= 0) & (local < ips)
        scores[seen_rows[on].long(), local[on].long()] = NEG_INF
    k = min(n_items, ips)
    vals, idx = torch.topk(scores, k, dim=1)
    # one all-gather of both: the indices ride as their int32 bits
    pair = torch.stack([vals, (idx + offset).to(torch.int32).view(
        torch.float32)])
    got = mesh.all_gather(pair, "model", tag="topk_merge")
    merged_vals = torch.cat([g[0] for g in got], 1)
    merged_idx = torch.cat([g[1].contiguous().view(torch.int32)
                            for g in got], 1)
    top_vals, pos = torch.topk(merged_vals, n_items, dim=1)
    top_idx = merged_idx.gather(1, pos)
    top_idx = torch.where(torch.isneginf(top_vals), -1, top_idx)
    return top_idx.to(torch.int32), top_vals


def item_operands(mesh, w, x_if, num_items, sharded):
    """``(i_mat [I_shard, 2F], item_bias [I_shard])`` of this rank's item
    shard, pad rows' bias ``-inf``. ``w`` holds whole tables, or with
    ``sharded`` this rank's row shards (`tp.pad_and_place`); ``x_if`` is
    the whole item feature matrix."""
    I_pad = tp._pad_rows(num_items, mesh.shape["model"])
    if sharded:
        v_i, w_i = w["v_i"], w["w_i"]
    else:
        v_i, w_i = (tp.shard_rows(mesh, w[k], I_pad) for k in ("v_i", "w_i"))
    x = tp.shard_rows(mesh, x_if, I_pad)
    ir = v_i + x @ w["v_if"]
    ib = w_i + x @ w["w_if"]
    rows = mesh.model_rank * v_i.shape[0] + torch.arange(
        v_i.shape[0], device=v_i.device)
    return (torch.cat([v_i, ir - v_i], 1),
            torch.where(rows < num_items, ib, NEG_INF))


def user_operands(mesh, w, x_uf, u_idx, sharded):
    """``u_mat [B, 2F]`` of the users ``u_idx``: their rows exchanged from
    their owners with ``sharded`` (one all-reduce over ``model``)."""
    if sharded:
        v_u_b = tp.owner_gather(mesh, u_idx, [w["v_u"]])[0]
    else:
        v_u_b = w["v_u"][u_idx]
    ur_b = v_u_b + x_uf[u_idx] @ w["v_uf"]
    return torch.cat([ur_b, v_u_b], 1)

