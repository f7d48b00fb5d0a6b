"""Batched FM scoring (port of `rankfm_tpu/ops/scoring.py`).

The reduced FM is

    s(u, i) = w_i[i] + x_if[i]·w_if + v_u[u]·v_i[i]
              + x_uf[u]·(v_uf @ v_i[i]) + x_if[i]·(v_if @ v_u[u])

With user_rep[u] = v_u[u] + v_ufᵀ x_uf[u], item_rep[i] = v_i[i] + v_ifᵀ x_if[i]
and item_bias[i] = w_i[i] + x_if[i]·w_if the model is one 2F-wide inner
product, so full-catalog retrieval is one ``[B, 2F] x [2F, I]`` matmul.

Weights are a dict of tensors ``w_i [I], w_if [Q], v_u [U,F], v_i [I,F],
v_uf [P,F], v_if [Q,F]``, with the feature matrices ``x_uf [U,P]`` and
``x_if [I,Q]`` on the same device.
"""

from __future__ import annotations

import torch


def item_reps(w, x_if):
    """``item_rep [I,F]`` = v_i + x_if @ v_if."""
    return w["v_i"] + x_if @ w["v_if"]


def item_biases(w, x_if):
    """``item_bias [I]`` = w_i + x_if @ w_if."""
    return w["w_i"] + x_if @ w["w_if"]


def score_pairs(w, x_uf, x_if, u_idx, i_idx):
    """Pointwise utilities for index pairs ``(u_idx, i_idx)`` of one shape."""
    # gather first: reps are row-wise linear, so only the B rows are needed
    v_u_b = w["v_u"][u_idx]
    v_i_b = w["v_i"][i_idx]
    ur_b = v_u_b + x_uf[u_idx] @ w["v_uf"]
    x_if_b = x_if[i_idx]
    ir_b = v_i_b + x_if_b @ w["v_if"]
    ib_b = w["w_i"][i_idx] + x_if_b @ w["w_if"]
    return (ib_b + torch.sum(ur_b * v_i_b, dim=-1)
            + torch.sum(v_u_b * (ir_b - v_i_b), dim=-1))


def score_all_items(w, x_uf, x_if, u_idx):
    """Utilities of ALL items for each user in ``u_idx`` -> ``[B, I]``."""
    v_u_b = w["v_u"][u_idx]
    ur_b = v_u_b + x_uf[u_idx] @ w["v_uf"]
    ir = item_reps(w, x_if)
    ib = item_biases(w, x_if)
    u_mat = torch.cat([ur_b, v_u_b], dim=-1)                    # [B, 2F]
    i_mat = torch.cat([w["v_i"], ir - w["v_i"]], dim=-1)        # [I, 2F]
    return u_mat @ i_mat.T + ib[None, :]
