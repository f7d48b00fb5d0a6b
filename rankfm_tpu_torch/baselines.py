"""Cross-model baselines for quality comparisons (port of
`rankfm_tpu/baselines.py`).

An implicit-feedback ALS (Hu/Koren/Volinsky 2008) — the same model class as
`implicit.als.AlternatingLeastSquares` — with batched PyTorch linear algebra
on the model's device:

* the per-row normal equations ``(YtY + Y_u^T (C_u - I) Y_u + reg I) x_u =
  Y_u^T c_u`` are assembled per 512-row user chunk as ONE einsum over the
  chunk's padded histories and solved as a batched [B, F, F] system
  (`torch.linalg.solve`, f32; this module never enables TF32);
* user and item sides alternate with swapped roles on the transposed CSR.

`ImplicitALS.recommend` follows the RankFM recommend contract (DataFrame
indexed by user id, `filter_previous`, `cold_start`), so the whole
`rankfm_tpu_torch.evaluation` module works on it unchanged.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from rankfm_tpu_torch.models.rankfm import _recommend_chunk
from rankfm_tpu_torch.utils.data import (
    build_index, build_user_items_csr, csr_row_pairs, get_data, map_ids_float,
    map_interactions)


def _csr_transpose(offsets, items, counts_vals, num_cols):
    """(row->cols CSR with per-nnz values) -> col->rows CSR."""
    rows = np.repeat(np.arange(len(offsets) - 1, dtype=np.int32),
                     np.diff(offsets))
    order = np.argsort(items, kind="stable")
    new_items = rows[order]
    new_vals = counts_vals[order]
    new_counts = np.bincount(items, minlength=num_cols)
    new_offsets = np.zeros(num_cols + 1, dtype=np.int64)
    new_offsets[1:] = np.cumsum(new_counts)
    return new_offsets, new_items, new_vals


def _pad_chunks(offsets, items, conf, n_rows, device, B=512):
    """Vectorized once-per-fit chunking of a CSR side into padded
    ``(idx [b, L], conf [b, L])`` tensors on ``device``; ``L`` is the
    chunk's longest history. The JAX package rounds ``L`` up to a power of
    two so that each distinct solve shape compiles once; nothing compiles
    here, so the rounding is dropped (pads carry confidence 0 and add
    exact zeros either way)."""
    lens = np.diff(offsets).astype(np.int64)
    chunks = []
    for s in range(0, n_rows, B):
        e = min(s + B, n_rows)
        l = lens[s:e]
        L = max(int(l.max()) if e > s else 1, 1)
        idx = np.zeros((e - s, L), dtype=np.int64)
        cf = np.zeros((e - s, L), dtype=np.float32)
        if l.sum():
            rows = np.repeat(np.arange(e - s), l)
            cols = np.arange(l.sum()) - np.repeat(np.cumsum(l) - l, l)
            span = slice(int(offsets[s]), int(offsets[e]))
            idx[rows, cols] = items[span]
            cf[rows, cols] = conf[span]
        chunks.append((torch.from_numpy(idx).to(device),
                       torch.from_numpy(cf).to(device)))
    return chunks


def _solve_chunk(Y, YtY_reg, hist_idx, conf):
    """One ALS half-step for a chunk of rows.

    ``hist_idx [B, L]`` padded history columns (pad = 0 with conf 0),
    ``conf [B, L]`` confidences c=1+alpha*count (0 for pads). Solves the
    Hu-Koren normal equations with the classic (C-1) decomposition so the
    dense YtY term is shared across the chunk."""
    Yh = Y[hist_idx]                                         # [B, L, F]
    s = torch.clamp(conf - 1.0, min=0.0) * (conf > 0)        # (c-1), 0 on pads
    A = YtY_reg[None] + torch.einsum("ble,blf->bef", Yh * s[..., None], Yh)
    b = torch.einsum("blf,bl->bf", Yh, conf)
    return torch.linalg.solve(A, b[..., None])[..., 0]


class ImplicitALS:
    """Implicit-feedback ALS baseline.

    :param factors: latent dimensionality
    :param regularization: L2 term added to every normal-equation diagonal
    :param alpha: confidence scale, ``c = 1 + alpha * interaction_count``
    :param iterations: alternating sweeps (each = one user + one item solve)
    :param seed: init PRNG seed
    :param device: torch device of the solves ('cuda' by default)
    """

    def __init__(self, factors=50, regularization=0.01, alpha=40.0,
                 iterations=15, seed=1492, *, device='cuda'):
        self.factors = factors
        self.regularization = regularization
        self.alpha = alpha
        self.iterations = iterations
        self.seed = seed
        self.device = torch.device(device)
        self.is_fit = False

    def fit(self, interactions, epochs=None, verbose=False):
        """Index ids like RankFM, dedupe (user, item) to counts, then
        alternate chunked batched solves. ``epochs`` overrides
        ``iterations`` when given (keeps example call sites uniform)."""
        arr = get_data(interactions)
        self.user_id, self.user_to_index = build_index(arr[:, 0])
        self.item_id, self.item_to_index = build_index(arr[:, 1])
        pairs, _ = map_interactions(
            pd.DataFrame(arr), self.user_to_index, self.item_to_index)
        U, I = len(self.user_id), len(self.item_id)

        uniq, counts = np.unique(pairs, axis=0, return_counts=True)
        conf_vals = (1.0 + self.alpha * counts).astype(np.float32)
        u_off, u_items = build_user_items_csr(uniq, U)
        # per-nnz confidences aligned with the user CSR's item order
        order = np.lexsort((uniq[:, 1], uniq[:, 0]))
        u_conf = conf_vals[order]
        i_off, i_rows, i_conf = _csr_transpose(
            u_off, u_items, u_conf, I)
        self._ui_offsets, self._ui_items = u_off, u_items

        # the same draws as the JAX package's: both start from equal factors
        rng = np.random.default_rng(self.seed)
        F, dev = self.factors, self.device
        X = torch.from_numpy(rng.normal(0, 0.01, (U, F)).astype(np.float32)).to(dev)
        Y = torch.from_numpy(rng.normal(0, 0.01, (I, F)).astype(np.float32)).to(dev)
        sweeps = epochs if epochs is not None else self.iterations
        eye = self.regularization * torch.eye(F, dtype=torch.float32, device=dev)
        # padded history chunks are sweep-invariant: build them ONCE per
        # side (vectorized) instead of a per-row Python loop per sweep
        u_chunks = _pad_chunks(u_off, u_items, u_conf, U, dev)
        i_chunks = _pad_chunks(i_off, i_rows, i_conf, I, dev)
        for _ in range(sweeps):
            X = self._half_step(Y, u_chunks, U, eye)
            Y = self._half_step(X, i_chunks, I, eye)
        self._factors_dev = (X, Y)
        self.user_factors = X.cpu().numpy()
        self.item_factors = Y.cpu().numpy()
        self.is_fit = True
        return self

    def _half_step(self, Y, chunks, n_rows, eye):
        YtY = Y.T @ Y + eye
        outs = [_solve_chunk(Y, YtY, idx, cf) for idx, cf in chunks]
        return torch.cat(outs, dim=0)[:n_rows]

    def recommend(self, users, n_items=10, filter_previous=False,
                  cold_start="nan"):
        """RankFM-compatible top-N (DataFrame indexed by user id) so
        `rankfm_tpu_torch.evaluation` scores this baseline unchanged."""
        assert self.is_fit, "fit the model first"
        users_arr = pd.Series(users).values
        uidx = map_ids_float(users_arr, self.user_to_index)
        known = ~np.isnan(uidx)
        kidx = uidx[known].astype(np.int64)
        n_items = min(int(n_items), len(self.item_id))
        out = np.full((len(users_arr), n_items), np.nan, dtype=np.float64)
        X, Y = self._factors_dev
        step = _recommend_chunk(len(self.item_id))
        tops = []
        for s in range(0, len(kidx), step):
            batch = kidx[s:s + step]
            scores = X[torch.from_numpy(batch).to(X.device)] @ Y.T
            if filter_previous:
                rows, cols = csr_row_pairs(self._ui_offsets, self._ui_items,
                                           batch)
                scores[torch.from_numpy(rows).long().to(X.device),
                       torch.from_numpy(cols).long().to(X.device)] = float("-inf")
            vals, top = torch.topk(scores, n_items, dim=1)
            top = top.to(torch.float64)
            top[vals == float("-inf")] = float("nan")
            tops.append(top.cpu().numpy())
        if tops:
            out[known] = np.concatenate(tops, axis=0)
        vals = np.full(out.shape, np.nan, dtype=object)
        ok = ~np.isnan(out)
        vals[ok] = self.item_id.values[out[ok].astype(np.int64)]
        recs = pd.DataFrame(vals, index=pd.Index(users_arr))
        if cold_start == "nan":
            return recs
        elif cold_start == "drop":
            return recs.dropna(how="any")
        raise ValueError(
            "param [cold_start] must be set to either 'nan' or 'drop'")
