"""Per-touch decayed table update (port of `rankfm_tpu/ops/scatter.py`).

Every XLA-engine step ends by adding a batch of gradient rows into the item
and user tables with the geometric per-touch decay of
`rankfm_tpu.ops.training._decay_apply`:

    cnt   = sum of the validity column over the row's updates
    ck    = c^cnt,   c = max(1 - eta*2*reg, 1e-8)
    f     = (1 - ck) / (cnt * (1 - c))          (1 when cnt * (1 - c) <= 1e-12)
    tab   = ck * tab + eta * f * sum(updates)

``upd [B2, F+2]`` carries the factor gradient in cols ``0..F-1``, the bias
gradient in col ``F`` and the validity in col ``F+1``; ``idx [B2]`` names
each update's row, and rows outside ``[0, N)`` (``-1``) are skipped.

`apply_table_update` runs the plain PyTorch version
`table_update_reference` on CPU tensors and a Hopper kernel of
``csrc/table_update.cu`` on CUDA tensors, chosen as the JAX wrapper chooses
its Pallas kernel (`_regime`): `table_update_sorted` (B3) or
`table_update_dense` (B2). The TPU's sorted kernel reads a fixed span of
sorted updates per table tile and falls back to the dense kernel when a
span overflows; the card's sorted kernel walks each run of equal rows to
its end, so that fallback has no counterpart here.

All three update ``tab`` and ``bias`` IN PLACE (one write per touched row)
and return them.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

TILE = 2048          # the JAX wrapper's table tile: only `_regime` reads it

# kernel launches, keyed by 'sorted' / 'dense': one count per call of a
# kernel wrapper that launched its kernel
LAUNCHES = Counter()


def _round_up(x, m):
    return (x + m - 1) // m * m


def _regime(N, B2, tile=TILE):
    """'sorted' exactly when `rankfm_tpu.ops.scatter.apply_table_update`
    takes its sorted kernel for an ``N``-row table and ``B2`` updates
    (``nT >= 8`` tiles and a span ``tb < B2``), else 'dense'."""
    B2 = _round_up(B2, 8)
    tile = min(tile, _round_up(N, 8))
    nT = _round_up(N, tile) // tile
    tb = _round_up(min(B2, max(1024, 4 * B2 // max(nT, 1))), 8)
    return "sorted" if nT >= 8 and tb < B2 else "dense"


def decay_c(eta, reg):
    """The per-touch decay factor ``max(1 - eta*2*reg, 1e-8)`` in f32, as
    the JAX package computes it from f32 scalars."""
    c = np.float32(1.0) - np.float32(eta) * np.float32(2.0) * np.float32(reg)
    return float(np.maximum(c, np.float32(1e-8)))


def decay_rows(wt, grad, counts, eta, c):
    """``ck * wt + eta * f * grad`` with ``counts`` broadcast over trailing
    dims (`rankfm_tpu.ops.training._decay_apply` given its ``c``). The
    scalars are f32 values computed on the host: a tensor made from a
    Python scalar on the card is a pageable copy that waits for the
    stream."""
    if wt.dim() > counts.dim():
        counts = counts[..., None]
    c32 = np.float32(c)
    ck = torch.exp(counts * float(np.log(c32)))
    denom = counts * float(np.float32(1.0) - c32)
    f = torch.where(denom > 1e-12, (1.0 - ck) / torch.clamp(denom, min=1e-12),
                    1.0)
    return ck * wt + float(np.float32(eta)) * f * grad


def table_update_reference(tab, bias, idx, upd, eta, c):
    """Plain PyTorch version: ``index_add_`` of the valid update rows, the
    touch count from column ``F+1``, then `decay_rows` on every row (an
    untouched row is left as it was). ``bias`` may be None."""
    N, F = tab.shape
    ok = (idx >= 0) & (idx < N)
    acc = torch.zeros((N, F + 2), dtype=torch.float32, device=tab.device)
    acc.index_add_(0, idx[ok].long(), upd[ok])
    cnt = acc[:, F + 1]
    tab.copy_(decay_rows(tab, acc[:, :F], cnt, eta, c))
    if bias is not None:
        bias.copy_(decay_rows(bias, acc[:, F], cnt, eta, c))
    return tab, bias


def apply_table_update(tab, bias, idx, upd, eta, c):
    """``tab [N, F]`` f32, ``bias [N]`` f32 or None, ``idx [B2]`` int32,
    ``upd [B2, F+2]`` f32, ``eta`` and ``c`` floats. Updates ``tab`` and
    ``bias`` in place and returns them. CPU tensors take the plain version,
    CUDA tensors the kernel of `_regime`; any other device raises."""
    dev = tab.device
    if dev.type == "cpu":
        return table_update_reference(tab, bias, idx, upd, eta, c)
    if dev.type != "cuda":
        raise ValueError(
            f"apply_table_update runs on cuda or cpu, not {dev}")
    if _regime(tab.shape[0], idx.shape[0]) == "sorted":
        return table_update_sorted(tab, bias, idx, upd, eta, c)
    return table_update_dense(tab, bias, idx, upd, eta, c)


def _check(tab, bias, idx, upd, name):
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got tab on {dev}")
    args = [("tab", tab, torch.float32, 2), ("idx", idx, torch.int32, 1),
            ("upd", upd, torch.float32, 2)]
    if bias is not None:
        args.append(("bias", bias, torch.float32, 1))
    for arg, t, dtype, ndim in args:
        if t.dtype != dtype or t.device != dev or t.dim() != ndim \
                or not t.is_contiguous():
            raise ValueError(
                f"{name}: {arg} must be a contiguous {ndim}-d {dtype} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    N, F = tab.shape
    if upd.shape != (idx.shape[0], F + 2) or (
            bias is not None and bias.shape != (N,)):
        raise ValueError(
            f"{name}: inconsistent shapes tab={tuple(tab.shape)} "
            f"bias={None if bias is None else tuple(bias.shape)} "
            f"idx={tuple(idx.shape)} upd={tuple(upd.shape)} "
            f"(upd must be [len(idx), F+2])")


def _raise_on(err, name):
    if err:
        from rankfm_tpu_torch.ops import _build
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err, 'table_update')})")


def _ptr(t):
    return None if t is None else t.data_ptr()


def table_update_sorted(tab, bias, idx, upd, eta, c):
    """Kernel B3 on CUDA tensors (arguments as `apply_table_update`): a
    stable sort of ``idx``, then one warp per run of equal rows."""
    from rankfm_tpu_torch.ops import _build

    _check(tab, bias, idx, upd, "table_update_sorted")
    idx_s, order = torch.sort(idx, stable=True)
    upd_s = upd[order]
    N, F = tab.shape
    err = _build.load("table_update").rfm_table_update_sorted(
        tab.data_ptr(), _ptr(bias), N, F, idx_s.data_ptr(), upd_s.data_ptr(),
        idx.shape[0], float(eta), float(c),
        torch.cuda.current_stream(tab.device).cuda_stream)
    _raise_on(err, "table_update_sorted")
    LAUNCHES["sorted"] += 1
    return tab, bias


def table_update_dense(tab, bias, idx, upd, eta, c):
    """Kernel B2 on CUDA tensors (arguments as `apply_table_update`):
    atomic adds into a zeroed ``[N, F+2]`` accumulator, then a decay pass
    over the touched rows."""
    from rankfm_tpu_torch.ops import _build

    _check(tab, bias, idx, upd, "table_update_dense")
    N, F = tab.shape
    acc = torch.zeros((N, F + 2), dtype=torch.float32, device=tab.device)
    err = _build.load("table_update").rfm_table_update_dense(
        tab.data_ptr(), _ptr(bias), N, F, idx.data_ptr(), upd.data_ptr(),
        idx.shape[0], acc.data_ptr(), float(eta), float(c),
        torch.cuda.current_stream(tab.device).cuda_stream)
    _raise_on(err, "table_update_dense")
    LAUNCHES["dense"] += 1
    return tab, bias
