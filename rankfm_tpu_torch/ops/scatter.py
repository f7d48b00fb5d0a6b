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
its Pallas kernel (`_regime`): `table_update_sorted` (B3, tables of many
more rows than updates) or `table_update_dense` (B2, small tables), except
that a table too large for B2's accumulator (`DENSE_ACC_MAX_BYTES`) takes
B3 however few its updates. On a
CUDA tensor a wrapper launches its kernel or raises; neither takes the
plain version, a library sort or ``index_add_``.

Each kernel is one cooperative launch per call and allocates nothing: B3
lets one update of each row claim it, adds every update row into its
claimant's accumulator row (``[B2, F+3]``) and lets the claimant rewrite the
table row, so its work does not grow with the table and a row's updates are
never walked one by one; B2 adds the update rows into an ``[N, F+3]``
accumulator and rewrites the touched rows from it. Both sum in 64-bit fixed
point with integer atomics, so a call's result is a function of its inputs
alone, bit for bit, from one run to the next; a gradient too large for the
fixed point, or not finite, turns its row to NaN. The TPU's sorted kernel
reads a fixed span of sorted updates per table tile and falls back to the
dense kernel when a span overflows; nothing is sorted here, so that
fallback has no counterpart. What the kernels keep between calls is
`scratch` (sizes: `scratch_sizes`), per device and stream, and restored by
every call. `update_work` counts the operations and bytes of one update,
whatever implements it.

All three update ``tab`` and ``bias`` IN PLACE (touched rows only) and
return them.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

TILE = 2048          # the JAX wrapper's table tile: only `_regime` reads it
# B2's accumulator, counted as ``[N, F+2]`` f32 (the row limit that was
# measured; the fixed-point accumulator is ``[N, F+3]`` of 8 bytes, a little
# over twice that), may hold this many bytes; a larger table takes B3
# whatever the JAX rule says. B2 passes over the whole accumulator,
# B3's work does not grow with the table: with 512 updates at F 64 on an
# NVIDIA H100 80GB HBM3 (700 W), B2 / B3 took 0.0141 / 0.0184 ms per call
# at 17.3 MB, 0.0209 / 0.0139 at 34.6 MB, 0.0426 / 0.0135 at 69.2 MB and
# 0.1364 / 0.0243 at 264 MB (1,000,000 rows; `chip_smoke.py`, phase 4).
DENSE_ACC_MAX_BYTES = 32 << 20

# kernel launches, keyed by 'sorted' / 'dense': one count per call of a
# kernel wrapper that launched its kernel
LAUNCHES = Counter()


def _round_up(x, m):
    return (x + m - 1) // m * m


def _regime(N, B2, F, tile=TILE):
    """The kernel for ``B2`` updates of an ``N``-row table of width ``F``:
    'sorted' for every table whose dense accumulator would exceed
    `DENSE_ACC_MAX_BYTES`; below that 'sorted' exactly when
    `rankfm_tpu.ops.scatter.apply_table_update` takes its sorted kernel
    (``nT >= 8`` tiles and a span ``tb < B2``), else 'dense'."""
    if N * (F + 2) * 4 > DENSE_ACC_MAX_BYTES:
        return "sorted"
    B2 = _round_up(B2, 8)
    tile = min(tile, _round_up(N, 8))
    nT = _round_up(N, tile) // tile
    tb = _round_up(min(B2, max(1024, 4 * B2 // max(nT, 1))), 8)
    return "sorted" if nT >= 8 and tb < B2 else "dense"


def update_work(B2, F, n_live, n_rows, with_bias):
    """``(operations, bytes)`` one table update has to do and move, whatever
    implements it: the numbers behind the kernels' roofline bound. ``B2``
    update rows of ``F + 2`` floats, ``n_live`` of them aimed at a table
    row, ``n_rows`` distinct rows touched.

    Bytes, each input read once and each output written once: every update
    row and its index, each touched table row (and its bias) read and
    written. Operations (f32): one add per live update element, a multiply
    and an add per touched element."""
    cols = F + bool(with_bias)
    nbytes = B2 * (4 + (F + 2) * 4) + 2 * n_rows * cols * 4
    ops = n_live * cols + 2 * n_rows * cols
    return ops, nbytes


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
    if _regime(tab.shape[0], idx.shape[0], tab.shape[1]) == "sorted":
        return table_update_sorted(tab, bias, idx, upd, eta, c)
    return table_update_dense(tab, bias, idx, upd, eta, c)


def _ok(t, dtype, ndim, dev):
    return (t.dtype is dtype and t.dim() == ndim and t.device == dev
            and t.is_contiguous())


def _check(tab, bias, idx, upd, name):
    """Raise on what the kernels do not take."""
    dev = tab.device
    if dev.type != "cuda":
        raise ValueError(f"{name}: needs CUDA tensors, got tab on {dev}")
    for arg, t, dtype, ndim in (("tab", tab, torch.float32, 2),
                                ("idx", idx, torch.int32, 1),
                                ("upd", upd, torch.float32, 2),
                                ("bias", bias, torch.float32, 1)):
        if t is not None and not _ok(t, dtype, ndim, dev):
            raise ValueError(
                f"{name}: {arg} must be a contiguous {ndim}-d {dtype} tensor "
                f"on {dev}, got {t.dtype} {tuple(t.shape)} on {t.device} "
                f"(contiguous={t.is_contiguous()})")
    N, F = tab.shape
    if upd.shape[0] != idx.shape[0] or upd.shape[1] != F + 2 or (
            bias is not None and bias.shape[0] != N):
        raise ValueError(
            f"{name}: inconsistent shapes tab={tuple(tab.shape)} "
            f"bias={None if bias is None else tuple(bias.shape)} "
            f"idx={tuple(idx.shape)} upd={tuple(upd.shape)} "
            f"(upd must be [len(idx), F+2])")


def scratch_sizes(N, F, kind, B2=0):
    """Element counts (4-byte words) of the persistent scratch one kernel
    keeps for an ``N``-row table of width ``F`` and ``B2`` updates, in the
    order it is laid out. 'sorted' keeps the fixed-point accumulator rows
    of the updates that claim a row, ``acc [B2, F+3]`` (64-bit words, two
    4-byte words each: factors, bias, touch count, flag), and the row
    claims ``claim [N]`` (int32); 'dense' keeps the accumulator ``acc
    [N, F+3]`` (64-bit). Both are zeroed when allocated and left all-zero
    by every call."""
    if kind == "sorted":
        return {"acc": 2 * B2 * (F + 3), "claim": N}
    if kind == "dense":
        return {"acc": 2 * N * (F + 3)}
    raise ValueError(f"scratch_sizes: kind {kind!r} is not 'sorted' or 'dense'")


# (device index, stream, kind, words) -> zeroed int32 tensor; the newest
# `_SCRATCH_MAX` are kept
_scratch = {}
_SCRATCH_MAX = 16


def scratch(device, stream, N, kind, F=0, B2=0):
    """The persistent scratch of kernel ``kind`` for ``N``-row tables of
    width ``F`` updated ``B2`` rows at a time (``B2`` matters to 'sorted'
    only) on ``device`` and the CUDA stream with the handle ``stream``: one
    zeroed tensor of ``sum(scratch_sizes(N, F, kind, B2).values())`` 4-byte
    words, allocated at the first call and reused by every later one.

    The kernels restore it: each call finds it all-zero and leaves it
    all-zero, so no call clears it. It is per stream: two tables of equal
    shape share one scratch, which is safe because launches on one stream
    run in order; launches on two streams get two."""
    words = sum(scratch_sizes(N, F, kind, B2).values())
    key = (device.index, stream, kind, words)
    buf = _scratch.get(key)
    if buf is None:
        while len(_scratch) >= _SCRATCH_MAX:
            _scratch.pop(next(iter(_scratch)))
        buf = _scratch[key] = torch.zeros(words, dtype=torch.int32,
                                          device=device)
    return buf


# the current stream's handle without building a `torch.cuda.Stream`
# (5 us a call); builds of torch without it take the public way
_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)


def _current_stream(dev):
    if _raw_stream is not None:
        return _raw_stream(dev.index)
    return torch.cuda.current_stream(dev).cuda_stream


_fns = {}


def _fn(kind):
    """The C entry point of kernel ``kind``, resolved once."""
    fn = _fns.get(kind)
    if fn is None:
        from rankfm_tpu_torch.ops import _build
        fn = _fns[kind] = getattr(_build.load("table_update"),
                                  f"rfm_table_update_{kind}")
    return fn


def _launch(kind, tab, bias, idx, upd, eta, c):
    name = f"table_update_{kind}"
    _check(tab, bias, idx, upd, name)
    N, F = tab.shape
    B2 = idx.shape[0]
    dev = tab.device
    stream = _current_stream(dev)
    scr = scratch(dev, stream, N, kind, F, B2).data_ptr()
    # 'sorted': claim, then acc; 'dense': acc
    parts = ((scr + 8 * B2 * (F + 3), scr) if kind == "sorted" else (scr,))
    err = _fn(kind)(
        tab.data_ptr(), None if bias is None else bias.data_ptr(), N, F,
        idx.data_ptr(), upd.data_ptr(), B2, *parts, float(eta),
        float(c), stream)
    if err:
        from rankfm_tpu_torch.ops import _build
        raise RuntimeError(
            f"{name} kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err, 'table_update')})")
    LAUNCHES[kind] += 1
    return tab, bias


def table_update_sorted(tab, bias, idx, upd, eta, c):
    """Kernel B3 on CUDA tensors (arguments as `apply_table_update`), for
    tables of many more rows than updates: one cooperative launch in which
    one update of each touched row claims it, every update row is added
    into the claimant's fixed-point accumulator row with atomics, and the
    claimant rewrites the table row. Its work does not grow with the table.
    No sort, no copy of ``upd``, no allocation after the first call at a
    shape (`scratch`)."""
    return _launch("sorted", tab, bias, idx, upd, eta, c)


def table_update_dense(tab, bias, idx, upd, eta, c):
    """Kernel B2 on CUDA tensors (arguments as `apply_table_update`), for
    small tables: one cooperative launch that adds the update rows into a
    persistent fixed-point ``[N, F+3]`` accumulator with atomics and then,
    one warp per table row, rewrites the touched rows and clears their
    accumulator (`scratch`). No allocation and no clearing per call."""
    return _launch("dense", tab, bias, idx, upd, eta, c)
