"""Top-N retrieval (port of `rankfm_tpu/ops/topk.py`).

The plain version, as the JAX package computes it: one matmul over the
whole catalog, previously seen items masked to -inf, one ``torch.topk``
(`topk_bitmap_plain`, `topk_for_users_plain`). On the card, `topk_bitmap`
and the unfiltered `topk_for_users` run the kernel of
``csrc/topk_select.cu`` instead (`topk_select`): three launches that build
the 2F-wide operands, score every item against the users in registers,
drop the seen items by their bitmap bit and keep each user's running top
``n_items``, then merge the per-split lists. No ``[B, I]`` matrix is
written and nothing is kept between calls.

The rule (`runs_kernel`): a chunk on a CUDA device with ``1 <= n_items <=
K_MAX`` takes the kernel; any other chunk takes the plain version. The
seen-pair filter of `topk_for_users` (the binary-search sampler) always
takes the plain version. On a CUDA tensor the kernel's wrapper launches it
or raises; nothing falls back.

A slot with no unseen item left comes back as item -1 (score -inf);
`RankFM.recommend` turns it into NaN. Items of equal score may come back
in another order from the kernel than from ``torch.topk``.
"""

from __future__ import annotations

from collections import Counter

import torch

from rankfm_tpu_torch.ops import scoring
from rankfm_tpu_torch.ops.scatter import _current_stream

# the largest ``n_items`` the kernel takes (its heap of candidates per user
# row lives in shared memory: 1 KiB per slot for a block's 128 rows)
K_MAX = 128
# the kernel's tiles (`csrc/topk_select.cu`): users of a block, items of a
# tile, the depth staged at a time
BLOCK_USERS, TILE_ITEMS, DEPTH = 128, 128, 8
# shared memory of the kernel's block before its heaps, per row: the score
# tile's row (whose room the staged operands share), a pass byte for each
# of the 16 threads that computed it, the threshold, 4 bitmap words, a
# column byte for each score; and what one SM has
HEAP_OFFSET_BYTES = BLOCK_USERS * ((TILE_ITEMS + 4) * 4 + 16 + 4 + 16
                                   + TILE_ITEMS)
SM_SHARED_BYTES, BLOCK_RESERVED_BYTES = 233_472, 1_024
# the merge stages a user's candidates (8 bytes each) and a position for
# each list (4 bytes) in this much shared memory
MERGE_BYTES = 48 * 1024

# kernel calls, keyed by ``(n_items, has_bitmap)``: one count per chunk
LAUNCHES = Counter()
# chunks on the card that took the plain version, keyed by ``(n_items,
# filter)`` with filter 'bitmap', 'none' or 'pairs'
PLAIN = Counter()


def _top(scores, n_items):
    top_scores, top_items = torch.topk(scores, n_items, dim=1)
    top_items = torch.where(torch.isneginf(top_scores), -1, top_items)
    return top_items.to(torch.int32), top_scores


def topk_for_users_plain(w, x_uf, x_if, u_idx, n_items, seen_rows,
                         seen_cols):
    """`topk_for_users` in plain PyTorch ops."""
    scores = scoring.score_all_items(w, x_uf, x_if, u_idx)          # [B, I]
    if seen_rows.shape[0] > 0:
        ok = seen_rows >= 0
        scores[seen_rows[ok].long(), seen_cols[ok].long()] = float("-inf")
    return _top(scores, n_items)


def topk_bitmap_plain(w, x_uf, x_if, u_idx, n_items, bitmap_words):
    """`topk_bitmap` in plain PyTorch ops."""
    scores = scoring.score_all_items(w, x_uf, x_if, u_idx)          # [B, I]
    col = torch.arange(scores.shape[1], device=scores.device)
    words = bitmap_words[u_idx][:, col >> 5]                        # [B, I]
    seen = ((words >> (col & 31)) & 1).bool()
    scores = scores.masked_fill(seen, float("-inf"))
    return _top(scores, n_items)


def runs_kernel(device, n_items):
    """Does a chunk of ``n_items`` per user on ``device`` take the kernel?"""
    return device.type == "cuda" and 1 <= int(n_items) <= K_MAX


def topk_for_users(w, x_uf, x_if, u_idx, n_items, seen_rows, seen_cols):
    """Top-``n_items`` item indices (int32 ``[B, n_items]``) and scores (f32)
    for each user in ``u_idx``.

    ``seen_rows``/``seen_cols`` are flat int tensors of (batch-row, item)
    pairs to exclude; empty tensors disable filtering and a negative row
    disables one pair.
    """
    unfiltered = seen_rows.shape[0] == 0
    if unfiltered and runs_kernel(u_idx.device, n_items):
        return topk_select(w, x_uf, x_if, u_idx, n_items)
    if u_idx.device.type == "cuda":
        PLAIN[(int(n_items), "none" if unfiltered else "pairs")] += 1
    return topk_for_users_plain(w, x_uf, x_if, u_idx, n_items, seen_rows,
                                seen_cols)


def topk_bitmap(w, x_uf, x_if, u_idx, n_items, bitmap_words):
    """Top-N (int32 items, f32 scores) with previously seen items masked
    from the packed membership bitmap (`negatives.build_bitmap_words`, held
    as int32 words)."""
    if runs_kernel(u_idx.device, n_items):
        return topk_select(w, x_uf, x_if, u_idx, n_items, bitmap_words)
    if u_idx.device.type == "cuda":
        PLAIN[(int(n_items), "bitmap")] += 1
    return topk_bitmap_plain(w, x_uf, x_if, u_idx, n_items, bitmap_words)


def _round_up(x, m):
    return (x + m - 1) // m * m


def shared_bytes(k):
    """Dynamic shared memory of one block of the kernel for ``k`` slots."""
    return HEAP_OFFSET_BYTES + k * BLOCK_USERS * 8


def launch_plan(B, I, F, k, n_sm):
    """``(S, words)``: the number of item splits of the kernel's grid for
    ``B`` users, ``I`` items, ``F`` factors and ``k`` slots on a card of
    ``n_sm`` SMs, and the f32 words of its scratch.

    The grid is ``S`` splits x ``ceil(B / 128)`` user blocks; ``S`` is the
    least that fills every SM for one wave (two blocks an SM while their
    shared memory allows), at most the number of 128-item tiles, and at
    most what the merge can stage of a user's ``S * k`` candidates. The
    scratch holds the item operands ``[Ip, Kp]``, the user operands ``[Bp,
    Kp]``, the item biases ``[Ip]`` and each split's candidates (score and
    item) ``[B, S, k]``, with Kp, Ip, Bp the depth 2F, I and B rounded up
    to the tiles."""
    Kp = _round_up(2 * F, DEPTH)
    Ip = _round_up(I, TILE_ITEMS)
    Bp = _round_up(B, BLOCK_USERS)
    per_sm = max(1, min(2, SM_SHARED_BYTES
                        // (shared_bytes(k) + BLOCK_RESERVED_BYTES)))
    n_ub = Bp // BLOCK_USERS
    S = max(1, min(Ip // TILE_ITEMS, -(-per_sm * n_sm // n_ub),
                   MERGE_BYTES // (8 * k + 4)))
    return S, (Ip + Bp) * Kp + Ip + 2 * B * S * k


_n_sm = {}


def _sm_count(dev):
    n = _n_sm.get(dev.index)
    if n is None:
        n = _n_sm[dev.index] = torch.cuda.get_device_properties(
            dev).multi_processor_count
    return n


_NAMES = ("u_idx", "x_uf", "x_if", "w['w_i']", "w['w_if']", "w['v_u']",
          "w['v_i']", "w['v_uf']", "w['v_if']", "bitmap_words")
_DTYPES = (torch.int64,) + (torch.float32,) * 8 + (torch.int32,)


def _check(w, x_uf, x_if, u_idx, bitmap_words):
    """Raise on what the kernel does not take; returns ``(U, I, F, P, Q)``.
    The common case is a few comparisons of tuples; the messages are built
    only on a failure."""
    ts = (u_idx, x_uf, x_if, w["w_i"], w["w_if"], w["v_u"], w["v_i"],
          w["v_uf"], w["v_if"])
    if bitmap_words is not None:
        ts += (bitmap_words,)
    dev = u_idx.device
    U, F = w["v_u"].shape if w["v_u"].dim() == 2 else (0, 0)
    I, P, Q = w["v_i"].shape[0], x_uf.shape[-1], x_if.shape[-1]
    want = ((U, P), (I, Q), (I,), (Q,), (U, F), (I, F), (P, F), (Q, F))
    if bitmap_words is not None:
        want += ((U, (I + 31) // 32),)
    if (dev.type == "cuda"
            and all(t.get_device() == dev.index for t in ts)
            and tuple(t.dtype for t in ts) == _DTYPES[:len(ts)]
            and all(t.is_contiguous() for t in ts)
            and u_idx.dim() == 1
            and tuple(t.shape for t in ts[1:]) == want and F >= 1 and I >= 1):
        return U, I, F, P, Q
    if dev.type != "cuda":
        raise ValueError(f"topk_select: needs CUDA tensors, got u_idx on {dev}")
    for name, t, dtype in zip(_NAMES, ts, _DTYPES):
        ndim = 1 if name in ("u_idx", "w['w_i']", "w['w_if']") else 2
        if not (t.dtype is dtype and t.dim() == ndim and t.device == dev
                and t.is_contiguous()):
            raise ValueError(
                f"topk_select: {name} must be a contiguous {ndim}-d {dtype} "
                f"tensor on {dev}, got {t.dtype} {tuple(t.shape)} on "
                f"{t.device} (contiguous={t.is_contiguous()})")
    for name, t, shape in zip(_NAMES[1:], ts[1:], want):
        if tuple(t.shape) != shape:
            raise ValueError(f"topk_select: {name} has shape {tuple(t.shape)}"
                             f", not {shape} (U={U}, I={I}, F={F}, P={P}, "
                             f"Q={Q})")
    raise ValueError(f"topk_select: needs F >= 1 and I >= 1, got F={F}, "
                     f"I={I}")


_fn = []


def topk_select(w, x_uf, x_if, u_idx, n_items, bitmap_words=None):
    """The kernel on CUDA tensors: the top ``n_items`` (1 to `K_MAX`) items
    of each user in ``u_idx`` (int64 ``[B]``) by descending score, as int32
    items and f32 scores ``[B, n_items]``, skipping the items set in the
    user's row of ``bitmap_words`` (int32 ``[U, ceil(I / 32)]``; None: no
    filter). Three launches on the current stream, no synchronisation; a
    slot with no item left is -1 with score -inf, and so is every slot of a
    user index outside ``[0, U)``."""
    U, I, F, P, Q = _check(w, x_uf, x_if, u_idx, bitmap_words)
    k = int(n_items)
    if not 1 <= k <= K_MAX:
        raise ValueError(f"topk_select: n_items must be in [1, {K_MAX}], "
                         f"got {k}")
    dev = u_idx.device
    B = u_idx.shape[0]
    if B == 0:
        return (torch.empty((0, k), dtype=torch.int32, device=dev),
                torch.empty((0, k), dtype=torch.float32, device=dev))
    S, words = launch_plan(B, I, F, k, _sm_count(dev))
    # one allocation: the scratch, then the items and the scores
    buf = torch.empty(words + 2 * B * k, dtype=torch.int32, device=dev)
    items = buf[words:words + B * k].view(B, k)
    scores = buf[words + B * k:].view(torch.float32).view(B, k)
    if not _fn:
        from rankfm_tpu_torch.ops import _build
        _fn.append(_build.load("topk_select").rfm_topk_select)
    bm = bitmap_words
    ptr = buf.data_ptr()
    err = _fn[0](
        w["v_u"].data_ptr(), w["v_i"].data_ptr(), w["w_i"].data_ptr(),
        w["v_uf"].data_ptr(), w["v_if"].data_ptr(), w["w_if"].data_ptr(),
        x_uf.data_ptr(), x_if.data_ptr(), u_idx.data_ptr(),
        None if bm is None else bm.data_ptr(),
        0 if bm is None else bm.shape[1], U, I, F, P, Q, B, k, S, ptr,
        ptr + 4 * words, ptr + 4 * (words + B * k), _current_stream(dev))
    if err:
        from rankfm_tpu_torch.ops import _build
        raise RuntimeError(
            f"topk_select kernel launch failed: CUDA error {err} "
            f"({_build.error_string(err, 'topk_select')})")
    LAUNCHES[(k, bm is not None)] += 1
    return items, scores
