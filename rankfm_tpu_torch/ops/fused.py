"""Fused WARP/BPR training engine (port of `rankfm_tpu/ops/fused.py`).

The fit-time layout is the JAX package's, function for function, so the
arrays compare bit for bit:

* every interaction becomes one packed int32 record
  ``u_local | (i_local+1) << 10 | valid << 21`` plus its sample-weight bits,
  grouped by (user block, item block) and padded to whole chunks
  (`make_records_grouped`); each chunk's rows share ONE user block and ONE
  positive-item block;
* user histories become the blocked 16-bit membership pack
  (`pack_history`), pad items marked as members;
* the chunks are dealt to batches by their fractional position in their
  group (`deal_by_fraction`, where the JAX package deals them by rank), so
  every batch holds every group at the group's own rate;
* each epoch re-randomizes rows within their group with one single-key
  sort, rotates the batch order, and draws one size-weighted window block
  per chunk (`fused_epoch`); on a data-parallel mesh each rank runs its
  share of every batch's chunks and one all-reduce merges the replicas'
  deltas (`dp_fused_epoch`, `split_layout_for_mesh`).

The chunk step is `fused_batch`: on CUDA tensors it launches the Hopper
kernel of ``csrc/fused_chunk.cu`` (one cooperative launch per batch: the
window scoring as a tile product, the selection, the coalesced updates,
chunk after chunk); on CPU tensors it runs the plain version
`fused_batch_reference`. Both apply the chunks of a batch strictly
in order with the semantics of the TPU kernel's `_sub_round`
(`rankfm_tpu/ops/fused.py:611-971`, f32 tables, with or without side
features): gradients read at chunk start, then the user block, the
positive block and each window block decayed and updated in that order,
and the feature tables (``tab_uf [P, F+2]``, ``tab_if [Q, F+2]``,
`extend_feature_tables`) with their own decay rate.

What the port drops, because it carries no semantics: the 128-lane tables
(tables here are ``[rows, F+2]``: factors, then col F = 1 on the user side
and the item bias on the item side, col F+1 = 0 at rest), the lane-padded
window columns (the kernel reads the ``[U, NBLK*BLK/16]`` pack directly),
the 8-bit bf16 membership planes, the bf16 MXU casts, SUB sub-rounds and
revolving DMAs. Random draws come from counter-based Philox keys
(`_philox`) instead of the TPU's hardware generator, the epoch's draws on
the device as the JAX package's jitted epoch makes them.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from rankfm_tpu_torch.ops import _philox
# the keys of an epoch's and of a pre-shuffled layout's draws (the JAX
# package's ``fold_in(PRNGKey(seed), epoch)``, and ``fold_in(key, device)``
# for a mesh rank r > 0; ``fold_in(fold_in(PRNGKey(seed), 2**31 - 7), r)``)
from rankfm_tpu_torch.ops._philox import epoch_key, layout_key  # noqa: F401
from rankfm_tpu_torch.ops.scatter import (_current_stream, decay_rows,
                                          device_scalar, device_scalars)

LANES = 128          # TPU lane width: only the eligibility rule reads it
BITS_PER_LANE = 16
MARGIN = 1.0
MAX_BLK = 1024
UBLK = 1024          # default user-bucket cap; see pick_user_block
# catalogs beyond this many window blocks leave the fused engine
FUSED_NBLK_CAP = 64

# kernel launches of `fused_batch`, keyed by (chunk rows, user block rows,
# user features, item features, windows per chunk): one count per batch
# whose chunks went through the CUDA kernel
LAUNCHES = Counter()


def _round_up(x, m):
    return (x + m - 1) // m * m


# ---------------------------------------------------------------------------
# layout sizes (same functions as the JAX package)
# ---------------------------------------------------------------------------

def user_block(num_users, ub=None):
    """User-block size: the whole (guarded) table when it is small, else
    the ``ub`` cap."""
    return min(UBLK if ub is None else ub, _round_up(num_users + 1, 8))


def user_pad(num_users, ub=None):
    """User-table padding: at least one spare GUARD row, rounded to a whole
    number of user blocks."""
    return _round_up(num_users + 1, user_block(num_users, ub))


def num_user_blocks(num_users, ub=None):
    return user_pad(num_users, ub) // user_block(num_users, ub)


def pick_user_block(num_users, num_items, n, chunk):
    """Fused user-block rows (UB) for a fit: 1024 (the JAX package's
    oracle-validated default; see `rankfm_tpu.ops.fused.pick_user_block`)."""
    return UBLK


def block_size(num_items):
    """Window block size: a power of two in [128, 1024]."""
    p = 1 << max(LANES.bit_length() - 1, (max(num_items, 1) - 1).bit_length())
    return min(MAX_BLK, p)


def item_pad(num_items):
    """Item-table padding: a whole number of window blocks."""
    return _round_up(max(num_items, 1), block_size(num_items))


def pick_chunk(batch_size, num_users, num_items, n):
    """Fused chunk rows: the largest halving of 256 that divides the batch,
    halved further while (user block x item block) guard padding would
    exceed ~15% of the epoch rows. Requires ``batch_size % 128 == 0``."""
    assert batch_size % 128 == 0, \
        f"fused batch_size must be a multiple of 128, got {batch_size}"
    if batch_size <= 256:
        chunk = batch_size
    else:
        chunk = 256
        while chunk > 128 and batch_size % chunk:
            chunk //= 2
    ng = num_user_blocks(num_users) * (
        item_pad(num_items) // block_size(num_items))
    while chunk >= 256 and ng * chunk > 0.15 * max(n, 1):
        chunk //= 2
    return chunk


def window_block_cdf(num_items):
    """Cumulative REAL item count per window block: windows are drawn with
    probability proportional to their real item count, so negatives stay
    uniform over the catalog."""
    blk = block_size(num_items)
    nblk = item_pad(num_items) // blk
    return np.minimum(np.arange(1, nblk + 1) * blk, num_items)


def default_n_windows(nblk):
    """Negative windows per chunk: 1 below 9 blocks, 4 beyond."""
    return 1 if nblk <= 8 else min(4, nblk)


# Fused eligibility is the JAX package's rule (tables + scratch within a
# 15 MB TPU VMEM budget), kept so that both packages plan a fit the same
# way. A rule derived from the H100's own limits is ROADMAP work.

def _fused_vmem_bytes(num_users, num_items, width, nw, x_uf_any, x_if_any):
    rows = user_pad(num_users) + item_pad(num_items)
    blk = block_size(num_items)
    s = rows * LANES * width
    s += nw * user_block(num_users) * LANES * 4
    if x_uf_any:
        s += user_block(num_users) * LANES * width + LANES * LANES * 4
    if x_if_any:
        s += (1 + nw) * blk * LANES * width + LANES * LANES * 4
    return s


def fused_table_mode(num_users, num_items, factors, x_uf_any, x_if_any,
                     vmem_table_budget=15 * 2**20, num_uf=0, num_if=0):
    """``'f32'``, ``'bf16'`` or ``None``: the JAX package's eligibility
    verdict for this configuration. The port always trains f32 tables."""
    if factors > LANES - 2:
        return None
    if (x_uf_any and num_uf > LANES) or (x_if_any and num_if > LANES):
        return None
    nblk = item_pad(num_items) // block_size(num_items)
    if nblk > FUSED_NBLK_CAP:
        return None
    nw = default_n_windows(nblk)
    if _fused_vmem_bytes(num_users, num_items, 4, nw, x_uf_any,
                         x_if_any) <= vmem_table_budget:
        return 'f32'
    if _fused_vmem_bytes(num_users, num_items, 2, nw, x_uf_any,
                         x_if_any) <= vmem_table_budget:
        return 'bf16'
    return None


def fused_eligible(num_users, num_items, factors, x_uf_any, x_if_any,
                   vmem_table_budget=15 * 2**20, num_uf=0, num_if=0):
    return fused_table_mode(num_users, num_items, factors, x_uf_any,
                            x_if_any, vmem_table_budget,
                            num_uf=num_uf, num_if=num_if) is not None


def max_n_windows(num_users, num_items, table_bf16, x_uf_any=False,
                  x_if_any=False, vmem_budget=15 * 2**20):
    """Largest per-chunk window count the JAX package's budget admits
    (clamps the `n_windows` override identically in both packages)."""
    width = 2 if table_bf16 else 4
    blk = block_size(num_items)
    fixed = (user_pad(num_users) + item_pad(num_items)) * LANES * width
    if x_uf_any:
        fixed += user_block(num_users) * LANES * width + LANES * LANES * 4
    if x_if_any:
        fixed += blk * LANES * width + LANES * LANES * 4
    per_window = user_block(num_users) * LANES * 4
    if x_if_any:
        per_window += blk * LANES * width
    nblk = item_pad(num_items) // blk
    nw = (vmem_budget - fixed) // per_window
    return int(max(0, min(nw, nblk)))


# ---------------------------------------------------------------------------
# fit-time layout (host numpy, bit for bit the JAX package's arrays)
# ---------------------------------------------------------------------------

def _pack_coords(items, blk):
    """item index -> (word, bit) in the blocked 16-bit pack: block
    ``b = i // blk`` owns words ``[b*LW, (b+1)*LW)`` with ``LW = blk/16``;
    item ``j`` of the block is bit ``j // LW`` of word ``j % LW``."""
    lw = blk // BITS_PER_LANE
    b = items // blk
    j = items - b * blk
    return b * lw + (j % lw), j // lw


def pack_history(offsets, flat_items, num_users, num_items):
    """Blocked 16-bit history pack -> int32 [U, NBLK*BLK/16]. Items
    ``>= num_items`` (window padding) are members of every user."""
    blk = block_size(num_items)
    i_pad = item_pad(num_items)
    w = i_pad // BITS_PER_LANE
    packed = np.zeros((num_users, w), dtype=np.int32)
    counts = np.diff(offsets).astype(np.int64)
    users = np.repeat(np.arange(num_users, dtype=np.int64), counts)
    lane, bit = _pack_coords(flat_items.astype(np.int64), blk)
    np.bitwise_or.at(packed, (users, lane), np.int32(1) << bit)
    packed |= pad_row(num_items)[None, :]
    return packed


def pad_row(num_items):
    """int32 [W] row with the bits of pad items (>= num_items) set."""
    blk = block_size(num_items)
    i_pad = item_pad(num_items)
    w = i_pad // BITS_PER_LANE
    row = np.zeros(w, dtype=np.int32)
    pads = np.arange(num_items, i_pad, dtype=np.int64)
    lane, bit = _pack_coords(pads, blk)
    np.bitwise_or.at(row, lane, np.int32(1) << bit)
    return row


def make_records_grouped(u, i, sw, num_users, num_items, batch_size, chunk,
                         ub=None):
    """Fit-time epoch layout, the JAX package's function unchanged.

    Returns ``(rec [n_pad, 2], group [n_pad], chunkids [nb, nT],
    ublk [nb, nT], iblk [nb, nT])``: the packed records grouped by (user
    block, item block), each group padded to whole chunks and the tail to
    whole batches by all-zero guard records; ``group`` is each slot's group
    (tail guards sort last); ``chunkids`` the interleaved chunk visit order
    (by rank within group, then group); ``ublk``/``iblk`` the block ids of
    the chunk at each visit position. The padded chunk count is quantized
    into ~3%-wide buckets, so small row-count drift keeps the shapes.
    """
    n = len(u)
    NBU = num_user_blocks(num_users, ub)
    BLK = block_size(num_items)
    NBI = item_pad(num_items) // BLK
    NG = NBU * NBI
    nT = batch_size // chunk
    assert nT * chunk == batch_size
    u = np.asarray(u, dtype=np.int32)
    i = np.asarray(i, dtype=np.int32)
    sw = np.asarray(sw, dtype=np.float32)
    if NBU == 1:
        ubid = np.zeros(n, dtype=np.int32)
    else:
        ubw = user_block(num_users, ub)
        assert ubw & (ubw - 1) == 0, ubw  # NBU > 1 implies ubw == cap (pow2)
        ubid = (u >> (ubw.bit_length() - 1)).astype(np.int32)
    gid = ubid * NBI + (i // BLK).astype(np.int32)
    order = np.argsort(gid, kind="stable")
    g_s = gid[order]
    cnt = np.bincount(g_s, minlength=NG)
    pad_cnt = (cnt + chunk - 1) // chunk * chunk
    nC = int(pad_cnt.sum()) // chunk
    nC_pad = (nC + nT - 1) // nT * nT
    q = max(nT, 1 << max(0, nC_pad.bit_length() - 6))
    nC_pad = _round_up(_round_up(nC_pad, q), nT)
    n_pad = nC_pad * chunk

    rec = np.zeros((n_pad, 2), dtype=np.int32)
    src_start = np.cumsum(cnt) - cnt
    dst_start = np.cumsum(pad_cnt) - pad_cnt
    dst = (np.arange(n, dtype=np.int64)
           - src_start[g_s] + dst_start[g_s])
    ubw = user_block(num_users, ub)
    u_loc = (u - ubid * ubw).astype(np.int32)
    i_loc1 = (i & (BLK - 1)) + 1                       # BLK is a pow2
    rec[dst, 0] = u_loc[order] | (i_loc1[order] << 10) | (1 << 21)
    rec[dst, 1] = sw[order].view(np.int32)

    group = np.full(n_pad, NG, dtype=np.int32)
    group[:int(pad_cnt.sum())] = np.repeat(
        np.arange(NG, dtype=np.int32), pad_cnt)
    cpg = pad_cnt // chunk
    gid_c = np.repeat(np.arange(NG, dtype=np.int32), cpg)        # [nC]
    rank_c = np.arange(nC, dtype=np.int32) - np.repeat(
        np.cumsum(cpg) - cpg, cpg).astype(np.int32)
    perm = np.full(nC_pad, nC_pad - 1, dtype=np.int32)
    perm[:nC] = np.lexsort((gid_c, rank_c)).astype(np.int32)
    ublk = np.zeros(nC_pad, dtype=np.int32)
    iblk = np.zeros(nC_pad, dtype=np.int32)
    ublk[:nC] = (gid_c // NBI)[perm[:nC]]
    iblk[:nC] = (gid_c % NBI)[perm[:nC]]
    nb = nC_pad // nT
    return (rec, group, perm.reshape(nb, nT), ublk.reshape(nb, nT),
            iblk.reshape(nb, nT))


def deal_by_fraction(layout, chunk, num_users, num_items, ub=None):
    """`make_records_grouped`'s layout with its chunks dealt to the batches
    by their fractional position in their group: chunk ``r`` of a group of
    ``n`` chunks sits at ``(r + 1/2) / n``, and the chunks are visited in
    that order (ties by group), so every batch holds every (user block,
    item block) group at the group's own rate.

    `make_records_grouped` (the JAX package's function, kept equal to it)
    visits the chunks by their rank in the group first. Its first batches
    then hold every group, its last ones only the largest: at the ML-1M
    headline the smallest item block has all its positives in the first
    16 of 23 batches and none in the last 7. An epoch rotates that order,
    so every epoch replays the same burst from another starting point; the
    hit rate after an epoch swung with the offset at which the epoch
    stopped, and a fit ended outside the oracle's quality band at several
    model seeds (`PERF.md` §6, the batch deal). ``rec`` and ``group`` are
    unchanged; ``cids``, ``ublk`` and ``iblk`` are dealt anew (the padding
    positions keep the all-guard chunk and block 0)."""
    rec, group, cids, ublk, iblk = layout
    nb, nT = cids.shape
    NBI = item_pad(num_items) // block_size(num_items)
    NG = num_user_blocks(num_users, ub) * NBI
    gc = np.asarray(group)[::chunk]              # each chunk slot's group
    cpg = np.bincount(gc[gc < NG], minlength=NG)
    nC = int(cpg.sum())
    gid_c = gc[:nC].astype(np.int64)             # real chunks come first
    rank_c = np.arange(nC) - np.repeat(np.cumsum(cpg) - cpg, cpg)
    frac = (2 * rank_c + 1) / (2.0 * cpg[gid_c])
    perm = np.full(nb * nT, nb * nT - 1, dtype=np.int32)
    perm[:nC] = np.lexsort((gid_c, frac))
    ublk_d = np.zeros(nb * nT, dtype=np.int32)
    iblk_d = np.zeros(nb * nT, dtype=np.int32)
    ublk_d[:nC] = gid_c[perm[:nC]] // NBI
    iblk_d[:nC] = gid_c[perm[:nC]] % NBI
    return (rec, group, perm.reshape(nb, nT), ublk_d.reshape(nb, nT),
            iblk_d.reshape(nb, nT))


def unpack_record_cols(p0):
    """(u_local, i_local_plus_1, valid) from packed record column 0; works
    on numpy arrays and tensors."""
    return p0 & 1023, (p0 >> 10) & 2047, (p0 >> 21) & 1


def extend_tables(w_i, v_u, v_i, u_pad, i_pad):
    """[U,F]/[I,F]/[I] tensors -> ``tab_u [u_pad, F+2]`` (col F = 1) and
    ``tab_i [i_pad, F+2]`` (col F = w_i); col F+1 is 0 on both."""
    U, F = v_u.shape
    I = v_i.shape[0]
    tu = torch.zeros((u_pad, F + 2), dtype=torch.float32, device=v_u.device)
    tu[:U, :F] = v_u
    tu[:U, F] = 1.0
    ti = torch.zeros((i_pad, F + 2), dtype=torch.float32, device=v_i.device)
    ti[:I, :F] = v_i
    ti[:I, F] = w_i
    return tu, ti


def extract_tables(tab_u, tab_i, num_users, num_items, factors):
    """Inverse of `extend_tables`: ``(w_i, v_u, v_i)`` copies."""
    v_u = tab_u[:num_users, :factors].clone()
    v_i = tab_i[:num_items, :factors].clone()
    w_i = tab_i[:num_items, factors].clone()
    return w_i, v_u, v_i


def extend_feature_tables(v_uf, w_if, v_if):
    """``v_uf [P,F]``, ``w_if [Q]``, ``v_if [Q,F]`` -> ``tab_uf [P, F+2]``
    (factors, col F stays 0 so the user row's constant-1 lane survives
    augmentation) and ``tab_if [Q, F+2]`` (factors, col F = w_if: one
    product ``x_if @ tab_if`` gives the feature representation and the
    feature bias). `rankfm_tpu/ops/fused.py:400-415` without the 128-lane
    padding."""
    P, F = v_uf.shape
    Q = v_if.shape[0]
    tuf = torch.zeros((P, F + 2), dtype=torch.float32, device=v_uf.device)
    tuf[:, :F] = v_uf
    tif = torch.zeros((Q, F + 2), dtype=torch.float32, device=v_if.device)
    tif[:, :F] = v_if
    tif[:, F] = w_if
    return tuf, tif


def extract_feature_tables(tab_uf, tab_if, num_uf, num_if, factors):
    """Inverse of `extend_feature_tables`: ``(v_uf, w_if, v_if)`` copies,
    None for an absent table."""
    v_uf = None if tab_uf is None else tab_uf[:num_uf, :factors].clone()
    if tab_if is None:
        return v_uf, None, None
    return (v_uf, tab_if[:num_if, factors].clone(),
            tab_if[:num_if, :factors].clone())


def pad_feature_cols(x, rows_pad):
    """``x [N, K] -> [rows_pad, K]`` f32 with zero pad rows: the per-fit
    feature layout of the featured chunk step (the JAX package's
    `pad_feature_cols` pads the columns to 128 lanes as well)."""
    out = torch.zeros((rows_pad, x.shape[1]), dtype=torch.float32,
                      device=x.device)
    out[:x.shape[0]] = x
    return out


# ---------------------------------------------------------------------------
# the chunk step, plain PyTorch version
# ---------------------------------------------------------------------------

def select_key(pw, nonmem, u01, r1, M, num_items):
    """The closed-form WARP/BPR negative choice over one chunk's window
    slots (`rankfm_tpu/ops/fused.py:771-810`).

    ``pw [C, W2]`` pairwise utilities, ``nonmem [C, W2]`` bool, ``u01
    [C, W2]`` and ``r1 [C]`` uniforms in [0, 1). Returns ``(key [C, W2],
    sampled [C], mult [C])``: the chosen negatives are the slots where
    ``key`` equals its row maximum (ties split evenly), none when the
    maximum is -inf.
    """
    C = pw.shape[0]
    dev = pw.device
    log_I = math.log(num_items) if num_items > 1 else 1.0
    neg_inf = torch.tensor(float("-inf"), device=dev)
    if M == 1:
        # BPR: a uniform window non-member
        key = torch.where(nonmem, u01, neg_inf)
        sampled = torch.ones(C, device=dev)
        mult = torch.full((C,), math.log(max(num_items - 1, 1)) / log_I,
                          device=dev)
        return key, sampled, mult
    viol = (pw < MARGIN) & nonmem
    nv = viol.sum(1).to(torch.float32)
    n_nonmem = nonmem.sum(1).to(torch.float32)
    # the draw count: sampled ~ min(M, 1 + Geometric(nv / n_nonmem))
    p_c = torch.clamp(nv / torch.clamp(n_nonmem, min=1.0), 1e-9, 1.0 - 1e-7)
    geo = torch.floor(torch.log(torch.clamp(1.0 - r1, min=1e-30))
                      / torch.log(1.0 - p_c)) + 1.0
    geo = torch.where(nv > 0, geo, torch.tensor(float(M), device=dev))
    found = (nv > 0) & (geo <= M)
    sampled = torch.clamp(geo, max=float(M))
    # a uniform violator when found; else the hardest non-violator of a
    # Bernoulli(M / n_nonmem) subset, items outside the subset 1e6 lower
    pthr = M / torch.clamp(n_nonmem, min=1.0)
    off_subset = (u01 >= pthr[:, None]).to(torch.float32) * 1e6
    key = torch.where(
        found[:, None],
        torch.where(viol, u01, neg_inf),
        torch.where(nonmem & ~viol, -pw - off_subset, neg_inf))
    ratio = torch.clamp(torch.floor((num_items - 1) / sampled), min=1.0)
    mult = torch.log(ratio) / log_I
    return key, sampled, mult


def _decay_c(dreg):
    """The per-touch decay factor ``max(1 - dreg, 1e-8)`` in f32 (a 0-dim
    tensor when ``dreg`` is one)."""
    if isinstance(dreg, torch.Tensor):
        return torch.clamp(1.0 - dreg, min=1e-8)
    return float(np.maximum(np.float32(1.0) - np.float32(dreg),
                            np.float32(1e-8)))


def _chunk_reference(tab_u, tab_i, rec, packed, blks, ubase, ibase, u01, r1,
                     eta, dreg, F, M, BLK, UB, num_items, feats=None):
    """One chunk, in place on the tables. Returns the per-row ll terms,
    each row's lowest chosen window slot (-1: none) and the key matrix.

    ``dreg`` is the pair ``(eta*2*alpha, eta*2*beta)``; ``feats`` is None
    or ``(x_uf, x_if, tab_uf, tab_if)`` with None for an absent side (the
    TPU kernel's ``HAS_UF``/``HAS_IF``)."""
    dev = tab_u.device
    p0 = rec[:, 0]
    sw = rec[:, 1].contiguous().view(torch.float32)
    u_loc, i1, valid_i = unpack_record_cols(p0)
    ok = valid_i == 1
    valid = valid_i.to(torch.float32)
    u_abs = (ubase + u_loc).long()
    i_abs = (ibase + torch.clamp(i1 - 1, min=0)).long()
    NW = blks.shape[0]
    LW = BLK // BITS_PER_LANE
    jloc = torch.arange(BLK, device=dev)
    blks_d = blks.to(dev).long()
    items = (blks_d[:, None] * BLK + jloc[None, :]).reshape(-1)       # [W2]

    # everything below reads the chunk-start tables
    u_rows = tab_u[u_abs]                                   # [C, D]
    i_rows = tab_i[i_abs]
    tw = tab_i[items]                                       # [W2, D]
    x_uf, x_if, tab_uf, tab_if = feats or (None,) * 4
    has_uf, has_if = tab_uf is not None, tab_if is not None
    # side-feature representations (`rankfm_tpu/ops/fused.py:704-754`):
    # the user row gains x_uf[u] @ tab_uf, every item row x_if @ tab_if
    # (col F: the feature bias); the reference FM has no uf x if term, so
    # the cross products are taken out again
    u_aug, i_tot, tw_tot = u_rows, i_rows, tw
    if has_uf:
        xuf_rows = x_uf[u_abs]                              # [C, P]
        ufrep = xuf_rows @ tab_uf
        u_aug = u_rows + ufrep
    if has_if:
        xif_i = x_if[i_abs]                                 # [C, Q]
        xif_win = x_if[items]                               # [W2, Q]
        ifrep_i = xif_i @ tab_if
        ifrep_win = xif_win @ tab_if
        i_tot = i_rows + ifrep_i
        tw_tot = tw + ifrep_win
    ut_ui = (u_aug * i_tot).sum(1)
    all_w = u_aug @ tw_tot.T                                # [C, W2]
    if has_uf and has_if:
        ut_ui = ut_ui - (ufrep * ifrep_i).sum(1)
        all_w = all_w - ufrep @ ifrep_win.T
    pw = ut_ui[:, None] - all_w
    words = (blks_d[:, None] * LW + (jloc % LW)[None, :]).reshape(-1)
    bits = (jloc // LW).repeat(NW)
    # guard rows may point past the pack: their user index is clamped
    urow = packed[torch.clamp(u_abs, max=packed.shape[0] - 1)]
    nonmem = ((urow[:, words] >> bits) & 1) == 0

    key, _, mult = select_key(pw, nonmem, u01, r1, M, num_items)
    mx = key.max(1, keepdim=True).values
    oh_j = ((key == mx) & (key > float("-inf"))).to(torch.float32) \
        * valid[:, None]
    cnt_j = oh_j.sum(1)
    w_j = oh_j / torch.clamp(cnt_j, min=1.0)[:, None]       # tie split
    has_j = (cnt_j > 0).to(torch.float32)
    j_rows = w_j @ tw                                       # [C, D]
    j_tot = w_j @ tw_tot if has_if else j_rows
    ut_uj = (u_aug * j_tot).sum(1)
    if has_uf and has_if:
        ut_uj = ut_uj - (ufrep * (j_tot - j_rows)).sum(1)
    pw_sel = ut_ui - ut_uj
    gate = valid * has_j
    d = gate * sw * mult * torch.sigmoid(-pw_sel)
    ll = torch.where(gate > 0, torch.nn.functional.logsigmoid(pw_sel),
                     torch.zeros_like(pw_sel))
    chosen = torch.where(gate > 0, key.argmax(1), -1).to(torch.int32)

    # gradient rows + per-row touch counts (valid rows only); with side
    # features the user gradient is the full utility derivative and the
    # item gradient the augmented user row
    D = tab_u.shape[1]
    g_u = d[:, None] * (i_tot - j_tot)
    acc_u = torch.zeros((UB, D), device=dev).index_add_(
        0, u_loc[ok].long(), g_u[ok])
    cnt_u = torch.zeros(UB, device=dev).index_add_(0, u_loc[ok].long(),
                                                   valid[ok])
    g_ip = d[:, None] * u_aug                     # col F = d: the bias grad
    acc_p = torch.zeros((BLK, D), device=dev).index_add_(
        0, (i1[ok] - 1).long(), g_ip[ok])
    cnt_p = torch.zeros(BLK, device=dev).index_add_(0, (i1[ok] - 1).long(),
                                                    valid[ok])
    acc_w = w_j.T @ (-g_ip)                                  # [W2, D]
    cnt_w = w_j.T @ gate                                     # [W2]

    # decay + update (w <- c^k w + eta (1-c^k)/(k(1-c)) sum(g) for k
    # touches, c = max(1 - dreg, 1e-8)), in the kernel's order: user block,
    # positive block, then each window block (a block drawn twice is
    # updated twice)
    c = _decay_c(dreg[0])
    rows = slice(ubase, ubase + UB)
    tab_u[rows, :F] = decay_rows(tab_u[rows, :F], acc_u[:, :F], cnt_u, eta, c)
    rows = slice(ibase, ibase + BLK)
    tab_i[rows, :F + 1] = decay_rows(tab_i[rows, :F + 1], acc_p[:, :F + 1],
                                     cnt_p, eta, c)
    for w in range(NW):
        b = int(blks[w])
        sl = slice(w * BLK, (w + 1) * BLK)
        rows = slice(b * BLK, (b + 1) * BLK)
        tab_i[rows, :F + 1] = decay_rows(tab_i[rows, :F + 1],
                                         acc_w[sl, :F + 1], cnt_w[sl], eta, c)

    # feature tables (`rankfm_tpu/ops/fused.py:901-971`): the same
    # geometric per-touch decay at c = 1 - eta*2*beta, one touch per
    # sample with a negative (valid * has_j)
    if has_uf or has_if:
        cf = _decay_c(dreg[1])
        touch = gate[:, None]
    if has_if:
        # v_if[q] is touched by a nonzero feature difference, w_if (col F,
        # payload d * the raw user row's constant 1) by every sample
        xif_j = w_j @ xif_win                       # tie-split mean [C, Q]
        diff = xif_i - xif_j
        g_if = diff.T @ (d[:, None] * u_rows)       # [Q, D]
        cnt_if = ((diff != 0).to(torch.float32) * touch).sum(0)
        n_ok = gate.sum().expand(tab_if.shape[0])
        tab_if[:, :F] = decay_rows(tab_if[:, :F], g_if[:, :F], cnt_if, eta,
                                   cf)
        tab_if[:, F] = decay_rows(tab_if[:, F], g_if[:, F], n_ok, eta, cf)
    if has_uf:
        # v_uf: payload d * the RAW item rows' difference, touched by a
        # nonzero x_uf; col F stays 0
        g_uf = xuf_rows.T @ (d[:, None] * (i_rows - j_rows))    # [P, D]
        cnt_uf = ((xuf_rows != 0).to(torch.float32) * touch).sum(0)
        tab_uf[:, :F] = decay_rows(tab_uf[:, :F], g_uf[:, :F], cnt_uf, eta,
                                   cf)
        tab_uf[:, F] = 0.0
    return ll, chosen, key


def _step_args(dreg, tab_u, tab_i, x_uf, x_if, tab_uf, tab_if):
    """``((eta*2*alpha, eta*2*beta), feats)`` from `fused_batch`'s
    arguments; ``feats`` is None without side features. Each feature
    matrix comes with its table and is padded to its side's table rows."""
    for x, tab, rows, side in ((x_uf, tab_uf, tab_u, "user"),
                               (x_if, tab_if, tab_i, "item")):
        if (x is None) != (tab is None):
            raise ValueError(f"fused_batch: the {side} feature matrix and "
                             f"its table come together")
        if x is not None and x.shape[0] != rows.shape[0]:
            raise ValueError(
                f"fused_batch: {side} features have {x.shape[0]} rows, the "
                f"{side} table {rows.shape[0]} (pad_feature_cols)")
    featured = tab_uf is not None or tab_if is not None
    return (dreg[0], dreg[1]), ((x_uf, x_if, tab_uf, tab_if) if featured
                                else None)


def fused_batch_reference(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed,
                          eta, dreg, *, factors, max_samples, ub_rows,
                          num_items, chosen=None, keys=None, x_uf=None,
                          x_if=None, tab_uf=None, tab_if=None, ll_rows=None):
    """Plain PyTorch version of one batch of the fused kernel.

    ``rec [nT*C, 2]`` int32 records in visit order, ``packed [U, W]``
    int32 history pack, ``blk [nT, NW]``, ``ublk [nT]``, ``iblk [nT]`` int32
    block ids, ``ub_rows`` the user block's rows (`user_block`), ``seed``
    the batch seed, ``dreg`` the pair ``(eta * 2 * alpha, eta * 2 * beta)``
    (the JAX kernel's ``dreg``). ``seed``, ``eta`` and ``dreg`` may be
    numbers or tensors (0-dim, 0-dim and ``[2]``), as an epoch hands them
    over without reading them on the host. Updates ``tab_u``/``tab_i`` IN
    PLACE, chunk after chunk, and returns the batch's log-likelihood (0-dim
    f32). The random draws are the kernel's Philox stream
    (`_philox.chunk_draws`).

    Side features (the TPU kernel's ``HAS_UF``/``HAS_IF``): ``x_uf
    [U_pad, P]`` with ``tab_uf [P, F+2]``, and/or ``x_if [I_pad, Q]`` with
    ``tab_if [Q, F+2]`` (`pad_feature_cols`, `extend_feature_tables`);
    the feature tables are updated in place too.

    Optional diagnostics: ``chosen [nT*C]`` int32 receives each row's
    lowest chosen window slot (-1: none), ``ll_rows [nT*C]`` f32 each row's
    log-likelihood term, and the list ``keys`` each chunk's ``[C, NW*BLK]``
    selection keys.
    """
    dreg, feats = _step_args(dreg, tab_u, tab_i, x_uf, x_if, tab_uf,
                             tab_if)
    nT, NW = blk.shape
    C = rec.shape[0] // nT
    BLK = block_size(num_items)
    blk_h, ublk_h, iblk_h = blk.cpu(), ublk.cpu(), iblk.cpu()
    lls = []
    for k in range(nT):
        u01_k, r1_k = _philox.chunk_draws(seed, k, C, NW * BLK,
                                          device=tab_u.device)
        ll, j, key = _chunk_reference(
            tab_u, tab_i, rec[k * C:(k + 1) * C], packed, blk_h[k],
            int(ublk_h[k]) * ub_rows, int(iblk_h[k]) * BLK, u01_k, r1_k,
            eta, dreg, factors, max_samples, BLK, ub_rows, num_items, feats)
        lls.append(ll)
        if ll_rows is not None:
            ll_rows[k * C:(k + 1) * C] = ll
        if chosen is not None:
            chosen[k * C:(k + 1) * C] = j
        if keys is not None:
            keys.append(key)
    return torch.cat(lls).sum()


def fused_batch(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg,
                *, factors, max_samples, ub_rows, num_items, chosen=None,
                x_uf=None, x_if=None, tab_uf=None, tab_if=None,
                phase_ns=None, ll_rows=None):
    """One batch of the fused WARP/BPR step (see `fused_batch_reference`
    for the arguments). CUDA tensors go through the Hopper kernel; CPU
    tensors through the plain version. Updates the tables in place and
    returns the batch log-likelihood.

    A diagnostic of the kernel only: ``phase_ns``, an int64 ``[4]`` CUDA
    tensor, gains the nanoseconds one block spent in each phase of the
    batch, barriers included (feature representations, window scoring,
    selection, updates)."""
    if tab_u.device.type == "cpu":
        return fused_batch_reference(
            tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg,
            factors=factors, max_samples=max_samples, ub_rows=ub_rows,
            num_items=num_items, chosen=chosen, x_uf=x_uf, x_if=x_if,
            tab_uf=tab_uf, tab_if=tab_if, ll_rows=ll_rows)
    if tab_u.device.type != "cuda":
        raise ValueError(f"fused_batch runs on cuda or cpu, not {tab_u.device}")
    dreg, feats = _step_args(dreg, tab_u, tab_i, x_uf, x_if, tab_uf,
                             tab_if)
    return _launch(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta,
                   dreg, factors, max_samples, ub_rows, num_items, chosen,
                   feats, phase_ns, ll_rows)


def scratch_sizes(nT, C, UB, BLK, NW, D, P=0, Q=0, has_uf=False,
                  has_if=False):
    """Element counts of the kernel's scratch tensors for one batch
    (`rfm_fused_batch` in ``csrc/fused_chunk.cu``):

    * ``acc`` int64, zeroed: the per-chunk gradient accumulator, in fixed
      point (scale 2^32), of the user block, the positive block and the
      ``NW`` window blocks, then the feature gradients ``[P + Q, D]``;
    * ``pw`` f32, uninitialised: one chunk's pairwise utilities
      ``[C, NW*BLK]`` followed by its ``ut_ui [C]``;
    * ``cnt`` int32, zeroed: each row's non-member and violator counts;
    * ``facc`` f32, zeroed (0 without side features): the chunk's feature
      representations (``UB`` user rows with user features, ``(1+NW)*BLK``
      item rows with item features), the feature touch counts ``[P + Q]``
      and one count of rows with a negative per chunk.
    """
    P, Q = (P if has_uf else 0), (Q if has_if else 0)
    n_rep = (UB if has_uf else 0) + ((1 + NW) * BLK if has_if else 0)
    return {"acc": (UB + (1 + NW) * BLK + P + Q) * D,
            "pw": C * NW * BLK + C,
            "cnt": 2 * C,
            "facc": (n_rep * D + P + Q + nT if has_uf or has_if else 0)}


def chunk_work(C, UB, BLK, NW, D, has_uf=False, has_if=False, P=0, Q=0,
               uf_nnz=None, if_nnz=None):
    """``(operations, bytes)`` one chunk of the fused step has to do and
    move, from its shapes: the numbers behind the kernel's roofline bound.

    Operations (f32, one FMA = 2): the window scoring ``2*C*NW*BLK*D``,
    twice that with item features (the product has depth ``2D``), plus
    the feature representations at ``uf_nnz`` / ``if_nnz`` nonzero
    features per row (default: dense, ``P`` / ``Q``). The selection
    (compares, one Philox draw per slot at most) and the ``O(C*D)``
    gradients are not counted.

    Bytes, each input read once and each output written once: the window
    rows, every row's history words for the windows, the records, the
    user rows and positive rows (read and written), the chosen window
    rows (at most one per row, written) and the ll terms; with side
    features the feature rows read and the feature tables read and
    written. ``UB`` only enters through the user representations."""
    W2 = NW * BLK
    ops = 2 * C * W2 * D * (2 if has_if else 1)
    nbytes = (W2 * D * 4                        # window rows
              + C * (W2 // BITS_PER_LANE) * 4   # history words
              + C * 8                           # records
              + 2 * 2 * C * D * 4               # user + positive rows, r/w
              + C * D * 4                       # chosen window rows, written
              + C * 4)                          # ll terms
    if has_uf:
        ops += 2 * UB * (P if uf_nnz is None else uf_nnz) * D
        nbytes += C * P * 4 + 2 * P * D * 4
    if has_if:
        ops += 2 * (1 + NW) * BLK * (Q if if_nnz is None else if_nnz) * D
        nbytes += (1 + NW) * BLK * Q * 4 + 2 * Q * D * 4
    return ops, nbytes


def phase_probe(n, cooperative):
    """Enqueue what ``n`` phase boundaries cost on the current CUDA
    stream: ``n`` grid barriers inside one cooperative launch, or ``n``
    empty dependent launches, on the batch kernel's grid. The caller times
    it (CUDA events)."""
    from rankfm_tpu_torch.ops import _build

    err = _build.load().rfm_phase_probe(
        int(n), int(bool(cooperative)),
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"phase probe failed: CUDA error {err} "
                           f"({_build.error_string(err)})")


def _check(name, t, dtype, device, ndim):
    if t.dtype != dtype or t.device != device or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_batch: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


# (device index, stream, shapes) -> the kernel's scratch tensors; the
# newest `_SCRATCH_MAX` are kept
_scratch = {}
_SCRATCH_MAX = 16


def scratch(device, stream, nT, C, UB, BLK, NW, D, P=0, Q=0, has_uf=False,
            has_if=False):
    """The persistent scratch of the kernel for one batch shape on
    ``device`` and the CUDA stream with the handle ``stream``
    (`scratch_sizes`, as `scatter.scratch` keeps B2's and B3's): ``acc``,
    ``cnt`` and ``facc`` zeroed, ``pw`` uninitialised, and ``ll_rows``
    (``[nT*C]`` f32, the rows' ll terms), allocated at the first call and
    reused by every later one.

    The kernel restores what it finds zeroed: it clears each accumulator
    row of ``acc`` as it applies it, each row's counts of ``cnt`` as it
    reads them, the feature touch counts of ``facc`` as it applies them and
    its per-chunk counts of rows with a negative when it starts, so no call
    clears anything. Per stream, like `scatter.scratch`: launches on one
    stream run in order."""
    n = scratch_sizes(nT, C, UB, BLK, NW, D, P, Q, has_uf, has_if)
    key = (device.index, stream, nT, C, tuple(sorted(n.items())))
    bufs = _scratch.get(key)
    if bufs is None:
        while len(_scratch) >= _SCRATCH_MAX:
            _scratch.pop(next(iter(_scratch)))
        bufs = _scratch[key] = {
            "acc": torch.zeros(n["acc"], dtype=torch.int64, device=device),
            "pw": torch.empty(n["pw"], dtype=torch.float32, device=device),
            "cnt": torch.zeros(n["cnt"], dtype=torch.int32, device=device),
            "facc": (torch.zeros(n["facc"], dtype=torch.float32,
                                 device=device) if n["facc"] else None),
            "ll_rows": torch.empty(nT * C, dtype=torch.float32,
                                   device=device)}
    return bufs


def _launch(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg,
            F, M, UB, num_items, chosen, feats, phase_ns=None,
            ll_rows=None):
    from rankfm_tpu_torch.ops import _build

    dev = tab_u.device
    x_uf, x_if, tab_uf, tab_if = feats or (None,) * 4
    # the optional tensors (chosen, features) are checked when given
    for name, t, dt, nd in (("tab_u", tab_u, torch.float32, 2),
                            ("tab_i", tab_i, torch.float32, 2),
                            ("rec", rec, torch.int32, 2),
                            ("packed", packed, torch.int32, 2),
                            ("blk", blk, torch.int32, 2),
                            ("ublk", ublk, torch.int32, 1),
                            ("iblk", iblk, torch.int32, 1),
                            ("chosen", chosen, torch.int32, 1),
                            ("ll_rows", ll_rows, torch.float32, 1),
                            ("phase_ns", phase_ns, torch.int64, 1),
                            ("x_uf", x_uf, torch.float32, 2),
                            ("x_if", x_if, torch.float32, 2),
                            ("tab_uf", tab_uf, torch.float32, 2),
                            ("tab_if", tab_if, torch.float32, 2)):
        if t is not None:
            _check(name, t, dt, dev, nd)
    nT, NW = blk.shape
    BLK = block_size(num_items)
    D = F + 2
    C = rec.shape[0] // nT
    P = 0 if x_uf is None else x_uf.shape[1]
    Q = 0 if x_if is None else x_if.shape[1]
    if (tab_u.shape[1] != D or tab_i.shape[1] != D or rec.shape[1] != 2
            or rec.shape[0] != nT * C or ublk.shape[0] != nT
            or iblk.shape[0] != nT
            or packed.shape[1] != item_pad(num_items) // BITS_PER_LANE
            or tab_i.shape[0] != item_pad(num_items)
            or tab_u.shape[0] % UB or UB > UBLK or D > LANES
            or NW > FUSED_NBLK_CAP or Q > 256
            or (chosen is not None and chosen.shape != (nT * C,))
            or (ll_rows is not None and ll_rows.shape != (nT * C,))
            or (phase_ns is not None and phase_ns.shape != (4,))
            or (x_uf is not None and tab_uf.shape != (P, D))
            or (x_if is not None and tab_if.shape != (Q, D))):
        raise ValueError(
            f"fused_batch: inconsistent shapes tab_u={tuple(tab_u.shape)} "
            f"tab_i={tuple(tab_i.shape)} rec={tuple(rec.shape)} "
            f"packed={tuple(packed.shape)} blk={tuple(blk.shape)} "
            + "".join(f"{n}={tuple(t.shape)} " for n, t in (
                ("x_uf", x_uf), ("tab_uf", tab_uf), ("x_if", x_if),
                ("tab_if", tab_if)) if t is not None)
            + f"F={F} UB={UB} num_items={num_items}")
    stream = _current_stream(dev)
    scr = scratch(dev, stream, nT, C, UB, BLK, NW, D, P, Q, x_uf is not None,
                  x_if is not None)
    if ll_rows is None:
        ll_rows = scr["ll_rows"]
    seed_t = device_scalar(seed, torch.int32, dev)
    scal = device_scalars(dev, eta, dreg[0], dreg[1])
    log_I = math.log(num_items) if num_items > 1 else 1.0

    def ptr(t):
        return None if t is None else t.data_ptr()

    # one library per instantiation of the kernel's two feature flags
    lib = _build.load(f"fused_chunk_{int(x_uf is not None)}"
                      f"{int(x_if is not None)}")
    err = lib.rfm_fused_batch(
        tab_u.data_ptr(), tab_i.data_ptr(), D, F,
        rec.data_ptr(), packed.data_ptr(), packed.shape[1],
        blk.data_ptr(), ublk.data_ptr(), iblk.data_ptr(),
        scr["acc"].data_ptr(), ll_rows.data_ptr(), ptr(chosen),
        nT, C, UB, BLK, NW, M, float(num_items - 1), log_I,
        math.log(max(num_items - 1, 1)) / log_I,
        seed_t.data_ptr(), scal.data_ptr(),
        ptr(x_uf), ptr(x_if), ptr(tab_uf), ptr(tab_if), P, Q,
        ptr(scr["facc"]), scr["pw"].data_ptr(), scr["cnt"].data_ptr(),
        ptr(phase_ns), stream)
    if err < 0:
        raise ValueError(
            f"fused_batch: {NW} windows of {BLK} items need {-err} bytes of "
            f"shared memory per block, more than this card gives a block: "
            f"fewer windows (n_windows / tail_windows)")
    if err:
        raise RuntimeError(f"fused chunk kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    LAUNCHES[(C, UB, x_uf is not None, x_if is not None, NW)] += 1
    return ll_rows.sum()


# ---------------------------------------------------------------------------
# one epoch
# ---------------------------------------------------------------------------

def draw_window_blocks(key, shape, num_items):
    """int32 window-block ids of ``shape`` drawn under ``key``, each block
    with probability proportional to its real item count
    (`window_block_cdf`): a uniform item of the catalog, and its block."""
    return window_blocks(_philox.bits(key, _philox.STREAM_BLOCKS,
                                      math.prod(shape)), shape, num_items)


def window_blocks(x, shape, num_items):
    """`draw_window_blocks` of the stream's 32-bit draws ``x``."""
    lg = block_size(num_items).bit_length() - 1
    return (_philox.below(x, num_items) >> lg).to(torch.int32).reshape(shape)


def shuffle_bits(key, n):
    """``n`` 32-bit random draws (int64 in ``[0, 2^32)``) under ``key``: the
    draws of one segmented shuffle, on the key's device."""
    return _philox.bits(key, _philox.STREAM_SHUFFLE, n)


def rotation(key, nb):
    """The batch order of one epoch: ``(arange(nb) + r) % nb`` for a
    rotation ``r`` drawn under ``key``, on the key's device (the JAX
    package's ``jnp.roll`` by a drawn ``r``)."""
    r = _philox.below(_philox.bits(key, _philox.STREAM_ROTATION, 1), nb)
    return (torch.arange(nb, device=key.device) + r) % nb


def batch_seeds(key, nb):
    """The ``nb`` batch seeds (int32 in ``[0, 2^31)``) drawn under
    ``key``: the key of the kernel's draws in each batch."""
    return (_philox.bits(key, _philox.STREAM_SEEDS, nb) >> 1).to(torch.int32)


def shuffle_rnd_bits(num_users, num_items, ub=None):
    """The low key bits a segmented shuffle gives its random draw: what the
    group ids of the layout leave of 31."""
    NBLK = item_pad(num_items) // block_size(num_items)
    NG = num_user_blocks(num_users, ub) * NBLK
    return 31 - int(NG + 1).bit_length()


def group_keys(group, rnd_bits, rnd):
    """Segmented-shuffle sort keys: the group id in the high bits, the top
    ``rnd_bits`` of each 32-bit draw of ``rnd`` in the low bits
    (`rankfm_tpu/ops/fused.py:1310-1313`)."""
    return (group.to(rnd.device, torch.int64) << rnd_bits) | (
        rnd.to(torch.int64) >> (32 - rnd_bits))


def shuffle_keys(group, rnd_bits, key):
    """One epoch's segmented-shuffle sort keys, drawn under ``key``."""
    return group_keys(group, rnd_bits, shuffle_bits(key, group.shape[0]))


def make_shuffle_fn(num_users, num_items, ub=None):
    """``shuffle(rec, group, rnd) -> rec_s``: the segmented shuffle an
    epoch sorts by, standalone (`rankfm_tpu.ops.fused.make_shuffle_fn`), so
    that a fit can build ``shuffle_layouts`` pre-shuffled layouts once and
    cycle them over its epochs. ``rnd`` holds the 32-bit draws
    (`shuffle_bits`), one per record; ``rec_s`` is on ``rec``'s device. A
    stable sort: records of equal keys keep their fit-time order."""
    rnd_bits = shuffle_rnd_bits(num_users, num_items, ub)

    def shuffle(rec, group, rnd):
        keys = group_keys(group, rnd_bits, rnd).to(rec.device)
        return rec[torch.sort(keys, stable=True).indices]

    return shuffle


def sync_group_size(sync_every, nb):
    """The largest divisor of the batch count ``nb`` not above
    ``sync_every`` (at least 1): the batches each replica of a data-parallel
    epoch runs between two merges (`rankfm_tpu/ops/fused.py:1407`)."""
    return max(d for d in range(1, max(1, min(sync_every, nb)) + 1)
               if nb % d == 0)


def split_layout_for_mesh(cids, ublk, iblk, n_dev):
    """Deal each batch's ``nT`` chunks of a `make_records_grouped` visit
    order to ``n_dev`` ranks, contiguously (``nTd = nT // n_dev`` apiece),
    as `rankfm_tpu/ops/fused.py:1449-1469` does: device-major ``[n_dev *
    nb, nTd]`` tensors, rank ``d``'s share of every batch in rows ``[d*nb,
    (d+1)*nb)``."""
    nb, nT = cids.shape
    assert nT % n_dev == 0, (nT, n_dev)
    nTd = nT // n_dev

    def split(a):
        return (torch.as_tensor(a).reshape(nb, n_dev, nTd).transpose(0, 1)
                .reshape(n_dev * nb, nTd).contiguous())

    return split(cids), split(ublk), split(iblk)


def fused_epoch(tab_u, tab_i, packed, layout, eta, alpha, seed, epoch, *,
                num_users, num_items, factors, max_samples, batch_size,
                chunk, ub, n_windows=None, x_uf=None, x_if=None,
                tab_uf=None, tab_if=None, beta=0.0, pre_shuffled=False):
    """One epoch of the fused engine (`_epoch_body`,
    `rankfm_tpu/ops/fused.py:1273-1342`): one segmented-shuffle sort, a
    rotation of the batch order, per-batch seeds and per-chunk window
    draws, then `fused_batch` for each batch in order.

    ``layout`` is `make_records_grouped`'s tuple of tensors (on the
    tables' device for a CUDA graph to capture the epoch; others are
    copied there). Every draw is a function of ``(seed, epoch)`` computed
    on the device (`epoch_key`: the shuffle, the rotation, the batch seeds,
    the window blocks), and ``epoch`` and ``eta`` may be 0-dim tensors on
    the device: nothing of the epoch is read back on the host, so a CUDA
    graph can capture it (`ops.graph`). ``pre_shuffled``: ``rec`` is
    already shuffled (one of the fit's ``shuffle_layouts``,
    `make_shuffle_fn`) and the epoch does not sort; every other draw is the
    sorting epoch's, and only the row order differs. Side features come as
    in `fused_batch_reference` (``x_uf`` padded to the user table's rows,
    ``x_if`` to the item table's), with ``beta`` their L2 rate. Updates the
    tables in place; returns the epoch log-likelihood (0-dim f32 on the
    device)."""
    return dp_fused_epoch(
        tab_u, tab_i, packed, layout, eta, alpha, seed, epoch, mesh=None,
        num_users=num_users, num_items=num_items, factors=factors,
        max_samples=max_samples, batch_size=batch_size, chunk=chunk, ub=ub,
        n_windows=n_windows, x_uf=x_uf, x_if=x_if, tab_uf=tab_uf,
        tab_if=tab_if, beta=beta, pre_shuffled=pre_shuffled)


def dp_fused_epoch(tab_u, tab_i, packed, layout, eta, alpha, seed, epoch, *,
                   mesh, num_users, num_items, factors, max_samples,
                   batch_size, chunk, ub, n_windows=None, sync_every=1,
                   x_uf=None, x_if=None, tab_uf=None, tab_if=None, beta=0.0,
                   batch_fn=None, pre_shuffled=False):
    """One data-parallel epoch of the fused engine on this rank of
    ``mesh`` (`_dp_epoch_body`, `rankfm_tpu/ops/fused.py:1345-1446`).

    Every rank holds the whole tables and the whole record array.
    ``layout``'s ``cids``/``ublk``/``iblk`` are `split_layout_for_mesh`'s
    device-major split; this rank visits its share of every global batch
    (``batch_size`` rows, ``batch_size / mesh.size`` on each rank). The
    shuffle and the batch rotation are drawn under the epoch's key and so
    shared by every rank; the batch seeds and the window blocks under this
    rank's key (``epoch_key(seed, epoch, rank)``; rank 0's is the epoch's
    own). After every group of `sync_group_size` batches one all-reduce
    sums the ranks' f32 deltas to ``tab_u``, ``tab_i`` and the feature
    tables against the group's start; the epoch log-likelihood is summed
    over the ranks at the end. ``mesh=None`` is one device (`fused_epoch`),
    and so is a one-rank mesh, bit for bit. ``pre_shuffled``, ``epoch``
    and ``eta`` as in `fused_epoch`.

    ``batch_fn`` replaces `fused_batch` (same signature); tests count
    visits with it."""
    if batch_fn is None:
        batch_fn = fused_batch
    rec, group, cids, ublk, iblk = layout
    dev = tab_u.device
    n_dev = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    NBLK = item_pad(num_items) // block_size(num_items)
    rnd_bits = shuffle_rnd_bits(num_users, num_items, ub)
    NW = default_n_windows(NBLK) if n_windows is None else n_windows
    nb = cids.shape[0] // n_dev
    cids, ublk, iblk = (a[rank * nb:(rank + 1) * nb].to(dev)
                        for a in (cids, ublk, iblk))
    nT = cids.shape[1]
    UB = user_block(num_users, ub)
    # every draw is a function of (seed, epoch, rank) on the device: the
    # shuffle and the rotation from the epoch's key, shared by the ranks,
    # the seeds and the window blocks from this rank's (rank 0's is the
    # epoch's own)
    key = epoch_key(seed, epoch, device=dev)
    rkey = key if rank == 0 else epoch_key(seed, epoch, rank, device=dev)
    if pre_shuffled:
        rec_s = rec
    else:
        keys = shuffle_keys(group.to(dev), rnd_bits, key)
        rec_s = rec[torch.sort(keys, stable=True).indices]
    order = rotation(key, nb)
    seeds = batch_seeds(rkey, nb)
    blks = draw_window_blocks(rkey, (nb, nT, NW), num_items)
    ublk_d, iblk_d = ublk[order], iblk[order]
    chunks = rec_s.view(-1, chunk, 2)
    idx = cids[order].long()
    # [eta, eta*2*alpha, eta*2*beta] in f32 (`rankfm_tpu/ops/fused.py:
    # 1322-1326`), on the device: the kernel reads them there
    eta = device_scalar(eta, torch.float32, dev)
    scal = torch.stack([eta] + [
        eta * float(np.float32(2.0) * np.float32(r)) for r in (alpha, beta)])
    k = sync_group_size(sync_every, nb)
    tables = [t for t in (tab_u, tab_i, tab_uf, tab_if) if t is not None]
    ll = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(nb):
        if n_dev > 1 and b % k == 0:
            snap = [t.clone() for t in tables]
        ll = ll + batch_fn(
            tab_u, tab_i, chunks[idx[b]].reshape(-1, 2), packed, blks[b],
            ublk_d[b], iblk_d[b], seeds[b], scal[0], scal[1:],
            factors=factors, max_samples=max_samples,
            ub_rows=UB, num_items=num_items, x_uf=x_uf, x_if=x_if,
            tab_uf=tab_uf, tab_if=tab_if)
        if n_dev > 1 and b % k == k - 1:
            mesh.merge_deltas(tables, snap)
    if n_dev > 1:
        mesh.all_reduce(ll.reshape(1), tag="epoch_ll")
    return ll
