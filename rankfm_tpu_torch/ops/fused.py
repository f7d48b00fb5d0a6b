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
* each epoch re-randomizes rows within their group with one single-key
  sort, rotates the batch order, and draws one size-weighted window block
  per chunk (`fused_epoch`).

The chunk step is `fused_batch`: on CUDA tensors it launches the Hopper
kernel of ``csrc/fused_chunk.cu``; on CPU tensors it runs the plain
version `fused_batch_reference`. Both apply the chunks of a batch strictly
in order with the semantics of the TPU kernel's `_sub_round`
(`rankfm_tpu/ops/fused.py:611-971`, featureless, f32 tables): gradients
read at chunk start, then the user block, the positive block and each
window block decayed and updated in that order.

What the port drops, because it carries no semantics: the 128-lane tables
(tables here are ``[rows, F+2]``: factors, then col F = 1 on the user side
and the item bias on the item side, col F+1 = 0 at rest), the lane-padded
window columns (the kernel reads the ``[U, NBLK*BLK/16]`` pack directly),
the 8-bit bf16 membership planes, the bf16 MXU casts, SUB sub-rounds and
revolving DMAs. Random draws come from a counter-based Philox stream
(`_philox`) instead of the TPU's hardware generator.
"""

from __future__ import annotations

import math
from collections import Counter

import numpy as np
import torch

from rankfm_tpu_torch.ops import _philox
from rankfm_tpu_torch.ops.scatter import decay_rows

LANES = 128          # TPU lane width: only the eligibility rule reads it
BITS_PER_LANE = 16
MARGIN = 1.0
MAX_BLK = 1024
UBLK = 1024          # default user-bucket cap; see pick_user_block
# catalogs beyond this many window blocks leave the fused engine
FUSED_NBLK_CAP = 64

# kernel launches of `fused_batch`, keyed by (chunk rows, user block rows):
# one count per batch whose chunks went through the CUDA kernel
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


def _chunk_reference(tab_u, tab_i, rec, packed, blks, ubase, ibase, u01, r1,
                     eta, dreg, F, M, BLK, UB, num_items):
    """One chunk, in place on the tables. Returns the per-row ll terms,
    each row's lowest chosen window slot (-1: none) and the key matrix."""
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
    ut_ui = (u_rows * i_rows).sum(1)
    pw = ut_ui[:, None] - u_rows @ tw.T                     # [C, W2]
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
    pw_sel = ut_ui - (u_rows * j_rows).sum(1)
    gate = valid * has_j
    d = gate * sw * mult * torch.sigmoid(-pw_sel)
    ll = torch.where(gate > 0, torch.nn.functional.logsigmoid(pw_sel),
                     torch.zeros_like(pw_sel))
    chosen = torch.where(gate > 0, key.argmax(1), -1).to(torch.int32)

    # gradient rows + per-row touch counts (valid rows only)
    D = tab_u.shape[1]
    g_u = d[:, None] * (i_rows - j_rows)
    acc_u = torch.zeros((UB, D), device=dev).index_add_(
        0, u_loc[ok].long(), g_u[ok])
    cnt_u = torch.zeros(UB, device=dev).index_add_(0, u_loc[ok].long(),
                                                   valid[ok])
    g_ip = d[:, None] * u_rows                    # col F = d: the bias grad
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
    c = float(np.maximum(np.float32(1.0) - np.float32(dreg), np.float32(1e-8)))
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
    return ll, chosen, key


def fused_batch_reference(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed,
                          eta, dreg, *, factors, max_samples, ub_rows,
                          num_items, chosen=None, keys=None):
    """Plain PyTorch version of one batch of the fused kernel.

    ``rec [nT*C, 2]`` int32 records in visit order, ``packed [U, W]``
    int32 history pack, ``blk [nT, NW]``, ``ublk [nT]``, ``iblk [nT]`` int32
    block ids, ``ub_rows`` the user block's rows (`user_block`), ``seed``
    the batch seed, ``dreg = eta * 2 * alpha``. Updates
    ``tab_u``/``tab_i`` IN PLACE, chunk after chunk, and returns the
    batch's log-likelihood (0-dim f32). The random draws are the kernel's
    Philox stream (`_philox.chunk_draws`).

    Optional diagnostics: ``chosen [nT*C]`` int32 receives each row's
    lowest chosen window slot (-1: none), and the list ``keys`` each
    chunk's ``[C, NW*BLK]`` selection keys.
    """
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
            eta, dreg, factors, max_samples, BLK, ub_rows, num_items)
        lls.append(ll)
        if chosen is not None:
            chosen[k * C:(k + 1) * C] = j
        if keys is not None:
            keys.append(key)
    return torch.cat(lls).sum()


def fused_batch(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg,
                *, factors, max_samples, ub_rows, num_items, chosen=None):
    """One batch of the fused WARP/BPR step (see `fused_batch_reference`
    for the arguments). CUDA tensors go through the Hopper kernel; CPU
    tensors through the plain version. Updates the tables in place and
    returns the batch log-likelihood."""
    if tab_u.device.type == "cpu":
        return fused_batch_reference(
            tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg,
            factors=factors, max_samples=max_samples, ub_rows=ub_rows,
            num_items=num_items, chosen=chosen)
    if tab_u.device.type != "cuda":
        raise ValueError(f"fused_batch runs on cuda or cpu, not {tab_u.device}")
    return _launch(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta,
                   dreg, factors, max_samples, ub_rows, num_items, chosen)


def _check(name, t, dtype, device, ndim):
    if t.dtype != dtype or t.device != device or t.dim() != ndim \
            or not t.is_contiguous():
        raise ValueError(
            f"fused_batch: {name} must be a contiguous {ndim}-d {dtype} "
            f"tensor on {device}, got {t.dtype} {tuple(t.shape)} on "
            f"{t.device} (contiguous={t.is_contiguous()})")


def _launch(tab_u, tab_i, rec, packed, blk, ublk, iblk, seed, eta, dreg,
            F, M, UB, num_items, chosen):
    from rankfm_tpu_torch.ops import _build

    dev = tab_u.device
    for name, t, dt, nd in (("tab_u", tab_u, torch.float32, 2),
                            ("tab_i", tab_i, torch.float32, 2),
                            ("rec", rec, torch.int32, 2),
                            ("packed", packed, torch.int32, 2),
                            ("blk", blk, torch.int32, 2),
                            ("ublk", ublk, torch.int32, 1),
                            ("iblk", iblk, torch.int32, 1),
                            ("chosen", chosen, torch.int32, 1)):
        if t is not None or name != "chosen":
            _check(name, t, dt, dev, nd)
    nT, NW = blk.shape
    BLK = block_size(num_items)
    D = F + 2
    C = rec.shape[0] // nT
    if (tab_u.shape[1] != D or tab_i.shape[1] != D or rec.shape[1] != 2
            or rec.shape[0] != nT * C or ublk.shape[0] != nT
            or iblk.shape[0] != nT
            or packed.shape[1] != item_pad(num_items) // BITS_PER_LANE
            or tab_i.shape[0] != item_pad(num_items)
            or tab_u.shape[0] % UB or UB > UBLK
            or (chosen is not None and chosen.shape != (nT * C,))):
        raise ValueError(
            f"fused_batch: inconsistent shapes tab_u={tuple(tab_u.shape)} "
            f"tab_i={tuple(tab_i.shape)} rec={tuple(rec.shape)} "
            f"packed={tuple(packed.shape)} blk={tuple(blk.shape)} "
            f"F={F} UB={UB} num_items={num_items}")
    acc = torch.zeros((UB + (1 + NW) * BLK) * D, dtype=torch.float32,
                      device=dev)
    ll_rows = torch.empty(nT * C, dtype=torch.float32, device=dev)
    log_I = math.log(num_items) if num_items > 1 else 1.0
    err = _build.load().rfm_fused_batch(
        tab_u.data_ptr(), tab_i.data_ptr(), D, F,
        rec.data_ptr(), packed.data_ptr(), packed.shape[1],
        blk.data_ptr(), ublk.data_ptr(), iblk.data_ptr(),
        acc.data_ptr(), ll_rows.data_ptr(),
        None if chosen is None else chosen.data_ptr(),
        nT, C, UB, BLK, NW, M, float(num_items - 1), log_I,
        math.log(max(num_items - 1, 1)) / log_I,
        int(seed) & 0xFFFFFFFF, float(eta), float(dreg),
        torch.cuda.current_stream(dev).cuda_stream)
    if err:
        raise RuntimeError(f"fused chunk kernel launch failed: CUDA error "
                           f"{err} ({_build.error_string(err)})")
    LAUNCHES[(C, UB)] += 1
    return ll_rows.sum()


# ---------------------------------------------------------------------------
# one epoch
# ---------------------------------------------------------------------------

def epoch_generator(seed, epoch):
    """The CPU generator of one epoch's draws, keyed by (seed, epoch): the
    JAX package's ``fold_in(PRNGKey(seed), epoch)``."""
    state = np.random.SeedSequence([int(seed), int(epoch)]).generate_state(
        1, np.uint64)[0]
    return torch.Generator().manual_seed(int(state) & (2**63 - 1))


def draw_window_blocks(gen, shape, num_items):
    """int32 window-block ids of ``shape``, catalog-size-weighted, on the
    generator's device."""
    real_cum = torch.as_tensor(window_block_cdf(num_items), dtype=torch.float32,
                               device=gen.device)
    x = torch.rand(shape, generator=gen, device=gen.device) * float(num_items)
    return torch.searchsorted(real_cum, x, right=True).to(torch.int32)


def shuffle_keys(group, rnd_bits, gen):
    """One epoch's segmented-shuffle sort keys: the group id in the high
    bits, the top ``rnd_bits`` of a 32-bit random draw in the low bits
    (`rankfm_tpu/ops/fused.py:1310-1313`)."""
    rnd = torch.randint(0, 2**32, group.shape, generator=gen,
                        dtype=torch.int64)
    return (group.to(torch.int64) << rnd_bits) | (rnd >> (32 - rnd_bits))


def fused_epoch(tab_u, tab_i, packed, layout, eta, alpha, seed, epoch, *,
                num_users, num_items, factors, max_samples, batch_size,
                chunk, ub, n_windows=None):
    """One epoch of the fused engine (`_epoch_body`,
    `rankfm_tpu/ops/fused.py:1273-1342`): one segmented-shuffle sort, a
    rotation of the batch order, per-batch seeds and per-chunk window
    draws, then `fused_batch` for each batch in order.

    ``layout`` is `make_records_grouped`'s tuple with ``rec`` on the
    tables' device and the rest as CPU tensors. Updates the tables in
    place; returns the epoch log-likelihood (0-dim f32 on the device)."""
    rec, group, cids, ublk, iblk = layout
    dev = tab_u.device
    NBLK = item_pad(num_items) // block_size(num_items)
    NG = num_user_blocks(num_users, ub) * NBLK
    rnd_bits = 31 - int(NG + 1).bit_length()
    NW = default_n_windows(NBLK) if n_windows is None else n_windows
    nb, nT = cids.shape
    UB = user_block(num_users, ub)
    gen = epoch_generator(seed, epoch)

    keys = shuffle_keys(group, rnd_bits, gen).to(dev)
    rec_s = rec[torch.sort(keys, stable=True).indices]
    r = int(torch.randint(0, nb, (), generator=gen))
    cids_b, ublk_b, iblk_b = (torch.roll(a, r, 0) for a in (cids, ublk, iblk))
    seeds = torch.randint(0, 2**31 - 1, (nb,), generator=gen).tolist()
    blks = draw_window_blocks(gen, (nb, nT, NW), num_items).to(dev)
    ublk_d, iblk_d = ublk_b.to(dev), iblk_b.to(dev)
    chunks = rec_s.view(-1, chunk, 2)
    idx = cids_b.to(dev).long()
    dreg = np.float32(eta) * np.float32(2.0 * np.float32(alpha))
    ll = torch.zeros((), dtype=torch.float32, device=dev)
    for b in range(nb):
        ll = ll + fused_batch(
            tab_u, tab_i, chunks[idx[b]].reshape(-1, 2), packed, blks[b],
            ublk_d[b], iblk_d[b], seeds[b], float(np.float32(eta)),
            float(dreg), factors=factors, max_samples=max_samples,
            ub_rows=UB, num_items=num_items)
    return ll
