"""Counter-based random numbers: every draw of the port.

The JAX package draws from counter-based keys on the device: the fused
epoch folds the epoch into the fit's key and splits it for the shuffle,
the rotation, the batch seeds and the window blocks
(`rankfm_tpu/ops/fused.py:1273-1342`), the XLA epoch folds each batch
index into its sampling key (`rankfm_tpu/ops/training.py:556-591`), and
the TPU kernel seeds its hardware generator per chunk
(`pltpu.prng_seed(seed + k)`, `rankfm_tpu/ops/fused.py:618`). The port
draws all of these from Philox4x32-10 (Salmon et al., "Parallel random
numbers: as easy as 1, 2, 3", SC 2011), a pure function of a 128-bit
counter and a 64-bit key, so a draw is a function of ``(seed, epoch,
stream, counter)`` alone: equal on the CPU and on the card, equal in an
eager epoch and in the CUDA graph that replays it, and computed where it
is used, with no host round trip.

* A **key** is a 0-dim int64 tensor holding the 64-bit Philox key (low
  word ``k0``, high word ``k1``). `epoch_key` makes one epoch's key from
  ``(seed, epoch, rank)`` (rank 0 is the single device's), `layout_key`
  the key of a pre-shuffled layout, `fold` a key per batch.
* A **stream** names what the draws are for, as the counter's last word;
  two streams of one key never share a counter.
* Inside the fused kernel (``csrc/fused_chunk.cu``) the key is the batch
  seed and the counter ``(slot, row, chunk, stream)``, stream
  `STREAM_U01` for the slot uniforms and `STREAM_R1` for the per-row
  ``r1``; `chunk_draws` computes the same bits here, so the plain version
  and the kernel see the same draws.

A 24-bit draw is the word's top 24 bits scaled to ``[0, 1)``, exact in f32.

This runs in int64 tensor ops on any device. A 32 x 32-bit product can
reach 2^64: int64 tensor products wrap modulo 2^64 (two's complement) on
the CPU and on CUDA, so the product's bit pattern is exact and
`philox4x32` takes its two 32-bit halves out of it (the known-answer tests
with all-ones inputs pin this).
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF

# what a draw is for: the counter's last word
STREAM_U01, STREAM_R1 = 0, 1          # inside the fused kernel
STREAM_SHUFFLE = 2                    # the segmented shuffle's 32-bit draws
STREAM_ROTATION = 3                   # the batch order's rotation
STREAM_SEEDS = 4                      # the fused batches' seeds
STREAM_BLOCKS = 5                     # the fused chunks' window blocks
STREAM_PERM = 6                       # the XLA epoch's permutation
STREAM_STEP = 7                       # the XLA steps' draws
STREAM_KEY = 8                        # keys made from keys


def philox4x32(c0, c1, c2, c3, k0, k1=0):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words; the
    key words ``k0``/``k1`` may be ints or int64 tensors that broadcast
    against the counters.

    Returns the four output words as int64 tensors in [0, 2^32).

    A round multiplies ``c0`` and ``c2``, which must be exact 32-bit words,
    and only XORs ``c1`` and ``c3``: so the products are kept whole as the
    next ``c1``/``c3`` (their low 32 bits are the ``lo`` words), the high
    words are taken with an arithmetic shift (their low 32 bits are right),
    and only the two words about to be multiplied are masked, ten
    elementwise operations a round."""
    ks0, ks1 = _round_keys(k0, _W0), _round_keys(k1, _W1)
    c0, c2 = c0 & _MASK, c2 & _MASK
    for r in range(10):
        p0 = c0 * _M0                           # wraps modulo 2^64
        p1 = c2 * _M1
        c0 = ((p1 >> 32) ^ c1 ^ ks0[r]) & _MASK
        c2 = ((p0 >> 32) ^ c3 ^ ks1[r]) & _MASK
        c1, c3 = p1, p0
    return c0, c1 & _MASK, c2, c3 & _MASK


def _round_keys(k, w):
    """The ten round keys ``(k + r*w) mod 2^32`` of a key word (an int, or
    an int64 tensor: then all ten in one pass, so a key on the device costs
    a few launches and not forty)."""
    if isinstance(k, torch.Tensor):
        r = torch.arange(10, dtype=torch.int64, device=k.device) * w
        ks = ((k & _MASK).unsqueeze(-1) + r) & _MASK
        return ks.unbind(-1)
    return [((k & _MASK) + r * w) & _MASK for r in range(10)]


def key_words(key):
    """``(k0, k1)``: the 32-bit words of a key (a 0-dim int64 tensor, or
    an ``[n]`` one of keys)."""
    return key & _MASK, (key >> 32) & _MASK


def _join(lo, hi):
    """The 64-bit key of two 32-bit words (int64, two's complement)."""
    return lo | (hi << 32)


def epoch_key(seed, epoch, rank=0, device=None):
    """The key of one epoch's draws: a 0-dim int64 tensor on ``device``,
    the counterpart of the JAX package's ``fold_in(PRNGKey(seed), epoch)``
    (and, for ``rank > 0``, of its ``fold_in(key, device)`` on a mesh).
    Rank 0 is the single device's key, so a one-rank mesh draws what one
    device draws. ``epoch`` (and ``rank``) may be ints or int64 tensors:
    a CUDA graph reads the epoch from a buffer it was captured with."""
    seed = int(seed)
    if not isinstance(epoch, torch.Tensor):
        epoch = torch.tensor(int(epoch), dtype=torch.int64, device=device)
    w = philox4x32(epoch & _MASK, rank, 0, STREAM_KEY, seed & _MASK,
                   (seed >> 32) & _MASK)
    return _join(w[0], w[1])


def layout_key(seed, r, device=None):
    """The key of pre-shuffled layout ``r`` of a fit: the JAX package's
    ``fold_in(fold_in(PRNGKey(seed), 2**31 - 7), r)``."""
    seed = int(seed)
    w = philox4x32(torch.tensor(int(r), dtype=torch.int64, device=device),
                   2**31 - 7, 1, STREAM_KEY, seed & _MASK,
                   (seed >> 32) & _MASK)
    return _join(w[0], w[1])


def fold(key, t):
    """One key per entry of the int64 tensor ``t`` (the JAX package's
    ``fold_in(key, t)``): ``[len(t)]`` int64, entry ``b`` a batch's key."""
    k0, k1 = key_words(key)
    w = philox4x32(t, 0, 2, STREAM_KEY, k0, k1)
    return _join(w[0], w[1])


# counters a CPU call of `bits` takes at a time: a cache-sized slice runs
# the thirty-odd passes of Philox several times faster than the whole array
_CPU_SLICE = 1 << 14


def bits(key, stream, n, device=None, c1=0):
    """``n`` 32-bit draws (int64 in ``[0, 2^32)``) of ``stream`` under
    ``key``: the four words of counters ``(m, c1, 0, stream)``, ``m =
    0..ceil(n/4)-1``, in order. The same bits on any device."""
    return bits_of(key, [(stream, n, c1)], device)[0]


def bits_of(key, parts, device=None):
    """`bits` of several ``(stream, n, c1)`` parts under one key, in one
    pass over all their counters (each part's draws are `bits`' own): one
    set of launches for the draws a step makes, where separate calls would
    each pay Philox's thirty-odd. The CPU takes the counters a cache-sized
    slice at a time."""
    k0, k1 = key_words(key)
    dev = key.device if device is None else torch.device(device)
    ms = [(n + 3) // 4 for _, n, _ in parts]

    def col(vals):
        if len(parts) == 1:
            return vals[0]
        return torch.cat([torch.full((m,), v, dtype=torch.int64, device=dev)
                          for m, v in zip(ms, vals)])

    m = torch.cat([torch.arange(m, dtype=torch.int64, device=dev)
                   for m in ms])
    c1, c3 = col([p[2] for p in parts]), col([p[0] for p in parts])
    step = _CPU_SLICE if dev.type == "cpu" else max(len(m), 1)

    def sl(c, i):
        return c[i:i + step] if isinstance(c, torch.Tensor) else c

    words = torch.cat([torch.stack(philox4x32(
        m[i:i + step], sl(c1, i), 0, sl(c3, i), k0, k1), 1)
        for i in range(0, max(len(m), 1), step)])
    out, at = [], 0
    for (_, n, _), mi in zip(parts, ms):
        out.append(words[at:at + mi].reshape(-1)[:n])
        at += mi
    return out


def to_unit(x):
    """f32 in [0, 1) from 32-bit draws: the top 24 bits, exact."""
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def below(x, n):
    """Integers in ``[0, n)`` from 32-bit draws: ``floor(x * n / 2^32)``,
    ``n <= 2^31``."""
    return (x * int(n)) >> 32


def uniform(seed, chunk, row, slot, stream):
    """f32 draws in [0, 1) for broadcastable int64 ``chunk/row/slot``, as
    the fused kernel draws them under the batch seed."""
    return to_unit(philox4x32(slot, row, chunk, stream, seed)[0])


def chunk_draws(seed, chunk, C, W2, device=None):
    """``(u01 [C, W2], r1 [C])`` of one chunk, as the kernel draws them.
    ``seed`` is an int or a 0-dim integer tensor."""
    row = torch.arange(C, dtype=torch.int64, device=device)
    slot = torch.arange(W2, dtype=torch.int64, device=device)
    k = torch.tensor(int(chunk), dtype=torch.int64, device=device)
    if isinstance(seed, torch.Tensor):
        seed = seed.to(device=device, dtype=torch.int64)
    u01 = uniform(seed, k, row[:, None], slot[None, :], STREAM_U01)
    r1 = uniform(seed, k, row, torch.zeros_like(row), STREAM_R1)
    return u01, r1
