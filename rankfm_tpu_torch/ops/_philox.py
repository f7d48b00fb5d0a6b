"""Counter-based random numbers for the fused chunk step.

The TPU kernel seeds its hardware generator per chunk
(`pltpu.prng_seed(seed + k)`, `rankfm_tpu/ops/fused.py:618`) and draws a
``[C, NW*BLK]`` uniform matrix plus one geometric draw per row. A CUDA
block has no such generator, so the port draws from Philox4x32-10
(Salmon et al., "Parallel random numbers: as easy as 1, 2, 3", SC 2011),
a pure function of a 128-bit counter and a 64-bit key:

    key     = (batch seed, 0)
    counter = (slot, row, chunk index within the batch, stream)

with stream 0 for the slot uniforms ``u01`` and stream 1 for the per-row
``r1``. The CUDA kernel (``csrc/fused_chunk.cu``) and this twin compute the
same bits, so the plain version and the kernel see the same draws. A draw
is the first output word's top 24 bits scaled to ``[0, 1)``, exact in f32.

The twin runs in int64 tensor ops on any device. A 32 x 32-bit product can
reach 2^64 and would overflow int64, so `_mulhilo` splits the multiplier
into 16-bit halves; every intermediate stays below 2^49.
"""

from __future__ import annotations

import torch

_M0, _M1 = 0xD2511F53, 0xCD9E8D57
_W0, _W1 = 0x9E3779B9, 0xBB67AE85
_MASK = 0xFFFFFFFF
STREAM_U01, STREAM_R1 = 0, 1


def _mulhilo(a, m):
    """(hi, lo) 32-bit words of ``a * m`` for int64 ``a`` in [0, 2^32)."""
    p_lo = a * (m & 0xFFFF)                     # < 2^48
    p_hi = a * (m >> 16)                        # < 2^48
    hi = (p_hi + (p_lo >> 16)) >> 16
    lo = (((p_hi & 0xFFFF) << 16) + p_lo) & _MASK
    return hi, lo


def philox4x32(c0, c1, c2, c3, k0, k1=0):
    """Philox4x32-10 on int64 tensors (or ints) holding 32-bit words.

    Returns the four output words as int64 tensors in [0, 2^32)."""
    k0, k1 = int(k0) & _MASK, int(k1) & _MASK
    for r in range(10):
        if r:
            k0, k1 = (k0 + _W0) & _MASK, (k1 + _W1) & _MASK
        hi0, lo0 = _mulhilo(c0, _M0)
        hi1, lo1 = _mulhilo(c2, _M1)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def uniform(seed, chunk, row, slot, stream):
    """f32 draws in [0, 1) for broadcastable int64 ``chunk/row/slot``."""
    x = philox4x32(slot, row, chunk, stream, seed)[0]
    return (x >> 8).to(torch.float32) * (2.0 ** -24)


def chunk_draws(seed, chunk, C, W2, device=None):
    """``(u01 [C, W2], r1 [C])`` of one chunk, as the kernel draws them."""
    row = torch.arange(C, dtype=torch.int64, device=device)
    slot = torch.arange(W2, dtype=torch.int64, device=device)
    k = torch.tensor(int(chunk), dtype=torch.int64, device=device)
    u01 = uniform(seed, k, row[:, None], slot[None, :], STREAM_U01)
    r1 = uniform(seed, k, row, torch.zeros_like(row), STREAM_R1)
    return u01, r1
