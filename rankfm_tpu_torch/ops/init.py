"""Initial factor tables drawn on the card, numpy's draw bit for bit.

`RankFM._init_weights` draws ``v_u`` and then ``v_i`` as
``np.random.default_rng(seed).normal(0, sigma, shape).astype(np.float32)``,
the JAX package's tables, which the tests hold the port's fits against.
`normal_pair` makes the same two float32 tables on a CUDA device from the
generator's PCG64 state, and leaves the generator where numpy's two calls
would, so the feature tables drawn after it are unchanged too:

1. the card computes each stream position's one-word ziggurat attempt
   (``csrc/pcg_normal.cu``: `scan_kernel`, `compact_kernel`) and hands the
   host the ~1.5% of positions one word does not decide, with the next two
   words of each;
2. the host walks those in stream order with numpy's own arithmetic
   (`rankfm_tpu_torch.native.normal_walk`): which positions start an
   attempt, which are accepted, the values of the wedge and tail attempts;
3. the card writes every one-word emit at its rank (`emit_kernel`); the
   walk's values are put at theirs.

The range drawn is `n_positions` of the draws: far more than the draws
need (numpy reads ~1.0222 words a normal), so a range whose emits fall
short raises, as a failed build does; nothing is drawn on another path.
A CPU model keeps numpy's draw; `normal_pair` takes CUDA devices alone.
"""

from __future__ import annotations

from collections import Counter

import numpy as np
import torch

from rankfm_tpu_torch import native
from rankfm_tpu_torch.ops.scatter import _current_stream

# 32-position mask words a segment (one warp on the card) covers
SEG_WORDS = 64
# raw words drawn a normal (numpy consumes ~1.0222) and a margin: the range
# of positions the card scans
WORDS_PER_DRAW, MARGIN = 1.03, 4096
_M64 = (1 << 64) - 1

# tables drawn, keyed by ``(path, table)`` with path 'card' or 'host'
DRAWS = Counter()
# kernel launches, keyed by 'scan', 'compact', 'emit'
LAUNCHES = Counter()
# attempts the walk resolved ('wedge', 'tail'), and the raw words of the
# draws ('words'): the share of the stream that took more than one word
SLOW = Counter()


def n_positions(n_draws):
    """The stream positions scanned for ``n_draws`` normals."""
    return int(n_draws * WORDS_PER_DRAW) + MARGIN


def _halves(state, inc):
    return state >> 64, state & _M64, inc >> 64, inc & _M64


def _lib():
    from rankfm_tpu_torch.ops import _build
    return _build.load("pcg_normal")


def _raise(err, what):
    from rankfm_tpu_torch.ops import _build
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                       f"({_build.error_string(err, 'pcg_normal')})")


def _scan_card(halves, n_pos, dev):
    """Stage 1 on the card: the one-word mask (a device tensor) and the
    records on the host."""
    lib, stream = _lib(), _current_stream(dev)
    nw = -(-n_pos // 32)
    mask = torch.empty(nw, dtype=torch.int32, device=dev)
    cnt = torch.empty(-(-nw // SEG_WORDS), dtype=torch.int32, device=dev)
    err = lib.rfm_pcg_scan(*halves, n_pos, SEG_WORDS, mask.data_ptr(),
                           cnt.data_ptr(), stream)
    if err:
        _raise(err, "pcg_scan")
    LAUNCHES["scan"] += 1
    off = torch.cumsum(cnt, 0, dtype=torch.int64)
    m = int(off[-1])
    rec = torch.empty((m, 4), dtype=torch.int64, device=dev)
    if m:
        err = lib.rfm_pcg_compact(*halves, n_pos, SEG_WORDS, mask.data_ptr(),
                                  (off - cnt).data_ptr(), rec.data_ptr(),
                                  stream)
        if err:
            _raise(err, "pcg_compact")
        LAUNCHES["compact"] += 1
    return mask, rec.cpu().numpy()


def _put(out0, out1, idx, val):
    """``val`` at ranks ``idx`` (ascending) of the two tables."""
    k = int(np.searchsorted(idx, out0.shape[0]))
    dev = out0.device
    for out, i, v in ((out0, idx[:k], val[:k]),
                      (out1, idx[k:] - out0.shape[0], val[k:])):
        if len(i):
            out[torch.from_numpy(i).to(dev)] = torch.from_numpy(v).to(dev)


def walk(rec, mask, n_pos, n_draws, sigma, state, inc):
    """`native.normal_walk` over the first stage's records and mask
    (turned into the emit mask in place); raises RuntimeError when the
    ``n_pos`` positions hold fewer than ``n_draws`` emits."""
    base, idx, val, w = native.normal_walk(rec, mask, n_pos, n_draws, sigma,
                                           state, inc, SEG_WORDS)
    if w["emitted"] < n_draws:
        raise RuntimeError(
            f"normal draw: {n_pos} stream positions hold {w['emitted']} of "
            f"the {n_draws} draws")
    return base, idx, val, w


def normal_pair(bit_generator, sigma, n0, n1, device):
    """``Generator(bit_generator).normal(0, sigma, n0)`` and then ``(...,
    n1)``, cast to float32, as two flat tensors on the CUDA ``device``;
    advances ``bit_generator`` (a PCG64) by the words the two draws
    consume."""
    st = bit_generator.state
    if st["bit_generator"] != "PCG64":
        raise ValueError(f"normal_pair: needs a PCG64, got "
                         f"{st['bit_generator']}")
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"normal_pair: draws on a CUDA device, not {dev}")
    s0, inc = st["state"]["state"], st["state"]["inc"]
    out0 = torch.empty(n0, dtype=torch.float32, device=dev)
    out1 = torch.empty(n1, dtype=torch.float32, device=dev)
    T = n0 + n1
    if T == 0:
        return out0, out1
    dev = out0.device
    N = n_positions(T)
    halves = _halves(s0, inc)
    with torch.cuda.device(dev):
        mask_dev, rec = _scan_card(halves, N, dev)
        mask = mask_dev.cpu().numpy().view(np.uint32)
        base, idx, val, w = walk(rec, mask, N, T, sigma, s0, inc)
        mask_dev.copy_(torch.from_numpy(mask.view(np.int32)))
        base_dev = torch.from_numpy(base).to(dev)
        err = _lib().rfm_pcg_emit(
            *halves, N, SEG_WORDS, mask_dev.data_ptr(), base_dev.data_ptr(),
            T, n0, sigma, out0.data_ptr(), out1.data_ptr(),
            _current_stream(dev))
        if err:
            _raise(err, "pcg_emit")
        LAUNCHES["emit"] += 1
        _put(out0, out1, idx, val)
    bit_generator.advance(w["words"])
    SLOW["wedge"] += w["wedge"]
    SLOW["tail"] += w["tail"]
    SLOW["words"] += w["words"]
    return out0, out1
