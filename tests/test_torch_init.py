"""The initial tables' draw (`rankfm_tpu_torch.ops.init`) on the CPU: the
native walk (`init.walk`) behind numpy versions of the card's first and
third stages (`scan_plain`, `emit_plain`, over `PCG64.random_raw`), held
bit for bit to
``np.random.default_rng(seed).normal(0, sigma, shape).astype(np.float32)``,
``v_u`` then ``v_i`` from one stream, and the generator left where numpy's
two draws leave it. `init.normal_pair` itself draws on the card alone: its
tests are in `tests/test_torch_cuda.py`.
"""

import shutil
import subprocess

import numpy as np
import pandas as pd
import pytest
import torch

from rankfm_tpu_torch import RankFM, native
from rankfm_tpu_torch.ops import init


@pytest.fixture(scope="module")
def walk():
    try:
        return native.get_walk()
    except RuntimeError as e:
        pytest.skip(f"native toolchain unavailable: {e}")


_MASK52 = (1 << 52) - 1


def raw_words(state, inc, n):
    """The first ``n`` raw words of the PCG64 stream ``(state, inc)``."""
    bg = np.random.PCG64()
    bg.state = {"bit_generator": "PCG64",
                "state": {"state": state, "inc": inc},
                "has_uint32": 0, "uinteger": 0}
    return bg.random_raw(n)


def _one_word(r, ki):
    return ((r >> np.uint64(9)) & np.uint64(_MASK52)) < ki[r & np.uint64(0xff)]


def scan_plain(raw, n_pos):
    """`scan_kernel` and `compact_kernel` in numpy over ``raw`` (at least
    ``n_pos + 2`` words): the one-word mask (uint32) and the records
    ``{q, word q, word q + 1, word q + 2}`` (int64 ``[m, 4]``)."""
    ki, _, _ = native.ziggurat_tables()
    fast = _one_word(raw[:n_pos], ki)
    bits = np.zeros(-(-n_pos // 32) * 32, dtype=bool)
    bits[:n_pos] = fast
    mask = np.packbits(bits, bitorder="little").view("<u4").astype(np.uint32)
    q = np.flatnonzero(~fast)
    rec = np.stack([q.astype(np.uint64), raw[q], raw[q + 1], raw[q + 2]],
                   axis=1)
    return mask, rec.view(np.int64)


def emit_plain(raw, mask, base, n_draws, sigma):
    """`emit_kernel` in numpy: the ranks and values of the emits that one
    word decides, from the emit mask and its segment counts ``base``."""
    ki, wi, _ = native.ziggurat_tables()
    seg = init.SEG_WORDS * 32
    bits = np.unpackbits(mask.astype("<u4").view(np.uint8),
                         bitorder="little").astype(np.int64)
    bits = np.pad(bits, (0, len(base) * seg - len(bits))).reshape(-1, seg)
    rank = (base[:, None] + np.cumsum(bits, axis=1) - bits).ravel()
    p = np.flatnonzero(bits.ravel().astype(bool) & (rank < n_draws))
    r = raw[p]
    one = _one_word(r, ki)
    p, r = p[one], r[one]
    x = ((r >> np.uint64(9)) & np.uint64(_MASK52)).astype(np.float64) \
        * wi[r & np.uint64(0xff)]
    x = np.where((r >> np.uint64(8)) & np.uint64(1), -x, x)
    return rank[p], (0.0 + sigma * x).astype(np.float32)


def plain_pair(bit_generator, sigma, n0, n1, n_pos=None):
    """`init.normal_pair` with its two card stages in numpy: the same walk
    between them, the same counters, on the CPU."""
    st = bit_generator.state
    s0, inc = st["state"]["state"], st["state"]["inc"]
    out0 = torch.empty(n0, dtype=torch.float32)
    out1 = torch.empty(n1, dtype=torch.float32)
    T = n0 + n1
    if T == 0:
        return out0, out1
    N = init.n_positions(T) if n_pos is None else n_pos
    raw = raw_words(s0, inc, N + 2)
    mask, rec = scan_plain(raw, N)
    base, idx, val, w = init.walk(rec, mask, N, T, sigma, s0, inc)
    init._put(out0, out1, *emit_plain(raw, mask, base, T, sigma))
    init._put(out0, out1, idx, val)
    bit_generator.advance(w["words"])
    for k in ("wedge", "tail", "words"):
        init.SLOW[k] += w[k]
    return out0, out1


def _bits(a):
    a = a.numpy() if isinstance(a, torch.Tensor) else a
    return np.ascontiguousarray(a, dtype=np.float32).view(np.uint32).ravel()


def _check(rng, sigma, shapes, after=((21, 50), 0.5)):
    """Draw the two tables with `plain_pair` from ``rng`` and from a copy
    of its state with numpy; then one more table from each."""
    ref = np.random.Generator(np.random.PCG64())
    ref.bit_generator.state = rng.bit_generator.state
    (r0, f), (r1, _) = shapes
    a, b = plain_pair(rng.bit_generator, sigma, r0 * f, r1 * f)
    assert a.dtype == b.dtype == torch.float32
    assert a.shape == (r0 * f,) and b.shape == (r1 * f,)
    want_a = ref.normal(0, sigma, (r0, f)).astype(np.float32)
    want_b = ref.normal(0, sigma, (r1, f)).astype(np.float32)
    np.testing.assert_array_equal(_bits(a), _bits(want_a))
    np.testing.assert_array_equal(_bits(b), _bits(want_b))
    assert rng.bit_generator.state == ref.bit_generator.state
    shape, scale = after
    np.testing.assert_array_equal(
        _bits(rng.normal(0, scale, shape).astype(np.float32)),
        _bits(ref.normal(0, scale, shape).astype(np.float32)))


@pytest.mark.parametrize("seed", [0, 1492, 2**31 + 11])
@pytest.mark.parametrize("sigma", [0.1, 0.01])
@pytest.mark.parametrize("shapes", [((600, 20), (1500, 20)),
                                    ((1000, 64), (777, 64)),
                                    ((7, 5), (3, 5))])
def test_pair_equals_numpys_draw(walk, seed, sigma, shapes):
    _check(np.random.default_rng(seed), sigma, shapes)


def test_unseeded_generator(walk):
    """``seed=None``: the draw starts from whatever state numpy chose."""
    _check(np.random.default_rng(), 0.1, ((300, 16), (400, 16)))


def test_tail_and_wedge_attempts_in_a_long_draw(walk):
    """~4e5 positions: the wedge engages on ~1.4% of them, the tail (idx 0,
    rabs >= ki[0]) on ~0.03%."""
    before = init.SLOW.copy()
    _check(np.random.default_rng(20), 0.1, ((2000, 64), (4000, 64)))
    d = {k: init.SLOW[k] - before[k] for k in ("wedge", "tail", "words")}
    assert d["tail"] > 0
    assert 0.010 < d["wedge"] / d["words"] < 0.020
    assert 1.01 < d["words"] / (6000 * 64) < 1.03


def _tail_rounds(raw, ki):
    """Positions whose word starts a tail attempt, with the tail rounds
    numpy's loop runs from there (first round's rejection only: 1 or 2)."""
    idx = raw & np.uint64(0xff)
    rabs = (raw >> np.uint64(9)) & np.uint64((1 << 52) - 1)
    q = np.flatnonzero((idx[:-2] == 0) & (rabs[:-2] >= ki[0]))
    u1 = (raw[q + 1] >> np.uint64(11)) * (1.0 / 2**53)
    u2 = (raw[q + 2] >> np.uint64(11)) * (1.0 / 2**53)
    xx = -0.27366123732975827 * np.log1p(-u1)
    yy = -np.log1p(-u2)
    return q, np.where(yy + yy > xx * xx, 1, 2)


@pytest.mark.parametrize("rounds", [1, 2])
def test_draw_that_starts_with_a_tail_attempt(walk, rounds):
    """The first word of the draw starts a tail attempt: its rounds read
    the next two words (from the records) and, in a second round, words
    the walk computes itself from the stream."""
    ki, _, _ = native.ziggurat_tables()
    st = np.random.default_rng(77).bit_generator.state
    q, n = _tail_rounds(raw_words(st["state"]["state"],
                                       st["state"]["inc"], 2_000_000), ki)
    first = q[n == rounds][0]
    rng = np.random.default_rng(77)
    rng.bit_generator.advance(int(first))
    before = init.SLOW["tail"]
    _check(rng, 0.1, ((1, 3), (2, 3)))
    assert init.SLOW["tail"] > before


@pytest.mark.parametrize("n_pos", [1, 40, 1000, 5000, 12_000])
def test_short_range_raises(walk, n_pos):
    """Fewer positions than the draws need (12,000 draws) raise, naming
    the range, and leave the generator where it was: nothing is drawn on
    another path."""
    rng = np.random.default_rng(5)
    st = rng.bit_generator.state
    with pytest.raises(RuntimeError, match=f"{n_pos} stream positions hold"):
        plain_pair(rng.bit_generator, 0.1, 4000, 8000, n_pos=n_pos)
    assert rng.bit_generator.state == st


def test_empty_and_one_sided_pairs(walk):
    _check(np.random.default_rng(3), 0.1, ((0, 8), (0, 8)))
    _check(np.random.default_rng(3), 0.1, ((0, 8), (9, 8)))
    _check(np.random.default_rng(3), 0.1, ((9, 8), (0, 8)))


def test_walk_turns_the_mask_into_the_emit_mask(walk):
    """The walk's emit mask, segment counts and values against numpy's
    draw: each emitted position's rank is its count of emits before it."""
    rng = np.random.default_rng(9)
    st = rng.bit_generator.state["state"]
    T = 70_000
    N = init.n_positions(T)
    raw = raw_words(st["state"], st["inc"], N + 2)
    mask, rec = scan_plain(raw, N)
    one_word = mask.copy()
    base, idx, val, w = native.normal_walk(rec, mask, N, T, 0.1, st["state"],
                                           st["inc"], init.SEG_WORDS)
    assert w["done"] and w["emitted"] == T
    assert w["wedge"] + w["tail"] <= len(rec)
    bits = np.unpackbits(mask.view(np.uint8), bitorder="little")[:N]
    emits = np.flatnonzero(bits)
    # the first T emits end at the word numpy's draws end at
    ref = np.random.default_rng(9)
    want = ref.normal(0, 0.1, T).astype(np.float32)
    ref2 = np.random.default_rng(9)
    ref2.bit_generator.advance(w["words"])
    assert ref2.bit_generator.state == ref.bit_generator.state
    assert emits[T - 1] < w["words"] <= emits[T - 1] + 1 + 2 * 8
    # walk values sit at their ranks; every other emit is a one-word one
    np.testing.assert_array_equal(_bits(val), _bits(want[idx]))
    walked = emits[idx]
    assert not (one_word.view(np.uint8)[walked >> 3] >> (walked & 7) & 1).any()
    # base: the emits before each segment
    seg = init.SEG_WORDS * 32
    np.testing.assert_array_equal(
        base, np.searchsorted(emits, np.arange(len(base)) * seg))


def test_bit_generator_must_be_pcg64(walk):
    with pytest.raises(ValueError, match="PCG64"):
        init.normal_pair(np.random.Philox(1), 0.1, 4, 4, "cpu")


def test_pair_draws_on_a_cuda_device_alone():
    """A CPU model keeps numpy's draw: `normal_pair` refuses the CPU."""
    with pytest.raises(ValueError, match="CUDA device"):
        init.normal_pair(np.random.PCG64(1), 0.1, 4, 4, "cpu")


def test_ziggurat_tables_shape(walk):
    """numpy's tables as the walk and the card hold them: ki[0] is the
    tail's share of the base strip, ki[1] = 0 (layer 1 always takes the
    wedge), fi falls from 1."""
    ki, wi, fi = native.ziggurat_tables()
    assert ki.dtype == np.uint64 and wi.dtype == fi.dtype == np.float64
    assert ki[1] == 0 and 0.9 < ki[0] / 2**52 < 0.95
    assert fi[0] == 1.0 and (np.diff(fi) < 0).all()
    assert (ki[2:] < 2**52).all() and (wi > 0).all()


def test_walk_is_built_without_contraction(walk):
    """numpy's wedge multiplies and adds apart: the walk's build keeps
    them apart (no fused multiply-add in its code)."""
    assert "-ffp-contract=off" in native._WALK_FLAGS
    if shutil.which("objdump") is None:
        pytest.skip("objdump not on PATH")
    asm = subprocess.run(["objdump", "-d", walk._name], check=True,
                         capture_output=True, text=True).stdout
    assert "fmadd" not in asm and "fmsub" not in asm


def test_cpu_model_keeps_numpys_draw(walk):
    """A CPU model's tables are numpy's draw on the host, the feature
    tables drawn after ``v_i`` from the same generator."""
    rng = np.random.default_rng(0)
    users, items = rng.integers(0, 50, 400), rng.integers(0, 80, 400)
    df = pd.DataFrame({"u": users, "i": items})
    feats = pd.DataFrame(
        {"i": np.unique(items), "a": rng.random(len(np.unique(items))),
         "b": rng.random(len(np.unique(items)))})
    before = init.DRAWS.copy()
    model = RankFM(factors=6, device="cpu", seed=31)
    model._init_all(df, item_features=feats)
    U, I = len(model.user_idx), len(model.item_idx)
    ref = np.random.default_rng(31)
    for name, shape, scale in (("v_u", (U, 6), model.sigma),
                               ("v_i", (I, 6), model.sigma),
                               ("v_if", (2, 6),
                                model.alpha / model.beta * model.sigma)):
        np.testing.assert_array_equal(
            _bits(model._w[name]),
            _bits(ref.normal(0, scale, shape).astype(np.float32)))
    assert init.DRAWS - before == {("host", "v_u"): 1, ("host", "v_i"): 1,
                                   ("host", "v_if"): 1}


def test_walk_rejects_inconsistent_shapes(walk):
    """The library indexes the records and the mask by the sizes it is
    given: a mask of another length, dtype or a record of other width is
    refused before the call."""
    rec = np.zeros((0, 4), dtype=np.int64)
    args = (100, 10, 0.1, 1, 1, init.SEG_WORDS)
    for bad_rec, bad_mask in ((rec, np.zeros(3, dtype=np.uint32)),
                              (rec, np.zeros(4, dtype=np.int32)),
                              (np.zeros((2, 3), dtype=np.int64),
                               np.zeros(4, dtype=np.uint32))):
        with pytest.raises(ValueError, match="inconsistent"):
            native.normal_walk(bad_rec, bad_mask, *args)
