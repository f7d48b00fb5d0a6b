"""What surrounds the fused chunk kernel and runs without a card: the
operation and byte counts behind its roofline bound (`chunk_work`), the
sizes of the scratch tensors the wrapper hands it (`scratch_sizes`), and
`fused_batch`'s CPU path, which is the plain version bit for bit.

The hand-computed figures are those of the two headline shapes: ML-1M
(chunk 256, user block 1,024, one window of 1,024 items, F 20, so D 22) and
Instacart (chunk 128, four windows, F 50, so D 52; 21 + 21 one-hot feature
columns in the featured variant).
"""

import numpy as np
import pytest
import torch

from rankfm_tpu_torch.ops import fused

from test_torch_cuda import EDGES, _case

ML1M = dict(C=256, UB=1024, BLK=1024, NW=1, D=22)
TAIL = dict(C=128, UB=256, BLK=1024, NW=1, D=22)
INSTACART = dict(C=128, UB=1024, BLK=1024, NW=4, D=52)


@pytest.mark.parametrize("shape,ops,nbytes", [
    # scoring 2*256*1024*22; window rows 90,112 + history words 65,536 +
    # records 2,048 + user/positive rows read and written 90,112 + chosen
    # rows 22,528 + ll 1,024
    (ML1M, 11_534_336, 271_360),
    (TAIL, 5_767_168, 180_736),
    # scoring 2*128*4096*52; 851,968 + 131,072 + 1,024 + 106,496 + 26,624 +
    # 512
    (INSTACART, 54_525_952, 1_117_696),
], ids=["ml1m", "ml1m-tail", "instacart"])
def test_chunk_work_featureless(shape, ops, nbytes):
    assert fused.chunk_work(**shape) == (ops, nbytes)


def test_chunk_work_with_side_features():
    base_ops, base_bytes = fused.chunk_work(**INSTACART)
    # item features double the scoring depth; one-hot rows cost one
    # feature-table row each: 2*D per user-block row and per item row
    ops, nbytes = fused.chunk_work(**INSTACART, has_uf=True, has_if=True,
                                   P=21, Q=21, uf_nnz=1, if_nnz=1)
    assert ops == 2 * base_ops + 2 * 52 * (1024 + 5 * 1024)
    assert ops == 109_690_880
    # + the chunk's x_uf rows, the blocks' x_if rows, both feature tables
    # read and written
    assert nbytes == base_bytes + 128 * 21 * 4 + 5 * 1024 * 21 * 4 \
        + 2 * 2 * 21 * 52 * 4
    assert nbytes == 1_576_000
    # dense features by default
    dense, _ = fused.chunk_work(**INSTACART, has_uf=True, has_if=True, P=21,
                                Q=21)
    assert dense == 2 * base_ops + 2 * 52 * 21 * (1024 + 5 * 1024)
    # one side only
    uf_ops, uf_bytes = fused.chunk_work(**ML1M, has_uf=True, P=30, uf_nnz=3)
    assert uf_ops == 11_534_336 + 2 * 1024 * 3 * 22
    assert uf_bytes == 271_360 + 256 * 30 * 4 + 2 * 30 * 22 * 4
    if_ops, _ = fused.chunk_work(**ML1M, has_if=True, Q=18, if_nnz=2)
    assert if_ops == 2 * 11_534_336 + 2 * 2 * 1024 * 2 * 22


def test_chunk_bound_is_operations_at_both_headlines():
    """At the H100's published peaks (67 TFLOP/s f32, 3.35 TB/s) both
    headline chunks are bound by their operations, not their bytes."""
    for shape in (ML1M, INSTACART):
        ops, nbytes = fused.chunk_work(**shape)
        assert ops / 67e12 > nbytes / 3.35e12
    ops, _ = fused.chunk_work(**ML1M)
    assert 128 * ops / 67e12 * 1e3 == pytest.approx(0.0220, abs=1e-4)  # ms


@pytest.mark.parametrize("kw,want", [
    (dict(nT=128, **ML1M),
     dict(acc=(1024 + 2 * 1024) * 22, pw=256 * 1024 + 256, cnt=512, facc=0)),
    (dict(nT=256, **INSTACART),
     dict(acc=(1024 + 5 * 1024) * 52, pw=128 * 4096 + 128, cnt=256, facc=0)),
    (dict(nT=256, **INSTACART, P=21, Q=21, has_uf=True, has_if=True),
     dict(acc=6144 * 52, pw=128 * 4096 + 128, cnt=256,
          facc=(1024 + 5120 + 42) * 52 + 42 + 256)),
    (dict(nT=128, **ML1M, P=30, Q=18, has_uf=True),
     dict(acc=3072 * 22, pw=256 * 1024 + 256, cnt=512,
          facc=(1024 + 30) * 22 + 30 + 128)),
    (dict(nT=128, **ML1M, P=30, Q=18, has_if=True),
     dict(acc=3072 * 22, pw=256 * 1024 + 256, cnt=512,
          facc=(2048 + 18) * 22 + 18 + 128)),
], ids=["ml1m", "instacart", "instacart-both", "ml1m-user-only",
        "ml1m-item-only"])
def test_scratch_sizes(kw, want):
    assert fused.scratch_sizes(**kw) == want


def test_pw_scratch_stays_in_l2():
    """The pairwise-utility scratch of one chunk is 1 MB at ML-1M and 2 MB
    at Instacart: far inside the H100's 50 MB L2."""
    for shape, mb in ((ML1M, 1), (INSTACART, 2)):
        n = fused.scratch_sizes(nT=1, **shape)["pw"]
        assert mb * 2**20 <= 4 * n < (mb + 0.01) * 2**20


@pytest.mark.parametrize("edge,nw,n_uf,n_if", [
    ("BLK128", 1, 0, 0), ("BLK128", 4, 0, 0), ("BLK128", 2, 5, 6),
    ("base", 1, 0, 0)])
def test_fused_batch_on_cpu_is_the_plain_version(edge, nw, n_uf, n_if):
    """On CPU tensors the wrapper runs `fused_batch_reference`: the same
    tables, log-likelihood and chosen slots, bit for bit."""
    rng = np.random.default_rng(5)
    cpu = torch.device("cpu")
    tabs, args, kw, rows = _case(cpu, nw, rng, n_uf, n_if, **EDGES[edge])
    feats = {}
    if n_uf or n_if:
        tabs, feats = tabs
    got = [t.clone() for t in tabs], {k: v.clone() for k, v in feats.items()}
    want = [t.clone() for t in tabs], {k: v.clone() for k, v in feats.items()}
    launches = sum(fused.LAUNCHES.values())
    ch_got = torch.empty(rows, dtype=torch.int32)
    ch_want = torch.empty_like(ch_got)
    ll_got = fused.fused_batch(*got[0], *args, max_samples=10, chosen=ch_got,
                               **kw, **got[1])
    ll_want = fused.fused_batch_reference(*want[0], *args, max_samples=10,
                                          chosen=ch_want, **kw, **want[1])
    assert torch.equal(ll_got, ll_want) and torch.isfinite(ll_got)
    assert torch.equal(ch_got, ch_want)
    for a, b, t0 in zip(got[0], want[0], tabs):
        assert torch.equal(a, b) and not torch.equal(a, t0)
    for name in ("tab_uf", "tab_if"):
        if name in feats:
            assert torch.equal(got[1][name], want[1][name])
            assert not torch.equal(got[1][name], feats[name])
    assert sum(fused.LAUNCHES.values()) == launches   # none on the CPU
