"""The fused chunk kernel on the card, and the build and dispatch rules
around it.

Tests marked ``cuda`` need an NVIDIA GPU with nvcc and skip without one;
run them there with ``python -m pytest tests/test_torch_cuda.py -m cuda``.
This file imports no JAX, so it runs where only the port is installed.

Kernel vs plain version on the same inputs and the same Philox draws: f32
atomics sum in a run-dependent order, so the tables agree to ~1e-5
absolute (checked at 1e-4), the log-likelihood to 1e-4 relative, and at
least 99.9% of the rows choose the same negative.
"""

import numpy as np
import pytest
import torch

from rankfm_tpu_torch.ops import _build
from rankfm_tpu_torch.ops import fused


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, nw, rng):
    U, I, F, C, ub = 700, 2500, 20, 128, 256
    hist = rng.random((U, I)) < 0.3
    offsets = np.zeros(U + 1, np.int32)
    offsets[1:] = np.cumsum(hist.sum(1))
    flat = np.nonzero(hist)[1].astype(np.int32)
    packed = torch.from_numpy(fused.pack_history(offsets, flat, U, I)).to(dev)
    u, i = np.nonzero(hist)
    pick = rng.choice(len(u), 6000, replace=False)
    rec, _, cids, ublk, iblk = fused.make_records_grouped(
        u[pick], i[pick], rng.uniform(0.5, 2.0, 6000).astype(np.float32),
        U, I, 2048, C, ub=ub)
    rec_b = torch.from_numpy(rec).to(dev).view(-1, C, 2)[
        torch.from_numpy(cids[0]).to(dev).long()].reshape(-1, 2)
    nT = cids.shape[1]
    # windows: random blocks, a repeated block, and the positive block
    blk = rng.integers(0, 3, (nT, nw)).astype(np.int32)
    blk[:, 0] = iblk[0]
    if nw > 1:
        blk[::2, 1] = blk[::2, 0]
    tabs = fused.extend_tables(
        torch.from_numpy(rng.normal(0, 0.05, I).astype(np.float32)).to(dev),
        torch.from_numpy(rng.normal(0, 0.1, (U, F)).astype(np.float32)).to(dev),
        torch.from_numpy(rng.normal(0, 0.1, (I, F)).astype(np.float32)).to(dev),
        fused.user_pad(U, ub), fused.item_pad(I))
    args = (rec_b, packed, torch.from_numpy(blk).to(dev),
            torch.from_numpy(ublk[0]).to(dev), torch.from_numpy(iblk[0]).to(dev),
            77, 0.1, float(np.float32(0.1) * np.float32(0.02)))
    kw = dict(factors=F, ub_rows=fused.user_block(U, ub), num_items=I)
    return tabs, args, kw, nT * C


@pytest.mark.cuda
@pytest.mark.parametrize("M,nw", [(1, 1), (20, 1), (20, 4)])
def test_kernel_matches_plain_version(cuda, M, nw):
    rng = np.random.default_rng(M * 10 + nw)
    tabs, args, kw, rows = _case(cuda, nw, rng)
    tk = [t.clone() for t in tabs]
    tr = [t.clone() for t in tabs]
    ch_k = torch.empty(rows, dtype=torch.int32, device=cuda)
    ch_r = torch.empty_like(ch_k)
    before = dict(fused.LAUNCHES)
    ll_k = float(fused.fused_batch(*tk, *args, max_samples=M, chosen=ch_k, **kw))
    assert sum(fused.LAUNCHES.values()) == sum(before.values()) + 1
    ll_r = float(fused.fused_batch_reference(*tr, *args, max_samples=M,
                                             chosen=ch_r, **kw))
    assert abs(ll_k - ll_r) <= 1e-4 * abs(ll_r)
    valid = ((args[0][:, 0] >> 21) & 1).bool()
    assert (ch_k == ch_r)[valid].float().mean() >= 0.999
    assert ((ch_k[~valid] == -1).all() and (ch_r[~valid] == -1).all())
    for a, b, t0 in zip(tk, tr, tabs):
        assert float((a - b).abs().max()) <= 1e-4
        assert float((a - t0).abs().max()) > 0


@pytest.mark.cuda
def test_gpu_fit_matches_cpu_fit(cuda):
    """A whole fit through the kernel and through the plain version: both
    draw the same shuffles, windows and Philox bits, so they differ only by
    f32 summation order (both layouts run: 3 epochs end in the
    chunk-tail)."""
    from rankfm_tpu_torch import RankFM

    rng = np.random.default_rng(3)
    users = np.repeat(np.arange(500), 30)
    train = np.stack([users, rng.integers(0, 2300, len(users))], 1)
    cfg = dict(factors=12, loss="warp", max_samples=10,
               learning_schedule="invscaling")
    before = sum(fused.LAUNCHES.values())
    mg = RankFM(**cfg, device="cuda").fit(train, epochs=3)
    assert sum(fused.LAUNCHES.values()) > before
    mc = RankFM(**cfg, device="cpu").fit(train, epochs=3)
    assert mg.last_fit_plan_ == mc.last_fit_plan_
    assert mg.last_fit_plan_.chunk_tail == 1
    for k in ("w_i", "v_u", "v_i"):
        want = mc._weights[k]
        assert np.abs(mg._weights[k] - want).max() <= 1e-3 * np.abs(want).max()
    np.testing.assert_allclose(
        [r["log_likelihood"] for r in mg.training_log_],
        [r["log_likelihood"] for r in mc.training_log_], rtol=1e-4)


@pytest.mark.cuda
def test_kernel_wrapper_rejects_bad_inputs(cuda):
    rng = np.random.default_rng(0)
    tabs, args, kw, _ = _case(cuda, 1, rng)
    bad_rec = args[0].to(torch.int64)
    with pytest.raises(ValueError, match="rec"):
        fused.fused_batch(*tabs, bad_rec, *args[1:], max_samples=5, **kw)
    with pytest.raises(ValueError, match="packed"):
        fused.fused_batch(*tabs, args[0], args[1].cpu(), *args[2:],
                          max_samples=5, **kw)


def test_fused_batch_refuses_other_devices():
    t = torch.zeros((8, 4), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fused.fused_batch(t, t, t, t, t, t, t, 0, 0.1, 0.002, factors=2,
                          max_samples=1, ub_rows=8, num_items=8)


def test_build_raises_on_compiler_failure(tmp_path, monkeypatch):
    nvcc = tmp_path / "nvcc"
    nvcc.write_text("#!/bin/sh\necho 'error: fake nvcc refuses' >&2\nexit 1\n")
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="fake nvcc refuses"):
        _build.build()


def test_build_is_keyed_by_content(tmp_path, monkeypatch):
    calls = tmp_path / "calls"
    nvcc = tmp_path / "nvcc"
    # a stand-in compiler: count the call, write the -o file
    nvcc.write_text('#!/bin/sh\necho x >> "%s"\nwhile [ "$1" != "-o" ]; do '
                    'shift; done\ntouch "$2"\n' % calls)
    nvcc.chmod(0o755)
    monkeypatch.setattr(_build, "nvcc_path", lambda: str(nvcc))
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    first = _build.build()
    assert _build.build() == first and first.exists()
    assert calls.read_text().count("x") == 1
    monkeypatch.setattr(_build, "NVCC_FLAGS", _build.NVCC_FLAGS + ("-lineinfo",))
    assert _build.build() != first
    assert calls.read_text().count("x") == 2
