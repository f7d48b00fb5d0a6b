"""Training-dispatch planner (port of `rankfm_tpu/models/planner.py`): every
fit-time regime decision as ONE pure function over plain scalars.

`plan_fit` returns the same `FitPlan` as the JAX package's `plan_fit` for
the same spec, field by field (``on_gpu`` here is ``on_tpu`` there: the
backend can run the fused engine). The decision rules and their measured
reasons are documented in the JAX package.

The port runs the fused engine (with its chunk-tail or its candidate
tail) and the XLA window and candidate engines, with or without side
features, on one device or on a mesh (`rankfm_tpu_torch.parallel`:
data-parallel or table-parallel placement). `plan_fit` raises
`NotImplementedError`, naming the ROADMAP item, for the plans outside
that: a wide-window tail, pre-shuffled layouts.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from rankfm_tpu_torch.ops import fused as fused_mod

# chunks walked per grid step on the TPU: pure scheduling there, carried
# in the plan for parity and ignored by the port's engine
DEFAULT_SUB = 1


def _next_pow2(n):
    return 1 << max(0, (int(n) - 1).bit_length())


@dataclass(frozen=True)
class FitSpec:
    """Everything `plan_fit` may look at: data shapes, history density,
    backend facts and the constructor knobs, as plain scalars."""

    n: int                    # interaction rows in THIS fit call
    num_users: int
    num_items: int
    factors: int
    loss: str                 # 'bpr' | 'warp'
    max_samples: int
    epochs: int
    x_uf_any: bool = False
    x_if_any: bool = False
    num_uf: int = 1           # feature matrix column counts
    num_if: int = 1
    nnz_hist: int = 0         # total distinct (u, i) history pairs
    mean_sample_weight: float = 1.0
    on_gpu: bool = False      # the backend runs the fused engine
    mesh: object = None       # a `parallel.mesh.Mesh` (only .shape is read)
    table_bytes: int = 0      # weight bytes (DP-vs-TP input)
    # knobs (RankFM constructor extras)
    batch_size: Optional[int] = None
    train_step: str = "auto"
    use_fused: object = "auto"
    n_windows: Optional[int] = None
    tail_windows: Optional[int] = None
    sample_rounds: object = "auto"
    shuffle_layouts: object = "auto"


@dataclass(frozen=True)
class FitPlan:
    """The resolved dispatch: which engines run which epochs, at what
    shapes, placed how."""

    max_samples: int          # 1 for BPR
    n_dev: int                # devices on the mesh (1 when mesh is None)
    nblk: int                 # catalog window blocks (regime selector)
    # fused main path
    fused: bool               # main epochs run the fused engine
    table_mode: Optional[str]  # 'f32' | 'bf16' | None (eligibility)
    # bf16 tables exist on the TPU only to fit VMEM: the port always trains
    # f32 tables and carries this field for parity, unread by its engine
    table_bf16: bool
    batch_size: int           # fused batch (launch granularity)
    chunk: int                # fused chunk rows (negative-window unit)
    sub: int                  # TPU grid scheduling, unread by the port
    user_block: int           # fused user-bucket rows (0 = n/a)
    shuffle_layouts: int      # pre-computed epoch layouts (1 = sort per epoch)
    n_windows: Optional[int]  # per-chunk window override (None = default)
    # epoch split (mixed schedule)
    n_main: int               # epochs on the main engine
    n_tail: int               # candidate-tail epochs at the end
    tail_windows: Optional[int]  # wide-window fused tail instead (resolved)
    # XLA path (fallback main epochs and the candidate tail)
    xla_batch: int
    step_kind: str            # 'window' | 'candidate' for XLA MAIN epochs
    placement: str            # 'single' | 'dp' | 'tp'
    rounds: int               # candidate-step rejection redraw rounds
    post_reject: bool         # post-hoc membership testing (sparse regime)
    # chunk-tail schedule: the LAST chunk_tail fused epochs re-run at the
    # oracle-parity layout (tail_chunk @ tail_user_block)
    chunk_tail: int = 0
    tail_chunk: int = 0
    tail_user_block: int = 0
    tail_sub: int = 1


POST_REJECT_DENSITY = 0.02


def _mesh_devices(mesh):
    n = 1
    if mesh is not None:
        for v in mesh.shape.values():
            n *= v
    return n


def _auto_batch_size(spec, fused):
    """Auto minibatch size: up to 32k on the fused engine (whose
    synchronous unit is the chunk), else a stability-capped power of two
    <= 8192."""
    if spec.batch_size is not None:
        return spec.batch_size
    if fused:
        return min(32768, max(256, _next_pow2(max(spec.n, 1))))
    num_items = max(spec.num_items, 1)
    mean_sw = max(float(spec.mean_sample_weight), 0.0)
    stable_cap = max(256, _next_pow2(int(2 * num_items / max(mean_sw, 1.0) ** 2)))
    return min(8192, _next_pow2(max(spec.n, 1)), stable_cap)


def plan_fit(spec: FitSpec) -> FitPlan:
    """Resolve the full training dispatch for one `fit_partial` call."""
    if spec.loss == "bpr":
        max_samples = 1
    elif spec.loss == "warp":
        max_samples = spec.max_samples
    else:
        raise ValueError("[loss] function not recognized")

    U, I, F = spec.num_users, spec.num_items, spec.factors
    n_dev = _mesh_devices(spec.mesh)
    nblk = fused_mod.item_pad(I) // fused_mod.block_size(I)

    table_mode = fused_mod.fused_table_mode(
        U, I, F, spec.x_uf_any, spec.x_if_any,
        num_uf=spec.num_uf, num_if=spec.num_if)
    # on a mesh the fused engine runs data-parallel only: replicated
    # tables, one delta all-reduce per sync group
    fused_mesh_ok = False
    if spec.mesh is not None and table_mode is not None:
        from rankfm_tpu_torch.parallel.train import uses_dp
        fused_mesh_ok = uses_dp(spec.mesh, 128 * n_dev, spec.table_bytes)
    fused_possible = (spec.use_fused in (True, "auto")
                      and (spec.mesh is None or fused_mesh_ok)
                      and spec.on_gpu and table_mode is not None)
    bs = _auto_batch_size(spec, fused=fused_possible)
    if fused_possible and spec.mesh is not None and spec.batch_size is None:
        # the global batch deals whole 128-row chunk multiples to every rank
        q = 128 * n_dev
        bs = (bs + q - 1) // q * q
    fused = (fused_possible and bs >= 128 * n_dev
             and bs % (128 * n_dev) == 0)

    chunk = (fused_mod.pick_chunk(max(bs // n_dev, 128), U, I, spec.n)
             if fused else 0)
    ub = fused_mod.pick_user_block(U, I, spec.n, chunk) if fused else 0
    sub = DEFAULT_SUB if fused else 1
    if not fused or spec.shuffle_layouts == "auto":
        shuffle_layouts = 1
    else:
        shuffle_layouts = max(1, int(spec.shuffle_layouts))
    table_bf16 = table_mode == "bf16"
    nw_main = None
    if fused and spec.n_windows is not None:
        nw_main = min(spec.n_windows, nblk,
                      max(1, fused_mod.max_n_windows(
                          U, I, table_bf16, spec.x_uf_any, spec.x_if_any)))
        if nw_main == fused_mod.default_n_windows(nblk):
            nw_main = None

    bs_x = _auto_batch_size(spec, fused=False)
    if spec.mesh is not None:
        # the padded row count must split evenly over the ranks
        bs_x = (bs_x + n_dev - 1) // n_dev * n_dev
    if spec.train_step in ("auto", "mixed"):
        step_kind = "window" if 2 < nblk <= 8 else "candidate"
    else:
        step_kind = spec.train_step

    density = spec.nnz_hist / max(U * I, 1)
    post_reject = density < POST_REJECT_DENSITY
    if spec.sample_rounds == "auto":
        rounds = int(np.clip(np.ceil(
            -6.0 / np.log10(np.clip(density, 1e-12, 0.99))), 2, 8))
    else:
        rounds = int(spec.sample_rounds)
    placement = "single"
    if spec.mesh is not None:
        from rankfm_tpu_torch.parallel.train import uses_dp
        placement = ("dp" if uses_dp(spec.mesh, bs_x, spec.table_bytes)
                     else "tp")

    n_tail = 0
    if fused and (spec.train_step == "mixed"
                  or (spec.train_step == "auto"
                      and (nblk > 8 or nblk <= 2))):
        n_tail = min(3, spec.epochs // 6)
        if spec.train_step == "auto" and nblk <= 2:
            n_tail = max(n_tail, min(1, spec.epochs - 1))

    nw_tail = None
    if fused and n_tail and spec.tail_windows and spec.tail_windows > 1:
        cand = min(spec.tail_windows, nblk,
                   fused_mod.max_n_windows(
                       U, I, table_bf16, spec.x_uf_any, spec.x_if_any))
        if cand > fused_mod.default_n_windows(nblk):
            nw_tail = cand

    chunk_tail = 0
    tail_chunk = tail_ub = 0
    tail_sub = 1
    # gated off on a mesh: the data-parallel chunk split is dealt once
    if (fused and n_tail == 0 and spec.mesh is None and chunk > 128
            and shuffle_layouts == 1 and spec.epochs >= 2):
        chunk_tail = max(1, spec.epochs // 6)
        tail_chunk, tail_ub, tail_sub = 128, 256, 8

    plan = FitPlan(
        max_samples=max_samples, n_dev=n_dev, nblk=nblk,
        fused=fused, table_mode=table_mode, table_bf16=table_bf16,
        batch_size=bs, chunk=chunk, sub=sub, user_block=ub,
        shuffle_layouts=shuffle_layouts, n_windows=nw_main,
        n_main=spec.epochs - n_tail, n_tail=n_tail, tail_windows=nw_tail,
        xla_batch=bs_x, step_kind=step_kind, placement=placement,
        rounds=rounds, post_reject=post_reject,
        chunk_tail=chunk_tail, tail_chunk=tail_chunk,
        tail_user_block=tail_ub, tail_sub=tail_sub,
    )
    _require_slice(spec, plan)
    return plan


def _require_slice(spec, plan):
    """Raise `NotImplementedError` for a plan this port cannot run yet."""
    if plan.tail_windows:
        raise NotImplementedError(
            "the wide-window tail is not ported (ROADMAP queue 1, "
            "deliberately not ported: tail_windows)")
    if plan.shuffle_layouts > 1:
        raise NotImplementedError(
            "pre-shuffled layouts are not ported (ROADMAP queue 1, "
            "deliberately not ported: shuffle_layouts)")
