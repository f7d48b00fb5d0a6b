"""Traffic kind ``fit_loop_sparse``: `fit_loop`'s closed loop of whole fits,
judged by a reference that holds no ``[users, items]`` matrix.

Set-up, the window and the relabelling are `fit_loop`'s own (`fit_loop.setup`,
`fit_loop.window`, `fit_loop.fit_once`). The judge and the control are
`fit_loop.judge` and `fit_loop.control` themselves: this kind runs a private
instance of `fit_loop` whose reference is `fmbench.reference.fit_sparse`
(`fmbench.reference.fit`'s fit with a sparse membership) and whose
statistics are `fmbench.reference.fitstats_sparse` (the same numbers, masks
built a block of users at a time): the same numbers (``idmap_mismatch``,
the largest ``hr10_gap``, ``ll_gap`` and ``rms_gap.<table>`` over the
judged fits), compared the same way. A catalog of ~10^6 items makes the
dense membership and masks of `fit_loop`'s own reference larger than the
card.

The window also counts the program's batch steps (`training.STEPS`, when
the program has that counter), which ``cand.step_us`` and ``b3_roofline``
read, and prints to standard error the fits' plans, the steps and the
table-update kernels' launches (the path the window took); set-up adds to ``run.shape`` the rows of each user and item, from
which ``b3_roofline`` counts the rows a step touches.

Mix parameters: ``judged_fits``, how many of the window's fits (drawn from
the seed) are compared.
"""

from __future__ import annotations

import importlib.util
import sys
from collections import Counter
from pathlib import Path

import numpy as np
import torch

from fmbench.reference import fit_sparse, fitstats_sparse

FIT_LOOP = Path(__file__).resolve().parent / "fit_loop.py"


# the float32 reference fits made in this process, by (configuration,
# seed): `proof.py` judges a seed's program fits and its control against one
# and the same reference fit
_REFERENCE = {}


def reference(run, inputs, frame, dtype=torch.float32, fault=None, draws=0,
              tf32=False):
    """`fit_loop.reference` with `fit_sparse`: the reference's fit of
    ``inputs`` in ``frame``'s index, its tables and its epochs'
    log-likelihoods. ``draws`` picks another stream of the seed (the
    control's own draws)."""
    assert inputs["x_if"] is None, "fit_sparse takes no item features"
    cfg = run.config
    key = (str(run.cell.base), run.cell.entry["config"], run.seed, draws,
           str(dtype), fault, tf32, run.device)
    if key in _REFERENCE:
        return _REFERENCE[key]
    seed = np.random.default_rng([run.seed, 0x4EF, draws]).integers(2**62)
    out = fit_sparse.fit(frame.train, inputs["sw"], len(frame.users),
                         len(frame.items), cfg["model"], cfg["epochs"],
                         seed=seed, device=run.device, dtype=dtype,
                         tf32=tf32, fault=fault)
    if draws == 0 and fault is None and dtype == torch.float32 and not tf32:
        _REFERENCE[key] = out
    return out


def _sparse_fit_loop():
    """A private instance of `fit_loop` that reads `reference` above and
    `fitstats_sparse` where it read its own reference and `fitstats`.

    It rests on two module globals of `fit_loop.py`: ``reference`` (which
    `judge` and `control` call for the reference fit) and ``fitstats``
    (whose ``Frame``, ``stats`` and ``gaps`` they call); an edit that
    reaches the reference fit or the statistics by another name would
    judge this kind with the dense ones. `harness.load_module` cannot
    serve here: it hands out the one shared instance of `fit_loop`, which
    the other fit cells judge with, so rebinding its globals would change
    their judge."""
    spec = importlib.util.spec_from_file_location("fmbench_fit_loop_sparse",
                                                  FIT_LOOP)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.fitstats, mod.reference = fitstats_sparse, reference
    return mod


fit_loop = _sparse_fit_loop()
# `fit_loop.judge(run, state, program=None)` and `fit_loop.control(run,
# what)` (bf16, tf32, unchanged, half, token) on the sparse reference:
# bfloat16 is the control for the reason `fit_loop.control` gives, the
# candidate step scoring its sampled negatives by gathered dot products
judge, control = fit_loop.judge, fit_loop.control


def steps_counter():
    """The program's count of batch steps, or None when it keeps none."""
    from rankfm_tpu_torch.ops import training

    return getattr(training, "STEPS", None)


def setup(run):
    state = fit_loop.setup(run)
    tr = state["inputs"]["train"]
    run.shape["user_rows"] = np.unique(tr[:, 0], return_counts=True)[1]
    run.shape["item_rows"] = np.unique(tr[:, 1], return_counts=True)[1]
    return state


def window(run, state):
    from rankfm_tpu_torch.ops import scatter

    steps = steps_counter()
    before = Counter(steps) if steps is not None else None
    updates = Counter(scatter.LAUNCHES)
    rec = fit_loop.window(run, state)
    if steps is not None:
        rec["steps"] = dict(Counter(steps) - before)
    plans = sorted({(p.fused, p.step_kind, p.n_main + p.n_tail, p.post_reject,
                     p.xla_batch) for p in (f["plan"] for f in rec["fits"])})
    print(f"fit_loop_sparse: plans (fused, step kind, epochs, post-reject, "
          f"batch) {plans}; steps {rec.get('steps')}; table-update "
          f"launches {dict(Counter(scatter.LAUNCHES) - updates)}",
          file=sys.stderr)
    return rec
