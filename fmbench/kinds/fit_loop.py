"""Traffic kind ``fit_loop``: a closed loop of whole fits.

Each fit is ``RankFM(**model, seed=...).fit(train, epochs=...)`` on a new
model, after the harness has relabelled the user and item ids by
permutations drawn from ``(seed, fit index)`` and reordered the rows, so no
fit sees data that a fit before it saw. A fit starts only while the clock is
under ``--seconds``; the one that crosses it is finished and counted. The
clock runs from the first relabelling to the synced end of the last fit.

Set-up makes the data from the seed and runs one whole fit on a
relabelling that no timed fit uses, which builds and loads the kernels and
warms every shape the window's fits use.

After the window the reference (`fmbench.reference.fit`) fits the same
data once from its own draws, and every fit of the window is compared with
it (`fmbench.reference.fitstats`): its id maps exactly, its hit rate, its
epochs' log-likelihoods and its tables' root mean squares by their gaps.
``limits/<cell>.json`` says which of them are compared.

Mix parameters: ``judged_fits``, how many of the window's fits (drawn from
the seed) are compared.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from fmbench import data
from fmbench.reference import fit as ref_fit
from fmbench.reference import fitstats

MODEL_SEED_BOUND = 2**31 - 1


def model_seed(seed, k):
    return int(np.random.default_rng([seed, 0x5EED, k + 1]).integers(
        MODEL_SEED_BOUND))


def fit_once(run, state, k):
    """Relabel, fit and keep the outputs of fit ``k`` (-1: the warm-up)."""
    from torch.profiler import record_function

    from rankfm_tpu_torch import RankFM

    cfg = run.config
    with record_function("fmbench.relabel"):
        kw = data.fit_args(data.relabel(state["inputs"], run.seed, k)[0])
    with record_function("fmbench.fit"):
        model = RankFM(**cfg["model"], seed=model_seed(run.seed, k),
                       device=run.device)
        model.fit(**kw, epochs=cfg["epochs"])
    with record_function("fmbench.outputs"):
        out = {"k": k,
               "users": model.index_to_user.values,
               "items": model.index_to_item.values,
               "tables": {n: getattr(model, n) for n in state["leaves"]},
               "lls": [e["log_likelihood"] for e in model.training_log_],
               "timing": dict(model.last_fit_timing_),
               "plan": model.last_fit_plan_}
    return out


def setup(run):
    inputs = data.make(run.config["data"], run.seed, run.cell.base)
    leaves = ["v_u", "v_i", "w_i"]
    if inputs["x_if"] is not None:
        leaves += ["v_if", "w_if"]
    state = {"inputs": inputs, "leaves": leaves}
    tr, x_if = inputs["train"], inputs["x_if"]
    items = np.unique(tr[:, 1])
    run.shape = {
        "users": len(np.unique(tr[:, 0])), "items": len(items),
        "rows": len(tr), "nnz_hist": len(np.unique(
            tr[:, 0] * inputs["id_bound"][1] + tr[:, 1])),
        "factors": run.config["model"]["factors"],
        "max_samples": run.config["model"]["max_samples"],
        "item_features": 0 if x_if is None else x_if.shape[1],
        "if_nnz_per_item": (0.0 if x_if is None
                            else float((x_if[items] != 0).sum(1).mean()))}
    fit_once(run, state, -1)
    return state


def window(run, state):
    fits, failed = [], 0
    t0 = time.time()
    while time.time() - t0 < run.seconds:
        fits.append(fit_once(run, state, len(fits)))
    wall = time.time() - t0
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    return {"fits": fits, "wall_s": wall, "attempted": len(fits),
            "failed": failed, "rows": len(state["inputs"]["train"]),
            "epochs": run.config["epochs"]}


# the float32 reference fits made in this process, by (configuration,
# seed): `proof.py` judges a seed's program fits and its control against one
# and the same reference fit
_REFERENCE = {}


def reference(run, inputs, frame, dtype=torch.float32, fault=None, draws=0,
              tf32=False):
    """The reference's fit of ``inputs`` in ``frame``'s index: its tables
    and its epochs' log-likelihoods. ``draws`` picks another stream of the
    seed (the control's own draws)."""
    cfg = run.config
    key = (str(run.cell.base), run.cell.entry["config"], run.seed, draws,
           str(dtype), fault, tf32, run.device)
    if key in _REFERENCE:
        return _REFERENCE[key]
    x_if = None if inputs["x_if"] is None else inputs["x_if"][frame.items]
    seed = np.random.default_rng([run.seed, 0x4EF, draws]).integers(2**62)
    out = ref_fit.fit(frame.train, inputs["sw"], x_if, len(frame.users),
                      len(frame.items), cfg["model"], cfg["epochs"],
                      seed=seed, device=run.device, dtype=dtype, tf32=tf32,
                      fault=fault)
    if draws == 0 and fault is None and dtype == torch.float32 and not tf32:
        _REFERENCE[key] = out
    return out


def in_frame(run, frame, inputs, out):
    """One program fit's tables in ``frame``'s index (the reference's own),
    or None when the fit's id maps are not the ones its data gives."""
    relab, pu, pi = data.relabel(inputs, run.seed, out["k"])
    tr = relab["train"]
    if not (np.array_equal(out["users"], np.unique(tr[:, 0]))
            and np.array_equal(out["items"], np.unique(tr[:, 1]))):
        return None
    # program row r holds new id out[...][r]; its reference row is that of
    # the original id the permutation took there
    inv_u, inv_i = np.argsort(pu), np.argsort(pi)
    ru = np.searchsorted(frame.users, inv_u[out["users"]])
    ri = np.searchsorted(frame.items, inv_i[out["items"]])
    t = {}
    for n, v in out["tables"].items():
        if n in ("v_u",):
            t[n] = np.empty_like(v)
            t[n][ru] = v
        elif n in ("v_i", "w_i"):
            t[n] = np.empty_like(v)
            t[n][ri] = v
        else:
            t[n] = v
    return t


def judge(run, state, program=None):
    """The numbers compared: ``idmap_mismatch`` (judged fits whose id maps
    are not the sorted ids of their data), and the largest ``hr10_gap``,
    ``ll_gap`` and ``rms_gap.<table>`` over the judged fits. ``program`` (for
    the control and the planted faults) replaces the window's fits by a list
    of ``(tables, lls)`` already in the reference's index."""
    inputs = state["inputs"]
    frame = fitstats.Frame(inputs["train"], inputs["test"], run.device)
    x_if = None if inputs["x_if"] is None else inputs["x_if"][frame.items]
    t0 = time.time()
    tables, lls = reference(run, inputs, frame)
    ref_s = time.time() - t0
    ref = fitstats.stats(frame, tables, lls, x_if)
    worst = {"idmap_mismatch": 0.0, "hr10_gap": 0.0, "ll_gap": 0.0}
    worst.update({f"rms_gap.{n}": 0.0 for n in ref["rms"]})
    got = program
    if got is None:
        got = []
        fits = run.record["fits"]
        pick = np.random.default_rng([run.seed, 0x1D6]).permutation(
            len(fits))[:run.traffic["judged_fits"]]
        for out in (fits[k] for k in sorted(pick)):
            t = in_frame(run, frame, inputs, out)
            if t is None:
                worst["idmap_mismatch"] += 1
                continue
            got.append((t, out["lls"]))
    if not got:
        return {k: float("inf") for k in worst}
    per_fit = []
    for t, fit_lls in got:
        st = fitstats.stats(frame, t, fit_lls, x_if)
        g = fitstats.gaps(st, ref)
        for k, v in g.items():
            worst[k] = max(worst[k], v)
        per_fit.append(dict(g, hr10=st["hr10"], ll=st["ll"].tolist(),
                            rms=st["rms"]))
    state["readings"] = [
        f"reference ({ref_s:.1f} s): hr10 {ref['hr10']!r}, "
        f"ll {ref['ll'].tolist()!r}, rms {ref['rms']!r}"] + [
        f"fit {k}: {g!r}" for k, g in enumerate(per_fit)]
    return worst


def control(run, what):
    """The numbers compared when the reference, from draws of its own, takes
    the program's place: in bfloat16 (``"bf16"``, the control), with its
    matrix products in TF32 (``"tf32"``), or in float32 with a planted fault
    (``"unchanged"``, ``"half"``, ``"token"``: see
    `fmbench.reference.fit.fit`).

    The control is bfloat16 because a fit's arithmetic is float32 outside
    any large matrix product: the program's fused kernel runs every epoch
    of ``ml1m`` and 27 of ``instacart``'s 30 on the CUDA cores, and the
    candidate epochs score their sampled negatives by gathered dot products
    (8,192 rows by 33k items is past the size they score whole). TF32, a
    mode of tensor-core products, has nothing of such a fit to act on but
    the small products of item features by their 21-row table; the
    precision below float32 that a fit could take is bfloat16 tables and
    arithmetic.
    """
    inputs = data.make(run.config["data"], run.seed, run.cell.base)
    frame = fitstats.Frame(inputs["train"], inputs["test"], run.device)
    if what == "tf32":
        got = reference(run, inputs, frame, draws=1, tf32=True)
    elif what == "bf16":
        got = reference(run, inputs, frame, torch.bfloat16, draws=1)
    else:
        got = reference(run, inputs, frame, fault=what, draws=1)
    state = {"inputs": inputs}
    values = judge(run, state, program=[got])
    run.readings = state["readings"]
    return values
