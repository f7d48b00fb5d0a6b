"""Traffic kind ``refresh_loop``: a warm model refreshed in a closed loop, as
a job that retrains with early stopping does.

Set-up makes the data from the seed, relabels its ids once as `fit_loop`
relabels the ids of its warm-up fit (`data.relabel`, fit -1: the makers
number items by popularity, which would put the fused engine's contiguous
window blocks on popularity bands; a log's own ids are not so ordered),
fits the configuration's whole job on it (``RankFM(**model,
seed=...).fit(train, epochs=...)``: the warm model) and then makes
``warmup_calls`` calls. A call is
``model.fit_partial(train, epochs=epochs_per_call)`` and then
``rankfm_tpu_torch.evaluation.hit_rate(model, test, k=k)``, on the same
frames every call, so the ingest short cut, the record layouts and the
epoch graphs of the call before are reused. The window makes calls while
the clock is under ``--seconds``; the one that crosses it is finished and
counted. Its record is shaped like `fit_loop`'s (``fits``, one a call, with
``plan`` and ``timing``; ``rows``; ``epochs``, those of a call; ``wall_s``),
so the fit cells' readers read it.

Each call keeps the tables it leaves (host copies). After the window,
``judged_calls`` calls drawn from the seed are compared, each from the
tables before it (those the call before left) to the tables after it:

- ``eval_gap``: the hit rate the call returned against a plain float32 hit
  rate of the tables it left, with `evaluation.hit_rate`'s definition (each
  held-out user the model knows, the ten best items of the whole catalog,
  none filtered; a hit when one of them is a held-out item of the user);
- ``ll_gap`` and ``rms_gap.<table>``: the reference
  (`fmbench.reference.fit_sparse`) runs the call's epochs from the tables
  before it, from draws of its own, at the call's learning rates (its
  epochs are numbered from 0, as a call's are), with its 128-row chunks and
  4,096-item windows; ``ll_gap`` is the worst epoch's log-likelihood gap,
  relative, and ``rms_gap.<table>`` the gap of the root mean square of what
  the call changed in each table (after less before) from that of the
  reference's change, relative as `fitstats.gaps` takes it. A refresh
  moves a warm table by a few percent, so the tables' own root mean squares
  would read alike whatever the call did; its change does not;
- ``idmap_mismatch``: 1 when the model's id maps are not the sorted ids of
  the data.

Mix parameters: ``epochs_per_call``, ``k``, ``warmup_calls``,
``judged_calls``.
"""

from __future__ import annotations

import time
from pathlib import Path

import numpy as np
import torch

from fmbench import data
from fmbench.harness import load_module
from fmbench.reference import fit_sparse, fitstats
from fmbench.reference.fitstats import no_tf32

fit_loop = load_module(Path(__file__).resolve().parent / "fit_loop.py")
LEAVES = ("v_u", "v_i", "w_i")


def shape_of(run, inputs):
    """``run.shape`` as `fit_loop.setup` sets it."""
    tr = inputs["train"]
    return {"users": len(np.unique(tr[:, 0])),
            "items": len(np.unique(tr[:, 1])),
            "rows": len(tr),
            "nnz_hist": len(np.unique(tr[:, 0] * inputs["id_bound"][1]
                                      + tr[:, 1])),
            "factors": run.config["model"]["factors"],
            "max_samples": run.config["model"]["max_samples"],
            "item_features": 0, "if_nnz_per_item": 0.0}


def refresh(run, state):
    """One call: a refresh of the model and its hit rate, with what it left
    behind."""
    from torch.profiler import record_function

    from rankfm_tpu_torch import evaluation

    mix, m = run.traffic, state["model"]
    epochs = mix["epochs_per_call"]
    with record_function("fmbench.fit"):
        m.fit_partial(**state["kw"], epochs=epochs)
    with record_function("fmbench.evaluate"):
        hr = evaluation.hit_rate(m, state["test"], k=mix["k"])
    with record_function("fmbench.outputs"):
        log = m.training_log_[-epochs:]
        return {"hr": hr, "lls": [e["log_likelihood"] for e in log],
                "tables": {n: getattr(m, n) for n in LEAVES},
                "timing": dict(m.last_fit_timing_),
                "plan": m.last_fit_plan_}


def setup(run):
    from rankfm_tpu_torch import RankFM

    cfg = run.config
    made = data.make(cfg["data"], run.seed, run.cell.base)
    assert made["x_if"] is None, "fit_sparse takes no item features"
    relab, pu, pi = data.relabel(made, run.seed, -1)
    te = made["test"]
    inputs = dict(made, train=relab["train"], sw=relab["sw"],
                  test=np.stack([pu[te[:, 0]], pi[te[:, 1]]], 1))
    run.shape = shape_of(run, inputs)
    model = RankFM(**cfg["model"], seed=fit_loop.model_seed(run.seed, -1),
                   device=run.device)
    kw = data.fit_args(inputs)
    model.fit(**kw, epochs=cfg["epochs"])
    state = {"inputs": inputs, "model": model, "kw": kw,
             "test": inputs["test"]}
    for _ in range(run.traffic["warmup_calls"]):
        refresh(run, state)
    state["start"] = {n: getattr(model, n) for n in LEAVES}
    return state


def window(run, state):
    calls = []
    t0 = time.time()
    while time.time() - t0 < run.seconds:
        calls.append(refresh(run, state))
    wall = time.time() - t0
    return {"fits": calls, "wall_s": wall, "attempted": len(calls),
            "failed": 0, "rows": len(state["inputs"]["train"]),
            "epochs": run.traffic["epochs_per_call"]}


def plain_hit_rate(inputs, frame, tables, k, device, dtype=torch.float32):
    """`evaluation.hit_rate`'s number for ``tables`` (``frame``'s index), in
    ``dtype``: the held-out users the model knows, the ``k`` best items of
    the whole catalog each, a hit when one is a held-out item of the
    user."""
    te = inputs["test"]
    known_u = np.isin(te[:, 0], frame.users)
    users, row = np.unique(np.searchsorted(frame.users, te[known_u, 0]),
                           return_inverse=True)
    known_i = np.isin(te[known_u, 1], frame.items)
    I = len(frame.items)
    with no_tf32():
        t = {n: torch.as_tensor(tables[n], device=device).to(dtype)
             for n in LEAVES}
        scores = t["v_u"][torch.as_tensor(users, device=device)] @ (
            t["v_i"].T) + t["w_i"][None, :]
        top = scores.topk(min(k, I), dim=1).indices
        rel = torch.zeros(len(users), I, dtype=torch.bool, device=device)
        rel[torch.as_tensor(row[known_i], device=device),
            torch.as_tensor(np.searchsorted(frame.items, te[known_u, 1][
                known_i]), device=device)] = True
        hits = rel.gather(1, top).any(1)
    return float(hits.double().mean()) if len(users) else 0.0


def change_rms(before, after):
    """The root mean square of ``after - before``, table by table."""
    return {n: float(np.sqrt(np.mean(np.square(
        after[n].astype(np.float64) - before[n].astype(np.float64)))))
        for n in LEAVES}


def reference(run, inputs, frame, before, k, dtype=torch.float32,
              fault=None, draws=0, tf32=False):
    """The reference's epochs of call ``k`` from the tables ``before``:
    ``(tables, lls)``."""
    seed = np.random.default_rng([run.seed, 0x4EF, draws, k]).integers(
        2**62)
    return fit_sparse.fit(
        frame.train, inputs["sw"], len(frame.users), len(frame.items),
        run.config["model"], run.traffic["epochs_per_call"], seed=seed,
        device=run.device, dtype=dtype, tf32=tf32, fault=fault,
        init=before)


def judge(run, state, program=None):
    """The numbers compared, the worst over the judged calls. ``program``
    (for the control and the planted faults) replaces the window's calls
    by a list of ``(k, before, after, hit rate, lls)``."""
    inputs, mix = state["inputs"], run.traffic
    frame = fitstats.Frame(inputs["train"], inputs["test"], run.device)
    m = state["model"]
    worst = {"idmap_mismatch": float(not (
        np.array_equal(m.index_to_user.values, frame.users)
        and np.array_equal(m.index_to_item.values, frame.items))),
        "eval_gap": 0.0, "ll_gap": 0.0}
    worst.update({f"rms_gap.{n}": 0.0 for n in LEAVES})
    got = program
    if got is None:
        calls = run.record["fits"]
        pick = np.random.default_rng([run.seed, 0x1D6]).permutation(
            len(calls))[:mix["judged_calls"]]
        got = [(k, calls[k - 1]["tables"] if k else state["start"],
                calls[k]["tables"], calls[k]["hr"], calls[k]["lls"])
               for k in sorted(pick)]
    if not got:
        return {n: float("inf") for n in worst}
    readings = []
    for k, before, after, hr, lls in got:
        t0 = time.time()
        ref_t, ref_lls = reference(run, inputs, frame, before, k)
        ref_s = time.time() - t0
        plain = plain_hit_rate(inputs, frame, after, mix["k"], run.device)
        g = fitstats.gaps(
            {"hr10": 0.0, "ll": np.asarray(lls, dtype=np.float64),
             "rms": change_rms(before, after)},
            {"hr10": 0.0, "ll": ref_lls, "rms": change_rms(before, ref_t)})
        del g["hr10_gap"]
        g["eval_gap"] = abs(hr - plain)
        for n, v in g.items():
            worst[n] = max(worst[n], v)
        readings.append(
            f"call {k}: hr {hr!r} (plain {plain!r}), ll {list(lls)!r} "
            f"(reference {ref_lls.tolist()!r}, {ref_s:.1f} s), change rms "
            f"{change_rms(before, after)!r} (reference "
            f"{change_rms(before, ref_t)!r}): {g!r}")
    state["readings"] = readings
    return worst


def control(run, what):
    """The numbers compared when the reference, from the program's warm
    tables and draws of its own, takes the place of a call: in bfloat16
    (``"bf16"``, the control: its epoch and its hit rate), with its matrix
    products in TF32 (``"tf32"``), or in float32 with a planted fault
    (``"unchanged"``, ``"half"``, ``"token"``: see
    `fmbench.reference.fit.fit`). bfloat16 for the reason
    `fit_loop.control` gives."""
    state = setup(run)
    inputs = state["inputs"]
    frame = fitstats.Frame(inputs["train"], inputs["test"], run.device)
    before = state["start"]
    dtype = torch.bfloat16 if what == "bf16" else torch.float32
    after, lls = reference(
        run, inputs, frame, before, 0, dtype=dtype, draws=1,
        tf32=what == "tf32",
        fault=what if what in ("unchanged", "half", "token") else None)
    hr = plain_hit_rate(inputs, frame, after, run.traffic["k"], run.device,
                        dtype)
    values = judge(run, state, program=[(0, before, after, hr, lls)])
    run.readings = state["readings"]
    return values
