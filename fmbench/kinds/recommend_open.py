"""Traffic kind ``recommend_open``: top-N requests on a fixed schedule.

Set-up makes the data from the seed, fits a model on it for ``fit_epochs``
epochs, which builds the model's id maps and its filter of seen items, and
then hands the model weights that the benchmark draws from the seed (so the
reference scores with the same weights and takes none from the program).
It warms the request shape with ``warmup`` requests that the window does
not send.

The window sends request ``k`` at ``k / rate_per_s`` seconds (an open loop:
a request waits for the one before it, and its latency counts from when it
was due), while that time is under ``--seconds``; the last is finished and
counted. A request is ``recommend(users, n_items, filter_previous)`` for
``users_per_request`` training users drawn without replacement from
``(seed, k)``, and ends when the DataFrame is returned.

After the window a sample of ``judged`` requests drawn from the seed is
judged by `fmbench.reference.serve`.

Mix parameters: ``rate_per_s``, ``users_per_request``, ``n_items``,
``filter_previous``, ``fit_epochs``, ``warmup``, ``judged``.
"""

from __future__ import annotations

import math
import time

import numpy as np
import pandas as pd
import torch

from fmbench import data
from fmbench.reference import serve as ref_serve

# the spread of the weights the benchmark draws: factors and biases of the
# size a fitted model's have
FACTOR_SD, BIAS_SD = 0.3, 1.0


def draw_weights(seed, users, items, F, Q, has_if, device):
    """Weights for the sorted ``users`` and ``items`` ids, drawn on the
    device from ``seed`` in a few large calls: ``v_u``, ``v_i``, ``w_i``,
    ``v_if``, ``w_if`` (zeros without item features) and ``v_uf`` (zeros:
    no user features)."""
    g = torch.Generator(device=device)
    g.manual_seed(int(np.random.default_rng([seed, 0x3E1]).integers(2**62)))
    dev = torch.device(device)
    f = torch.randn(len(users) + len(items) + Q, F, generator=g, device=dev)
    b = torch.randn(len(items) + Q, generator=g, device=dev)
    U, I = len(users), len(items)
    w = {"v_u": f[:U] * FACTOR_SD, "v_i": f[U:U + I] * FACTOR_SD,
         "w_i": b[:I] * BIAS_SD,
         "v_if": f[U + I:] * FACTOR_SD if has_if else torch.zeros(Q, F,
                                                                  device=dev),
         "w_if": b[I:] * BIAS_SD if has_if else torch.zeros(Q, device=dev),
         "v_uf": torch.zeros(1, F, device=dev)}
    return {k: v.contiguous() for k, v in w.items()}


def request_users(seed, k, users, n):
    return np.random.default_rng([seed, 0x4E9, k]).choice(users, n,
                                                          replace=False)


def inputs_of(run):
    """What the benchmark hands both sides: the data, the sorted ids, the
    weights, the requests and the sample of them that is judged."""
    cfg, mix = run.config, run.traffic
    inputs = data.make(cfg["data"], run.seed, run.cell.base)
    tr = inputs["train"]
    users, items = np.unique(tr[:, 0]), np.unique(tr[:, 1])
    has_if = inputs["x_if"] is not None
    Q = inputs["x_if"].shape[1] if has_if else 1
    w = draw_weights(run.seed, users, items, cfg["model"]["factors"], Q,
                     has_if, run.device)
    n_due = math.ceil(mix["rate_per_s"] * run.seconds)
    rng = np.random.default_rng([run.seed, 0x5A3])
    sample = set(rng.choice(n_due, min(mix["judged"], n_due),
                            replace=False).tolist())
    reqs = [request_users(run.seed, k, users, mix["users_per_request"])
            for k in range(n_due)]
    return {"inputs": inputs, "users": users, "items": items, "weights": w,
            "reqs": reqs, "sample": sample}


def setup(run):
    from rankfm_tpu_torch import RankFM

    cfg, mix = run.config, run.traffic
    state = inputs_of(run)
    model = RankFM(**cfg["model"], seed=1, device=run.device)
    model.fit(**data.fit_args(state["inputs"]), epochs=mix["fit_epochs"])
    model._weights = state["weights"]
    state["model"] = model
    users, n_due = state["users"], len(state["reqs"])
    for k in range(mix["warmup"]):
        model.recommend(request_users(run.seed, n_due + k, users,
                                      mix["users_per_request"]),
                        n_items=mix["n_items"],
                        filter_previous=mix["filter_previous"])
    return state


def window(run, state):
    from torch.profiler import record_function

    mix, model = run.traffic, state["model"]
    rate, reqs = mix["rate_per_s"], state["reqs"]
    lat, late, kept, failed = [], [], {}, 0
    t0 = time.time()
    for k, users in enumerate(reqs):
        due = k / rate
        now = time.time() - t0
        if now < due:
            with record_function("fmbench.wait"):
                time.sleep(due - now)
            now = time.time() - t0
        late.append(now - due)
        try:
            with record_function("fmbench.recommend"):
                df = model.recommend(users, n_items=mix["n_items"],
                                     filter_previous=mix["filter_previous"])
        except (RuntimeError, ValueError, AssertionError) as e:
            failed += 1
            print(f"request {k} failed: {e!r}", flush=True)
            continue
        lat.append(time.time() - t0 - due)
        if k in state["sample"]:
            kept[k] = (users, df)
    wall = time.time() - t0
    return {"latency_s": np.array(lat), "late_s": np.array(late),
            "kept": kept, "wall_s": wall, "attempted": len(reqs),
            "failed": failed}


def catalog(run, state):
    inputs = state["inputs"]
    x_if = None
    if inputs["x_if"] is not None:
        x_if = inputs["x_if"][state["items"]]
    w = {k: v for k, v in state["weights"].items() if k != "v_uf"}
    if x_if is None:
        w = {k: w[k] for k in ("v_u", "v_i", "w_i")}
    return ref_serve.Catalog(state["users"], state["items"], w, x_if,
                             inputs["train"], run.device)


def judge(run, state, answers=None):
    """The numbers compared: ``bad_answers`` (list entries that name no
    item, an unknown or a seen item, or an item twice) and ``topk_gap`` (the
    largest score gap below the reference's list) over the sampled requests.
    ``answers`` (for the control and the planted faults) replaces the
    window's lists by ``{k: (users, lists)}``."""
    state.pop("model", None)
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    cat = catalog(run, state)
    kept = run.record["kept"] if answers is None else answers
    worst = {"bad_answers": 0.0, "topk_gap": 0.0}
    missing = len(state["sample"] - set(kept)) if answers is None else 0
    for users, lists in kept.values():
        if isinstance(lists, pd.DataFrame):
            # the lists come back indexed by the users asked for, in order
            if not np.array_equal(lists.index.values, users):
                worst["bad_answers"] += lists.size
                continue
            lists = lists.to_numpy(dtype=np.float64)
        g = ref_serve.judge(cat, users, lists)
        worst["bad_answers"] += g["bad_answers"]
        worst["topk_gap"] = max(worst["topk_gap"], g["topk_gap"])
    worst["bad_answers"] += missing * run.traffic["users_per_request"]
    state["readings"] = [f"judged {len(kept)} requests: {worst}"]
    return worst


def control(run, what):
    """The numbers compared with the reference's own lists in the program's
    place, scored with TF32 matrix products (``"tf32"``, the control: the
    precision below the float32 with TF32 off that the configurations
    state) or in bfloat16 (``"bf16"``); or with the program's lists of a
    window altered where they are produced: one item of each list replaced
    by its neighbour in the catalog (``"token"``), or half of each request's
    users left without a list (``"half"``)."""
    if what in ("tf32", "bf16"):
        state = inputs_of(run)
        run.record = {"kept": {}}
        cat = catalog(run, state)
        prec = ({"tf32": True} if what == "tf32"
                else {"dtype": torch.bfloat16})
        answers = {k: (state["reqs"][k],
                       ref_serve.lists(cat, state["reqs"][k],
                                       run.traffic["n_items"], **prec))
                   for k in sorted(state["sample"])}
        return judge(run, state, answers)
    state = setup(run)
    run.record = window(run, state)
    answers = {}
    for k, (users, df) in run.record["kept"].items():
        lists = df.to_numpy(dtype=np.float64, copy=True)
        if what == "token":
            pos = np.searchsorted(state["items"], lists[:, 0])
            lists[:, 0] = state["items"][(pos + 1) % len(state["items"])]
        elif what == "half":
            lists[::2] = np.nan
        else:
            raise ValueError(f"no fault {what!r} for a served model")
        answers[k] = (users, lists)
    return judge(run, state, answers)
