"""`examples/mesh_training.py` on the PyTorch + CUDA port: the same model
code on a ``(data, model)`` mesh of two ranks, in both placement regimes.

`rankfm_tpu_torch.parallel` runs one process per device, every rank calling
the same methods on the same data:

* **DP** (tables fit per card — the common case): tables replicate, the
  batch shards over every mesh axis, one all-reduce of the weight deltas
  per sync group. The per-rank step is the fused CUDA kernel itself.
* **TP** (tables beyond ``parallel.train.DP_TABLE_BYTES`` per card):
  tables row-shard over ``model``; lookups are owner-masked gathers and
  one all-reduce per lookup group, update payloads all-gather over
  ``data``.

This script spawns the two ranks with `torch.multiprocessing`: one card
each over NCCL when the machine has two, else both on ``cuda:0`` over gloo
(NCCL refuses two ranks on one device). Under ``torchrun`` a program calls
``init_distributed()`` and ``make_mesh(...)`` with no addresses instead.

Run from the repository root: PYTHONPATH=. python examples/torch/mesh_training.py
"""

import socket
import time

import numpy as np
import pandas as pd
import torch

WORLD = 2


def make_log(rng, n_users=2000, n_items=1200, per_user=40):
    """implicit log with two planted taste groups"""
    rows = []
    for u in range(n_users):
        grp = u % 2
        pool = np.arange(grp * n_items // 2, (grp + 1) * n_items // 2)
        items = rng.choice(pool, per_user, replace=False)
        rows.extend((u, it) for it in items)
    return pd.DataFrame(rows, columns=["user_id", "item_id"])


def rank_main(rank, address, devices, backend):
    """One rank: every rank makes the same data and the same calls; rank 0
    prints."""
    from rankfm_tpu_torch import RankFM, evaluation
    from rankfm_tpu_torch.parallel import init_distributed, make_mesh
    import rankfm_tpu_torch.parallel.train as ptrain

    init_distributed(init_method=address, world_size=WORLD, rank=rank,
                     backend=backend)
    say = print if rank == 0 else (lambda *a, **k: None)
    rng = np.random.default_rng(1492)
    df = make_log(rng)
    train = df.sample(frac=0.75, random_state=0)
    test = df.drop(train.index)
    say(f"ranks: {WORLD} on {devices} over {backend}  "
        f"train={len(train)} test={len(test)}")

    mesh = make_mesh(data=max(1, WORLD // 2), model=min(2, WORLD),
                     device=devices[rank], backend=backend)

    # ---- DP regime (default: these tables easily fit per card) ----
    m = RankFM(factors=16, loss="warp", max_samples=10, learning_rate=0.1,
               learning_schedule="invscaling", mesh=mesh)
    t0 = time.time()
    m.fit(train, epochs=10)
    hr = evaluation.hit_rate(m, test, k=10)
    say(f"DP mesh fit: {time.time() - t0:.1f}s  hit_rate@10={hr:.3f}  "
        f"(placement {m.last_fit_plan_.placement})")

    # ---- TP regime (forced here; auto-selected when the weights exceed
    # parallel.train.DP_TABLE_BYTES) ----
    saved = ptrain.DP_TABLE_BYTES
    ptrain.DP_TABLE_BYTES = 0
    try:
        m2 = RankFM(factors=16, loss="warp", max_samples=10,
                    learning_rate=0.1, learning_schedule="invscaling",
                    mesh=mesh, train_step="candidate")
        t0 = time.time()
        m2.fit(train, epochs=10)
        hr2 = evaluation.hit_rate(m2, test, k=10)
        say(f"TP mesh fit: {time.time() - t0:.1f}s  hit_rate@10={hr2:.3f}  "
            f"(placement {m2.last_fit_plan_.placement})")
    finally:
        ptrain.DP_TABLE_BYTES = saved

    # sharded retrieval rides the same mesh
    recs = m.recommend(train["user_id"].unique()[:5], n_items=5,
                       filter_previous=True)
    say("sample recommendations:")
    say(recs)
    torch.distributed.destroy_process_group()


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def main(devices=None, backend=None):
    """Spawn the ranks: one card each over NCCL when the machine has two,
    else both on ``cuda:0`` over gloo (``devices`` / ``backend`` override,
    e.g. ``["cpu", "cpu"], "gloo"``)."""
    if devices is None:
        if torch.cuda.device_count() >= WORLD:
            devices, backend = [f"cuda:{r}" for r in range(WORLD)], "nccl"
        else:
            devices, backend = ["cuda:0"] * WORLD, "gloo"
    address = f"tcp://127.0.0.1:{free_port()}"
    torch.multiprocessing.start_processes(
        rank_main, args=(address, devices, backend), nprocs=WORLD,
        join=True, start_method="spawn")


if __name__ == "__main__":
    main()
