"""rankfm_tpu_torch — the PyTorch + CUDA port of `rankfm_tpu`.

Factorization Machines for implicit-feedback ranking trained with pairwise
BPR/WARP loss, plus top-N retrieval, similarity search and offline ranking
evaluation, with the same public API as `rankfm_tpu`:

    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch import evaluation

    model = RankFM(factors=20, loss='warp', device='cuda').fit(train, epochs=20)

Training runs the engines of `rankfm_tpu` as its planner resolves them: the
fused WARP/BPR engine, whose chunk step on CUDA tensors is the hand-written
Hopper kernel in ``csrc/fused_chunk.cu``, and the window and candidate
steps, whose table update is ``csrc/table_update.cu``; on CPU tensors each
is its plain PyTorch version. Around them, the host half of `rankfm_tpu`:

* ``native``: the C++ ingest for integer ids, built with g++ at first use
  (the numpy / pandas paths give the same arrays without it);
* ``model.last_fit_timing_``, and a ``fit_partial`` on the same interactions
  that reuses the history and the record layouts of the call before;
* ``model.save(path)`` / ``RankFM.load(path, device='cuda')``: the JAX
  package's pickle-free ``.npz``, readable by either package;
* ``baselines.ImplicitALS`` and ``utils.observe`` (``trace``, ``span``,
  ``device_memory_stats``): under ``observe.trace(dir)`` (or any
  ``torch.profiler`` trace) each fit and request shows as a
  ``rankfm.fit`` / ``rankfm.recommend`` range holding one range per phase
  (ingest, layouts, each engine's epochs, graph captures and replays; id
  map, scoring, the wait for the card, the DataFrame), beside the card's
  kernels when the trace is opened in Perfetto; with no profiler
  recording, a span costs one flag check;
* ``parallel``: ``init_distributed`` and ``make_mesh`` on
  ``torch.distributed``, then ``RankFM(mesh=...)`` on every rank: the
  data-parallel and table-parallel placements and sharded retrieval.

This package imports ``torch`` and never ``jax``.
"""

from rankfm_tpu_torch.models.rankfm import RankFM
from rankfm_tpu_torch import evaluation

__version__ = "0.5.0"

__all__ = ["RankFM", "evaluation", "__version__"]
