"""rankfm_tpu_torch — the PyTorch + CUDA port of `rankfm_tpu`.

Factorization Machines for implicit-feedback ranking trained with pairwise
BPR/WARP loss, plus top-N retrieval, similarity search and offline ranking
evaluation, with the same public API as `rankfm_tpu`:

    from rankfm_tpu_torch import RankFM
    from rankfm_tpu_torch import evaluation

    model = RankFM(factors=20, loss='warp', device='cuda').fit(train, epochs=20)

Training runs the fused WARP/BPR engine: on CUDA tensors its chunk step is
the hand-written Hopper kernel in ``csrc/fused_chunk.cu``; on CPU tensors it
is the kernel's plain PyTorch version. This package imports ``torch`` and
never ``jax``.
"""

from rankfm_tpu_torch.models.rankfm import RankFM
from rankfm_tpu_torch import evaluation

__version__ = "0.5.0"

__all__ = ["RankFM", "evaluation", "__version__"]
