"""Data-parallel and table-parallel placement on ``torch.distributed``
(port of `rankfm_tpu.parallel`): `init_distributed` and `make_mesh`, then
``RankFM(mesh=make_mesh(data, model))``. One process per device, every rank
calling the same methods on the same data."""

from rankfm_tpu_torch.parallel.mesh import (
    batch_sharding,
    init_distributed,
    make_mesh,
    weight_shardings,
)

__all__ = ["make_mesh", "weight_shardings", "batch_sharding",
           "init_distributed"]
