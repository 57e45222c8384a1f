"""Several devices: the mesh and its shardings, corpus-sharded retrieval
(the port of the JAX package's ``parallel``)."""
from tvretrieval_tpu_torch.parallel.mesh import (
    make_mesh,
    batch_sharding,
    replicate_sharding,
    shard_batch,
)

__all__ = ["make_mesh", "batch_sharding", "replicate_sharding", "shard_batch"]
