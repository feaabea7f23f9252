from diffphycon_tpu_torch.parallel.mesh import (
    Mesh,
    gather_batch,
    make_mesh,
    replicate,
    sample_sharded,
    shard_batch,
)

__all__ = ["Mesh", "gather_batch", "make_mesh", "replicate", "sample_sharded",
           "shard_batch"]
