"""Scale-out of the port over torch.distributed
(dualmessagepassing_tpu/parallel/): process groups, the launcher and the
collectives (dist.py), data-parallel SCM training (dp.py),
edge-partitioned UNC training (ep_unc.py), owner-sharded (halo) UNC
training (halo_unc.py), and the JAX package's demonstration layer
(edge_partition.py) and halo library (halo.py), the bare DMP layer over
a full sum and over a halo exchange.

The names below are exported as the JAX package's parallel/__init__.py
exports them, where this package's idiom did not replace one:
  make_dp_mesh, batch_sharding, replicated -> dist.World (one rank of a
      process group; dist.launch spawns the ranks): each rank holds its
      own share of a batch (shard_batch) and a replicated copy of the
      weights (replicate), so there is no mesh or sharding object;
  make_edge_parallel_dmp_apply -> edge_parallel_dmp_apply, the forward
      itself, called on each rank with its World."""

from .dist import World, launch
from .dp import replicate, shard_batch
from .edge_partition import (edge_parallel_dmp_apply,
                             init_edge_parallel_params,
                             make_edge_parallel_train_step, pad_to_multiple,
                             params_from_jax, shard_flat_edges)
from .halo import (build_halo_partition, make_halo_dmp_apply,
                   shard_halo_arrays, unshard_nodes)

__all__ = ["World", "build_halo_partition", "edge_parallel_dmp_apply",
           "init_edge_parallel_params", "launch",
           "make_edge_parallel_train_step", "make_halo_dmp_apply",
           "pad_to_multiple", "params_from_jax", "replicate", "shard_batch",
           "shard_flat_edges", "shard_halo_arrays", "unshard_nodes"]
