"""Scale-out of the port over torch.distributed
(dualmessagepassing_tpu/parallel/): process groups, the launcher and the
sums over ranks (dist.py), data-parallel SCM training (dp.py) and
edge-partitioned UNC training (ep_unc.py). The JAX package's
owner-sharded halo mode (halo.py, halo_unc.py) and its demonstration
layer (edge_partition.py) are not ported yet."""
