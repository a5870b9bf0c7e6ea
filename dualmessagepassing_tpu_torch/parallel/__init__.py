"""Scale-out of the port over torch.distributed
(dualmessagepassing_tpu/parallel/): process groups, the launcher and the
collectives (dist.py), data-parallel SCM training (dp.py),
edge-partitioned UNC training (ep_unc.py) and owner-sharded (halo) UNC
training (halo_unc.py). The JAX package's demonstration layer
(edge_partition.py) and its halo library helpers (halo.py) are not
ported yet."""
