"""The JAX package's examples (examples/*.py), one module each, run as

    python -m dualmessagepassing_tpu_torch.examples.<name> [--device cpu]

  quickstart_scm      build a DMPNN counting model, one forward and one
                      AdamW step on a synthetic pattern/graph batch;
  multichip_dp        that step data-parallel over ranks: the batch split
                      over the ranks, the weights replicated, the
                      gradients summed over the ranks;
  edge_parallel       the edge-partitioned demonstration layer: edges and
                      the edge stream split over the ranks, one sum over
                      the ranks a layer;
  performance_levers  the SCM step under amp bf16 in 4 microbatches, and
                      train_unc owner-sharded (halo, bfs partition, amp)
                      over ranks and on one device.

Each main takes the device (the card by default; --device cpu runs on
the CPU, ranks over gloo) and returns the numbers it prints. The ranks
of multichip_dp, edge_parallel and performance_levers are spawned
processes (parallel/dist.launch): NCCL with rank r on cuda:r, or gloo
(--backend gloo, ranks may share a card; the only backend on the CPU).
"""
