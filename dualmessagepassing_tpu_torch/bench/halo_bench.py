"""Full-sum against owner-sharded (halo) exchange: the crossover study of
scripts/halo_bench.py on the port.

    python -m dualmessagepassing_tpu_torch.bench.halo_bench \
        [--v 100000] [--edges 1000000,4000000] [--h 64] [--layers 2] \
        [--iters 5] [--ranks 2] [--backend gloo|nccl] [--device cuda|cpu]

Runs both edge-partitioned DMP forwards over --ranks ranks
(parallel/dist.launch): parallel/edge_partition.py (the node table
replicated, one [V, H] sum over the ranks a layer) and parallel/halo.py
(owned node slices, one boundary exchange a layer), on a power-law graph
and on a community graph of --ranks communities, 95 % of its edges
inside one (data/synthetic.py), each with the range and the degree
partitioner. For each it first asserts that the halo forward equals the
full-sum forward (HALO_TOL), then prints one JSON line: the partition's
B_max, Vp and Ep, the two forwards' ms (rank 0, the mean of --iters
calls after one warm-up: CUDA events on the card, the host clock on the
CPU), their ratio, and each path's bytes a rank sends a layer (a ring
all-reduce's 2 V H 4, the exchange's n B H 4). max_err is the halo
forward's largest distance from the full sum, as a share of the output's
largest magnitude, the worst over the ranks.

The default device is the card, NCCL with rank r on cuda:r;
--backend gloo puts two ranks on one card (NCCL refuses that), and
--device cpu runs gloo ranks on the CPU. Ranks that share one card or
the CPU show the algorithm's traffic, not a scale-out speed. This is a
study; it writes no file.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Sequence

import numpy as np
import torch

from ..data.synthetic import generate_community_graph, generate_large_graph
from ..parallel.dist import (World, all_gather_rows, all_reduce_max, launch,
                             launch_plan, rank_threads)
from ..parallel.edge_partition import (edge_parallel_dmp_apply,
                                       init_edge_parallel_params,
                                       pad_to_multiple, shard_flat_edges)
from ..parallel.halo import (ARG_ORDER, build_halo_partition,
                             make_halo_dmp_apply, shard_halo_arrays)

# the halo forward against the full sum: float32 sums in another order
# (K3's atomics, the ranks' partial sums), a power-law hub summing ~2 %
# of the edges; within this share of each output's largest magnitude
HALO_TOL = 1e-4


def time_ms(fn: Callable, iters: int, device: torch.device) -> float:
    """Mean ms of fn over `iters` calls after one warm-up: CUDA events on
    a card, the host clock on the CPU."""
    fn()
    if device.type == "cuda":
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(iters):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / iters
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    return (time.perf_counter() - t0) / iters * 1e3


def _max_err(got: torch.Tensor, want: torch.Tensor, label: str) -> float:
    scale = max(float(want.abs().max()), 1e-30)
    err = float((got - want).abs().max()) / scale if got.numel() else 0.0
    if err > HALO_TOL:
        raise AssertionError(f"halo forward differs from the full sum: "
                             f"{label} at {err:.3e} of its largest "
                             f"magnitude (limit {HALO_TOL:g})")
    return err


def run(world: World, v: int = 100_000,
        edges: Sequence[int] = (1_000_000, 4_000_000), h: int = 64,
        layers: int = 2, iters: int = 5,
        print_fn: Callable[[str], None] = print) -> List[Dict]:
    """The study as one rank of `world` -> its records (rank 0's times;
    the other fields are the same on every rank). Rank 0 prints each
    record's JSON line with print_fn."""
    n, dev = world.size, world.device
    params = init_edge_parallel_params(layers, h, device=dev)
    records = []
    for e in edges:
        graphs = {
            "power_law": generate_large_graph(v, e, seed=0)[0],
            "community95": generate_community_graph(
                v, e, num_communities=n, p_intra=0.95, seed=0)[0],
        }
        for gname, trip in graphs.items():
            senders = trip[:, 0].astype(np.int32)
            receivers = trip[:, 2].astype(np.int32)
            rev = np.zeros(e, bool)
            rng = np.random.default_rng(1)
            node_feat = rng.normal(size=(v, h)).astype(np.float32)
            edge_feat = rng.normal(size=(e, h)).astype(np.float32)

            # the full-sum path
            arrays = pad_to_multiple({"senders": senders,
                                      "receivers": receivers,
                                      "rev_flag": rev}, n)
            ef = np.zeros((len(arrays["senders"]), h), np.float32)
            ef[:e] = edge_feat
            sh = shard_flat_edges(world, dict(arrays, edge_feat=ef), dev)
            x = torch.from_numpy(node_feat).to(dev)
            del ef

            def psum():
                return edge_parallel_dmp_apply(
                    params, x, sh["edge_feat"], sh["senders"],
                    sh["receivers"], sh["rev_flag"], sh["edge_mask"], v,
                    world)

            with torch.inference_mode():
                h_full, e_block = psum()
                # every rank's edge rows, to hold its halo edges against
                e_full = all_gather_rows(e_block, world)[:e]
                del e_block
                t_psum = time_ms(psum, iters, dev)

            # the halo path, both partitioners
            for method in ("range", "degree"):
                part = build_halo_partition(senders, receivers, rev, v, n,
                                            method=method)
                arrs = shard_halo_arrays(world, part, node_feat, edge_feat,
                                         dev)
                fwd = make_halo_dmp_apply(world, num_layers=layers)
                args = [arrs[k] for k in ARG_ORDER]
                with torch.inference_mode():
                    h_halo, e_halo = fwd(params, *args)
                    idx = torch.from_numpy(part["owned_slice"][world.rank]
                                           ).to(dev)
                    ok = idx >= 0
                    s = world.rank
                    off = int(part["edge_mask"][:s].sum())
                    k = int(part["edge_mask"][s].sum())
                    es = torch.from_numpy(
                        part["edge_perm"][off: off + k]).to(dev)
                    err = float(all_reduce_max(torch.tensor(max(
                        _max_err(h_halo[ok], h_full[idx[ok]],
                                 f"{gname} {method} node rows"),
                        _max_err(e_halo[:k], e_full[es],
                                 f"{gname} {method} edge rows")),
                        device=dev), world))
                    t_halo = time_ms(lambda: fwd(params, *args), iters, dev)
                # per-rank bytes sent a layer
                psum_bytes = 2 * v * h * 4            # ring all-reduce
                halo_bytes = n * part["B"] * h * 4    # the exchange
                rec = {
                    "V": v, "E": e, "graph": gname, "partition": method,
                    "ranks": n, "backend": world.backend,
                    "device": str(dev), "B_max": part["B"],
                    "Vp": part["Vp"], "Ep": part["Ep"],
                    "psum_ms": t_psum, "halo_ms": t_halo,
                    "speedup": t_psum / t_halo,
                    "psum_MB_per_layer": round(psum_bytes / 2 ** 20, 2),
                    "halo_MB_per_layer": round(halo_bytes / 2 ** 20, 2),
                    "traffic_ratio": round(psum_bytes / max(halo_bytes, 1),
                                           2),
                    "max_err": err,
                }
                records.append(rec)
                if world.rank == 0:
                    print_fn(json.dumps(rec))
                del arrs, args, h_halo, e_halo
            del sh, x, h_full, e_full
    return records


def main(argv=None) -> List[Dict]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--v", type=int, default=100_000)
    ap.add_argument("--edges", type=str, default="1000000,4000000")
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--ranks", type=int, default=2)
    ap.add_argument("--backend", type=str, default=None,
                    choices=(None, "gloo", "nccl"))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    if args.device != "cpu" and not torch.cuda.is_available():
        raise SystemExit("halo_bench: no CUDA device (pass --device cpu to "
                         "run on the CPU)")
    backend, devices = launch_plan(args.ranks, args.device, args.backend)
    edges = [int(x) for x in args.edges.split(",")]
    with tempfile.TemporaryDirectory() as tmp:
        return launch(run, args.ranks, backend=backend, devices=devices,
                      init_file=os.path.join(tmp, "rdv"),
                      args=(args.v, edges, args.h, args.layers, args.iters),
                      timeout=None, threads=rank_threads(devices))[0]


if __name__ == "__main__":
    main()
