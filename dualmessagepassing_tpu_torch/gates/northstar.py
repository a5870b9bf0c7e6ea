"""The north-star pipeline through the port: scripts/northstar_train.py
(run 61-257, main 260-290) over the owner-sharded halo mode of
parallel/halo_unc.py, on the card unless --cpu asks for the CPU.

Each of `shards` ranks (parallel/dist.launch) runs the composed UNC
pipeline on the same data: a power-law graph from generate_large_graph,
its WholeGraph, random-walk and negative sampling in prefetch threads
that also build the rank's halo partition and its K1/K2 plans, then
`steps` amp bf16 halo train steps of the UNC DMPNN, with a full-state
checkpoint (train/checkpoint.py: parameters, BatchNorm statistics,
optimizer state, clocks, sampling RNG) written by rank 0 and restored
by every rank mid-run, training going on from the restored state. Rank
0's result has the JAX run()'s keys; the gate (tests/test_northstar.py's
asserts) is that the losses are finite, that the mean of the last half
is below the first and the last below the first, and that the
checkpoint round trip is verified.

python -m dualmessagepassing_tpu_torch.gates.northstar \\
    --v 2000 --e 40000 --steps 6 --shards 2 --batch 400 --depth 2 \\
    --width 6 [--cpu]

Ranks: NCCL with rank r on cuda:r (launch_plan: one card a rank), or
gloo on the CPU with --cpu; run(..., backend="gloo", devices=["cuda:0"]
* 2) puts two gloo ranks on one card. The JAX script's r5_kernels, a
TPU lowering, has no counterpart; "backend" names the route the
aggregation took, "cuda" where the steps launched the port's kernels
and "plain" where they ran its plain versions (on the CPU).
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Optional, Sequence

import numpy as np

# the JAX script's run() defaults, which no caller changes
SEED, NEGATIVE_RATE, PREFETCH, LR = 0, 5, 2, 1e-2


def _quiet(msg: str) -> None:
    """The log of the ranks other than 0, and of a run without one."""


def _rank(world, cfg: dict, ckpt_dir: str) -> dict:
    """One rank of the pipeline -> its result (run's keys)."""
    import torch

    from ..data.synthetic import generate_large_graph
    from ..ops import segment_kernel as sk
    from ..ops.build import build_cuda_kernels
    from ..parallel.dist import same_on_all_ranks
    from ..parallel.dp import replicate
    from ..parallel.halo_unc import (halo_envelope, halo_rank_shard,
                                     make_halo_train_step)
    from ..train.checkpoint import restore_unc_checkpoint, save_unc_checkpoint
    from ..unc.data import WholeGraph
    from ..unc.driver import make_unc_optimizer, sample_batch, to_device
    from ..unc.model import UNCTrainModel

    log = cfg["log"] if world.rank == 0 and cfg["log"] else _quiet
    seed, neg = SEED, NEGATIVE_RATE
    batch, depth, width = cfg["batch"], cfg["depth"], cfg["width"]
    v, steps = cfg["v"], cfg["steps"]
    dev = world.device
    t0 = time.perf_counter()
    compile_s = 0.0
    if dev.type == "cuda":
        compile_s = build_cuda_kernels()
    rng = np.random.default_rng(seed)
    triplets, _ = generate_large_graph(v, cfg["e"], num_rels=4, seed=seed,
                                       power_law=True)
    graph = WholeGraph(v, 4, triplets)
    log(f"graph: {v} nodes, {graph.num_edges} directed edges, "
        f"{time.perf_counter() - t0:.1f} s")

    s_max = batch * (1 + neg)
    v_max = v
    # the edge envelope from the first sampled batch, 1.25x and 4,096 of
    # slack (northstar_train.py:127-145)
    first = sample_batch(graph, triplets[rng.integers(0, len(triplets),
                                                       batch)],
                         "randomwalk", depth, width, 0.5, neg, v_max,
                         min(v_max * width, graph.num_edges), s_max, rng)
    sampled_v = int(first["node_mask"].sum())
    sampled_e = int(first["edge_mask"].sum())
    e_max = min(int(1.25 * sampled_e) + 4096,
                min(v_max * width, graph.num_edges))
    envelope = halo_envelope(v_max, e_max, world.size)
    log(f"first sample: {sampled_v} V / {sampled_e} E; envelope v_max="
        f"{v_max} e_max={e_max} (per rank Vp, Ep, B = {envelope})")

    model = UNCTrainModel(
        v, 4, cfg["h_dim"], num_hidden_layers=cfg["layers"], dropout=0.2,
        reg_param=0.01, generator=torch.Generator().manual_seed(seed),
        backbone="DMPNN").to(dev)
    replicate(world, model.state_dict().values())
    optimizer = make_unc_optimizer(model, LR, steps)
    dropout_gen = torch.Generator(device=dev).manual_seed(seed)
    step = make_halo_train_step(model, optimizer, world, amp=cfg["amp"],
                                generator=dropout_gen)

    def sample_one(brng):
        t = time.perf_counter()
        edges = triplets[brng.integers(0, len(triplets), batch)]
        padded = sample_batch(graph, edges, "randomwalk", depth, width, 0.5,
                              neg, v_max, e_max, s_max, brng)
        shard, _ = halo_rank_shard(padded, world, envelope,
                                   cfg["partition"], sender_plan=True)
        return (shard, int(padded["node_mask"].sum()),
                int(padded["edge_mask"].sum())), time.perf_counter() - t

    if not same_on_all_ranks(int(np.dot(first["receivers"], np.arange(
            len(first["receivers"])) % 65521)), world):
        raise RuntimeError("the ranks sampled different batches from the "
                           "same seed")

    losses, step_s = [], []
    blocked_s = sample_s = 0.0
    ckpt_verified = False
    ckpt_at = steps // 2
    path = os.path.join(ckpt_dir, "mid")
    child_rngs = rng.spawn(steps)
    window = 2 * PREFETCH
    sk.reset_launch_counts()
    with ThreadPoolExecutor(max_workers=PREFETCH) as pool:
        futures = {i: pool.submit(sample_one, child_rngs[i])
                   for i in range(min(window, steps))}
        for k in range(steps):
            t_wait = time.perf_counter()
            (shard, nv, ne), s_time = futures.pop(k).result()
            blocked_s += time.perf_counter() - t_wait
            sample_s += s_time
            if k + window < steps:
                futures[k + window] = pool.submit(sample_one,
                                                  child_rngs[k + window])
            sub = to_device(shard, dev)
            t_step = time.perf_counter()
            loss = float(step(sub))                   # syncs the device
            step_s.append(time.perf_counter() - t_step)
            losses.append(loss)
            log(f"step {k:03d} | loss {loss:.4f} | {nv} V / {ne} E | "
                f"step {step_s[-1]:.3f} s")
            if k == ckpt_at:
                # the full state written by rank 0, restored by every rank,
                # and training goes on from the restored state
                saved = {n: t.detach().cpu().clone()
                         for n, t in model.state_dict().items()}
                count = optimizer.count
                if world.rank == 0:
                    save_unc_checkpoint(path, model, optimizer,
                                        {"step": k}, rng, dropout_gen)
                torch.distributed.barrier()
                clocks = restore_unc_checkpoint(path, model, optimizer,
                                                dropout_gen)
                ok = (int(clocks["step"]) == k and optimizer.count == count
                      and all(torch.equal(saved[n], t.detach().cpu())
                              for n, t in model.state_dict().items()))
                ckpt_verified = same_on_all_ranks(int(ok), world) and ok
                log(f"checkpoint saved and restored at step {k} "
                    f"(verified={ckpt_verified})")

    overlap = 1.0 - blocked_s / max(sample_s, 1e-9)
    half = max(len(losses) // 2, 1)
    vp, ep, b = envelope
    return {
        "metric": "northstar_halo_train_loss",
        "value": round(losses[-1], 4),
        "unit": "bce+reg",
        "graph_v": v, "graph_e_directed": graph.num_edges,
        "sampled_v": sampled_v, "sampled_e": sampled_e,
        "envelope": {"v_max": v_max, "e_max": e_max, "vp": vp, "ep": ep,
                     "b": b},
        "shards": world.size,
        "backend": "cuda" if any(sk.LAUNCHES.values()) else "plain",
        "amp": cfg["amp"],
        "partition": cfg["partition"], "steps": steps,
        "losses": [round(x, 4) for x in losses],
        "loss_first": round(losses[0], 4),
        "loss_last_half_mean": round(sum(losses[half:])
                                     / max(len(losses) - half, 1), 4),
        "loss_decreased": losses[-1] < losses[0],
        "checkpoint_verified": ckpt_verified,
        "compile_s": round(compile_s, 1),
        "step_s_avg": round(sum(step_s) / max(len(step_s), 1), 4),
        "sample_s_avg": round(sample_s / max(steps, 1), 4),
        "sample_overlap_fraction": round(max(overlap, 0.0), 3),
        "platform": dev.type,
        "collectives": world.backend,
        # K1's and K2's launches over the steps (none on the CPU)
        "launches": dict(sk.LAUNCHES),
    }


def run(v: int, e: int, steps: int, shards: int, batch: int = 10_000,
        depth: int = 3, width: int = 10, h_dim: int = 50, layers: int = 2,
        amp: bool = True, partition: str = "degree", log=print,
        device: str = "cuda", backend: Optional[str] = None,
        devices: Optional[Sequence[str]] = None,
        timeout: Optional[float] = 3600.0) -> dict:
    """The pipeline over `shards` spawned ranks -> rank 0's result.
    backend and devices default to parallel/dist.launch_plan(shards,
    device); `log` (None: silent) is called in rank 0's process, so it
    must pickle (print, or a function of a module)."""
    from ..parallel.dist import launch, launch_plan, rank_threads

    if backend is None or devices is None:
        backend, devices = launch_plan(shards, device)
    cfg = dict(v=v, e=e, steps=steps, batch=batch, depth=depth, width=width,
               h_dim=h_dim, layers=layers, amp=bool(amp),
               partition=partition, log=log)
    with tempfile.TemporaryDirectory(prefix="northstar_") as tmp:
        return launch(_rank, shards, backend=backend, devices=devices,
                      init_file=os.path.join(tmp, "rendezvous"),
                      args=(cfg, tmp), timeout=timeout,
                      threads=rank_threads(devices))[0]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--v", type=int, default=1_000_000)
    ap.add_argument("--e", type=int, default=100_000_000)
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--batch", type=int, default=10_000)
    ap.add_argument("--depth", type=int, default=3)
    ap.add_argument("--width", type=int, default=10)
    ap.add_argument("--h-dim", type=int, default=50)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--amp", type=int, default=1)
    ap.add_argument("--partition", default="degree",
                    choices=["degree", "range", "bfs"])
    ap.add_argument("--cpu", action="store_true",
                    help="gloo ranks on the CPU (default: one card a rank)")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args(argv)
    result = run(args.v, args.e, args.steps, args.shards, batch=args.batch,
                 depth=args.depth, width=args.width, h_dim=args.h_dim,
                 layers=args.layers, amp=bool(args.amp),
                 partition=args.partition,
                 device="cpu" if args.cpu else "cuda")
    line = json.dumps(result)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return result


if __name__ == "__main__":
    main()
