"""UNC training CLI of the port — the argparse surface of
dualmessagepassing_tpu/cli/unc_train.py (the reference Model/*/src/
main.py:221-304) over unc/driver.train_unc and train_unc_supervised:
every backbone (--model DMPNN|CompGCN|RGCN|RGIN), attributed inputs
(--attributed True with --node), supervised training (--supervised True
with --label; it exports the learned node table, as the JAX CLI does).

python -m dualmessagepassing_tpu_torch.cli.unc_train \
    --link data/link.dat --output emb.dat --model DMPNN \
    --n_hidden 50 --n_layers 2 --sampler randomwalk [--device cpu]

Every command line of the JAX CLI parses here unchanged. Supervised
training with attributed inputs is refused: it has no learned node table
to export (the JAX CLI fails there with a KeyError); so is
--checkpoint_dir with --supervised True, which the JAX CLI ignores.
The options of the JAX package's TPU kernel compositions
(--scatter_backend, --endpoint_gather, --pad_cols, --sender_windowed,
--recv_bcast) pick among lowerings that compute the same numbers as the
one composition the port has: any value is accepted and changes
nothing, with one log line each. --ep_devices N trains over N spawned
ranks (parallel/dist.launch), each of which builds the model from the
seed and calls unc/driver.train_unc(world=...): NCCL with rank r on
cuda:r, or gloo on the CPU with --device cpu; more ranks than visible
CUDA devices are refused. --ep_mode psum splits the edges and
replicates the node rows; --ep_mode halo owner-shards the node rows,
partitioned by --ep_partition (degree, range or bfs), and exchanges the
boundary rows each layer. Rank 0 logs, checkpoints and returns the
embeddings, which this process writes. Without --ep_devices, --ep_mode
halo and --ep_partition are logged no-ops (the JAX CLI ignores them
there too); so is --ep_partition under --ep_mode psum. Supervised
training stays on one device, as in the JAX CLI; there --ep_devices is
a logged no-op.
--device picks the torch device (default cuda); a machine without a GPU
trains only when asked to with --device cpu. --gpu is accepted for the
reference's command lines and not used.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time
from typing import List

# the JAX CLI's single-device lowering options and their defaults: any
# value computes the same numbers here (a no-op, logged)
_SAME_NUMBERS = {"scatter_backend": "xla", "endpoint_gather": "split",
                 "pad_cols": "auto", "sender_windowed": "auto",
                 "recv_bcast": "auto"}


def get_args(argv=None):
    p = argparse.ArgumentParser("unc-train")
    p.add_argument("--link", type=str, required=True)
    p.add_argument("--node", type=str, default="")
    p.add_argument("--label", type=str, default="")
    p.add_argument("--output", type=str, default="emb.dat")
    p.add_argument("--model", type=str, default="DMPNN",
                   choices=["DMPNN", "CompGCN", "RGCN", "RGIN"])
    p.add_argument("--supervised", type=str, default="False")
    p.add_argument("--attributed", type=str, default="False")
    p.add_argument("--n_hidden", "--n-hidden", type=int, default=50)
    p.add_argument("--n_layers", "--n-layers", type=int, default=2)
    p.add_argument("--lr", type=float, default=1e-2)
    p.add_argument("--regularization", type=float, default=1e-2)
    p.add_argument("--negative_sample", "--negative-sample", type=int, default=5)
    p.add_argument("--dropout", type=float, default=0.2)
    p.add_argument("--graph_batch_size", "--graph-batch-size", type=int, default=10000)
    p.add_argument("--label_batch_size", "--label-batch-size", type=int, default=512)
    p.add_argument("--graph_split_size", "--graph-split-size", type=float, default=0.5)
    p.add_argument("--sampler", type=str, default="randomwalk",
                   choices=["randomwalk", "neighbor"])
    p.add_argument("--sample_depth", "--sample-depth", type=int, default=3)
    p.add_argument("--sample_width", "--sample-width", type=int, default=10)
    p.add_argument("--n_epochs", "--n-epochs", type=int, default=50)
    p.add_argument("--grad_norm", "--grad-norm", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--gpu", type=int, default=-1,
                   help="accepted for reference compatibility; unused "
                        "(see --device)")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on: cuda, cuda:N or cpu")
    p.add_argument("--ep_devices", type=int, default=0,
                   help="edge-partitioned training over N ranks (0: one "
                        "device)")
    p.add_argument("--ep_mode", type=str, default="psum",
                   choices=["psum", "halo"],
                   help="node-state placement under --ep_devices: psum "
                        "replicates the node rows (edges split); halo "
                        "owner-shards them (boundary exchange)")
    p.add_argument("--scatter_backend", type=str, default="xla",
                   choices=["xla", "windowed"],
                   help="JAX package only; accepted and unused (the "
                        "port's aggregation always runs its CUDA "
                        "segment-sum)")
    p.add_argument("--ep_partition", type=str, default="degree",
                   choices=["degree", "range", "bfs"],
                   help="the halo mode's node partitioner (--ep_mode "
                        "halo with --ep_devices); bfs keeps neighbours "
                        "together, fewer boundary rows")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="save full training state (params/opt/BN/clocks/"
                        "sampling RNG) per epoch and resume from it when "
                        "present")
    p.add_argument("--amp", type=str, default="False",
                   help="bf16 backbone forward/backward with f32 master "
                        "params and f32 loss (utils/amp)")
    p.add_argument("--endpoint_gather", type=str, default="split",
                   choices=["split", "fused"],
                   help="JAX package only; accepted and unused")
    p.add_argument("--pad_cols", type=str, default="auto",
                   help="JAX package only; accepted and unused")
    p.add_argument("--sender_windowed", type=str, default="auto",
                   help="JAX package only; accepted and unused")
    p.add_argument("--recv_bcast", type=str, default="auto",
                   help="JAX package only; accepted and unused")
    return p.parse_args(argv)


def check_supported(args) -> List[str]:
    """Raise on what the port does not run; return one note per option
    that was set and changes nothing here (a JAX lowering option;
    --ep_devices under supervised training)."""
    if args.supervised == "True" and args.attributed == "True":
        raise NotImplementedError(
            "--supervised True exports the learned node table, which "
            "attributed inputs replace: there is nothing to export (the "
            "JAX package's CLI fails here with a KeyError)")
    if args.supervised == "True" and args.checkpoint_dir:
        raise ValueError("--checkpoint_dir applies to unsupervised "
                         "training only")
    if args.ep_devices < 0:
        raise ValueError(f"--ep_devices {args.ep_devices} < 0")
    notes = [f"--{name} {getattr(args, name)}: a lowering choice of the "
             "JAX package that computes the same numbers; the port runs "
             "its one composition" for name, default in _SAME_NUMBERS.items()
             if getattr(args, name) != default]
    sharded = bool(args.ep_devices) and args.supervised != "True"
    if args.ep_devices and not sharded:
        notes.append(f"--ep_devices {args.ep_devices}: supervised training "
                     "runs on one device (as in the JAX CLI); it does not "
                     "apply")
    elif sharded:
        from ..parallel.dist import launch_plan
        launch_plan(args.ep_devices, args.device)     # refuses too many
    if args.ep_mode == "halo" and not sharded:
        notes.append("--ep_mode halo: places node rows over the ranks of "
                     "--ep_devices; on one device it does not apply")
    if args.ep_partition != "degree" and not (
            sharded and args.ep_mode == "halo"):
        notes.append(f"--ep_partition {args.ep_partition}: the halo mode's "
                     "partitioner (--ep_mode halo with --ep_devices); it "
                     "does not apply")
    return notes


def log(msg: str) -> None:
    print(time.strftime("%a, %d %b %Y %H:%M:%S +0000: ") + msg, flush=True)


def build_model(args, device, n: int, r: int, **kw):
    """The UNCTrainModel of the command line, its weights drawn from
    --seed, on `device`."""
    import torch

    from ..unc.model import UNCTrainModel
    return UNCTrainModel(
        n, r, args.n_hidden, num_hidden_layers=args.n_layers,
        dropout=args.dropout, reg_param=args.regularization,
        generator=torch.Generator().manual_seed(args.seed),
        backbone=args.model, **kw).to(device)


def train_kw(args) -> dict:
    """train_unc's and train_unc_supervised's shared keywords."""
    return dict(
        lr=args.lr, graph_batch_size=args.graph_batch_size,
        graph_split_size=args.graph_split_size, sampler=args.sampler,
        sample_depth=args.sample_depth, sample_width=args.sample_width,
        n_epochs=args.n_epochs, grad_norm=args.grad_norm, seed=args.seed,
        amp=args.amp.lower() in ("true", "1"), log=log)


def unsupervised(args, triplets, n, r, attrs, seed_nodes, world=None):
    """train_unc over the loaded graph, as this rank of `world` where
    given -> the node embeddings (None on the ranks other than 0)."""
    from ..unc.driver import train_unc

    device = args.device if world is None else world.device
    model = build_model(args, device, n, r, node_attri=attrs)
    embs, _ = train_unc(
        model, triplets, n, r, negative_rate=args.negative_sample,
        seed_nodes=seed_nodes or None,
        checkpoint_dir=args.checkpoint_dir or None, world=world,
        ep_mode=args.ep_mode, ep_partition=args.ep_partition,
        **train_kw(args))
    return embs if world is None or world.rank == 0 else None


def _unsupervised_rank(world, *args):
    return unsupervised(*args, world=world)


def main(argv=None):
    import numpy as np
    import torch

    from ..parallel.dist import (CLI_COLLECTIVE_TIMEOUT, launch,
                                 launch_plan, rank_threads)
    from ..unc.data import (load_label, load_supervised, load_unsupervised,
                            save_embeddings)
    from ..unc.driver import train_unc_supervised

    args = get_args(argv)
    notes = check_supported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")

    for note in notes:
        log(note)
    log("start loading...")
    attributed = args.attributed == "True"
    seed_nodes = set()
    seed_path = (args.node.replace("node.dat", "seed_node.dat")
                 if args.node else
                 os.path.join(os.path.dirname(args.link), "seed_node.dat"))
    if os.path.exists(seed_path):
        seed_nodes = set(int(line) for line in open(seed_path))

    if args.supervised == "True":
        train_pool, train_labels, nlabels, multi = load_label(args.label)
        triplets, n, r, train_indices, _, _ = load_supervised(
            args.link, args.node, train_pool)
        log("finish loading...")
        model = build_model(args, device, n, r, nlabel=nlabels, multi=multi)
        train_unc_supervised(model, triplets, n, r, train_indices,
                             train_labels, multi=multi,
                             label_batch_size=args.label_batch_size,
                             **train_kw(args))
        embs = model.model.node_emb.detach().float().cpu().numpy()
    else:
        triplets, n, r, attrs = load_unsupervised(args.link, args.node,
                                                  attributed)
        log("finish loading...")
        job = (args, triplets, n, r, attrs, seed_nodes)
        if args.ep_devices:
            backend, devices = launch_plan(args.ep_devices, args.device)
            with tempfile.TemporaryDirectory() as tmp:
                embs = launch(_unsupervised_rank, args.ep_devices,
                              backend=backend, devices=devices,
                              init_file=os.path.join(tmp, "rendezvous"),
                              args=job, timeout=None,
                              collective_timeout=CLI_COLLECTIVE_TIMEOUT,
                              threads=rank_threads(devices))[0]
        else:
            embs = unsupervised(*job)

    log("start output...")
    header = str(vars(args))
    if seed_nodes:
        idx = np.asarray(sorted(seed_nodes))
        save_embeddings(args.output, header, embs[idx], index=idx)
    else:
        save_embeddings(args.output, header, embs)
    log("done")


if __name__ == "__main__":
    main()
