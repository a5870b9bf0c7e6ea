"""UNC training CLI of the port — the argparse surface of
dualmessagepassing_tpu/cli/unc_train.py (the reference Model/*/src/
main.py:221-304) over unc/driver.train_unc, unsupervised DMPNN only.

python -m dualmessagepassing_tpu_torch.cli.unc_train \
    --link data/link.dat --output emb.dat --model DMPNN \
    --n_hidden 50 --n_layers 2 --sampler randomwalk [--device cpu]

Every command line of the JAX CLI parses here unchanged. The options of
the JAX package's sharded and TPU kernel compositions (--ep_devices,
--ep_mode, --ep_partition, --scatter_backend, --endpoint_gather,
--pad_cols, --sender_windowed, --recv_bcast) have no counterpart: each
choice among them computes the same numbers as the one composition the
port has, so their defaults are accepted and any other value is refused.
--device picks the torch device (default cuda); a machine without a GPU
trains only when asked to with --device cpu. --gpu is accepted for the
reference's command lines and not used.
"""

from __future__ import annotations

import argparse
import os
import time

# the JAX CLI's TPU-only options and the only values the port accepts
_NO_COUNTERPART = {"ep_devices": 0, "ep_mode": "psum",
                   "ep_partition": "degree", "scatter_backend": "xla",
                   "endpoint_gather": "split", "pad_cols": "auto",
                   "sender_windowed": "auto", "recv_bcast": "auto"}


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
                   help="JAX package only; the port accepts 0")
    p.add_argument("--ep_mode", type=str, default="psum",
                   choices=["psum", "halo"],
                   help="JAX package only; the port accepts psum")
    p.add_argument("--scatter_backend", type=str, default="xla",
                   choices=["xla", "windowed"],
                   help="JAX package only; the port accepts xla (its "
                        "aggregation always runs the CUDA segment-sum)")
    p.add_argument("--ep_partition", type=str, default="degree",
                   choices=["degree", "range", "bfs"],
                   help="JAX package only; the port accepts degree")
    p.add_argument("--checkpoint_dir", type=str, default="",
                   help="save full training state (params/opt/BN/clocks/"
                        "sampling RNG) per epoch and resume from it when "
                        "present")
    p.add_argument("--amp", type=str, default="False",
                   help="bf16 backbone forward/backward with f32 master "
                        "params and f32 loss (utils/amp)")
    p.add_argument("--endpoint_gather", type=str, default="split",
                   choices=["split", "fused"],
                   help="JAX package only; the port accepts split")
    p.add_argument("--pad_cols", type=str, default="auto",
                   help="JAX package only; the port accepts auto")
    p.add_argument("--sender_windowed", type=str, default="auto",
                   help="JAX package only; the port accepts auto")
    p.add_argument("--recv_bcast", type=str, default="auto",
                   help="JAX package only; the port accepts auto")
    return p.parse_args(argv)


def check_supported(args) -> None:
    """Raise on what the port does not run (yet)."""
    if args.supervised == "True":
        raise NotImplementedError(
            "supervised UNC training is not ported yet (ROADMAP.md slice "
            "B1)")
    if args.model != "DMPNN":
        raise NotImplementedError(
            f"--model {args.model} is not ported yet (ROADMAP.md slice B2)")
    if args.attributed == "True":
        raise NotImplementedError(
            "attributed node inputs are not ported yet (ROADMAP.md slice "
            "A, the _input_embeddings branches)")
    for name, accepted in _NO_COUNTERPART.items():
        if getattr(args, name) != accepted:
            raise ValueError(
                f"--{name} {getattr(args, name)}: the JAX package's option "
                f"has no counterpart in the port, which accepts only "
                f"{accepted!r}")


def main(argv=None):
    import numpy as np
    import torch

    from ..unc.data import load_unsupervised, save_embeddings
    from ..unc.driver import train_unc
    from ..unc.model import UNCTrainModel

    args = get_args(argv)
    check_supported(args)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to train on "
                           "the CPU")

    def log(msg):
        print(time.strftime("%a, %d %b %Y %H:%M:%S +0000: ") + msg,
              flush=True)

    log("start loading...")
    seed_nodes = set()
    seed_path = (args.node.replace("node.dat", "seed_node.dat")
                 if args.node else
                 os.path.join(os.path.dirname(args.link), "seed_node.dat"))
    if os.path.exists(seed_path):
        seed_nodes = set(int(line) for line in open(seed_path))
    triplets, n, r, _ = load_unsupervised(args.link)
    log("finish loading...")
    model = UNCTrainModel(
        n, r, args.n_hidden, num_hidden_layers=args.n_layers,
        dropout=args.dropout, reg_param=args.regularization,
        generator=torch.Generator().manual_seed(args.seed)).to(device)
    embs, _ = train_unc(
        model, triplets, n, r, lr=args.lr,
        negative_rate=args.negative_sample,
        graph_batch_size=args.graph_batch_size,
        graph_split_size=args.graph_split_size, sampler=args.sampler,
        sample_depth=args.sample_depth, sample_width=args.sample_width,
        n_epochs=args.n_epochs, grad_norm=args.grad_norm,
        seed_nodes=seed_nodes or None, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir or None,
        amp=args.amp.lower() in ("true", "1"), log=log)

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
