"""HIN dataset transform CLI of the port — the flags of
dualmessagepassing_tpu/cli/unc_transform.py (reference
Transform/transform.py) over the port's unc/transform.py.

Converts an HNE-style dataset directory (meta.dat, link.dat[,.test],
label.dat[,.test], node.dat) into the model input format (link.dat with
header + seed_node.dat). The reference takes ``-dataset``/``-model`` and
derives paths from its repo layout (transform.py:5-38,
transform_model.py:7); both shapes parse here — explicit
``--data_dir``/``--out_dir``, or the reference's single-dash
``-dataset``/``-model`` flags with the HNE folder layout (roots
overridable via --data_folder/--model_folder).

python -m dualmessagepassing_tpu_torch.cli.unc_transform \\
    --data_dir data/PubMed --out_dir Model/DMPNN/data/PubMed \\
    --attributed False --supervised False
"""

from __future__ import annotations

import argparse


def str2bool(x: str) -> bool:
    """utils/io.py:str2bool of the JAX package."""
    return x.lower() in ("true", "yes", "1")


def main(argv=None):
    from ..unc.transform import transform

    p = argparse.ArgumentParser("unc-transform")
    p.add_argument("--data_dir", type=str, default="",
                   help="HNE dataset dir containing meta.dat/link.dat/...")
    p.add_argument("--out_dir", type=str, default="")
    p.add_argument("--attributed", "-attributed", type=str2bool,
                   default=False)
    p.add_argument("--supervised", "-supervised", type=str2bool,
                   default=False)
    # reference-command compatibility (transform.py:8-15): derive the
    # directories from the HNE folder layout
    p.add_argument("-dataset", "--dataset", type=str, default="")
    p.add_argument("-model", "--model", type=str, default="")
    p.add_argument("--data_folder", type=str, default="../Data",
                   help="HNE layout root (the reference hardcodes ../Data)")
    p.add_argument("--model_folder", type=str, default="../Model")
    args = p.parse_args(argv)
    if not args.data_dir:
        if not args.dataset:
            p.error("--data_dir (or -dataset with -model) is required")
        args.data_dir = f"{args.data_folder}/{args.dataset}"
    if not args.out_dir:
        if not (args.dataset and args.model):
            p.error("--out_dir (or -dataset with -model) is required")
        args.out_dir = (f"{args.model_folder}/{args.model}/data/"
                        f"{args.dataset}")

    transform(args.data_dir, args.out_dir, attributed=args.attributed,
              supervised=args.supervised)
    print(f"transformed {args.data_dir} -> {args.out_dir}")


if __name__ == "__main__":
    main()
