"""UNC downstream evaluation CLI of the port — the flags, paths and
record format of dualmessagepassing_tpu/cli/unc_evaluate.py (reference
Evaluate/evaluate.py) over the port's unc/evaluate.py, which needs no
scikit-learn. Host code: it runs on the CPU wherever the port runs.

Evaluates saved embeddings (emb.dat) on node classification (5-fold
LinearSVC, single- or multi-label) and/or link prediction (AUC + MRR).
The reference hardcodes an HNE folder layout and keys multi-label on
dataset == Yelp (evaluate.py:8-28, node_classification.py:18-29); here
every file can be an explicit flag and multi-label is ``--multi True``.
The reference's own command shape also parses verbatim: ``--dataset`` /
``--model`` derive the HNE-layout default paths (evaluate.py:117-133,
overridable via --data_folder/--model_folder) and ``--dataset Yelp``
selects the multi-label protocol when --multi is left on auto.

python -m dualmessagepassing_tpu_torch.cli.unc_evaluate \\
    --task both --emb_file emb.dat --label_file label.dat \\
    --label_test_file label.dat.test --link_test_file link.dat.test
"""

from __future__ import annotations

import argparse


def main(argv=None):
    from ..unc.evaluate import load_emb_dict, lp_evaluate, nc_evaluate

    p = argparse.ArgumentParser("unc-evaluate")
    p.add_argument("--task", type=str, required=True,
                   choices=["nc", "lp", "both"])
    p.add_argument("--emb_file", type=str, default="")
    p.add_argument("--label_file", type=str, default="")
    p.add_argument("--label_test_file", type=str, default="")
    p.add_argument("--link_test_file", type=str, default="")
    # the reference restricts these to the literal strings True/False
    # (evaluate.py:36-42); free-form values used to fall through
    # str2bool to a silent False — a clean parser error beats that
    p.add_argument("--supervised", type=str, default="False",
                   choices=["True", "False"])
    p.add_argument("--multi", type=str, default="auto",
                   choices=["auto", "True", "False"],
                   help="multi-label nc (the reference's Yelp protocol); "
                        "auto = True iff --dataset Yelp")
    p.add_argument("--record_file", type=str, default="",
                   help="default with --dataset: "
                        "{data_folder}/{dataset}/record.dat, the "
                        "reference's path and multi-line text format "
                        "(evaluate.py:66-80)")
    # reference-command compatibility (evaluate.py:14-47): --dataset and
    # --model derive the HNE folder-layout default paths for any file
    # flag left empty
    p.add_argument("--dataset", type=str, default="")
    p.add_argument("--model", type=str, default="")
    p.add_argument("--attributed", type=str, default="False",
                   choices=["True", "False"],
                   help="accepted for reference-command compatibility "
                        "(recorded in --record_file lines only)")
    p.add_argument("--data_folder", type=str, default="../Data",
                   help="HNE layout root for --dataset-derived paths "
                        "(the reference hardcodes ../Data)")
    p.add_argument("--model_folder", type=str, default="../Model")
    args = p.parse_args(argv)
    args.supervised = args.supervised == "True"

    # HNE-layout path derivation (reference evaluate.py:117-133)
    if not args.emb_file:
        if args.dataset and args.model:
            args.emb_file = (f"{args.model_folder}/{args.model}/data/"
                             f"{args.dataset}/emb.dat")
        else:
            p.error("--emb_file (or --dataset with --model) is required")
    if args.dataset:
        if not args.label_file:
            args.label_file = f"{args.data_folder}/{args.dataset}/label.dat"
        if not args.label_test_file:
            args.label_test_file = (f"{args.data_folder}/{args.dataset}/"
                                    "label.dat.test")
        if not args.link_test_file:
            args.link_test_file = (f"{args.data_folder}/{args.dataset}/"
                                   "link.dat.test")
    # Yelp = multi-label single-class protocol (node_classification.py:18-29)
    args.multi = (args.dataset == "Yelp" if args.multi == "auto"
                  else args.multi == "True")
    if not args.record_file and args.dataset:
        # reference default record path (evaluate.py:7,68-71)
        args.record_file = f"{args.data_folder}/{args.dataset}/record.dat"

    emb_dict = load_emb_dict(args.emb_file)
    results = {}
    if args.task in ("nc", "both"):
        if not (args.label_file and args.label_test_file):
            p.error("nc requires --label_file and --label_test_file")
        macro, micro = nc_evaluate(args.label_file, args.label_test_file,
                                   emb_dict, supervised=args.supervised,
                                   multi=args.multi)
        results["nc"] = {"Macro-F1": macro, "Micro-F1": micro}
        print(f"Macro-F1={macro:.4f}, Micro-F1={micro:.4f}")
    if args.task in ("lp", "both"):
        if not args.link_test_file:
            p.error("lp requires --link_test_file")
        auc, mrr = lp_evaluate(args.link_test_file, emb_dict)
        results["lp"] = {"AUC": auc, "MRR": mrr}
        print(f"AUC={auc:.4f}, MRR={mrr:.4f}")
    if args.record_file:
        # byte-compatible with the reference's record() (evaluate.py:
        # 66-80): one 4-line block per task — header, the emb.dat
        # training-parameter line, the scores line, a blank line
        try:
            with open(args.emb_file) as f:
                train_para = f.readline().rstrip("\n")
        except OSError:
            train_para = ""
        try:
            with open(args.record_file, "a") as f:
                for task, scores in results.items():
                    f.write(f"model={args.model}, task={task}, "
                            f"attributed={args.attributed}, "
                            f"supervised={args.supervised}\n")
                    f.write(f"{train_para}\n")
                    if task == "nc":
                        f.write(f"Macro-F1={scores['Macro-F1']:.4f}, "
                                f"Micro-F1={scores['Micro-F1']:.4f}\n")
                    else:
                        f.write(f"AUC={scores['AUC']:.4f}, "
                                f"MRR={scores['MRR']:.4f}\n")
                    f.write("\n")
        except OSError as e:
            # the DEFAULT path is derived from --dataset (reference
            # layout); a missing ../Data/{dataset}/ dir shouldn't void
            # an eval that already printed its scores
            print(f"record skipped ({e})")
    return results


if __name__ == "__main__":
    main()
