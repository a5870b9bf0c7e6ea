"""SCM evaluation CLI of the port — dualmessagepassing_tpu/cli/
scm_evaluate.py (reference evaluate.py:44-245), on the card unless
--device cpu asks for the CPU.

Reads config.json and the best dev epoch from log.txt (utils/log.
get_best_epochs: a log either package wrote), restores that epoch's
checkpoint (train/checkpoint.restore_state) and runs evaluate_epoch over
train/dev/test, writing eval_{split}_results_{ts}.json into the run's
directory.

python -m dualmessagepassing_tpu_torch.cli.scm_evaluate --load_model_dir <dir>
"""

from __future__ import annotations

import argparse
import datetime
import os
from typing import Dict


def build_parser():
    parser = argparse.ArgumentParser("scm-evaluate")
    parser.add_argument("--load_model_dir", type=str, required=True)
    # optional overrides: evaluate the trained model on another dataset
    # (reference evaluate.py:44-77 takes the data dirs on its own command
    # line; the transfer setting — train small, evaluate large — needs them)
    parser.add_argument("--pattern_dir", type=str, default=None)
    parser.add_argument("--graph_dir", type=str, default=None)
    parser.add_argument("--metadata_dir", type=str, default=None)
    parser.add_argument("--save_data_dir", type=str, default=None)
    parser.add_argument("--eval_batch_size", type=int, default=None)
    parser.add_argument("--device", type=str, default="cuda",
                        help="torch device: cuda (with the run's --gpu_id) "
                             "or cpu")
    return parser


def main(argv=None) -> Dict[str, dict]:
    """Evaluate; -> {split: evaluate_epoch's results}."""
    from ..train.checkpoint import restore_state
    from ..train.samplers import BucketSampler
    from ..train.scm_driver import evaluate_epoch, make_eval_step
    from ..utils.io import load_config, save_results
    from ..utils.log import get_best_epochs, init_logger
    from .config import train_device
    from .scm_train import build_datasets, build_scm_model, transform_datasets

    args = build_parser().parse_args(argv)
    path = args.load_model_dir

    config = load_config(os.path.join(path, "config.json"))
    for key in ("pattern_dir", "graph_dir", "metadata_dir",
                "save_data_dir", "eval_batch_size", "device"):
        val = getattr(args, key)
        if val is not None:
            config[key] = val
    device = train_device(config)
    best = get_best_epochs(os.path.join(path, "log.txt"))
    metric = "eval-" + config["eval_metric"]
    epoch = best[metric]["dev"][0]

    logger = init_logger(os.path.join(path, "eval_log.txt"),
                         log_tag=config["rep_net"])
    logger.info(f"evaluating best dev epoch {epoch} on {device}")

    datasets = build_datasets(config, logger)
    # the JAX CLI's transforms here: no loop removal
    bounds = transform_datasets(datasets, config, remove_loops=False)
    model, _ = build_scm_model(config, bounds, device)
    restore_state(os.path.join(path, f"epoch{epoch}"), model)

    eval_step = make_eval_step(model)
    ts = datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")
    out = {}
    for split, ds in datasets.items():
        sampler = BucketSampler(ds.sizes(), ["g_len", "p_len"],
                                config["eval_batch_size"],
                                seed=config["seed"])
        res = evaluate_epoch(eval_step, ds, sampler,
                             return_weights=config["match_weights"])
        logger.info("%s: %s" % (
            split, "  ".join(f"{k}: {v:.6f}" for k, v in res.items()
                             if isinstance(v, float))))
        save_results(res, os.path.join(
            path, f"eval_{split}_results_{ts}.json"))
        out[split] = res
    return out


if __name__ == "__main__":
    main()
