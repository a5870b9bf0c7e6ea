"""SCM training CLI of the port — dualmessagepassing_tpu/cli/scm_train.py
(the reference train.py main loop, train.py:1064-1398) over
train/scm_driver.py, on the card unless --device cpu asks for the CPU.

python -m dualmessagepassing_tpu_torch.cli.scm_train --synthetic True ...
python -m dualmessagepassing_tpu_torch.cli.scm_train --pattern_dir ... \\
    --graph_dir ... --metadata_dir ... --rep_net DMPNN --match_weights node

The loop is the JAX CLI's: per-epoch curriculum training split,
bucketed dev/test evaluation, results JSONs, best-epoch checkpoints
(train/checkpoint.save_state into epoch{N}/), early stop when both the
train loss and the dev metric stall; finetuning from --load_model_dir
(the best dev epoch of that run, expanded onto this run's vocabulary);
--train_grad_steps k as optax.MultiSteps (train/scm_driver.MultiSteps).
Its flags are cli/config.py's. As in the JAX CLI, the config that
train_epoch reads has no pred_return_weights key, so the train batches
carry no gold node/edge weights and the matching losses train toward
zeros; the dev/test batches carry the --match_weights targets.

The dataset cache in --save_data_dir holds the same pickles as the JAX
CLI's, so each package reads the other's. --profile_dir writes a
torch.profiler trace of epoch 0 (epoch0_trace.json).
"""

from __future__ import annotations

import contextlib
import datetime
import logging
import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..data.dataset import CollateView, GraphAdjDataset, collate_kind_for
from ..data.synthetic import generate_dataset
from ..graph import single_graph
from ..parallel.dist import (CLI_COLLECTIVE_TIMEOUT, broadcast_object,
                             launch, launch_plan, rank_threads)
from ..utils.io import load_data

SPLITS = ("train", "dev", "test")


def build_datasets(config, logger) -> Dict[str, CollateView]:
    """{train, dev, test} CollateViews: from the cache in save_data_dir
    when all three pickles are there, else a synthetic ER set
    (--synthetic) or the reference-format data (utils/io.load_data), then
    cached to save_data_dir if one is given."""
    cache_dir = config.get("save_data_dir")
    if cache_dir and all(os.path.exists(
            os.path.join(cache_dir, f"{k}_dataset.pkl")) for k in SPLITS):
        logger.info(f"loading cached datasets from {cache_dir}")
        datasets = {k: GraphAdjDataset().load(
            os.path.join(cache_dir, f"{k}_dataset.pkl")) for k in SPLITS}
        return _views(datasets, config, logger, " (cache)")

    if config["synthetic"]:
        logger.info("generating synthetic Erdos-Renyi datasets")
        n = config["synthetic_pairs"]
        kw = dict(
            pv=config["max_npv"],
            pe=min(config["max_npe"], 2 * config["max_npv"]),
            gv=config["max_ngv"], ge=config["max_nge"],
            num_vlabels=config["max_ngvl"], num_elabels=config["max_ngel"],
            p_v_max=config["max_npv"], p_e_max=config["max_npe"],
            g_v_max=config["max_ngv"], g_e_max=config["max_nge"])
        sizes = {"train": n, "dev": max(n // 8, 1), "test": max(n // 8, 1)}
        datasets = {k: GraphAdjDataset(generate_dataset(
            sizes[k], seed=config["seed"] + i, **kw))
            for i, k in enumerate(SPLITS)}
    else:
        logger.info("loading datasets from %s / %s / %s" % (
            config["pattern_dir"], config["graph_dir"],
            config["metadata_dir"]))
        splits, _shared = load_data(config["pattern_dir"],
                                    config["graph_dir"],
                                    config["metadata_dir"])

        def to_record(x):
            p, g = x["pattern"], x["graph"]
            return {
                "id": x["id"],
                "pattern": single_graph(
                    p["num_nodes"], p["senders"], p["receivers"],
                    p["node_labels"], p["edge_labels"],
                    v_max=config["max_npv"], e_max=config["max_npe"]),
                "graph": single_graph(
                    g["num_nodes"], g["senders"], g["receivers"],
                    g["node_labels"], g["edge_labels"],
                    v_max=config["max_ngv"], e_max=config["max_nge"]),
                "counts": x["counts"],
                "subisomorphisms": x["subisomorphisms"],
                "node_weights": None, "edge_weights": None,
            }

        datasets = {k: GraphAdjDataset([to_record(x) for x in v])
                    for k, v in splits.items()}
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        for k, v in datasets.items():
            v.save(os.path.join(cache_dir, f"{k}_dataset.pkl"))
        logger.info(f"datasets cached to {cache_dir}")
    return _views(datasets, config, logger, "")


def _views(datasets, config, logger, note: str) -> Dict[str, CollateView]:
    kind = collate_kind_for(config["rep_net"])
    views = {k: CollateView(v, kind, config.get("lrp_seq_len", 4),
                            auto_envelope=config.get("auto_envelope", False))
             for k, v in datasets.items()}
    for k, v in views.items():
        logger.info("%8d %s data loaded%s" % (len(v), k, note))
    return views


def transform_datasets(datasets, config, remove_loops: bool):
    """The reference's dataset transforms in its order (train.py:
    1111-1186): loop removal, reversed edges, the dual graphs; -> the
    eigenvalue bounds of the train set."""
    if remove_loops:
        for ds in datasets.values():
            ds.dataset.remove_loops()
    if config["add_rev"]:
        for ds in datasets.values():
            ds.dataset.add_reversed_edges(config["max_npel"],
                                          config["max_ngel"])
    if config.get("convert_dual"):
        from ..data.dual import convert_dataset_to_dual
        for ds in datasets.values():
            convert_dataset_to_dual(ds.dataset)
    return datasets["train"].dataset.compute_eigenvalue_bounds()


def build_scm_model(config, bounds, device):
    """The model of config on `device`, with the train set's eigenvalue
    bounds (transform_datasets') -> (model, ModelConfig)."""
    from ..models.scm_models import build_model
    from .config import process_model_config, to_model_config

    neigenv, eeigenv = bounds
    model_cfg = to_model_config(process_model_config(config)).replace(
        init_neigenv=neigenv, init_eeigenv=eeigenv)
    return build_model(model_cfg, device=device, seed=config["seed"]), \
        model_cfg


class _SubsetSampler:
    """A sampler's batches mapped through a subset's indices (the
    per-epoch --train_ratio subset)."""

    def __init__(self, sampler, subset: np.ndarray):
        self.sampler, self.subset = sampler, subset

    def __iter__(self):
        return (self.subset[b] for b in self.sampler)

    def __len__(self):
        return len(self.sampler)

    @property
    def full_len(self) -> int:
        return self.sampler.full_len


def _trace(profile_dir: str, device: torch.device):
    """A torch.profiler context that writes epoch0_trace.json into
    profile_dir on exit; a null context without a directory."""
    if not profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)

    @contextlib.contextmanager
    def ctx():
        os.makedirs(profile_dir, exist_ok=True)
        with profile(activities=acts) as prof:
            yield
        prof.export_chrome_trace(os.path.join(profile_dir,
                                              "epoch0_trace.json"))

    return ctx()


def _stamp() -> str:
    return datetime.datetime.now().strftime("%Y_%m_%d_%H_%M_%S")


def dp_launch_plan(config) -> Tuple[str, List[str]]:
    """(backend, one device per rank) of --dp_devices N
    (parallel/dist.launch_plan: NCCL with rank r on cuda:r, or gloo on
    the CPU under --device cpu). Refused, as the JAX CLI refuses them
    (cli/scm_train.py:211-220): more ranks than visible cards, and a
    --train_batch_size that N does not divide."""
    n = config["dp_devices"]
    if config["train_batch_size"] % n:
        # every batch would fall back to the whole batch on each rank
        raise ValueError(
            f"--train_batch_size {config['train_batch_size']} must be "
            f"divisible by --dp_devices {n}")
    return launch_plan(n, config.get("device", "cuda"))


def main(argv=None) -> str:
    """Train; -> the run's directory (save_model_dir/<rep>_<pred>_<ts>).
    --dp_devices N > 1 spawns N ranks (parallel/dist.launch, backend and
    devices from dp_launch_plan) that train one model data-parallel;
    rank 0 evaluates, logs and writes the run's files."""
    from .config import get_train_config

    config = get_train_config(argv)
    n = config["dp_devices"]
    if n <= 1:
        return train(config)
    backend, devices = dp_launch_plan(config)
    with tempfile.TemporaryDirectory() as tmp:
        return launch(_train_rank, n, backend=backend, devices=devices,
                      init_file=os.path.join(tmp, "rendezvous"),
                      args=(config, _stamp()), timeout=None,
                      collective_timeout=CLI_COLLECTIVE_TIMEOUT,
                      threads=rank_threads(devices))[0]


def _train_rank(world, config, stamp):
    return train(config, world, stamp)


def train(config, world=None, stamp: Optional[str] = None) -> str:
    """The training loop over the parsed config on one rank; world (a
    parallel.dist.World) for data parallelism, on world.device. Rank 0
    (or the one process) writes the run's directory and returns it."""
    from ..train.checkpoint import save_state
    from ..train.samplers import BucketSampler, CurriculumSampler
    from ..train.schedules import derive_schedule_config
    from ..train.scm_driver import (MultiSteps, dp_replicate_state,
                                    evaluate_epoch, make_eval_step,
                                    make_optimizer, make_train_step,
                                    train_epoch)
    from ..utils.io import save_config, save_results
    from ..utils.log import generate_best_line, init_logger
    from .config import train_device

    lead = world is None or world.rank == 0
    device = train_device(config) if world is None else world.device
    save_dir = os.path.join(
        config["save_model_dir"], "%s_%s_%s" % (
            config["rep_net"], config["pred_net"], stamp or _stamp()))
    writer = None
    if lead:
        os.makedirs(save_dir, exist_ok=True)
        logger = init_logger(os.path.join(save_dir, "log.txt"),
                             log_tag=config["rep_net"])
        save_config(config, os.path.join(save_dir, "config.json"))
        # TensorBoard scalars (reference train.py:18,688-724,1018-1025),
        # where tensorboardX is installed
        try:
            from tensorboardX import SummaryWriter
            writer = SummaryWriter(os.path.join(save_dir, "tb"))
        except ImportError:
            pass
    else:
        logger = logging.getLogger(f"{__name__}.rank{world.rank}")
        logger.addHandler(logging.NullHandler())
        logger.propagate = False

    if world is not None and not lead:
        dist.barrier()          # rank 0 builds (and caches) the data first
    datasets = build_datasets(config, logger)
    if world is not None and lead:
        dist.barrier()
    bounds = transform_datasets(datasets, config,
                                config.get("remove_loops", False))
    logger.info("eigenvalue bounds: node %.2f edge %.2f" % bounds)
    model, _ = build_scm_model(config, bounds, device)
    n_params = sum(p.numel() for p in model.parameters())
    logger.info(f"model built: {n_params} parameters on {device}")

    # finetune: the best dev epoch of a previous run, expanded onto this
    # (possibly larger-vocabulary) model (train.py:90-111,1209-1223);
    # parameters only, the BatchNorm statistics stay fresh
    if config.get("load_model_dir"):
        from ..train.checkpoint import expand_params, restore_state
        from ..utils.io import load_config
        from ..utils.log import get_best_epochs
        src = config["load_model_dir"]
        src_cfg = load_config(os.path.join(src, "config.json"))
        best = get_best_epochs(os.path.join(src, "log.txt"))
        src_epoch = best["eval-" + src_cfg["eval_metric"]]["dev"][0]
        logger.info(f"finetuning from {src} epoch {src_epoch}")
        old = restore_state(os.path.join(src, f"epoch{src_epoch}"))["model"]
        fresh = {k: v.detach() for k, v in model.named_parameters()}
        model.load_state_dict(expand_params(
            {k: v for k, v in old.items() if k in fresh}, fresh,
            pre_pad=True), strict=False)

    tx = make_optimizer(model.parameters(), config["lr"],
                        config["weight_decay"], config["max_grad_norm"])
    # gradient accumulation (reference train_grad_steps, train.py:679-684)
    if config.get("train_grad_steps", 1) > 1:
        tx = MultiSteps(tx, config["train_grad_steps"])
    # derived warmup/cycles for the LR schedule (reference train.py:1231-1254)
    config.update(derive_schedule_config(len(datasets["train"]), config))
    logger.info("schedule: warmup %d steps, horizon %d, cycles %.3f,"
                " min_percent %g" % (
                    config["num_warmup_steps"], config["num_schedule_steps"],
                    config["num_cycles"], config["min_percent"]))
    # each rank draws its own rows' dropout masks
    dropout = torch.Generator(device=device).manual_seed(
        config["seed"] + (world.rank if world else 0))
    train_step = make_train_step(
        model, tx, config["bp_loss"], config["match_weights"],
        eval_metric=config["eval_metric"], amp=config.get("amp", False),
        accum_chunks=config.get("train_microbatch_chunks", 0) or None,
        generator=dropout, world=world)
    if world is not None:
        dp_replicate_state(train_step)
        logger.info(f"data parallel: {world.size} ranks over "
                    f"{world.backend}")
    eval_step = make_eval_step(model)       # float32, as the JAX CLI's

    sizes = {k: v.sizes() for k, v in datasets.items()}
    warmup = config["curriculum_warmup_epochs"]
    if warmup < 0:
        warmup = max(1, int(0.2 * config["train_epochs"]))

    metric = config["eval_metric"]
    higher_better = metric == "AUC"
    best_dev = -float("inf") if higher_better else float("inf")
    best_train_loss = float("inf")
    stale_loss = stale_metric = 0
    for epoch in range(config["train_epochs"]):
        used_ratio = min(1.0, 0.5 + 0.5 * epoch / max(warmup, 1))
        # per-epoch train_ratio subsetting (train.py:1266-1290)
        train_sizes = sizes["train"]
        subset = None
        if config.get("train_ratio", 1.0) < 1.0:
            sub_rng = np.random.default_rng(config["seed"] + epoch)
            n_keep = max(1, int(len(train_sizes) * config["train_ratio"]))
            subset = sub_rng.permutation(len(train_sizes))[:n_keep]
            train_sizes = [train_sizes[i] for i in subset]
        sampler = CurriculumSampler(
            train_sizes, ["p_len", "g_len"], used_ratio,
            config["train_batch_size"], group_by=["g_len", "p_len"],
            shuffle=True, seed=config["seed"])
        sampler.set_epoch(epoch)
        if subset is not None:
            sampler = _SubsetSampler(sampler, subset)
        with _trace(config.get("profile_dir")
                    if epoch == 0 and lead else "", device):
            totals = train_epoch(train_step, datasets["train"], sampler,
                                 config, epoch, log_fn=logger.info,
                                 writer=writer)
        logger.info("train throughput: %.0f edges/s, %.1f pairs/s, "
                    "epoch %.3f s" % (totals["edges_per_sec"],
                                      totals["pairs_per_sec"],
                                      totals["seconds"]))
        logger.info("data_type: %-10s\tepoch: %05d/%05d\tloss: %.6f" % (
            "train", epoch, config["train_epochs"], totals["total"]))
        if writer:
            for k, v in totals.items():
                writer.add_scalar(f"train/{k}", v, epoch)
        if totals["total"] < best_train_loss:
            best_train_loss = totals["total"]
            stale_loss = 0
        else:
            stale_loss += 1
        if not lead:
            # every rank's loss is the whole batch's; rank 0 decides
            if broadcast_object(world):
                break
            continue

        results = {}
        for split in ("dev", "test"):
            ev = BucketSampler(sizes[split], ["g_len", "p_len"],
                               config["eval_batch_size"],
                               seed=config["seed"])
            res = evaluate_epoch(eval_step, datasets[split], ev,
                                 return_weights=config["match_weights"])
            results[split] = res
            logger.info("data_type: %-10s\tepoch: %05d/%05d\t%s" % (
                split, epoch, config["train_epochs"],
                "\t".join(f"{k}: {v:.6f}" for k, v in res.items()
                          if isinstance(v, float))))
            save_results(res, os.path.join(
                save_dir, f"{split}_results{epoch}.json"))
            if writer:
                for k, v in res.items():
                    if isinstance(v, float):
                        writer.add_scalar(f"{split}/{k}", v, epoch)

        dev_metric = results["dev"].get(metric, float("nan"))
        improved = (dev_metric > best_dev if higher_better
                    else dev_metric < best_dev)
        if improved:
            best_dev = dev_metric
            stale_metric = 0
            save_state(os.path.join(save_dir, f"epoch{epoch}"), model, tx,
                       tx.count, dropout)
            for split in ("dev", "test"):
                logger.info(generate_best_line(
                    split, epoch, config["train_epochs"],
                    **{("eval-" + metric): results[split].get(metric)}))
        else:
            stale_metric += 1
        stop = (stale_loss > config["early_stop_rounds"]
                and stale_metric > config["early_stop_rounds"])
        if world is not None:
            broadcast_object(world, stop)
        if stop:
            logger.info(f"early stop at epoch {epoch}")
            break
    if writer:
        writer.close()
    logger.info("training done; best dev %s: %.6f" % (metric, best_dev))
    return save_dir


if __name__ == "__main__":
    main()
