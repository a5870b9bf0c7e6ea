"""The SCM learning run and its spread over the last bits of the weights.

`learning_run` is the user's SCM path counted from zero, as
chip_smoke.py phase 11 runs it: generate_dataset (an ER set at the
scm_er_counting sizes, tests/test_regression.py:64-66, reversed edges
added), the flagship's widths and options, BucketSampler,
make_train_step and train_epoch for LEARN["epochs"] epochs, then
make_eval_step and evaluate_epoch.

On the card K3 adds in the order its atomics land, so two runs differ in
the last bits and the trajectories drift apart. Run alone, the module
repeats the run at chip_smoke.py's seed with the initial weights scaled
by 1 + EPS * N(0, 1) (the first run unscaled) and prints each run's
epoch losses and whether the last epoch fell below the first two, the
check chip_smoke.py makes:

    python -m dualmessagepassing_tpu_torch.bench.scm_learn_spread \
        [--runs 8] [--schedule default|constant] [--device cpu]

`default` is scm_train's learning-rate schedule (cosine with the warmup
train/schedules.derive_schedule_config derives), `constant` a constant
rate. One JSON line a run, then one with the count that held.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Callable, Optional

import numpy as np
import torch

from ..cli import config as scm_config
from ..data.dataset import GraphAdjDataset
from ..data.synthetic import generate_dataset
from ..dryrun import _flagship_config
from ..models.scm_models import build_model
from ..train import scm_driver
from ..train.samplers import BucketSampler
from ..train.schedules import derive_schedule_config

LEARN = dict(n_train=512, n_dev=128, bsz=32, epochs=4, lr=1e-3)
# chip_smoke.py's learning run: its default --seed 0, plus 16
SEED = 16
# a relative change of the weights near float32's last bits
EPS = 1e-6


def learning_config():
    """The flagship's widths and options cut to the ER set's envelope."""
    return _flagship_config().replace(
        max_ngv=8, max_ngvl=2, max_nge=32, max_ngel=4, max_npv=4,
        max_npvl=2, max_npe=8, max_npel=4)


def learning_run(device, seed: int, schedule: str = "default",
                 eps: float = 0.0, noise_seed: int = 0,
                 log: Optional[Callable[[str], None]] = None) -> dict:
    """One learning run: the epoch losses, the dev scores of
    evaluate_epoch, the train steps and eval batches, and the seconds it
    took to make the data and to train and evaluate. eps > 0 scales the
    initial weights by 1 + eps * N(0, 1), the noise drawn from
    noise_seed."""
    t0 = time.perf_counter()
    n_tr, n_dev, bsz = LEARN["n_train"], LEARN["n_dev"], LEARN["bsz"]
    data = generate_dataset(n_tr + n_dev, seed=seed, pv=3, pe=3, gv=8,
                            ge=16, num_vlabels=2, num_elabels=2, p_v_max=4,
                            p_e_max=4, g_v_max=8, g_e_max=16)
    train_ds = GraphAdjDataset(data[:n_tr]).add_reversed_edges(2, 2)
    dev_ds = GraphAdjDataset(data[n_tr:]).add_reversed_edges(2, 2)
    gen_s = time.perf_counter() - t0
    model = build_model(learning_config(), device=device, seed=seed)
    if eps:
        gen = torch.Generator().manual_seed(noise_seed)
        with torch.no_grad():
            for p in model.parameters():
                p.mul_(1 + eps * torch.randn(p.shape, generator=gen).to(p))
    step = scm_driver.make_train_step(
        model, scm_driver.make_optimizer(model.parameters(), LEARN["lr"]),
        return_weights="nodeedge")
    config = {"train_epochs": LEARN["epochs"], "neg_pred_slp": 0.2,
              "match_loss_w": 0.1, "pred_return_weights": "nodeedge"}
    if schedule == "default":
        cli = scm_config.get_train_config([])
        config["scheduler"] = cli["scheduler"]
        config.update(derive_schedule_config(n_tr, {
            **cli, "train_batch_size": bsz, "train_epochs": LEARN["epochs"]}))
    elif schedule != "constant":
        raise ValueError(f"schedule {schedule!r}: default or constant")
    sampler = BucketSampler(train_ds.sizes(), ["g_len", "p_len"], bsz,
                            shuffle=True, seed=seed)
    dev_sampler = BucketSampler(dev_ds.sizes(), ["g_len", "p_len"], bsz)
    losses = []
    t1 = time.perf_counter()
    for epoch in range(LEARN["epochs"]):
        sampler.set_epoch(epoch)
        rec = scm_driver.train_epoch(step, train_ds, sampler, config, epoch)
        losses.append(rec["total"])
        if log:
            log(f"scm learn epoch {epoch}: loss {rec['total']:.6f}, "
                f"{len(sampler)} steps, {rec['edges_per_sec']:.4g} edges/s "
                "(host wall clock)")
    results = scm_driver.evaluate_epoch(scm_driver.make_eval_step(model),
                                        dev_ds, dev_sampler, "nodeedge")
    return dict(losses=losses, results=results,
                steps=LEARN["epochs"] * len(sampler),
                eval_batches=len(dev_sampler), gen_s=gen_s,
                seconds=time.perf_counter() - t1)


def falling(losses) -> bool:
    """Finite, and the last epoch below each of the first two."""
    return bool(np.isfinite(losses).all()) and losses[-1] < min(losses[:2])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--schedule", default="default",
                    choices=["default", "constant"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    held = 0
    for run in range(args.runs):
        out = learning_run(torch.device(args.device), SEED, args.schedule,
                           EPS if run else 0.0, noise_seed=run)
        ok = falling(out["losses"])
        held += ok
        print(json.dumps({"run": run, "schedule": args.schedule,
                          "losses": out["losses"], "falling": ok,
                          "seconds": out["seconds"]}), flush=True)
    print(json.dumps({"runs": args.runs, "falling": held,
                      "schedule": args.schedule, "eps": EPS,
                      "device": args.device}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
