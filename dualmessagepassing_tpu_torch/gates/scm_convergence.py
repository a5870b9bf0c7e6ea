"""The SCM learning gate through the port: scripts/scm_convergence.py
(family specs 51-110, run 111-365, matching_learned 366-417, main
420-496) over the port's generate_pair, GraphAdjDataset, samplers and
train/scm_driver.py, on the card unless --cpu asks for the CPU.

It trains the flagship DMPNN counting+matching configuration with the
reference recipe (train.py:1231-1372: AdamW amsgrad wd 1e-5 clip 8.0,
cosine-with-warmup-and-restart LR, annealed leaky slope, match losses,
early stop on train-loss AND dev-metric staleness) to early stop on a
synthetic set of a reference dataset family, records the per-epoch
metric trajectory, the zero-predictor baselines and an overfit probe (a
fresh model fit to 16 seen pairs), and decides matching_learned:

  * head_learns — the probe beats the zero predictor by 2x on MNED and
    MEED (the matching machinery learns);
  * dev_beats_zero — the trained model's dev MNED and MEED (mean of the
    last quarter of epochs) are below the zero predictor's (held-out
    matching skill; the ER family's dense gold weights make that
    reachable, SCM_CONVERGENCE_ER.json).

python -m dualmessagepassing_tpu_torch.gates.scm_convergence --family er \\
    --pairs 4096 --bsz 64 --max-epochs 100 --early-stop 5 --amp 1
(--check FILE gates the final metrics against a stored result, as the
script does.) The dataset, the recipe and the gate are the script's; the
initial weights and the dropout stream are torch's (build_model's
generator), so a run reaches the gate's thresholds, not the JAX run's
numbers.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch


def family_spec(family: str) -> dict:
    """Generation and envelope parameters per reference dataset family
    (SubgraphCountingMatching/README.md:24-117), the script's
    _family_spec: the per-pair sampler kwargs (sample(rng)), the caps,
    the label vocabularies, the count-tail rejection cap and the family's
    published batch size."""
    if family == "complex":
        return dict(
            caps=dict(p_v_max=8, p_e_max=8, g_v_max=64, g_e_max=256),
            nvl=16, nel=16, p_nvl=16, p_nel=16, count_cap=60, bsz=128,
            sample=lambda rng: dict(pv=8, pe=8, gv=64, ge=256,
                                    plant=int(rng.integers(0, 4))),
            envelope="Complex+rev (8V/8E pattern, 64V/512E graph)")
    if family == "er":
        # unlabeled ER (README.md:38-39): every injective embedding with
        # the right edges is a match; dense gold weights, no planting
        return dict(
            caps=dict(p_v_max=4, p_e_max=10, g_v_max=10, g_e_max=48),
            nvl=1, nel=1, p_nvl=1, p_nel=1, count_cap=256, bsz=64,
            sample=lambda rng: (lambda pv: dict(
                pv=pv, pe=int(rng.integers(pv, min(10, 3 * pv) + 1)),
                gv=10, ge=int(rng.integers(24, 49)), plant=0))(
                    int(rng.integers(3, 5))),
            envelope="ER+rev (<=4V/10E unlabeled pattern, 10V/<=48E graph)")
    if family == "mutag":
        # MUTAG-like (README.md:107-108): pattern labels a subset of the
        # graph's vocabulary; matches planted
        return dict(
            caps=dict(p_v_max=4, p_e_max=3, g_v_max=28, g_e_max=66),
            nvl=7, nel=4, p_nvl=2, p_nel=2, count_cap=96, bsz=32,
            sample=lambda rng: (lambda pv: dict(
                pv=pv, pe=3, gv=28, ge=int(rng.integers(50, 67)),
                plant=int(rng.integers(1, 4))))(int(rng.integers(3, 5))),
            envelope="MUTAG+rev (<=4V/3E 2/2-label pattern, "
                     "28V/<=66E 7/4-label graph)")
    raise ValueError(f"unknown family {family!r} "
                     "(choose complex | er | mutag)")


def family_model_config(spec: dict, hid: int):
    """The flagship ModelConfig on a family's envelope with reversed
    edges (train.py:1150-1158 doubles E and the edge labels)."""
    from ..models.basemodel import ModelConfig

    caps = spec["caps"]
    return ModelConfig(
        max_ngv=caps["g_v_max"], max_ngvl=spec["nvl"],
        max_nge=caps["g_e_max"] * 2, max_ngel=spec["nel"] * 2,
        max_npv=caps["p_v_max"], max_npvl=spec["p_nvl"],
        max_npe=caps["p_e_max"] * 2, max_npel=spec["p_nel"] * 2,
        hid_dim=hid, rep_num_pattern_layers=3, rep_num_graph_layers=3,
        pred_hid_dim=hid, filter_net="ScalarFilter",
        pred_return_weights="nodeedge")


def make_pairs(family: str, pairs: int, seed: int) -> list:
    """The script's data: `pairs` records from generate_pair with the
    family's sampler, the count tail above count_cap drawn again."""
    from ..data.synthetic import generate_pair

    spec = family_spec(family)
    rng = np.random.default_rng(seed)

    def one_pair(i):
        while True:
            rec = generate_pair(rng, num_vlabels=spec["nvl"],
                                num_elabels=spec["nel"],
                                p_num_vlabels=spec["p_nvl"],
                                p_num_elabels=spec["p_nel"],
                                pair_id=f"P{i}-G{i}",
                                **spec["caps"], **spec["sample"](rng))
            if rec["counts"] <= spec["count_cap"]:
                return rec

    return [one_pair(i) for i in range(pairs)]


def zero_baseline(ds, sampler) -> dict:
    """MNED/MEED/MAE of the all-zeros predictor (the gold weights' mean
    mass per graph; reversed edges masked out)."""
    neds, eeds, absc = [], [], []
    for bidx in sampler:
        _, _, graph, counts, (nw, ew) = ds.batchify(bidx, "nodeedge")
        gvm = graph.node_mask.numpy()
        gem = graph.edge_mask.numpy() & ~graph.rev_flag.numpy()
        neds.append(np.abs(nw.numpy() * gvm).sum(axis=1))
        eeds.append(np.abs(ew.numpy() * gem).sum(axis=1))
        absc.append(np.abs(counts.numpy()[:, 0]))
    return {"MNED": round(float(np.concatenate(neds).mean()), 6),
            "MEED": round(float(np.concatenate(eeds).mean()), 6),
            "MAE": round(float(np.concatenate(absc).mean()), 6)}


def _dev_row(epoch, loss, dev, seconds) -> dict:
    row = {"epoch": epoch, "train_loss": loss}
    row.update({f"dev_{k}": round(dev[k], 6)
                for k in ("MAE", "MSE", "RMSE", "AUC", "MNED", "MEED")})
    row["epoch_s"] = seconds
    return row


def run(pairs: int, max_epochs: int, early_stop: int, bsz: int, lr: float,
        amp: bool, seed: int, probe_steps: int = 600, hid: int = 64,
        family: str = "complex", device="cuda", init_weights=None,
        log=print) -> dict:
    """The script's run() on the port -> its result dict, plus the
    device, its name and the run's seconds. init_weights: a state_dict
    (or the path of one saved with torch.save) the trained model starts
    from instead of build_model's draw, e.g. the JAX package's initial
    weights through models/scm_models.params_from_flax."""
    from ..data.dataset import GraphAdjDataset
    from ..models.scm_models import build_model
    from ..train.samplers import BucketSampler
    from ..train.scm_driver import (evaluate_epoch, make_eval_step,
                                    make_optimizer, make_train_step,
                                    train_epoch)

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass device='cpu' (--cpu) "
                           "to run on the CPU")
    t_run = time.perf_counter()
    spec = family_spec(family)
    t0 = time.perf_counter()
    data = make_pairs(family, pairs, seed)
    n_dev = max(pairs // 6, 8)
    train_ds = GraphAdjDataset(data[: pairs - 2 * n_dev])
    dev_ds = GraphAdjDataset(data[pairs - 2 * n_dev: pairs - n_dev])
    test_ds = GraphAdjDataset(data[pairs - n_dev:])
    for ds in (train_ds, dev_ds, test_ds):
        ds.add_reversed_edges(spec["p_nel"], spec["nel"])  # train.py:1150
    counts = [d["counts"] for d in data]
    log(f"dataset[{family}]: {pairs} pairs in "
        f"{time.perf_counter() - t0:.1f}s; "
        f"counts mean {np.mean(counts):.2f} max {max(counts)} "
        f"zero-frac {np.mean(np.asarray(counts) == 0):.2f}")

    cfg = family_model_config(spec, hid)
    model = build_model(cfg, device=device, seed=seed)
    if isinstance(init_weights, str):
        init_weights = torch.load(init_weights, map_location="cpu",
                                  weights_only=True)
    if init_weights is not None:
        model.load_state_dict(init_weights)
    step = make_train_step(
        model, make_optimizer(model.parameters(), lr),
        bp_loss="MSE", return_weights="nodeedge", amp=amp,
        generator=torch.Generator(device=device).manual_seed(seed + 1))
    n_train = pairs - 2 * n_dev
    steps_per_epoch = max(n_train // bsz, 1)
    # reference warmup/cycle formulas (train.py:1246-1254)
    warmup = int(steps_per_epoch * 0.5 * min(0.06 * max_epochs, early_stop))
    config = {
        "train_epochs": max_epochs, "lr": lr,
        "neg_pred_slp": "anneal_cosine$1.0$0.01",   # config.py:145-146
        # the reference matching recipe (config.py:495-506)
        "match_loss_w": 1.0, "match_reg_w": "anneal_cosine$0.01$0.0",
        "rep_reg_w": 1e-5,
        "scheduler": "cosine_with_warmup_and_restart",
        "num_warmup_steps": warmup,
        "num_schedule_steps": max_epochs * steps_per_epoch,
        "num_cycles": max(max_epochs * steps_per_epoch // 20000, 1),
        "pred_return_weights": "nodeedge", "bp_loss": "MSE",
    }
    eval_step = make_eval_step(model)

    def sampler_of(ds, size=bsz):
        return BucketSampler(ds.sizes(), ["g_len", "p_len"],
                             batch_size=size, seed=0, shuffle=False)

    def evaluate(ds, sampler, fn=eval_step):
        return evaluate_epoch(fn, ds, sampler, return_weights="nodeedge")

    dev_sampler, test_sampler = sampler_of(dev_ds), sampler_of(test_ds)
    # train-fit split: dev-sized, drawn from seen pairs (the records were
    # given reversed edges in place through train_ds)
    fit_ds = GraphAdjDataset(data[:n_dev])
    fit_sampler = sampler_of(fit_ds)
    baselines = {"dev_zero": zero_baseline(dev_ds, dev_sampler),
                 "train_zero": zero_baseline(fit_ds, fit_sampler)}
    log(f"zero-predictor baselines: {json.dumps(baselines)}")

    # the pre-training eval (epoch -1) anchors the _vs_untrained ratios
    pre_row = _dev_row(-1, None, evaluate(dev_ds, dev_sampler), 0.0)
    log(json.dumps(pre_row))
    trajectory = [pre_row]
    best_dev = best_loss = float("inf")
    stale_dev = stale_loss = 0
    stopped_at = max_epochs - 1
    for epoch in range(max_epochs):
        sampler = BucketSampler(train_ds.sizes(), ["g_len", "p_len"],
                                batch_size=bsz, seed=epoch)
        sampler.set_epoch(epoch)
        t0 = time.perf_counter()
        totals = train_epoch(step, train_ds, sampler, config, epoch)
        dev = evaluate(dev_ds, dev_sampler)
        row = _dev_row(epoch, round(float(totals["total"]), 6), dev,
                       round(time.perf_counter() - t0, 1))
        trajectory.append(row)
        log(json.dumps(row))
        # early stop when both the train loss and the dev metric are stale
        # (train.py:1368-1372)
        stale_loss = 0 if totals["total"] < best_loss else stale_loss + 1
        best_loss = min(best_loss, float(totals["total"]))
        stale_dev = 0 if dev["MAE"] < best_dev else stale_dev + 1
        best_dev = min(best_dev, float(dev["MAE"]))
        if stale_loss > early_stop and stale_dev > early_stop:
            stopped_at = epoch
            break

    test = evaluate(test_ds, test_sampler)
    fit = evaluate(fit_ds, fit_sampler)
    train_fit = {k: round(fit[k], 6) for k in ("MAE", "MNED", "MEED")}

    # the overfit probe: a fresh model fit to probe_pairs seen pairs
    # until it reproduces their gold occurrence weights
    probe_pairs = min(16, n_train)
    probe_ds = GraphAdjDataset(data[:probe_pairs])
    probe_sampler = sampler_of(probe_ds, probe_pairs)
    probe_zero = zero_baseline(probe_ds, probe_sampler)
    _, p_pat, p_graph, p_counts, (p_nw, p_ew) = probe_ds.batchify(
        range(probe_pairs), "nodeedge")
    p_model = build_model(cfg, device=device, seed=seed + 101)
    p_step = make_train_step(
        p_model, make_optimizer(p_model.parameters(), lr), bp_loss="MSE",
        return_weights="nodeedge", amp=amp,
        generator=torch.Generator(device=device).manual_seed(seed + 102))
    p_batch = [x.to(device) for x in (p_pat, p_graph, p_counts, p_nw, p_ew)]
    t0 = time.perf_counter()
    for _ in range(probe_steps):
        p_step(*p_batch, 0.01, 1.0, 0.0, 0.0, 1.0)
    p_fit = evaluate(probe_ds, probe_sampler, make_eval_step(p_model))
    probe = {"pairs": probe_pairs, "steps": probe_steps,
             "zero": probe_zero,
             "MNED": round(p_fit["MNED"], 6),
             "MEED": round(p_fit["MEED"], 6),
             "MNED_vs_zero": round(
                 p_fit["MNED"] / max(probe_zero["MNED"], 1e-9), 6),
             "MEED_vs_zero": round(
                 p_fit["MEED"] / max(probe_zero["MEED"], 1e-9), 6),
             "probe_s": round(time.perf_counter() - t0, 1)}
    log(f"overfit probe: {json.dumps(probe)}")
    final = {k: trajectory[-1][k] for k in (
        "dev_MAE", "dev_MSE", "dev_RMSE", "dev_AUC", "dev_MNED", "dev_MEED")}
    final.update({f"test_{k}": round(test[k], 6) for k in (
        "MAE", "MSE", "RMSE", "AUC", "MNED", "MEED")})
    return {
        "metric": "scm_convergence_dev_MAE",
        "value": round(best_dev, 6),
        "unit": "MAE",
        "config": {"pairs": pairs, "bsz": bsz, "lr": lr, "amp": amp,
                   "seed": seed, "max_epochs": max_epochs,
                   "early_stop": early_stop, "hid": hid, "family": family,
                   "envelope": spec["envelope"]},
        "platform": device.type,
        "device_name": (torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"),
        "seconds": round(time.perf_counter() - t_run, 1),
        "stopped_at_epoch": stopped_at,
        "final": final,
        "best_dev_MAE": round(best_dev, 6),
        "baselines": baselines,
        "train_fit": train_fit,
        "overfit_probe": probe,
        "matching_learned": matching_learned(trajectory, baselines,
                                             train_fit, probe),
        "trajectory": trajectory,
    }


def matching_learned(trajectory, baselines=None, train_fit=None,
                     probe=None) -> dict:
    """The script's matching_learned: the dev MNED/MEED of the last
    quarter of epochs against the untrained model and the zero
    predictor; head_learns from the probe (both ratios < 0.5; from the
    train fit, < 0.9, for a result without a probe); dev_beats_zero (both
    dev ratios < 1.0); ok = head_learns. Without baselines, the old
    epoch-anchored ratios (< 0.7) decide ok."""
    rows = [r for r in trajectory if r["epoch"] >= 0]
    base = trajectory[0]   # the epoch -1 pre-training row when present
    q = max(len(rows) // 4, 1)
    out = {}
    for k in ("dev_MNED", "dev_MEED"):
        tail = float(np.mean([r[k] for r in rows[-q:]]))
        out[k + "_vs_untrained"] = round(tail / max(base[k], 1e-9), 6)
        if baselines is not None:
            zk = baselines["dev_zero"][k[4:]]   # dev_MNED -> MNED
            out[k + "_vs_zero"] = round(tail / max(zk, 1e-9), 6)
    if baselines is None or train_fit is None:
        out["ok"] = bool(out["dev_MNED_vs_untrained"] < 0.7
                         and out["dev_MEED_vs_untrained"] < 0.7)
        return out
    tz = baselines["train_zero"]
    out["train_MNED_vs_zero"] = round(
        train_fit["MNED"] / max(tz["MNED"], 1e-9), 6)
    out["train_MEED_vs_zero"] = round(
        train_fit["MEED"] / max(tz["MEED"], 1e-9), 6)
    if probe is not None:
        out["head_learns"] = bool(probe["MNED_vs_zero"] < 0.5
                                  and probe["MEED_vs_zero"] < 0.5)
    else:
        out["head_learns"] = bool(out["train_MNED_vs_zero"] < 0.9
                                  and out["train_MEED_vs_zero"] < 0.9)
    out["dev_beats_zero"] = bool(out["dev_MNED_vs_zero"] < 1.0
                                 and out["dev_MEED_vs_zero"] < 1.0)
    out["ok"] = out["head_learns"]
    return out


def check_against(result: dict, ref: dict) -> list:
    """The script's --check: each final metric within 0.15 relative of
    the stored one (AUC 0.05 absolute; NaN must match NaN), matching
    learned, and dev_beats_zero kept where the stored result had it ->
    the failures."""
    bad = []
    for k, v in ref["final"].items():
        got = result["final"][k]
        if math.isnan(got) != math.isnan(v):
            bad.append(f"{k}: expected {v}, got {got} (NaN mismatch)")
        elif math.isnan(got):
            continue
        elif k.endswith("AUC"):
            if abs(got - v) > 0.05:
                bad.append(f"{k}: expected {v}, got {got}")
        elif abs(got - v) > 0.15 * max(abs(v), 1e-6):
            bad.append(f"{k}: expected {v}, got {got}")
    ml = result["matching_learned"]
    if not ml["ok"]:
        bad.append(f"matching did not learn: {ml}")
    if ref.get("matching_learned", {}).get("dev_beats_zero") and not \
            ml.get("dev_beats_zero"):
        bad.append("dev_beats_zero regressed: the stored result beat the "
                   f"zero predictor, this run did not ({ml})")
    return bad


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--family", default="complex",
                    choices=["complex", "er", "mutag"],
                    help="reference dataset family envelope (README.md:24-117)")
    ap.add_argument("--pairs", type=int, default=768)
    ap.add_argument("--max-epochs", type=int, default=60)
    ap.add_argument("--early-stop", type=int, default=5)
    ap.add_argument("--bsz", type=int, default=None,
                    help="default: the family's published batch size")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--amp", type=int, default=1)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU (default: the card)")
    ap.add_argument("--probe-steps", type=int, default=600,
                    help="overfit-probe length (the machinery gate)")
    ap.add_argument("--hid", type=int, default=64,
                    help="hid_dim/pred_hid_dim override (capacity axis)")
    ap.add_argument("--init-weights", default=None,
                    help="a torch.save'd state_dict the trained model "
                         "starts from (e.g. the JAX package's init)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", default=None,
                    help="gate final metrics against this stored JSON")
    args = ap.parse_args(argv)
    bsz = args.bsz or family_spec(args.family)["bsz"]
    result = run(args.pairs, args.max_epochs, args.early_stop, bsz,
                 args.lr, bool(args.amp), args.seed,
                 probe_steps=args.probe_steps, hid=args.hid,
                 family=args.family,
                 device="cpu" if args.cpu else "cuda",
                 init_weights=args.init_weights)
    print(json.dumps({k: v for k, v in result.items() if k != "trajectory"}))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.check:
        with open(args.check) as f:
            bad = check_against(result, json.load(f))
        if bad:
            print("CONVERGENCE GATE FAILED: " + "; ".join(bad))
            sys.exit(1)
        print("convergence gate OK")
    return result


if __name__ == "__main__":
    main()
