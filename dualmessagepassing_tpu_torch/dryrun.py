"""Compile-free entry point and multi-rank dry run of the port: the
counterpart of __graft_entry__.py.

    python -m dualmessagepassing_tpu_torch.dryrun [--ranks N]
        [--backend gloo|nccl] [--device cuda|cpu]

entry(device)            -> (fn, args): the flagship DMPNN counting
                            forward (_flagship_config) on 8 pairs of the
                            Complex envelope (_make_batch); fn(*args) ->
                            (pred_c, pred_v, pred_e).
dryrun_multichip(world)  -> every loss of one pass, in each rank of
                            `world`, over what the JAX package runs over
                            its mesh, at its tiny shapes:
  * one data-parallel SCM step: the JAX loss (count MSE plus 0.1 of the
    node and edge predictions' mean squares), each rank its rows of the
    batch, the means completed over the ranks, AdamW(1e-3, weight decay
    1e-5) as optax.adamw computes it (torch.optim.AdamW: m_hat /
    (sqrt(v_hat) + eps) plus the decoupled decay of the old parameter,
    betas 0.9/0.999, eps 1e-8);
  * the edge-partitioned demonstration layer's forward
    (parallel/edge_partition.py) at V 16, E 64, H 16, 2 layers;
  * three edge-partitioned UNC steps (parallel/ep_unc.py) with
    optax.adam(1e-2)'s update (torch.optim.Adam);
  * three owner-sharded (halo) steps (parallel/halo_unc.py), then two
    under amp bf16, each on the rank's own K1/K2 plans
    (attach_halo_csr_plans). JAX's amp steps add sorted_edges, the
    windowed kernels and pad_cols, TPU levers this package does not
    carry (ROADMAP.md, "Not ported");
  * one supervised UNC step (unc/driver.make_unc_supervised_step);
  * one data-parallel train_epoch through cli/config.py's configuration
    (--dp_devices N), the code path of cli/scm_train.py.
Every loss must be finite (RuntimeError otherwise). The inputs are drawn
from fixed seeds, the same on every rank, so the ranks' losses agree.

The default device is the card: NCCL with rank r on cuda:r, as many
ranks as cards; --backend gloo lets ranks share one card; --device cpu
runs gloo ranks on the CPU.
"""

from __future__ import annotations

import argparse
import copy
import os
import tempfile
from typing import Dict, List

import numpy as np
import torch

from .graph import add_reversed_edges, batch_graphs, single_graph
from .models.basemodel import ModelConfig
from .models.scm_models import build_model
from .parallel import dp
from .parallel.dist import (World, all_reduce_grads, all_reduce_sum, launch,
                            launch_plan, rank_threads, split_rows)
from .train.scm_driver import TorchOptimizer


def _make_batch(bsz, pv, pe, gv, ge, nvl, nel, seed=0, add_rev=True):
    """__graft_entry__.py:_make_batch with the port's graph builders:
    random pattern/graph pairs, the same draws."""
    rng = np.random.default_rng(seed)
    pats, gras = [], []
    for _ in range(bsz):
        p = single_graph(
            pv, rng.integers(0, pv, pe), rng.integers(0, pv, pe),
            node_labels=rng.integers(0, nvl, pv),
            edge_labels=rng.integers(0, nel, pe), v_max=pv, e_max=pe)
        g = single_graph(
            gv, rng.integers(0, gv, ge), rng.integers(0, gv, ge),
            node_labels=rng.integers(0, nvl, gv),
            edge_labels=rng.integers(0, nel, ge), v_max=gv, e_max=ge)
        if add_rev:
            p = add_reversed_edges(p, nel)
            g = add_reversed_edges(g, nel)
        pats.append(p)
        gras.append(g)
    return batch_graphs(pats), batch_graphs(gras)


def _flagship_config(add_rev=True) -> ModelConfig:
    """__graft_entry__.py:_flagship_config: the Complex-dataset envelope
    (pattern <= 8V/8E, graph <= 64V/256E, 16 labels; reversed edges
    double E and the edge labels), hid 64, 3 + 3 layers, ScalarFilter,
    node and edge weights."""
    mult = 2 if add_rev else 1
    return ModelConfig(
        max_ngv=64, max_ngvl=16, max_nge=256 * mult, max_ngel=16 * mult,
        max_npv=8, max_npvl=16, max_npe=8 * mult, max_npel=16 * mult,
        hid_dim=64, rep_num_pattern_layers=3, rep_num_graph_layers=3,
        pred_hid_dim=64, filter_net="ScalarFilter",
        pred_return_weights="nodeedge")


def entry(device="cuda"):
    """(fn, args) of the flagship forward: fn(*args) -> (pred_c, pred_v,
    pred_e) of 8 pairs, random weights from seed 0, on `device`."""
    model = build_model(_flagship_config(), device=device, seed=0)
    pattern, graph = _make_batch(8, 8, 8, 64, 256, 16, 16)

    def forward(pattern, graph):
        with torch.inference_mode():
            out = model(pattern.to(device), graph.to(device))
        return out["pred_c"], out["pred_v"], out["pred_e"]

    return forward, (pattern, graph)


def _adam(model, lr: float) -> TorchOptimizer:
    """optax.adam(lr)."""
    return TorchOptimizer(model.parameters(), torch.optim.Adam, lr=lr,
                          betas=(0.9, 0.999), eps=1e-8)


def _finite(name: str, losses) -> None:
    values = np.atleast_1d(np.asarray(losses, np.float64))
    if not np.isfinite(values).all():
        raise RuntimeError(f"dry run: non-finite {name} loss: {losses}")


def _dp_step(world: World) -> float:
    """One data-parallel SCM step (__graft_entry__.py:123-175)."""
    dev, n = world.device, world.size
    cfg = ModelConfig(
        max_ngv=8, max_ngvl=4, max_nge=16, max_ngel=4,
        max_npv=4, max_npvl=4, max_npe=8, max_npel=4,
        hid_dim=16, rep_num_pattern_layers=2, rep_num_graph_layers=2,
        pred_hid_dim=16, filter_net="ScalarFilter",
        pred_return_weights="nodeedge")
    model = build_model(cfg, device=dev, seed=0)
    bsz = 2 * n
    pattern, graph = _make_batch(bsz, 4, 8, 8, 16, 4, 4, add_rev=False)
    pattern, graph, counts = dp.shard_batch(
        world, pattern, graph, torch.ones(bsz, 1))
    opt = TorchOptimizer(model.parameters(), torch.optim.AdamW, lr=1e-3,
                         betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-5)

    def mean(x):
        # this rank's rows' sum, summed over the ranks, over every row
        return all_reduce_sum(x.sum(), world) / (x.numel() * n)

    opt.zero_grad()
    with split_rows(model, world):
        out = model(pattern.to(dev), graph.to(dev))
        loss = (mean((out["pred_c"] - counts.to(dev)) ** 2)
                + 0.1 * (mean(out["pred_v"] ** 2) + mean(out["pred_e"] ** 2)))
        (loss / n).backward()
    all_reduce_grads(opt.params, world)
    opt.step()
    return loss.item()


def _edge_parallel_forward(world: World, rng) -> List[float]:
    """The demonstration layer at V 16, E 64, H 16, 2 layers
    (__graft_entry__.py:177-206) -> the sum of its node outputs and the
    sum over the ranks of their edge outputs' sums, which must be
    finite."""
    from .parallel.edge_partition import (edge_parallel_dmp_apply,
                                          init_edge_parallel_params,
                                          pad_to_multiple, shard_flat_edges)
    dev = world.device
    V, E, H = 16, 64, 16
    arrays = pad_to_multiple({
        "senders": rng.integers(0, V, E).astype(np.int32),
        "receivers": rng.integers(0, V, E).astype(np.int32),
        "rev_flag": rng.random(E) < 0.5,
    }, world.size)
    node_feat = torch.tensor(rng.normal(size=(V, H)), dtype=torch.float32,
                             device=dev)
    edge_feat = rng.normal(size=(len(arrays["senders"]), H)).astype(
        np.float32)
    params = init_edge_parallel_params(
        2, H, generator=torch.Generator().manual_seed(1), device=dev)
    sh = shard_flat_edges(world, dict(arrays, edge_feat=edge_feat), dev)
    with torch.inference_mode():
        h, e = edge_parallel_dmp_apply(
            params, node_feat, sh["edge_feat"], sh["senders"],
            sh["receivers"], sh["rev_flag"], sh["edge_mask"], V, world)
    if not (torch.isfinite(h).all() and torch.isfinite(e).all()):
        raise RuntimeError("dry run: non-finite demonstration layer output")
    return [float(h.sum()), float(all_reduce_sum(e.sum(), world))]


def _unc_runs(world: World, rng) -> Dict[str, object]:
    """The UNC part (__graft_entry__.py:208-331): three edge-partitioned
    steps, three halo steps, two halo steps under amp, one supervised
    step -> their losses."""
    from .ops.segment_kernel import attach_csr_plan
    from .parallel.ep_unc import (attach_ep_csr_plans, make_ep_train_step,
                                  pad_e_max, shard_sub)
    from .parallel.halo_unc import (halo_envelope, halo_rank_shard,
                                    make_halo_train_step)
    from .unc.data import (WholeGraph, compute_edgenorm, negative_sampling,
                           pad_subgraph, sample_subgraph_by_randomwalks)
    from .unc.driver import make_unc_supervised_step, to_device
    from .unc.model import UNCTrainModel

    dev, n = world.device, world.size
    Vn, En, R = 24, 96, 3
    src = rng.integers(0, Vn, En)
    dst = (src + rng.integers(1, Vn, En)) % Vn
    triplets = np.stack([src, rng.integers(0, R, En), dst], 1).astype(
        np.int64)
    g = WholeGraph(Vn, R, triplets)
    e_max = pad_e_max(2 * En, n)
    mkw = dict(num_nodes=Vn, num_rels=R, h_dim=16, nlabel=0,
               num_hidden_layers=2, dropout=0.0, reg_param=0.01,
               backbone="DMPNN")
    rng_np = np.random.default_rng(1)

    def make_sub():
        pos = triplets[rng_np.integers(0, En, 8)]
        neg = negative_sampling(pos, Vn, 2, rng_np)
        seeds = np.unique(pos[:, [0, 2]].reshape(-1))
        sub = sample_subgraph_by_randomwalks(g, seeds, 2, 6, rng_np)
        samples = np.concatenate([pos, neg])
        lut = {int(v): i for i, v in enumerate(sub["nid"])}
        samples = samples.copy()
        samples[:, 0] = [lut.get(int(x), 0) for x in samples[:, 0]]
        samples[:, 2] = [lut.get(int(x), 0) for x in samples[:, 2]]
        labels = np.zeros(len(samples), np.float32)
        labels[: len(pos)] = 1.0
        return pad_subgraph(sub, samples, labels, Vn, e_max, 32,
                            edge_norm=compute_edgenorm(sub), send_keys=True)

    first = make_sub()
    init = UNCTrainModel(generator=torch.Generator().manual_seed(2), **mkw)
    out = {}

    model = copy.deepcopy(init).to(dev)
    step = make_ep_train_step(model, _adam(model, 1e-2), world)
    losses = []
    for k in range(3):
        shard = attach_ep_csr_plans(shard_sub(make_sub() if k else first,
                                              world), sender_plan=True)
        losses.append(float(step(to_device(shard, dev))))
    out["ep"] = losses

    env = halo_envelope(Vn, e_max, n)
    for name, amp, steps in (("halo", False, 3), ("halo_amp", True, 2)):
        model = copy.deepcopy(init).to(dev)
        step = make_halo_train_step(model, _adam(model, 1e-2), world,
                                    amp=amp)
        losses = []
        for k in range(steps):
            padded = first if (k == 0 and not amp) else make_sub()
            shard, _ = halo_rank_shard(padded, world, env, sender_plan=True)
            losses.append(float(step(to_device(shard, dev))))
        out[name] = losses

    sup = UNCTrainModel(generator=torch.Generator().manual_seed(3),
                        multi=False, **dict(mkw, nlabel=4)).to(dev)
    sup_step = make_unc_supervised_step(sup, _adam(sup, 1e-2), multi=False)
    lmax = 8
    ml = torch.tensor(rng_np.integers(0, 4, lmax), device=dev)
    mi = torch.tensor(rng_np.integers(0, Vn, lmax), device=dev)
    mm = torch.ones(lmax, dtype=torch.bool, device=dev)
    out["supervised"] = float(sup_step(
        to_device(attach_csr_plan(first, sender_plan=True), dev), ml, mi,
        mm))
    return out


def _dp_train_epoch(world: World) -> float:
    """One data-parallel epoch through the command line's configuration
    (__graft_entry__.py:333-358) -> its mean total loss."""
    from .cli.config import (get_train_config, process_model_config,
                             to_model_config)
    from .data.dataset import GraphAdjDataset
    from .data.synthetic import generate_pair
    from .train.samplers import BucketSampler
    from .train.scm_driver import (dp_replicate_state, make_optimizer,
                                   make_train_step, train_epoch)

    n = world.size
    config = get_train_config([
        "--dp_devices", str(n), "--train_batch_size", str(2 * n),
        "--hid_dim", "16", "--pred_hid_dim", "16",
        "--rep_num_pattern_layers", "2", "--rep_num_graph_layers", "2",
        "--max_npv", "4", "--max_npe", "8", "--max_npvl", "4",
        "--max_npel", "4", "--max_ngv", "8", "--max_nge", "16",
        "--max_ngvl", "4", "--max_ngel", "4",
        "--match_weights", "nodeedge", "--device", world.device.type])
    rng_dp = np.random.default_rng(7)
    data = [generate_pair(rng_dp, pv=4, pe=8, gv=8, ge=16,
                          num_vlabels=4, num_elabels=4,
                          p_v_max=4, p_e_max=8, g_v_max=8, g_e_max=16,
                          pair_id=f"DP{i}")
            for i in range(2 * n)]
    ds = GraphAdjDataset(data)
    model = build_model(to_model_config(process_model_config(config)),
                        device=world.device, seed=5)
    tx = make_optimizer(model.parameters(), config["lr"])
    step = make_train_step(model, tx, config["bp_loss"],
                           config["match_weights"], world=world)
    dp_replicate_state(step)
    sampler = BucketSampler(ds.sizes(), ["g_len", "p_len"],
                            config["train_batch_size"], seed=0)
    totals = train_epoch(step, ds, sampler, {**config, "train_epochs": 1}, 0)
    return totals["total"]


def dryrun_multichip(world: World) -> Dict[str, object]:
    """The dry run as one rank of `world` -> its losses by part (each a
    float or a list of floats), every one finite."""
    rng = np.random.default_rng(0)
    out = {"dp_step": _dp_step(world),
           "edge_parallel_sums": _edge_parallel_forward(world, rng)}
    out.update(_unc_runs(world, rng))
    out["dp_train_epoch"] = _dp_train_epoch(world)
    for name, losses in out.items():
        _finite(name, losses)
    return out


def main(argv=None) -> List[Dict[str, object]]:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=None,
                    help="ranks of the dry run (default: one a visible "
                    "card, 2 on the CPU)")
    ap.add_argument("--backend", type=str, default=None,
                    choices=(None, "gloo", "nccl"))
    ap.add_argument("--device", type=str, default="cuda")
    args = ap.parse_args(argv)
    on_cpu = torch.device(args.device).type == "cpu"
    if not on_cpu and not torch.cuda.is_available():
        raise SystemExit("dryrun: no CUDA device (pass --device cpu to run "
                         "on the CPU)")
    n = args.ranks or (2 if on_cpu else torch.cuda.device_count())
    fn, fargs = entry(args.device)
    print("entry() ok:", [tuple(o.shape) for o in fn(*fargs)])
    backend, devices = launch_plan(n, args.device, args.backend)
    with tempfile.TemporaryDirectory() as tmp:
        ranks = launch(dryrun_multichip, n, backend=backend, devices=devices,
                       init_file=os.path.join(tmp, "rdv"), timeout=None,
                       threads=rank_threads(devices))
    for r, losses in enumerate(ranks):
        if losses != ranks[0]:
            raise RuntimeError(f"dry run: rank {r}'s losses {losses} differ "
                               f"from rank 0's {ranks[0]}")
    print(f"dryrun_multichip ok over {n} ranks ({backend}):", ranks[0])
    return ranks


if __name__ == "__main__":
    main()
