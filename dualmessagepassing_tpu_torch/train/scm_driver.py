"""SCM training and evaluation driver (dualmessagepassing_tpu/train/
scm_driver.py: make_optimizer 52-66, make_train_step 69-216,
make_eval_step 253, train_epoch 263-401, evaluate_epoch 404-485).

Reference: SubgraphCountingMatching/train.py:449-1061. The model and the
optimizer hold the training state (the JAX package's TrainState): a
train step updates them in place. Batches come from the samplers and
dataset.batchify on the CPU and are moved to the model's device here.

Evaluation metrics (train.py:847-1061): MAE, MSE, RMSE of the relu'd
counts, the AUC of count > 0 detection (unc/evaluate.roc_auc_score, no
scikit-learn), and MNED/MEED, the mean per-graph L1 distance between the
predicted and the gold node/edge weights.

A model whose sequence length changes (CNN's pooling, models/edgeseq.py)
has refine_node_weights / refine_edge_weights; the train step and the
evaluation take the weight targets through them to the predictions'
length (train.py:630,641).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..constants import MIN_PERCENT
from ..graph import GraphBatch
from ..parallel.dist import (World, all_reduce_grads, broadcast_object,
                             split_rows)
from ..parallel.dp import replicate, shard_rows
from ..unc.evaluate import roc_auc_score
from ..utils.amp import cast_floats
from .losses import scm_loss
from .schedules import lr_schedule, scalar_schedule


class SCMOptimizer:
    """optax.chain(clip_by_global_norm(max_grad_norm), scale_by_amsgrad(),
    add_decayed_weights(weight_decay), scale(-lr)) over a model's
    parameters (scm_driver.py:52-66, the reference's AdamW(amsgrad=True)
    with clipping at 8.0, train.py:1231), written out:

      g      <- g                 if ||g|| < max_grad_norm
                g / ||g|| * max_grad_norm   otherwise (global L2 norm)
      mu     <- 0.9 mu + 0.1 g,   nu <- 0.999 nu + 0.001 g^2
      nu_max <- max(nu_max, nu / (1 - 0.999^t))      (t = this step, >= 1)
      p      <- p + lr_mult * (-lr * (mu / (1 - 0.9^t) / (sqrt(nu_max)
                + 1e-8) + weight_decay * p))

    The max is taken over the BIAS-CORRECTED second moment, as optax
    does. torch.optim.AdamW(amsgrad=True) keeps the max of the raw moment
    and computes another update, so it is not used. lr_mult is the LR
    schedule's multiplier of the step (make_train_step applies it to the
    update, as the JAX step does)."""

    b1, b2, eps = 0.9, 0.999, 1e-8

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 weight_decay: float = 1e-5, max_grad_norm: float = 8.0):
        self.params = list(params)
        self.lr = lr
        self.weight_decay = weight_decay
        self.max_grad_norm = max_grad_norm
        self.count = 0
        self.state = [{k: torch.zeros_like(p, dtype=torch.float32)
                       for k in ("mu", "nu", "nu_max")}
                      for p in self.params]

    def zero_grad(self) -> None:
        for p in self.params:
            p.grad = None

    @torch.no_grad()
    def step(self, lr_mult: float = 1.0) -> None:
        # each line is one multi-tensor launch over all parameters; the
        # bias corrections are host floats, as a host-to-card copy per
        # parameter would wait for the card every step
        params = self.params
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in params]          # optax updates every leaf
        if self.max_grad_norm and self.max_grad_norm > 0:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(grads)))
            scale = torch.where(norm < self.max_grad_norm, 1.0,
                                self.max_grad_norm / norm)
            grads = torch._foreach_mul(grads, scale)
        self.count += 1
        # the corrections in float32, as optax computes them (1 - b^t
        # cancels: float32 keeps ~1e-5 of it, which nu_max shows)
        t = np.float32(self.count)
        c1 = float(np.float32(1.0) - np.float32(self.b1) ** t)
        c2 = float(np.float32(1.0) - np.float32(self.b2) ** t)
        mu, nu, nu_max = ([s[k] for s in self.state]
                          for k in ("mu", "nu", "nu_max"))
        torch._foreach_mul_(mu, self.b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - self.b1))
        torch._foreach_mul_(nu, self.b2)
        torch._foreach_add_(nu, torch._foreach_mul(
            torch._foreach_mul(grads, grads), 1.0 - self.b2))
        torch._foreach_maximum_(nu_max, torch._foreach_div(nu, c2))
        denom = torch._foreach_sqrt(nu_max)
        torch._foreach_add_(denom, self.eps)
        u = torch._foreach_div(mu, c1)
        torch._foreach_div_(u, denom)
        if self.weight_decay:
            torch._foreach_add_(u, torch._foreach_mul(params,
                                                      self.weight_decay))
        torch._foreach_mul_(u, -self.lr)
        torch._foreach_mul_(u, lr_mult)
        torch._foreach_add_(params, u)

    def state_dict(self) -> dict:
        return {"count": self.count, "state": self.state}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        for mine, theirs in zip(self.state, state["state"]):
            for k in mine:
                mine[k].copy_(theirs[k])


class MultiSteps:
    """optax.MultiSteps(inner, k) (the JAX CLI's --train_grad_steps,
    cli/scm_train.py:194-197): each step() folds the parameters'
    gradients into their running mean (acc + (g - acc) / (n + 1), optax's
    Welford form); every k-th call hands the mean to the inner optimizer,
    which applies its update and advances its own step count (the one
    its bias corrections use), and the mean restarts. The other calls
    leave the parameters as they are.

    count is the number of calls, as the JAX TrainState's step counts
    them: train_epoch's LR clock."""

    def __init__(self, inner: SCMOptimizer, k: int):
        if k < 1:
            raise ValueError(f"MultiSteps needs k >= 1, got {k}")
        self.inner = inner
        self.k = k
        self.params = inner.params
        self.count = 0
        self.mini_step = 0
        self.acc = [torch.zeros_like(p, dtype=torch.float32)
                    for p in self.params]

    def zero_grad(self) -> None:
        self.inner.zero_grad()

    @torch.no_grad()
    def step(self, lr_mult: float = 1.0) -> None:
        grads = [torch.zeros_like(p) if p.grad is None else p.grad
                 for p in self.params]
        delta = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(delta, float(self.mini_step + 1))
        torch._foreach_add_(self.acc, delta)
        self.count += 1
        self.mini_step += 1
        if self.mini_step < self.k:
            return
        for p, a in zip(self.params, self.acc):
            p.grad = a.clone()
        self.inner.step(lr_mult)
        torch._foreach_zero_(self.acc)
        self.mini_step = 0

    def state_dict(self) -> dict:
        return {"count": self.count, "mini_step": self.mini_step,
                "acc": self.acc, "inner": self.inner.state_dict()}

    def load_state_dict(self, state: dict) -> None:
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        for mine, theirs in zip(self.acc, state["acc"]):
            mine.copy_(theirs)
        self.inner.load_state_dict(state["inner"])


class TorchOptimizer:
    """A torch.optim optimizer over a parameter list with the interface
    the port's train steps call (.params, zero_grad, step(lr_mult)).
    Every parameter is updated, as optax updates every leaf: one without
    a gradient gets zeros first. lr_mult scales the step's learning
    rate, as an optax schedule scales the whole update. With
    torch.optim.AdamW it is optax.adamw: the decoupled decay of the old
    parameter plus m_hat / (sqrt(v_hat) + eps), each times lr."""

    def __init__(self, params: Iterable[torch.nn.Parameter], cls, **kw):
        self.params = list(params)
        self.opt = cls(self.params, **kw)
        self.lrs = [g["lr"] for g in self.opt.param_groups]

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self, lr_mult: float = 1.0) -> None:
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        for group, lr in zip(self.opt.param_groups, self.lrs):
            group["lr"] = lr * lr_mult
        self.opt.step()


def make_optimizer(params: Iterable[torch.nn.Parameter], lr: float,
                   weight_decay: float = 1e-5,
                   max_grad_norm: float = 8.0) -> SCMOptimizer:
    return SCMOptimizer(params, lr, weight_decay, max_grad_norm)


def model_device(model: torch.nn.Module) -> torch.device:
    return next(model.parameters()).device


def apply_model(model, pattern: GraphBatch, graph: GraphBatch,
                amp: bool = False, train: bool = False, generator=None):
    """The model's output dict; amp=True runs it in bf16 (float32 master
    parameters cast at use) and returns float32 tensors."""
    dtype = torch.bfloat16 if amp else torch.float32
    out = model(pattern, graph, train=train, dtype=dtype,
                generator=generator)
    return cast_floats(out, torch.float32) if amp else out


def refine_weights(model, kind: str,
                   w: Optional[torch.Tensor]) -> Optional[torch.Tensor]:
    """Weight targets w [B, L] through model.refine_{kind}_weights
    (kind "node" or "edge"), where the model has it."""
    fn = getattr(model, f"refine_{kind}_weights", None)
    if w is None or fn is None:
        return w
    return fn(w[..., None])[..., 0]


def auto_chunks(bsz: int) -> int:
    """The JAX step's automatic microbatch count: the largest k <=
    bsz // 128 that divides bsz (~128-pair chunks)."""
    k = max(bsz // 128, 1)
    while bsz % k:
        k -= 1
    return k


def make_train_step(model, tx: SCMOptimizer, bp_loss: str = "MSE",
                    return_weights: str = "none",
                    eval_metric: Optional[str] = None, amp: bool = False,
                    accum_chunks: Optional[int] = None,
                    generator: Optional[torch.Generator] = None,
                    world: Optional[World] = None) -> Callable:
    """-> step(pattern, graph, counts, node_weights, edge_weights,
    neg_slope, match_loss_w, match_reg_w, rep_reg_w, lr_mult) -> losses
    (a dict of 0-dim float32 tensors, before the update). The batch is on
    the model's device. One train-mode forward (BatchNorm statistics
    update in place, dropout draws from `generator`), scm_loss, a backward
    and one optimizer update.

    amp=True runs the model in bf16 with float32 master parameters and a
    float32 loss. accum_chunks=k > 1 takes the gradient as the mean over k
    equal microbatches (one update; the losses are the chunks' mean);
    None picks auto_chunks(bsz), as the JAX step does, and 1 never
    chunks. The rep regulariser is each chunk's per-element mean, as in
    the JAX package (scm_driver.py:99-107). The weight targets go through
    refine_weights first, for the whole batch (scm_driver.py:166-167).

    world (data parallelism, the JAX step's mesh; scm_driver.py:218-250):
    the step runs on every rank of `world`, each with its own rows of
    the batch (train_epoch collates them: shard_rows), and the model
    completes its BatchNorm statistics, the predict nets' largest
    lengths and the losses over the ranks (parallel/dist.py), so each
    rank computes the whole batch's losses. Each rank's backward is
    seeded with 1 / world.size and the gradients are summed over the
    ranks before the update, which is then the same on every rank.
    accum_chunks None means 1 under DP (the JAX step's auto rule: the
    rank's share is already a chunk); an explicit k splits each rank's
    rows into its shares of the JAX step's k microbatches. A batch that
    does not split (sharded=False: the ragged last batch of a
    curriculum epoch) is computed whole on every rank, as the JAX
    package replicates it: no cross-rank statistics, and the summed
    gradients, each seeded 1 / world.size, are the batch's gradient.

    The step carries .model, .optimizer, .world and .chunks (the
    microbatch count under DP)."""
    use_node_w = "node" in return_weights
    use_edge_w = "edge" in return_weights
    ranks = 1 if world is None else world.size

    def step(pattern, graph, counts, node_weights, edge_weights,
             neg_slope, match_loss_w, match_reg_w, rep_reg_w,
             lr_mult=1.0, sharded: bool = True) -> Dict[str, torch.Tensor]:
        bsz = counts.shape[0]
        if accum_chunks is not None:
            k = accum_chunks
        else:
            k = auto_chunks(bsz) if world is None else 1
        k = max(k, 1)
        if bsz % k:
            raise ValueError(
                f"batch size {bsz} not divisible by accum_chunks {k}")
        m = bsz // k
        split = world if sharded else None
        if use_node_w:
            node_weights = refine_weights(model, "node", node_weights)
        if use_edge_w:
            edge_weights = refine_weights(model, "edge", edge_weights)
        tx.zero_grad()
        sums: Dict[str, torch.Tensor] = {}
        with split_rows(model, split):
            for c in range(k):
                rows = slice(c * m, (c + 1) * m)
                out = apply_model(model, pattern.slice(rows),
                                  graph.slice(rows), amp=amp, train=True,
                                  generator=generator)
                losses = scm_loss(
                    out, counts[rows],
                    node_weights[rows] if use_node_w else None,
                    edge_weights[rows] if use_edge_w else None,
                    bp_loss=bp_loss, neg_slope=neg_slope,
                    match_loss_w=match_loss_w, match_reg_w=match_reg_w,
                    rep_reg_w=rep_reg_w, eval_metric=eval_metric,
                    world=split)
                seed = k * ranks
                (losses["total"] / seed if seed > 1
                 else losses["total"]).backward()
                for name, v in losses.items():
                    v = v.detach()
                    sums[name] = v if name not in sums else sums[name] + v
        if world is not None:
            all_reduce_grads(tx.params, world)
        tx.step(lr_mult)
        return {name: v / k for name, v in sums.items()} if k > 1 else sums

    step.model = model
    step.optimizer = tx
    step.world = world
    step.chunks = max(accum_chunks or 1, 1)
    return step


def dp_replicate_state(train_step: Callable) -> None:
    """Rank 0's model state (parameters and BatchNorm statistics) and
    optimizer state on every rank of train_step.world, in place: the
    counterpart of the JAX package's dp_replicate_state
    (scm_driver.py:244-250), called once before training."""
    world = train_step.world
    model, tx = train_step.model, train_step.optimizer
    replicate(world, model.state_dict().values())
    tx.load_state_dict(broadcast_object(world, tx.state_dict()))


def make_eval_step(model, amp: bool = False) -> Callable:
    """-> eval_step(pattern, graph) -> (pred_c, pred_v, pred_e, g_v_mask,
    g_e_mask): an eval-mode forward under torch.inference_mode(), float32
    outputs."""

    def eval_step(pattern: GraphBatch, graph: GraphBatch):
        with torch.inference_mode():
            out = apply_model(model, pattern, graph, amp=amp, train=False)
        return (out["pred_c"], out["pred_v"], out["pred_e"],
                out["g_v_mask"], out["g_e_mask"])

    eval_step.model = model
    return eval_step


def _mask(batch, name: str) -> torch.Tensor:
    """A GraphBatch's node_mask or edge_mask, an EdgeSeqBatch's mask."""
    m = getattr(batch, name, None)
    return batch.mask if m is None else m


def _to(x, device):
    return None if x is None else x.to(device, non_blocking=True)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def train_epoch(train_step: Callable, dataset, sampler,
                config: Dict[str, Any], epoch: int,
                log_fn: Optional[Callable[[str], None]] = None,
                writer=None, data_type: str = "train") -> Dict[str, float]:
    """One epoch over the sampler's batches (train.py:486-784), with the
    reference's two schedule clocks:
      * the scalar schedules (neg_pred_slp, the loss weights) advance on
        epoch * full_epoch_steps + batch_id, full_epoch_steps ignoring a
        curriculum's used_ratio (sampler.py:76-77, train.py:451-452);
      * the LR schedule advances once per yielded batch, cumulatively
        (the optimizer's update count).
    Returns the bsz-weighted mean of each loss over the epoch,
    edges_per_sec (real pattern + graph edges over the epoch's wall
    time), pairs_per_sec and the epoch's seconds (the device
    synchronised at its end). `writer` (anything with add_scalar) gets
    the reference's per-step scalars after the epoch.

    Under data parallelism (train_step.world) every rank draws the same
    batches from the same sampler and collates only its own rows
    (shard_rows; all of them for a batch that does not split), and the
    losses are the whole batch's on every rank."""
    device = model_device(train_step.model)
    world = getattr(train_step, "world", None)
    epoch_steps = len(sampler)
    full_epoch_steps = getattr(sampler, "full_len", epoch_steps)
    total_steps = config.get("train_epochs", 100) * max(full_epoch_steps, 1)
    neg_slp_s = scalar_schedule(config.get("neg_pred_slp", 0.2), total_steps)
    match_w_s = scalar_schedule(config.get("match_loss_w", 0.0), total_steps)
    match_r_s = scalar_schedule(config.get("match_reg_w", 0.0), total_steps)
    rep_r_s = scalar_schedule(config.get("rep_reg_w", 0.0), total_steps)
    lr_s = lr_schedule(
        config.get("scheduler", "constant"),
        num_warmup_steps=config.get("num_warmup_steps", 0),
        num_schedule_steps=config.get("num_schedule_steps", total_steps),
        num_cycles=config.get("num_cycles", 2),
        min_percent=config.get("min_percent", MIN_PERCENT))
    return_weights = config.get("pred_return_weights", "none")
    lr_step0 = train_step.optimizer.count

    # losses stay on the device until the epoch ends: reading one back
    # every step would wait for the device each step
    pending, sched_vals, bszs = [], [], []
    n = total_edges = 0
    host_sizes = dataset.sizes()
    t_epoch = time.perf_counter()
    for batch_id, idx in enumerate(sampler):
        rows = None if world is None else shard_rows(
            len(idx), world, train_step.chunks)
        mine = idx if rows is None else [idx[i] for i in rows]
        _, pattern, graph, counts, (nw, ew) = dataset.batchify(
            mine, return_weights)
        step = epoch * full_epoch_steps + batch_id     # scalar clock
        lr_mult = lr_s(lr_step0 + batch_id)            # LR clock
        # placeholder targets; an EdgeSeqBatch has one mask for both
        if nw is None:
            nw = torch.zeros(_mask(graph, "node_mask").shape)
        if ew is None:
            ew = torch.zeros(_mask(graph, "edge_mask").shape)
        scal = dict(neg_slp=neg_slp_s(step), match_loss_w=match_w_s(step),
                    match_reg_w=match_r_s(step), rep_reg_w=rep_r_s(step),
                    lr=lr_mult * config.get("lr", 1e-3), step=step)
        losses = train_step(
            pattern.to(device, True), graph.to(device, True),
            _to(counts, device), _to(nw, device), _to(ew, device),
            scal["neg_slp"], scal["match_loss_w"], scal["match_reg_w"],
            scal["rep_reg_w"], lr_mult, **(
                {} if world is None else {"sharded": rows is not None}))
        bsz = len(idx)
        total_edges += sum(host_sizes[i]["g_len"] + host_sizes[i]["p_len"]
                           for i in idx)
        n += bsz
        pending.append(losses)
        sched_vals.append(scal)
        bszs.append(bsz)
        if log_fn and batch_id % config.get("log_every", 100) == 0 \
                and batch_id > 0:
            log_fn(f"epoch {epoch} step {batch_id}/{epoch_steps} "
                   f"loss {float(losses['total']):.6f}")
    _sync(device)
    dt = time.perf_counter() - t_epoch
    keys = tuple(pending[0]) if pending else ()
    pending = [{k: float(v[k]) for k in keys} for v in pending]
    totals = {k: sum(v[k] * b for v, b in zip(pending, bszs)) for k in keys}
    if writer is not None:
        bp = config.get("bp_loss", "MSE")
        em = config.get("eval_metric", "MAE")
        for losses, scal in zip(pending, sched_vals):
            s = scal["step"]
            if "eval_metric" in losses:
                writer.add_scalar("%s/eval-%s" % (data_type, em),
                                  losses["eval_metric"], s)
            writer.add_scalar("%s/train-%s" % (data_type, bp),
                              losses["total"], s)
            for name in ("lr", "neg_slp", "match_loss_w", "match_reg_w",
                         "rep_reg_w"):
                writer.add_scalar(f"train/{name}", scal[name], s)
            for name in ("match_v_loss", "match_e_loss", "match_v_reg",
                         "match_e_reg", "rep_reg"):
                writer.add_scalar(f"train/{name}", losses[name], s)
    out = {k: v / max(n, 1) for k, v in totals.items()}
    out["edges_per_sec"] = total_edges / dt if dt > 0 else 0.0
    out["pairs_per_sec"] = n / dt if dt > 0 else 0.0
    out["seconds"] = dt
    return out


def evaluate_epoch(eval_step: Callable, dataset, sampler,
                   return_weights: str = "none") -> Dict[str, Any]:
    """The evaluation metrics (train.py:847-1061) and the per-sample
    dumps; time_avg / time_total are the forward's wall time, the
    device synchronised, per sample and in all. The gold weights go
    through refine_weights of the eval step's model before the NED/EED
    sums (scm_driver.py:436-446)."""
    model = eval_step.model
    device = model_device(model)
    preds, golds, all_ids, neds, eeds = [], [], [], [], []
    t_total = 0.0
    n_items = 0
    for idx in sampler:
        ids, pattern, graph, counts, (nw, ew) = dataset.batchify(
            idx, return_weights)
        pattern, graph = pattern.to(device), graph.to(device)
        _sync(device)
        t0 = time.perf_counter()
        pred_c, pred_v, pred_e, g_v_mask, g_e_mask = eval_step(pattern,
                                                               graph)
        _sync(device)
        t_total += time.perf_counter() - t0
        n_items += counts.shape[0]
        all_ids.extend(ids)
        preds.append(pred_c.cpu().numpy()[:, 0])
        golds.append(counts.numpy()[:, 0])
        if pred_v is not None and nw is not None:
            vm = g_v_mask.cpu().numpy()
            pv = np.maximum(pred_v.cpu().numpy(), 0) * vm
            w = refine_weights(model, "node", nw).numpy()
            neds.append(np.abs(pv - w * vm).sum(axis=1))
        if pred_e is not None and ew is not None:
            em = g_e_mask.cpu().numpy()
            pe = np.maximum(pred_e.cpu().numpy(), 0) * em
            w = refine_weights(model, "edge", ew).numpy()
            eeds.append(np.abs(pe - w * em).sum(axis=1))

    pred = np.concatenate(preds) if preds else np.zeros(0)
    gold = np.concatenate(golds) if golds else np.zeros(0)
    pred_relu = np.maximum(pred, 0)
    ae = np.abs(pred_relu - gold)
    se = (pred_relu - gold) ** 2
    nan = float("nan")
    results: Dict[str, Any] = {
        "MAE": float(ae.mean()) if len(ae) else nan,
        "MSE": float(se.mean()) if len(se) else nan,
        "RMSE": float(np.sqrt(se.mean())) if len(se) else nan,
        "time_avg": t_total / max(n_items, 1),
        "time_total": t_total,
    }
    # AUC of count > 0 detection (train.py:1002-1015), both classes needed
    results["AUC"] = (float(roc_auc_score(gold > 0, pred_relu))
                      if len(gold) and (gold > 0).any()
                      and (gold <= 0).any() else nan)
    results["MNED"] = float(np.concatenate(neds).mean()) if neds else nan
    results["MEED"] = float(np.concatenate(eeds).mean()) if eeds else nan
    results["ids"] = all_ids
    results["predictions"] = pred_relu.tolist()
    results["counts"] = gold.tolist()
    results["AE"] = ae.tolist()
    results["SE"] = se.tolist()
    if neds:
        results["NED"] = np.concatenate(neds).tolist()
    if eeds:
        results["EED"] = np.concatenate(eeds).tolist()
    return results
