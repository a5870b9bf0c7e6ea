"""SCM training losses (dualmessagepassing_tpu/train/losses.py:
_elementwise 29, bp_criterion 40, eval_criterion 47, scm_loss 52-137).

Reference: SubgraphCountingMatching/train.py:462-661.
  * bp_crit(pred, target, slope) = {MAE|MSE|SMSE}(leaky_relu(pred, slope),
    target); eval_crit takes relu instead (train.py:462-482).
  * match_v_loss = sum over the real graph nodes of the elementwise loss
    against the node weights, over bsz (the reference's mean * len over
    its unpadded batch); match_v_reg penalises weights above the count
    (train.py:634,645); the same for edges.
  * rep_reg = over the four reps, the elementwise loss against 0 summed
    over real rows and divided by their count (train.py:649-657).
Losses are float32 (the model's outputs come back float32 under amp).
Under data parallelism each part's sum and count are summed over the
ranks (scm_loss(world=...)): the count and match losses recombine
exactly over equal shards, the rep regulariser divides by the whole
batch's real row count (dualmessagepassing_tpu/train/losses.py:113-116).
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..parallel.dist import World, all_reduce_sum


def _elementwise(kind: str, pred: torch.Tensor,
                 target: torch.Tensor) -> torch.Tensor:
    if kind == "MAE":
        return (pred - target).abs()
    if kind == "MSE":
        return (pred - target) ** 2
    if kind == "SMSE":  # smooth_l1, beta = 1 (torch's default)
        d = (pred - target).abs()
        return torch.where(d < 1.0, 0.5 * d * d, d - 0.5)
    raise NotImplementedError(kind)


def bp_criterion(kind: str, pred: torch.Tensor, target: torch.Tensor,
                 neg_slope: float) -> torch.Tensor:
    """Mean loss on leaky-relu'd predictions (train.py:475-482)."""
    return _elementwise(kind, F.leaky_relu(pred, neg_slope), target).mean()


def eval_criterion(kind: str, pred: torch.Tensor,
                   target: torch.Tensor) -> torch.Tensor:
    """Mean metric on relu'd predictions (train.py:462-467)."""
    return _elementwise(kind, F.relu(pred), target).mean()


def scm_loss(
    output: Dict[str, torch.Tensor],
    counts: torch.Tensor,                       # [B, 1]
    node_weights: Optional[torch.Tensor],       # [B, V] or None
    edge_weights: Optional[torch.Tensor],       # [B, E] or None
    *,
    bp_loss: str = "MSE",
    neg_slope: float = 0.0,
    match_loss_w: float = 0.0,
    match_reg_w: float = 0.0,
    rep_reg_w: float = 0.0,
    eval_metric: Optional[str] = None,
    world: Optional[World] = None,
) -> Dict[str, torch.Tensor]:
    """The training objective (train.py:624-661) and its parts. Each part
    is a sum over the batch's rows over a count (the elements, bsz, or
    the real rows of a rep). With `world` (data parallelism: the batch's
    other rows on the other ranks) the sums and the counts are summed
    over the ranks in one all-reduce, so every rank gets the whole
    batch's losses, as the JAX package computes them over its sharded
    batch."""
    bsz = float(counts.shape[0])
    pred_c = output["pred_c"]
    c_dev = counts.device
    terms = {}                                  # name -> (sum, count)

    def mean_of(el):
        return el.sum(), float(el.numel())

    terms["count_loss"] = mean_of(_elementwise(
        bp_loss, F.leaky_relu(pred_c, neg_slope), counts))

    def match(pred, weights, mask_key):
        mask = output[mask_key].float()
        w = weights * mask
        p = pred * mask
        loss = _elementwise(bp_loss, F.leaky_relu(p, neg_slope), w).sum()
        reg = _elementwise(bp_loss, F.relu(p - pred_c) * mask,
                           torch.zeros_like(p)).sum()
        return (loss, bsz), (reg, bsz)

    if node_weights is not None and output.get("pred_v") is not None:
        terms["match_v_loss"], terms["match_v_reg"] = match(
            output["pred_v"], node_weights, "g_v_mask")
    if edge_weights is not None and output.get("pred_e") is not None:
        terms["match_e_loss"], terms["match_e_reg"] = match(
            output["pred_e"], edge_weights, "g_e_mask")

    for rep_key, mask_key in (
        ("p_v_rep", "p_v_mask"), ("p_e_rep", "p_e_mask"),
        ("g_v_rep", "g_v_mask"), ("g_e_rep", "g_e_mask"),
    ):
        rep = output.get(rep_key)
        if rep is None:
            continue
        m = output[mask_key].float()[..., None]
        # slope-1 leaky_relu is the identity (train.py:651)
        terms[rep_key] = (_elementwise(bp_loss, rep * m,
                                       torch.zeros_like(rep)).sum(), m.sum())
    if eval_metric and eval_metric != "AUC":
        # the per-step eval metric the reference logs (train.py:689-691)
        terms["eval_metric"] = mean_of(_elementwise(
            eval_metric, F.relu(pred_c), counts))

    sums = [t[0] for t in terms.values()]
    cnts = [t[1] for t in terms.values()]
    if world is not None:
        both = all_reduce_sum(torch.stack(sums + [
            c if torch.is_tensor(c) else torch.full((), c, device=c_dev)
            for c in cnts]), world)
        sums, cnts = list(both[: len(sums)]), list(both[len(sums):])
    parts = {name: s / (torch.clamp(c, min=1.0) if torch.is_tensor(c)
                        else max(c, 1.0))
             for name, s, c in zip(terms, sums, cnts)}

    zero = torch.zeros((), dtype=torch.float32, device=c_dev)
    rep_reg = zero
    for rep_key in ("p_v_rep", "p_e_rep", "g_v_rep", "g_e_rep"):
        if rep_key in parts:
            rep_reg = rep_reg + parts[rep_key]
    out = {"count_loss": parts["count_loss"]}
    for name in ("match_v_loss", "match_e_loss", "match_v_reg",
                 "match_e_reg"):
        out[name] = parts.get(name, zero)
    out["rep_reg"] = rep_reg
    out["total"] = (out["count_loss"]
                    + rep_reg_w * rep_reg
                    + match_loss_w * (out["match_v_loss"]
                                      + out["match_e_loss"])
                    + match_reg_w * (out["match_v_reg"]
                                     + out["match_e_reg"]))
    if "eval_metric" in parts:
        out["eval_metric"] = parts["eval_metric"]
    return {"total": out.pop("total"), **out}
