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
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F


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
) -> Dict[str, torch.Tensor]:
    """The training objective (train.py:624-661) and its parts."""
    bsz = counts.shape[0]
    pred_c = output["pred_c"]
    count_loss = bp_criterion(bp_loss, pred_c, counts, neg_slope)
    zero = torch.zeros((), dtype=torch.float32, device=counts.device)

    def match(pred, weights, mask_key):
        mask = output[mask_key].float()
        w = weights * mask
        p = pred * mask
        loss = _elementwise(bp_loss, F.leaky_relu(p, neg_slope), w).sum() / bsz
        reg = _elementwise(bp_loss, F.relu(p - pred_c) * mask,
                           torch.zeros_like(p)).sum() / bsz
        return loss, reg

    match_v_loss = match_v_reg = match_e_loss = match_e_reg = zero
    if node_weights is not None and output.get("pred_v") is not None:
        match_v_loss, match_v_reg = match(output["pred_v"], node_weights,
                                          "g_v_mask")
    if edge_weights is not None and output.get("pred_e") is not None:
        match_e_loss, match_e_reg = match(output["pred_e"], edge_weights,
                                          "g_e_mask")

    rep_reg = zero
    for rep_key, mask_key in (
        ("p_v_rep", "p_v_mask"), ("p_e_rep", "p_e_mask"),
        ("g_v_rep", "g_v_mask"), ("g_e_rep", "g_e_mask"),
    ):
        rep = output.get(rep_key)
        if rep is None:
            continue
        m = output[mask_key].float()[..., None]
        n = torch.clamp(m.sum(), min=1.0)
        # slope-1 leaky_relu is the identity (train.py:651)
        rep_reg = rep_reg + _elementwise(
            bp_loss, rep * m, torch.zeros_like(rep)).sum() / n

    total = (count_loss
             + rep_reg_w * rep_reg
             + match_loss_w * (match_v_loss + match_e_loss)
             + match_reg_w * (match_v_reg + match_e_reg))
    out = {
        "total": total,
        "count_loss": count_loss,
        "match_v_loss": match_v_loss,
        "match_e_loss": match_e_loss,
        "match_v_reg": match_v_reg,
        "match_e_reg": match_e_reg,
        "rep_reg": rep_reg,
    }
    if eval_metric and eval_metric != "AUC":
        # the per-step eval metric the reference logs (train.py:689-691)
        out["eval_metric"] = eval_criterion(eval_metric, pred_c, counts)
    return out
