"""The numbers that decide `correct`, each against its limit.

Training cells compare readings of the program's first steps with the
reference's:
  loss1_gap          |L_prog - L_ref| / |L_ref| of the first step;
  loss_gap           the largest of these over the steps;
  grad_median_gap    the first gradient as the optimizer got it, leaf by
                     leaf: |norm_prog - norm_ref| over the larger of the
                     reference's norm of that leaf and of the median
                     leaf; the median of these over the leaves;
  change_median_gap  the parameters' change over the steps, the same
                     way, over the leaves whose reference gradient is at
                     least a thousandth of the median leaf's (leaves
                     whose gradient is nought to rounding move under
                     Adam by round-off alone).
The worst leaf's gaps, which the contract's default compares, swing
from seed to seed: a leaky-ReLU input within rounding of zero takes
either slope, and Adam's first, sign-like update carries such a flip
into the later steps. training_detail reports them beside the medians.
Answer cells compare each answer with the reference's: the largest
|a_prog - a_ref| over the batch's largest |a_ref|.
"""

from __future__ import annotations

import statistics
from typing import Dict, Iterable, Optional

import torch

GRAD_FLOOR = 1e-3


def loss_gap(prog: Iterable[float], ref: Iterable[float]) -> float:
    return max(abs(p - r) / max(abs(r), 1e-30) for p, r in zip(prog, ref))


def _norms(leaves: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            leaves.items()}


def leaf_gaps(prog: Dict[str, torch.Tensor],
              ref: Dict[str, torch.Tensor]) -> Dict[str, float]:
    """Each leaf's |norm_prog - norm_ref| / max(norm_ref, median leaf's
    norm_ref)."""
    if set(prog) != set(ref):
        raise KeyError(f"leaves differ: {sorted(set(prog) ^ set(ref))}")
    pn, rn = _norms(prog), _norms(ref)
    med = statistics.median(rn.values())
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in rn}


def moved_leaves(ref_grad: Dict[str, torch.Tensor]) -> list:
    """The leaves whose reference gradient is at least GRAD_FLOOR of the
    median leaf's."""
    norms = _norms(ref_grad)
    med = statistics.median(norms.values())
    return sorted(k for k, n in norms.items() if n >= GRAD_FLOOR * med)


def answer_gap(prog: torch.Tensor, ref: torch.Tensor,
               mask: Optional[torch.Tensor] = None) -> float:
    prog, ref = prog.double(), ref.double()
    if mask is not None:
        prog, ref = prog[mask], ref[mask]
    scale = float(ref.abs().max()) if ref.numel() else 0.0
    return float((prog - ref).abs().max()) / max(scale, 1e-30) \
        if ref.numel() else 0.0


def checks(values: Dict[str, float], limits: Dict[str, float]) -> dict:
    """name -> {"value", "limit"}; a value with no limit is refused."""
    missing = sorted(set(values) - set(limits))
    if missing:
        raise KeyError(f"no limit for {missing}")
    return {k: {"value": v, "limit": limits[k]} for k, v in values.items()}


def passed(table: dict) -> bool:
    return all(v["value"] == v["value"] and v["value"] <= v["limit"]
               for v in table.values())


def _changes(after, ref):
    keep = moved_leaves(ref["grad1"])
    return ({k: after[k] - ref["before"][k] for k in keep},
            {k: ref["after"][k] - ref["before"][k] for k in keep})


def training_readings(losses, grad1: Dict[str, torch.Tensor],
                      after: Dict[str, torch.Tensor], ref: dict) -> dict:
    """The program's first steps (losses, first gradient, leaves after
    the last step) against the reference's train_steps output."""
    med = statistics.median
    return {"loss1_gap": loss_gap(losses[:1], ref["losses"][:1]),
            "loss_gap": loss_gap(losses, ref["losses"]),
            "grad_median_gap": med(leaf_gaps(grad1, ref["grad1"]).values()),
            "change_median_gap": med(leaf_gaps(
                *_changes(after, ref)).values())}


def _worst(prog, ref):
    gaps = leaf_gaps(prog, ref)
    k = max(gaps, key=gaps.get)
    return {"leaf": k, "gap": gaps[k],
            "prog": float(torch.linalg.vector_norm(prog[k].double())),
            "ref": float(torch.linalg.vector_norm(ref[k].double()))}


def training_detail(losses, grad1, after, ref) -> dict:
    """Where the training readings come from: each step's loss gap, and
    the worst leaf of the gradient and of the change, with its norms."""
    change_p, change_r = _changes(after, ref)
    return {"loss_steps": [loss_gap([p], [r])
                           for p, r in zip(losses, ref["losses"])],
            "grad": _worst(grad1, ref["grad1"]),
            "change": _worst(change_p, change_r),
            "left_out_of_change": sorted(set(ref["grad1"]) - set(change_r))}
