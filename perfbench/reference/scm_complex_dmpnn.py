"""Plain reference of the SCM Complex DMPNN model (the reference
repository's SubgraphCountingMatching: models/dmpnn.py, embed.py,
filter.py, pred.py's SumPredictNet, basemodel.py's GraphAdjModelV2;
train.py's loss, its AdamW(amsgrad) with clipping and its schedules), in
plain PyTorch: batched indexing for the gathers, index_add_ for the node
sums, float32 throughout. It imports nothing of the program.

Inputs are the benchmark's raw pairs (core/generators.scm_pairs): the
reference adds the reversed edges, encodes the labels and works out the
label filter, the degrees and the masks itself. The rows of each step
are the rows the program's sampler put in that batch.

The training targets follow the published command as the program's
command line runs it: train_epoch's config carries no
pred_return_weights, so the node-weight targets of a training step are
zeros (the matching loss trains toward zeros); the schedules are the
command line's defaults (config.py): neg_pred_slp anneal_cosine 1.0 to
0.01 with 2 cycles over train_epochs epochs, match_loss_w 0.1,
match_reg_w 1e-4, rep_reg_w 1e-4, the cosine-with-warmup-and-restart
rate with train.py's derived warmup, weight decay 1e-5, clipping at 8.

precision="tf32" is the control: every matmul with TF32 inputs.
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core.precision import Matmul

LEAKY = 1.0 / 5.5
B1, B2, EPS = 0.9, 0.999, 1e-8
CLI_DEFAULTS = {"neg_pred_slp": (1.0, 0.01), "match_loss_w": 0.1,
                "match_reg_w": 1e-4, "rep_reg_w": 1e-4, "weight_decay": 1e-5,
                "max_grad_norm": 8.0, "early_stop_rounds": 10,
                "num_cycles": 2}


def _flag(argv: List[str], name: str, cast=str):
    key = f"--{name}"
    return cast(argv[argv.index(key) + 1])


def enc_len(n: int, base: int = 2) -> int:
    """Digits of n - 1 in `base` (at least 1)."""
    x, k = max(n - 1, 0), 0
    while x > 0:
        x //= base
        k += 1
    return max(k, 1)


def multihot(n: int, base: int = 2) -> torch.Tensor:
    """[n, enc_len * base]: row i holds the one-hots of i's digits, most
    significant first."""
    k = enc_len(n, base)
    out = torch.zeros(n, k, base)
    for i in range(n):
        x = i
        for pos in range(k - 1, -1, -1):
            out[i, pos, x % base] = 1.0
            x //= base
    return out.reshape(n, k * base)


def hparams(config: dict) -> dict:
    argv = config["argv"]
    hp = {k: _flag(argv, k, int) for k in (
        "hid_dim", "pred_hid_dim", "rep_num_graph_layers", "max_npv",
        "max_npe", "max_npvl", "max_npel", "max_ngv", "max_nge",
        "max_ngvl", "max_ngel", "train_batch_size", "eval_batch_size",
        "train_epochs", "enc_base")}
    hp["lr"] = _flag(argv, "lr", float)
    hp.update(CLI_DEFAULTS)
    return hp


def param_spec(config: dict) -> Dict[str, tuple]:
    hp = hparams(config)
    h, ph = hp["hid_dim"], hp["pred_hid_dim"]
    base = hp["enc_base"]
    spec = {"g_emb_net.vl.weight": (
                (enc_len(hp["max_ngvl"], base) * base, h), "fan"),
            "g_emb_net.el.weight": (
                (enc_len(2 * hp["max_ngel"], base) * base, h), "fan")}
    for i in range(hp["rep_num_graph_layers"]):
        p = f"g_rep_net.dmpnn_{i}."
        for w in ("in", "out", "nloop", "src", "dst", "eloop"):
            spec[p + w + "_weight"] = ((h, h), "fan")
        spec[p + "nbias"] = ((h,), "vector")
        spec[p + "ebias"] = ((h,), "vector")
        for mlp in ("nmlp", "emlp"):
            for j in range(2):
                spec[f"{p}{mlp}.fc{j}.kernel"] = ((h, h), "fan")
                spec[f"{p}{mlp}.fc{j}.bias"] = ((h,), "vector")
    dims = {"p_fc": (h, ph), "g_fc": (h, ph),
            "weight_fc1": (4 * ph + 2, ph), "weight_fc2": (ph + 2, 1),
            "pred_fc1": (4 * ph + 4, ph), "pred_fc2": (ph + 4, 1)}
    for name, shape in dims.items():
        spec[f"pred_net_v.{name}.kernel"] = (shape, "fan")
        spec[f"pred_net_v.{name}.bias"] = ((shape[1],), "vector")
    return spec


def side(raw: dict, rows, prefix: str, n_el: int, device) -> dict:
    """One side (pattern "p" or graph "g") of the pairs `rows`, with the
    reversed edges appended (labels + n_el)."""
    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a[rows])).to(device)

    src, dst = t(raw[prefix + "_src"]), t(raw[prefix + "_dst"])
    el = t(raw[prefix + "_el"])
    e = src.shape[1]
    rev = torch.zeros(src.shape[0], 2 * e, dtype=torch.bool, device=device)
    rev[:, e:] = True
    return {"senders": torch.cat([src, dst], 1),
            "receivers": torch.cat([dst, src], 1),
            "el": torch.cat([el, el + n_el], 1),
            "vl": t(raw[prefix + "_vl"]), "rev": rev}


def batch(raw: dict, rows, hp: dict, device) -> dict:
    return {"p": side(raw, rows, "p", hp["max_npel"], device),
            "g": side(raw, rows, "g", hp["max_ngel"], device),
            "counts": torch.from_numpy(raw["counts"][rows]).to(device)[:, None]}


def gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, V, C] rows at idx [B, E] -> [B, E, C]."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[2]))


def scatter_sum(msg: torch.Tensor, idx: torch.Tensor, v: int) -> torch.Tensor:
    b, e, c = msg.shape
    flat = (idx + torch.arange(b, device=idx.device)[:, None] * v).reshape(-1)
    out = torch.zeros(b * v, c, dtype=msg.dtype, device=msg.device)
    return out.index_add_(0, flat, msg.reshape(-1, c)).reshape(b, v, c)


def dmp_layer(W, p, s, v, e, out_deg, mm):
    h = v.shape[2]
    w_src, w_dst = W[p + "src_weight"], W[p + "dst_weight"]
    hw = mm(v, torch.cat([w_src, w_dst], 1))
    ew_in, ew_out = mm(e, W[p + "in_weight"]), mm(e, W[p + "out_weight"])
    src_w, dst_w = gather(hw, s["senders"]), gather(hw, s["receivers"])
    rev = s["rev"][..., None]
    edge_msg = torch.where(rev, src_w[..., h:] - dst_w[..., :h],
                           dst_w[..., h:] - src_w[..., :h])
    agg = scatter_sum(torch.where(rev, ew_out, -ew_in), s["receivers"],
                      v.shape[1])

    def mlp(q, x):
        x = F.leaky_relu(mm(x, W[q + "fc0.kernel"]) + W[q + "fc0.bias"],
                         LEAKY)
        return mm(x, W[q + "fc1.kernel"]) + W[q + "fc1.bias"]

    v_out = mlp(p + "nmlp.", mm(v, W[p + "nloop_weight"]) + agg
                + W[p + "nbias"])
    d = torch.log2(1.0 + gather(out_deg[..., None], s["receivers"]))
    e_out = (mm(e, W[p + "eloop_weight"])
             + 2.0 * (1.0 + d) * mm(e, w_src - w_dst) + edge_msg
             + W[p + "ebias"])
    return v_out, mlp(p + "emlp.", e_out)


def rep(W, s, v, e, v_gate, e_gate, layers, mm):
    v, e = v * v_gate, e * e_gate
    n_v = v.shape[1]
    out_deg = scatter_sum(torch.ones_like(s["senders"], dtype=v.dtype)[
        ..., None], s["senders"], n_v)[..., 0]
    for i in range(layers):
        v_new, e_new = dmp_layer(W, f"g_rep_net.dmpnn_{i}.", s, v, e,
                                 out_deg, mm)
        v, e = v + v_new * v_gate, e + e_new * e_gate
    return v, e


def dense_parts(W, name, parts, mm):
    k = W[name + ".kernel"]
    y, off = None, 0
    for x in parts:
        term = mm(x, k[off: off + x.shape[-1]])
        y = term if y is None else y + term
        off += x.shape[-1]
    return y + W[name + ".bias"]


def predict(W, p_rep, g_rep, mm):
    """SumPredictNet with its weight head (every row of the Complex
    envelope is real, so the masks are all ones)."""
    b, lp, _ = p_rep.shape
    lg = g_rep.shape[1]
    pl = torch.full((b, 1), float(lp), device=p_rep.device)
    gl = torch.full((b, 1), float(lg), device=p_rep.device)
    p = dense_parts(W, "pred_net_v.p_fc", [p_rep], mm).sum(1)
    g_el = dense_parts(W, "pred_net_v.g_fc", [g_rep], mm)
    pe, pl_e, pli_e = p[:, None, :], pl[:, :, None], (1.0 / pl)[:, :, None]
    w = dense_parts(W, "pred_net_v.weight_fc1",
                    [pe, g_el, g_el - pe, g_el * pe, pl_e, pli_e], mm)
    w = dense_parts(W, "pred_net_v.weight_fc2", [F.relu(w), pl_e, pli_e],
                    mm)[..., 0]
    g = g_el.sum(1)
    y = dense_parts(W, "pred_net_v.pred_fc1", [torch.cat(
        [p, g, g - p, g * p, pl, gl, 1.0 / pl, 1.0 / gl], 1)], mm)
    y = dense_parts(W, "pred_net_v.pred_fc2", [torch.cat(
        [F.relu(y), pl, gl, 1.0 / pl, 1.0 / gl], 1)], mm)
    return y, w


def forward(W, bt, hp, mm) -> dict:
    tables = {k: multihot(n, hp["enc_base"]).to(bt["counts"].device)
              for k, n in (("vl", hp["max_ngvl"]),
                           ("el", 2 * hp["max_ngel"]))}
    p, g = bt["p"], bt["g"]

    def emb(s):
        return (mm(tables["vl"][s["vl"]], W["g_emb_net.vl.weight"]),
                mm(tables["el"][s["el"]], W["g_emb_net.el.weight"]))

    # the label filter: graph rows whose label the pattern has
    vl_gate = (g["vl"][:, :, None] == p["vl"][:, None, :]).any(2)
    el_gate = (g["el"][:, :, None] == p["el"][:, None, :]).any(2)
    layers = hp["rep_num_graph_layers"]
    ones_v = torch.ones(p["vl"].shape + (1,), device=p["vl"].device)
    ones_e = torch.ones(p["el"].shape + (1,), device=p["el"].device)
    p_v, p_e = rep(W, p, *emb(p), ones_v, ones_e, layers, mm)
    g_v, g_e = rep(W, g, *emb(g), vl_gate.float()[..., None],
                   el_gate.float()[..., None], layers, mm)
    pred_c, pred_v = predict(W, p_v, g_v, mm)
    return {"pred_c": pred_c, "pred_v": pred_v, "p_v_rep": p_v,
            "p_e_rep": p_e, "g_v_rep": g_v, "g_e_rep": g_e,
            "p_fwd": ~p["rev"], "g_fwd": ~g["rev"]}


def anneal_cosine(step: int, total: int, v1: float, v2: float,
                  cycles: int) -> float:
    progress = float(cycles * step) / max(1, total) % 1
    if step > total or progress >= 0.5:
        return v2
    return v1 + (v2 - v1) * (1 - math.cos(math.pi * progress * 2)) / 2


def lr_mult(step: int, hp: dict, n_pairs: int) -> float:
    """cosine_with_warmup_and_restart at train.py's derived warmup."""
    steps = n_pairs / hp["train_batch_size"]
    warmup = int(steps * 0.5 * min(hp["train_epochs"] * 0.06,
                                   hp["early_stop_rounds"]))
    min_percent = max(1e-3, hp["weight_decay"])
    schedule = int(steps * hp["train_epochs"]) - warmup
    cycles = max(1, schedule / 20000)
    if step < warmup:
        return step / max(1, warmup)
    progress = (step - warmup) / max(1, schedule - warmup)
    if progress >= 1.0:
        return min_percent
    return max(min_percent,
               0.5 * (1.0 + math.cos(math.pi * ((cycles * progress) % 1))))


def loss_fn(out: dict, counts: torch.Tensor, slope: float, hp: dict):
    mse = lambda a, b: (a - b) ** 2  # noqa: E731
    pred_c = out["pred_c"]
    bsz = float(counts.shape[0])
    count_loss = mse(F.leaky_relu(pred_c, slope), counts).mean()
    pv = out["pred_v"]
    match_loss = mse(F.leaky_relu(pv, slope), torch.zeros_like(pv)).sum() \
        / bsz
    match_reg = (F.relu(pv - pred_c) ** 2).sum() / bsz
    rep_reg = 0.0
    for key, fwd in (("p_v_rep", None), ("p_e_rep", "p_fwd"),
                     ("g_v_rep", None), ("g_e_rep", "g_fwd")):
        x = out[key]
        if fwd is None:
            rep_reg = rep_reg + (x ** 2).sum() / (x.shape[0] * x.shape[1])
        else:
            m = out[fwd].float()[..., None]
            rep_reg = rep_reg + ((x * m) ** 2).sum() / m.sum()
    return (count_loss + hp["rep_reg_w"] * rep_reg
            + hp["match_loss_w"] * match_loss + hp["match_reg_w"] * match_reg)


def train_steps(config: dict, raw: dict, rows: list, seed: int, device,
                precision: str = "float32") -> dict:
    """The first len(rows) steps (epoch 0, batches 0, 1, ...) from the
    benchmark's weights -> losses, the first clipped gradient, and the
    leaves before and after (on the CPU)."""
    from perfbench.core.weights import make_weights
    hp = hparams(config)
    spec = param_spec(config)
    names = sorted(spec)
    W = make_weights(spec, seed, device)
    before = {k: W[k].detach().cpu().clone() for k in names}
    for k in names:
        W[k].requires_grad_(True)
    state = {k: [torch.zeros_like(W[k]) for _ in range(3)] for k in names}
    mm = Matmul(precision, torch.device(device))
    n_pairs = len(raw["counts"])
    steps_per_epoch = math.ceil(n_pairs / hp["train_batch_size"])
    total = hp["train_epochs"] * steps_per_epoch
    v1, v2 = hp["neg_pred_slp"]
    losses, grad1 = [], None
    for t, r in enumerate(rows, start=1):
        bt = batch(raw, r, hp, device)
        slope = anneal_cosine(t - 1, total, v1, v2, hp["num_cycles"])
        with mm.mode():
            loss = loss_fn(forward(W, bt, hp, mm), bt["counts"], slope, hp)
            grads = torch.autograd.grad(loss, [W[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            if float(norm) >= hp["max_grad_norm"]:
                grads = [g * (hp["max_grad_norm"] / norm) for g in grads]
            if grad1 is None:
                grad1 = {k: g.cpu() for k, g in zip(names, grads)}
            # the bias corrections in float32, as the optimizer states them
            c1 = float(np.float32(1) - np.float32(B1) ** np.float32(t))
            c2 = float(np.float32(1) - np.float32(B2) ** np.float32(t))
            mult = lr_mult(t - 1, hp, n_pairs)
            for k, g in zip(names, grads):
                mu, nu, nu_max = state[k]
                mu.mul_(B1).add_(g, alpha=1 - B1)
                nu.mul_(B2).add_(g * g, alpha=1 - B2)
                torch.maximum(nu_max, nu / c2, out=nu_max)
                u = mu / c1 / (nu_max.sqrt() + EPS) + hp["weight_decay"] * W[k]
                W[k] -= hp["lr"] * mult * u
    return {"losses": losses, "grad1": grad1, "before": before,
            "after": {k: W[k].detach().cpu() for k in names}}


def eval_forward(config: dict, raw: dict, batches: list, seed: int, device,
                 precision: str = "float32") -> list:
    """Eval-mode predictions of each batch of pair rows -> [(pred_c [B, 1],
    pred_v [B, V])] on the CPU."""
    from perfbench.core.weights import make_weights
    hp = hparams(config)
    W = make_weights(param_spec(config), seed, device)
    mm = Matmul(precision, torch.device(device))
    out = []
    with torch.no_grad(), mm.mode():
        for rows in batches:
            o = forward(W, batch(raw, rows, hp, device), hp, mm)
            out.append((o["pred_c"].cpu(), o["pred_v"].cpu()))
    return out
