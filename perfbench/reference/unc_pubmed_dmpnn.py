"""Plain reference of UNC DMPNN training (the reference repository's
UnsupervisedNodeClassification/Model/DMPNN/src/model.py: DualGraphConv
117-280, DMPNN 283-328, TrainModel 632-737; main.py's clipped Adam with
a cosine rate), in plain PyTorch: indexing for the gathers, index_add_
for the node aggregation, float32 throughout. It imports nothing of the
program.

Inputs are the sampled batches the program's sampler drew in set-up
(sampling is a host stage outside the window; sample_faults checks it
on its own against the graph). From each batch the reference takes the
real prefix of the edge list, the node ids and the DistMult samples,
and works out again what the program derived from them: the global
out-degrees, the in-degree edge norm, and no kernel plan at all.

The model's dropout flag (0.2 in run.sh) changes nothing in DMPNN: the
reference layer calls dropout and discards its result (model.py:245,
260), so there is no mask to work out again.

train_steps(precision="tf32") is the control: every matmul with TF32
inputs (on the card the backend flag; on the CPU the inputs rounded to
TF32's 10-bit mantissa).
"""

from __future__ import annotations

import math
from typing import Dict, List

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.core.precision import Matmul

LEAKY = 1.0 / 5.5          # the reference's LeakyReLU slope
BN_EPS = 1e-5
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def _flag(argv: List[str], name: str, cast=str):
    for spelling in (f"--{name}", f"--{name.replace('-', '_')}"):
        if spelling in argv:
            return cast(argv[argv.index(spelling) + 1])
    raise KeyError(name)


def hparams(config: dict) -> dict:
    argv = config["argv"]
    return {"hidden": _flag(argv, "n-hidden", int),
            "layers": _flag(argv, "n-layers", int),
            "neg": _flag(argv, "negative-sample", int),
            "lr": _flag(argv, "lr", float),
            "reg": _flag(argv, "regularization", float),
            "grad_norm": _flag(argv, "grad-norm", float),
            "batch": _flag(argv, "graph-batch-size", int),
            "epochs": _flag(argv, "n-epochs", int),
            **config["data"]}


def param_spec(config: dict) -> Dict[str, tuple]:
    """The trained leaves and the BatchNorm statistics, by the names the
    program's state_dict gives them."""
    hp = hparams(config)
    h, r = hp["hidden"], hp["num_rels"]
    spec = {"w_relation": ((r, h), "fan"),
            "model.node_emb": ((hp["num_nodes"], h), "fan"),
            "model.rel_emb": ((2 * r, h), "fan"),
            "edge_fc.kernel": ((h, h), "fan"),
            "edge_fc.bias": ((h,), "vector")}
    for i in range(hp["layers"]):
        p = f"model.layers.{i}."
        for w in ("in", "out", "nloop", "src", "dst", "eloop"):
            spec[p + w + "_weight"] = ((h, h), "fan")
        spec[p + "nbias"] = ((h,), "vector")
        spec[p + "ebias"] = ((h,), "vector")
        for mlp in ("nmlp", "emlp"):
            q = p + mlp + "."
            spec[q + "fc0_kernel"] = ((h, h), "fan")
            spec[q + "fc1_kernel"] = ((h, h), "fan")
            spec[q + "fc0_bias"] = ((h,), "vector")
            spec[q + "fc1_bias"] = ((h,), "vector")
            spec[q + "bn.weight"] = ((h,), "scale")
            spec[q + "bn.bias"] = ((h,), "vector")
            spec[q + "bn.running_mean"] = ((h,), "mean")
            spec[q + "bn.running_var"] = ((h,), "var")
    return spec


def trained(spec: dict) -> List[str]:
    return sorted(k for k in spec if "running_" not in k)


def batch_tensors(batch: dict, device) -> dict:
    """The real prefix of one sampled batch, and what the program derived
    from it worked out again: out-degrees and the in-degree edge norm."""
    e = int(np.asarray(batch["edge_mask"]).sum())
    v = int(np.asarray(batch["node_mask"]).sum())
    s = int(np.asarray(batch["sample_mask"]).sum())
    snd = np.asarray(batch["senders"])[:e]
    rcv = np.asarray(batch["receivers"])[:e]
    in_deg = np.bincount(rcv, minlength=v).astype(np.float64)
    norm = (1.0 / in_deg[rcv]).astype(np.float32)
    out_deg = np.bincount(snd, minlength=v).astype(np.float32)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(device)

    return {"nid": t(np.asarray(batch["nid"])[:v]),
            "senders": t(snd.astype(np.int64)),
            "receivers": t(rcv.astype(np.int64)),
            "edge_type": t(np.asarray(batch["edge_type"])[:e]),
            "rev": t(np.asarray(batch["rev_flag"])[:e]),
            "norm": t(norm)[:, None], "out_deg": t(out_deg),
            "samples": t(np.asarray(batch["samples"])[:s]),
            "labels": t(np.asarray(batch["labels"])[:s])}


def batch_norm(x, w, b):
    mean = x.mean(0)
    var = ((x - mean) ** 2).mean(0)
    return (x - mean) * torch.rsqrt(var + BN_EPS) * w + b


def update_mlp(W, p, x, mm):
    y = mm(x, W[p + "fc0_kernel"]) + W[p + "fc0_bias"]
    y = F.leaky_relu(batch_norm(y, W[p + "bn.weight"], W[p + "bn.bias"]),
                     LEAKY)
    return mm(y, W[p + "fc1_kernel"]) + W[p + "fc1_bias"]


def dual_graph_conv(W, p, b, h, z, mm, last: bool):
    hd = h.shape[1]
    w_src, w_dst = W[p + "src_weight"], W[p + "dst_weight"]
    deg = torch.log2(1.0 + b["out_deg"])[:, None]
    cols = torch.cat([mm(h, w_src), mm(h, w_dst), deg], 1)
    at_send, at_recv = cols[b["senders"]], cols[b["receivers"]]
    rev = b["rev"][:, None]
    edge_msg = torch.where(rev, at_send[:, hd:2 * hd] - at_recv[:, :hd],
                           at_recv[:, hd:2 * hd] - at_send[:, :hd])
    node_msg = torch.where(rev, mm(z, W[p + "out_weight"]),
                           -mm(z, W[p + "in_weight"])) * b["norm"]
    agg = torch.zeros_like(h).index_add_(0, b["receivers"], node_msg)
    n_out = update_mlp(W, p + "nmlp.", mm(h, W[p + "nloop_weight"]) + agg
                       + W[p + "nbias"], mm)
    d = at_recv[:, 2 * hd:2 * hd + 1]
    e_out = (mm(z, W[p + "eloop_weight"]) + edge_msg
             + 2.0 * (1.0 + d) * mm(z, w_src - w_dst) + W[p + "ebias"])
    e_out = update_mlp(W, p + "emlp.", e_out, mm)
    if not last:
        n_out, e_out = torch.tanh(n_out), torch.tanh(e_out)
    return n_out, e_out


def loss_fn(W, b, hp, mm):
    r, layers = hp["num_rels"], hp["layers"]
    h = W["model.node_emb"][b["nid"]]
    z = mm(F.one_hot(b["edge_type"], 2 * r).float(), W["model.rel_emb"])
    for i in range(layers):
        h, z = dual_graph_conv(W, f"model.layers.{i}.", b, h, z, mm,
                               last=i == layers - 1)
    onehot = F.one_hot(b["edge_type"], 2 * r).float()
    r_bar = mm(onehot.T, z) / (onehot.sum(0)[:, None] + 1e-8)
    s = b["samples"]
    rel = mm(F.one_hot(s[:, 1], r).float(), W["w_relation"])
    score = (h[s[:, 0]] * rel * h[s[:, 2]]).sum(1)
    y = b["labels"]
    bce = score.clamp(min=0) - score * y + torch.log1p(torch.exp(-score.abs()))
    predict = bce.mean()
    hd = h.shape[1]
    reg = (W["w_relation"] ** 2).mean() + (h ** 2).mean() + (z ** 2).mean() \
        + (r_bar ** 2).mean()
    fwd = b["edge_type"] < r
    diff = (mm(z, W["edge_fc.kernel"]) + W["edge_fc.bias"]
            - mm(F.one_hot(b["edge_type"].clamp(0, r - 1), r).float(),
                 W["w_relation"]))
    sq = (diff ** 2).sum(1)
    reg = reg + torch.where(fwd, sq, 0.0).sum() / (
        fwd.sum().clamp(min=1) * hd)
    return predict + hp["reg"] * reg


def learning_rate(hp: dict, count: int) -> float:
    """main.py's cosine decay to 3e-6 over the run's steps, at the
    number of earlier updates."""
    n_batches = math.ceil(hp["num_links"] / hp["batch"])
    total = math.ceil(hp["epochs"] * n_batches * hp["batch"]
                      / hp["num_nodes"]) * n_batches
    alpha = 3e-6 / hp["lr"]
    cosine = 0.5 * (1.0 + math.cos(math.pi * min(count, total) / total))
    return hp["lr"] * ((1.0 - alpha) * cosine + alpha)


def train_steps(config: dict, batches: list, seed: int, device,
                precision: str = "float32") -> dict:
    """The first len(batches) steps from the benchmark's weights ->
    losses, the first clipped gradient, the trained leaves before and
    after (on the CPU)."""
    from perfbench.core.weights import make_weights
    hp = hparams(config)
    spec = param_spec(config)
    names = trained(spec)
    W = make_weights(spec, seed, device)
    before = {k: W[k].detach().cpu().clone() for k in names}
    for k in names:
        W[k].requires_grad_(True)
    m = {k: torch.zeros_like(W[k]) for k in names}
    v = {k: torch.zeros_like(W[k]) for k in names}
    mm = Matmul(precision, torch.device(device))
    losses, grad1 = [], None
    for t, batch in enumerate(batches, start=1):
        b = batch_tensors(batch, device)
        with mm.mode():
            loss = loss_fn(W, b, hp, mm)
            grads = torch.autograd.grad(loss, [W[k] for k in names])
        losses.append(float(loss.detach()))
        with torch.no_grad():
            norm = torch.sqrt(sum((g ** 2).sum() for g in grads))
            if float(norm) >= hp["grad_norm"]:
                grads = [g / norm * hp["grad_norm"] for g in grads]
            if grad1 is None:
                grad1 = {k: g.cpu() for k, g in zip(names, grads)}
            lr = learning_rate(hp, t - 1)
            bc1, bc2 = 1.0 - B1 ** t, 1.0 - B2 ** t
            for k, g in zip(names, grads):
                m[k] = B1 * m[k] + (1.0 - B1) * g
                v[k] = B2 * v[k] + (1.0 - B2) * g * g
                denom = v[k].sqrt() / math.sqrt(bc2) + ADAM_EPS
                W[k] -= (lr / bc1) * m[k] / denom
    return {"losses": losses, "grad1": grad1, "before": before,
            "after": {k: W[k].detach().cpu() for k in names}}


def sample_faults(batch: dict, edges: np.ndarray, triplets: np.ndarray,
                  config: dict) -> int:
    """Rows of a sampled batch that break the sampler's contract: an edge
    not in the graph (forward, or reversed with its relation + R), a
    reversal flag that disagrees with the relation, a positive sample
    other than the batch's own link, a label out of place, or a negative
    that is not its positive with exactly one end replaced."""
    hp = hparams(config)
    n, r = hp["num_nodes"], hp["num_rels"]
    e = int(np.asarray(batch["edge_mask"]).sum())
    nid = np.asarray(batch["nid"])
    src = nid[np.asarray(batch["senders"])[:e]]
    dst = nid[np.asarray(batch["receivers"])[:e]]
    et = np.asarray(batch["edge_type"])[:e]
    rev = np.asarray(batch["rev_flag"])[:e]
    graph = np.concatenate([
        (triplets[:, 0] * 2 * r + triplets[:, 1]) * n + triplets[:, 2],
        (triplets[:, 2] * 2 * r + triplets[:, 1] + r) * n + triplets[:, 0]])
    faults = int((~np.isin((src * 2 * r + et) * n + dst, graph)).sum())
    faults += int((rev != (et >= r)).sum())
    s = int(np.asarray(batch["sample_mask"]).sum())
    smp = np.asarray(batch["samples"])[:s]
    lab = np.asarray(batch["labels"])[:s]
    glob = np.stack([nid[smp[:, 0]], smp[:, 1], nid[smp[:, 2]]], 1)
    p = len(edges)
    faults += int((glob[:p] != edges).any(1).sum())
    faults += int((lab[:p] != 1).sum() + (lab[p:] != 0).sum())
    pos = np.tile(edges, (hp["neg"], 1))
    neg = glob[p:]
    one_end = ((neg[:, 0] != pos[:, 0]) & (neg[:, 2] == pos[:, 2])) | \
        ((neg[:, 0] == pos[:, 0]) & (neg[:, 2] != pos[:, 2]))
    faults += int((~one_end | (neg[:, 1] != pos[:, 1])).sum())
    faults += int(s != p * (1 + hp["neg"]))
    return faults
