"""UNC training and embedding export (dualmessagepassing_tpu/unc/
driver.py: make_unc_optimizer 34-40, make_unc_train_step 43-67,
make_unc_embed_step 70-76, sample_batch 79-101, train_unc 273-689).

train_unc trains the DMPNN on sampled subgraphs, one device: each batch
of graph_batch_size triplets is sampled on the host by a 2-thread
prefetch pool, padded to the static (v_max, e_max) envelope, given the
kernels' CSR plans, and taken through a loss, a backward and a clipped
Adam step with a cosine learning rate; an epoch whose mean loss rises
stops the loop (reference main.py:48-183). It then exports node
embeddings over sampled subgraphs: each request of 4 * graph_batch_size
triplets runs the model forward and folds into the embedding table with
the coverage-weighted moving average
    emb[nid] = emb[nid] * (1 - c) + h * c,   c = (subdeg + 1) / (deg + 1)
(reference main.py:184-209).

The JAX driver's sharding and TPU-gate arguments (ep_*, halo_*,
scatter_backend, pad_cols, recv_bcast, sender_windowed, endpoint_gather)
have no counterpart: every choice among them computes the numbers of
the one composition this package has.
"""

from __future__ import annotations

import math
import os
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterable, Optional

import numpy as np
import torch

from ..ops.segment_kernel import attach_csr_plan
from ..train.checkpoint import (restore_unc_checkpoint, rng_from_state,
                                save_unc_checkpoint)
from .data import (
    WholeGraph,
    compute_edgenorm,
    convert_subgraph_nids,
    edge_dropout,
    negative_sampling,
    pad_subgraph,
    sample_subgraph_by_neighbors,
    sample_subgraph_by_randomwalks,
)
from .model import UNCTrainModel, apply_unc_forward


def sample_batch(graph: WholeGraph, edges: np.ndarray, sampler: str,
                 depth: int, width: int, split_size: float,
                 negative_rate: int, v_max: int, e_max: int, s_max: int,
                 rng, send_keys: bool = False) -> Dict[str, np.ndarray]:
    """generate_sampled_graph_and_labels_unsupervised + padding
    (utils.py:399-434); the JAX package's sample_batch with the same
    send_keys (True for training: the sender sort; the sort draws no
    random numbers, so the RNG stream is the same either way)."""
    neg = negative_sampling(edges, graph.num_nodes, negative_rate, rng)
    seeds = np.unique(np.concatenate(
        [edges[:, 0], edges[:, 2], neg[:, 0], neg[:, 2]]))
    if sampler == "neighbor":
        sub = sample_subgraph_by_neighbors(graph, seeds, depth, width, rng)
    else:
        sub = sample_subgraph_by_randomwalks(graph, seeds, depth, width, rng)
    samples = np.concatenate([edges, neg])
    samples = samples.copy()
    samples[:, 0] = convert_subgraph_nids(samples[:, 0], sub["nid"])
    samples[:, 2] = convert_subgraph_nids(samples[:, 2], sub["nid"])
    sub = edge_dropout(sub, split_size, rng)
    labels = np.zeros(len(samples), np.float32)
    labels[: len(edges)] = 1.0
    norm = compute_edgenorm(sub)
    return pad_subgraph(sub, samples, labels, v_max, e_max, s_max,
                        edge_norm=norm, send_keys=send_keys)


def to_device(padded: Dict[str, object], device) -> Dict[str, object]:
    """numpy arrays -> tensors on `device`; scalars (n_real) stay ints."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in padded.items()}


class UNCOptimizer:
    """optax.chain(clip_by_global_norm(grad_norm), scale_by_adam(),
    scale_by_schedule(-cosine_decay_schedule(lr, T, alpha=3e-6 / lr)))
    over a model's parameters (driver.py:34-40).

    Clipping is written out because torch.nn.utils.clip_grad_norm_
    divides by norm + 1e-6 and optax does not: gradients whose global
    norm is at least grad_norm become g / norm * grad_norm. Adam is
    torch.optim.Adam (betas 0.9/0.999, eps 1e-8, no weight decay). The
    learning rate of each step is the closed form of the cosine schedule
    at the number of earlier updates, as optax counts."""

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 total_steps: int, grad_norm: float = 1.0):
        self.params = list(params)
        self.lr = lr
        self.total_steps = max(total_steps, 1)
        self.alpha = 3e-6 / lr
        self.grad_norm = grad_norm
        self.adam = torch.optim.Adam(self.params, lr=lr, betas=(0.9, 0.999),
                                     eps=1e-8, weight_decay=0.0)
        self.count = 0

    def schedule(self, count: int) -> float:
        c = min(count, self.total_steps)
        cosine = 0.5 * (1.0 + math.cos(math.pi * c / self.total_steps))
        return self.lr * ((1.0 - self.alpha) * cosine + self.alpha)

    def zero_grad(self) -> None:
        self.adam.zero_grad(set_to_none=True)

    @torch.no_grad()
    def step(self) -> None:
        for p in self.params:
            if p.grad is None:          # optax updates every leaf
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in self.params]
        norm = torch.sqrt(sum((g.float() ** 2).sum() for g in grads))
        keep = norm < self.grad_norm
        for g in grads:
            g.copy_(torch.where(keep, g, g / norm * self.grad_norm))
        for group in self.adam.param_groups:
            group["lr"] = self.schedule(self.count)
        self.adam.step()
        self.count += 1

    def state_dict(self) -> dict:
        return {"adam": self.adam.state_dict(), "count": self.count}

    def load_state_dict(self, state: dict) -> None:
        self.adam.load_state_dict(state["adam"])
        self.count = int(state["count"])


def make_unc_optimizer(model: torch.nn.Module, lr: float, total_steps: int,
                       grad_norm: float = 1.0) -> UNCOptimizer:
    return UNCOptimizer(model.parameters(), lr, total_steps, grad_norm)


def make_unc_train_step(model: UNCTrainModel, optimizer: UNCOptimizer,
                        amp: bool = False) -> Callable:
    """sub (tensors on the model's device, with the sender plan) -> loss
    (a 0-dim float32 tensor, before the update): one train-mode forward
    (the BatchNorm running statistics update in place), the DistMult
    loss, a backward and an optimizer step. amp=True runs the backbone
    in bf16 with float32 master parameters and a float32 loss
    (apply_unc_forward)."""

    def step(sub):
        optimizer.zero_grad()
        out = apply_unc_forward(model, sub, amp=amp, train=True)
        loss = model.unsupervised_loss(
            out, sub["edge_type"], sub["edge_mask"], sub["samples"],
            sub["labels"], sub["sample_mask"], sub["node_mask"])
        loss.backward()
        optimizer.step()
        return loss.detach()

    return step


def make_unc_embed_step(model: UNCTrainModel,
                        amp: bool = False) -> Callable:
    """sub (tensors on the model's device) -> node rows h [V, H] float32,
    eval-mode forward under torch.inference_mode()."""

    def embed(sub):
        with torch.inference_mode():
            return apply_unc_forward(model, sub, amp=amp, train=False)[0]

    return embed


def _cuda_ms(device: torch.device, fn: Callable):
    """(fn(), device milliseconds between CUDA events around it; None
    off CUDA). The events are read after fn's result is synchronised."""
    if device.type != "cuda":
        return fn(), None
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def export_embeddings(model: UNCTrainModel, graph: WholeGraph,
                      triplets: np.ndarray, graph_batch_size: int, *,
                      rng: np.random.Generator,
                      sampler: str = "randomwalk", sample_depth: int = 3,
                      sample_width: int = 10, graph_split_size: float = 0.5,
                      negative_rate: int = 5, amp: bool = False,
                      v_max: Optional[int] = None,
                      e_max: Optional[int] = None,
                      on_request: Optional[Callable[[dict], None]] = None,
                      log: Callable[[str], None] = print):
    """Coverage-weighted moving-average export (driver.py:641-689) ->
    (node_emb [N, H] float32 numpy, coverage fraction).

    Requests are consecutive slices of 4 * graph_batch_size triplets,
    sampled with `rng` exactly as the JAX package samples them. The
    envelope defaults to train_unc's: v_max = num_nodes, e_max =
    min(v_max * sample_width, graph.num_edges). `on_request`, if given,
    receives one dict per request: request index, host sampling ms,
    forward ms (CUDA events; None off CUDA), real edges and rows, and
    the coverage so far."""
    device = model.model.node_emb.device
    v_max = graph.num_nodes if v_max is None else v_max
    e_max = min(v_max * sample_width, graph.num_edges) if e_max is None \
        else e_max
    bsz = graph_batch_size * 4
    s_max = bsz * (1 + negative_rate)
    embed = make_unc_embed_step(model, amp=amp)
    node_emb = model.model.full_node_embeddings().detach().float().cpu() \
        .numpy().copy()
    seen = np.zeros(graph.num_nodes, bool)
    for i in range(math.ceil(len(triplets) / bsz)):
        edges = triplets[i * bsz: (i + 1) * bsz]
        t0 = time.perf_counter()
        subp = attach_csr_plan(sample_batch(
            graph, edges, sampler, sample_depth, sample_width,
            graph_split_size, negative_rate, v_max, e_max, s_max, rng))
        sample_ms = (time.perf_counter() - t0) * 1e3
        sub = to_device(subp, device)
        h, forward_ms = _cuda_ms(device, lambda: embed(sub))
        h = h.cpu().numpy()
        nm = subp["node_mask"]
        nid = subp["nid"][nm]
        sub_in_deg = np.bincount(subp["receivers"][subp["edge_mask"]],
                                 minlength=len(subp["nid"]))[nm]
        coef = (sub_in_deg + 1.0) / (graph.in_deg[nid] + 1.0)
        node_emb[nid] = (node_emb[nid] * (1 - coef[:, None])
                         + h[nm] * coef[:, None])
        seen[nid] = True
        if on_request is not None:
            on_request({"request": i, "sample_ms": sample_ms,
                        "forward_ms": forward_ms, "n_real": subp["n_real"],
                        "n_nodes": int(nm.sum()),
                        "coverage": float(seen.sum()) / graph.num_nodes})
    coverage = float(seen.sum()) / graph.num_nodes
    log(f"{coverage * 100:.1f}% node embeddings are saved.")
    return node_emb, coverage


def train_unc(model: UNCTrainModel, triplets: np.ndarray, num_nodes: int,
              num_rels: int, *, lr: float = 1e-2, negative_rate: int = 5,
              graph_batch_size: int = 10000, graph_split_size: float = 0.5,
              sampler: str = "randomwalk", sample_depth: int = 3,
              sample_width: int = 10, n_epochs: int = 50,
              grad_norm: float = 1.0, seed_nodes: Optional[set] = None,
              v_max: Optional[int] = None, e_max: Optional[int] = None,
              seed: int = 0, prefetch: int = 2,
              checkpoint_dir: Optional[str] = None, amp: bool = False,
              on_epoch: Optional[Callable[[dict], None]] = None,
              on_request: Optional[Callable[[dict], None]] = None,
              log: Callable[[str], None] = print):
    """Train `model` in place, then export -> (node_embeddings [N, h]
    float32 numpy, coverage fraction) (driver.py:273-689, one device).

    The model's parameters and device are the caller's (h_dim, n_layers,
    dropout and reg_param live on the model). Sampling draws from
    np.random.default_rng(seed) exactly as the JAX package draws: the
    first batch (which the JAX package samples to initialise and compile
    its step) is sampled and dropped; without seed_nodes n_epochs is
    rescaled to cover the graph's nodes (driver.py:361-363); each epoch
    shuffles the edges and spawns one Generator per batch, and the
    batches are sampled by `prefetch` threads, at most 2 * prefetch
    ahead. The loss is read after every step; an epoch whose mean loss is
    above the previous one's ends training after it. The export runs in
    float32, as the JAX package's.

    checkpoint_dir: after each epoch the model, optimizer state, loop
    clocks and the sampling RNG are saved under checkpoint_dir/latest
    (train/checkpoint.py), and a run finding one resumes from it. The JAX
    package does not restore its sampling RNG; this one does, so a
    resumed run continues as the uninterrupted one would.

    on_epoch, if given, receives after each epoch (and its checkpoint) a
    dict: epoch, loss, steps, the step losses, host sampling ms per batch
    (in the sampler threads), wait ms per step (the main loop blocked on
    the sampler), step ms (CUDA events; None off CUDA) and the epoch's
    wall-clock ms. on_request is export_embeddings'."""
    device = model.model.node_emb.device
    rng = np.random.default_rng(seed)
    graph = WholeGraph(num_nodes, num_rels, triplets)
    if seed_nodes:
        pool = np.asarray([
            i for i, t in enumerate(triplets)
            if int(t[0]) in seed_nodes or int(t[2]) in seed_nodes])
        train_edges = triplets[pool]
    else:
        train_edges = triplets
    n_batches = math.ceil(len(train_edges) / graph_batch_size)
    if not seed_nodes:
        n_epochs = math.ceil(
            n_epochs * n_batches * graph_batch_size / num_nodes)
    if v_max is None:
        v_max = num_nodes
    if e_max is None:
        e_max = min(v_max * sample_width, graph.num_edges)
    s_max = graph_batch_size * (1 + negative_rate)

    optimizer = make_unc_optimizer(model, lr, n_epochs * n_batches,
                                   grad_norm)
    step = make_unc_train_step(model, optimizer, amp=amp)

    def sample_and_prepare(edges, brng):
        t0 = time.perf_counter()
        padded = attach_csr_plan(sample_batch(
            graph, edges, sampler, sample_depth, sample_width,
            graph_split_size, negative_rate, v_max, e_max, s_max, brng,
            send_keys=True), sender_plan=True)
        return padded, (time.perf_counter() - t0) * 1e3

    sample_and_prepare(train_edges[:graph_batch_size], rng)   # RNG parity

    prev_loss = float("inf")
    start_epoch = 0
    ckpt_path = None
    if checkpoint_dir:
        ckpt_path = os.path.join(os.path.abspath(checkpoint_dir), "latest")
        if os.path.exists(ckpt_path):
            clocks = restore_unc_checkpoint(ckpt_path, model, optimizer)
            start_epoch = clocks["epoch"] + 1
            prev_loss = clocks["prev_loss"]
            rng = rng_from_state(clocks["rng"])
            log(f"resumed from {ckpt_path} at epoch {start_epoch}")

    log("training...")
    with ThreadPoolExecutor(max_workers=max(prefetch, 1)) as pool:
        for epoch in range(start_epoch, n_epochs):
            t_epoch = time.perf_counter()
            order = rng.permutation(len(train_edges))
            batch_list = [train_edges[order[i: i + graph_batch_size]]
                          for i in range(0, len(order), graph_batch_size)]
            child_rngs = rng.spawn(len(batch_list))
            window = max(2 * prefetch, 1)
            futures = {i: pool.submit(sample_and_prepare, batch_list[i],
                                      child_rngs[i])
                       for i in range(min(window, len(batch_list)))}
            losses, sample_ms, wait_ms, step_ms = [], [], [], []
            for i in range(len(batch_list)):
                t0 = time.perf_counter()
                padded, ms = futures.pop(i).result()
                wait_ms.append((time.perf_counter() - t0) * 1e3)
                sample_ms.append(ms)
                nxt = i + window
                if nxt < len(batch_list):
                    futures[nxt] = pool.submit(
                        sample_and_prepare, batch_list[nxt], child_rngs[nxt])
                sub = to_device(padded, device)
                loss, ms = _cuda_ms(device, lambda: step(sub))
                losses.append(float(loss))
                step_ms.append(ms)
            loss = sum(losses) / max(len(losses), 1)
            log(f"Epoch {epoch:05d} | Loss {loss:.4f}")
            if ckpt_path:
                save_unc_checkpoint(
                    ckpt_path, model, optimizer,
                    {"epoch": epoch,
                     "prev_loss": float(min(loss, prev_loss))}, rng)
            if on_epoch is not None:
                on_epoch({"epoch": epoch, "loss": loss, "steps": len(losses),
                          "losses": losses, "sample_ms": sample_ms,
                          "wait_ms": wait_ms, "step_ms": step_ms,
                          "wall_ms": (time.perf_counter() - t_epoch) * 1e3})
            if loss > prev_loss:
                break
            prev_loss = loss

    return export_embeddings(
        model, graph, triplets, graph_batch_size, rng=rng, sampler=sampler,
        sample_depth=sample_depth, sample_width=sample_width,
        graph_split_size=graph_split_size, negative_rate=negative_rate,
        amp=False, v_max=v_max, e_max=e_max, on_request=on_request, log=log)
