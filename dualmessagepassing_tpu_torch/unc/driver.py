"""UNC embedding export — the serving path (dualmessagepassing_tpu/unc/
driver.py: sample_batch 79-101, make_unc_embed_step 70-76, and the export
loop of train_unc 641-689).

A trained DMPNN exports node embeddings over sampled subgraphs: each
request of 4 * graph_batch_size triplets is sampled on the host, padded
to the static (v_max, e_max) envelope, given the kernels' CSR plan, run
through the model forward on the model's device, and folded into the
embedding table with the coverage-weighted moving average
    emb[nid] = emb[nid] * (1 - c) + h * c,   c = (subdeg + 1) / (deg + 1)
(reference main.py:184-209). Training comes with the next slice.
"""

from __future__ import annotations

import math
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..ops.segment_kernel import attach_csr_plan
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
                 rng) -> Dict[str, np.ndarray]:
    """generate_sampled_graph_and_labels_unsupervised + padding
    (utils.py:399-434); the JAX package's sample_batch(send_keys=False)."""
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
                        edge_norm=norm)


def to_device(padded: Dict[str, object], device) -> Dict[str, object]:
    """numpy arrays -> tensors on `device`; scalars (n_real) stay ints."""
    return {k: (torch.from_numpy(np.ascontiguousarray(v)).to(device)
                if isinstance(v, np.ndarray) else v)
            for k, v in padded.items()}


def make_unc_embed_step(model: UNCTrainModel,
                        amp: bool = False) -> Callable:
    """sub (tensors on the model's device) -> node rows h [V, H] float32,
    eval-mode forward under torch.inference_mode()."""

    def embed(sub):
        with torch.inference_mode():
            return apply_unc_forward(model, sub, amp=amp, train=False)[0]

    return embed


def export_embeddings(model: UNCTrainModel, graph: WholeGraph,
                      triplets: np.ndarray, graph_batch_size: int, *,
                      rng: np.random.Generator,
                      sampler: str = "randomwalk", sample_depth: int = 3,
                      sample_width: int = 10, graph_split_size: float = 0.5,
                      negative_rate: int = 5, amp: bool = False,
                      on_request: Optional[Callable[[dict], None]] = None,
                      log: Callable[[str], None] = print):
    """Coverage-weighted moving-average export (driver.py:641-689) ->
    (node_emb [N, H] float32 numpy, coverage fraction).

    Requests are consecutive slices of 4 * graph_batch_size triplets,
    sampled with `rng` exactly as the JAX package samples them. The
    envelope is train_unc's default: v_max = num_nodes, e_max =
    min(v_max * sample_width, graph.num_edges). `on_request`, if given,
    receives one dict per request: request index, host sampling ms,
    forward ms (CUDA events; None off CUDA), real edges and rows, and
    the coverage so far."""
    device = model.model.node_emb.device
    v_max = graph.num_nodes
    e_max = min(v_max * sample_width, graph.num_edges)
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
        forward_ms = None
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            h = embed(sub)
            end.record()
            end.synchronize()
            forward_ms = start.elapsed_time(end)
        else:
            h = embed(sub)
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
