"""Subgraph-isomorphism ground truth of the SCM data
(dualmessagepassing_tpu/data/subiso.py, all of it, copied as numpy).

A subisomorphism is an injective node mapping m: V_p -> V_g such that
node labels match and every pattern edge (u, v, el) has a graph edge
(m(u), m(v), el). The enumerator and the edge-weight counter prefer the
C++ kernels of csrc/hostkernels.cpp (native.py) and fall back to the
Python versions below, which compute the same arrays.

Reference: SubgraphCountingMatching/dataset.py:54-108 (the numba weight
kernels); the reference datasets ship the subisomorphisms of an external
solver (utils/io.py:43-142).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from .. import native


def enumerate_subisomorphisms(
    p_senders: np.ndarray, p_receivers: np.ndarray, p_vlabels: np.ndarray,
    p_elabels: np.ndarray,
    g_senders: np.ndarray, g_receivers: np.ndarray, g_vlabels: np.ndarray,
    g_elabels: np.ndarray,
    max_count: int = 1_000_000,
    use_native: bool = True,
) -> np.ndarray:
    """All injective label-preserving mappings, [n_iso, n_pattern_nodes]."""
    if use_native and native.available():
        out = native.enumerate_subiso_native(
            p_senders, p_receivers, p_elabels, p_vlabels,
            g_senders, g_receivers, g_elabels, g_vlabels,
            max_count=max_count)
        if out is not None:
            return out
    n_p = len(p_vlabels)
    n_g = len(g_vlabels)
    # edge-label sets per graph (u, v)
    g_edge_set = {}
    for s, r, l in zip(g_senders, g_receivers, g_elabels):
        g_edge_set.setdefault((int(s), int(r)), set()).add(int(l))
    # pattern node -> [(neighbour, edge label, direction)]
    p_out = [[] for _ in range(n_p)]
    for s, r, l in zip(p_senders, p_receivers, p_elabels):
        p_out[int(s)].append((int(r), int(l), 0))
        p_out[int(r)].append((int(s), int(l), 1))
    candidates = [
        np.nonzero(g_vlabels == p_vlabels[i])[0].tolist() for i in range(n_p)
    ]

    results: List[List[int]] = []
    mapping = [-1] * n_p
    used = [False] * n_g

    def ok(i: int, g: int) -> bool:
        for nbr, el, drc in p_out[i]:
            m = mapping[nbr]
            if m < 0:
                continue
            key = (g, m) if drc == 0 else (m, g)
            labels = g_edge_set.get(key)
            if labels is None or el not in labels:
                return False
        return True

    def backtrack(i: int):
        if len(results) >= max_count:
            return
        if i == n_p:
            results.append(mapping.copy())
            return
        for g in candidates[i]:
            if not used[g] and ok(i, g):
                mapping[i] = g
                used[g] = True
                backtrack(i + 1)
                used[g] = False
                mapping[i] = -1

    backtrack(0)
    if not results:
        return np.zeros((0, n_p), dtype=np.int64)
    return np.asarray(results, dtype=np.int64)


def node_subiso_weights(num_nodes: int,
                        subisomorphisms: np.ndarray) -> np.ndarray:
    """Per-node occurrence counts (dataset.py:54-61)."""
    if subisomorphisms.size == 0:
        return np.zeros((num_nodes,), dtype=np.int64)
    return np.bincount(subisomorphisms.reshape(-1),
                       minlength=num_nodes).astype(np.int64)


def edge_subiso_weights(
    p_senders: np.ndarray, p_receivers: np.ndarray, p_elabels: np.ndarray,
    g_senders: np.ndarray, g_receivers: np.ndarray, g_elabels: np.ndarray,
    subisomorphisms: np.ndarray,
    use_native: bool = True,
) -> np.ndarray:
    """Per-graph-edge counts: for each subisomorphism and pattern edge
    (u, v, el), every graph edge (m(u), m(v), el) gets +1
    (dataset.py:69-108)."""
    weights = np.zeros((len(g_senders),), dtype=np.int64)
    if subisomorphisms.size == 0 or len(p_senders) == 0:
        return weights
    if use_native and native.available():
        n_g = int(max(g_senders.max(), g_receivers.max())) + 1
        out = native.edge_subiso_weights_native(
            p_senders, p_receivers, p_elabels,
            g_senders, g_receivers, g_elabels, n_g, subisomorphisms)
        if out is not None:
            return out
    idx: Dict[Tuple[int, int, int], List[int]] = {}
    for e, (s, r, l) in enumerate(zip(g_senders, g_receivers, g_elabels)):
        idx.setdefault((int(s), int(r), int(l)), []).append(e)
    for m in subisomorphisms:
        for s, r, l in zip(p_senders, p_receivers, p_elabels):
            for e in idx.get((int(m[s]), int(m[r]), int(l)), ()):
                weights[e] += 1
    return weights
