"""UNC host data pipeline for the export path: HIN loader, embedding
writer, whole-graph build, subgraph samplers, negative sampling, edge
dropout, edge norms and static-envelope padding.

A numpy copy of dualmessagepassing_tpu/unc/data.py:39-433 — the JAX
package cannot be imported on a machine without jax, since its
__init__ imports jax and flax. The arrays are identical to the JAX
package's under the same np.random.Generator (tests/test_torch_unc_data.py).
The supervised helpers (load_supervised, load_label, labeled edge
sampling) are not part of this slice, nor are the TPU-only padding keys
(the sender sort of pad_subgraph(send_keys=True) and the fused-endpoint
pair keys).

Reference: HKUST-KnowComp/DualMessagePassing,
UnsupervisedNodeClassification/Model/DMPNN/src/utils.py (loaders 168-240, samplers 279-434, negative sampling 539-551,
graph build 473-491, norms 437-453) and main.py:48-218.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np


# =============================================================================
# loaders (utils.py:218-258)
# =============================================================================

def load_unsupervised(link_path: str, node_path: Optional[str] = None,
                      attributed: bool = False):
    """-> (triplets [E, 3] (src, rel, dst), num_nodes, num_rels, attrs|None)."""
    triplets = []
    with open(link_path) as f:
        header = f.readline().split()
        num_nodes, num_rels = int(header[0]), int(header[1])
        for line in f:
            triplets.append([int(x) for x in line.split()])
    triplets = np.asarray(triplets, np.int64)
    attrs = None
    if attributed and node_path:
        attrs = _load_attrs(node_path)
    return triplets, num_nodes, num_rels, attrs


def _load_attrs(path: str) -> np.ndarray:
    attrs = {}
    with open(path) as f:
        for line in f:
            parts = line.rstrip("\n").split("\t")
            attrs[int(parts[0])] = np.asarray(parts[1].split(","), np.float32)
    return np.stack([attrs[k] for k in range(len(attrs))])


def save_embeddings(path: str, header: str, embs: np.ndarray,
                    index: Optional[np.ndarray] = None):
    """emb.dat writer with args header line (utils.py:243-258)."""
    with open(path, "w") as f:
        f.write(header + "\n")
        ids = range(len(embs)) if index is None else index
        for n, emb in zip(ids, embs):
            f.write(f"{n}\t" + " ".join(str(x) for x in emb) + "\n")


# =============================================================================
# whole graph (both directions; rel and rel + num_rels)
# =============================================================================

class WholeGraph:
    """Host CSR graph over the doubled edge set (utils.py:473-491)."""

    def __init__(self, num_nodes: int, num_rels: int, triplets: np.ndarray):
        self.num_nodes = num_nodes
        self.num_rels = num_rels
        src = np.concatenate([triplets[:, 0], triplets[:, 2]])
        dst = np.concatenate([triplets[:, 2], triplets[:, 0]])
        rel = np.concatenate([triplets[:, 1], triplets[:, 1] + num_rels])
        self.senders = src.astype(np.int64)
        self.receivers = dst.astype(np.int64)
        self.edge_type = rel.astype(np.int64)
        self.num_edges = len(src)
        # CSR by destination (in-edges) and by source (out-edges)
        self.in_order = np.argsort(dst, kind="stable")
        self.in_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(dst, minlength=num_nodes))])
        self.out_order = np.argsort(src, kind="stable")
        self.out_ptr = np.concatenate(
            [[0], np.cumsum(np.bincount(src, minlength=num_nodes))])
        self.in_deg = np.bincount(dst, minlength=num_nodes)
        self.out_deg = np.bincount(src, minlength=num_nodes)

    def in_edges(self, v: int) -> np.ndarray:
        return self.in_order[self.in_ptr[v]: self.in_ptr[v + 1]]

    def out_neighbors(self, v: int) -> np.ndarray:
        eids = self.out_order[self.out_ptr[v]: self.out_ptr[v + 1]]
        return self.receivers[eids]


# =============================================================================
# samplers
# =============================================================================

def _sample_in_edges(g: WholeGraph, nodes: np.ndarray, width: int, rng):
    """<=width in-edges per node, uniform without replacement
    (dgl.sampling.sample_neighbors(edge_dir='in') semantics).
    C++ fast path in csrc/hostkernels.cpp."""
    from .. import native
    if native.available() and len(nodes):
        out = native.sample_in_edges_native(
            g.in_ptr, g.in_order, np.asarray(nodes, np.int64), width,
            int(rng.integers(0, 2 ** 62)))
        if out is not None:
            return out
    eids = []
    for v in nodes:
        cand = g.in_edges(int(v))
        if len(cand) > width:
            cand = rng.choice(cand, size=width, replace=False)
        eids.append(cand)
    return np.concatenate(eids) if eids else np.zeros(0, np.int64)


def _finalize_subgraph(g: WholeGraph, nodes: np.ndarray, eids: np.ndarray,
                       seed_set: np.ndarray) -> Dict[str, np.ndarray]:
    """Drop isolated non-seeds, relabel ascending, package COO."""
    src = g.senders[eids]
    dst = g.receivers[eids]
    # kept = edge-touched nodes plus (possibly isolated) seeds
    # (utils.py:298-303: deg-0 nodes removed unless they are seeds)
    nid = np.unique(np.concatenate(
        [src, dst, np.asarray(seed_set, np.int64)]))
    return {
        "nid": nid,
        "senders": np.searchsorted(nid, src),
        "receivers": np.searchsorted(nid, dst),
        "edge_type": g.edge_type[eids].copy(),
        "rev_flag": (g.edge_type[eids] >= g.num_rels),
        "eids": eids,
    }


def sample_subgraph_by_randomwalks(g: WholeGraph, seeds: np.ndarray,
                                   depth: int = 2, width: int = 10,
                                   rng=None) -> Dict[str, np.ndarray]:
    rng = rng or np.random.default_rng()
    seeds_arr = np.asarray(seeds, np.int64)
    from .. import native
    if native.available() and width > 1 and len(seeds_arr):
        walks = native.random_walks_native(
            g.out_ptr, g.receivers[g.out_order], seeds_arr, depth,
            width - 1, int(rng.integers(0, 2 ** 62)))
        visited = walks.reshape(-1)
        nodes = np.unique(np.concatenate(
            [seeds_arr, visited[visited >= 0]]))
    else:
        node_sets = [seeds_arr]
        for _ in range(width - 1):
            # one walk of length `depth` per seed, following out-edges
            cur = seeds_arr.copy()
            alive = np.ones(len(cur), bool)
            visited = [cur.copy()]
            for _step in range(depth):
                nxt = np.full(len(cur), -1, np.int64)
                for i, v in enumerate(cur):
                    if not alive[i]:
                        continue
                    nbrs = g.out_neighbors(int(v))
                    if len(nbrs) == 0:
                        alive[i] = False
                    else:
                        nxt[i] = nbrs[rng.integers(0, len(nbrs))]
                cur = np.where(alive, np.maximum(nxt, 0), cur)
                visited.append(cur[alive].copy())
                if not alive.any():
                    break
            node_sets.append(np.concatenate(visited))
        nodes = np.unique(np.concatenate(node_sets))
    eids = _sample_in_edges(g, nodes, width, rng)
    return _finalize_subgraph(g, nodes, eids, np.asarray(seeds, np.int64))


def sample_subgraph_by_neighbors(g: WholeGraph, seeds: np.ndarray,
                                 depth: int = 2, width: int = 10,
                                 rng=None) -> Dict[str, np.ndarray]:
    rng = rng or np.random.default_rng()
    nodes = np.asarray(seeds, np.int64)
    for _ in range(depth - 1):
        eids = _sample_in_edges(g, nodes, width, rng)
        srcs = g.senders[eids]
        # reference keeps expansion nodes with out_deg > 0 (utils.py:329-330)
        srcs = srcs[g.out_deg[srcs] > 0]
        nodes = np.unique(np.concatenate([nodes, srcs]))
    eids = _sample_in_edges(g, nodes, width, rng)
    return _finalize_subgraph(g, nodes, eids, np.asarray(seeds, np.int64))


def negative_sampling(pos: np.ndarray, num_entity: int, rate: int,
                      rng=None) -> np.ndarray:
    rng = rng or np.random.default_rng()
    n = len(pos) * rate
    neg = np.tile(pos, (rate, 1))
    values = rng.integers(0, num_entity - 1, size=n)
    choices = rng.random(n)
    subj = choices > 0.5
    obj = ~subj
    neg[subj, 0] = values[subj] + (values[subj] >= neg[subj, 0])
    neg[obj, 2] = values[obj] + (values[obj] >= neg[obj, 2])
    return neg


def convert_subgraph_nids(ori: np.ndarray, nid: np.ndarray) -> np.ndarray:
    # nid is sorted ascending (subgraph relabeling), so a binary search
    # replaces the reference's numba dict loop (utils.py:554-564)
    return np.searchsorted(nid, np.asarray(ori, np.int64))


def edge_dropout(sub: Dict[str, np.ndarray], split_size: float,
                 rng=None) -> Dict[str, np.ndarray]:
    """Remove ~ (1 - split_size) * E random edges (utils.py:392-394)."""
    if split_size >= 1.0:
        return sub
    rng = rng or np.random.default_rng()
    n_e = len(sub["senders"])
    del_ids = np.unique(rng.integers(0, n_e, size=int(n_e * (1 - split_size))))
    keep = np.setdiff1d(np.arange(n_e), del_ids)
    out = dict(sub)
    for k in ("senders", "receivers", "edge_type", "rev_flag", "eids"):
        out[k] = sub[k][keep]
    return out


def compute_edgenorm(sub: Dict[str, np.ndarray], norm: str = "in") -> np.ndarray:
    """Reciprocal-degree per-edge norm with nan/inf -> finite-min quirk
    (utils.py:437-453)."""
    n = len(sub["nid"])
    in_deg = np.bincount(sub["receivers"], minlength=n).astype(np.float64)
    out_deg = np.bincount(sub["senders"], minlength=n).astype(np.float64)
    with np.errstate(divide="ignore", invalid="ignore"):
        if norm == "in":
            w = 1.0 / in_deg[sub["receivers"]]
        elif norm == "out":
            w = 1.0 / out_deg[sub["senders"]]
        else:
            w = 1.0 / np.sqrt(out_deg[sub["senders"]] * in_deg[sub["receivers"]])
    bad = ~np.isfinite(w)
    if bad.any():
        w[bad] = w[~bad].min() if (~bad).any() else 1.0
    return w.astype(np.float32)[:, None]


# =============================================================================
# padding to a static envelope
# =============================================================================

def pad_subgraph(sub: Dict[str, np.ndarray], samples: np.ndarray,
                 labels: np.ndarray, v_max: int, e_max: int, s_max: int,
                 edge_norm: Optional[np.ndarray] = None
                 ) -> Dict[str, np.ndarray]:
    """Pad a sampled subgraph + DistMult samples to static shapes.

    samples are (src, rel, dst) with subgraph-local node ids. Overflow of
    the envelope raises. Edges are stably sorted by receiver, pad rows at
    the tail keeping the last receiver id; every per-edge array carries
    the same permutation. The segment kernels rely on that order
    (ops/segment_kernel.attach_csr_plan). `out_deg` holds the global
    out-degrees. The output equals the JAX package's
    pad_subgraph(send_keys=False): the sender-sort keys serve only the
    TPU training path's sender cotangent.
    """
    n_v = len(sub["nid"])
    n_e = len(sub["senders"])
    n_s = len(samples)
    if n_v > v_max or n_e > e_max or n_s > s_max:
        raise ValueError(
            f"subgraph ({n_v}V, {n_e}E, {n_s}S) exceeds envelope "
            f"({v_max}, {e_max}, {s_max})")

    order = np.argsort(sub["receivers"], kind="stable")
    recv_fill = int(sub["receivers"][order[-1]]) if n_e else 0

    def pad1(x, n, dtype=np.int64, fill=0):
        out = np.full((n,), fill, dtype)
        out[: len(x)] = x
        return out

    out = {
        "nid": pad1(sub["nid"], v_max),
        "node_mask": np.arange(v_max) < n_v,
        "senders": pad1(sub["senders"][order], e_max),
        "receivers": pad1(sub["receivers"][order], e_max, fill=recv_fill),
        "edge_type": pad1(sub["edge_type"][order], e_max),
        "rev_flag": pad1(sub["rev_flag"][order], e_max, bool, False),
        "edge_mask": np.arange(e_max) < n_e,
        "samples": np.concatenate(
            [samples, np.zeros((s_max - n_s, 3), np.int64)], axis=0),
        "sample_mask": np.arange(s_max) < n_s,
        "labels": pad1(labels, s_max, np.float32, 0.0),
    }
    if edge_norm is not None:
        out["edge_norm"] = np.concatenate(
            [edge_norm[order], np.zeros((e_max - n_e, 1), np.float32)], axis=0)
    out["out_deg"] = np.bincount(
        sub["senders"], minlength=v_max).astype(np.float32)
    return out
