"""SCM dataset container and collate (dualmessagepassing_tpu/data/
dataset.py: GraphAdjDataset 26-213, _node/_edge_weights 299-318, the
envelope ladder and CollateView 321-394).

Records are host numpy dicts (graph.single_graph records); batchify
returns GraphBatch pairs of CPU tensors with the count and weight
targets, and the training driver moves them to the model's device.
Node and edge weights are derived lazily from the stored
subisomorphisms and cached on the record (reference dataset.py:1620-
1634). The dataset transforms mirror the reference train.py:
remove_loops (252-270), add_reversed_edges (273-327), the eigenvalue
bounds (330-380).

The graph collate serves the GNNs, batchify_lrp (dataset.py:257-297)
LRP and DMPLRP, batchify_edgeseq (dataset.py:215-256) CNN, RNN and TXL.
"""

from __future__ import annotations

import pickle
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import graph as G
from ..models.lrp import LRPGraphBatch
from ..ops.spectral import largest_eigenvalue_bounds_np
from .lrp import count_perms, record_to_lrp_perms
from .subiso import edge_subiso_weights, node_subiso_weights

# the dense collate cache is built only below this many bytes per side
COLLATE_CACHE_BYTES = 16e9


class GraphAdjDataset:
    def __init__(self, data: Optional[List[Dict]] = None):
        self.data: List[Dict] = data or []

    def __len__(self):
        return len(self.data)

    def __getitem__(self, idx):
        return self.data[idx]

    def save(self, filename: str):
        with open(filename, "wb") as f:
            pickle.dump(self.data, f, protocol=pickle.HIGHEST_PROTOCOL)

    def load(self, filename: str) -> "GraphAdjDataset":
        """Read a file that save() wrote (pickle: only files this program
        wrote)."""
        with open(filename, "rb") as f:
            self.data = pickle.load(f)
        return self

    # ---- transforms ---------------------------------------------------------
    def remove_loops(self):
        """Drop self-loop edges from every pattern and graph (train.py:
        252-270), keeping real edges contiguous; the edge weights are
        reset and derived again from the subisomorphisms."""
        for x in self.data:
            for key in ("pattern", "graph"):
                rec = x[key]
                em = rec["edge_mask"].astype(bool)
                keep = em & (rec["senders"] != rec["receivers"])
                if keep.sum() == em.sum():
                    continue
                order = np.argsort(~keep, kind="stable")
                for k in ("senders", "receivers", "edge_label", "rev_flag"):
                    rec[k] = rec[k][order]
                n_keep = int(keep.sum())
                rec["edge_mask"] = np.arange(len(em)) < n_keep
                rec["n_edge"] = np.int32(n_keep)
            x["edge_weights"] = None
            # the records changed in place: their cached edge sequences
            # (batchify_edgeseq) go too
            x.pop("_edgeseq_pattern", None)
            x.pop("_edgeseq_graph", None)
        self.invalidate_collate_cache()
        return self

    def add_reversed_edges(self, num_p_elabels: int, num_g_elabels: int):
        """Reversed edges on pattern and graph (train.py:273-327); the
        edge weights of the reversed half are a copy (the loss masks them
        by rev_flag)."""
        for x in self.data:
            x["pattern"] = G.add_reversed_edges(x["pattern"], num_p_elabels)
            x["graph"] = G.add_reversed_edges(x["graph"], num_g_elabels)
            if x.get("edge_weights") is not None:
                x["edge_weights"] = np.concatenate(
                    [x["edge_weights"], x["edge_weights"]])
        self.invalidate_collate_cache()
        return self

    def compute_eigenvalue_bounds(self) -> Tuple[float, float]:
        """Max over graphs of the spectral bounds, clamped >= 4.0
        (train.py:1174-1186)."""
        max_n, max_e = 4.0, 4.0
        for x in self.data:
            for key in ("pattern", "graph"):
                rec = x[key]
                ne, ee = largest_eigenvalue_bounds_np(
                    rec["senders"], rec["receivers"], int(rec["n_node"]),
                    rec["edge_mask"].astype(bool))
                max_n, max_e = max(max_n, ne), max(max_e, ee)
        return max_n, max_e

    def sizes(self) -> List[Dict[str, int]]:
        """Per-record sizes, the samplers' group_by keys g_len / p_len."""
        return [{"g_len": int(x["graph"]["n_edge"]),
                 "p_len": int(x["pattern"]["n_edge"])} for x in self.data]

    # ---- collate ------------------------------------------------------------
    def invalidate_collate_cache(self):
        """Drop the dense collate cache (the in-place transforms call
        this)."""
        self._dense = {}

    def _cache(self) -> dict:
        if getattr(self, "_dense", None) is None:
            self._dense = {}
        return self._dense

    def _dense_records(self, which: str):
        """Dataset-level stacked arrays [N, ...] per field, built once, or
        None where they would pass COLLATE_CACHE_BYTES (the caller then
        stacks per batch)."""
        cache = self._cache()
        if which not in cache:
            recs = [x[which] for x in self.data]
            est = sum(getattr(v, "nbytes", 8)
                      for v in recs[0].values()) * len(recs)
            cache[which] = None if est > COLLATE_CACHE_BYTES else {
                k: np.stack([r[k] for r in recs]) for k in G._FIELDS}
        return cache[which]

    def _dense_weights(self, kind: str):
        cache = self._cache()
        key = f"w_{kind}"
        if key not in cache:
            if kind == "node":
                n = self.data[0]["graph"]["node_mask"].shape[0]
                fn = self._node_weights
            else:
                n = self.data[0]["graph"]["edge_mask"].shape[0]
                fn = self._edge_weights
            cache[key] = np.stack([_padded(fn(x), n) for x in self.data])
        return cache[key]

    def batchify(self, indices: Sequence[int], return_weights: str = "none",
                 auto_envelope: bool = False):
        """-> (ids, pattern GraphBatch, graph GraphBatch, counts [B, 1]
        float32, (node_weights [B, V] float32 | None, edge_weights [B, E]
        float32 | None)), all on the CPU.

        auto_envelope shrinks each batch's envelope to the smallest
        power-of-two step (at least 4) that covers the batch maxima."""
        batch = [self.data[i] for i in indices]
        ids = [x["id"] for x in batch]
        counts = np.asarray([x["counts"] for x in batch], np.float32)[:, None]
        node_w = edge_w = None
        dense_p = None if auto_envelope else self._dense_records("pattern")
        if dense_p is not None:
            take = np.asarray(indices, np.int64)
            pattern = G.batch_graphs_dense(dense_p, take)
            graph = G.batch_graphs_dense(self._dense_records("graph"), take)
            if "node" in return_weights:
                node_w = self._dense_weights("node")[take]
            if "edge" in return_weights:
                edge_w = self._dense_weights("edge")[take]
        else:
            p_recs = [x["pattern"] for x in batch]
            g_recs = [x["graph"] for x in batch]
            if auto_envelope:
                p_recs = [_sliced(r, *_ladder_envelope(p_recs))
                          for r in p_recs]
                g_recs = [_sliced(r, *_ladder_envelope(g_recs))
                          for r in g_recs]
            pattern = G.batch_graphs(p_recs)
            graph = G.batch_graphs(g_recs)
            if "node" in return_weights:
                node_w = np.stack([
                    _padded(self._node_weights(x), rec["node_mask"].shape[0])
                    for x, rec in zip(batch, g_recs)])
            if "edge" in return_weights:
                edge_w = np.stack([
                    _padded(self._edge_weights(x), rec["edge_mask"].shape[0])
                    for x, rec in zip(batch, g_recs)])

        def t(a):
            return None if a is None else torch.from_numpy(
                np.ascontiguousarray(a))

        return ids, pattern, graph, t(counts), (t(node_w), t(edge_w))

    def batchify_edgeseq(self, indices: Sequence[int],
                         return_weights: str = "none"):
        """The EdgeSeq collate (reference EdgeSeqDataset.batchify,
        dataset.py:995-1050): batchify's tuple with EdgeSeqBatch pattern
        and graph and no node weights; the edge weights follow the tuple
        sort. Each record keeps its sequence (under "_edgeseq_pattern",
        "_edgeseq_graph") beside the record it was made from, and makes
        it again when the transforms replace that record."""
        batch = [self.data[i] for i in indices]
        ids = [x["id"] for x in batch]

        def seq(x, which):
            key = f"_edgeseq_{which}"
            cached = x.get(key)
            if cached is None or cached[0] is not x[which]:
                cached = (x[which], G.record_to_edgeseq(x[which]))
                x[key] = cached
            return cached[1]

        p_seqs = [seq(x, "pattern") for x in batch]
        g_seqs = [seq(x, "graph") for x in batch]
        counts = np.asarray([x["counts"] for x in batch], np.float32)[:, None]
        edge_w = None
        if "edge" in return_weights:
            rows = []
            for x, s in zip(batch, g_seqs):
                w = np.asarray(self._edge_weights(x), np.float32)
                padded = np.zeros((x["graph"]["edge_mask"].shape[0],),
                                  np.float32)
                order = s["order"]
                w = w[order[order < len(w)]]
                padded[: len(w)] = w
                rows.append(padded)
            edge_w = torch.from_numpy(np.stack(rows))
        return (ids, G.batch_edgeseqs(p_seqs), G.batch_edgeseqs(g_seqs),
                torch.from_numpy(counts), (None, edge_w))

    def batchify_lrp(self, indices: Sequence[int],
                     return_weights: str = "none", seq_len: int = 4):
        """The LRP collate (reference LRPDataset.batchify, dataset.py:
        1862-1905): batchify's tuple with LRPGraphBatch pattern and graph,
        the perm tables padded to the batch's largest perm count. Each
        record keeps its tables (under "_lrp_pattern", "_lrp_graph") and
        enumerates them again only for a larger envelope."""
        batch = [self.data[i] for i in indices]
        ids, pattern, graph, counts, weights = self.batchify(
            indices, return_weights)

        def perm_rows(which):
            key = f"_lrp_{which}"
            p_max = max(count_perms(x[which], seq_len) for x in batch) or 1
            rows = []
            for x in batch:
                cached = x.get(key)
                if cached is None or cached["perm_node"].shape[0] < p_max:
                    cached = record_to_lrp_perms(x[which], seq_len, p_max)
                    x[key] = cached
                rows.append({k: v[:p_max] for k, v in cached.items()
                             if k != "n_perm"})
            return rows

        return (ids, lrp_batch(pattern, perm_rows("pattern")),
                lrp_batch(graph, perm_rows("graph")), counts, weights)

    def _node_weights(self, x) -> np.ndarray:
        if x.get("node_weights") is None:
            x["node_weights"] = node_subiso_weights(
                int(x["graph"]["n_node"]), x["subisomorphisms"])
        return x["node_weights"]

    def _edge_weights(self, x) -> np.ndarray:
        if x.get("edge_weights") is None:
            rec = x["graph"]
            prec = x["pattern"]
            em = rec["edge_mask"].astype(bool)
            pm = prec["edge_mask"].astype(bool) & ~prec["rev_flag"]
            x["edge_weights"] = edge_subiso_weights(
                prec["senders"][pm], prec["receivers"][pm],
                prec["edge_label"][pm],
                rec["senders"][em], rec["receivers"][em],
                rec["edge_label"][em], x["subisomorphisms"])
        return x["edge_weights"]


def _padded(w: np.ndarray, n: int) -> np.ndarray:
    out = np.zeros((n,), np.float32)
    w = w[:n]
    out[: len(w)] = w
    return out


def _next_pow2(x: int, floor: int = 4) -> int:
    n = floor
    while n < x:
        n *= 2
    return n


def _ladder_envelope(recs) -> tuple:
    v = max(int(r["n_node"]) for r in recs)
    e = max(int(r["n_edge"]) for r in recs)
    cap_v = recs[0]["node_mask"].shape[0]
    cap_e = recs[0]["edge_mask"].shape[0]
    return min(_next_pow2(v), cap_v), min(_next_pow2(e), cap_e)


def _sliced(rec, v_env: int, e_env: int):
    """A post-padded record at a smaller envelope (prefix slices)."""
    out = {k: rec[k][:v_env] for k in ("node_id", "node_label", "node_mask")}
    out.update({k: rec[k][:e_env] for k in (
        "senders", "receivers", "edge_label", "edge_mask", "rev_flag")})
    out["n_node"], out["n_edge"] = rec["n_node"], rec["n_edge"]
    return out


def lrp_batch(gb: G.GraphBatch, perm_rows: List[Dict[str, np.ndarray]]):
    """A GraphBatch lifted to an LRPGraphBatch: one record's perm tables
    (data/lrp.record_to_lrp_perms, one envelope) per graph, stacked into
    CPU tensors."""
    perms = {k: G._tensor(np.stack([r[k] for r in perm_rows]))
             for k in ("perm_node", "perm_node_mask", "perm_edge",
                       "perm_edge_mask", "perm_owner", "perm_mask")}
    return LRPGraphBatch(**{f: getattr(gb, f) for f in G._FIELDS}, **perms)


class CollateView:
    """A dataset view whose batchify routes to the collate a model family
    needs: 'graph' (the GNNs), 'edgeseq' (CNN, RNN, TXL) or 'lrp' (LRP,
    DMPLRP)."""

    def __init__(self, dataset: GraphAdjDataset, kind: str = "graph",
                 lrp_seq_len: int = 4, auto_envelope: bool = False):
        if kind not in ("graph", "edgeseq", "lrp"):
            raise ValueError(kind)
        self.dataset = dataset
        self.kind = kind
        self.lrp_seq_len = lrp_seq_len
        self.auto_envelope = auto_envelope

    def __len__(self):
        return len(self.dataset)

    def sizes(self):
        return self.dataset.sizes()

    def batchify(self, indices, return_weights="none"):
        if self.kind == "edgeseq":
            return self.dataset.batchify_edgeseq(indices, return_weights)
        if self.kind == "lrp":
            return self.dataset.batchify_lrp(indices, return_weights,
                                             self.lrp_seq_len)
        return self.dataset.batchify(indices, return_weights,
                                     auto_envelope=self.auto_envelope)


def collate_kind_for(rep_net: str) -> str:
    if rep_net in ("CNN", "RNN", "TXL"):
        return "edgeseq"
    if rep_net in ("LRP", "DMPLRP"):
        return "lrp"
    return "graph"
