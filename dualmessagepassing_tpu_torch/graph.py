"""Padded graph containers of the port (dualmessagepassing_tpu/graph.py:
GraphBatch 36-107, FlatGraph 110, EdgeSeqBatch 128-155, the EdgeSeq
record functions 158-297, single_graph 304, add_reversed_edges 352,
compact_record 377, batch_graphs_dense 387, batch_graphs 401,
_bincount_batched 424).

A GraphBatch is B graphs padded to one (V_max, E_max) envelope, layout
[B, V] / [B, E], post-padded: real entries first, node_mask/edge_mask
mark them, pad edges have senders == receivers == 0. In the JAX package
it is a flax struct pytree; here a plain dataclass of tensors, indices
as int64 (what torch's indexing and the K3 kernel take), masks as bool.
Host records are numpy dicts, exactly the JAX package's (the builders
below are copies). A subclass adds fields of its own (models/lrp.
LRPGraphBatch, the perm tables); to, slice and replace keep them.

An EdgeSeqBatch is the same graphs as edge sequences for CNN, RNN and
TXL: tuples (u, v, ul, el, vl) sorted by (u, v, el), [B, L], post-
padded, with the static node count its degree tables span.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from .ops.scatter import bincount_batched

_FIELDS = ("senders", "receivers", "node_id", "node_label", "edge_label",
           "node_mask", "edge_mask", "rev_flag", "n_node", "n_edge")


def _tensor(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; integer arrays become int64."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if t.dtype == torch.bool else t.long()


@dataclasses.dataclass
class GraphBatch:
    """B graphs padded to a static (V_max, E_max) envelope."""

    senders: torch.Tensor     # [B, E] int64
    receivers: torch.Tensor   # [B, E] int64
    node_id: torch.Tensor     # [B, V] int64
    node_label: torch.Tensor  # [B, V] int64
    edge_label: torch.Tensor  # [B, E] int64
    node_mask: torch.Tensor   # [B, V] bool
    edge_mask: torch.Tensor   # [B, E] bool
    rev_flag: torch.Tensor    # [B, E] bool: the added reverse direction
    n_node: torch.Tensor      # [B] int64 true sizes
    n_edge: torch.Tensor      # [B] int64

    @property
    def batch_size(self) -> int:
        return self.node_id.shape[0]

    @property
    def max_nodes(self) -> int:
        return self.node_id.shape[1]

    @property
    def max_edges(self) -> int:
        return self.senders.shape[1]

    @property
    def device(self) -> torch.device:
        return self.senders.device

    def _map(self, fn) -> "GraphBatch":
        """A batch of this class with fn applied to every tensor field, a
        subclass's fields included (None stays None)."""
        return dataclasses.replace(self, **{
            f.name: fn(getattr(self, f.name))
            for f in dataclasses.fields(self)
            if getattr(self, f.name) is not None})

    def to(self, device, non_blocking: bool = False) -> "GraphBatch":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def replace(self, **kw) -> "GraphBatch":
        return dataclasses.replace(self, **kw)

    def slice(self, rows: slice) -> "GraphBatch":
        """The graphs `rows` of the batch (a microbatch); every field is
        [B, ...]."""
        return self._map(lambda t: t[rows])

    # degrees over the real edges, float32 counts: a segment-sum of the
    # edge mask (K3 on a CUDA tensor, ops/scatter.bincount_batched)
    def out_degrees(self) -> torch.Tensor:
        """[B, V] float32 out-degree per node."""
        return bincount_batched(self.senders, self.edge_mask, self.max_nodes)

    def in_degrees(self) -> torch.Tensor:
        """[B, V] float32 in-degree per node."""
        return bincount_batched(self.receivers, self.edge_mask,
                                self.max_nodes)

    def flatten(self) -> "FlatGraph":
        """The batch as one disjoint-union graph, node offsets V_max per
        graph (padded slots included, masked off)."""
        b, v = self.node_id.shape
        offs = (torch.arange(b, device=self.device) * v)[:, None]
        return FlatGraph(
            senders=(self.senders + offs).reshape(-1),
            receivers=(self.receivers + offs).reshape(-1),
            node_id=self.node_id.reshape(-1),
            node_label=self.node_label.reshape(-1),
            edge_label=self.edge_label.reshape(-1),
            node_mask=self.node_mask.reshape(-1),
            edge_mask=self.edge_mask.reshape(-1),
            rev_flag=self.rev_flag.reshape(-1),
            num_nodes=b * v)


@dataclasses.dataclass
class FlatGraph:
    """One flat COO graph (static E, V)."""

    senders: torch.Tensor     # [E] int64
    receivers: torch.Tensor   # [E] int64
    node_id: torch.Tensor     # [V]
    node_label: torch.Tensor  # [V]
    edge_label: torch.Tensor  # [E]
    node_mask: torch.Tensor   # [V] bool
    edge_mask: torch.Tensor   # [E] bool
    rev_flag: torch.Tensor    # [E] bool
    num_nodes: int

    @property
    def max_edges(self) -> int:
        return self.senders.shape[0]


_SEQ_FIELDS = ("u", "v", "ul", "el", "vl", "mask", "rev_flag", "n_tuple")


@dataclasses.dataclass
class EdgeSeqBatch:
    """B graphs as edge sequences (reference EdgeSeq, dataset.py:111-769):
    tuples (u, v, ul, el, vl) sorted by (u, v, el), padded to L (post-
    pad). num_nodes is the padded node axis of the degree tables, an int
    that to, slice and replace keep."""

    u: torch.Tensor         # [B, L] int64
    v: torch.Tensor
    ul: torch.Tensor
    el: torch.Tensor
    vl: torch.Tensor
    mask: torch.Tensor      # [B, L] bool
    rev_flag: torch.Tensor  # [B, L] bool
    n_tuple: torch.Tensor   # [B] int64
    num_nodes: int

    @property
    def batch_size(self) -> int:
        return self.u.shape[0]

    @property
    def max_len(self) -> int:
        return self.u.shape[1]

    @property
    def device(self) -> torch.device:
        return self.u.device

    def _map(self, fn) -> "EdgeSeqBatch":
        return dataclasses.replace(self, **{
            f: fn(getattr(self, f)) for f in _SEQ_FIELDS})

    def to(self, device, non_blocking: bool = False) -> "EdgeSeqBatch":
        return self._map(lambda t: t.to(device, non_blocking=non_blocking))

    def replace(self, **kw) -> "EdgeSeqBatch":
        return dataclasses.replace(self, **kw)

    def slice(self, rows: slice) -> "EdgeSeqBatch":
        return self._map(lambda t: t[rows])

    # degrees over the real tuples, float32 counts (K3 on a CUDA tensor)
    def out_degrees(self) -> torch.Tensor:
        """[B, num_nodes] float32 out-degrees."""
        return bincount_batched(self.u, self.mask, self.num_nodes)

    def in_degrees(self) -> torch.Tensor:
        """[B, num_nodes] float32 in-degrees."""
        return bincount_batched(self.v, self.mask, self.num_nodes)


# -----------------------------------------------------------------------------
# host-side builders (numpy records, copies of the JAX package's)
# -----------------------------------------------------------------------------

def single_graph(
    num_nodes: int,
    senders: Sequence[int],
    receivers: Sequence[int],
    node_labels: Optional[Sequence[int]] = None,
    edge_labels: Optional[Sequence[int]] = None,
    v_max: Optional[int] = None,
    e_max: Optional[int] = None,
) -> Dict[str, np.ndarray]:
    """One padded graph record (host numpy dict)."""
    senders = np.asarray(senders, dtype=np.int32)
    receivers = np.asarray(receivers, dtype=np.int32)
    num_edges = len(senders)
    v_max = num_nodes if v_max is None else v_max
    e_max = num_edges if e_max is None else e_max
    if num_nodes > v_max or num_edges > e_max:
        raise ValueError(
            f"graph ({num_nodes}V,{num_edges}E) exceeds envelope "
            f"({v_max},{e_max})")
    if node_labels is None:
        node_labels = np.zeros(num_nodes, dtype=np.int32)
    if edge_labels is None:
        edge_labels = np.zeros(num_edges, dtype=np.int32)

    def pad1(x, n):
        out = np.zeros((n,), dtype=np.int32)
        out[: len(x)] = x
        return out

    return {
        "senders": pad1(senders, e_max),
        "receivers": pad1(receivers, e_max),
        "node_id": pad1(np.arange(num_nodes, dtype=np.int32), v_max),
        "node_label": pad1(np.asarray(node_labels, dtype=np.int32), v_max),
        "edge_label": pad1(np.asarray(edge_labels, dtype=np.int32), e_max),
        "node_mask": pad1(np.ones(num_nodes, np.int32), v_max).astype(bool),
        "edge_mask": pad1(np.ones(num_edges, np.int32), e_max).astype(bool),
        "rev_flag": np.zeros(e_max, dtype=bool),
        "n_node": np.int32(num_nodes),
        "n_edge": np.int32(num_edges),
    }


def add_reversed_edges(rec: Dict[str, np.ndarray],
                       num_edge_labels: int) -> Dict[str, np.ndarray]:
    """For every real edge (u, v, el) add (v, u, el + num_edge_labels)
    with rev_flag set; doubles E_max (reference train.py:273-327)."""
    n_edge = int(rec["n_edge"])
    e_max = rec["senders"].shape[0]
    out = dict(rec)
    out["senders"] = np.concatenate([rec["senders"], rec["receivers"]])
    out["receivers"] = np.concatenate([rec["receivers"], rec["senders"]])
    rev_labels = rec["edge_label"].copy()
    rev_labels[: n_edge] += num_edge_labels
    out["edge_label"] = np.concatenate([rec["edge_label"], rev_labels])
    out["edge_mask"] = np.concatenate([rec["edge_mask"], rec["edge_mask"]])
    out["rev_flag"] = np.concatenate([np.zeros(e_max, dtype=bool),
                                      rec["edge_mask"].astype(bool)])
    out["n_edge"] = np.int32(2 * n_edge)
    return out


def compact_record(rec: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Re-pack a record so real edges are contiguous at the head."""
    order = np.argsort(~rec["edge_mask"].astype(bool), kind="stable")
    out = dict(rec)
    for k in ("senders", "receivers", "edge_label", "edge_mask", "rev_flag"):
        out[k] = rec[k][order]
    return out


def batch_graphs_dense(dense: Dict[str, np.ndarray], idx) -> GraphBatch:
    """GraphBatch (CPU tensors) from a dataset-level dense cache: one
    fancy-index gather per field."""
    return GraphBatch(**{k: _tensor(dense[k][idx]) for k in _FIELDS})


def batch_graphs(records: List[Dict[str, np.ndarray]]) -> GraphBatch:
    """Stack host records (one envelope) into a GraphBatch of CPU
    tensors; .to(device) ships it."""
    return GraphBatch(**{k: _tensor(np.stack([r[k] for r in records]))
                         for k in _FIELDS})


# -----------------------------------------------------------------------------
# EdgeSeq records (numpy, copies of the JAX package's)
# -----------------------------------------------------------------------------

def record_to_edgeseq(rec: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
    """Graph record -> edge-sequence record: the real edges as tuples
    sorted by (u, v, el) (EdgeSeq.from_graph), padded to the record's
    E_max. "order" is the sort permutation, so per-edge targets can
    follow the tuples."""
    em = rec["edge_mask"].astype(bool)
    n_edge = int(rec["n_edge"])
    e_max = em.shape[0]
    u = rec["senders"][em]
    v = rec["receivers"][em]
    el = rec["edge_label"][em]
    nl = rec["node_label"]
    order = np.lexsort((el, v, u))

    def pad(x):
        out = np.zeros((e_max,), x.dtype)
        out[: n_edge] = x[order]
        return out

    return {
        "u": pad(u), "v": pad(v), "el": pad(el),
        "ul": pad(nl[u]), "vl": pad(nl[v]),
        "mask": np.arange(e_max) < n_edge,
        "rev_flag": pad(rec["rev_flag"][em]),
        "n_tuple": np.int32(n_edge),
        "num_nodes": int(rec["node_mask"].shape[0]),
        "order": order,
    }


def edgeseq_add_tuples(rec: Dict[str, np.ndarray],
                       tuples: np.ndarray) -> Dict[str, np.ndarray]:
    """Tuple insertion in order (reference EdgeSeq.add_tuples, dataset.py:
    352-445): the new (u, v, ul, el, vl) rows go into the (u, v, el)
    order before existing rows of equal key. Several new tuples of equal
    key keep their argument order (the reference's one-at-a-time
    bisect_left reverses them). The envelope grows when they overflow
    it."""
    tuples = np.asarray(tuples)
    if tuples.ndim == 1:
        tuples = tuples[None]
    m = rec["mask"].astype(bool)
    n_old, n_new = int(m.sum()), len(tuples)
    n = n_old + n_new
    e_max = max(len(m), n)
    cols = {k: np.concatenate([tuples[:, i], rec[k][m]])
            for i, k in enumerate(("u", "v", "ul", "el", "vl"))}
    cols["rev_flag"] = np.concatenate([
        np.zeros(n_new, rec["rev_flag"].dtype), rec["rev_flag"][m]])
    # a stable sort with the new rows first: new before equal existing
    order = np.lexsort((cols["el"], cols["v"], cols["u"]))

    def pad(x):
        out = np.zeros((e_max,), x.dtype)
        out[:n] = x[order]
        return out

    out = {k: pad(x) for k, x in cols.items()}
    out["mask"] = np.arange(e_max) < n
    out["n_tuple"] = np.int32(n)
    out["num_nodes"] = max(int(rec["num_nodes"]),
                           int(max(cols["u"].max(), cols["v"].max())) + 1
                           if n else 0)
    return out


def edgeseq_to_graph(rec: Dict[str, np.ndarray],
                     v_max: Optional[int] = None,
                     e_max: Optional[int] = None) -> Dict[str, np.ndarray]:
    """Edge-sequence record -> graph record (reference EdgeSeq.to_graph,
    dataset.py:560-591): the nodes are the ids the tuples name (u's
    first, then v's, in order of appearance), renumbered 0..V-1, their
    labels from ul/vl; "edge_key" numbers a run of equal (u, v) tuples
    0, 1, ...; "node_id" keeps the original ids."""
    m = rec["mask"].astype(bool)
    u, v = rec["u"][m], rec["v"][m]
    el = rec["el"][m]
    nid2label: Dict[int, int] = {}
    for a, la in zip(u, rec["ul"][m]):
        nid2label.setdefault(int(a), int(la))
    for b, lb in zip(v, rec["vl"][m]):
        nid2label.setdefault(int(b), int(lb))
    node_ids = np.asarray(list(nid2label.keys()), np.int64)
    node_labels = np.asarray(list(nid2label.values()), np.int64)
    remap = {int(x): i for i, x in enumerate(node_ids)}
    senders = np.asarray([remap[int(x)] for x in u], np.int64)
    receivers = np.asarray([remap[int(x)] for x in v], np.int64)
    key = np.zeros(len(u), np.int64)
    for i in range(1, len(u)):
        if u[i] == u[i - 1] and v[i] == v[i - 1]:
            key[i] = key[i - 1] + 1
    n_v, n_e = len(node_ids), len(u)
    v_max = v_max or n_v
    e_max = e_max or n_e

    def pad1(x, n):
        out = np.zeros((n,), x.dtype)
        out[: len(x)] = x
        return out

    return {
        "senders": pad1(senders, e_max),
        "receivers": pad1(receivers, e_max),
        "node_label": pad1(node_labels, v_max),
        "edge_label": pad1(el, e_max),
        "node_mask": np.arange(v_max) < n_v,
        "edge_mask": np.arange(e_max) < n_e,
        "rev_flag": pad1(rec["rev_flag"][m], e_max),
        "n_node": np.int32(n_v),
        "n_edge": np.int32(n_e),
        "node_id": pad1(node_ids, v_max),
        "edge_key": pad1(key, e_max),
    }


def batch_edgeseqs(records: List[Dict[str, np.ndarray]]) -> EdgeSeqBatch:
    """Stack edge-sequence records (one L) into an EdgeSeqBatch of CPU
    tensors; num_nodes is the largest of theirs."""
    return EdgeSeqBatch(
        **{k: _tensor(np.stack([r[k] for r in records]))
           for k in _SEQ_FIELDS},
        num_nodes=max(r["num_nodes"] for r in records))
