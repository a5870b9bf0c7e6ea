"""Padded graph containers of the port (dualmessagepassing_tpu/graph.py:
GraphBatch 36-107, FlatGraph 110, single_graph 304, add_reversed_edges
352, compact_record 377, batch_graphs_dense 387, batch_graphs 401,
_bincount_batched 424).

A GraphBatch is B graphs padded to one (V_max, E_max) envelope, layout
[B, V] / [B, E], post-padded: real entries first, node_mask/edge_mask
mark them, pad edges have senders == receivers == 0. In the JAX package
it is a flax struct pytree; here a plain dataclass of tensors, indices
as int64 (what torch's indexing and the K3 kernel take), masks as bool.
Host records are numpy dicts, exactly the JAX package's (the builders
below are copies). A subclass adds fields of its own (models/lrp.
LRPGraphBatch, the perm tables); to, slice and replace keep them. The
EdgeSeq containers (graph.py:129-300) are not ported.
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
