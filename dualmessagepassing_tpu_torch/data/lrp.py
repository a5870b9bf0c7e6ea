"""Host-side local relational pooling (LRP) perm enumeration: a numpy
copy of dualmessagepassing_tpu/data/lrp.py (record_to_lrp_perms 34-91,
count_perms 94-103; reference SubgraphCountingMatching/dataset.py:
1639-1905, LRPDataset), array for array.

For every node, each permutation of up to seq_len - 1 of its
out-neighbours (in edge order, repeats included, itertools.permutations'
order) follows the node itself: a "perm". A perm places its nodes on the
diagonal of an S x S grid, and each edge (u, v) between two of its nodes
at (pos(u), pos(v)), pos being a node's LAST position in the perm; of
duplicate (u, v) edges the last one wins (the reference's eid_map dict,
dataset.py:1792). Reversed edges are left out (dataset.py:1784-1786).
Per record, padded to a perm envelope P:

  perm_node  [P, S] int32 + perm_node_mask [P, S] bool
  perm_edge  [P, S, S] int32 + perm_edge_mask [P, S, S] bool
  perm_owner [P] int32 (the ego node, for the mean pooling), perm_mask [P]

The JAX module loops over perms and cells in Python; here one node's
perms are a precomputed position table indexed by its neighbours, and
the cells are S*S vectorised lookups in a dense edge-id table.
"""

from __future__ import annotations

import functools
from itertools import permutations
from typing import Dict, Optional

import numpy as np


@functools.lru_cache(maxsize=None)
def _positions(d: int, k: int) -> np.ndarray:
    """[P(d, k), k] int64: itertools.permutations(range(d), k), read-only."""
    rows = list(permutations(range(d), k))
    t = np.array(rows, np.int64).reshape(len(rows), k)
    t.setflags(write=False)
    return t


def _real_edges(rec: Dict[str, np.ndarray]):
    em = rec["edge_mask"].astype(bool) & ~rec["rev_flag"].astype(bool)
    return (rec["senders"][em].astype(np.int64),
            rec["receivers"][em].astype(np.int64), np.nonzero(em)[0])


def record_to_lrp_perms(rec: Dict[str, np.ndarray], seq_len: int = 4,
                        p_max: Optional[int] = None
                        ) -> Dict[str, np.ndarray]:
    """A graph record's perm tables padded to p_max (default: its own
    perm count); raises ValueError when it has more perms than p_max."""
    src, dst, eid = _real_edges(rec)
    n_nodes = int(rec["n_node"])
    v_max = rec["node_mask"].shape[0]
    s = seq_len
    nei = s - 1

    # each sender's neighbours in edge order
    order = np.argsort(src, kind="stable")
    nbrs = dst[order]
    ends = np.cumsum(np.bincount(src, minlength=v_max))
    starts = ends - np.bincount(src, minlength=v_max)
    blocks = []
    for i in range(n_nodes):
        adj = nbrs[starts[i]:ends[i]]
        t = _positions(len(adj), min(nei, len(adj)))
        block = np.full((len(t), s), -1, np.int64)
        block[:, 0] = i
        block[:, 1:1 + t.shape[1]] = adj[t]
        blocks.append(block)
    perms = (np.concatenate(blocks) if blocks
             else np.zeros((0, s), np.int64))
    n_perm = len(perms)
    if p_max is None:
        p_max = n_perm
    if n_perm > p_max:
        raise ValueError(f"{n_perm} perms exceed envelope {p_max}")

    node_ok = perms >= 0
    # a slot counts where no later slot holds the same node (its last
    # position)
    last = node_ok.copy()
    for a in range(s):
        for b in range(a + 1, s):
            last[:, a] &= ~(node_ok[:, b] & (perms[:, b] == perms[:, a]))
    # the edge id of each (u, v), the last duplicate winning
    eid_of = np.full((v_max, v_max), -1, np.int64)
    key = src * v_max + dst
    _, first_rev = np.unique(key[::-1], return_index=True)
    keep = len(key) - 1 - first_rev
    eid_of[src[keep], dst[keep]] = eid[keep]
    nodes = np.where(node_ok, perms, 0)
    cell = eid_of[nodes[:, :, None], nodes[:, None, :]]    # [n, S, S]
    cell_ok = last[:, :, None] & last[:, None, :] & (cell >= 0)

    pn = np.zeros((p_max, s), np.int32)
    pn_mask = np.zeros((p_max, s), bool)
    pe = np.zeros((p_max, s, s), np.int32)
    pe_mask = np.zeros((p_max, s, s), bool)
    owner = np.zeros((p_max,), np.int32)
    pmask = np.zeros((p_max,), bool)
    pn[:n_perm] = nodes
    pn_mask[:n_perm] = node_ok
    pe[:n_perm] = np.where(cell_ok, cell, 0)
    pe_mask[:n_perm] = cell_ok
    owner[:n_perm] = perms[:, 0]
    pmask[:n_perm] = True
    return {
        "perm_node": pn, "perm_node_mask": pn_mask,
        "perm_edge": pe, "perm_edge_mask": pe_mask,
        "perm_owner": owner, "perm_mask": pmask,
        "n_perm": np.int32(n_perm),
    }


def count_perms(rec: Dict[str, np.ndarray], seq_len: int = 4) -> int:
    """The record's perm count without enumerating (envelope sizing):
    sum over its nodes of d! / (d - min(seq_len - 1, d))!, d the
    out-degree."""
    src, _, _ = _real_edges(rec)
    n = int(rec["n_node"])
    deg = np.bincount(src, minlength=n)[:n]
    k = np.minimum(seq_len - 1, deg)
    total = np.ones_like(deg)
    for t in range(seq_len - 1):
        total *= np.where(t < k, deg - t, 1)
    return int(total.sum())
