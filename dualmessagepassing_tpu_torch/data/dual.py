"""Explicit dual (line) graph conversion — the --convert_dual ablation
(a numpy copy of dualmessagepassing_tpu/data/dual.py).

Reference: SubgraphCountingMatching/utils/graph.py:74-316
(`convert_to_dual_graph`, `get_dual_subisomorphisms`) and the driver
transform (train.py:383-446).

Semantics on our host records (edge ids are the implicit 0..E-1 positions, so
the reference's EDGEID-merge loop degenerates to the identity — ids are
always unique):
  * dual node e for every primal edge e; dual node id/label = primal edge
    id/label;
  * dual edge (e1 -> e2) for every pair with dst(e1) == src(e2); dual edge
    label = primal node label of the shared node;
  * dual subisomorphisms: for each pattern edge key (u, v) in sorted order,
    the matching graph edge under the node mapping (graph edges scanned in
    (src, dst) order, last match winning — graph.py:302-316).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np

from ..graph import single_graph


def convert_to_dual_record(rec: Dict[str, np.ndarray],
                           e_max_dual: int = None) -> Dict[str, np.ndarray]:
    em = rec["edge_mask"].astype(bool)
    src = rec["senders"][em].astype(np.int64)
    dst = rec["receivers"][em].astype(np.int64)
    el = rec["edge_label"][em].astype(np.int64)
    nl = rec["node_label"].astype(np.int64)
    n_edge = len(src)

    in_edges = [[] for _ in range(int(rec["node_mask"].shape[0]))]
    for e, d in enumerate(dst):
        in_edges[int(d)].append(e)

    d_senders, d_receivers, d_labels = [], [], []
    for e2, s in enumerate(src):
        for e1 in in_edges[int(s)]:
            d_senders.append(e1)
            d_receivers.append(e2)
            d_labels.append(int(nl[s]))

    v_max = rec["edge_mask"].shape[0]  # dual V envelope = primal E envelope
    if e_max_dual is None:
        e_max_dual = max(len(d_senders), 1)
    return single_graph(
        n_edge, d_senders, d_receivers,
        node_labels=el, edge_labels=d_labels,
        v_max=v_max, e_max=e_max_dual,
    )


def get_dual_subisomorphisms(
    p_senders, p_receivers, p_elabels,
    g_senders, g_receivers, g_elabels,
    subisomorphisms: np.ndarray,
) -> np.ndarray:
    """Node-mapping -> dual(edge)-mapping (utils/graph.py:282-316).

    Pattern edges are grouped by (u, v) key in sorted order; each group
    contributes one output column holding the index of a label-matching graph
    edge under the mapping (last match wins, as in the reference loop).
    """
    order = np.lexsort((g_receivers, g_senders))
    gs, gr, gl = g_senders[order], g_receivers[order], g_elabels[order]

    keys = {}
    for s, r, l in zip(p_senders, p_receivers, p_elabels):
        keys.setdefault((int(s), int(r)), []).append(int(l))
    sorted_keys = sorted(keys)

    n_iso = subisomorphisms.shape[0]
    out = np.zeros((n_iso, len(p_senders)), dtype=np.int64)
    g_index = {}
    for i, (s, r) in enumerate(zip(gs, gr)):
        g_index.setdefault((int(s), int(r)), []).append(i)
    for i, m in enumerate(subisomorphisms):
        for col, (u, v) in enumerate(sorted_keys):
            for k in g_index.get((int(m[u]), int(m[v])), ()):
                for l in keys[(u, v)]:
                    if gl[k] == l:
                        out[i, col] = order[k]
    return out


def convert_dataset_to_dual(dataset, e_max_dual_p=None, e_max_dual_g=None):
    """In-place dual conversion of a GraphAdjDataset (train.py:383-446)."""
    # common dual-edge envelope so batches stack
    def dual_e_count(rec):
        em = rec["edge_mask"].astype(bool)
        out_deg = np.bincount(rec["senders"][em],
                              minlength=int(rec["n_node"]))
        in_deg = np.bincount(rec["receivers"][em],
                             minlength=int(rec["n_node"]))
        return int((in_deg * out_deg).sum())

    if e_max_dual_p is None:
        e_max_dual_p = max((dual_e_count(x["pattern"]) for x in dataset.data),
                           default=1) or 1
    if e_max_dual_g is None:
        e_max_dual_g = max((dual_e_count(x["graph"]) for x in dataset.data),
                           default=1) or 1
    for x in dataset.data:
        p, g = x["pattern"], x["graph"]
        pm = p["edge_mask"].astype(bool)
        gm = g["edge_mask"].astype(bool)
        x["subisomorphisms"] = get_dual_subisomorphisms(
            p["senders"][pm], p["receivers"][pm], p["edge_label"][pm],
            g["senders"][gm], g["receivers"][gm], g["edge_label"][gm],
            x["subisomorphisms"],
        )
        x["pattern"] = convert_to_dual_record(p, e_max_dual_p)
        x["graph"] = convert_to_dual_record(g, e_max_dual_g)
        x["node_weights"] = None
        x["edge_weights"] = None
    if hasattr(dataset, "invalidate_collate_cache"):
        dataset.invalidate_collate_cache()
    return dataset
