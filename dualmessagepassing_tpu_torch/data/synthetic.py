"""Synthetic (pattern, graph) pairs with exact ground truth
(dualmessagepassing_tpu/data/synthetic.py: random_multidigraph 22,
generate_pair 34, generate_large_graph 100, generate_community_graph
127, generate_dataset 151, copied as numpy).

Erdős–Rényi-style random directed multigraphs; counts, subisomorphisms
and node/edge weights come from data/subiso.py. The large power-law and
community-structured triplet graphs feed the scale-out runs (the
north-star gate, gates/northstar.py). The same seed gives the JAX
package's arrays.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np

from ..graph import single_graph
from .subiso import (edge_subiso_weights, enumerate_subisomorphisms,
                     node_subiso_weights)


def random_multidigraph(rng, num_nodes, num_edges, num_vlabels, num_elabels,
                        connected_bias=True):
    """Random directed (multi)graph without self loops."""
    senders = rng.integers(0, num_nodes, size=num_edges)
    offs = rng.integers(1, max(num_nodes, 2), size=num_edges)
    receivers = (senders + offs) % num_nodes  # no self loops
    vlabels = rng.integers(0, num_vlabels, size=num_nodes)
    elabels = rng.integers(0, num_elabels, size=num_edges)
    return (senders.astype(np.int64), receivers.astype(np.int64),
            vlabels.astype(np.int64), elabels.astype(np.int64))


def generate_pair(
    rng,
    pv: int = 3, pe: int = 3, gv: int = 8, ge: int = 16,
    num_vlabels: int = 2, num_elabels: int = 2,
    p_v_max: Optional[int] = None, p_e_max: Optional[int] = None,
    g_v_max: Optional[int] = None, g_e_max: Optional[int] = None,
    pair_id: str = "0-0",
    plant: int = 0,
    p_num_vlabels: Optional[int] = None, p_num_elabels: Optional[int] = None,
) -> Dict:
    """One dataset record: pattern and graph records, counts,
    subisomorphisms and node/edge weights. `plant` copies the pattern into
    the graph that many times at random injective node mappings;
    p_num_vlabels/p_num_elabels restrict the pattern's label vocabulary."""
    if plant:
        if pv > gv:
            raise ValueError(
                f"plant needs pv <= gv (pattern {pv} nodes into a {gv}-node"
                " graph)")
        if plant * pe > ge:
            raise ValueError(
                f"plant={plant} needs plant*pe <= ge ({plant}*{pe} edge"
                f" slots > {ge} graph edges)")
    ps, pr, pvl, pel = random_multidigraph(
        rng, pv, pe, p_num_vlabels or num_vlabels,
        p_num_elabels or num_elabels)
    gs, gr, gvl, gel = random_multidigraph(rng, gv, ge, num_vlabels,
                                           num_elabels)
    for j in range(plant):
        m = rng.choice(gv, size=pv, replace=False)
        gvl[m] = pvl
        slots = slice(j * pe, (j + 1) * pe)
        gs[slots] = m[ps]
        gr[slots] = m[pr]
        gel[slots] = pel

    subiso = enumerate_subisomorphisms(ps, pr, pvl, pel, gs, gr, gvl, gel)
    return {
        "id": pair_id,
        "pattern": single_graph(pv, ps, pr, pvl, pel,
                                v_max=p_v_max or pv, e_max=p_e_max or pe),
        "graph": single_graph(gv, gs, gr, gvl, gel,
                              v_max=g_v_max or gv, e_max=g_e_max or ge),
        "counts": subiso.shape[0],
        "subisomorphisms": subiso,
        "node_weights": node_subiso_weights(gv, subiso),
        "edge_weights": edge_subiso_weights(ps, pr, pel, gs, gr, gel,
                                            subiso),
    }


def generate_dataset(n_pairs: int, seed: int = 0, **kw) -> List[Dict]:
    rng = np.random.default_rng(seed)
    return [generate_pair(rng, pair_id=f"P{i}-G{i}", **kw)
            for i in range(n_pairs)]


def generate_large_graph(num_nodes: int, num_edges: int, num_rels: int = 4,
                         seed: int = 0, power_law: bool = True):
    """Synthetic large-graph triplets -> (triplets int64 [E, 3] of (src,
    rel, dst), num_nodes). power_law draws both endpoints from a
    zipf(0.8)-weighted permutation of the node ids (heavy-tailed
    degrees); otherwise uniformly. Self loops move their destination to
    the next id. 24 bytes an edge of host memory."""
    rng = np.random.default_rng(seed)
    if power_law:
        w = 1.0 / np.arange(1, num_nodes + 1) ** 0.8
        w /= w.sum()
        perm = rng.permutation(num_nodes)
        src = perm[rng.choice(num_nodes, size=num_edges, p=w)]
        dst = perm[rng.choice(num_nodes, size=num_edges, p=w)]
    else:
        src = rng.integers(0, num_nodes, num_edges)
        dst = rng.integers(0, num_nodes, num_edges)
    clash = src == dst
    dst[clash] = (dst[clash] + 1) % num_nodes
    rel = rng.integers(0, num_rels, num_edges)
    return (np.stack([src, rel, dst], axis=1).astype(np.int64), num_nodes)


def generate_community_graph(num_nodes: int, num_edges: int,
                             num_communities: int = 8, p_intra: float = 0.95,
                             num_rels: int = 4, seed: int = 0):
    """Community-structured triplets: an edge's endpoints share a
    community (a contiguous block of ids) with probability p_intra, the
    locality an owner partitioner can find -> (triplets [E, 3],
    num_nodes)."""
    rng = np.random.default_rng(seed)
    per = -(-num_nodes // num_communities)
    comm = rng.integers(0, num_communities, num_edges)
    src = comm * per + rng.integers(0, per, num_edges)
    intra = rng.random(num_edges) < p_intra
    dst_comm = np.where(intra, comm,
                        rng.integers(0, num_communities, num_edges))
    dst = dst_comm * per + rng.integers(0, per, num_edges)
    src = np.minimum(src, num_nodes - 1)
    dst = np.minimum(dst, num_nodes - 1)
    clash = src == dst
    dst[clash] = (dst[clash] + 1) % num_nodes
    rel = rng.integers(0, num_rels, num_edges)
    return (np.stack([src, rel, dst], axis=1).astype(np.int64), num_nodes)
