"""Inputs made from the seed (copies of chip_smoke.py's synthetic_hin and
scm_make_batch, which later work may delete in favour of these).

synthetic_hin   a heterogeneous graph: distinct (src, rel, dst) links
                without self loops, endpoints drawn with Pareto-skewed
                popularity, as in real heterogeneous graphs;
scm_pairs       pattern/graph pairs at a fixed envelope, as dense numpy
                arrays [N, ...]: every pattern has pv nodes and pe edges,
                every graph gv nodes and ge edges, endpoints and labels
                uniform, with Poisson counts and per-node weights.
"""

from __future__ import annotations

from typing import Dict

import numpy as np


def synthetic_hin(num_nodes: int, num_links: int, num_rels: int,
                  rng: np.random.Generator) -> np.ndarray:
    w = rng.pareto(2.0, num_nodes) + 1.0
    p = w / w.sum()
    keys = np.zeros(0, np.int64)
    while len(keys) < num_links:
        k = int((num_links - len(keys)) * 1.3) + 16
        s = rng.choice(num_nodes, k, p=p)
        d = rng.choice(num_nodes, k, p=p)
        r = rng.integers(0, num_rels, k)
        new = ((s * num_rels + r) * num_nodes + d)[s != d]
        allk = np.concatenate([keys, new])
        _, first = np.unique(allk, return_index=True)
        keys = allk[np.sort(first)]
    keys = keys[:num_links]
    d = keys % num_nodes
    r = (keys // num_nodes) % num_rels
    s = keys // (num_nodes * num_rels)
    return np.stack([s, r, d], axis=1).astype(np.int64)


def scm_pairs(n: int, pv: int, pe: int, pvl: int, pel: int, gv: int,
              ge: int, gvl: int, gel: int, count_mean: float,
              weight_mean: float, rng: np.random.Generator
              ) -> Dict[str, np.ndarray]:
    """n pairs: p_src/p_dst/p_el [n, pe], p_vl [n, pv], g_src/g_dst/g_el
    [n, ge], g_vl [n, gv] (int64), counts [n] and node_weights [n, gv]
    (float32, Poisson)."""
    return {
        "p_src": rng.integers(0, pv, (n, pe)),
        "p_dst": rng.integers(0, pv, (n, pe)),
        "p_vl": rng.integers(0, pvl, (n, pv)),
        "p_el": rng.integers(0, pel, (n, pe)),
        "g_src": rng.integers(0, gv, (n, ge)),
        "g_dst": rng.integers(0, gv, (n, ge)),
        "g_vl": rng.integers(0, gvl, (n, gv)),
        "g_el": rng.integers(0, gel, (n, ge)),
        "counts": rng.poisson(count_mean, n).astype(np.float32),
        "node_weights": rng.poisson(weight_mean, (n, gv)).astype(np.float32),
    }
