"""Halo-partitioner quality: boundary rows exported per method, the port
of scripts/partition_bench.py.

    python -m dualmessagepassing_tpu_torch.bench.partition_bench \
        [n_nodes] [n_shards]

Host only: the partitioners of parallel/halo_unc.py (the owner-sharded
UNC mode's: degree, range, bfs) at halo_envelope's owned-row cap. The
boundary size sets the per-layer exchange [n, B, H]. Two graph families:
  * community: a ring of 32-node cliques (each node wired to 6 of its
    clique) with one bridge a clique, the case locality-aware
    partitioning exists for;
  * powerlaw: data/synthetic.generate_large_graph's preferential wiring
    (8 edges a node), where hubs touch every shard.

Prints a JSON line per (family, method): the boundary rows in total (the
rows exchanged a layer, summed over the shards), the largest per
(shard, owner) pair (what sizes B), and build_s, the partitioner's host
seconds alone (the owners; the boundary count is not timed).
"""

from __future__ import annotations

import json
import sys
import time
from typing import Callable, Dict, List

import numpy as np

from ..data.synthetic import generate_large_graph
from ..parallel.halo_unc import _assign_owners_capped, halo_envelope


def community_graph(n, clique, rng):
    srcs, dsts = [], []
    n_cliq = n // clique
    for c in range(n_cliq):
        base = c * clique
        members = np.arange(base, base + clique)
        for i in members:
            nbrs = rng.choice(members[members != i],
                              size=min(6, clique - 1), replace=False)
            srcs.extend([i] * len(nbrs))
            dsts.extend(nbrs)
        srcs.append(base)
        dsts.append(((c + 1) % n_cliq) * clique)
    return np.asarray(srcs), np.asarray(dsts)


def powerlaw_graph(n, m, rng):
    triplets, _ = generate_large_graph(n, n * m, seed=1, power_law=True)
    return (np.asarray(triplets[:, 0], np.int64),
            np.asarray(triplets[:, 2], np.int64))


def boundary_rows(senders, receivers, owner, n_shards):
    """(total, largest) boundary rows: the unique senders each shard
    imports from each other owner."""
    total_b = 0
    max_b = 0
    e_owner = owner[receivers]
    for s in range(n_shards):
        snd = senders[e_owner == s]
        foreign = snd[owner[snd] != s]
        per_owner = {}
        for o in np.unique(owner[foreign]):
            per_owner[o] = len(np.unique(foreign[owner[foreign] == o]))
        total_b += sum(per_owner.values())
        if per_owner:
            max_b = max(max_b, max(per_owner.values()))
    return total_b, max_b


def run(n: int = 4096, n_shards: int = 8,
        print_fn: Callable[[str], None] = print) -> List[Dict]:
    """Every (family, method) record at n nodes over n_shards shards."""
    rng = np.random.default_rng(0)
    records = []
    for family, (senders, receivers) in (
        ("community", community_graph(n, 32, rng)),
        ("powerlaw", powerlaw_graph(n, 8, rng)),
    ):
        e = len(senders)
        mask = np.ones(e, bool)
        vp, _, _ = halo_envelope(n, e, n_shards)
        for method in ("range", "degree", "bfs"):
            t0 = time.perf_counter()
            owner = _assign_owners_capped(senders, receivers, mask, n,
                                          n_shards, vp, method)
            dt = time.perf_counter() - t0
            total_b, max_b = boundary_rows(senders, receivers, owner,
                                           n_shards)
            rec = {"family": family, "method": method, "v": n, "e": e,
                   "boundary_rows_total": int(total_b),
                   "boundary_rows_max": int(max_b), "build_s": dt}
            records.append(rec)
            print_fn(json.dumps(rec))
    return records


def main(argv=None) -> List[Dict]:
    argv = sys.argv[1:] if argv is None else argv
    n = int(argv[0]) if len(argv) > 0 else 4096
    n_shards = int(argv[1]) if len(argv) > 1 else 8
    return run(n, n_shards)


if __name__ == "__main__":
    main()
