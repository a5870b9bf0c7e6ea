"""Owner-sharded edge partitioning with boundary (halo) exchange: the JAX
package's halo library (dualmessagepassing_tpu/parallel/halo.py) over
the ranks of a World.

The full-sum layer (parallel/edge_partition.py) replicates the node
table and sums the whole [V, H] table over the ranks once a layer. Here:

  * the nodes are partitioned into owner-contiguous slices
    (assign_owners: degree-balanced greedy, or contiguous id ranges);
  * every edge lives on the rank that owns its receiver, so the
    aggregation is local, on K3 (ops/scatter.SegmentSumRows), with no
    collective;
  * each layer fetches the sender rows that other ranks own with one
    parallel/dist.halo_exchange of [n, B, H] boundary rows, B the
    partition's largest real boundary (build_halo_partition sizes it;
    it is not an envelope).

The host half (assign_owners, build_halo_partition, unshard_nodes) is a
numpy copy of the JAX package's, array for array, the degree loop's
np.argmin tie-breaking included. The layer is edge_partition.dmp_layer,
the same parameters. Its gathers index a [owned; halo; dump] table of
Vp + n * B + 1 rows. Indices that JAX leaves to XLA's clamping are in
range here: pad senders name the dump row Vp + n * B, and pad receivers
name Vp. In the table Vp is the first halo row, so those edges' rows
are masked to zero at the end of each layer, as JAX masks them. In the
aggregation Vp is one past the owned rows, so K3 drops them (JAX sums
them into a dump row it slices off). The send buffer is filled at its
real slots only (dist.halo_table). JAX gathers every slot and
masks, and its pad slots all name row 0.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch

from .dist import World, halo_table
from .edge_partition import Params, dmp_layer


def assign_owners(senders: np.ndarray, receivers: np.ndarray,
                  num_nodes: int, n_shards: int,
                  method: str = "degree") -> np.ndarray:
    """owner[v] for every node.

    "degree": greedy load balance — nodes in descending in-degree order go
    to the shard with the fewest owned edges (balances the local
    segment-sum work); contiguous runs of the original ids stay together
    only by accident, so boundaries are whatever the wiring gives.
    "range": contiguous equal-node ranges of the ORIGINAL ids — minimizes
    boundaries when the generator wires locally (community graphs).
    """
    if method == "range":
        per = -(-num_nodes // n_shards)
        return (np.arange(num_nodes) // per).astype(np.int32)
    in_deg = np.bincount(receivers, minlength=num_nodes)
    order = np.argsort(-in_deg, kind="stable")
    owner = np.zeros(num_nodes, np.int32)
    load = np.zeros(n_shards, np.int64)
    for v in order:
        s = int(np.argmin(load))
        owner[v] = s
        load[s] += in_deg[v]
    return owner


def build_halo_partition(senders: np.ndarray, receivers: np.ndarray,
                         rev_flag: np.ndarray, num_nodes: int,
                         n_shards: int, method: str = "degree"
                         ) -> Dict[str, Any]:
    """Host-side partition + exchange plan. All arrays carry a leading
    shard axis; rank r reads row r (shard_halo_arrays).

    Returns (n = n_shards, Vp = padded owned nodes/shard, Ep = padded
    edges/shard, B = padded boundary rows per (shard, owner) pair):
      owner, perm              renumbering: new_id = rank within owner
      owned_slice [n, Vp]      original node id of each owned row (pad -1)
      local_senders [n, Ep]    index into the shard's local table
                               (0..Vp-1 owned, Vp + o*B + j halo)
      local_receivers [n, Ep]  index into the owned slice (Vp = dump row)
      edge_mask [n, Ep]
      rev_flag [n, Ep]
      send_idx [n, n, B]       rows of MY owned slice to send to shard t
      send_mask [n, n, B]
      out_deg [n, Vp]          global out-degree of owned nodes
      edge_perm [E]            original edge index of each packed slot
    """
    E = len(senders)
    owner = assign_owners(senders, receivers, num_nodes, n_shards, method)
    # owner-contiguous renumbering
    counts = np.bincount(owner, minlength=n_shards)
    Vp = int(counts.max())
    rank = np.zeros(num_nodes, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(owner == s)
        rank[idx] = np.arange(len(idx))
    owned_slice = np.full((n_shards, Vp), -1, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(owner == s)
        owned_slice[s, : len(idx)] = idx

    e_shard = owner[receivers]
    e_counts = np.bincount(e_shard, minlength=n_shards)
    Ep = int(e_counts.max()) if E else 1

    # boundary sets: unique senders per (dst shard, src owner)
    need: List[List[np.ndarray]] = []
    B = 1
    for s in range(n_shards):
        es = np.flatnonzero(e_shard == s)
        row = []
        for o in range(n_shards):
            if o == s:
                row.append(np.zeros(0, np.int64))
                continue
            snd = senders[es]
            uniq = np.unique(snd[owner[snd] == o])
            row.append(uniq)
            B = max(B, len(uniq))
        need.append(row)

    send_idx = np.zeros((n_shards, n_shards, B), np.int64)
    send_mask = np.zeros((n_shards, n_shards, B), bool)
    for o in range(n_shards):
        for t in range(n_shards):
            ids = need[t][o]
            send_idx[o, t, : len(ids)] = rank[ids]
            send_mask[o, t, : len(ids)] = True

    # pad senders address the ZERO dump row (Vp + n*B) of the
    # [owned; halo; dump] table — Vp alone is the first HALO row, i.e.
    # another shard's real boundary features leaking into masked edges
    local_senders = np.full((n_shards, Ep), Vp + n_shards * B, np.int64)
    local_receivers = np.full((n_shards, Ep), Vp, np.int64)
    edge_mask = np.zeros((n_shards, Ep), bool)
    rev_out = np.zeros((n_shards, Ep), rev_flag.dtype)
    edge_perm = np.zeros(E, np.int64)
    off = 0
    for s in range(n_shards):
        es = np.flatnonzero(e_shard == s)
        k = len(es)
        snd, rcv = senders[es], receivers[es]
        lr = rank[rcv]
        halo = np.zeros(k, np.int64)
        own_s = owner[snd]
        for o in range(n_shards):
            m = own_s == o
            if not m.any():
                continue
            if o == s:
                halo[m] = rank[snd[m]]
            else:
                pos = np.searchsorted(need[s][o], snd[m])
                halo[m] = Vp + o * B + pos
        local_senders[s, :k] = halo
        local_receivers[s, :k] = lr
        edge_mask[s, :k] = True
        rev_out[s, :k] = rev_flag[es]
        edge_perm[off: off + k] = es
        off += k

    out_deg_global = np.bincount(senders, minlength=num_nodes).astype(
        np.float32)
    out_deg = np.zeros((n_shards, Vp), np.float32)
    for s in range(n_shards):
        idx = owned_slice[s]
        valid = idx >= 0
        out_deg[s, valid] = out_deg_global[idx[valid]]

    return {
        "owner": owner, "rank": rank, "owned_slice": owned_slice,
        "local_senders": local_senders, "local_receivers": local_receivers,
        "edge_mask": edge_mask, "rev_flag": rev_out,
        "send_idx": send_idx, "send_mask": send_mask,
        "out_deg": out_deg, "edge_perm": edge_perm,
        "Vp": Vp, "Ep": Ep, "B": B, "n": n_shards,
    }


def shard_halo_arrays(world: World, part: Dict[str, Any],
                      node_feat: np.ndarray, edge_feat: np.ndarray,
                      device="cuda") -> Dict[str, torch.Tensor]:
    """This rank's slice of the plan and of the features, as tensors on
    `device` (halo.py:184-219 cuts the same rows with its 'ep'
    sharding): owned_feat [Vp, H] (node_feat [V, H] in original ids,
    packed by owned_slice), edge_feat [Ep, H] (edge_feat [E, H] packed
    by edge_perm), and the rank's row of every plan array."""
    n, Vp, Ep = part["n"], part["Vp"], part["Ep"]
    if world.size != n:
        raise ValueError(f"a partition over {n} shards for {world.size} "
                         "ranks")
    s = world.rank
    H = node_feat.shape[1]
    idx = part["owned_slice"][s]
    valid = idx >= 0
    owned_feat = np.zeros((Vp, H), node_feat.dtype)
    owned_feat[valid] = node_feat[idx[valid]]
    off = int(part["edge_mask"][:s].sum())
    k = int(part["edge_mask"][s].sum())
    e_feat = np.zeros((Ep, H), edge_feat.dtype)
    e_feat[:k] = edge_feat[part["edge_perm"][off: off + k]]
    out = {"owned_feat": owned_feat, "edge_feat": e_feat}
    out.update({key: part[key][s] for key in ARG_ORDER[2:]})
    out["rev_flag"] = out["rev_flag"].astype(bool)
    return {key: torch.tensor(v, device=device) for key, v in out.items()}


ARG_ORDER = ("owned_feat", "edge_feat", "local_senders", "local_receivers",
             "edge_mask", "rev_flag", "send_idx", "send_mask", "out_deg")


def make_halo_dmp_apply(world: World, num_layers: int = 1,
                        activation: str = "tanh_between") -> Callable:
    """The owner-sharded multi-layer DMP forward (halo.py:222-306): the
    layer math and parameters of edge_partition.edge_parallel_dmp_apply,
    one halo exchange a layer in place of the [V, H] sum over the ranks.

    Call positionally with the dict from shard_halo_arrays:
      fwd(layer_params, *[arrays[k] for k in ARG_ORDER])
        -> (owned_out [Vp, H], edge_out [Ep, H]): this rank's rows, its
        pad edges' rows zero."""

    def forward(layer_params: Params, owned_feat, edge_feat, local_senders,
                local_receivers, edge_mask, rev_flag, send_idx, send_mask,
                out_deg):
        if len(layer_params) != num_layers:
            raise ValueError(f"{len(layer_params)} layers of parameters "
                             f"for a {num_layers}-layer forward")
        vp = owned_feat.shape[0]
        pos = torch.nonzero(send_mask.reshape(-1))[:, 0]
        plan = {"send_idx": send_idx, "send_pos": pos,
                "send_rows": send_idx.reshape(-1)[pos]}
        # jnp.minimum(rcv, Vp) into [log2(1 + out_deg); 0]
        d = torch.cat([torch.log2(1.0 + out_deg), out_deg.new_zeros(1)]
                      ).index_select(0, local_receivers.clamp(max=vp))[:, None]
        em = edge_mask[:, None]
        h, e = owned_feat, edge_feat
        for i, p in enumerate(layer_params):
            table = halo_table(h, plan, world)
            h, e = dmp_layer(p, h, table, e, local_senders, local_receivers,
                             rev_flag, edge_mask, d)
            e = torch.where(em, e, 0.0)
            if activation == "tanh_between" and i < len(layer_params) - 1:
                h, e = torch.tanh(h), torch.tanh(e)
        return h, e

    return forward


def unshard_nodes(part: Dict[str, Any], owned_out: Sequence) -> np.ndarray:
    """[n, Vp, H] owned outputs (each rank's [Vp, H], in rank order) ->
    [V, H] in original node order."""
    arr = np.asarray(owned_out)
    V = len(part["owner"])
    out = np.zeros((V, arr.shape[-1]), arr.dtype)
    for s in range(part["n"]):
        idx = part["owned_slice"][s]
        valid = idx >= 0
        out[idx[valid]] = arr[s][valid]
    return out

