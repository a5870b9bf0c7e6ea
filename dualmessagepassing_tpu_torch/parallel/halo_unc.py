"""Owner-sharded (halo) execution of the UNC model
(dualmessagepassing_tpu/parallel/halo_unc.py): the whole UNCTrainModel —
every backbone, the update MLPs and their BatchNorms, the edge norm, the
DistMult loss and its three regularisers — with the node state
owner-sharded over the ranks of a World, the layout for graphs whose
replicated [V, H] sum (parallel/ep_unc.py) outgrows the links:

  * the nodes of a padded subgraph are partitioned over the ranks
    (_assign_owners_capped: degree-balanced greedy, contiguous ranges or
    BFS region growing), each rank holding its owned rows [Vp, H];
  * every edge lives on the rank that owns its receiver, so the
    aggregation completes on the rank, with no sum of [V, H] over the
    ranks;
  * each layer fetches the boundary sender rows it needs with one
    exchange of [n, B, H] (parallel/dist.halo_exchange;
    parallel/dist.halo_table); B <= Vp by construction;
  * the BatchNorm statistics, the per-relation means and the
    regularisers' sums and counts are summed over the ranks, as in the
    edge-partitioned mode;
  * the loss gathers the final [Vp, H] node rows of every rank once
    (parallel/dist.all_gather_rows) and scores samples by packed ids
    (owner * Vp + rank), which build_halo_sub writes.

Every shape is a static envelope, (Vp, Ep, B) from halo_envelope;
build_halo_sub raises where a subgraph overflows it (B = Vp never does).

The host half (halo_envelope, the partitioners, build_halo_sub and the
unshard maps) computes the JAX package's arrays, array for array. Its
windowed-kernel plan twins (sk_*, sb_*, sbt_*, sk2_* at halo_unc.py:
293-333) are a TPU lowering: this package gives each rank its CSR plans
instead (attach_halo_csr_plans).

The device half follows parallel/ep_unc.py. The model is the one-device
UNCTrainModel (the JAX package's make_halo_model sets its
node_sharding="owner"; here parallel/dist.split_rows(..., owner=True)
does, inside make_halo_apply and make_halo_train_step). Every rank
computes the whole, replicated loss, seeds its backward with 1 / size, and the
gradients are summed over the ranks before the update, so the parameters
stay equal on every rank.
"""

from __future__ import annotations

import math
from typing import Any, Callable, Dict, Tuple

import numpy as np
import torch

from ..ops.segment_kernel import attach_csr_plan, row_pointer
from ..unc.model import UNCTrainModel, apply_unc_forward
from .dist import World, all_reduce_grads, split_rows

# the arrays build_halo_sub gives a leading [n_ranks] axis; the rest
# (samples, labels, sample_mask) every rank holds whole
SHARD_KEYS = ("nid", "node_mask", "out_deg", "senders", "receivers",
              "edge_type", "rev_flag", "edge_mask", "edge_norm",
              "send_idx", "send_mask")


# the edges a rank may hold, as a multiple of its even share
EDGE_SLACK = 1.5


def halo_envelope(v_max: int, e_max: int,
                  n_shards: int) -> Tuple[int, int, int]:
    """The static (Vp, Ep, B): owned rows, edges and boundary rows per
    rank, the JAX package's defaults (edge_slack 1.5, B = Vp, which is
    always enough)."""
    vp = -(-v_max // n_shards)
    ep = min(e_max, math.ceil(EDGE_SLACK * e_max / n_shards) + 64)
    return vp, ep, vp


def _assign_owners_capped(senders, receivers, edge_mask, v_max, n_shards,
                          vp, method):
    """owner[row] for every padded node row, at most vp rows a rank.

    "degree": nodes in descending in-degree order go to the rank with
    the fewest owned in-edges among those with room (balances the
    aggregation). "range": contiguous row ranges. "bfs": greedy region
    growing (_assign_owners_bfs), which keeps neighbours together and so
    needs fewer boundary rows."""
    if method == "range":
        return (np.arange(v_max) // vp).astype(np.int32)
    in_deg = np.bincount(receivers[edge_mask], minlength=v_max)
    if method == "bfs":
        return _assign_owners_bfs(senders, receivers, edge_mask, v_max,
                                  n_shards, vp, in_deg)
    order = np.argsort(-in_deg, kind="stable")
    owner = np.zeros(v_max, np.int32)
    load = [0] * n_shards
    rows = [0] * n_shards
    hot = int(np.count_nonzero(in_deg))
    for v, d in zip(order[:hot].tolist(), in_deg[order[:hot]].tolist()):
        s = _least_loaded(load, rows, vp)
        owner[v] = s
        load[s] += d
        rows[s] += 1
    # the nodes without an in-edge add no load: the least loaded rank
    # with room takes them until it is full, then the next
    tail = order[hot:]
    for s in sorted(range(n_shards), key=lambda i: (load[i], i)):
        k = min(max(vp - rows[s], 0), len(tail))
        owner[tail[:k]] = s
        rows[s] += k
        tail = tail[k:]
    owner[tail] = 0      # no rank has room: build_halo_sub raises
    return owner


def _least_loaded(load, rows, vp) -> int:
    """The rank with the fewest owned in-edges among those with room, the
    lowest on a tie; 0 where none has room."""
    best = -1
    for i, (l, r) in enumerate(zip(load, rows)):
        if r < vp and (best < 0 or l < load[best]):
            best = i
    return max(best, 0)


def _assign_owners_bfs(senders, receivers, edge_mask, v_max, n_shards,
                       vp, in_deg):
    """Greedy region growing: the ranks take turns claiming up to
    max(1, vp // 16) unclaimed nodes with the most edges into their owned
    set, or, where their frontier is empty, the highest-degree unclaimed
    node. At most vp rows a rank."""
    s_real = senders[edge_mask]
    r_real = receivers[edge_mask]
    # the undirected adjacency as CSR
    u = np.concatenate([s_real, r_real])
    w = np.concatenate([r_real, s_real])
    order = np.argsort(u, kind="stable")
    u, w = u[order], w[order]
    starts = np.searchsorted(u, np.arange(v_max + 1))

    owner = np.full(v_max, -1, np.int32)
    rows = [0] * n_shards
    # affinity[s, v]: the edges between v and rank s's owned nodes
    affinity = np.zeros((n_shards, v_max), np.int32)
    deg_rank = np.argsort(-in_deg, kind="stable")
    seed_ptr = 0
    c = max(1, vp // 16)
    # frontier[s]: the unclaimed nodes with affinity[s] > 0, so that a
    # turn costs what it claims, not a pass over every row
    frontier = [set() for _ in range(n_shards)]
    linked = np.diff(starts) > 0
    left, unclaimed = int(linked.sum()), v_max

    while unclaimed:
        if not left:
            # no unclaimed node has an edge, so every frontier stays
            # empty: the turns hand out the rest one node each, in
            # deg_rank order
            s = 0
            for v in deg_rank[owner[deg_rank] < 0].tolist():
                for _ in range(n_shards):
                    if rows[s] < vp:
                        break
                    s = (s + 1) % n_shards
                else:
                    break
                owner[v] = s
                rows[s] += 1
                s = (s + 1) % n_shards
            break
        progress = False
        for s in range(n_shards):
            room = vp - rows[s]
            if room <= 0:
                continue
            take = min(c, room)
            if len(frontier[s]) > take:
                # only then does the choice among the frontier depend on
                # the selection's tie order
                aff = np.where(owner < 0, affinity[s], -1)
                cand = np.argpartition(aff, -take)[-take:]
                cand = cand[aff[cand] > 0]
            elif frontier[s]:
                cand = np.array(sorted(frontier[s]), np.int64)
            else:
                while seed_ptr < v_max and owner[deg_rank[seed_ptr]] >= 0:
                    seed_ptr += 1
                if seed_ptr >= v_max:
                    continue
                cand = deg_rank[seed_ptr: seed_ptr + 1]
            owner[cand] = s
            rows[s] += len(cand)
            unclaimed -= len(cand)
            left -= int(linked[cand].sum())
            claimed = cand.tolist()
            for f in frontier:
                f.difference_update(claimed)
            nbrs = np.concatenate(
                [w[starts[v]: starts[v + 1]] for v in claimed]) if claimed \
                else np.zeros(0, np.int64)
            if len(nbrs):
                new = np.unique(nbrs)
                new = new[(affinity[s][new] == 0) & (owner[new] < 0)]
                np.add.at(affinity[s], nbrs, 1)
                frontier[s].update(new.tolist())
            progress = True
        if not progress:
            break
    return owner


def build_halo_sub(padded: Dict[str, np.ndarray], n_shards: int,
                   vp: int, ep: int, b: int, method: str = "degree"
                   ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """Partition a pad_subgraph output over n_shards ranks -> (dev, meta).

    dev holds the SHARD_KEYS arrays with a leading [n_shards] axis and
    the samples (their node ids packed: owner * vp + rank), labels and
    sample mask whole. Per rank: its owned rows (nid, node_mask, the
    host's global out_deg), its edges — those whose receiver it owns, in
    the receiver-sorted order of the stream, so a rank's local receivers
    stay sorted — with local senders into [owned; halo; dump]: an owned
    row's rank, Vp + o * b + j for the j-th boundary row from owner o,
    Vp + n * b (the dump row) for the pads; pad receivers repeat the
    last real local receiver; send_idx[o, s] / send_mask[o, s] name the
    owned rows rank o sends rank s. meta holds the inverse maps (owner,
    rank, owned_slice, edge_perm, packed) and (vp, ep, b). Overflow of
    vp, ep or b raises."""
    v_max = len(padded["nid"])
    senders = np.asarray(padded["senders"])
    receivers = np.asarray(padded["receivers"])
    e_mask_in = np.asarray(padded["edge_mask"])

    owner = _assign_owners_capped(senders, receivers, e_mask_in, v_max,
                                  n_shards, vp, method)
    rows = np.bincount(owner, minlength=n_shards)
    if rows.max() > vp:
        raise ValueError(f"partition places {rows.max()} rows on one shard; "
                         f"envelope vp={vp}")

    rank = np.zeros(v_max, np.int64)
    owned_slice = np.full((n_shards, vp), -1, np.int64)
    for s in range(n_shards):
        idx = np.flatnonzero(owner == s)
        rank[idx] = np.arange(len(idx))
        owned_slice[s, : len(idx)] = idx

    valid = owned_slice >= 0
    safe = np.maximum(owned_slice, 0)
    nid_sh = np.where(valid, np.asarray(padded["nid"])[safe], 0)
    node_mask_sh = np.logical_and(valid,
                                  np.asarray(padded["node_mask"])[safe])
    out_deg_full = np.bincount(senders[e_mask_in], minlength=v_max
                               ).astype(np.float32)
    out_deg_sh = np.where(valid, out_deg_full[safe], 0.0).astype(np.float32)

    # edges go to their receiver's owner
    real = np.flatnonzero(e_mask_in)
    e_owner = owner[receivers[real]]
    counts = np.bincount(e_owner, minlength=n_shards)
    if counts.max() > ep:
        raise ValueError(
            f"{counts.max()} edges land on one shard; envelope ep={ep} "
            f"(EDGE_SLACK in halo_envelope)")

    dump = vp + n_shards * b
    l_send = np.full((n_shards, ep), dump, np.int64)
    l_recv = np.zeros((n_shards, ep), np.int64)
    e_type = np.zeros((n_shards, ep), np.asarray(padded["edge_type"]).dtype)
    rev_sh = np.zeros((n_shards, ep), np.asarray(padded["rev_flag"]).dtype)
    e_mask_sh = np.zeros((n_shards, ep), bool)
    has_norm = "edge_norm" in padded
    if has_norm:
        norm_sh = np.zeros((n_shards, ep, 1), np.float32)
    edge_perm = []

    need = []
    send_idx = np.zeros((n_shards, n_shards, b), np.int64)
    send_mask = np.zeros((n_shards, n_shards, b), bool)
    for s in range(n_shards):
        es = real[e_owner == s]
        snd = senders[es]
        row = []
        for o in range(n_shards):
            if o == s:
                row.append(np.zeros(0, np.int64))
                continue
            uniq = np.unique(snd[owner[snd] == o])
            if len(uniq) > b:
                raise ValueError(f"boundary {len(uniq)} > envelope b={b}")
            row.append(uniq)
            send_idx[o, s, : len(uniq)] = rank[uniq]
            send_mask[o, s, : len(uniq)] = True
        need.append(row)

        k = len(es)
        local = np.zeros(k, np.int64)
        own_s = owner[snd]
        for o in range(n_shards):
            m = own_s == o
            if not m.any():
                continue
            if o == s:
                local[m] = rank[snd[m]]
            else:
                local[m] = vp + o * b + np.searchsorted(need[s][o], snd[m])
        l_send[s, :k] = local
        l_recv[s, :k] = rank[receivers[es]]
        if k:
            # the pad tail repeats the last real receiver: the rank's
            # stream stays sorted
            l_recv[s, k:] = l_recv[s, k - 1]
        e_type[s, :k] = np.asarray(padded["edge_type"])[es]
        rev_sh[s, :k] = np.asarray(padded["rev_flag"])[es]
        e_mask_sh[s, :k] = True
        if has_norm:
            norm_sh[s, :k] = np.asarray(padded["edge_norm"])[es]
        edge_perm.append(es)

    # samples by packed ids (owner * vp + rank)
    packed = owner.astype(np.int64) * vp + rank
    samples = np.asarray(padded["samples"]).copy()
    samples[:, 0] = packed[samples[:, 0]]
    samples[:, 2] = packed[samples[:, 2]]

    dev = {
        "nid": nid_sh, "node_mask": node_mask_sh, "out_deg": out_deg_sh,
        "senders": l_send, "receivers": l_recv, "edge_type": e_type,
        "rev_flag": rev_sh, "edge_mask": e_mask_sh,
        "send_idx": send_idx, "send_mask": send_mask,
        "samples": samples, "labels": np.asarray(padded["labels"]),
        "sample_mask": np.asarray(padded["sample_mask"]),
    }
    if has_norm:
        dev["edge_norm"] = norm_sh
    meta = {"owner": owner, "rank": rank, "owned_slice": owned_slice,
            "edge_perm": edge_perm, "vp": vp, "ep": ep, "b": b,
            "packed": packed}
    return dev, meta


def rank_sub(dev: Dict[str, np.ndarray], rank: int) -> Dict[str, np.ndarray]:
    """Rank `rank`'s slice of build_halo_sub's dev: its row of every
    SHARD_KEYS array, the samples, labels and mask whole."""
    return {k: (v[rank] if k in SHARD_KEYS else v) for k, v in dev.items()}


def attach_halo_csr_plans(shard: Dict[str, np.ndarray],
                          sender_plan: bool = False
                          ) -> Dict[str, np.ndarray]:
    """The K1/K2 plans of one rank's slice (rank_sub's). The rank indexes
    three row spaces: its owned rows [Vp] (the aggregation), the
    composite sender table [Vt = Vp + n * B + 1] (owned, halo, dump) and
    the receivers, always owned rows. So:
      sk_rowptr   int32 [Vp+1]: the receiver plan over the rank's real
                  edges, K1's aggregation into Vp rows (and n_real);
      skt_rowptr  int32 [Vt+1]: the same receivers over Vt rows, the
                  plan of DualGraphConv's receiver gather from the
                  [Vt, 2H+1] table (K2, and K1 its backward into Vt
                  rows); its tail is flat, as no receiver is >= Vp;
      send_pos    int64: the real slots of the flattened [n * B]
                  send_mask, send_rows the owned rows send_idx names
                  there (the send buffer's gather, dist.halo_table);
    and with sender_plan=True (training), from a stable sort of the real
    local senders:
      sk2_order   int64 [n_real], sk2_rowptr int32 [Vt+1]: the sender
                  plan over the composite table (K1, the sender gathers'
                  backward into Vt rows).
    A rank without a real edge gets empty plans (n_real = 0)."""
    n, b = np.asarray(shard["send_idx"]).shape
    vp = len(shard["node_mask"])
    vt = vp + n * b + 1
    out = attach_csr_plan(shard)
    n_real = out["n_real"]
    out["skt_rowptr"] = np.concatenate(
        [out["sk_rowptr"], np.full(vt - vp, n_real, np.int32)])
    out["send_pos"] = np.flatnonzero(np.asarray(shard["send_mask"]))
    out["send_rows"] = np.asarray(shard["send_idx"]).reshape(-1)[
        out["send_pos"]]
    if sender_plan:
        send = np.asarray(shard["senders"])[:n_real]
        order = np.argsort(send, kind="stable").astype(np.int64)
        out["sk2_order"] = order
        out["sk2_rowptr"] = row_pointer(send[order], vt, "senders")
    return out


def halo_rank_shard(padded: Dict[str, np.ndarray], world: World,
                    envelope: Tuple[int, int, int], method: str = "degree",
                    sender_plan: bool = False
                    ) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """A padded subgraph -> (this rank's planned slice, build_halo_sub's
    meta). Every rank partitions the whole subgraph (the host work is
    the same on each) and keeps its slice."""
    vp, ep, b = envelope
    dev, meta = build_halo_sub(padded, world.size, vp, ep, b, method=method)
    return attach_halo_csr_plans(rank_sub(dev, world.rank),
                                 sender_plan=sender_plan), meta


def make_halo_apply(model: UNCTrainModel, world: World,
                    amp: bool = False) -> Callable:
    """sub (this rank's planned slice, tensors on its device) -> the
    output tuple of an eval-mode forward, node and edge rows this rank's
    ([Vp, H], [Ep, H]; make_halo_apply at halo_unc.py:374-398 returns
    them with the leading rank axis), DMPNN's per-relation means whole.
    amp as apply_unc_forward's: the exchange then carries bf16 rows."""

    def fwd(sub):
        with torch.inference_mode(), split_rows(model, world, owner=True):
            return apply_unc_forward(model, sub, amp=amp, train=False)

    return fwd


def make_halo_train_step(model: UNCTrainModel, optimizer, world: World,
                         amp: bool = False, generator=None) -> Callable:
    """sub -> loss, as parallel/ep_unc.make_ep_train_step, owner-sharded
    (halo_unc.py:401-438): the full unsupervised loss, the same on every
    rank; each rank's backward seeded with 1 / world.size, the gradients
    summed over the ranks, then the optimizer's update. Dropout acts on
    each rank's own rows, drawn from its generator."""

    def step(sub):
        optimizer.zero_grad()
        with split_rows(model, world, owner=True):
            out = apply_unc_forward(model, sub, amp=amp, train=True,
                                    generator=generator)
            loss = model.unsupervised_loss(
                out, sub["edge_type"], sub["edge_mask"], sub["samples"],
                sub["labels"], sub["sample_mask"], sub["node_mask"])
            (loss / world.size).backward()
        all_reduce_grads(optimizer.params, world)
        optimizer.step()
        return loss.detach()

    return step


def unshard_halo_nodes(meta: Dict[str, Any], sharded) -> np.ndarray:
    """[n, Vp, ...] owner-sharded node rows -> [v_max, ...] in the
    subgraph's row order."""
    arr = np.asarray(sharded)
    v_max = len(meta["owner"])
    out = np.zeros((v_max,) + arr.shape[2:], arr.dtype)
    for s in range(arr.shape[0]):
        idx = meta["owned_slice"][s]
        ok = idx >= 0
        out[idx[ok]] = arr[s][ok]
    return out


def unshard_halo_edges(meta: Dict[str, Any], sharded,
                       e_max: int) -> np.ndarray:
    """[n, Ep, ...] receiver-owner-placed edge rows -> [e_max, ...] in the
    subgraph's (receiver-sorted) edge order, the pad rows zero."""
    arr = np.asarray(sharded)
    out = np.zeros((e_max,) + arr.shape[2:], arr.dtype)
    for s, es in enumerate(meta["edge_perm"]):
        out[es] = arr[s][: len(es)]
    return out
