"""The port's process groups (dualmessagepassing_tpu_torch/parallel/) on
the CPU over gloo, and the rank functions that tests/test_torch_dp.py,
tests/test_torch_ep_unc.py, tests/test_torch_halo_unc.py,
tests/test_torch_edge_partition.py, tests/test_torch_halo.py and
tests/test_torch_examples.py launch.

This file imports no JAX: the ranks are spawned processes that import it
by name, and the machine with the card has no JAX. The JAX side of those
comparisons runs in the pytest process only.

Tolerances here: the sums over two ranks against one process's sum,
1e-6 of each tensor's largest magnitude (float32 in another order); the
owner-sharded collectives over three ranks against one process's
indexing, the loss rtol 1e-6 and each gradient 1e-6 of its largest
magnitude.
"""

import os

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch.bench import halo_bench
from dualmessagepassing_tpu_torch.examples import (edge_parallel,
                                                   multichip_dp,
                                                   performance_levers)
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.ops.segment_kernel import attach_csr_plan
from dualmessagepassing_tpu_torch.parallel import dist as pd
from dualmessagepassing_tpu_torch.parallel import dp
from dualmessagepassing_tpu_torch.parallel import edge_partition
from dualmessagepassing_tpu_torch.parallel import ep_unc
from dualmessagepassing_tpu_torch.parallel import halo
from dualmessagepassing_tpu_torch.parallel import halo_unc
from dualmessagepassing_tpu_torch.train import checkpoint as ck
from dualmessagepassing_tpu_torch.train import scm_driver as sd
from dualmessagepassing_tpu_torch.unc import driver as ud
from dualmessagepassing_tpu_torch.unc import model as um

# seconds a test's spawned ranks may take, and a collective may wait
RUN_TIMEOUT, COLLECTIVE_TIMEOUT = 240.0, 120.0


def run_ranks(fn, tmp_path, *args, size=2, timeout=RUN_TIMEOUT):
    """fn(world, *args) on `size` gloo ranks on the CPU, one thread each."""
    return pd.launch(fn, size, backend="gloo", devices=["cpu"] * size,
                     init_file=str(tmp_path / f"rdv_{fn.__name__}"),
                     args=args, timeout=timeout,
                     collective_timeout=COLLECTIVE_TIMEOUT, threads=1)


def _numpy(tensors: dict) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in tensors.items()}


# -----------------------------------------------------------------------------
# SCM data parallelism (tests/test_torch_dp.py)
# -----------------------------------------------------------------------------

def scm_model(spec, device="cpu"):
    m = sm.build_model(spec["cfg"], device=device)
    m.load_state_dict(sm.params_from_flax(spec["params"], spec["stats"]))
    return m


def scm_batch(spec, rows=None):
    """(pattern, graph, counts, node weights, edge weights) of the spec's
    records, the rows given or all."""
    rows = np.arange(len(spec["pats"])) if rows is None else rows
    pats = [spec["pats"][i] for i in rows]
    gras = [spec["gras"][i] for i in rows]
    return (tg.batch_graphs(pats), tg.batch_graphs(gras),
            *(torch.from_numpy(spec[k][rows]) for k in ("counts", "nw", "ew")))


def _dp_steps(world, spec, amp=False, chunks=None, steps=None):
    """Steps of a DP train step on this rank's rows -> (model, step,
    per-step losses, per-step gradients)."""
    model = scm_model(spec)
    tx = sd.make_optimizer(model.parameters(), spec["lr"])
    step = sd.make_train_step(model, tx, return_weights="nodeedge",
                              eval_metric="MAE", amp=amp,
                              accum_chunks=chunks, world=world)
    sd.dp_replicate_state(step)
    batch = scm_batch(spec, dp.shard_rows(len(spec["pats"]), world,
                                          step.chunks))
    losses, grads = [], []
    for s in range(steps or spec["steps"]):
        out = step(*batch, *spec["scal"], spec["lr_mult"])
        losses.append({k: float(v) for k, v in out.items()})
        grads.append(_numpy({k: p.grad for k, p in model.named_parameters()}))
        pin(model, spec["pins"][s] if spec.get("pins") else {})
    return model, step, losses, grads


def pin(model, values: dict) -> None:
    """Set the named parameters to the given arrays."""
    with torch.no_grad():
        for k, v in values.items():
            model.get_parameter(k).copy_(torch.from_numpy(v))


def scm_dp_rank(world, specs, ckpt_dir):
    """Per case of `specs` the DP steps' losses, gradients and final state;
    the ragged path's gradient (the whole batch on every rank); amp with
    two microbatches; a checkpoint of the bn case saved by rank 0 and
    restored into a fresh DP model on every rank."""
    out = {}
    for name, spec in specs.items():
        model, step, losses, grads = _dp_steps(world, spec)
        out[name] = dict(losses=losses, grads=grads,
                         state=_numpy(model.state_dict()))
        # the ragged path: every rank the whole batch, no cross-rank
        # statistics, the gradients summed
        m2 = scm_model(spec)
        s2 = sd.make_train_step(m2, sd.make_optimizer(m2.parameters(),
                                                      spec["lr"]),
                                return_weights="nodeedge", eval_metric="MAE",
                                world=world)
        s2(*scm_batch(spec), *spec["scal"], spec["lr_mult"], sharded=False)
        out[name]["ragged_grads"] = _numpy(
            {k: p.grad for k, p in m2.named_parameters()})
        if name == "bn":
            path = os.path.join(ckpt_dir, "epoch1")
            if world.rank == 0:
                ck.save_state(path, model, step.optimizer,
                              step.optimizer.count)
            pd.dist.barrier()
            fresh = scm_model(spec)
            tx = sd.make_optimizer(fresh.parameters(), spec["lr"])
            if world.rank == 0:
                ck.restore_state(path, fresh, tx)
            s3 = sd.make_train_step(fresh, tx, world=world)
            sd.dp_replicate_state(s3)     # rank 0's restored state
            out["resumed"] = dict(state=_numpy(fresh.state_dict()),
                                  count=tx.count,
                                  mu=[s["mu"].numpy().copy()
                                      for s in tx.state])
    spec = specs["bn"]
    model, _, losses, _ = _dp_steps(world, dict(spec, pins=None), amp=True,
                                    chunks=2)
    out["amp_chunks"] = dict(losses=losses, state=_numpy(model.state_dict()))
    return out


# -----------------------------------------------------------------------------
# UNC edge partitioning (tests/test_torch_ep_unc.py)
# -----------------------------------------------------------------------------

def unc_model(spec):
    m = um.UNCTrainModel(spec["n"], spec["r"], spec["h"],
                         num_hidden_layers=spec["layers"],
                         reg_param=spec["reg"], backbone=spec["backbone"])
    m.load_state_dict(um.params_from_flax(spec["params"], spec["stats"]))
    return m


def ep_shard(padded, world, sender_plan=True):
    return ud.to_device(ep_unc.attach_ep_csr_plans(
        ep_unc.shard_sub(padded, world), sender_plan=sender_plan), "cpu")


def unc_ep_rank(world, specs, train):
    """Per backbone of `specs`: the edge-partitioned eval forward (node
    rows, this rank's edge rows, per-relation means), the full loss and
    every gradient of a train-mode forward (BatchNorm on), and the
    parameters, statistics and losses of two steps of the clipped Adam
    on its cosine schedule, the BN-fed biases pinned after each step to
    the values the spec gives. Then train_unc as this rank of `world` on
    the HIN `train` gives (triplets, nodes, relations): one epoch and the
    export."""
    t, n, r = train
    model = um.UNCTrainModel(n, r, 8, num_hidden_layers=1, reg_param=0.01,
                             generator=torch.Generator().manual_seed(0))
    embs, coverage = ud.train_unc(model, t, n, r, graph_batch_size=40,
                                  n_epochs=1, sample_depth=2, sample_width=4,
                                  log=print, world=world)
    out = {"train_unc": dict(embs=embs, coverage=coverage,
                             state=_numpy(model.state_dict()))}
    for name, spec in specs.items():
        m = unc_model(spec)
        sub = ep_shard(spec["batches"][0], world)
        res = {"fwd": [t.numpy().copy() for t in
                       ep_unc.make_ep_apply(m, world)(sub)]}
        with pd.split_rows(m, world):
            o = um.apply_unc_forward(m, sub, train=True)
            loss = m.unsupervised_loss(
                o, sub["edge_type"], sub["edge_mask"], sub["samples"],
                sub["labels"], sub["sample_mask"], sub["node_mask"])
            (loss / world.size).backward()
        pd.all_reduce_grads(m.parameters(), world)
        res["loss"] = loss.item()
        res["grads"] = _numpy({k: p.grad for k, p in m.named_parameters()})

        m = unc_model(spec)
        opt = ud.make_unc_optimizer(m, spec["lr"], spec["total_steps"], 1.0)
        step = ep_unc.make_ep_train_step(m, opt, world)
        res["losses"] = []
        for b, pins in zip(spec["batches"], spec["pins"]):
            res["losses"].append(step(ep_shard(b, world)).item())
            pin(m, pins)
        res["state"] = _numpy(m.state_dict())
        out[name] = res
    return out


# -----------------------------------------------------------------------------
# UNC owner sharding (tests/test_torch_halo_unc.py)
# -----------------------------------------------------------------------------

def halo_shard(padded, world, spec, sender_plan=True):
    shard, _ = halo_unc.halo_rank_shard(padded, world, spec["envelope"],
                                        spec["method"],
                                        sender_plan=sender_plan)
    return ud.to_device(shard, "cpu")


def unc_halo_rank(world, specs, train):
    """As unc_ep_rank, owner-sharded: per backbone of `specs` (its
    envelope and partitioner) the halo eval forward (this rank's node and
    edge rows, the per-relation means), the full loss and every gradient
    of a train-mode forward, and two clipped Adam steps with the BN-fed
    biases pinned; then train_unc(ep_mode="halo", ep_partition="bfs") as
    this rank on the HIN `train` gives."""
    t, n, r = train
    model = um.UNCTrainModel(n, r, 8, num_hidden_layers=1, reg_param=0.01,
                             generator=torch.Generator().manual_seed(0))
    embs, coverage = ud.train_unc(model, t, n, r, graph_batch_size=40,
                                  n_epochs=1, sample_depth=2, sample_width=4,
                                  log=print, world=world, ep_mode="halo",
                                  ep_partition="bfs")
    out = {"train_unc": dict(embs=embs, coverage=coverage,
                             state=_numpy(model.state_dict()))}
    for name, spec in specs.items():
        m = unc_model(spec)
        sub = halo_shard(spec["batches"][0], world, spec)
        res = {"fwd": [t.numpy().copy() for t in
                       halo_unc.make_halo_apply(m, world)(sub)]}
        with pd.split_rows(m, world, owner=True):
            o = um.apply_unc_forward(m, sub, train=True)
            loss = m.unsupervised_loss(
                o, sub["edge_type"], sub["edge_mask"], sub["samples"],
                sub["labels"], sub["sample_mask"], sub["node_mask"])
            (loss / world.size).backward()
        pd.all_reduce_grads(m.parameters(), world)
        res["loss"] = loss.item()
        res["grads"] = _numpy({k: p.grad for k, p in m.named_parameters()})

        m = unc_model(spec)
        opt = ud.make_unc_optimizer(m, spec["lr"], spec["total_steps"], 1.0)
        step = halo_unc.make_halo_train_step(m, opt, world)
        res["losses"] = []
        for b, pins in zip(spec["batches"], spec["pins"]):
            res["losses"].append(step(halo_shard(b, world, spec)).item())
            pin(m, pins)
        res["state"] = _numpy(m.state_dict())
        out[name] = res
    return out


# -----------------------------------------------------------------------------
# the demonstration layer and the halo library (tests/test_torch_edge_
# partition.py, tests/test_torch_halo.py)
# -----------------------------------------------------------------------------

def _flat_edges(world, case):
    return edge_partition.shard_flat_edges(
        world, dict(case["arrays"], edge_feat=case["edge_feat"]), "cpu")


def edge_partition_rank(world, fwd, step):
    """The demonstration layer as this rank of `world` (None: the one-rank
    path): the forward of case `fwd` (node rows; this rank's edge rows)
    and the train steps of case `step` (each step's loss, then the layer
    parameters and the relation table after it)."""
    a = _flat_edges(world, fwd)
    h, e = edge_partition.edge_parallel_dmp_apply(
        edge_partition.params_from_jax(fwd["params"], "cpu"),
        torch.from_numpy(fwd["node_feat"]), a["edge_feat"], a["senders"],
        a["receivers"], a["rev_flag"], a["edge_mask"], fwd["V"], world)
    out = {"h": h.numpy(), "e": e.numpy(), "losses": [], "params": [],
           "w_rel": []}
    a = _flat_edges(world, step)
    train = edge_partition.make_edge_parallel_train_step(
        world, step["V"], len(step["params"]), step["lr"])
    p = edge_partition.params_from_jax(step["params"], "cpu")
    w = torch.from_numpy(step["w_rel"])
    x = torch.from_numpy(step["node_feat"])
    samples = torch.from_numpy(step["samples"])
    labels = torch.from_numpy(step["labels"])
    for _ in range(step["steps"]):
        p, w, loss = train(p, w, x, a["edge_feat"], a["senders"],
                           a["receivers"], a["rev_flag"], a["edge_mask"],
                           samples, labels)
        out["losses"].append(loss.item())
        out["params"].append([_numpy(layer) for layer in p])
        out["w_rel"].append(w.numpy().copy())
    return out


def halo_lib_rank(world, cases, bench):
    """Per case of `cases` (a graph, its features, the parameters and a
    partitioner) this rank's halo forward (its owned node rows and edge
    rows, parallel/halo.py) and full-sum forward (the node rows and this
    rank's edge block); then bench/halo_bench.run at `bench`'s sizes."""
    out = {}
    for name, c in cases.items():
        params = edge_partition.params_from_jax(c["params"], "cpu")
        part = halo.build_halo_partition(c["senders"], c["receivers"],
                                         c["rev"], c["V"], world.size,
                                         method=c["method"])
        arrs = halo.shard_halo_arrays(world, part, c["node_feat"],
                                      c["edge_feat"], "cpu")
        h, e = halo.make_halo_dmp_apply(world, len(params))(
            params, *[arrs[k] for k in halo.ARG_ORDER])
        a = _flat_edges(world, c)
        h_full, e_full = edge_partition.edge_parallel_dmp_apply(
            params, torch.from_numpy(c["node_feat"]), a["edge_feat"],
            a["senders"], a["receivers"], a["rev_flag"], a["edge_mask"],
            c["V"], world)
        out[name] = dict(h=h.numpy(), e=e.numpy(), h_full=h_full.numpy(),
                         e_full=e_full.numpy())
    out["bench"] = halo_bench.run(world, **bench)
    return out


# -----------------------------------------------------------------------------
# tests of the process groups themselves
# -----------------------------------------------------------------------------

def _toy_loss(x, w, world):
    """A replicated tanh of edge-sharded partial sums, plus a replicated
    regulariser: (1/2) sum over nodes of tanh(agg @ w)^2 + |w|^2."""
    agg = torch.zeros(4, 3).index_add_(0, x["recv"], x["msg"] @ w)
    agg = pd.all_reduce_sum(agg, world)
    return 0.5 * (torch.tanh(agg) ** 2).sum() + (w ** 2).sum()


def _toy_data():
    rng = np.random.default_rng(0)
    return {"msg": torch.from_numpy(rng.normal(size=(10, 3)).astype(
        np.float32)), "recv": torch.from_numpy(rng.integers(0, 4, 10))}


def toy_rank(world, w0):
    x = _toy_data()
    rows = slice(world.rank * 5, (world.rank + 1) * 5)
    w = torch.nn.Parameter(torch.from_numpy(w0))
    loss = _toy_loss({k: v[rows] for k, v in x.items()}, w, world)
    (loss / world.size).backward()
    pd.all_reduce_grads([w], world)
    return loss.item(), w.grad.numpy().copy()


def _halo_toy_data(size=3, vp=4, h=3, b=2):
    """Rows [size, vp, h], an exchange plan send_idx / send_mask
    [owner, destination, b], gathered-table ids [size, 5] and the toy
    loss's weights, from a seed."""
    rng = np.random.default_rng(5)
    f32 = lambda *shape: rng.normal(size=shape).astype(np.float32)  # noqa
    mask = rng.random((size, size, b)) < 0.7
    mask[np.arange(size), np.arange(size)] = False      # none to itself
    return dict(x=f32(size, vp, h), w=f32(h, h),
                send_idx=rng.integers(0, vp, (size, size, b)),
                send_mask=mask, gidx=rng.integers(0, size * vp, (size, 5)),
                c=f32(size, vp + size * b + 1, h), d=f32(size, 5, h))


def _halo_toy_part(s, x_s, recv, full, w, data):
    """Rank s's part of the toy loss: a tanh of its sender table
    [owned; halo; zero] times weights, and squares of gathered rows."""
    size, _, b = data["send_idx"].shape
    h = x_s.shape[-1]
    table = torch.cat([x_s, recv.reshape(size * b, h), x_s.new_zeros(1, h)])
    c, d = (torch.from_numpy(data[k][s]) for k in ("c", "d"))
    return ((torch.tanh(table @ w) * c).sum()
            + (full[torch.from_numpy(data["gidx"][s])] ** 2 * d).sum())


def halo_toy_rank(world, data):
    """The toy loss over the ranks: rank s holds rows x[s], exchanges its
    boundary rows with halo_exchange and gathers every rank's rows (times
    1.5) with all_gather_rows -> (loss, d loss / d x[s], d loss / d w
    summed over the ranks)."""
    s = world.rank
    x = torch.nn.Parameter(torch.from_numpy(data["x"][s].copy()))
    w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))
    idx = torch.from_numpy(data["send_idx"][s])
    mask = torch.from_numpy(data["send_mask"][s])
    send = torch.where(mask[..., None], x[idx], 0.0)
    recv = pd.halo_exchange(send, world)
    full = pd.all_gather_rows(x * 1.5, world)
    loss = pd.all_reduce_sum(_halo_toy_part(s, x, recv, full, w, data),
                             world)
    (loss / world.size).backward()
    pd.all_reduce_grads([w], world)
    return loss.item(), x.grad.numpy().copy(), w.grad.numpy().copy()


# -----------------------------------------------------------------------------
# the examples (tests/test_torch_examples.py)
# -----------------------------------------------------------------------------

def examples_rank(world, state_dict, ep_params):
    """This rank's part of the three examples that run over ranks: the
    data-parallel step (on `state_dict`), the edge-partitioned forward
    (on the JAX package's `ep_params`) and the owner-sharded train_unc."""
    return {"dp": multichip_dp.dp_step(world, state_dict=state_dict),
            "ep": edge_parallel.ep_forward(world, ep_params),
            "halo": performance_levers.unc_train(world)}


def hang_rank(world, seconds):
    if world.rank == 1:
        import time
        time.sleep(seconds)
    pd.dist.barrier()


def fail_rank(world):
    if world.rank == 1:
        raise ValueError("rank 1 fails on purpose")
    pd.dist.barrier()


def test_sum_over_ranks_has_the_true_adjoint(tmp_path):
    """Two gloo ranks, each with half of the edges: the loss and the
    gradient equal one process's over all edges."""
    w0 = np.random.default_rng(1).normal(size=(3, 3)).astype(np.float32)
    w = torch.nn.Parameter(torch.from_numpy(w0.copy()))
    want = _toy_loss(_toy_data(), w, None)
    want.backward()
    got = run_ranks(toy_rank, tmp_path, w0)
    for loss, grad in got:
        np.testing.assert_allclose(loss, want.item(), rtol=1e-6)
        np.testing.assert_allclose(grad, w.grad.numpy(), rtol=0,
                                   atol=1e-6 * float(w.grad.abs().max()))
    np.testing.assert_array_equal(got[0][1], got[1][1])


def test_halo_collectives_have_their_true_adjoints(tmp_path):
    """Three gloo ranks (two would hide a routing error: every block
    would go to "the other" rank): the exchange delivers rank o's
    send[s] to rank s as its block o, the gathered table is every rank's
    rows in rank order, and the backwards of both (the same exchange of
    the cotangent; its reduce-scatter) give one process's gradients of
    the same loss, computed by plain indexing."""
    data = _halo_toy_data()
    size = data["x"].shape[0]
    x = torch.nn.Parameter(torch.from_numpy(data["x"].copy()))
    w = torch.nn.Parameter(torch.from_numpy(data["w"].copy()))
    idx, mask = (torch.from_numpy(data[k]) for k in ("send_idx",
                                                      "send_mask"))
    full = (x * 1.5).reshape(-1, x.shape[-1])
    want = 0.0
    for s in range(size):
        # rank s receives from each owner o the rows o sends it
        recv = torch.stack([torch.where(mask[o, s][:, None],
                                        x[o][idx[o, s]], 0.0)
                            for o in range(size)])
        want = want + _halo_toy_part(s, x[s], recv, full, w, data)
    want.backward()
    got = run_ranks(halo_toy_rank, tmp_path, data, size=size)
    gx = x.grad.numpy()
    for s, (loss, gxs, gw) in enumerate(got):
        np.testing.assert_allclose(loss, want.item(), rtol=1e-6)
        np.testing.assert_allclose(gxs, gx[s], rtol=0,
                                   atol=1e-6 * float(np.abs(gx).max()))
        np.testing.assert_allclose(gw, w.grad.numpy(), rtol=0,
                                   atol=1e-6 * float(w.grad.abs().max()))


@pytest.mark.parametrize("fn, args, error, timeout", [
    (hang_rank, (120.0,), TimeoutError, 12.0),
    (fail_rank, (), RuntimeError, RUN_TIMEOUT),
], ids=["hang", "fail"])
def test_launcher_fails_fast_and_stops_every_rank(tmp_path, fn, args,
                                                  error, timeout):
    """A rank that hangs ends the run at the launcher's timeout, one that
    raises at once with its traceback; no rank outlives the call."""
    import multiprocessing
    import time
    t0 = time.monotonic()
    with pytest.raises(error) as info:
        run_ranks(fn, tmp_path, *args, timeout=timeout)
    if fn is hang_rank:
        assert time.monotonic() - t0 < timeout + 30.0
    else:
        assert "rank 1 fails on purpose" in str(info.value)
    assert not (tmp_path / f"rdv_{fn.__name__}").exists()
    assert not multiprocessing.active_children()


def test_launcher_refuses_a_used_rendezvous_file(tmp_path):
    (tmp_path / "rdv_toy_rank").write_text("")
    with pytest.raises(ValueError, match="exists"):
        run_ranks(toy_rank, tmp_path, np.eye(3, dtype=np.float32))
    with pytest.raises(ValueError, match="devices"):
        pd.launch(toy_rank, 2, backend="gloo", devices=["cpu"],
                  init_file=str(tmp_path / "other"))


def test_shard_rows_follows_the_jax_steps_microbatches():
    world = [pd.World(r, 2, torch.device("cpu"), "gloo") for r in range(2)]
    np.testing.assert_array_equal(dp.shard_rows(8, world[0]), [0, 1, 2, 3])
    np.testing.assert_array_equal(dp.shard_rows(8, world[1]), [4, 5, 6, 7])
    # two microbatches of 4: rank r holds its half of each
    np.testing.assert_array_equal(dp.shard_rows(8, world[0], 2),
                                  [0, 1, 4, 5])
    np.testing.assert_array_equal(dp.shard_rows(8, world[1], 2),
                                  [2, 3, 6, 7])
    assert dp.shard_rows(7, world[0]) is None         # ragged: whole batch
    assert dp.shard_rows(6, world[0], 2) is None
    x = torch.arange(8)
    assert dp.shard_batch(world[1], x).tolist() == [4, 5, 6, 7]
    with pytest.raises(ValueError):
        dp.shard_batch(world[0], torch.arange(7))


def test_split_rows_sets_and_restores_row_world():
    from dualmessagepassing_tpu_torch.models.layers import MaskedBatchNorm
    m = torch.nn.Sequential(MaskedBatchNorm(3), torch.nn.Linear(3, 3),
                            MaskedBatchNorm(3))
    w = pd.World(0, 1, torch.device("cpu"), "gloo")
    with pd.split_rows(m, w):
        assert [x.row_world for x in (m[0], m[2])] == [w, w]
    assert m[0].row_world is None and m[2].row_world is None
    assert not hasattr(m[1], "row_world")


def test_ep_shards_and_plans_cover_the_subgraph():
    """shard_sub gives each rank e_max / size rows: an even share of the
    real edges in order, then pads; together the shares hold every real
    edge once and every pad row once. Each share's plans name its real
    edges once, by receiver and by sender. An envelope that does not
    divide is refused, as in the JAX package; so is a mask that is not a
    prefix."""
    from test_torch_unc_data import tiny_hin
    from dualmessagepassing_tpu_torch.unc.data import WholeGraph
    t, n, r = tiny_hin(seed=3, n=60, e=240)
    g = WholeGraph(n, r, t)
    e_max = ep_unc.pad_e_max(g.num_edges, 3)
    padded = ud.sample_batch(g, t[:40], "randomwalk", 2, 4, 0.5, 2, n,
                             e_max, 120, np.random.default_rng(0))
    n_real = int(padded["edge_mask"].sum())
    assert 0 < n_real < e_max // 3
    worlds = [pd.World(k, 3, torch.device("cpu"), "gloo") for k in range(3)]
    shards = [ep_unc.attach_ep_csr_plans(ep_unc.shard_sub(padded, w),
                                         sender_plan=True) for w in worlds]
    counts = [s["n_real"] for s in shards]
    assert sum(counts) == n_real and max(counts) - min(counts) <= 1
    for key in ep_unc.EDGE_KEYS:
        assert all(len(s[key]) == e_max // 3 for s in shards)
        np.testing.assert_array_equal(
            np.concatenate([s[key][:s["n_real"]] for s in shards]),
            padded[key][:n_real])
        np.testing.assert_array_equal(
            np.concatenate([s[key][s["n_real"]:] for s in shards]),
            padded[key][n_real:])
    for s in shards:
        assert s["edge_mask"][:s["n_real"]].all()
        assert not s["edge_mask"][s["n_real"]:].any()
        np.testing.assert_array_equal(
            np.diff(s["sk_rowptr"]),
            np.bincount(s["receivers"][:s["n_real"]], minlength=n))
        send = s["senders"][s["sk2_order"]]
        assert (np.diff(send) >= 0).all()
        assert sorted(s["sk2_order"].tolist()) == list(range(s["n_real"]))
    odd = {k: (v[:-1] if k in ep_unc.EDGE_KEYS else v)
           for k, v in padded.items()}
    with pytest.raises(ValueError, match="pad_e_max"):
        ep_unc.shard_sub(odd, worlds[0])
    holes = dict(padded, edge_mask=np.roll(padded["edge_mask"], 1))
    with pytest.raises(ValueError, match="prefix"):
        ep_unc.shard_sub(holes, worlds[0])


def test_launch_plan_lets_gloo_ranks_share_a_card(monkeypatch):
    """The command lines' plan: gloo on the CPU; NCCL one card a rank,
    refused past the visible cards; backend gloo on CUDA puts the ranks
    round-robin on the cards, two on one card."""
    assert pd.launch_plan(2, "cpu") == ("gloo", ["cpu", "cpu"])
    with pytest.raises(ValueError):
        pd.launch_plan(2, "cpu", "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pd.launch_plan(1, "cuda") == ("nccl", ["cuda:0"])
    with pytest.raises(ValueError):
        pd.launch_plan(2, "cuda")
    assert pd.launch_plan(2, "cuda", "gloo") == ("gloo",
                                                 ["cuda:0", "cuda:0"])
