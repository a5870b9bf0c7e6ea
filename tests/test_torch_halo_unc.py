"""Owner-sharded (halo) UNC training of the port (parallel/halo_unc.py,
the owner_rows paths of unc/model.py, parallel/dist.halo_exchange and
all_gather_rows, unc/driver.train_unc(world=..., ep_mode="halo")) over
two gloo ranks on the CPU, against the JAX package's make_halo_apply and
make_halo_train_step on a 2-device 'ep' mesh of conftest's virtual CPU
devices (tests/test_halo_unc.py) and against the port's one-rank step:
the same padded subgraphs, the same flax weights (drawn from the seed in
the variable tree's shapes), dropout off, for DMPNN, CompGCN, R-GCN and
R-GIN, each under one of the three partitioners. The partition arrays,
the envelope checks and the synthetic generators against the JAX
package's, array for array.

One spawn (tests/test_torch_dist.unc_halo_rank) computes what the
comparisons read; JAX runs in the pytest process only.

Tolerances (those of tests/test_torch_ep_unc.py): the forward 1e-5 abs
and rel on the valid rows (a rank's owned rows, its real edges); the
loss rtol 1e-6 and the gradients rtol 1e-4, atol 1e-6 (float32 in
another order); two steps of the clipped Adam: losses rtol 1e-5,
parameters and running statistics rtol 1e-4 plus atol 1e-3 * lr per
step, DMPNN's BatchNorm-fed biases pinned after each step to the JAX
step's values (their gradient is rounding noise, which Adam turns into
steps of ~lr on each side its own). Against the one-rank step the
running variances need no tolerance of their own now: the ranks own
disjoint node rows (and edges), so the count in the unbiased factor is
the one-device count, and they are held at the parameters' tolerance.
The ranks' parameters are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dualmessagepassing_tpu.data import synthetic as jsyn
from dualmessagepassing_tpu.parallel import halo_unc as jhalo
from dualmessagepassing_tpu.unc import data as jdata
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu_torch.data import synthetic as tsyn
from dualmessagepassing_tpu_torch.parallel import halo_unc as thalo
from dualmessagepassing_tpu_torch.parallel.dist import World, split_rows
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import model as tm

from test_torch_dist import run_ranks, unc_halo_rank
from test_torch_ep_unc import (BN_FED, F32_TOL, H, LAYERS, LR, REG, STEPS,
                               _batches, _draw, _numpy_tree, _one_rank,
                               _recorded, _valid)
from test_torch_unc_data import tiny_hin

# backbone -> the partitioner its run uses (each partitioner runs a model)
CASES = {"DMPNN": "degree", "CompGCN": "bfs", "RGCN": "range",
         "RGIN": "degree"}
BACKBONES = tuple(CASES)


def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("ep",))


def _envelope(padded):
    return jhalo.halo_envelope(len(padded["nid"]), len(padded["senders"]),
                               2)


def _jax_case(backbone, seed):
    batches, n, r = _batches(STEPS, seed)
    method = CASES[backbone]
    envelope = _envelope(batches[0])
    kw = dict(num_nodes=n, num_rels=r, h_dim=H, nlabel=0,
              num_hidden_layers=LAYERS, dropout=0.0, reg_param=REG,
              backbone=backbone)
    sub = {k: jnp.asarray(v) for k, v in batches[0].items()}
    shapes = jax.eval_shape(lambda s: jm.init_unc_variables(
        jm.UNCTrainModel(**kw), jax.random.PRNGKey(0), s), sub)
    rng = np.random.default_rng(seed)
    params = _draw(shapes["params"], rng)
    stats = _draw(shapes.get("batch_stats", {}), rng)
    halo_model = jhalo.make_halo_model(**kw)
    mesh = mesh2()
    vs = {"params": params, **({"batch_stats": stats} if stats else {})}

    def dev(b):
        d, meta = jhalo.build_halo_sub(b, 2, *envelope, method=method)
        return jhalo.shard_halo_sub(mesh, d), meta

    with mesh:
        d0, meta0 = dev(batches[0])
        fwd, _ = jhalo.make_halo_apply(halo_model, mesh)(vs, d0)

    tx = _recorded(jdrv.make_unc_optimizer(LR, 5, 1.0))
    step = jhalo.make_halo_train_step(halo_model, tx, mesh)
    p, o, s = params, tx.init(params), stats
    losses, pins, grads = [], [], []
    for b in batches:
        with mesh:
            p, o, s, jl = step(p, o, s, dev(b)[0], jax.random.PRNGKey(0))
        losses.append(float(jl))
        grads.append(tm.params_from_flax(_numpy_tree(o[0])))
        pins.append({k: v.numpy() for k, v in tm.params_from_flax(
            _numpy_tree(p)).items() if k.endswith(BN_FED)})
    spec = dict(n=n, r=r, h=H, layers=LAYERS, reg=REG, backbone=backbone,
                params=_numpy_tree(params), stats=_numpy_tree(stats),
                batches=batches, pins=pins, lr=LR, total_steps=5,
                envelope=envelope, method=method)
    want = dict(fwd=[np.asarray(x) for x in fwd], loss=losses[0],
                grads=grads[0], losses=losses, meta=meta0,
                state=tm.params_from_flax(_numpy_tree(p), _numpy_tree(s)))
    return spec, want


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs, want = {}, {}
    for i, b in enumerate(BACKBONES):
        specs[b], want[b] = _jax_case(b, seed=31 + i)
    ranks = run_ranks(unc_halo_rank, tmp_path_factory.mktemp("halo"), specs,
                      tiny_hin(seed=2, n=40, e=80))
    return dict(specs=specs, want=want, ranks=ranks)


def _assert_same_partition(padded, n_shards, envelope, method):
    """build_halo_sub's arrays and inverse maps equal the JAX package's
    -> the port's (dev, meta)."""
    dj, mj = jhalo.build_halo_sub(padded, n_shards, *envelope, method=method)
    dt, mt = thalo.build_halo_sub(padded, n_shards, *envelope, method=method)
    assert set(dt) == set(dj)
    assert set(thalo.SHARD_KEYS) == {k for k in jhalo.SHARD_KEYS
                                     if not k.startswith(("sk", "sb"))
                                     and k != "send_order"}
    for k in dj:
        np.testing.assert_array_equal(dt[k], dj[k], err_msg=k)
        assert dt[k].dtype == dj[k].dtype, k
    for k in ("owner", "rank", "owned_slice", "packed"):
        np.testing.assert_array_equal(mt[k], mj[k], err_msg=k)
    assert [list(e) for e in mt["edge_perm"]] == \
        [list(e) for e in mj["edge_perm"]]
    assert (mt["vp"], mt["ep"], mt["b"]) == (mj["vp"], mj["ep"], mj["b"])
    return dt, mt


def _cliques():
    """tests/test_halo_unc.py:360-402's ring of 8 six-node cliques with
    one bridge edge between neighbours, sampled and padded."""
    n_cliq, cs = 8, 6
    n = n_cliq * cs
    srcs, dsts = [], []
    for c in range(n_cliq):
        base = c * cs
        for i in range(cs):
            for j in range(cs):
                if i != j:
                    srcs.append(base + i)
                    dsts.append(base + j)
        srcs.append(base)
        dsts.append(((c + 1) % n_cliq) * cs)
    t = np.stack([np.asarray(srcs), np.zeros(len(srcs), np.int64),
                  np.asarray(dsts)], 1).astype(np.int64)
    g = jdata.WholeGraph(n, 1, t)
    sub = jdata.sample_subgraph_by_randomwalks(
        g, np.arange(n), depth=2, width=6, rng=np.random.default_rng(0))
    samples = t[:4].copy()
    lut = {int(v): i for i, v in enumerate(sub["nid"])}
    samples[:, 0] = [lut.get(int(x), 0) for x in samples[:, 0]]
    samples[:, 2] = [lut.get(int(x), 0) for x in samples[:, 2]]
    return jdata.pad_subgraph(sub, samples, np.ones(4, np.float32), n,
                              len(sub["senders"]) + 8, 8,
                              edge_norm=jdata.compute_edgenorm(sub))


@pytest.mark.parametrize("method", ["degree", "range", "bfs"])
def test_build_halo_sub_matches_jax(method):
    """Owners, ranks, owned slices, local senders (the pads at the dump
    row Vp + n * B) and receivers (the pad tail repeating the last real
    one), send_idx / send_mask, out_deg, packed samples and edge_perm
    equal the JAX package's, on a training batch at 2 ranks and on the
    clique ring at 8; each rank's plans name its real edges once."""
    (padded,), _, _ = _batches(1, seed=7)
    dev, meta = _assert_same_partition(padded, 2, _envelope(padded), method)
    # a 1,000-node batch at 3 ranks: bfs claims up to Vp // 16 = 20 nodes
    # a round, with frontiers both above and below that
    t, n, r = tiny_hin(seed=9, n=1000, e=6000, r=2)
    big = jdrv.sample_batch(jdata.WholeGraph(n, r, t), t[:400],
                            "randomwalk", 2, 4, 0.5, 1, n, 2 * len(t) + 2,
                            800, np.random.default_rng(9))
    _assert_same_partition(big, 3, jhalo.halo_envelope(
        n, len(big["senders"]), 3), method)
    cl = _cliques()
    _assert_same_partition(cl, 8, jhalo.halo_envelope(
        len(cl["nid"]), len(cl["senders"]), 8), method)
    vp, ep, b = _envelope(padded)
    vt = vp + 2 * b + 1
    for s in range(2):
        sh = thalo.attach_halo_csr_plans(thalo.rank_sub(dev, s),
                                         sender_plan=True)
        k = sh["n_real"]
        assert k == len(meta["edge_perm"][s])
        assert (sh["senders"][k:] == vp + 2 * b).all()
        assert (np.diff(sh["receivers"]) >= 0).all()
        np.testing.assert_array_equal(
            np.diff(sh["sk_rowptr"]), np.bincount(sh["receivers"][:k],
                                                  minlength=vp))
        assert len(sh["skt_rowptr"]) == vt + 1
        np.testing.assert_array_equal(
            sh["send_rows"], sh["send_idx"].reshape(-1)[sh["send_pos"]])
        assert sh["send_mask"].reshape(-1)[sh["send_pos"]].all()
        assert len(sh["send_pos"]) == sh["send_mask"].sum()
        assert (sh["skt_rowptr"][vp:] == k).all()
        send = sh["senders"][sh["sk2_order"]]
        assert (np.diff(send) >= 0).all() and len(send) == k
        np.testing.assert_array_equal(
            np.diff(sh["sk2_rowptr"]), np.bincount(send, minlength=vt))


def test_bfs_needs_fewer_boundary_rows_on_the_cliques():
    cl = _cliques()
    env = jhalo.halo_envelope(len(cl["nid"]), len(cl["senders"]), 8)
    rows = {m: int(thalo.build_halo_sub(cl, 8, *env, method=m)[0][
        "send_mask"].sum()) for m in ("bfs", "degree")}
    assert rows["bfs"] < rows["degree"], rows


@pytest.mark.parametrize("what", ["vp", "ep", "b"])
def test_envelope_overflow_raises_as_in_jax(what):
    (padded,), _, _ = _batches(1, seed=7)
    vp, ep, b = _envelope(padded)
    env = {"vp": (vp // 2, ep, b), "ep": (vp, 8, b), "b": (vp, ep, 1)}[what]
    match = {"vp": "envelope vp", "ep": "envelope ep", "b": "envelope b"}
    for build in (jhalo.build_halo_sub, thalo.build_halo_sub):
        with pytest.raises(ValueError, match=match[what]):
            build(padded, 2, *env)
    for args in ((1000, 5000, 3), (10, 50, 2), (63109, 489972, 2)):
        assert thalo.halo_envelope(*args) == jhalo.halo_envelope(*args)


def test_synthetic_generators_match_jax():
    for power_law in (True, False):
        a, na = tsyn.generate_large_graph(500, 3000, 4, seed=3,
                                          power_law=power_law)
        b, nb = jsyn.generate_large_graph(500, 3000, 4, seed=3,
                                          power_law=power_law)
        np.testing.assert_array_equal(a, b)
        assert na == nb == 500 and a.dtype == b.dtype
    a, _ = tsyn.generate_community_graph(400, 2000, 5, 0.9, 3, seed=4)
    b, _ = jsyn.generate_community_graph(400, 2000, 5, 0.9, 3, seed=4)
    np.testing.assert_array_equal(a, b)


def test_supervised_head_under_owner_sharding_raises():
    """As the JAX model's setup does (unc/model.py:1051-1059)."""
    m = tm.UNCTrainModel(20, 2, 8, nlabel=3)
    world = World(0, 2, torch.device("cpu"), "gloo")
    with pytest.raises(NotImplementedError, match="packed"):
        with split_rows(m, world, owner=True):
            m({})
    with pytest.raises(NotImplementedError, match="packed"):
        jm.UNCTrainModel(num_nodes=20, num_rels=2, h_dim=8, nlabel=3,
                         ep_axis="ep", node_sharding="owner").init(
            jax.random.PRNGKey(0), {})


@pytest.mark.parametrize("backbone", BACKBONES)
def test_halo_forward_matches_the_jax_halo_apply(runs, backbone):
    """Each rank's owned node rows, its real edge rows and the
    per-relation means against the JAX package's shard of them."""
    spec, want = runs["specs"][backbone], runs["want"][backbone]
    meta = want["meta"]
    for rank, r in enumerate(runs["ranks"]):
        got = r[backbone]["fwd"]
        assert len(got) == len(want["fwd"])
        owned = meta["owned_slice"][rank]
        rows = (owned >= 0) & spec["batches"][0]["node_mask"][
            np.maximum(owned, 0)]
        np.testing.assert_allclose(_valid(got[0], rows),
                                   _valid(want["fwd"][0][rank], rows),
                                   atol=1e-5, rtol=1e-5)
        if len(got) > 1:
            k = len(meta["edge_perm"][rank])
            np.testing.assert_allclose(got[1][:k], want["fwd"][1][rank][:k],
                                       atol=1e-5, rtol=1e-5)
        if len(got) > 2:
            np.testing.assert_allclose(got[2], want["fwd"][2], atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_halo_loss_and_gradients_match_the_jax_halo_step(runs, backbone):
    """The full loss (DistMult BCE over the gathered rows and the three
    regularisers, BatchNorm on in train mode) and every parameter
    gradient, summed over the ranks, against the JAX halo step's raw
    gradient on the first batch."""
    want = runs["want"][backbone]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[backbone]["loss"], want["loss"],
                                   rtol=1e-6)
        assert set(r[backbone]["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(r[backbone]["grads"][k], g.numpy(),
                                       err_msg=k, **F32_TOL)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_two_halo_adam_steps_match_jax_and_the_one_rank_step(runs, backbone):
    """Two clipped Adam steps: the losses and every parameter and running
    statistic against the JAX halo step's and the port's one-rank
    step's, the ranks bit for bit equal; the ranks' node rows, mapped
    back (unshard_halo_nodes), against the one-rank forward."""
    spec, want = runs["specs"][backbone], runs["want"][backbone]
    a, b = (r[backbone] for r in runs["ranks"])
    fwd1, losses1, state1 = _one_rank(spec)
    np.testing.assert_allclose(a["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(a["losses"], losses1, rtol=1e-5)
    tol = dict(rtol=1e-4, atol=1e-3 * LR * STEPS)
    for k, w in want["state"].items():
        np.testing.assert_allclose(a["state"][k], w.numpy(), err_msg=k, **tol)
        np.testing.assert_allclose(a["state"][k], state1[k], err_msg=k,
                                   **tol)
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    node_mask = spec["batches"][0]["node_mask"]
    h = thalo.unshard_halo_nodes(
        want["meta"], np.stack([r[backbone]["fwd"][0]
                                for r in runs["ranks"]]))
    np.testing.assert_allclose(_valid(h, node_mask),
                               _valid(fwd1[0], node_mask), atol=1e-5,
                               rtol=1e-5)
    if len(fwd1) > 1:
        e_mask = spec["batches"][0]["edge_mask"]
        z = thalo.unshard_halo_edges(
            want["meta"], np.stack([r[backbone]["fwd"][1]
                                    for r in runs["ranks"]]), len(e_mask))
        np.testing.assert_allclose(_valid(z, e_mask), _valid(fwd1[1], e_mask),
                                   atol=1e-5, rtol=1e-5)


def test_train_unc_owner_sharded_on_two_ranks_end_to_end(runs):
    """train_unc(world=..., ep_mode="halo", ep_partition="bfs") as each of
    two ranks (the command line's --ep_devices 2 --ep_mode halo spawns
    the same): one tiny epoch and the owner-sharded export, every node's
    row finite, the ranks' parameters and tables equal."""
    a, b = (r["train_unc"] for r in runs["ranks"])
    assert a["embs"].shape == (40, 8) and np.isfinite(a["embs"]).all()
    assert a["coverage"] > 0.9
    np.testing.assert_array_equal(a["embs"], b["embs"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)


def test_halo_rank_shard_is_the_ranks_slice():
    """halo_rank_shard = build_halo_sub + rank_sub + the plans, and the
    export's unshard puts every owned row back (tdrv's _rank_batch)."""
    (padded,), _, _ = _batches(1, seed=8)
    env = _envelope(padded)
    dev, meta = thalo.build_halo_sub(padded, 2, *env, method="bfs")
    for r in range(2):
        got, m = tdrv._rank_batch(padded, World(r, 2, torch.device("cpu"),
                                                "gloo"), (env, "bfs"))
        assert m["vp"] == env[0]
        for k in thalo.SHARD_KEYS:
            np.testing.assert_array_equal(got[k], dev[k][r], err_msg=k)
    rows = np.arange(2 * env[0], dtype=np.float32).reshape(2, env[0], 1)
    back = thalo.unshard_halo_nodes(meta, rows)[:, 0]
    np.testing.assert_array_equal(
        back, meta["owner"] * env[0] + meta["rank"])
