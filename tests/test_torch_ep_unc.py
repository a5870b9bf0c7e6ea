"""Edge-partitioned UNC training of the port (parallel/ep_unc.py, the
row_world sums of unc/model.py, unc/driver.train_unc(world=...),
cli/unc_train.py --ep_devices) over two gloo ranks on the CPU, against
the JAX package's make_ep_apply and make_ep_train_step on a 2-device
'ep' mesh of conftest's virtual CPU devices (tests/test_ep_unc.py:62-193)
and against the port's one-rank step: the same padded subgraphs, the
same flax weights (drawn from the seed in the variable tree's shapes, so
biases, BatchNorm affine terms and running statistics carry signal),
dropout off, for DMPNN, CompGCN, R-GCN and R-GIN.

One spawn (tests/test_torch_dist.unc_ep_rank) computes what the
comparisons read; JAX runs in the pytest process only.

Tolerances (those of tests/test_ep_unc.py and tests/test_torch_unc_train
.py): the forward 1e-5 abs and rel on valid rows (K2 zeroes the pad
edges' rows, which every real output masks); the loss rtol 1e-6 and the
gradients rtol 1e-4, atol 1e-6 (float32 in another order); two steps of
the clipped Adam: losses rtol 1e-5, parameters and running statistics
rtol 1e-4 plus atol 1e-3 * lr per step, DMPNN's BatchNorm-fed biases
pinned after each step to the JAX step's values (their gradient is
rounding noise, which Adam turns into steps of ~lr on each side its
own); against the one-rank step the running variances rtol 2e-3, atol
1e-4, as tests/test_ep_unc.py holds them against one device (the rows
every rank holds count once per rank in the unbiased factor, as in the
JAX package's EP step). The ranks' parameters are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dualmessagepassing_tpu.parallel import ep_unc as jep
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu.unc.data import WholeGraph
from dualmessagepassing_tpu_torch.ops import segment_kernel as tsk
from dualmessagepassing_tpu_torch.parallel import ep_unc as tep
from dualmessagepassing_tpu_torch.parallel.dist import World
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import model as tm

from test_torch_dist import pin, run_ranks, unc_ep_rank, unc_model
from test_torch_unc_data import tiny_hin

H, LAYERS, REG, LR, STEPS = 16, 2, 1e-2, 1e-2, 2
BACKBONES = ("DMPNN", "CompGCN", "RGCN", "RGIN")
BN_FED = ("nbias", "ebias", "nmlp.fc0_bias", "emlp.fc0_bias")
F32_TOL = dict(rtol=1e-4, atol=1e-6)


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("ep",))


def _batches(n_batches, seed):
    """Padded training subgraphs of a ~120-node HIN, the edge envelope a
    multiple of 2 (pad_e_max), without the global sender sort (as the
    JAX package's train_unc samples sharded batches)."""
    t, n, r = tiny_hin(seed=seed, n=120, e=480, r=2)
    g = WholeGraph(n, r, t)
    e_max = jep.pad_e_max(g.num_edges, 2) + 2          # pads on both ranks
    rng = np.random.default_rng(seed)
    return [jdrv.sample_batch(g, t[i * 60: (i + 1) * 60], "randomwalk", 3, 4,
                              0.5, 3, n, e_max, 240, rng, send_keys=False)
            for i in range(n_batches)], n, r


def _draw(tree, rng):
    """N(0, 0.3) weights of the tree's shapes; BatchNorm running
    variances 0.5-1.5."""
    def f(path, x):
        if path[-1].key == "var":
            return jnp.asarray(rng.uniform(0.5, 1.5, x.shape), jnp.float32)
        return jnp.asarray(rng.normal(0, 0.3, x.shape), jnp.float32)
    return jax.tree_util.tree_map_with_path(f, tree)


def _recorded(tx):
    """tx after a transformation that keeps each step's raw gradient in
    the optimizer state (so one compiled JAX step gives the gradient)."""
    import optax

    def init(params):
        return jax.tree.map(jnp.zeros_like, params)

    def update(grads, state, params=None):
        return grads, grads

    return optax.chain(optax.GradientTransformation(init, update), tx)


def _jax_case(backbone, seed):
    batches, n, r = _batches(STEPS, seed)
    kw = dict(num_nodes=n, num_rels=r, h_dim=H, nlabel=0,
              num_hidden_layers=LAYERS, dropout=0.0, reg_param=REG,
              backbone=backbone)
    sub = {k: jnp.asarray(v) for k, v in batches[0].items()}
    # the variable tree's shapes (no compiled init), drawn from the seed
    shapes = jax.eval_shape(lambda s: jm.init_unc_variables(
        jm.UNCTrainModel(**kw), jax.random.PRNGKey(0), s), sub)
    rng = np.random.default_rng(seed)
    params = _draw(shapes["params"], rng)
    stats = _draw(shapes.get("batch_stats", {}), rng)
    ep_model = jm.UNCTrainModel(ep_axis="ep", **kw)
    mesh = mesh2()
    vs = {"params": params, **({"batch_stats": stats} if stats else {})}
    with mesh:
        fwd, _ = jep.make_ep_apply(ep_model, mesh)(
            vs, jep.shard_sub(mesh, batches[0]))

    tx = _recorded(jdrv.make_unc_optimizer(LR, 5, 1.0))
    step = jep.make_ep_train_step(ep_model, tx, mesh)
    p, o, s = params, tx.init(params), stats
    losses, pins, grads = [], [], []
    for b in batches:
        with mesh:
            p, o, s, jl = step(p, o, s, jep.shard_sub(mesh, b),
                               jax.random.PRNGKey(0))
        losses.append(float(jl))
        grads.append(tm.params_from_flax(_numpy_tree(o[0])))
        pins.append({k: v.numpy() for k, v in tm.params_from_flax(
            _numpy_tree(p)).items() if k.endswith(BN_FED)})
    spec = dict(n=n, r=r, h=H, layers=LAYERS, reg=REG, backbone=backbone,
                params=_numpy_tree(params), stats=_numpy_tree(stats),
                batches=batches, pins=pins, lr=LR, total_steps=5)
    want = dict(fwd=[np.asarray(x) for x in fwd], loss=losses[0],
                grads=grads[0], losses=losses,
                state=tm.params_from_flax(_numpy_tree(p), _numpy_tree(s)))
    return spec, want


def _one_rank(spec):
    """The port's one-device forward, loss and gradients, and its two
    optimizer steps with the same pins."""
    m = unc_model(spec)
    sub = tdrv.to_device(tsk.attach_csr_plan(spec["batches"][0]), "cpu")
    with torch.no_grad():
        fwd = [x.numpy() for x in tm.apply_unc_forward(m, sub)]
    m = unc_model(spec)
    opt = tdrv.make_unc_optimizer(m, LR, spec["total_steps"], 1.0)
    step = tdrv.make_unc_train_step(m, opt)
    losses = []
    for b, pins in zip(spec["batches"], spec["pins"]):
        b = dict(b)
        n_real = int(b["edge_mask"].sum())
        b["send_order"] = np.argsort(b["senders"][:n_real], kind="stable")
        losses.append(step(tdrv.to_device(
            tsk.attach_csr_plan(b, sender_plan=True), "cpu")).item())
        pin(m, pins)
    return fwd, losses, {k: v.numpy() for k, v in m.state_dict().items()}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    specs, want = {}, {}
    for i, b in enumerate(BACKBONES):
        specs[b], want[b] = _jax_case(b, seed=11 + i)
    ranks = run_ranks(unc_ep_rank, tmp_path_factory.mktemp("ep"), specs,
                      tiny_hin(seed=2, n=40, e=80))
    return dict(specs=specs, want=want, ranks=ranks)


def _valid(x, mask):
    return np.asarray(x)[np.asarray(mask)]


@pytest.mark.parametrize("backbone", BACKBONES)
def test_ep_forward_matches_the_jax_ep_apply(runs, backbone):
    """Node rows and per-relation means whole on each rank, each rank's
    real edge rows its share of the JAX package's edge stream."""
    spec, want = runs["specs"][backbone], runs["want"][backbone]
    padded = spec["batches"][0]
    node_mask = padded["node_mask"]
    n_real = int(padded["edge_mask"].sum())
    lo = 0
    for rank, r in enumerate(runs["ranks"]):
        got = r[backbone]["fwd"]
        assert len(got) == len(want["fwd"])
        np.testing.assert_allclose(_valid(got[0], node_mask),
                                   _valid(want["fwd"][0], node_mask),
                                   atol=1e-5, rtol=1e-5)
        if len(got) > 1:
            # the rank's real edges are the next run of the stream's
            mine = min(-(-n_real // 2), n_real - lo)
            np.testing.assert_allclose(got[1][:mine],
                                       want["fwd"][1][lo: lo + mine],
                                       atol=1e-5, rtol=1e-5)
            lo += mine
        if len(got) > 2:
            np.testing.assert_allclose(got[2], want["fwd"][2], atol=1e-5,
                                       rtol=1e-5)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_ep_loss_and_gradients_match_the_jax_ep_step(runs, backbone):
    """The full loss (DistMult BCE and the three regularisers, BatchNorm
    on in train mode) and every parameter gradient, summed over the
    ranks, against the JAX EP step's on the first batch (its raw
    gradient, kept by a pass-through transformation before the clip)."""
    want = runs["want"][backbone]
    for r in runs["ranks"]:
        np.testing.assert_allclose(r[backbone]["loss"], want["loss"],
                                   rtol=1e-6)
        assert set(r[backbone]["grads"]) == set(want["grads"])
        for k, g in want["grads"].items():
            np.testing.assert_allclose(r[backbone]["grads"][k], g.numpy(),
                                       err_msg=k, **F32_TOL)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_two_ep_adam_steps_match_jax_and_the_one_rank_step(runs, backbone):
    """Two clipped Adam steps: the losses and every parameter and running
    statistic against the JAX EP step's and the port's one-rank step's,
    the ranks bit for bit equal."""
    spec, want = runs["specs"][backbone], runs["want"][backbone]
    a, b = (r[backbone] for r in runs["ranks"])
    fwd1, losses1, state1 = _one_rank(spec)
    np.testing.assert_allclose(a["losses"], want["losses"], rtol=1e-5)
    np.testing.assert_allclose(a["losses"], losses1, rtol=1e-5)
    tol = dict(rtol=1e-4, atol=1e-3 * LR * STEPS)
    for k, w in want["state"].items():
        np.testing.assert_allclose(a["state"][k], w.numpy(), err_msg=k, **tol)
        # the node rows' running variance: each rank counts the rows it
        # holds alike, so the unbiased factor is that of size x count, as
        # in the JAX package's EP step; held as tests/test_ep_unc.py
        # holds the statistics against one device
        np.testing.assert_allclose(
            a["state"][k], state1[k], err_msg=k,
            **(dict(rtol=2e-3, atol=1e-4) if k.endswith("running_var")
               else tol))
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
    node_mask = spec["batches"][0]["node_mask"]
    np.testing.assert_allclose(_valid(a["fwd"][0], node_mask),
                               _valid(fwd1[0], node_mask), atol=1e-5,
                               rtol=1e-5)


def test_envelope_refusal_matches_jax():
    """An edge envelope the ranks do not divide: both packages refuse it
    (tests/test_ep_unc.py:217)."""
    (padded,), _, _ = _batches(1, seed=3)
    odd = {k: (v[:-1] if k in jep.EDGE_KEYS else v)
           for k, v in padded.items()}
    assert set(tep.EDGE_KEYS) <= set(jep.EDGE_KEYS)
    with pytest.raises(ValueError, match="pad_e_max"):
        jep.shard_sub(mesh2(), odd)
    with pytest.raises(ValueError, match="pad_e_max"):
        tep.shard_sub(odd, World(0, 2, torch.device("cpu"), "gloo"))
    assert tep.pad_e_max(125, 2) == jep.pad_e_max(125, 2) == 126


def test_train_unc_on_two_ranks_end_to_end(runs):
    """train_unc(world=...) as each of two ranks (the command line's
    --ep_devices 2 spawns the same; tests/test_torch_unc_train.py runs
    it): one tiny epoch and the export, every node's row finite, the
    ranks' parameters and tables equal."""
    a, b = (r["train_unc"] for r in runs["ranks"])
    assert a["embs"].shape == (40, 8) and np.isfinite(a["embs"]).all()
    assert a["coverage"] > 0.9
    np.testing.assert_array_equal(a["embs"], b["embs"])
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)
