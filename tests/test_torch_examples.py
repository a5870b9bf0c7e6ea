"""The port's examples (dualmessagepassing_tpu_torch/examples/) on the
CPU against the JAX package's (examples/*.py), each at its own size:

  * quickstart_scm on the JAX example's model.init weights, perturbed
    (N(0, 0.1) on every leaf: the heads start at zero, so pred_c and
    most gradients would be 0), carried in by params_from_flax: pred_c,
    the loss, the gradients and the parameters after the AdamW step
    against the same computation in JAX;
  * the SCM half of performance_levers (amp bf16, 4 microbatches) on the
    JAX script's dataset and perturbed weights: every loss of the step
    held to JAX under tests/test_torch_scm_amp.py's amp rule;
  * one spawn of two gloo ranks (tests/test_torch_dist.examples_rank)
    runs multichip_dp, edge_parallel and the owner-sharded train_unc of
    performance_levers: the data-parallel step against the one-device
    step, the edge-partitioned forward against JAX's
    make_edge_parallel_dmp_apply on a 2-device mesh of conftest's
    virtual CPU devices (the JAX init's weights), and the halo run's
    coverage against the JAX script's train_unc on that mesh, its
    embeddings finite and [30, 8] (tests/test_torch_halo_unc.py holds
    the halo training numbers).

Tolerances: pred_c 1e-5 of its largest magnitude, the loss rtol 1e-5
(float32 matmuls summed in another order); gradients 1e-4 of each
tensor's largest magnitude plus 1e-5 of the largest gradient (the
port's SCM model tests' rule); the parameters after AdamW's first step
atol 1e-6 where the JAX gradient is above 1e-3 of its tensor's largest
(there the step is -lr (g / (|g| + eps) + wd p); a gradient that is
rounding noise takes a step of either sign); the data-parallel step
against the one-device step rtol 2e-4, atol 1e-5 (tests/test_torch_dp.py)
and the ranks bit for bit equal; the edge-partitioned forward rtol
1e-5, atol 1e-5 (tests/test_torch_edge_partition.py).
"""

import importlib.util

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
from jax.sharding import Mesh

from dualmessagepassing_tpu import ModelConfig as JConfig
from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu.data.dataset import GraphAdjDataset as JDataset
from dualmessagepassing_tpu.data.synthetic import \
    generate_dataset as jgenerate
from dualmessagepassing_tpu.parallel import edge_partition as jep
from dualmessagepassing_tpu.train import TrainState, make_optimizer
from dualmessagepassing_tpu.train import make_train_step as jmake_step
from dualmessagepassing_tpu.unc.driver import train_unc as jtrain_unc
from dualmessagepassing_tpu_torch.examples import (edge_parallel,
                                                   multichip_dp,
                                                   performance_levers,
                                                   quickstart_scm)
from dualmessagepassing_tpu_torch.models.scm_models import params_from_flax

from test_torch_dist import examples_rank, run_ranks
from test_torch_no_jax import ROOT

PRED = 1e-5
LOSS = dict(rtol=1e-5)
DP = dict(rtol=2e-4, atol=1e-5)
EP = dict(rtol=1e-5, atol=1e-5)


def jax_example(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def perturbed(variables, seed):
    """N(0, 0.1) on every parameter leaf (batch statistics kept)."""
    rng = np.random.default_rng(seed)
    params = jax.tree_util.tree_map(
        lambda x: jnp.asarray(np.asarray(x, np.float32) + rng.normal(
            0, 0.1, np.shape(x)).astype(np.float32)), variables["params"])
    return dict(variables, params=params)


def state_dict(variables):
    return params_from_flax(variables["params"],
                            variables.get("batch_stats"))


def assert_grads(got, want, rel=1e-4, glob=1e-5):
    gmax = max(float(np.abs(w).max()) for w in want.values())
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_allclose(
            got[k], w, rtol=0, err_msg=k,
            atol=rel * float(np.abs(w).max()) + glob * gmax)


@pytest.fixture(scope="module")
def quickstart():
    """The JAX example's computation on perturbed init weights -> (its
    variables, pred_c, loss, gradients, parameters after the step)."""
    jq = jax_example("quickstart_scm")
    rng = np.random.default_rng(0)
    pattern, graph = jq.make_batch(rng)
    model = jbuild(JConfig(**quickstart_scm.CONFIG.__dict__))
    variables = perturbed(jax.jit(model.init)(jax.random.PRNGKey(0),
                                              pattern, graph), 1)
    counts = jnp.asarray(rng.poisson(2.0, (4, 1)).astype(np.float32))
    tx = optax.adamw(1e-3)

    @jax.jit
    def step(p):
        def loss_fn(p):
            pred_c = model.apply(p, pattern, graph)["pred_c"]
            return jnp.mean((pred_c - counts) ** 2), pred_c
        (loss, pred_c), grads = jax.value_and_grad(loss_fn, has_aux=True)(p)
        updates, _ = tx.update(grads, tx.init(p), p)
        return pred_c, loss, grads, optax.apply_updates(p, updates)
    pred_c, loss, grads, after = step(variables)
    return (variables, np.asarray(pred_c), float(loss),
            {k: v.numpy() for k, v in state_dict(grads).items()},
            {k: v.numpy() for k, v in state_dict(after).items()})


def test_quickstart_follows_the_jax_example(quickstart):
    variables, pred_c, loss, grads, after = quickstart
    got = quickstart_scm.main("cpu", state_dict(variables))
    assert np.abs(pred_c).max() > 0.1
    np.testing.assert_allclose(got["pred_c"], pred_c, rtol=0,
                               atol=PRED * np.abs(pred_c).max())
    np.testing.assert_allclose(got["loss"], loss, **LOSS)
    assert_grads(got["grads"], grads)
    for k, g in grads.items():
        sure = np.abs(g) > 1e-3 * np.abs(g).max()
        np.testing.assert_allclose(got["params"][k][sure], after[k][sure],
                                   rtol=0, atol=1e-6, err_msg=k)


def test_performance_levers_scm_step_holds_the_amp_rule():
    data = jgenerate(32, seed=0, pv=3, pe=3, gv=8, ge=16, num_vlabels=2,
                     num_elabels=2, p_v_max=4, p_e_max=4, g_v_max=8,
                     g_e_max=16)
    model = jbuild(JConfig(**performance_levers.SCM_CONFIG.__dict__))
    _, pattern, graph, counts, (nw, ew) = JDataset(data).batchify(
        range(16), "nodeedge")
    variables = perturbed(jax.jit(model.init)(jax.random.PRNGKey(0),
                                              pattern, graph), 2)
    tx = make_optimizer(lr=1e-3)

    def jax_losses(amp):
        step = jmake_step(model, tx, return_weights="nodeedge", amp=amp,
                          accum_chunks=4)
        # the step donates its state: each gets a copy
        state = TrainState.create(jax.tree_util.tree_map(jnp.copy, variables),
                                  tx)
        _, losses = step(state, pattern, graph,
                         counts, nw, ew, *performance_levers.SCM_SCALARS,
                         jax.random.PRNGKey(1))
        return {k: float(v) for k, v in losses.items()}

    f32, amp = jax_losses(False), jax_losses(True)
    got = performance_levers.scm_amp_microbatched(
        "cpu", state_dict(variables))["losses"]
    assert "total" in got and set(got) <= set(f32)
    for k, v in got.items():
        err, own = abs(v - f32[k]), abs(amp[k] - f32[k])
        assert err <= 1.5 * own + 2 ** -8 * abs(f32[k]), (k, v, amp[k],
                                                         f32[k])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, quickstart):
    """The three examples that run over ranks, on two gloo ranks, with
    the JAX edge-parallel init's weights -> (rank results, the JAX
    weights)."""
    ep_params = [{k: np.asarray(v) for k, v in layer.items()}
                 for layer in jep.init_edge_parallel_params(
                     jax.random.PRNGKey(0), edge_parallel.LAYERS,
                     edge_parallel.H)]
    out = run_ranks(examples_rank, tmp_path_factory.mktemp("examples"),
                    state_dict(quickstart[0]), ep_params)
    return out, ep_params


def test_multichip_dp_equals_the_one_device_step(ranks, quickstart):
    """Two ranks against the one-device step and both against the JAX
    example's (the quickstart fixture: the same batch, counts and
    weights; its loss is the step's count loss at slope 1)."""
    out, _ = ranks
    variables, _, loss, grads, after = quickstart
    one = multichip_dp.dp_step(None, "cpu", 2, state_dict(variables))
    a, b = (r["dp"] for r in out)
    assert a["loss"] == b["loss"]
    np.testing.assert_allclose(a["loss"], one["loss"], **DP)
    for k, want in one["state"].items():
        np.testing.assert_array_equal(a["state"][k], b["state"][k])
        np.testing.assert_allclose(a["state"][k], want, err_msg=k, **DP)
    for run in (one, a):
        np.testing.assert_allclose(run["loss"], loss, **DP)
        assert_grads(run["grads"], grads)
        for k, g in grads.items():
            sure = np.abs(g) > 1e-3 * np.abs(g).max()
            np.testing.assert_allclose(run["state"][k][sure],
                                       after[k][sure], err_msg=k, **DP)


def test_edge_parallel_follows_jax_on_a_two_device_mesh(ranks):
    out, ep_params = ranks
    arrays, node_feat, edge_feat = edge_parallel.inputs(2)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("ep",))
    fwd = jep.make_edge_parallel_dmp_apply(mesh, edge_parallel.V,
                                           num_layers=edge_parallel.LAYERS)
    with mesh:
        sharded = jep.shard_flat_edges(mesh, arrays)
        v_out, e_out = jax.jit(fwd)(
            [{k: jnp.asarray(v) for k, v in layer.items()}
             for layer in ep_params], jnp.asarray(node_feat),
            jnp.asarray(edge_feat), sharded["senders"], sharded["receivers"],
            sharded["rev_flag"], sharded["edge_mask"])
    for r in out:
        np.testing.assert_allclose(r["ep"]["node_out"], np.asarray(v_out),
                                   **EP)
    edges = np.concatenate([r["ep"]["edge_out"] for r in out])
    np.testing.assert_allclose(edges, np.asarray(e_out), **EP)


def test_owner_sharded_train_unc_covers_as_the_jax_script(ranks):
    out, _ = ranks
    kw = dict(performance_levers.UNC_KW)
    _, coverage = jtrain_unc(
        performance_levers.unc_triplets(), performance_levers.UNC_NODES,
        performance_levers.UNC_RELS, h_dim=8, n_layers=1, ep_devices=2,
        ep_mode="halo", ep_partition="bfs", scatter_backend="windowed",
        log=lambda s: None, **kw)
    for r in out:
        emb = r["halo"]["emb"]
        assert emb.shape == (performance_levers.UNC_NODES, 8)
        assert np.isfinite(emb).all()
        assert r["halo"]["coverage"] == coverage
    np.testing.assert_array_equal(out[0]["halo"]["emb"],
                                  out[1]["halo"]["emb"])
