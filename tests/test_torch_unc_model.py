"""Port UNC DMPNN forward (dualmessagepassing_tpu_torch/unc/model.py)
against the JAX package on identical weights (params_from_flax).

The JAX side runs on the CPU at `highest` matmul precision
(tests/conftest.py) in two compositions: the plain XLA model, and the
bench composition (scatter_backend="windowed" + pad_cols + the
windowed, sender and broadcast plans, through the kernels' CPU
fallbacks). The port runs the plain versions of its kernels. Rows are
compared where they are valid (node_mask / edge_mask): pad edges differ
by design (the port's receiver gather zeroes them).

Tolerances: float32 — 1e-5 abs and rel (the same float32 arithmetic in
another summation order). amp bf16 — 3e-2 abs and rel: both sides round
every matmul and elementwise result to bf16 (8 significant bits, a
relative step of 2**-8 = 3.9e-3), but XLA and torch round at different
places (bf16 matmul accumulation, leaky_relu slope), and a few such
steps accumulate over two layers with BatchNorm.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.ops.segment_kernel import attach_scatter_plan
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu.unc.data import WholeGraph
from dualmessagepassing_tpu_torch.ops.segment_kernel import attach_csr_plan
from dualmessagepassing_tpu_torch.unc import model as tm
from dualmessagepassing_tpu_torch.unc.driver import to_device

from test_torch_unc_data import tiny_hin

H, LAYERS = 16, 2
F32_TOL = dict(rtol=1e-5, atol=1e-5)
AMP_TOL = dict(rtol=3e-2, atol=3e-2)


def perturb(tree, rng, scale=0.05):
    """Add N(0, scale) to every leaf so biases, BN affine terms and BN
    running statistics are all non-trivial (variances stay positive)."""
    def f(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.normal(0, scale, x.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(x + np.abs(noise) * 10)
        return jnp.asarray(x + noise)
    return jax.tree_util.tree_map_with_path(f, tree)


@pytest.fixture(scope="module")
def case():
    """One sampled, padded batch of a tiny HIN, and perturbed weights of a
    2-layer JAX UNCTrainModel."""
    t, n, r = tiny_hin(seed=5, n=80, e=400)
    g = WholeGraph(n, r, t)
    padded = jdrv.sample_batch(g, t[:50], "randomwalk", 3, 5, 0.5, 3, n,
                               g.num_edges, 200, np.random.default_rng(0))
    assert padded["edge_mask"].sum() < len(padded["edge_mask"])  # has pads
    kw = dict(num_nodes=n, num_rels=r, h_dim=H, nlabel=0,
              num_hidden_layers=LAYERS, dropout=0.0, reg_param=0.01,
              backbone="DMPNN", sorted_edges=True)
    models = {"xla": jm.UNCTrainModel(**kw),
              "bench": jm.UNCTrainModel(scatter_backend="windowed",
                                        pad_cols=True, **kw)}
    subs = {"xla": {k: jnp.asarray(v) for k, v in padded.items()},
            "bench": {k: jnp.asarray(v) for k, v in attach_scatter_plan(
                padded, sender_plan=True, bcast_plan=True).items()}}
    variables = jm.init_unc_variables(models["xla"], jax.random.PRNGKey(0),
                                      subs["xla"])
    rng = np.random.default_rng(1)
    params = perturb(variables["params"], rng)
    stats = perturb(variables["batch_stats"], rng)
    return dict(n=n, r=r, padded=padded, models=models, subs=subs,
                params=params, stats=stats,
                sub_t=to_device(attach_csr_plan(padded), "cpu"))


def port_model(case):
    m = tm.UNCTrainModel(case["n"], case["r"], H, num_hidden_layers=LAYERS)
    m.load_state_dict(tm.params_from_flax(case["params"], case["stats"]))
    return m


def assert_rows(got, want, mask, tol):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(got[mask], want[mask], **tol)


def test_params_from_flax_consumes_every_leaf(case):
    sd = tm.params_from_flax(case["params"], case["stats"])
    n_leaves = (len(jax.tree.leaves(case["params"]))
                + len(jax.tree.leaves(case["stats"])))
    assert len(sd) == n_leaves
    m = tm.UNCTrainModel(case["n"], case["r"], H, num_hidden_layers=LAYERS)
    assert set(sd) == set(m.state_dict())
    m.load_state_dict(sd, strict=True)
    np.testing.assert_array_equal(
        m.model.layers[1].emlp.bn.running_var.numpy(),
        np.asarray(case["stats"]["model"]["layer_1"]["emlp"]["bn"]["var"]))
    np.testing.assert_array_equal(
        m.edge_fc.kernel.detach().numpy(),
        np.asarray(case["params"]["edge_fc"]["kernel"]))


def test_dual_graph_conv_hand_fixture():
    """tests/test_golden_fixtures.py::test_dual_graph_conv_hand_fixture
    on the port: literals derived by hand from the reference math."""
    i2 = np.eye(2, dtype=np.float32)
    swap = np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)
    mlp = {"fc0_kernel": i2, "fc0_bias": np.zeros(2, np.float32),
           "fc1_kernel": i2, "fc1_bias": np.zeros(2, np.float32)}
    params = {"in_weight": i2, "out_weight": 2 * i2, "nloop_weight": i2,
              "src_weight": swap, "dst_weight": i2, "eloop_weight": i2,
              "nbias": np.array([0.1, -0.2], np.float32),
              "ebias": np.zeros(2, np.float32), "nmlp": mlp, "emlp": mlp}
    layer = tm.DualGraphConv(2, 2, batch_norm=False, activation=None)
    layer.load_state_dict(tm.params_from_flax(params))
    sub = to_device(attach_csr_plan({
        "senders": np.array([0, 2]), "receivers": np.array([1, 1]),
        "rev_flag": np.array([False, True]),
        "edge_mask": np.array([True, True]),
        "node_mask": np.array([True, True, True])}), "cpu")
    node_feat = torch.tensor([[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]])
    edge_feat = torch.tensor([[1.0, 2.0], [3.0, 1.0]])
    with torch.no_grad():
        n_out, e_out = layer(sub, node_feat, edge_feat,
                             edge_norm=torch.tensor([[0.5], [1.0]]))
    np.testing.assert_allclose(
        n_out.numpy(), [[1.1, -0.03636363636363637], [5.6, 1.8], [1.1, 0.8]],
        atol=1e-6, rtol=0)
    np.testing.assert_allclose(
        e_out.numpy(), [[3.0, 0.0], [-0.18181818181818182, 6.0]],
        atol=1e-6, rtol=0)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("comp", ["xla", "bench"])
def test_dual_graph_conv_matches_jax(case, comp, train):
    """One tanh layer on random features, eval and train mode (train
    also compares the updated BatchNorm running statistics)."""
    rng = np.random.default_rng(2)
    v, e = len(case["padded"]["node_mask"]), len(case["padded"]["senders"])
    x = rng.normal(size=(v, H)).astype(np.float32)
    z = rng.normal(size=(e, H)).astype(np.float32)
    jlayer = jm.DualGraphConv(
        hidden_dim=H, activation="tanh", sorted_edges=True,
        **({"scatter_backend": "windowed", "pad_cols": True}
           if comp == "bench" else {}))
    lp = case["params"]["model"]["layer_0"]
    ls = case["stats"]["model"]["layer_0"]
    sub_j = case["subs"][comp]
    (jn, je), mutated = jlayer.apply(
        {"params": lp, "batch_stats": ls}, sub_j, jnp.asarray(x),
        jnp.asarray(z), edge_norm=sub_j["edge_norm"], train=train,
        mutable=["batch_stats"])
    tlayer = tm.DualGraphConv(H, H, activation="tanh")
    tlayer.load_state_dict(tm.params_from_flax(lp, ls))
    sub_t = case["sub_t"]
    with torch.no_grad():
        tn, te = tlayer(sub_t, torch.from_numpy(x), torch.from_numpy(z),
                        edge_norm=sub_t["edge_norm"], train=train)
    assert_rows(tn, jn, case["padded"]["node_mask"], F32_TOL)
    assert_rows(te, je, case["padded"]["edge_mask"], F32_TOL)
    if train:
        want = tm.params_from_flax({}, mutated["batch_stats"])
        got = tlayer.state_dict()
        for k, val in want.items():
            np.testing.assert_allclose(got[k].numpy(), val.numpy(), **F32_TOL)


def _jax_forward(case, comp, level, train, amp=False):
    model, sub = case["models"][comp], case["subs"][comp]
    if level == "UNCTrainModel":
        (out, _), mutated = jm.apply_unc_forward(
            model, case["params"], case["stats"], sub,
            jax.random.PRNGKey(0), amp=amp, train=train)
        return out, mutated
    backbone = jm.UNCDMPNN(
        num_nodes=case["n"], num_rels=2 * case["r"], h_dim=H, out_dim=H,
        num_hidden_layers=LAYERS, sorted_edges=True,
        scatter_backend=model.scatter_backend, pad_cols=model.pad_cols)
    out, mutated = backbone.apply(
        {"params": case["params"]["model"],
         "batch_stats": case["stats"]["model"]},
        sub, train=train, mutable=["batch_stats"])
    return out, {"model": mutated["batch_stats"]}


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("comp", ["xla", "bench"])
@pytest.mark.parametrize("level", ["UNCDMPNN", "UNCTrainModel"])
def test_forward_matches_jax(case, level, comp, train):
    (jh, jz, jr), jstats = _jax_forward(case, comp, level, train)
    m = port_model(case)
    with torch.no_grad():
        if level == "UNCTrainModel":
            th, tz, tr = tm.apply_unc_forward(m, case["sub_t"], train=train)
        else:
            th, tz, tr = m.model(case["sub_t"], train=train)
    assert_rows(th, jh, case["padded"]["node_mask"], F32_TOL)
    assert_rows(tz, jz, case["padded"]["edge_mask"], F32_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **F32_TOL)
    if train:
        want = tm.params_from_flax({}, jstats)
        got = m.state_dict()
        for k, val in want.items():
            np.testing.assert_allclose(got[k].numpy(), val.numpy(), **F32_TOL)


@pytest.mark.parametrize("comp", ["xla", "bench"])
def test_amp_forward_matches_jax(case, comp):
    """amp bf16 eval forward against apply_unc_forward(amp=True)."""
    (jh, jz, jr), _ = _jax_forward(case, comp, "UNCTrainModel", False,
                                   amp=True)
    m = port_model(case)
    with torch.inference_mode():
        th, tz, tr = tm.apply_unc_forward(m, case["sub_t"], amp=True)
    assert th.dtype == tz.dtype == tr.dtype == torch.float32
    assert_rows(th, jh, case["padded"]["node_mask"], AMP_TOL)
    assert_rows(tz, jz, case["padded"]["edge_mask"], AMP_TOL)
    np.testing.assert_allclose(tr.numpy(), np.asarray(jr), **AMP_TOL)
