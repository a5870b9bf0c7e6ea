"""The port's SCM primitives and layers against the JAX package on the
CPU: ops/scatter.py (gather_nodes, gather_scalars, scatter_sum_edges and
their gradients, through K3's plain version), utils/act.py,
models/layers.py (Dense with parts=, UpdateMLP with MaskedBatchNorm),
models/embed.py, models/filter.py, models/dmpnn.py (DMPLayer, also on
the hand-derived fixture of tests/test_golden_fixtures.py) and
models/pred.py.

JAX runs at `highest` matmul precision (tests/conftest.py); weights are
carried across with params_from_flax. Tolerances: the primitives 1e-6
(float32 sums of a few terms in another order); layer outputs 1e-5 of
each tensor's largest magnitude (float32 matmuls of width <= 64 summed
in another order); gradients 1e-4 of each tensor's largest magnitude,
plus 1e-5 of the largest gradient of all (assert_grads).
"""

import flax.linen as nn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.models import dmpnn as jdmp
from dualmessagepassing_tpu.models import embed as jemb
from dualmessagepassing_tpu.models import filter as jflt
from dualmessagepassing_tpu.models import layers as jlay
from dualmessagepassing_tpu.models import pred as jpred
from dualmessagepassing_tpu.ops import scatter as jsc
from dualmessagepassing_tpu.utils import act as jact
from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch.models import dmpnn as tdmp
from dualmessagepassing_tpu_torch.models import embed as temb
from dualmessagepassing_tpu_torch.models import filter as tflt
from dualmessagepassing_tpu_torch.models import layers as tlay
from dualmessagepassing_tpu_torch.models import pred as tpred
from dualmessagepassing_tpu_torch.models.scm_models import params_from_flax
from dualmessagepassing_tpu_torch.ops import scatter as tsc
from dualmessagepassing_tpu_torch.utils import act as tact

from test_torch_scm_data import batches, make_records

OPS_TOL = dict(rtol=1e-6, atol=1e-6)


def close_to_max(got, want, rel, err_msg="", floor=0.0):
    """|got - want| <= rel * max|want| + floor, elementwise."""
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale + floor,
                               err_msg=err_msg)


def assert_grads(module, want, rel=1e-4, glob=1e-5):
    """Every parameter gradient within rel of its tensor's max plus glob
    of the largest gradient of all: a bias that feeds a BatchNorm has an
    exact gradient of 0 and returns rounding noise only."""
    gmax = max(float(v.abs().max()) for v in want.values())
    for k, p in module.named_parameters():
        close_to_max(p.grad, want[k].numpy(), rel, k, glob * gmax)


def perturb(tree, rng, scale=0.1):
    """N(0, scale) on every leaf, so zero-initialised biases and heads
    carry signal (variances stay positive)."""
    def f(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.normal(0, scale, x.shape).astype(np.float32)
        if path[-1].key == "var":
            return jnp.asarray(x + np.abs(noise) * 10)
        return jnp.asarray(x + noise)
    return jax.tree_util.tree_map_with_path(f, tree)


def jit_vjp(f, primals, cotangents):
    """(f(*primals), the vjp of the cotangents), compiled as one program:
    op-by-op JAX compiles every primitive on first use, which is slower
    on the CPU than one jit."""
    def run(p, c):
        out, vjp = jax.vjp(f, *p)
        return out, vjp(c)
    return jax.jit(run)(tuple(primals), cotangents)


@pytest.fixture(scope="module")
def graph_case():
    pats, gras = make_records(6, 4, 4, 12, 24, 4, 4, seed=3)
    (_, jgr), (_, tgr) = batches(pats, gras)
    return jgr, tgr


# ---------------------------------------------------------------------------
# primitives
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("method", [None, "segment"])
def test_gather_and_scatter_match_jax_with_gradients(graph_case, method):
    jgr, tgr = graph_case
    rng = np.random.default_rng(0)
    b, v, e, h = 6, 12, 48, 5
    table = rng.normal(size=(b, v, h)).astype(np.float32)
    scal = rng.normal(size=(b, v)).astype(np.float32)
    msg = rng.normal(size=(b, e, h)).astype(np.float32)
    cot_e = rng.normal(size=(b, e, h)).astype(np.float32)
    cot_s = rng.normal(size=(b, e)).astype(np.float32)
    cot_v = rng.normal(size=(b, v, h)).astype(np.float32)

    def jax_f(t, s, m):
        ge = jsc.gather_nodes(t, jgr.senders, method=method)
        gs = jsc.gather_scalars(s, jgr.receivers, method=method)
        agg = jsc.scatter_sum_edges(m, jgr.receivers, jgr.edge_mask, v,
                                    method=method)
        return ge, gs, agg

    outs, jgrads = jit_vjp(
        jax_f, (jnp.asarray(table), jnp.asarray(scal), jnp.asarray(msg)),
        (jnp.asarray(cot_e), jnp.asarray(cot_s), jnp.asarray(cot_v)))

    t, s, m = (torch.from_numpy(a).requires_grad_() for a in
               (table, scal, msg))
    ge = tsc.gather_nodes(t, tgr.senders, method)
    gs = tsc.gather_scalars(s, tgr.receivers, method)
    agg = tsc.scatter_sum_edges(m, tgr.receivers, tgr.edge_mask, v, method)
    torch.autograd.backward(
        (ge, gs, agg), tuple(torch.from_numpy(c) for c in
                             (cot_e, cot_s, cot_v)))
    for got, want in zip((ge, gs, agg), outs):
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                                   **OPS_TOL)
    for got, want in zip((t.grad, s.grad, m.grad), jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **OPS_TOL)


def test_pad_slots_holding_any_index_change_nothing(graph_case):
    """Pad edges are dropped by K3 and their messages zeroed: filling
    their receivers with any value (out of range, negative, another
    graph's) leaves the sum and the real rows' gradients unchanged."""
    _, tgr = graph_case
    rng = np.random.default_rng(1)
    msg = torch.from_numpy(rng.normal(size=(6, 48, 3)).astype(np.float32))
    cot = torch.from_numpy(rng.normal(size=(6, 12, 3)).astype(np.float32))
    pad = ~tgr.edge_mask
    results = []
    for fill in (0, 11, 12, 10 ** 6, -5):
        m = msg.clone().requires_grad_()
        recv = torch.where(pad, fill, tgr.receivers)
        out = tsc.scatter_sum_edges(m, recv, tgr.edge_mask, 12)
        out.backward(cot)
        results.append((out.detach(), m.grad))
        assert (m.grad[pad] == 0).all()
    for out, grad in results[1:]:
        assert torch.equal(out, results[0][0])
        assert torch.equal(grad, results[0][1])


def test_scatter_drops_out_of_range_receivers_and_sums_bf16_in_f32():
    """A real receiver outside [0, V) drops, as the one-hot of an
    out-of-range index is a zero row; bf16 messages are summed in
    float32 and rounded once."""
    recv = torch.tensor([[0, 3, 1, 0]])
    mask = torch.ones(1, 4, dtype=torch.bool)
    msg = torch.ones(1, 4, 2)
    out = tsc.scatter_sum_edges(msg, recv, mask, 2)
    np.testing.assert_array_equal(out[0].numpy(), [[2, 2], [1, 1]])
    big = torch.full((1, 300, 1), 1.0, dtype=torch.bfloat16)
    small = torch.full((1, 300, 1), 2.0 ** -8, dtype=torch.bfloat16)
    msg = torch.cat([big[:, :1], small], 1)
    out = tsc.scatter_sum_edges(msg, torch.zeros(1, 301, dtype=torch.long),
                                torch.ones(1, 301, dtype=torch.bool), 1)
    # 1 + 300 * 2**-8 = 2.17 rounds to 2.171875 in bf16; a running bf16
    # sum would stall at 1.0
    assert out.dtype == torch.bfloat16 and out.item() == 2.171875
    with pytest.raises(ValueError):
        tsc.scatter_sum_edges(msg, recv, mask, 2, method="bogus")


def test_gather_indices_clamp_like_xla():
    table = torch.arange(6.0).reshape(1, 3, 2)
    idx = torch.tensor([[-4, 0, 2, 9]])
    got = tsc.gather_nodes(table, idx)
    want = jnp.take_along_axis(jnp.asarray(table.numpy()),
                               jnp.asarray(idx.numpy())[..., None], axis=-2,
                               mode="clip")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ---------------------------------------------------------------------------
# activations, Dense, UpdateMLP, encoders, filter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(set(jact.supported_act_funcs())
                                        - {"gumbel_softmax"})
                         + ["leaky_relu0.1"])
def test_activations_match_jax(name):
    x = np.random.default_rng(2).normal(size=(4, 7)).astype(np.float32)
    x[0, :2] = x[0, 2]                   # ties for maximum/minimum
    want = jax.jit(jact.map_activation_str_to_fn(name))(jnp.asarray(x))
    got = tact.map_activation_str_to_fn(name)(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_sparsemax_gradient_and_gumbel_softmax():
    x = np.random.default_rng(3).normal(size=(3, 6)).astype(np.float32)
    g = np.random.default_rng(4).normal(size=(3, 6)).astype(np.float32)
    _, (want,) = jit_vjp(lambda a: jact.sparsemax(a, axis=0),
                         (jnp.asarray(x),), jnp.asarray(g))
    t = torch.from_numpy(x).requires_grad_()
    tact.sparsemax(t, axis=0).backward(torch.from_numpy(g))
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), atol=1e-6)
    soft = tact.gumbel_softmax(torch.from_numpy(x))
    np.testing.assert_allclose(soft.numpy(), np.asarray(
        jact.gumbel_softmax(jnp.asarray(x))), atol=1e-6)
    noisy = tact.gumbel_softmax(torch.from_numpy(x),
                                rng=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(noisy.sum(-1).numpy(), 1.0, atol=1e-6)
    with pytest.raises(NotImplementedError):
        tact.map_activation_str_to_fn("bogus")


def test_dense_parts_equal_the_concatenation():
    rng = np.random.default_rng(5)
    a = rng.normal(size=(3, 1, 4)).astype(np.float32)
    b = rng.normal(size=(3, 5, 6)).astype(np.float32)
    c = rng.normal(size=(3, 1, 1)).astype(np.float32)
    jd = jlay.Dense(7, init="normal", activation="relu")
    parts_j = [jnp.asarray(a), jnp.asarray(b), jnp.asarray(c)]
    # the Dense field `init` shadows Module.init
    params = perturb(nn.Module.init(jd, jax.random.PRNGKey(0),
                                    parts=parts_j), rng)
    want = jd.apply(params, parts=parts_j)
    td = tlay.Dense(11, 7, init="normal", activation="relu")
    td.load_state_dict(params_from_flax(params["params"]))
    got = td(parts=[torch.from_numpy(x) for x in (a, b, c)])
    close_to_max(got, want, 1e-6)
    cat = np.concatenate([np.broadcast_to(a, (3, 5, 4)), b,
                          np.broadcast_to(c, (3, 5, 1))], -1)
    close_to_max(td(torch.from_numpy(cat)), want, 1e-6)
    with pytest.raises(ValueError):
        td(parts=[torch.from_numpy(a)])


@pytest.mark.parametrize("train", [False, True])
def test_update_mlp_with_batch_norm_matches_jax(train):
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 9, 8)).astype(np.float32)
    mask = rng.random((4, 9)) < 0.7
    jm = jlay.UpdateMLP(8, 2, batch_norm=True, act="leaky_relu")
    v = nn.Module.init(jm, jax.random.PRNGKey(1), jnp.asarray(x),
                       mask=jnp.asarray(mask))
    params, stats = perturb(v["params"], rng), perturb(v["batch_stats"], rng)
    want, mut = jm.apply({"params": params, "batch_stats": stats},
                         jnp.asarray(x), mask=jnp.asarray(mask), train=train,
                         mutable=["batch_stats"])
    tm = tlay.UpdateMLP(8, 8, 2, batch_norm=True, act="leaky_relu")
    tm.load_state_dict(params_from_flax(params, stats))
    got = tm(torch.from_numpy(x), torch.from_numpy(mask), train=train)
    close_to_max(got, want, 1e-5)
    sd = tm.state_dict()
    for k, val in params_from_flax({}, mut["batch_stats"]).items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def test_encoders_embeddings_and_filter_match_jax():
    ids = np.array([[0, 3, 7, 9, -1]])           # 9 and -1 clamp
    for jenc_m, tenc_m in ((jemb.MultihotEncoder(8), temb.MultihotEncoder(8)),
                           (jemb.PositionEncoder(6, 8),
                            temb.PositionEncoder(6, 8))):
        want = jenc_m.apply({}, jnp.asarray(ids))
        np.testing.assert_array_equal(tenc_m(torch.from_numpy(ids)).numpy(),
                                      np.asarray(want))
    rows = np.random.default_rng(7).random((2, 3, 6)).astype(np.float32)
    for init in ("orthogonal", "normal", "uniform", "equivariant"):
        je = jemb.Embedding(6, 4, weight_init=init, scale=0.5)
        p = jax.jit(je.init)(jax.random.PRNGKey(2), jnp.asarray(rows))
        te = temb.Embedding(6, 4, weight_init=init, scale=0.5,
                            generator=torch.Generator().manual_seed(0))
        assert te.weight.shape == (6, 4)
        te.load_state_dict(params_from_flax(p["params"]))
        close_to_max(te(torch.from_numpy(rows)),
                     je.apply(p, jnp.asarray(rows)), 1e-6)
        np.testing.assert_array_equal(
            te(torch.tensor([[1, 8]])).detach().numpy(),
            np.asarray(je.apply(p, jnp.asarray([[1, 8]]))))
    w = temb.Embedding(5, 3, "orthogonal").weight.detach()
    np.testing.assert_allclose((w.T @ w).numpy(), np.eye(3), atol=1e-5)
    rng = np.random.default_rng(8)
    px, gx = rng.integers(0, 3, (4, 5)), rng.integers(0, 3, (4, 9))
    pm = rng.random((4, 5)) < 0.6
    np.testing.assert_array_equal(
        tflt.scalar_filter(torch.from_numpy(px), torch.from_numpy(gx),
                           torch.from_numpy(pm)).numpy(),
        np.asarray(jflt.scalar_filter(jnp.asarray(px), jnp.asarray(gx),
                                      jnp.asarray(pm))))


# ---------------------------------------------------------------------------
# DMPLayer and PredictNet
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("batch_norm, train", [(False, False), (True, True)])
def test_dmp_layer_matches_jax(graph_case, batch_norm, train):
    jgr, tgr = graph_case
    rng = np.random.default_rng(9)
    x = rng.normal(size=(6, 12, 16)).astype(np.float32)
    z = rng.normal(size=(6, 48, 16)).astype(np.float32)
    cot_v = rng.normal(size=(6, 12, 16)).astype(np.float32)
    cot_e = rng.normal(size=(6, 48, 16)).astype(np.float32)
    jl = jdmp.DMPLayer(hidden_dim=16, batch_norm=batch_norm, act="relu")
    v = jax.jit(jl.init)(jax.random.PRNGKey(3), jgr, jnp.asarray(x),
                         jnp.asarray(z))
    params = perturb(v["params"], rng)
    stats = perturb(v.get("batch_stats", {}), rng)

    def f(p, a, b):
        variables = {"params": p}
        if stats:
            variables["batch_stats"] = stats
        (vo, eo), _ = jl.apply(variables, jgr, a, b, train=train,
                               mutable=["batch_stats"])
        return vo, eo

    (jv, je), (jgp, jgx, jgz) = jit_vjp(
        f, (params, jnp.asarray(x), jnp.asarray(z)),
        (jnp.asarray(cot_v), jnp.asarray(cot_e)))

    tl = tdmp.DMPLayer(16, 16, batch_norm=batch_norm, act="relu")
    tl.load_state_dict(params_from_flax(params, stats))
    xt, zt = (torch.from_numpy(a).requires_grad_() for a in (x, z))
    tv, te = tl(tgr, xt, zt, train=train)
    nm, em = tgr.node_mask.numpy(), tgr.edge_mask.numpy()
    close_to_max(tv.detach().numpy()[nm], np.asarray(jv)[nm], 1e-5)
    close_to_max(te.detach().numpy()[em], np.asarray(je)[em], 1e-5)
    torch.autograd.backward((tv, te), (torch.from_numpy(cot_v),
                                       torch.from_numpy(cot_e)))
    close_to_max(xt.grad, jgx, 1e-4, "d node_feat")
    close_to_max(zt.grad, jgz, 1e-4, "d edge_feat")
    assert_grads(tl, params_from_flax(jgp))


def test_dmp_layer_hand_fixture():
    """tests/test_golden_fixtures.py::test_dmp_layer_hand_fixture through
    the port: literals derived by hand from the reference math."""
    i2 = np.eye(2, dtype=np.float32)
    swap = np.array([[0.0, 1.0], [1.0, 0.0]], np.float32)
    mlp = {"fc0": {"kernel": i2, "bias": np.zeros(2, np.float32)},
           "fc1": {"kernel": i2, "bias": np.zeros(2, np.float32)}}
    params = {"in_weight": i2, "out_weight": 2 * i2, "nloop_weight": i2,
              "src_weight": swap, "dst_weight": i2, "eloop_weight": i2,
              "nbias": np.array([0.1, -0.2], np.float32),
              "ebias": np.zeros(2, np.float32), "nmlp": mlp, "emlp": mlp}
    layer = tdmp.DMPLayer(2, 2, act="relu", dropout=0.0)
    layer.load_state_dict(params_from_flax(params))
    graph = tg.batch_graphs([tg.single_graph(3, [0, 2], [1, 1], v_max=3,
                                             e_max=2)])
    graph = graph.replace(rev_flag=torch.tensor([[False, True]]))
    node_feat = torch.tensor([[[1.0, 0.0], [0.0, 1.0], [1.0, 1.0]]])
    edge_feat = torch.tensor([[[1.0, 2.0], [3.0, 1.0]]])
    with torch.no_grad():
        v_out, e_out = layer(graph, node_feat, edge_feat)
    np.testing.assert_allclose(v_out[0].numpy(),
                               [[1.1, 0.0], [5.1, 0.8], [1.1, 0.8]],
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(e_out[0].numpy(), [[3.0, 0.0], [0.0, 6.0]],
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("name", ["SumPredictNet", "MeanPredictNet",
                                  "MaxPredictNet"])
def test_predict_nets_match_jax(name):
    rng = np.random.default_rng(10)
    p_rep = rng.normal(size=(3, 4, 8)).astype(np.float32)
    g_rep = rng.normal(size=(3, 9, 8)).astype(np.float32)
    pm = rng.random((3, 4)) < 0.8
    gm = rng.random((3, 9)) < 0.8
    pm[:, 0] = gm[:, 0] = True
    jn = jpred.build_pred_net(name, 6, "relu", 0.0, True)
    args = [jnp.asarray(a) for a in (p_rep, pm, g_rep, gm)]
    params = perturb(jax.jit(jn.init)(jax.random.PRNGKey(4), *args), rng)
    cy = rng.normal(size=(3, 1)).astype(np.float32)
    cw = rng.normal(size=(3, 9)).astype(np.float32)
    (jy, jw), (jgp, jga, jgb) = jit_vjp(
        lambda p, a, b: jn.apply(p, a, args[1], b, args[3]),
        (params, args[0], args[2]), (jnp.asarray(cy), jnp.asarray(cw)))
    tn = tpred.build_pred_net(name, 8, 6, "relu", 0.0, True)
    tn.load_state_dict(params_from_flax(params["params"]))
    pt, gt = (torch.from_numpy(a).requires_grad_() for a in (p_rep, g_rep))
    ty, tw = tn(pt, torch.from_numpy(pm), gt, torch.from_numpy(gm))
    close_to_max(ty, jy, 1e-5)
    close_to_max(tw, jw, 1e-5)
    torch.autograd.backward((ty, tw), (torch.from_numpy(cy),
                                       torch.from_numpy(cw)))
    close_to_max(pt.grad, jga, 1e-4)
    close_to_max(gt.grad, jgb, 1e-4)
    assert_grads(tn, params_from_flax(jgp["params"]))
    with pytest.raises(ValueError):
        tpred.build_pred_net("AttnPredictNet", 8, 6, "relu", 0.0, True)
