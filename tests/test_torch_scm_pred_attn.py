"""The port's attention predict nets (models/pred_attn.py: DotAttention,
Mean/Sum/MaxAttnPredictNet) against the JAX package on the CPU, with
random weights of the JAX modules' shapes (tests/test_torch_scm_rep_nets.
random_variables) carried across by params_from_flax.

  * The "identity" initializer: eye plus std**2 noise, as the JAX
    package draws it.
  * DotAttention over a grid of its options (no projection and
    projections of other widths, heads, scale, softmax / sparsemax / an
    activation, zero attention, gate, residual, pre- and post-LayerNorm)
    on batches whose keys are all real: the output within rtol 1e-5 /
    atol 1e-6, every gradient (parameters, query, key, value) within
    1e-4 of its tensor's largest magnitude plus 1e-5 of the largest
    gradient (tests/test_torch_scm_model.py's bounds). Dropout draws from
    the explicit generator.
  * The key mask. The JAX package scores a masked key +1e30
    (pred_attn.py:95), so softmax and sparsemax give the pad keys all the
    weight; the port scores it -1e30. On padded batches the port's real
    query rows equal the JAX package's run on each sample alone at its
    true key length (forward, and the parameter gradient summed over the
    samples); the JAX package's padded output moves with the pad values,
    the port's does not.
  * Each Attn net inside GraphAdjModelV2 over DMPNN (nodeedge) and inside
    EdgeSeqModel over CNN (edge), infer_steps 1 and 2, on batches without
    pad keys (every graph fills its envelope, no reversed edges): the
    outputs, scm_loss and every gradient in f32, within the bounds of
    tests/test_torch_scm_model.py plus twice the port's own float32 error
    (check_model_f32); and under amp bf16 (AMP_CASES) the port's L2
    distance to the JAX f32 result over the JAX package's own amp
    distance, for the predictions, the loss and the gradients, at most
    AMP_RATIO in the geometric mean over AMP_DRAWS weight draws (the JAX
    amp function compiled without XLA's excess precision, as
    tests/test_torch_scm_edgeseq_train.py does). Over 8 draws (2 layers)
    the means of 4 were at most 1.44 (gradients, infer_steps 2).
  * params_from_flax maps every leaf of the nets' flax trees.
  * One make_train_step of MeanAttnPredictNet against the JAX step
    (tests/test_torch_scm_train.py's bounds), and one tiny command-line
    epoch of SumAttnPredictNet, its finetune and scm_evaluate.
"""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu import graph as jg
from dualmessagepassing_tpu.models import pred_attn as jattn
from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu.utils import init as jinit
from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch.cli import scm_evaluate as teval
from dualmessagepassing_tpu_torch.cli import scm_train as ttrain
from dualmessagepassing_tpu_torch.models import pred_attn as tattn
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.models.scm_models import params_from_flax
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv
from dualmessagepassing_tpu_torch.train.losses import scm_loss as tloss
from dualmessagepassing_tpu_torch.utils import init as tinit

import test_torch_scm_edgeseq as es
import test_torch_scm_rep_nets as rn
from test_torch_scm_cli import TINY, VOCAB2
from test_torch_scm_data import jax_config, small_config
from test_torch_scm_model import LOSS_KW
from test_torch_scm_ops import assert_grads, close_to_max, jit_vjp

NETS = ("MeanAttnPredictNet", "SumAttnPredictNet", "MaxAttnPredictNet")
# the amp rule (test_torch_scm_rep_nets.py's): over AMP_DRAWS weight
# draws, the geometric mean of the ratios at most AMP_RATIO; single
# draws of a 4-pair batch run to ~7 (a relu or a sparsemax support that
# flips under bf16 moves a head's gradient)
AMP_DRAWS = 4
AMP_RATIO = 1.5


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are tiny and the test workers share
    the CPU's cores (tests/test_torch_scm_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_identity_init_matches_jax():
    """eye(in, out) plus std**2 N(0, 1), std = gain * 2 / (in + out)."""
    for shape in ((6, 8), (8, 8), (12, 6)):
        want = np.asarray(jinit.identity_init()(jax.random.PRNGKey(0),
                                                shape))
        got = tinit.get_initializer("identity")(
            shape, torch.Generator().manual_seed(0)).numpy()
        eye = np.eye(*shape, dtype=np.float32)
        std = 2.0 / sum(shape)
        for w in (want, got):
            noise = (w - eye) / std ** 2
            assert abs(noise.mean()) < 0.5 and 0.6 < noise.std() < 1.4
        np.testing.assert_allclose(got, eye, rtol=0, atol=8 * std ** 2)


# ---------------------------------------------------------------------------
# DotAttention
# ---------------------------------------------------------------------------

# (query, key, value widths), the options of both packages' DotAttention
ATTN_CASES = {
    "softmax": ((6, 10, 10), dict(hidden_dim=8)),
    "no-projection": ((8, 8, 8), dict(hidden_dim=-1, num_heads=2,
                                      score_func="sparsemax", scale=0.5)),
    "attn-net": ((6, 10, 10), dict(
        hidden_dim=8, num_heads=4, scale=0.5 ** 0.5, score_func="sparsemax",
        add_gate=True, param_init="identity")),
    "zero-attn": ((6, 10, 7), dict(hidden_dim=8, num_heads=2,
                                   add_zero_attn=True)),
    "pre-lnorm": ((6, 10, 10), dict(hidden_dim=8, num_heads=2,
                                    score_func="sparsemax", pre_lnorm=True,
                                    add_residual=True)),
    "post-lnorm": ((6, 6, 9), dict(hidden_dim=4, score_func="sigmoid",
                                   add_gate=True, post_lnorm=True)),
    "everything": ((8, 8, 8), dict(
        hidden_dim=-1, num_heads=2, score_func="sparsemax",
        add_zero_attn=True, add_gate=True, add_residual=True,
        pre_lnorm=True, post_lnorm=True)),
}


def attn_modules(dims, opts, rng):
    """(the JAX DotAttention, its random weights, the port's with them)."""
    qd, kd, vd = dims
    jm = jattn.DotAttention(**opts)
    x = [jnp.zeros((1, 2, d)) for d in dims]
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), *x,
                            jnp.ones((1, 2), bool), jnp.ones((1, 2), bool))
    params = rn.random_variables(shapes, rng)
    opts = {k: v for k, v in opts.items() if k != "hidden_dim"}
    tm = tattn.DotAttention(qd, kd, vd, jm.hidden_dim, **opts)
    tm.load_state_dict(params_from_flax(params.get("params", {})),
                       strict=True)
    return jm, params, tm


def attn_inputs(dims, rng, bsz=3, qlen=5, klen=7):
    q, k, v = (rng.normal(size=(bsz, n, d)).astype(np.float32)
               for n, d in zip((qlen, klen, klen), dims))
    qmask = rng.random((bsz, qlen)) < 0.7
    qmask[:, 0] = True
    return q, k, v, qmask


@pytest.mark.parametrize("name", list(ATTN_CASES))
def test_dot_attention_matches_jax(name):
    dims, opts = ATTN_CASES[name]
    rng = np.random.default_rng(sorted(ATTN_CASES).index(name))
    jm, params, tm = attn_modules(dims, opts, rng)
    q, k, v, qmask = attn_inputs(dims, rng)
    kmask = np.ones(k.shape[:2], bool)
    cot = rng.normal(size=(q.shape[0], q.shape[1], dims[0])).astype(
        np.float32)
    jout, (jgp, jgq, jgk, jgv) = jit_vjp(
        lambda p, a, b, c: jm.apply(p, a, b, c, jnp.asarray(qmask),
                                    jnp.asarray(kmask)),
        (params, *map(jnp.asarray, (q, k, v))), jnp.asarray(cot))
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    tout = tm(tq, tk, tv, torch.from_numpy(qmask), torch.from_numpy(kmask))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    tout.backward(torch.from_numpy(cot))
    want = params_from_flax(jgp.get("params", {}))
    gmax = max([float(g.abs().max()) for g in want.values()]
               + [float(np.abs(g).max()) for g in (jgq, jgk, jgv)])
    if want:
        assert_grads(tm, want)
    for t, g in ((tq, jgq), (tk, jgk), (tv, jgv)):
        close_to_max(t.grad, np.asarray(g), 1e-4, name, 1e-5 * gmax)


def test_dot_attention_dropout_draws_from_the_generator():
    """Dropout on the scores and the output: the same masks from the same
    seed, other masks from another, none in eval mode."""
    dims, opts = ATTN_CASES["attn-net"]
    rng = np.random.default_rng(0)
    _, _, tm = attn_modules(dims, dict(opts, dropout=0.3), rng)
    x = [torch.from_numpy(a) for a in attn_inputs(dims, rng)]

    def run(seed, train=True):
        return tm(*x, train=train,
                  generator=torch.Generator().manual_seed(seed))

    assert torch.equal(run(1), run(1))
    assert not torch.equal(run(1), run(2))
    assert torch.equal(run(1, False), run(2, False))


def padded_case(opts, seed):
    """Keys of true lengths 7, 4, 1 (pads at the end, random values)."""
    dims = (6, 10, 10)
    rng = np.random.default_rng(seed)
    jm, params, tm = attn_modules(dims, opts, rng)
    q, k, v, qmask = attn_inputs(dims, rng)
    lens = [7, 4, 1]
    kmask = np.arange(7)[None, :] < np.array(lens)[:, None]
    return jm, params, tm, (q, k, v, qmask, kmask), lens, rng


@pytest.mark.parametrize("opts", [
    ATTN_CASES["attn-net"][1],
    dict(hidden_dim=8, num_heads=2),
    dict(hidden_dim=8, num_heads=2, score_func="sparsemax",
         add_zero_attn=True)], ids=["attn-net", "softmax", "zero-attn"])
def test_pad_keys_match_jax_per_sample_at_true_length(opts):
    """The port's real query rows on a padded batch against the JAX
    package run on each sample alone, its keys cut to their true length;
    the parameter gradient of those rows summed over the samples."""
    jm, params, tm, (q, k, v, qmask, kmask), lens, rng = padded_case(
        opts, 5)
    cot = rng.normal(size=(3, 5, 6)).astype(np.float32) * qmask[..., None]
    tout = tm(*map(torch.from_numpy, (q, k, v, qmask, kmask)))
    tout.backward(torch.from_numpy(cot))
    want_g = None
    for b, n in enumerate(lens):
        one = [jnp.asarray(a[b:b + 1, :n]) for a in (k, v)]
        jout, (jgp,) = jit_vjp(
            lambda p: jm.apply(p, jnp.asarray(q[b:b + 1]), *one,
                               jnp.asarray(qmask[b:b + 1]), None),
            (params,), jnp.asarray(cot[b:b + 1]))
        rows = qmask[b]
        np.testing.assert_allclose(tout[b].detach().numpy()[rows],
                                   np.asarray(jout)[0][rows], rtol=1e-5,
                                   atol=1e-6)
        want_g = jgp if want_g is None else jax.tree.map(
            jnp.add, want_g, jgp)
    assert_grads(tm, params_from_flax(want_g["params"]))


def test_jax_pad_keys_take_the_weight():
    """Changing only the pad keys' values moves the JAX package's output
    on the padded samples (its mask selects the pad keys) and leaves the
    port's as it was."""
    jm, params, tm, (q, k, v, qmask, kmask), _, rng = padded_case(
        ATTN_CASES["attn-net"][1], 6)
    v2 = np.where(kmask[..., None], v, v + 3.0 * rng.normal(size=v.shape))
    v2 = v2.astype(np.float32)
    outs = {}
    for name, val in (("a", v), ("b", v2)):
        outs[("jax", name)] = np.asarray(jm.apply(
            params, *map(jnp.asarray, (q, k, val, qmask, kmask))))
        with torch.no_grad():
            outs[("port", name)] = tm(*map(torch.from_numpy, (
                q, k, val, qmask, kmask))).numpy()
    real = qmask[1:]     # samples 1 and 2 have pad keys
    moved = np.abs(outs[("jax", "a")] - outs[("jax", "b")])[1:][real]
    assert moved.max() > 0.1
    np.testing.assert_array_equal(outs[("port", "a")], outs[("port", "b")])


# ---------------------------------------------------------------------------
# the Attn nets inside the models
# ---------------------------------------------------------------------------

def full_records(bsz, pv, pe, gv, ge, nvl, nel, seed):
    """Random pattern and graph records that fill their envelopes (every
    node and edge real) and have no reversed edges: no prediction mask
    has a pad key."""
    rng = np.random.default_rng(seed)
    recs = []
    for _ in range(bsz):
        pair = []
        for v, e in ((pv, pe), (gv, ge)):
            pair.append(jg.single_graph(
                v, rng.integers(0, v, e), rng.integers(0, v, e),
                node_labels=rng.integers(0, nvl, v),
                edge_labels=rng.integers(0, nel, e), v_max=v, e_max=e))
        recs.append(pair)
    return [r[0] for r in recs], [r[1] for r in recs]


_CASES = {}


def attn_case(pred_net, rep_net, infer_steps):
    """test_torch_scm_rep_nets.family_case / test_torch_scm_edgeseq.
    seq_case on batches without pad keys: DMPNN (pattern 4 V / 4 E,
    graph 12 V / 24 E, nodeedge) or CNN (pattern 4 V / 3 tuples, graph
    8 V / 8 tuples, edge weights), one layer, bsz 4, hid 16, 4 heads;
    for AMP_CASES the JAX amp function compiled without excess
    precision."""
    key = (pred_net, rep_net, infer_steps)
    if key in _CASES:
        return _CASES[key]
    kw = dict(pred_net=pred_net, pred_infer_steps=infer_steps,
              pred_num_heads=4, rep_num_pattern_layers=1,
              rep_num_graph_layers=1)
    bsz = 4
    if rep_net == "DMPNN":
        cfg = small_config(max_ngv=12, max_nge=24, max_ngel=4, max_npv=4,
                           max_npe=4, max_npel=4, **kw)
        pats, gras = full_records(bsz, 4, 4, 12, 24, 4, 4, seed=2)
        jb = (jg.batch_graphs(pats), jg.batch_graphs(gras))
        tb = (tg.batch_graphs(pats), tg.batch_graphs(gras))
        out_len = 24
    else:
        cfg = es.seq_config(rep_net="CNN", max_ngv=8, max_nge=8,
                            max_ngel=3, max_npv=4, max_npe=3, max_npel=3,
                            **kw)
        pats, gras = full_records(bsz, 4, 3, 8, 8, 3, 3, seed=2)
        seqs = [[jg.record_to_edgeseq(r) for r in recs]
                for recs in (pats, gras)]
        jb = tuple(jg.batch_edgeseqs(s) for s in seqs)
        tb = tuple(tg.batch_edgeseqs(s) for s in seqs)
        out_len = sm.build_model(cfg, device="cpu").refine_edge_weights(
            torch.zeros(bsz, tb[1].max_len, 1)).shape[1]
    jm = jbuild(jax_config(cfg))
    rng = np.random.default_rng(MODEL_CASES.index(key))
    case = dict(cfg=cfg, jm=jm, jb=jb, tb=tb, rng=rng, fns={},
                shapes=jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jb),
                counts=rng.poisson(3.0, (bsz, 1)).astype(np.float32),
                nw=rng.poisson(1.0, (bsz, cfg.max_ngv)).astype(np.float32),
                ew=rng.poisson(1.0, (bsz, out_len)).astype(np.float32))
    amp = key in AMP_CASES
    case["draws"] = [rn.draw_weights(case)
                     for _ in range(AMP_DRAWS if amp else 1)]
    case.update(case["draws"][0])
    if amp:
        w = case["draws"][0]
        case["fns"][(True, True)] = jax.jit(
            rn._jax_grads(case, True, True)).lower(
                w["params"], w["stats"]).compile(
                    {"xla_allow_excess_precision": False})
    _CASES[key] = case
    return case


def port_run_f64(case):
    """The port's train-mode forward, scm_loss and gradients in float64:
    the reference for the port's own float32 rounding error (BatchNorm
    keeps its statistics in float32)."""
    m = sm.build_model(case["cfg"], device="cpu").double()
    m.load_state_dict({k: v.double() for k, v in params_from_flax(
        case["params"], case["stats"]).items()})
    # EdgeSeqModel rounds its parameters for any dtype but float32
    kw = {"params_rounded": True} if case["cfg"].rep_net == "CNN" else {}
    out = m(*case["tb"], train=True, dtype=torch.float64, **kw)
    losses = tloss(out, *(torch.from_numpy(case[k]).double()
                          for k in ("counts", "nw", "ew")), **LOSS_KW)
    losses["total"].backward()
    return out, losses, {k: p.grad for k, p in m.named_parameters()}


OUTPUTS = ("pred_c", "pred_v", "pred_e", "p_v_rep", "p_e_rep", "g_v_rep",
           "g_e_rep")


def check_model_f32(case):
    """params_from_flax takes every leaf; no prediction mask has a pad
    key. Per tensor (the outputs, the loss, every gradient), the port's
    float32 result lies within the usual bound of the JAX package's
    (tests/test_torch_scm_model.py: outputs 1e-5 of the largest magnitude
    plus 1e-6, the loss 1e-5 relative, gradients 1e-4 of the largest
    magnitude plus 1e-5 of the largest gradient) plus twice the port's
    own float32 error, its distance to its float64 run: the sparsemax
    weights are differences z - tau of scores of ~10, so each package's
    float32 outputs sit up to ~1e-3 of their largest magnitude from the
    float64 result at infer_steps 2 (the JAX package's as far as the
    port's). The updated BatchNorm statistics to 1e-5 relative."""
    sd = params_from_flax(case["params"], case["stats"])
    assert len(sd) == len(jax.tree.leaves(case["params"])) + len(
        jax.tree.leaves(case["stats"]))
    assert set(sd) == set(sm.build_model(case["cfg"], device="cpu",
                                         seed=3).state_dict())
    jout, jl, jg, jstats = rn.jax_run(case, case, amp=False, train=True)
    tout, tl, tg, m = rn.port_run(case, case, amp=False, train=True)
    xout, xl, xg = port_run_f64(case)

    def held(got, want, exact, rel, floor, name):
        got, want, exact = (x.detach().double().numpy() if torch.is_tensor(x)
                            else np.asarray(x, np.float64)
                            for x in (got, want, exact))
        assert got.shape == want.shape, name
        err, own = np.abs(got - want).max(), np.abs(got - exact).max()
        assert err <= rel * np.abs(want).max() + floor + 2 * own, (
            name, err, own)

    for key in OUTPUTS + ("p_v_mask", "p_e_mask", "g_v_mask", "g_e_mask"):
        if jout[key] is None:
            assert tout[key] is None, key
        elif key.endswith("mask"):
            assert bool(tout[key].all()) and bool(np.all(jout[key])), key
        else:
            held(tout[key], jout[key], xout[key], 1e-5, 1e-6, key)
    for k in jl:
        held(tl[k], jl[k], xl[k], 1e-5, 0.0, k)
    assert set(tg) == set(jg) and all(g is not None for g in tg.values())
    gmax = max(float(v.abs().max()) for v in jg.values())
    for k in jg:
        held(tg[k], jg[k], xg[k], 1e-4, 1e-5 * gmax, k)
    sdm = m.state_dict()
    for k, v in params_from_flax({}, jstats).items():
        np.testing.assert_allclose(sdm[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def check_model_amp(case):
    """Per AMP_DRAWS weight draws, the port's amp distance to the JAX
    float32 result over the JAX package's own amp distance (test_torch_
    scm_rep_nets.amp_ratios): the geometric mean over the draws at most
    AMP_RATIO for the predictions, the loss and the gradients."""
    draws = [rn.amp_ratios(case, w) for w in case["draws"]]
    for name in ("preds", "loss", "grads"):
        r = np.array([d[name] for d in draws])
        assert np.exp(np.log(r).mean()) <= AMP_RATIO, (name, r)


MODEL_CASES = [(net, rep, steps) for net in NETS
               for rep in ("DMPNN", "CNN") for steps in (1, 2)]
# amp: the three nets over DMPNN, which computes them in bf16, and one
# over CNN, whose float32 gates keep them in float32 on bf16-rounded
# parameters (models/edgeseq.py); each case compiles another JAX program
AMP_CASES = [(net, "DMPNN", 1) for net in NETS] + [
    ("MeanAttnPredictNet", "CNN", 1)]


@pytest.mark.parametrize("net, rep, steps", MODEL_CASES)
def test_attn_nets_in_models_match_jax(net, rep, steps):
    """f32: outputs, loss, every gradient and params_from_flax's leaves;
    for AMP_CASES, amp bf16 against the JAX package's own amp error."""
    case = attn_case(net, rep, steps)
    check_model_f32(case)
    if (net, rep, steps) in AMP_CASES:
        check_model_amp(case)


def test_params_from_flax_maps_every_attention_leaf():
    """Every leaf of the Attn net's flax tree (p_attn and g_attn:
    weight_q/k/v/o, g_kernel, g_bias), and a DotAttention's LayerNorm
    scales and biases, lands on the port's parameter of its path."""
    case = attn_case("SumAttnPredictNet", "DMPNN", 1)
    m = sm.build_model(case["cfg"], device="cpu", seed=1)
    m.load_state_dict(params_from_flax(case["params"]), strict=True)
    sd = m.state_dict()
    names = set()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            case["params"])[0]:
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(leaf))
        names.add(key.split(".")[-1])
    assert {"weight_q", "weight_k", "weight_v", "weight_o", "g_kernel",
            "g_bias"} <= names
    for pred in ("pred_net_v", "pred_net_e"):
        assert {k.split(".")[1] for k in sd if k.startswith(pred)} >= {
            "p_attn", "g_attn"}
    _, params, tm = attn_modules(*ATTN_CASES["everything"],
                                 np.random.default_rng(0))
    sd = tm.state_dict()
    for path, leaf in jax.tree_util.tree_flatten_with_path(
            params["params"])[0]:
        key = ".".join(p.key for p in path)
        np.testing.assert_array_equal(sd[key].numpy(), np.asarray(leaf))
    assert {k.rsplit(".", 1)[0] for k in sd if "layer_norm" in k} == {
        "q_layer_norm", "k_layer_norm", "v_layer_norm", "o_layer_norm"}


def test_train_step_matches_jax():
    """One make_train_step (f32, LR multiplier 0.5) of MeanAttnPredictNet
    over DMPNN: the losses and every parameter after the update."""
    case = attn_case("MeanAttnPredictNet", "DMPNN", 1)
    jp, jgr = case["jb"]
    counts, nw, ew = (case[k] for k in ("counts", "nw", "ew"))
    scal = (0.2, 0.1, 0.05, 0.0)
    tx = jdrv.make_optimizer(lr=1e-2)
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), case["params"])
    state = jdrv.TrainState.create({"params": params}, tx)
    jstep = jdrv.make_train_step(case["jm"], tx, return_weights="nodeedge",
                                 eval_metric="MAE")
    state, jlosses = jstep(state, jp, jgr, jnp.asarray(counts),
                           jnp.asarray(nw), jnp.asarray(ew),
                           *map(jnp.float32, scal), jnp.float32(0.5),
                           jax.random.PRNGKey(0))
    m = sm.build_model(case["cfg"], device="cpu")
    m.load_state_dict(params_from_flax(case["params"]))
    step = tdrv.make_train_step(m, tdrv.make_optimizer(m.parameters(), 1e-2),
                                return_weights="nodeedge",
                                eval_metric="MAE")
    tlosses = step(*case["tb"], torch.from_numpy(counts),
                   torch.from_numpy(nw), torch.from_numpy(ew), *scal, 0.5)
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = params_from_flax(state.params)
    for k, p in m.named_parameters():
        close_to_max(p, want[k].numpy(), 1e-5, k, 1e-6)


def test_cli_epoch_finetune_and_evaluate(tmp_path):
    """cli/scm_train with --pred_net SumAttnPredictNet for one epoch on
    --device cpu, a finetune onto a larger vocabulary, then scm_evaluate
    of the first run: finite metrics, and scm_evaluate's dev metrics
    equal the training log's."""
    base = TINY + ["--pred_net", "SumAttnPredictNet", "--pred_num_heads",
                   "2", "--train_epochs", "1"]
    d1 = ttrain.main(base + VOCAB2 + ["--save_model_dir",
                                      str(tmp_path / "a")])
    assert os.path.basename(d1).startswith("DMPNN_SumAttnPredictNet_")
    d2 = ttrain.main(base + ["--max_npvl", "5", "--max_npel", "5",
                             "--max_ngvl", "5", "--max_ngel", "5",
                             "--load_model_dir", d1,
                             "--save_model_dir", str(tmp_path / "b")])
    assert "finetuning from" in open(os.path.join(d2, "log.txt")).read()
    for d in (d1, d2):
        res = json.load(open(os.path.join(d, "dev_results0.json")))
        assert all(np.isfinite(res[k]) for k in ("MAE", "MSE", "MNED",
                                                 "MEED"))
    out = teval.main(["--load_model_dir", d1, "--device", "cpu"])
    logged = json.load(open(os.path.join(d1, "dev_results0.json")))
    for k in ("MAE", "MSE", "RMSE", "MNED", "MEED"):
        assert out["dev"][k] == pytest.approx(logged[k], rel=1e-6), k
