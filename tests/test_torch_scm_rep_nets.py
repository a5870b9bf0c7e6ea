"""The port's SCM graph networks CompGCN (models/compgcn.py), R-GCN and
R-GIN (models/rgnn.py, over models/basemodel.GraphAdjModel) against the
JAX package on the CPU, with random weights of the JAX model's shapes
(random_variables) carried across by params_from_flax.

  * The stacks alone, over the options: CompGCN comp_opt sub/mult/corr x
    edge_norm none/in/out/both, and with BatchNorm in train mode;
    R-GCN regularizer bdd/basis (num_bases 3 < R = 8)/none x edge_norm
    none/in/out/both, and with BatchNorm; R-GIN num_mlp_layers 0 and 2,
    with and without BatchNorm. Outputs on valid rows within 1e-5 of the
    largest magnitude, every gradient (parameters and inputs) within 1e-4
    of its tensor's largest magnitude plus 1e-5 of the largest gradient,
    the updated BatchNorm statistics to 1e-5 relative.
  * The models at the flagship's options (tests/test_torch_scm_data.
    small_config): pred_c, pred_v, pred_e and every rep within 1e-5 of
    the largest magnitude, scm_loss within 1e-5 relative, every gradient
    as above (tests/test_torch_scm_model.py's bounds).
  * amp bf16 against the JAX package's own amp error on the same batch,
    over AMP_DRAWS = 4 weight draws: per draw, the port's L2 distance to
    JAX's float32 result over JAX's own amp distance, for the
    predictions (pred_c, pred_v, pred_e on valid rows), the loss (its
    denominator plus 2**-8 of the float32 loss) and all the gradients;
    the geometric mean of each over the draws at most 1.5. One draw's
    ratio is not held: both packages round to bf16, at different places
    (XLA on the CPU also keeps bf16 chains in float32 where it may,
    --xla_allow_excess_precision), and in a 6-pair batch a hidden unit
    that crosses relu's kink moves a head's gradient by a sixth, so
    single-draw ratios run from near 0 to ~3 either way. Over 12 draws
    per network (this file run as a script with --draws 12 prints them), each group of 4 gave geometric means of at most 1.36
    (R-GIN predictions), single draws up to 3.27 (R-GIN loss); LRP and
    DMPLRP at most 0.75 (the JAX package sums their pools and gathers in
    bf16).
  * Edge labels outside [0, R) take no relation, as in the JAX scan.
  * K3's calls (the plain version's, on the CPU) per eval forward and per
    train step equal models/scm_models.k3_launches, which chip_smoke.py
    checks on the card; a rematerialised stack gives the same gradients
    and BatchNorm statistics, with dropout drawn from the same generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu.data.lrp import count_perms as jcount
from dualmessagepassing_tpu.data.lrp import record_to_lrp_perms as jperms
from dualmessagepassing_tpu.models import compgcn as jcg
from dualmessagepassing_tpu.models import lrp as jlrp
from dualmessagepassing_tpu.models import rgnn as jrg
from dualmessagepassing_tpu.train.losses import scm_loss as jloss
from dualmessagepassing_tpu.utils.amp import cast_floats, compute_dtype_scope
from dualmessagepassing_tpu_torch.data.dataset import lrp_batch
from dualmessagepassing_tpu_torch.models import compgcn as tcg
from dualmessagepassing_tpu_torch.models import rgnn as trg
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.models.scm_models import params_from_flax
from dualmessagepassing_tpu_torch.ops import scatter as tsc
from dualmessagepassing_tpu_torch.train.scm_driver import apply_model

from test_torch_scm_amp import remat_matches_plain
from test_torch_scm_data import (GRAPH_FIELDS, batches, jax_config,
                                 make_records, small_config)
from test_torch_scm_model import LOSS_KW, REPS, _rows
from test_torch_scm_model import port_run as tm_port_run
from test_torch_scm_ops import assert_grads, close_to_max

PERM_FIELDS = ("perm_node", "perm_node_mask", "perm_edge", "perm_edge_mask",
               "perm_owner", "perm_mask")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are tiny and the test workers share
    the CPU's cores (tests/test_torch_scm_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# shared with tests/test_torch_scm_lrp.py
# ---------------------------------------------------------------------------

def lrp_batches(pats, gras, jb, tb, seq_len=4):
    """The (JAX, port) batch pairs lifted to LRP batches: each record's
    perm tables (the JAX package's enumeration) at the batch's largest
    perm count."""
    out_j, out_t = [], []
    for recs, j, t in zip((pats, gras), jb, tb):
        p_max = max(jcount(r, seq_len) for r in recs) or 1
        rows = [jperms(r, seq_len, p_max) for r in recs]
        out_j.append(jlrp.LRPGraphBatch(
            **{f: getattr(j, f) for f in GRAPH_FIELDS},
            **{k: jnp.asarray(np.stack([r[k] for r in rows]))
               for k in PERM_FIELDS}))
        out_t.append(lrp_batch(t, [{k: r[k] for k in PERM_FIELDS}
                                   for r in rows]))
    return tuple(out_j), tuple(out_t)


_CASES = {}
# the amp rule's weight draws (module docstring)
AMP_DRAWS = 4


def family_case(net: str, bsz: int = 6, seed: int = 4, **kw):
    """tests/test_torch_scm_model.make_case for cfg.rep_net = net (the
    flagship's options, small_config), once per process: the JAX model,
    a batch (LRP batches for LRP and DMPLRP), targets, and weights of the
    JAX model's shapes (random_variables; tracing the init compiles
    nothing), draw 0 of the rng seeded with `seed`."""
    key = (net, bsz, seed, tuple(sorted(kw.items())))
    if key in _CASES:
        return _CASES[key]
    cfg = small_config(rep_net=net, **kw)
    jm = jbuild(jax_config(cfg))
    pats, gras = make_records(bsz, 4, 4, 12, 24, 4, 4, seed=seed)
    jb, tb = batches(pats, gras)
    if net in ("LRP", "DMPLRP"):
        jb, tb = lrp_batches(pats, gras, jb, tb, cfg.lrp_seq_len)
    rng = np.random.default_rng(seed)
    case = dict(cfg=cfg, jm=jm, jb=jb, tb=tb, rng=rng, fns={},
                shapes=jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jb),
                counts=rng.poisson(3.0, (bsz, 1)).astype(np.float32),
                nw=rng.poisson(1.0, (bsz, 12)).astype(np.float32),
                ew=rng.poisson(1.0, (bsz, 48)).astype(np.float32))
    case["draws"] = [draw_weights(case) for _ in range(AMP_DRAWS)]
    case.update(case["draws"][0])
    _CASES[key] = case
    return case


def draw_weights(case):
    shapes, rng = case["shapes"], case["rng"]
    return dict(params=random_variables(shapes["params"], rng),
                stats=random_variables(shapes.get("batch_stats", {}), rng))


def jax_run(case, weights, amp: bool, train: bool):
    """(outputs, losses, parameter gradients, updated batch stats) of the
    JAX model on `weights`, as tests/test_torch_scm_model.jax_run
    computes them; one compiled program per (case, amp, train), the
    weights its arguments."""
    if (amp, train) not in case["fns"]:
        case["fns"][(amp, train)] = jax.jit(_jax_grads(case, amp, train))
    grads, (out, losses, mut) = case["fns"][(amp, train)](
        weights["params"], weights["stats"])
    return (out, losses, params_from_flax(grads),
            mut.get("batch_stats", {}))


def _jax_grads(case, amp, train):
    jm, jb = case["jm"], case["jb"]
    counts, nw, ew = (jnp.asarray(case[k]) for k in ("counts", "nw", "ew"))

    def loss_fn(params, stats):
        variables = {"params": params}
        if stats:
            variables["batch_stats"] = stats
        if amp:
            with compute_dtype_scope(jnp.bfloat16):
                out, mut = jm.apply(
                    {**variables, "params": cast_floats(params,
                                                        jnp.bfloat16)},
                    *jb, train=train, mutable=["batch_stats"])
            out = cast_floats(out, jnp.float32)
        else:
            out, mut = jm.apply(variables, *jb, train=train,
                                mutable=["batch_stats"])
        losses = jloss(out, counts, nw, ew, **LOSS_KW)
        return losses["total"], (out, losses, mut)

    return jax.grad(loss_fn, has_aux=True)


def port_run(case, weights, amp: bool, train: bool):
    return tm_port_run(dict(case, **weights), amp=amp, train=train)


def check_model_f32(case, train=True):
    """params_from_flax takes every leaf; forward, loss and every
    gradient against the JAX model (tests/test_torch_scm_model.py's
    bounds)."""
    sd = params_from_flax(case["params"], case["stats"])
    assert len(sd) == len(jax.tree.leaves(case["params"])) + len(
        jax.tree.leaves(case["stats"]))
    assert set(sd) == set(sm.build_model(case["cfg"], device="cpu",
                                         seed=3).state_dict())
    jout, jl, jg, jstats = jax_run(case, case, amp=False, train=train)
    tout, tl, tg, m = port_run(case, case, amp=False, train=train)
    for key in ("pred_c", "pred_v", "pred_e") + REPS:
        if jout[key] is None:
            assert tout[key] is None, key
            continue
        got, mask = _rows(tout, key)
        want = np.asarray(jout[key])
        if mask is not None:
            got, want = got.detach().numpy()[mask.numpy()], want[
                mask.numpy()]
        close_to_max(got, want, 1e-5, key)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert set(tg) == set(jg) and all(g is not None for g in tg.values())
    gmax = max(float(v.abs().max()) for v in jg.values())
    for k in jg:
        close_to_max(tg[k], jg[k].numpy(), 1e-4, k, 1e-5 * gmax)
    sdm = m.state_dict()
    for k, v in params_from_flax({}, jstats).items():
        np.testing.assert_allclose(sdm[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


def amp_ratios(case, weights):
    """The port's distance to the JAX float32 result over JAX's own amp
    distance, in L2, for the predictions (valid rows), the loss and all
    the gradients, on one weight draw."""
    f_out, f_l, f_g, _ = jax_run(case, weights, amp=False, train=True)
    a_out, a_l, a_g, _ = jax_run(case, weights, amp=True, train=True)
    t_out, t_l, t_g, _ = port_run(case, weights, amp=True, train=True)
    assert all(t_g[k].dtype == torch.float32 for k in t_g)

    def preds(out, numpy):
        rows = []
        for key in ("pred_c", "pred_v", "pred_e"):
            if f_out[key] is None:
                continue
            mask = _rows(t_out, key)[1]
            sel = (slice(None),) if mask is None else (mask.numpy(),)
            x = out[key].detach().numpy() if numpy else np.asarray(out[key])
            rows.append(np.asarray(x, np.float32)[sel].ravel())
        return np.concatenate(rows)

    def ratio(port, own, f32, floor=0.0):
        def dist(a):      # in float64: the squares overflow float32
            return float(np.sqrt(sum(
                ((np.asarray(a[k], np.float64) - f32[k]) ** 2).sum()
                for k in f32)))
        num, den = dist(port), dist(own)
        assert np.isfinite(num)
        return num / (den + floor)

    f32 = {"p": preds(f_out, False)}
    return {"preds": ratio({"p": preds(t_out, True)},
                           {"p": preds(a_out, False)}, f32),
            "loss": ratio({"l": np.float32(t_l["total"].item())},
                          {"l": np.float32(a_l["total"])},
                          {"l": np.float32(f_l["total"])},
                          2 ** -8 * abs(float(f_l["total"]))),
            "grads": ratio({k: v.numpy() for k, v in t_g.items()},
                           {k: v.numpy() for k, v in a_g.items()},
                           {k: v.numpy() for k, v in f_g.items()})}


def check_model_amp(case):
    """The port's amp error against JAX's own over AMP_DRAWS weight draws
    (the rule in the module docstring)."""
    draws = [amp_ratios(case, w) for w in case["draws"]]
    for name in ("preds", "loss", "grads"):
        r = np.array([d[name] for d in draws])
        assert np.exp(np.log(r).mean()) <= 1.5, (name, r)


def count_k3_calls(cfg, tb, monkeypatch):
    """(K3 calls of one eval forward, of one train forward and backward)
    of the port's model on the CPU batch tb."""
    calls = []
    real = tsc.segment_sum_unsorted

    def spy(msg, receivers, num_nodes):
        calls.append(msg.shape)
        return real(msg, receivers, num_nodes)

    monkeypatch.setattr(tsc, "segment_sum_unsorted", spy)
    m = sm.build_model(cfg, device="cpu")
    with torch.no_grad():
        apply_model(m, *tb)
    n_eval = len(calls)
    calls.clear()
    out = apply_model(m, *tb, train=True)
    loss = out["pred_c"].sum() + out["pred_v"].sum()
    if out["pred_e"] is not None:
        loss = loss + out["pred_e"].sum()
    loss.backward()
    return n_eval, len(calls)


# ---------------------------------------------------------------------------
# the stacks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def graphs():
    pats, gras = make_records(6, 4, 4, 12, 24, 4, 4, seed=3)
    (_, jgr), (_, tgr) = batches(pats, gras)
    rng = np.random.default_rng(7)
    arrays = {
        "v": rng.normal(size=(6, 12, 16)).astype(np.float32),
        "e": rng.normal(size=(6, 48, 16)).astype(np.float32),
        "cot_v": rng.normal(size=(6, 12, 16)).astype(np.float32),
        "cot_e": rng.normal(size=(6, 48, 16)).astype(np.float32),
        "v_gate": tgr.node_mask.numpy().astype(np.float32)[..., None],
        "e_gate": tgr.edge_mask.numpy().astype(np.float32)[..., None]}
    return jgr, tgr, arrays


def random_variables(shapes, rng):
    """Weights for a tree of shapes (jax.eval_shape of an init, which
    compiles nothing): N(0, 1/sqrt(fan_in)) kernels, N(0, 0.1) biases and
    running means, BatchNorm scales and running variances 1 + |N(0,
    0.1)|."""
    def f(path, leaf):
        name = path[-1].key
        if name in ("scale", "var"):
            x = 1.0 + np.abs(rng.normal(0, 0.1, leaf.shape))
        elif len(leaf.shape) < 2:
            x = rng.normal(0, 0.1, leaf.shape)
        else:
            x = rng.normal(0, leaf.shape[-2] ** -0.5, leaf.shape)
        return jnp.asarray(x.astype(np.float32))
    return jax.tree_util.tree_map_with_path(f, shapes)


def check_stack(jmod, tmod, graph_pair, arrays, with_edges, train, seed,
                gated=True):
    """jmod (flax) and tmod (the port's) on the same batch, inputs (and
    gates, where gated) and random weights: outputs on valid rows, the
    vjp of random cotangents (every parameter and both inputs) and the
    updated BatchNorm statistics."""
    jgr, tgr = graph_pair
    rng = np.random.default_rng(seed)
    names = ("v", "e") if with_edges else ("v",)
    gates = (("v_gate", "e_gate") if with_edges else ("v_gate",)) \
        if gated else ()
    x = [jnp.asarray(arrays[n]) for n in names]
    g = [jnp.asarray(arrays[n]) for n in gates]
    v = jax.eval_shape(lambda: jmod.init(jax.random.PRNGKey(1), jgr, *x,
                                         *g))
    params = random_variables(v["params"], rng)
    stats = random_variables(v.get("batch_stats", {}), rng)

    def f(p, *inputs):
        variables = {"params": p}
        if stats:
            variables["batch_stats"] = stats
        out, mut = jmod.apply(variables, jgr, *inputs, *g, train=train,
                              mutable=["batch_stats"])
        return out, mut.get("batch_stats", {})

    def run(p, c, *a):
        out, vjp, new_stats = jax.vjp(f, p, *a, has_aux=True)
        return out, new_stats, vjp(c)

    cot = tuple(jnp.asarray(arrays["cot_" + n]) for n in names)
    jout, jstats, jgrads = jax.jit(run)(
        params, cot if with_edges else cot[0], *x)

    tmod.load_state_dict(params_from_flax(params, stats))
    xt = [torch.from_numpy(arrays[n]).requires_grad_() for n in names]
    gt = [torch.from_numpy(arrays[n]) for n in gates]
    tout = tmod(tgr, *xt, *gt, train=train)
    tout = tout if with_edges else (tout,)
    jout = jout if with_edges else (jout,)
    masks = (tgr.node_mask.numpy(), tgr.edge_mask.numpy())
    for t, j, msk in zip(tout, jout, masks):
        close_to_max(t.detach().numpy()[msk], np.asarray(j)[msk], 1e-5)
    torch.autograd.backward(tout, [torch.from_numpy(arrays["cot_" + n])
                                   for n in names])
    for t, j, n in zip(xt, jgrads[1:], names):
        close_to_max(t.grad, j, 1e-4, "d " + n)
    assert_grads(tmod, params_from_flax(jgrads[0]))
    sd = tmod.state_dict()
    for k, val in params_from_flax({}, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)


COMPGCN_STACKS = [(c, n, False) for c in ("sub", "mult", "corr")
                  for n in ("none", "in", "out", "both")] + [
                      ("corr", "in", True)]


@pytest.mark.parametrize("comp_opt, edge_norm, batch_norm", COMPGCN_STACKS)
def test_compgcn_stack_matches_jax(graphs, comp_opt, edge_norm,
                                   batch_norm):
    jgr, tgr, arrays = graphs
    kw = dict(comp_opt=comp_opt, edge_norm=edge_norm, batch_norm=batch_norm,
              act="leaky_relu")
    check_stack(jcg.CompGCNStack(num_layers=2, hidden_dim=16, **kw),
                tcg.CompGCNStack(2, 16, 16, **kw), (jgr, tgr), arrays,
                with_edges=True, train=batch_norm, seed=11)


RGCN_STACKS = [(r, n, False) for r in ("bdd", "basis", "none")
               for n in ("none", "in", "out", "both")] + [
                   ("bdd", "in", True)]


@pytest.mark.parametrize("regularizer, edge_norm, batch_norm", RGCN_STACKS)
def test_rgcn_stack_matches_jax(graphs, regularizer, edge_norm, batch_norm):
    jgr, tgr, arrays = graphs
    kw = dict(num_rels=8, regularizer=regularizer, num_bases=3
              if regularizer == "basis" else 4, edge_norm=edge_norm,
              batch_norm=batch_norm, act="leaky_relu")
    check_stack(jrg.RGNNStack(kind="rgcn", num_layers=2, hidden_dim=16, **kw),
                trg.RGNNStack("rgcn", 2, 16, 16, **kw), (jgr, tgr), arrays,
                with_edges=False, train=batch_norm, seed=12)


@pytest.mark.parametrize("num_mlp_layers, batch_norm",
                         [(0, False), (2, False), (2, True)])
def test_rgin_stack_matches_jax(graphs, num_mlp_layers, batch_norm):
    jgr, tgr, arrays = graphs
    kw = dict(num_rels=8, num_mlp_layers=num_mlp_layers,
              batch_norm=batch_norm, act="relu")
    check_stack(jrg.RGNNStack(kind="rgin", num_layers=2, hidden_dim=16, **kw),
                trg.RGNNStack("rgin", 2, 16, 16, **kw), (jgr, tgr), arrays,
                with_edges=False, train=batch_norm, seed=13)


def test_edge_labels_outside_the_relations_are_dropped(graphs):
    """R = 5 relations over labels 0..7: the edges labelled 5-7 take no
    relation in either package; relation_sums puts them nowhere."""
    jgr, tgr, arrays = graphs
    assert int(tgr.edge_label[tgr.edge_mask].max()) >= 5
    kw = dict(num_rels=5, regularizer="none", edge_norm="none",
              act="leaky_relu")
    check_stack(jrg.RGNNStack(kind="rgcn", num_layers=2, hidden_dim=16, **kw),
                trg.RGNNStack("rgcn", 2, 16, 16, **kw), (jgr, tgr), arrays,
                with_edges=False, train=False, seed=14)
    src = torch.ones(6, 48, 1)
    sums = trg.relation_sums(tgr, src, 5)
    keep = tgr.edge_mask & (tgr.edge_label < 5)
    assert sums.shape == (6, 12, 5, 1)
    assert float(sums.sum()) == float(keep.sum())


@pytest.mark.parametrize("kind", ["compgcn", "rgcn"])
def test_layers_without_a_self_loop_match_jax(graphs, kind):
    """self_loop=False, which the stacks never set: CompGCN's update agg
    * 0.5, and the degree norms without their + 1. Nodes of degree 0
    are in the batch: the JAX layers' reciprocal there (CompGCN's 1.0,
    R-GCN's 0.0; the port's 1.0 for both) reaches no output."""
    jgr, tgr, arrays = graphs
    assert bool((tgr.in_degrees() == 0).any())
    if kind == "compgcn":
        kw = dict(self_loop=False, comp_opt="mult", edge_norm="both")
        pair = (jcg.CompGCNLayer(hidden_dim=16, **kw),
                tcg.CompGCNLayer(16, 16, **kw))
    else:
        kw = dict(self_loop=False, regularizer="none", edge_norm="both")
        pair = (jrg.RGCNLayer(hidden_dim=16, num_rels=8, **kw),
                trg.RGCNLayer(16, 16, 8, **kw))
    check_stack(*pair, (jgr, tgr), arrays, with_edges=kind == "compgcn",
                train=False, seed=15, gated=False)


# ---------------------------------------------------------------------------
# the models
# ---------------------------------------------------------------------------

# the stacks above cover the options; the models run the defaults, and
# R-GIN with BatchNorm (train and eval mode)
MODELS = {"CompGCN": {}, "RGCN": {}, "RGIN": {},
          "RGIN-bn": dict(rep_rgin_batch_norm=True)}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_forward_loss_and_gradients_match_jax(name):
    check_model_f32(family_case(name.split("-")[0], **MODELS[name]))


@pytest.mark.parametrize("net", ["CompGCN", "RGCN", "RGIN"])
def test_model_amp_against_jax_amp_error(net):
    check_model_amp(family_case(net))


def test_model_eval_forward_matches_jax():
    """train=False: BatchNorm on its running statistics."""
    check_model_f32(family_case("RGIN", rep_rgin_batch_norm=True),
                    train=False)


K3_VARIANTS = [("CompGCN", {}), ("CompGCN", {"rep_compgcn_edge_norm": "in"}),
               ("CompGCN", {"rep_compgcn_edge_norm": "both",
                            "pred_with_deg": True}),
               ("CompGCN", {"rep_remat": True}),
               ("RGCN", {}), ("RGCN", {"rep_rgcn_edge_norm": "both"}),
               ("RGCN", {"rep_rgcn_edge_norm": "none", "rep_remat": True,
                         "share_rep_net": False}),
               ("RGIN", {}), ("RGIN", {"pred_with_deg": True,
                                       "rep_num_graph_layers": 3})]


@pytest.mark.parametrize("net, kw", K3_VARIANTS)
def test_k3_calls_equal_the_derived_count(net, kw, monkeypatch):
    cfg = small_config(rep_net=net, **kw)
    pats, gras = make_records(4, 4, 4, 12, 24, 4, 4, seed=5)
    _, tb = batches(pats, gras)
    assert count_k3_calls(cfg, tb, monkeypatch) == (
        sm.k3_launches(cfg, train=False), sm.k3_launches(cfg, train=True))


@pytest.mark.parametrize("net", ["CompGCN", "RGCN", "RGIN"])
def test_remat_gives_the_same_gradients(net):
    """The rematerialised stack against the plain one: without dropout,
    and with rep_dropout 0.1 and the family's BatchNorm (tests/
    test_torch_scm_amp.remat_matches_plain: gradients, statistics, the
    generator's state)."""
    pats, gras = make_records(4, 4, 4, 12, 24, 4, 4, seed=6)
    _, tb = batches(pats, gras)
    bn = {"CompGCN": "rep_compgcn_batch_norm", "RGCN": "rep_rgcn_batch_norm",
          "RGIN": "rep_rgin_batch_norm"}[net]
    for kw in ({}, {"rep_dropout": 0.1, bn: True}):
        _, stats = remat_matches_plain(
            small_config(rep_net=net, **kw), tb,
            lambda out: out["pred_c"].sum() + out["pred_v"].square().sum())
    assert any(k.endswith("running_mean") for k in stats)


if __name__ == "__main__":
    # the amp ratios over more weight draws than the tests hold, from the
    # repository's root: PYTHONPATH=.:$PYTHONPATH python \
    #     tests/test_torch_scm_rep_nets.py --draws 12
    import argparse

    import conftest  # noqa: F401  (jax on the CPU, highest precision)

    args = argparse.ArgumentParser()
    args.add_argument("--draws", type=int, default=12)
    args.add_argument("--nets", default="CompGCN,RGCN,RGIN,LRP,DMPLRP")
    args = args.parse_args()
    AMP_DRAWS = args.draws
    torch.set_num_threads(1)
    for net in args.nets.split(","):
        case = family_case(net)
        ratios = [amp_ratios(case, w) for w in case["draws"]]
        for name in ("preds", "loss", "grads"):
            r = np.array([x[name] for x in ratios])
            groups = [np.exp(np.log(r[i:i + 4]).mean())
                      for i in range(0, len(r) - 3, 4)]
            print(f"{net} {name}: geometric means per 4 draws "
                  f"{np.round(groups, 2).tolist()}, single draws "
                  f"{np.round(r, 2).tolist()}", flush=True)
