"""The port's memory predict nets (models/pred_attn.py: window_selection,
window_bounds, init_mem_static, WindowLSTMMem, MemDotAttention, the
Mean/Sum/MaxMemAttnPredictNet and DIAMNet) against the JAX package on
the CPU, with random weights of the JAX modules' shapes carried across
by params_from_flax.

  * window_selection and window_bounds equal the JAX package's exactly,
    on tests/test_pred_attn.py's seven (l, mem_len, circular) cases and
    on batches of mixed lengths (l < M, l = M, l = L); nothing the port
    builds on the way has the JAX package's [B, M, Lv, L] one-hot shape.
  * init_mem_static for the eight pooling and attention inits at mixed
    lengths: values and the gradients of random cotangents within rtol
    1e-5 / atol 1e-6. The attn inits with a DotAttention are held, slot
    by slot, to the JAX package's DotAttention run on that slot's window
    keys alone (each position once) with no mask: the JAX package's own
    window attention masks with +1e30 and so reads keys outside the
    window (test_jax_window_attention_reads_keys_outside_its_window);
    the softmax fallback without a module against the JAX package's.
  * WindowLSTMMem at mixed lengths, empty slots among them, circular
    and not: values and gradients within the same bounds; the empty
    slots are zero rows whose gradients are finite and zero.
  * Each memory net inside GraphAdjModelV2 over DMPNN (nodeedge) and
    inside EdgeSeqModel over CNN (edge), infer_steps 1, over all ten
    mem_inits (MODEL_CASES), on batches in which every pattern and graph
    has at least mem_len elements and no key is padded (mem_len 1 for
    the attn inits, whose window is then the whole sequence): outputs,
    scm_loss and every gradient in f32 within
    tests/test_torch_scm_pred_attn.py's bounds (the usual ones plus twice
    the port's own float32 error), and under amp bf16 (AMP_CASES) the
    port's distance to the JAX f32 result over the JAX package's own amp
    distance, the geometric mean over AMP_DRAWS weight draws at most
    AMP_RATIO.
  * params_from_flax over every memory leaf: proj_k/v, mem_attn,
    mem_lstm_k/v.cell.*, DIAMNet's mem_layer as a DotAttention, an LSTM
    cell and a Dense, m_attn, p_fc, g_fc, weight_fc1/2.
  * One make_train_step of DIAMNet against the JAX step, both in the
    same two chunks (its weight head divides by the chunk's largest
    pattern length), and a tiny command-line epoch with --pred_net
    DIAMNet --pred_mem_init circular_lstm, its finetune and
    scm_evaluate.
"""

import json
import os

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu import graph as jg
from dualmessagepassing_tpu.models import pred_attn as jattn
from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch.cli import scm_evaluate as teval
from dualmessagepassing_tpu_torch.cli import scm_train as ttrain
from dualmessagepassing_tpu_torch.models import pred_attn as tattn
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.models.scm_models import params_from_flax
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv

import test_torch_scm_edgeseq as es
import test_torch_scm_pred_attn as pa
import test_torch_scm_rep_nets as rn
from test_torch_scm_cli import TINY, VOCAB2
from test_torch_scm_data import jax_config, small_config
from test_torch_scm_ops import close_to_max, jit_vjp

# tests/test_pred_attn.py's (l, mem_len, circular) cases
WINDOW_CASES = [(10, 4, False), (3, 4, False), (4, 4, False),
                (16, 4, False), (10, 4, True), (3, 4, True), (7, 3, True)]
# a batch of mixed lengths at L = 10, M = 4: l < M (empty slots), l = M,
# l = L, and between
MIXED = np.array([10, 7, 2, 4])
SEQ_LEN, MEM_LEN, WIDTH = 10, 4, 6
# the window attention's module: DIAMNet's mem_layer (pred_attn.py:
# 454-458), 2 heads here
WIN_KW = dict(hidden_dim=8, num_heads=2, scale=0.5, score_func="sparsemax",
              add_gate=True, param_init="identity")


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are tiny and the test workers share
    the CPU's cores (tests/test_torch_scm_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the windows
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lengths, mem_len, circular", [
    ([l], m, c) for l, m, c in WINDOW_CASES] + [
    (list(MIXED), MEM_LEN, False), (list(MIXED), MEM_LEN, True)])
def test_window_selection_matches_jax(lengths, mem_len, circular):
    """The counts, the slot mask and the windows' starts and kernels,
    exactly, at L = 20 (10 for the mixed batches)."""
    seq_len = 20 if len(lengths) == 1 else SEQ_LEN
    lens = np.asarray(lengths)
    jsel, jmask = jattn.window_selection(jnp.asarray(lens), seq_len,
                                         mem_len, circular)
    tsel, tmask = tattn.window_selection(torch.from_numpy(lens), seq_len,
                                         mem_len, circular)
    np.testing.assert_array_equal(tsel.numpy(), np.asarray(jsel))
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    for want, got in zip(
            jattn.window_bounds(jnp.asarray(lens), mem_len, circular),
            tattn.window_bounds(torch.from_numpy(lens), mem_len, circular)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


class _Shapes(TorchDispatchMode):
    """Records the shape of every tensor an operation returns."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        self.shapes.update(tuple(t.shape) for t in tree_flatten(out)[0]
                           if isinstance(t, torch.Tensor))
        return out


@pytest.mark.parametrize("circular", [False, True])
def test_no_one_hot_over_the_virtual_sequence(circular):
    """No tensor of the port's window code (window_selection, every
    init_mem_static, forward and backward) ends in the JAX package's
    one-hot axes [.., Lv, L] (pred_attn.py:170-173)."""
    lv = tattn.virtual_len(SEQ_LEN, circular)
    x, mask = mixed_inputs(np.random.default_rng(0))
    tx = torch.from_numpy(x).requires_grad_()
    attn = tattn.DotAttention(WIDTH, WIDTH, WIDTH, 8, 2, add_gate=True)
    lstm = tattn.WindowLSTMMem(WIDTH, 5, MEM_LEN, circular)
    prefix = "circular_" if circular else ""
    with _Shapes() as seen:
        tattn.window_selection(torch.from_numpy(MIXED), SEQ_LEN, MEM_LEN,
                               circular)
        for base in ("mean", "sum", "max", "attn", "lstm"):
            mem, _ = tattn.init_mem_static(
                tx, torch.from_numpy(mask), MEM_LEN, prefix + base,
                attn=attn, lstm=lstm)
            mem.sum().backward()
    assert seen.shapes and not any(
        len(s) >= 3 and s[-2:] == (lv, SEQ_LEN) for s in seen.shapes)


# ---------------------------------------------------------------------------
# init_mem_static and WindowLSTMMem
# ---------------------------------------------------------------------------

def mixed_inputs(rng):
    x = rng.normal(size=(len(MIXED), SEQ_LEN, WIDTH)).astype(np.float32)
    mask = np.arange(SEQ_LEN)[None, :] < MIXED[:, None]
    return x, mask


class _WindowAttn(fnn.Module):
    """The JAX package's init_mem_static with a DotAttention, as a flax
    module (its parameters under mem_layer)."""
    mem_init: str

    @fnn.compact
    def __call__(self, x, mask):
        return jattn.init_mem_static(
            x, mask, MEM_LEN, self.mem_init,
            attn=jattn.DotAttention(name="mem_layer", **WIN_KW))[0]


def window_attn_modules(mem_init, rng, x, mask):
    """(the flax wrapper, its random weights, the port's DotAttention
    with them)."""
    jm = _WindowAttn(mem_init)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0),
                            jnp.asarray(x), jnp.asarray(mask))
    params = rn.random_variables(shapes, rng)
    kw = {k: v for k, v in WIN_KW.items() if k != "hidden_dim"}
    tm = tattn.DotAttention(WIDTH, WIDTH, WIDTH, WIN_KW["hidden_dim"], **kw)
    tm.load_state_dict(params_from_flax(params["params"]["mem_layer"]),
                       strict=True)
    return jm, params, tm


def per_window_attention(params, x, sel):
    """Slot by slot, the JAX package's DotAttention run with the window's
    mean (positions counted as often as the window holds them) as the
    query and the window's keys alone, each position once, without a
    mask; an empty slot zero."""
    attn = jattn.DotAttention(**WIN_KW)
    p = {"params": params["params"]["mem_layer"]}
    rows = []
    for b in range(sel.shape[0]):
        for k in range(sel.shape[1]):
            idx = np.flatnonzero(sel[b, k])
            if not len(idx):
                rows.append(jnp.zeros((WIDTH,), x.dtype))
                continue
            keys = x[b, idx][None]
            q = (jnp.asarray(sel[b, k, idx]) @ x[b, idx]) / sel[b, k].sum()
            rows.append(attn.apply(p, q[None, None], keys, keys)[0, 0])
    return jnp.stack(rows).reshape(sel.shape[0], sel.shape[1], WIDTH)


INITS = ["mean", "sum", "max", "attn"]


@pytest.mark.parametrize("mem_init", INITS + [f"circular_{b}"
                                              for b in INITS])
def test_init_mem_static_matches_jax(mem_init):
    """Values and the vjp of random cotangents (the input and, for the
    window attention, its parameters), rtol 1e-5 / atol 1e-6; the attn
    inits once with a DotAttention (against per_window_attention) and
    once with the softmax fallback (against the JAX package's)."""
    rng = np.random.default_rng(INITS.index(mem_init.split("_")[-1]))
    x, mask = mixed_inputs(rng)
    cot = rng.normal(size=(len(MIXED), MEM_LEN, WIDTH)).astype(np.float32)
    runs = [None, "module"] if mem_init.endswith("attn") else [None]
    for with_module in runs:
        tx = torch.from_numpy(x).requires_grad_()
        if with_module:
            circular = mem_init.startswith("circular")
            sel = np.asarray(jattn.window_selection(
                jnp.asarray(MIXED), SEQ_LEN, MEM_LEN, circular)[0])
            _, params, tm = window_attn_modules(mem_init, rng, x, mask)
            jout, (jgp, jgx) = jit_vjp(
                lambda p, a: per_window_attention(p, a, sel),
                (params, jnp.asarray(x)), jnp.asarray(cot))
        else:
            jout, (jgx,) = jit_vjp(
                lambda a: jattn.init_mem_static(a, jnp.asarray(mask),
                                                MEM_LEN, mem_init)[0],
                (jnp.asarray(x),), jnp.asarray(cot))
            tm = None
        tout, tmask = tattn.init_mem_static(tx, torch.from_numpy(mask),
                                            MEM_LEN, mem_init, attn=tm)
        np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                                   rtol=1e-5, atol=1e-6, err_msg=mem_init)
        np.testing.assert_array_equal(tmask.numpy()[:, 0], MIXED >= MEM_LEN)
        tout.backward(torch.from_numpy(cot))
        np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx),
                                   rtol=1e-5, atol=1e-6, err_msg=mem_init)
        if tm is not None:
            want = params_from_flax(jgp["params"]["mem_layer"])
            for k, p in tm.named_parameters():
                np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                           rtol=1e-5, atol=1e-6, err_msg=k)


@pytest.mark.parametrize("circular", [False, True])
def test_window_lstm_matches_jax(circular):
    """WindowLSTMMem at MIXED lengths (sample 2, l = 2 < M, has empty
    slots): values, the slot mask, the vjp (input and cell parameters)
    within rtol 1e-5 / atol 1e-6; a cotangent on the empty slots alone
    gives finite, zero gradients."""
    rng = np.random.default_rng(7)
    x, mask = mixed_inputs(rng)
    feats = 5
    jm = jattn.WindowLSTMMem(feats, MEM_LEN, circular)
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.asarray(x),
                            jnp.asarray(mask))
    params = rn.random_variables(shapes, rng)
    tm = tattn.WindowLSTMMem(WIDTH, feats, MEM_LEN, circular)
    tm.load_state_dict(params_from_flax(params["params"]), strict=True)
    cot = rng.normal(size=(len(MIXED), MEM_LEN, feats)).astype(np.float32)
    jout, (jgp, jgx) = jit_vjp(
        lambda p, a: jm.apply(p, a, jnp.asarray(mask))[0],
        (params, jnp.asarray(x)), jnp.asarray(cot))
    jmask = jm.apply(params, jnp.asarray(x), jnp.asarray(mask))[1]
    tx = torch.from_numpy(x).requires_grad_()
    tout, tmask = tm(tx, torch.from_numpy(mask))
    empty = ~tmask.numpy()
    assert empty.any() and not empty[[0, 1, 3]].any()
    np.testing.assert_array_equal(tmask.numpy(), np.asarray(jmask))
    np.testing.assert_allclose(tout.detach().numpy(), np.asarray(jout),
                               rtol=1e-5, atol=1e-6)
    assert not tout.detach().numpy()[empty].any()
    tout.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(jgx), rtol=1e-5,
                               atol=1e-6)
    want = params_from_flax(jgp["params"])
    for k, p in tm.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    tx.grad = None
    tm.zero_grad()
    tout, _ = tm(tx, torch.from_numpy(mask))
    tout.backward(torch.from_numpy(cot * empty[..., None]))
    for g in [tx.grad] + [p.grad for p in tm.parameters()]:
        assert torch.isfinite(g).all() and not g.any()


def test_jax_window_attention_reads_keys_outside_its_window():
    """One unpadded sample, L = 12, M = 4: slot 0's window is positions
    0-2. Moving the key at position 11 moves the JAX package's slot 0
    (its window mask scores the other keys +1e30, pred_attn.py:95 through
    277-285) and leaves the port's as it was; moving a key inside the
    window moves both."""
    rng = np.random.default_rng(11)
    x = rng.normal(size=(1, 12, WIDTH)).astype(np.float32)
    mask = np.ones((1, 12), bool)
    jm, params, tm = window_attn_modules("attn", rng, x, mask)

    apply = jax.jit(jm.apply)

    def slot0(a):
        j = np.asarray(apply(params, jnp.asarray(a), jnp.asarray(mask)))
        with torch.no_grad():
            t = tattn.init_mem_static(torch.from_numpy(a),
                                      torch.from_numpy(mask), MEM_LEN,
                                      "attn", attn=tm)[0].numpy()
        return j[0, 0], t[0, 0]

    base = slot0(x)
    outside, inside = x.copy(), x.copy()
    outside[0, 11] += 5.0
    inside[0, 1] += 5.0
    (j_out, t_out), (j_in, t_in) = slot0(outside), slot0(inside)
    assert np.abs(j_out - base[0]).max() > 0.1
    np.testing.assert_array_equal(t_out, base[1])
    assert np.abs(t_in - base[1]).max() > 0.1
    assert np.abs(j_in - base[0]).max() > 0.1


# ---------------------------------------------------------------------------
# the nets inside the models
# ---------------------------------------------------------------------------

# (net, rep net, mem_init, mem_len): all ten inits; mem_len 1 for attn
MODEL_CASES = [
    ("MeanMemAttnPredictNet", "DMPNN", "mean", 4),
    ("SumMemAttnPredictNet", "DMPNN", "circular_lstm", 3),
    ("MaxMemAttnPredictNet", "DMPNN", "attn", 1),
    ("DIAMNet", "DMPNN", "sum", 4),
    ("DIAMNet", "DMPNN", "max", 3),
    ("MeanMemAttnPredictNet", "CNN", "circular_max", 2),
    ("SumMemAttnPredictNet", "CNN", "lstm", 2),
    ("MaxMemAttnPredictNet", "CNN", "circular_attn", 1),
    ("DIAMNet", "CNN", "circular_mean", 2),
    ("SumMemAttnPredictNet", "CNN", "circular_sum", 2),
]
# amp: a MemAttn net and DIAMNet over DMPNN, which computes them in bf16
# (the pooled slots promote to float32, as in JAX); each compiles another
# JAX program
AMP_CASES = [MODEL_CASES[0], MODEL_CASES[3]]

_CASES = {}


def mem_case(net, rep, mem_init, mem_len):
    """tests/test_torch_scm_pred_attn.attn_case for a memory net: DMPNN
    (pattern 4 V / 4 E, graph 12 V / 24 E, nodeedge) or CNN (pattern 4 V
    / 3 tuples, graph 8 V / 8 tuples, edge weights) on batches that fill
    their envelopes, one layer, bsz 4, hid 16, 4 heads, one inference
    round. Every prediction row is real, so each pattern and graph has
    at least mem_len of them (checked)."""
    key = (net, rep, mem_init, mem_len)
    if key in _CASES:
        return _CASES[key]
    kw = dict(pred_net=net, pred_infer_steps=1, pred_num_heads=4,
              pred_mem_len=mem_len, pred_mem_init=mem_init,
              rep_num_pattern_layers=1, rep_num_graph_layers=1)
    bsz = 4
    if rep == "DMPNN":
        cfg = small_config(max_ngv=12, max_nge=24, max_ngel=4, max_npv=4,
                           max_npe=4, max_npel=4, **kw)
        pats, gras = pa.full_records(bsz, 4, 4, 12, 24, 4, 4, seed=2)
        jb = (jg.batch_graphs(pats), jg.batch_graphs(gras))
        tb = (tg.batch_graphs(pats), tg.batch_graphs(gras))
        out_len, p_len = 24, 4
    else:
        cfg = es.seq_config(rep_net="CNN", max_ngv=8, max_nge=8,
                            max_ngel=3, max_npv=4, max_npe=3, max_npel=3,
                            **kw)
        pats, gras = pa.full_records(bsz, 4, 3, 8, 8, 3, 3, seed=2)
        seqs = [[jg.record_to_edgeseq(r) for r in recs]
                for recs in (pats, gras)]
        jb = tuple(jg.batch_edgeseqs(s) for s in seqs)
        tb = tuple(tg.batch_edgeseqs(s) for s in seqs)
        model = sm.build_model(cfg, device="cpu")
        p_len, out_len = (model.refine_edge_weights(
            torch.zeros(bsz, b.max_len, 1)).shape[1] for b in tb)
    assert min(p_len, out_len) >= mem_len
    jm = jbuild(jax_config(cfg))
    rng = np.random.default_rng(MODEL_CASES.index(key))
    case = dict(cfg=cfg, jm=jm, jb=jb, tb=tb, rng=rng, fns={},
                shapes=jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jb),
                counts=rng.poisson(3.0, (bsz, 1)).astype(np.float32),
                nw=rng.poisson(1.0, (bsz, cfg.max_ngv)).astype(np.float32),
                ew=rng.poisson(1.0, (bsz, out_len)).astype(np.float32))
    amp = key in AMP_CASES
    case["draws"] = [rn.draw_weights(case)
                     for _ in range(pa.AMP_DRAWS if amp else 1)]
    case.update(case["draws"][0])
    if amp:
        w = case["draws"][0]
        case["fns"][(True, True)] = jax.jit(
            rn._jax_grads(case, True, True)).lower(
                w["params"], w["stats"]).compile(
                    {"xla_allow_excess_precision": False})
    _CASES[key] = case
    return case


@pytest.mark.parametrize("net, rep, mem_init, mem_len", MODEL_CASES)
def test_mem_nets_in_models_match_jax(net, rep, mem_init, mem_len):
    """f32: outputs, loss, every gradient and params_from_flax's leaves
    (test_torch_scm_pred_attn.check_model_f32); for AMP_CASES, amp bf16
    against the JAX package's own amp error (check_model_amp)."""
    case = mem_case(net, rep, mem_init, mem_len)
    pa.check_model_f32(case)
    if (net, rep, mem_init, mem_len) in AMP_CASES:
        pa.check_model_amp(case)


def flax_keys(params):
    return {".".join(p.key for p in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(
                params)[0]}


@pytest.mark.parametrize("mem_init", ["circular_attn", "lstm", "sum"])
def test_params_from_flax_maps_every_memory_leaf(mem_init):
    """A MemDotAttention's and a DIAMNet's (return_weights, pattern rows
    narrower than the graph's) flax trees land leaf for leaf on the
    port's parameters of their paths, strict: proj_k/v, mem_attn or
    mem_lstm_k/v.cell.{ii,if,ig,io}.kernel and {hi,hf,hg,ho}.{kernel,
    bias}, attn; DIAMNet's mem_layer as a DotAttention (rep_dim wide),
    an LSTM cell or a Dense, p/g/m_attn, p_fc, g_fc, weight_fc1/2,
    pred_fc1/2."""
    rng = np.random.default_rng(3)
    rep, p_rep, h, lens = 10, 7, 8, (6, 5)
    q, k = (jnp.zeros((2, n, d)) for n, d in zip(lens, (rep, p_rep)))
    masks = [jnp.ones((2, n), bool) for n in lens]
    jmem = jattn.MemDotAttention(hidden_dim=h, mem_dim=h, mem_len=3,
                                 mem_init=mem_init, num_heads=2)
    jdiam = jattn.DIAMNet(hidden_dim=h, num_heads=2, mem_len=3,
                          mem_init=mem_init, return_weights=True)
    tmem = tattn.MemDotAttention(rep, p_rep, p_rep, h, h, 3, mem_init, 2)
    tdiam = tattn.DIAMNet(rep, h, return_weights=True, p_rep_dim=p_rep,
                          num_heads=2, mem_len=3, mem_init=mem_init)
    for jm, tm, args in ((jmem, tmem, (q, k, k, masks[0], masks[1])),
                         (jdiam, tdiam, (k, masks[1], q, masks[0]))):
        params = rn.random_variables(jax.eval_shape(
            jm.init, jax.random.PRNGKey(0), *args), rng)["params"]
        want = flax_keys(params)
        tm.load_state_dict(params_from_flax(params), strict=True)
        sd = tm.state_dict()
        assert set(sd) == set(want)
        for name, leaf in want.items():
            np.testing.assert_array_equal(sd[name].numpy(), leaf)
    base = mem_init.split("_")[-1]
    mem_keys = {"attn": {"mem_attn.weight_q", "mem_layer.weight_q",
                         "mem_layer.g_kernel"},
                "lstm": {f"mem_lstm_{s}.cell.{g}.kernel" for s in "kv"
                         for g in ("ii", "if", "ig", "io", "hi", "hf",
                                   "hg", "ho")}
                | {f"mem_layer.cell.h{g}.bias" for g in "ifgo"},
                "sum": {"mem_layer.kernel", "mem_layer.bias"}}[base]
    names = set(tmem.state_dict()) | set(tdiam.state_dict())
    assert mem_keys <= names
    assert {"proj_k.kernel", "proj_v.kernel", "attn.q_layer_norm.scale",
            "m_attn.weight_k", "p_fc.kernel", "g_fc.kernel",
            "weight_fc1.kernel", "weight_fc2.kernel", "pred_fc1.kernel"
            } <= names
    assert tdiam.m_attn.weight_k.shape[0] == (rep if base == "attn" else h)
    assert tdiam.pred_fc1.kernel.shape[0] == 3 * tdiam.m_attn.weight_k.shape[
        0] + 4


def test_diamnet_train_step_matches_jax():
    """One make_train_step (f32, LR multiplier 0.5) of DIAMNet over CNN
    (circular_mean: the weight head divides by the chunk's largest
    pattern length), both steps in the same two chunks of two pairs: the
    losses, every parameter and the BatchNorm statistics after the
    update."""
    case = mem_case(*MODEL_CASES[8])
    weights = case["cfg"].pred_return_weights
    jp, jgr = case["jb"]
    # the steps refine the edge targets to CNN's pooled length themselves
    counts, nw = case["counts"], case["nw"]
    ew = case["rng"].poisson(1.0, (4, jgr.max_len)).astype(np.float32)
    scal = (0.2, 0.1, 0.05, 0.0)
    tx = jdrv.make_optimizer(lr=1e-2)
    params, stats = (jax.tree.map(lambda x: jnp.array(x, copy=True),
                                  case[k]) for k in ("params", "stats"))
    state = jdrv.TrainState.create({"params": params, "batch_stats": stats},
                                   tx)
    jstep = jdrv.make_train_step(case["jm"], tx, return_weights=weights,
                                 eval_metric="MAE", accum_chunks=2)
    state, jlosses = jstep(state, jp, jgr, jnp.asarray(counts),
                           jnp.asarray(nw), jnp.asarray(ew),
                           *map(jnp.float32, scal), jnp.float32(0.5),
                           jax.random.PRNGKey(0))
    m = sm.build_model(case["cfg"], device="cpu")
    m.load_state_dict(params_from_flax(case["params"], case["stats"]))
    step = tdrv.make_train_step(m, tdrv.make_optimizer(m.parameters(), 1e-2),
                                return_weights=weights,
                                eval_metric="MAE", accum_chunks=2)
    tlosses = step(*case["tb"], torch.from_numpy(counts),
                   torch.from_numpy(nw), torch.from_numpy(ew), *scal, 0.5)
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = params_from_flax(state.params, state.batch_stats)
    sd = m.state_dict()
    for k, v in want.items():
        close_to_max(sd[k], v.numpy(), 1e-5, k, 1e-6)


def test_cli_epoch_finetune_and_evaluate(tmp_path):
    """cli/scm_train with --pred_net DIAMNet --pred_mem_init
    circular_lstm for one epoch on --device cpu, a finetune onto a larger
    vocabulary, then scm_evaluate of the first run: finite metrics, and
    scm_evaluate's dev metrics equal the training log's."""
    base = TINY + ["--pred_net", "DIAMNet", "--pred_mem_init",
                   "circular_lstm", "--pred_mem_len", "3",
                   "--pred_num_heads", "2", "--train_epochs", "1"]
    d1 = ttrain.main(base + VOCAB2 + ["--save_model_dir",
                                      str(tmp_path / "a")])
    assert os.path.basename(d1).startswith("DMPNN_DIAMNet_")
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
