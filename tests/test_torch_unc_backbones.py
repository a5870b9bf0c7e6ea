"""Port UNC backbones and input layers (dualmessagepassing_tpu_torch/
models/compgcn.py, ops/encoding.py, unc/model.py: the shared input
layer, CompGraphConv/UNCCompGCN, RelGraphConvFlat/UNCRGNN (R-GCN and
R-GIN), params_from_flax; unc/driver.py:train_unc and
train/checkpoint.py with them) against the JAX package on identical
weights and batches.

The JAX side runs on the CPU at `highest` matmul precision
(tests/conftest.py). Its UNCCompGCN and UNCRGNN always take the XLA
scatter (they do not pass scatter_backend on); the port runs the plain
versions of its kernels, forward and backward. Dropout is 0 on both
sides.

Tolerances:
  * comp_func — the hand fixture to 1e-5 (tests/test_golden_fixtures.py:
    168); against JAX's comp_func within 1e-6 of the largest output
    (float32 FFTs of two libraries: 4.5e-6 at n = 50 on outputs up to
    ~15), and bf16 inputs to one bf16 rounding (2**-8 relative).
  * the encoding tables — array-equal.
  * float32 forward, loss and every gradient — rtol 1e-4, atol 1e-6 per
    tensor, as tests/test_torch_unc_train.py (the same float32 arithmetic
    in another summation order); the forward on valid rows 1e-5.
  * amp bf16 — the port's amp gradients held to the JAX package's own
    amp error, as tests/test_torch_unc_train.py: over all tensors the
    port's L2 distance to the float32 gradient at most 1.5 times JAX's;
    per tensor its max abs distance at most AMP_MAX_FACTOR = 3 times
    JAX's plus one bf16 rounding of the tensor's float32 maximum; the
    loss within 1e-3 relative. The per-tensor factor is 3, not 1.5: the
    max of a few hundred bf16 noise terms is a noisy statistic, and with
    attributed or multi-hot DMPNN inputs over five attribute draws the
    port's worst tensor stood at 0.7-2.6 times JAX's own error while the
    L2 ratio stayed at 0.53-1.12 (learned inputs: at most 1.3 and 1.0).
  * train_unc — 2 epochs: per-step losses rtol 1e-5, the exported
    embeddings 1e-4 abs and rel (no backbone here has a BatchNorm, so
    nothing is pinned); a checkpoint resume with dropout on is bitwise.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.models.compgcn import comp_func as jax_comp
from dualmessagepassing_tpu.ops import encoding as jenc
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu.unc.data import WholeGraph
from dualmessagepassing_tpu_torch.models.compgcn import comp_func
from dualmessagepassing_tpu_torch.ops import encoding as tenc
from dualmessagepassing_tpu_torch.ops import segment_kernel as tsk
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import model as tm

from test_torch_unc_data import tiny_hin
from test_torch_unc_model import perturb

H, LAYERS, REG, LR, ATTR_W = 16, 2, 1e-2, 1e-2, 12
F32_TOL = dict(rtol=1e-4, atol=1e-6)
AMP_MAX_FACTOR = 3.0

# (backbone, input layer) pairs held against the JAX package
CASES = [("CompGCN", "learned"), ("RGCN", "learned"), ("RGIN", "learned"),
         ("DMPNN", "attributed"), ("DMPNN", "multihot"),
         ("RGCN", "attributed")]


def attributes(n, width=ATTR_W, seed=9):
    return np.random.default_rng(seed).normal(size=(n, width)).astype(
        np.float32)


def input_kw(inputs, n):
    if inputs == "attributed":
        return {"node_attri": attributes(n)}
    if inputs == "multihot":
        return {"multihot_input": True}
    return {}


# -----------------------------------------------------------------------------
# comp_func and the encodings
# -----------------------------------------------------------------------------

def test_comp_func_hand_fixture():
    """corr(a, r)[k] = sum_i a[i] * r[(i + k) mod n]: a = [1, 2, 0, 1],
    r = [3, 1, 2, 0] -> [5, 8, 3, 8] (tests/test_golden_fixtures.py:168)."""
    a = torch.tensor([[1.0, 2.0, 0.0, 1.0]])
    r = torch.tensor([[3.0, 1.0, 2.0, 0.0]])
    np.testing.assert_allclose(comp_func(a, r, "corr")[0].numpy(),
                               [5.0, 8.0, 3.0, 8.0], atol=1e-5)
    np.testing.assert_array_equal(comp_func(a, r, "sub")[0].numpy(),
                                  [-2.0, 1.0, -2.0, 1.0])
    np.testing.assert_array_equal(comp_func(a, r, "mult")[0].numpy(),
                                  [3.0, 2.0, 0.0, 0.0])
    with pytest.raises(NotImplementedError):
        comp_func(a, r, "rotate")


@pytest.mark.parametrize("n", [7, 16, 50])
def test_comp_func_matches_jax(n):
    rng = np.random.default_rng(n)
    head = rng.normal(size=(30, n)).astype(np.float32)
    rel = rng.normal(size=(30, n)).astype(np.float32)
    loop = rng.normal(size=(1, n)).astype(np.float32)     # broadcast row
    for r in (rel, loop):
        want = np.asarray(jax_comp(jnp.asarray(head), jnp.asarray(r), "corr"))
        got = comp_func(torch.from_numpy(head), torch.from_numpy(r), "corr")
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-6 * np.abs(want).max())
    hb = torch.from_numpy(head).bfloat16()
    got = comp_func(hb, torch.from_numpy(rel).bfloat16(), "corr")
    want = np.asarray(jax_comp(jnp.asarray(hb.float().numpy(), jnp.bfloat16),
                               jnp.asarray(torch.from_numpy(rel).bfloat16()
                                           .float().numpy(), jnp.bfloat16),
                               "corr").astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=2 ** -8,
                               atol=2 ** -8 * np.abs(want).max())


def test_encoding_tables_match_jax():
    xs = np.array([[0, 1, 5], [63108, 1023, 1024]])
    for base in (2, 3, 10):
        np.testing.assert_array_equal(tenc.get_enc_len(xs, base),
                                      jenc.get_enc_len(xs, base))
        assert tenc.get_enc_len(63108, base) == jenc.get_enc_len(63108, base)
        for ln in (1, 4, 17):
            np.testing.assert_array_equal(tenc.int2anybase(xs, ln, base),
                                          jenc.int2anybase(xs, ln, base))
            np.testing.assert_array_equal(tenc.int2multihot(xs, ln, base),
                                          jenc.int2multihot(xs, ln, base))
            np.testing.assert_array_equal(tenc.int2multihot(37, ln, base),
                                          jenc.int2multihot(37, ln, base))
    for n in (1, 2, 150, 1025):
        a, b = tenc.multihot_table(n, 2), jenc.multihot_table(n, 2)
        assert a.dtype == b.dtype == np.float32
        np.testing.assert_array_equal(a, b)


# -----------------------------------------------------------------------------
# forward, loss and gradients
# -----------------------------------------------------------------------------

def jax_model(n, r, backbone, inputs, **kw):
    return jm.UNCTrainModel(num_nodes=n, num_rels=r, h_dim=H,
                            num_hidden_layers=LAYERS, dropout=0.0,
                            reg_param=REG, backbone=backbone,
                            sorted_edges=True, **input_kw(inputs, n), **kw)


def port_model(n, r, backbone, inputs, params, stats=None, **kw):
    m = tm.UNCTrainModel(n, r, H, num_hidden_layers=LAYERS, reg_param=REG,
                         backbone=backbone, **input_kw(inputs, n), **kw)
    m.load_state_dict(tm.params_from_flax(params, stats))
    return m


@pytest.fixture(scope="module")
def batch():
    """A training batch of a ~150-node HIN with both CSR plans."""
    t, n, r = tiny_hin(seed=5, n=150, e=600)
    g = WholeGraph(n, r, t)
    padded = jdrv.sample_batch(g, t[:80], "randomwalk", 3, 5, 0.5, 3, n,
                               g.num_edges, 320, np.random.default_rng(0))
    assert padded["edge_mask"].sum() < len(padded["edge_mask"])  # has pads
    assert len(np.unique(padded["edge_type"][padded["edge_mask"]])) == 2 * r
    return dict(n=n, r=r, padded=padded,
                sub=tdrv.to_device(tsk.attach_csr_plan(
                    padded, sender_plan=True), "cpu"))


_VARIABLES = {}


def variables(batch, backbone, inputs):
    """Perturbed initial variables of the JAX model (cached per case)."""
    key = (backbone, inputs)
    if key not in _VARIABLES:
        model = jax_model(batch["n"], batch["r"], backbone, inputs)
        sub = {k: jnp.asarray(v) for k, v in batch["padded"].items()}
        v = jm.init_unc_variables(model, jax.random.PRNGKey(1), sub)
        rng = np.random.default_rng(2)
        _VARIABLES[key] = (model, perturb(v["params"], rng),
                           perturb(v.get("batch_stats", {}), rng))
    return _VARIABLES[key]


def jax_value_and_grad(batch, backbone, inputs, amp):
    model, params, stats = variables(batch, backbone, inputs)
    sub = {k: jnp.asarray(v) for k, v in batch["padded"].items()}

    @jax.jit
    def f(p):
        def loss_fn(p):
            (out, _), new = jm.apply_unc_forward(
                model, p, stats, sub, jax.random.PRNGKey(0), amp=amp)
            return model.apply(
                {"params": p}, out, sub["edge_type"], sub["edge_mask"],
                sub["samples"], sub["labels"], sub["sample_mask"],
                sub["node_mask"],
                method=jm.UNCTrainModel.unsupervised_loss), (out, new)
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (loss, (out, new)), grads = f(params)
    return float(loss), tm.params_from_flax(grads), out, new


def port_value_and_grad(batch, backbone, inputs, amp):
    _, params, stats = variables(batch, backbone, inputs)
    m = port_model(batch["n"], batch["r"], backbone, inputs, params, stats)
    sub = batch["sub"]
    out = tm.apply_unc_forward(m, sub, amp=amp, train=True)
    loss = m.unsupervised_loss(out, sub["edge_type"], sub["edge_mask"],
                               sub["samples"], sub["labels"],
                               sub["sample_mask"], sub["node_mask"])
    loss.backward()
    return loss.item(), {k: p.grad for k, p in m.named_parameters()}, out, m


@pytest.mark.parametrize("backbone, inputs", CASES)
def test_params_from_flax_loads_every_backbone(batch, backbone, inputs):
    """Every leaf of the flax tree (and node_fc's) has one port tensor."""
    model = jax_model(batch["n"], batch["r"], backbone, inputs, nlabel=3)
    sub = {k: jnp.asarray(v) for k, v in batch["padded"].items()}
    v = jm.init_unc_variables(model, jax.random.PRNGKey(0), sub)
    sd = tm.params_from_flax(v["params"], v.get("batch_stats"))
    assert len(sd) == len(jax.tree.leaves(v))
    m = tm.UNCTrainModel(batch["n"], batch["r"], H, num_hidden_layers=LAYERS,
                         backbone=backbone, nlabel=3,
                         **input_kw(inputs, batch["n"]))
    assert set(sd) == set(m.state_dict())
    m.load_state_dict(sd, strict=True)


@pytest.mark.parametrize("backbone, inputs", CASES)
def test_loss_and_every_gradient_match_jax_f32(batch, backbone, inputs):
    jl, jg, jout, jnew = jax_value_and_grad(batch, backbone, inputs, False)
    tl, tg, tout, m = port_value_and_grad(batch, backbone, inputs, False)
    masks = (batch["padded"]["node_mask"], batch["padded"]["edge_mask"])
    assert len(tout) == len(jout)
    for got, want, mask in zip(tout, jout, masks):
        np.testing.assert_allclose(got.detach().numpy()[mask],
                                   np.asarray(want)[mask], rtol=1e-5,
                                   atol=1e-5)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert set(tg) == set(jg) and all(g is not None for g in tg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k].numpy(), err_msg=k,
                                   **F32_TOL)
    want = tm.params_from_flax({}, jnew)          # BN statistics (DMPNN)
    sd = m.state_dict()
    for k, val in want.items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), err_msg=k,
                                   **F32_TOL)


@pytest.mark.parametrize("backbone, inputs", CASES)
def test_loss_and_every_gradient_match_jax_amp(batch, backbone, inputs):
    _, f32, _, _ = jax_value_and_grad(batch, backbone, inputs, False)
    jl, ja, _, _ = jax_value_and_grad(batch, backbone, inputs, True)
    tl, ta, tout, _ = port_value_and_grad(batch, backbone, inputs, True)
    assert all(o.dtype == torch.float32 for o in tout)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k in ja:
        assert ta[k].dtype == torch.float32
        port = (ta[k] - f32[k]).abs().max().item()
        jax_own = (ja[k] - f32[k]).abs().max().item()
        assert port <= (AMP_MAX_FACTOR * jax_own
                        + 2 ** -8 * f32[k].abs().max().item()), \
            (k, port, jax_own)

    def dist(a, b):
        return math.sqrt(sum(((a[k] - b[k]) ** 2).sum().item() for k in a))
    assert dist(ta, f32) <= 1.5 * dist(ja, f32)


def test_relation_aggregation_launches_k1_per_relation(batch, monkeypatch):
    """R-GCN aggregates relation by relation: per layer 2R SegmentSumSorted
    calls (K1 forward, K2 backward), and one sender gather (K1 backward);
    CompGCN one of each per layer."""
    seen = []
    orig_ss, orig_perm = tsk.SegmentSumSorted.apply, tsk.GatherRowsPerm.apply
    monkeypatch.setattr(tsk.SegmentSumSorted, "apply",
                        lambda *a: seen.append("agg") or orig_ss(*a))
    monkeypatch.setattr(tsk.GatherRowsPerm, "apply",
                        lambda *a: seen.append("send") or orig_perm(*a))
    for backbone, per_layer in (("RGCN", 2 * batch["r"]), ("RGIN",
                                2 * batch["r"]), ("CompGCN", 1)):
        seen.clear()
        port_value_and_grad(batch, backbone, "learned", False)
        assert seen.count("agg") == per_layer * LAYERS, backbone
        assert seen.count("send") == LAYERS, backbone


def test_dropout_draws_from_the_generator(batch):
    """CompGraphConv and RelGraphConvFlat drop in train mode only, and
    the same generator state gives the same masks."""
    _, params, _ = variables(batch, "RGIN", "learned")
    for backbone in ("RGIN", "CompGCN"):
        m = tm.UNCTrainModel(batch["n"], batch["r"], H, LAYERS, dropout=0.5,
                             backbone=backbone)
        outs = []
        for seed in (0, 0, 1):
            gen = torch.Generator().manual_seed(seed)
            with torch.no_grad():
                outs.append(m(batch["sub"], train=True, generator=gen)[0])
        assert torch.equal(outs[0], outs[1])
        assert not torch.equal(outs[0], outs[2])
        with torch.no_grad():
            ev = m(batch["sub"], train=False)[0]
        assert (outs[0] == 0).float().mean() > 0.3 and (ev != 0).all()


# -----------------------------------------------------------------------------
# train_unc
# -----------------------------------------------------------------------------

# 4 batches of 75 triplets over 150 nodes: n_epochs=1 rescales to 2
TRAIN_KW = dict(lr=LR, negative_rate=3, graph_batch_size=75,
                graph_split_size=0.5, sampler="randomwalk", sample_depth=2,
                sample_width=5, n_epochs=1, grad_norm=1.0, seed=3)


def jax_train_run(backbone, t, n, r, node_attri=None):
    """The JAX package's train_unc with its initial variables and every
    step's loss recorded."""
    seen = {"losses": []}
    orig_init, orig_step = jdrv.init_unc_variables, jdrv.make_unc_train_step

    def init(*a, **k):
        seen["variables"] = orig_init(*a, **k)
        return seen["variables"]

    def make_step(*a, **k):
        step = orig_step(*a, **k)

        class Step:
            lower = step.lower

            def __call__(self, *args):
                out = step(*args)
                seen["losses"].append(float(out[-1]))
                return out
        return Step()

    jdrv.init_unc_variables, jdrv.make_unc_train_step = init, make_step
    try:
        emb, cov = jdrv.train_unc(
            t, n, r, h_dim=H, n_layers=LAYERS, reg_param=REG, dropout=0.0,
            backbone=backbone, node_attri=node_attri, log=lambda s: None,
            **TRAIN_KW)
    finally:
        jdrv.init_unc_variables, jdrv.make_unc_train_step = \
            orig_init, orig_step
    return dict(emb=emb, cov=cov, **seen)


@pytest.mark.parametrize("backbone, attributed", [
    ("CompGCN", False), ("RGCN", False), ("RGIN", False), ("CompGCN", True)])
def test_train_unc_matches_jax(backbone, attributed):
    """Per-step losses, early stop and the exported embeddings of the
    port's train_unc against the JAX package's from the same initial
    weights. The attributes are as wide as h_dim, so the export starts
    from them (driver.py:666-671)."""
    t, n, r = tiny_hin(seed=8, n=150, e=300)
    attrs = attributes(n, H) if attributed else None
    run = jax_train_run(backbone, t, n, r, attrs)
    v = run["variables"]
    m = tm.UNCTrainModel(n, r, H, num_hidden_layers=LAYERS, reg_param=REG,
                         backbone=backbone, node_attri=attrs)
    m.load_state_dict(tm.params_from_flax(v["params"], v.get("batch_stats")))
    epochs = []
    emb, cov = tdrv.train_unc(m, t, n, r, on_epoch=epochs.append,
                              log=lambda s: None, **TRAIN_KW)
    got = [x for e in epochs for x in e["losses"]]
    assert len(epochs) == 2 and len(got) == len(run["losses"]) == 8
    np.testing.assert_allclose(got, run["losses"], rtol=1e-5)
    assert cov == run["cov"]
    np.testing.assert_allclose(emb, run["emb"], rtol=1e-4, atol=1e-4)
    if attributed:
        untouched = np.abs(run["emb"] - attrs).max(1) == 0
        np.testing.assert_array_equal(emb[untouched], attrs[untouched])


def test_checkpoint_resumes_every_backbone_exactly(tmp_path):
    """R-GIN with dropout on: two epochs in one run, or one epoch, an
    interruption and a resume from checkpoint_dir/latest, give the same
    losses, state and embeddings bit for bit (the dropout generator's
    state is in the checkpoint)."""
    t, n, r = tiny_hin(seed=8, n=150, e=300)

    def model():
        return tm.UNCTrainModel(n, r, H, LAYERS, dropout=0.3, reg_param=REG,
                                generator=torch.Generator().manual_seed(0),
                                backbone="RGIN")

    class Stop(Exception):
        pass

    def stop_after_first(rec):
        if rec["epoch"] == 0:
            raise Stop

    kw = dict(TRAIN_KW, n_epochs=4, graph_batch_size=150)
    full = []
    m_full = model()
    emb_full, _ = tdrv.train_unc(m_full, t, n, r, on_epoch=full.append,
                                 log=lambda s: None, **kw)
    assert len(full) >= 2
    with pytest.raises(Stop):
        tdrv.train_unc(model(), t, n, r, checkpoint_dir=str(tmp_path),
                       on_epoch=stop_after_first, log=lambda s: None, **kw)
    resumed = []
    m = model()
    emb, _ = tdrv.train_unc(m, t, n, r, checkpoint_dir=str(tmp_path),
                            on_epoch=resumed.append, log=lambda s: None, **kw)
    assert [e["losses"] for e in resumed] == [e["losses"] for e in full[1:]]
    for (k, a), b in zip(m.state_dict().items(),
                         m_full.state_dict().values()):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(emb, emb_full)
