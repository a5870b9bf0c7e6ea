"""Port UNC training (dualmessagepassing_tpu_torch/unc/model.py loss,
ops/segment_kernel.py backward pairings, unc/driver.py optimizer, train
step and train_unc, train/checkpoint.py, cli/unc_train.py) against the
JAX package on identical weights and batches.

The JAX side runs on the CPU at `highest` matmul precision
(tests/conftest.py) in the composition its train_unc runs by default
(pad_cols, sorted edges, the sender sort of pad_subgraph(send_keys=True));
the port runs the plain versions of its kernels, in the forward and in
the backward.

Tolerances:
  * float32 loss and gradients — rtol 1e-4, atol 1e-6 per tensor: the
    same float32 arithmetic in another summation order. (The biases that
    feed a BatchNorm directly have an exact gradient of 0; both sides
    return rounding noise of ~1e-7 there, inside atol.)
  * amp bf16 — both sides round every matmul and elementwise result to
    bf16, at different places, so the two amp gradients differ by about
    as much as each differs from float32 (on this batch up to ~5 % of
    the largest gradient). So the test holds the port's amp gradients
    to the JAX package's own amp error: per tensor, the port's max abs
    distance to the float32 gradient is at most 1.5 times JAX's plus
    one bf16 rounding (2**-8) of the tensor's float32 maximum, and over
    all tensors its L2 distance at most 1.5 times JAX's. The loss within
    1e-3 relative.
  * Adam steps and train_unc — the 4 biases per layer that feed a
    BatchNorm directly (BN_FED_BIASES) have an exact gradient of 0, so
    their gradient is rounding noise of ~1e-7, which Adam (eps 1e-8)
    turns into steps of up to ~lr of either sign, on each side its own.
    They do not change any train-mode output, but the eval-mode
    BatchNorm of the export reads them against running means that lag
    them. So after every step the test sets the port's BN-fed biases to
    the JAX package's values of the same step; everything else must then
    match: losses rtol 1e-5 per step; parameters and running statistics
    rtol 1e-4 plus atol 1e-3 * lr per step (Adam divides each gradient
    element by its own root mean square, so an element whose gradient
    is ~1e4 times its rounding noise still moves 1e-4 of its ~lr step
    differently); the exported embeddings 1e-4 abs and rel.
"""

import json
import math
import re
import shlex

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu.unc.data import WholeGraph
from dualmessagepassing_tpu_torch.cli import unc_train as tcli
from dualmessagepassing_tpu_torch.ops import segment_kernel as tsk
from dualmessagepassing_tpu_torch.train import checkpoint as tck
from dualmessagepassing_tpu_torch.unc import data as td
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import model as tm

from test_torch_unc_data import assert_same_dict, tiny_hin
from test_torch_unc_model import perturb

H, LAYERS, REG, LR = 16, 2, 1e-2, 1e-2
F32_TOL = dict(rtol=1e-4, atol=1e-6)
BN_FED_BIASES = ("nbias", "ebias", "nmlp.fc0_bias", "emlp.fc0_bias")


def jax_model(n, r, **kw):
    return jm.UNCTrainModel(num_nodes=n, num_rels=r, h_dim=H, nlabel=0,
                            num_hidden_layers=LAYERS, dropout=0.0,
                            reg_param=REG, backbone="DMPNN",
                            sorted_edges=True, pad_cols=True, **kw)


def bn_fed_biases(params) -> dict:
    """The BN-fed biases of a flax parameter tree, as port names."""
    return {k: v.numpy().copy()
            for k, v in tm.params_from_flax(params).items()
            if k.endswith(BN_FED_BIASES)}


def pin(model, values: dict) -> None:
    with torch.no_grad():
        for k, v in values.items():
            model.get_parameter(k).copy_(torch.from_numpy(v))


def port_model(n, r, params, stats):
    m = tm.UNCTrainModel(n, r, H, num_hidden_layers=LAYERS, reg_param=REG)
    m.load_state_dict(tm.params_from_flax(params, stats))
    return m


@pytest.fixture(scope="module")
def case():
    """A training batch of a ~200-node HIN (sender sort included) and
    perturbed weights of a 2-layer JAX UNCTrainModel."""
    t, n, r = tiny_hin(seed=5, n=200, e=800)
    g = WholeGraph(n, r, t)
    padded = jdrv.sample_batch(g, t[:100], "randomwalk", 3, 5, 0.5, 3, n,
                               g.num_edges, 400, np.random.default_rng(0))
    assert padded["edge_mask"].sum() < len(padded["edge_mask"])  # has pads
    model = jax_model(n, r)
    sub = {k: jnp.asarray(v) for k, v in padded.items()}
    variables = jm.init_unc_variables(model, jax.random.PRNGKey(0), sub)
    rng = np.random.default_rng(1)
    return dict(n=n, r=r, t=t, padded=padded, model=model, sub=sub,
                params=perturb(variables["params"], rng),
                stats=perturb(variables["batch_stats"], rng),
                sub_t=tdrv.to_device(
                    tsk.attach_csr_plan(padded, sender_plan=True), "cpu"))


def jax_value_and_grad(case, amp):
    model, sub = case["model"], case["sub"]

    @jax.jit
    def f(p):
        def loss_fn(p):
            (out, _), stats = jm.apply_unc_forward(
                model, p, case["stats"], sub, jax.random.PRNGKey(0), amp=amp)
            return model.apply(
                {"params": p}, out, sub["edge_type"], sub["edge_mask"],
                sub["samples"], sub["labels"], sub["sample_mask"],
                sub["node_mask"],
                method=jm.UNCTrainModel.unsupervised_loss), stats
        return jax.value_and_grad(loss_fn, has_aux=True)(p)

    (loss, stats), grads = f(case["params"])
    return float(loss), tm.params_from_flax(grads), stats


def port_value_and_grad(case, amp):
    m = port_model(case["n"], case["r"], case["params"], case["stats"])
    sub = case["sub_t"]
    out = tm.apply_unc_forward(m, sub, amp=amp, train=True)
    loss = m.unsupervised_loss(out, sub["edge_type"], sub["edge_mask"],
                               sub["samples"], sub["labels"],
                               sub["sample_mask"], sub["node_mask"])
    loss.backward()
    return loss.item(), {k: p.grad for k, p in m.named_parameters()}, m


def test_loss_and_every_gradient_match_jax_f32(case):
    jl, jg, jstats = jax_value_and_grad(case, amp=False)
    tl, tg, m = port_value_and_grad(case, amp=False)
    np.testing.assert_allclose(tl, jl, rtol=1e-6)
    assert set(tg) == set(jg) and all(g is not None for g in tg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k].numpy(), err_msg=k,
                                   **F32_TOL)
    # the train-mode forward updated the BN running statistics as JAX's
    want = tm.params_from_flax({}, jstats)
    sd = m.state_dict()
    for k, val in want.items():
        np.testing.assert_allclose(sd[k].numpy(), val.numpy(), err_msg=k,
                                   **F32_TOL)


def test_loss_and_every_gradient_match_jax_amp(case):
    _, f32, _ = jax_value_and_grad(case, amp=False)
    jl, ja, _ = jax_value_and_grad(case, amp=True)
    tl, ta, _ = port_value_and_grad(case, amp=True)
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    for k in ja:
        assert ta[k].dtype == torch.float32
        port = (ta[k] - f32[k]).abs().max().item()
        jax_own = (ja[k] - f32[k]).abs().max().item()
        assert port <= 1.5 * jax_own + 2 ** -8 * f32[k].abs().max().item(), \
            (k, port, jax_own)

    def dist(a, b):
        return math.sqrt(sum(((a[k] - b[k]) ** 2).sum().item() for k in a))
    assert dist(ta, f32) <= 1.5 * dist(ja, f32)


def test_three_optimizer_steps_match_optax(case):
    """Three train steps on three batches: parameters, BN statistics and
    losses against make_unc_train_step with optax's clip -> Adam ->
    cosine chain (a total of 5 steps, so the schedule moves)."""
    n, r = case["n"], case["r"]
    g = WholeGraph(n, r, case["t"])
    rng = np.random.default_rng(4)
    batches = [jdrv.sample_batch(g, case["t"][i * 100: (i + 1) * 100],
                                 "randomwalk", 3, 5, 0.5, 3, n, g.num_edges,
                                 400, rng) for i in range(3)]
    tx = jdrv.make_unc_optimizer(LR, 5, 1.0)
    step = jdrv.make_unc_train_step(case["model"], tx)
    params, stats = case["params"], case["stats"]
    opt_state = tx.init(params)
    m = port_model(n, r, params, stats)
    opt = tdrv.make_unc_optimizer(m, LR, 5, 1.0)
    tstep = tdrv.make_unc_train_step(m, opt)
    for b in batches:
        params, opt_state, stats, jl = step(
            params, opt_state, stats, {k: jnp.asarray(v) for k, v in
                                       b.items()}, jax.random.PRNGKey(0))
        tl = tstep(tdrv.to_device(tsk.attach_csr_plan(b, sender_plan=True),
                                  "cpu"))
        np.testing.assert_allclose(tl.item(), float(jl), rtol=1e-5)
        pin(m, bn_fed_biases(params))
    assert opt.count == 3
    want = tm.params_from_flax(params, stats)
    for k, val in m.state_dict().items():
        np.testing.assert_allclose(val.numpy(), want[k].numpy(), err_msg=k,
                                   rtol=1e-4, atol=1e-3 * LR * 3)


def test_optimizer_clip_and_schedule_match_optax():
    """The optimizer alone on fixed gradients: one step whose global norm
    is below grad_norm, then steps that clip; lr from the closed form."""
    rng = np.random.default_rng(6)
    shapes = [(3, 4), (5,)]
    p0 = [rng.normal(size=s).astype(np.float32) for s in shapes]
    grads = [[(rng.normal(size=s) * scale).astype(np.float32)
              for s in shapes] for scale in (0.01, 3.0, 5.0)]
    tx = jdrv.make_unc_optimizer(LR, 4, 1.0)
    jp = [jnp.asarray(p) for p in p0]
    state = tx.init(jp)
    tp = [torch.nn.Parameter(torch.from_numpy(p.copy())) for p in p0]
    opt = tdrv.UNCOptimizer(tp, LR, 4, 1.0)
    sched = optax.cosine_decay_schedule(LR, 4, alpha=3e-6 / LR)
    for k, gs in enumerate(grads):
        upd, state = tx.update([jnp.asarray(g) for g in gs], state, jp)
        jp = optax.apply_updates(jp, upd)
        assert opt.schedule(k) == pytest.approx(float(sched(k)), rel=1e-6)
        for p, g in zip(tp, gs):
            p.grad = torch.from_numpy(g.copy())
        opt.step()
        for a, b in zip(tp, jp):
            np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                       rtol=1e-5, atol=1e-7)
    assert opt.schedule(10) == pytest.approx(3e-6)


def test_distmult_loss_hand_fixture():
    """tests/test_golden_fixtures.py::test_distmult_loss_hand_fixture on
    the port: the literal 3.5746614664537746 derived by hand there."""
    m = tm.UNCTrainModel(2, 1, 2, num_hidden_layers=1, reg_param=0.01)
    with torch.no_grad():
        m.w_relation.copy_(torch.tensor([[2.0, 0.5]]))
        m.edge_fc.kernel.copy_(torch.eye(2))
        m.edge_fc.bias.zero_()
    h = torch.tensor([[1.0, 2.0], [3.0, 1.0]])
    z = torch.tensor([[1.0, 1.0], [0.0, 1.0]])
    r_bar = torch.tensor([[0.5, 0.5], [0.0, 0.0]])
    ones = torch.tensor([True, True])
    loss = m.unsupervised_loss(
        (h, z, r_bar), torch.tensor([0, 1]), ones,
        torch.tensor([[0, 0, 1], [1, 0, 0]]), torch.tensor([1.0, 0.0]),
        ones, ones)
    assert loss.item() == pytest.approx(3.5746614664537746, abs=1e-6)


def test_onehot_rows_clamps_like_xla():
    table = torch.arange(12.0).reshape(4, 3)
    idx = torch.tensor([-2, 0, 3, 7])
    got = tm._onehot_rows(table, idx, clip=True)
    want = jm._onehot_rows(jnp.asarray(table.numpy()), jnp.asarray(idx),
                           clip=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(RuntimeError):
        tm._onehot_rows(table, idx)            # torch refuses, XLA clamps


# -----------------------------------------------------------------------------
# the sender gather: sort keys, plan, pads, f32 accumulation
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("sampler", ["randomwalk", "neighbor"])
def test_sample_batch_send_keys_match_jax(sampler):
    """send_order / senders_sorted array-equal to the JAX package's
    sample_batch(send_keys=True), drawing the same random numbers."""
    t, n, r = tiny_hin()
    ra, rb = np.random.default_rng(11), np.random.default_rng(11)
    args = (sampler, 3, 5, 0.5, 5, n, min(n * 5, 2 * len(t)), 40 * 6)
    a = jdrv.sample_batch(WholeGraph(n, r, t), t[:40], *args, ra,
                          send_keys=True)
    b = tdrv.sample_batch(td.WholeGraph(n, r, t), t[:40], *args, rb,
                          send_keys=True)
    assert "send_order" in a
    assert_same_dict(a, b)
    assert ra.integers(0, 2 ** 62) == rb.integers(0, 2 ** 62)


def test_sender_plan_covers_the_real_edges(case):
    """sk2_order is the JAX package's send_order without the pad slots;
    sk2_rowptr is its row pointer, ending at n_real."""
    padded = case["padded"]
    plan = tsk.attach_csr_plan(padded, sender_plan=True)
    rp, v, n_real = plan["sk2_rowptr"], case["n"], plan["n_real"]
    order = padded["send_order"]
    pads = order >= n_real
    assert pads.any() and (padded["senders_sorted"][pads] == 0).all()
    np.testing.assert_array_equal(plan["sk2_order"], order[~pads])
    assert rp.dtype == np.int32 and rp.shape == (v + 1,) and rp[-1] == n_real
    np.testing.assert_array_equal(np.repeat(np.arange(v), np.diff(rp)),
                                  padded["senders"][plan["sk2_order"]])


@pytest.mark.parametrize("amp", [False, True])
def test_sender_plan_without_pads_equals_the_whole_stream(case, amp):
    """The JAX package's sender plan covers the whole sorted stream, the
    pads as sender 0; the port's leaves the pads out. Every gradient of
    a full backward is the same either way, bit for bit, because the
    pads' cotangents are exactly zero."""
    padded = case["padded"]
    whole = dict(case["sub_t"])
    whole["sk2_order"] = torch.from_numpy(padded["send_order"])
    whole["sk2_rowptr"] = torch.from_numpy(np.searchsorted(
        padded["senders_sorted"], np.arange(case["n"] + 1)).astype(np.int32))
    grads = []
    for sub in (case["sub_t"], whole):
        m = port_model(case["n"], case["r"], case["params"], case["stats"])
        out = tm.apply_unc_forward(m, sub, amp=amp, train=True)
        m.unsupervised_loss(out, sub["edge_type"], sub["edge_mask"],
                            sub["samples"], sub["labels"],
                            sub["sample_mask"], sub["node_mask"]).backward()
        grads.append({k: p.grad for k, p in m.named_parameters()})
    for k in grads[0]:
        assert torch.equal(grads[0][k], grads[1][k]), k


def test_pad_edges_carry_exactly_zero_cotangents(case, monkeypatch):
    """Capture the cotangents of both endpoint gathers of every layer in
    a full backward: rows of pad edges are exactly 0, so the CSR plans
    may skip them."""
    seen = []

    def spy(cls):
        orig = cls.backward

        def backward(ctx, g):
            seen.append((cls.__name__, g.detach().clone()))
            return orig(ctx, g)
        monkeypatch.setattr(cls, "backward", staticmethod(backward))

    spy(tsk.GatherRowsPerm)
    spy(tsk.GatherRowsSorted)
    for amp in (False, True):
        seen.clear()
        port_value_and_grad(case, amp=amp)
        n_real = case["sub_t"]["n_real"]
        assert sorted(name for name, _ in seen) == \
            ["GatherRowsPerm"] * LAYERS + ["GatherRowsSorted"] * LAYERS
        for name, g in seen:
            assert g[:n_real].abs().sum() > 0, name
            assert (g[n_real:] == 0).all(), name


def _hub_case(seed=0, v=50, e=1500, hub=1000, w=21):
    """A sender stream with one hub of `hub` edges, in random order, and
    a bf16 cotangent whose f32 sum over the hub is far from bf16's."""
    rng = np.random.default_rng(seed)
    senders = np.concatenate([np.full(hub, 7), rng.integers(0, v, e - hub)])
    rng.shuffle(senders)
    order = np.argsort(senders, kind="stable")
    row_ptr = np.searchsorted(senders[order], np.arange(v + 1)).astype(
        np.int32)
    g = torch.from_numpy((rng.normal(size=(e, w)) * 0.1
                          + 1.0).astype(np.float32)).bfloat16()
    table = torch.zeros(v, w, dtype=torch.bfloat16, requires_grad=True)
    idx = torch.from_numpy(senders)
    want = torch.zeros(v, w).index_add_(0, idx, g.float()).bfloat16()
    return (table, idx, torch.from_numpy(order), torch.from_numpy(row_ptr),
            g, want)


def test_sender_gather_backward_accumulates_in_f32_under_amp():
    """The fault repaired with training: the sender gather's backward
    under amp. A plain gather's autograd backward sums the bf16
    cotangent in a bf16 accumulator — index_select's (index_add_) does
    so on CUDA (tests/test_torch_cuda_kernels.py shows it on the card),
    and table[idx]'s (index_put_ with accumulate) does so on the CPU too
    — and a hub of 1,000 edges then loses most of its precision. The
    port's sender gather sums in float32 and rounds once: within one
    bf16 rounding (2**-8 relative) of the float32 sum."""
    table, idx, order, row_ptr, g, want = _hub_case()
    tsk.gather_rows_perm(table, idx, order, row_ptr).backward(g)
    got = table.grad
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), want.float(), rtol=2 ** -8,
                               atol=0)
    table.grad = None
    table[idx].backward(g)
    err = (table.grad.float() - want.float()).abs() / want.float().abs()
    assert err.max().item() > 8 * 2 ** -8     # what the repair prevents


def test_model_sender_gather_runs_through_the_plan(case, monkeypatch):
    """DualGraphConv routes the sender gather through GatherRowsPerm when
    the sub carries the sender plan, and refuses a backward without it."""
    calls = []
    orig = tsk.GatherRowsPerm.apply
    monkeypatch.setattr(tsk.GatherRowsPerm, "apply",
                        lambda *a: calls.append(1) or orig(*a))
    port_value_and_grad(case, amp=True)
    assert len(calls) == LAYERS
    m = port_model(case["n"], case["r"], case["params"], case["stats"])
    sub = {k: v for k, v in case["sub_t"].items() if k != "sk2_rowptr"}
    with pytest.raises(ValueError, match="sender gather"):
        tm.apply_unc_forward(m, sub, train=True)


# -----------------------------------------------------------------------------
# train_unc, checkpoint, CLI
# -----------------------------------------------------------------------------

TRAIN_KW = dict(lr=LR, negative_rate=3, graph_batch_size=60,
                graph_split_size=0.5, sampler="randomwalk", sample_depth=2,
                sample_width=5, n_epochs=1, grad_norm=1.0, seed=3)


@pytest.fixture(scope="module")
def jax_run():
    """The JAX package's train_unc on a 120-node HIN, with its initial
    variables and every step's loss recorded."""
    t, n, r = tiny_hin(seed=8, n=120, e=300)
    seen = {"losses": [], "pinned": []}
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
                seen["pinned"].append(bn_fed_biases(out[0]))
                return out
        return Step()

    jdrv.init_unc_variables, jdrv.make_unc_train_step = init, make_step
    try:
        emb, cov = jdrv.train_unc(t, n, r, h_dim=H, n_layers=LAYERS,
                                  reg_param=REG, dropout=0.0,
                                  log=lambda s: None, **TRAIN_KW)
    finally:
        jdrv.init_unc_variables, jdrv.make_unc_train_step = \
            orig_init, orig_step
    return dict(t=t, n=n, r=r, emb=emb, cov=cov, **seen)


def port_from(run):
    v = run["variables"]
    return port_model(run["n"], run["r"], v["params"], v["batch_stats"])


def test_train_unc_matches_jax(jax_run, monkeypatch):
    """Per-step and per-epoch losses, the early-stop epoch and the
    exported embeddings against the JAX package's train_unc from the
    same initial weights (f32), with the BN-fed biases pinned to JAX's
    after every step (module docstring)."""
    pinned = iter(jax_run["pinned"])
    make_step = tdrv.make_unc_train_step

    def make_pinned_step(model, optimizer, amp=False):
        step = make_step(model, optimizer, amp)

        def pinned_step(sub):
            loss = step(sub)
            pin(model, next(pinned))
            return loss
        return pinned_step

    monkeypatch.setattr(tdrv, "make_unc_train_step", make_pinned_step)
    epochs = []
    emb, cov = tdrv.train_unc(port_from(jax_run), jax_run["t"], jax_run["n"],
                              jax_run["r"], on_epoch=epochs.append,
                              log=lambda s: None, **TRAIN_KW)
    steps = math.ceil(len(jax_run["t"]) / TRAIN_KW["graph_batch_size"])
    n_epochs = math.ceil(steps * TRAIN_KW["graph_batch_size"] / jax_run["n"])
    got = [x for e in epochs for x in e["losses"]]
    assert len(got) == len(jax_run["losses"])
    np.testing.assert_allclose(got, jax_run["losses"], rtol=1e-5)
    jax_means = [np.mean(jax_run["losses"][i: i + steps])
                 for i in range(0, len(got), steps)]
    np.testing.assert_allclose([e["loss"] for e in epochs], jax_means,
                               rtol=1e-4)
    assert len(epochs) <= n_epochs
    if len(epochs) < n_epochs:                 # stopped early: loss rose
        assert epochs[-1]["loss"] > epochs[-2]["loss"]
    assert all(e["step_ms"] == [None] * steps for e in epochs)  # no CUDA
    assert cov == jax_run["cov"]
    np.testing.assert_allclose(emb, jax_run["emb"], rtol=1e-4, atol=1e-4)


def test_checkpoint_resume_continues_exactly(jax_run, tmp_path):
    """Two epochs in one run, or one epoch, an interruption, and a resume
    from checkpoint_dir/latest: the same losses, state and embeddings."""
    kw = dict(TRAIN_KW, n_epochs=4, graph_batch_size=100)

    class Stop(Exception):
        pass

    def stop_after_first(rec):
        if rec["epoch"] == 0:
            raise Stop

    full = []
    m_full = port_from(jax_run)
    emb_full, _ = tdrv.train_unc(m_full, jax_run["t"], jax_run["n"],
                                 jax_run["r"], on_epoch=full.append,
                                 log=lambda s: None, **kw)
    assert len(full) >= 2
    m = port_from(jax_run)
    with pytest.raises(Stop):
        tdrv.train_unc(m, jax_run["t"], jax_run["n"], jax_run["r"],
                       checkpoint_dir=str(tmp_path), on_epoch=stop_after_first,
                       log=lambda s: None, **kw)
    assert (tmp_path / "latest").exists()
    resumed, logs = [], []
    m = port_from(jax_run)                     # fresh weights: all restored
    emb, _ = tdrv.train_unc(m, jax_run["t"], jax_run["n"], jax_run["r"],
                            checkpoint_dir=str(tmp_path),
                            on_epoch=resumed.append, log=logs.append, **kw)
    assert any("resumed" in s for s in logs)
    assert [e["epoch"] for e in resumed] == [e["epoch"] for e in full[1:]]
    assert [e["losses"] for e in resumed] == [e["losses"] for e in full[1:]]
    for (k, a), b in zip(m.state_dict().items(),
                         m_full.state_dict().values()):
        assert torch.equal(a, b), k
    np.testing.assert_array_equal(emb, emb_full)


def test_rng_state_round_trips():
    rng = np.random.default_rng(5)
    rng.spawn(3)
    rng.integers(0, 10, 7)
    back = tck.rng_from_state(json.loads(json.dumps(tck.rng_state(rng))))
    assert [c.integers(0, 2 ** 62) for c in rng.spawn(2)] == \
        [c.integers(0, 2 ** 62) for c in back.spawn(2)]
    assert rng.integers(0, 2 ** 62) == back.integers(0, 2 ** 62)


def _reference_command_lines():
    """Every argv the repository's tests give the JAX UNC train CLI: the
    run.sh line of tests/test_reference_commands.py and the line of
    tests/test_cli.py."""
    from pathlib import Path
    root = Path(__file__).resolve().parent
    src = (root / "test_reference_commands.py").read_text()
    body = src[src.index("def test_unc_run_sh_command_parses"):]
    run_sh = re.search(r'_split\("""(.*?)"""\)', body, re.S).group(1)
    cli = (root / "test_cli.py").read_text()
    body = cli[cli.index("def test_unc_cli"):]
    listed = re.search(r"unc_main\(\[(.*?)\]\)", body, re.S).group(1)
    test_cli = [a for a in re.findall(r'"([^"]*)"', listed)]
    return [shlex.split(run_sh), ["--link", "l", "--output", "o"]
            + [a for a in test_cli if a not in ("--link", "--output")]]


def test_cli_parses_every_reference_command_line():
    from dualmessagepassing_tpu.cli.unc_train import get_args as jax_args
    for argv in _reference_command_lines():
        a, b = jax_args(argv), tcli.get_args(argv)
        assert {k: v for k, v in vars(b).items() if k != "device"} == vars(a)
        tcli.check_supported(b)


@pytest.mark.parametrize("extra, error", [
    (["--supervised", "True"], NotImplementedError),
    (["--model", "RGCN"], NotImplementedError),
    (["--scatter_backend", "windowed"], ValueError),
    (["--ep_devices", "2"], ValueError),
    (["--recv_bcast", "True"], ValueError),
])
def test_cli_refuses_what_has_no_counterpart(extra, error):
    with pytest.raises(error):
        tcli.check_supported(tcli.get_args(["--link", "x"] + extra))


def test_cli_trains_on_the_cpu(tmp_path):
    t, n, r = tiny_hin(seed=2, n=40, e=160)
    link = tmp_path / "link.dat"
    with open(link, "w") as f:
        f.write(f"{n} {r}\n")
        for row in t:
            f.write("%d %d %d\n" % tuple(row))
    out = tmp_path / "emb.dat"
    tcli.main(["--link", str(link), "--output", str(out), "--n_hidden", "8",
               "--graph_batch_size", "40", "--n_epochs", "1",
               "--sample_depth", "2", "--sample_width", "4",
               "--checkpoint_dir", str(tmp_path / "ck"), "--device", "cpu"])
    lines = out.read_text().splitlines()
    assert len(lines) == n + 1 and len(lines[1].split("\t")[1].split()) == 8
    assert (tmp_path / "ck" / "latest").exists()
