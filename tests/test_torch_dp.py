"""Data-parallel SCM training of the port (parallel/dp.py, parallel/
dist.py, train/scm_driver.make_train_step(world=...)) over two gloo ranks
on the CPU, against the JAX package's make_train_step(mesh=
make_dp_mesh(2)) on two of conftest's virtual CPU devices: the same
records, the same flax weights (perturbed, so zero-initialised biases
and heads carry signal), dropout off.

One spawn (tests/test_torch_dist.scm_dp_rank) computes what every test
here reads; JAX runs in the pytest process only.

Tolerances: the losses and the parameters and BatchNorm statistics
after 2 steps within rtol 2e-4 and atol 1e-5, as the JAX package's own
DP test holds its DP step to its single-device one
(tests/test_parallel.py:156-200): float32 in another summation order,
through the amsgrad chain. The gradients as the port's SCM model tests
hold them (tests/test_torch_scm_model.py): 1e-4 of each tensor's largest
magnitude plus 1e-5 of the largest gradient. An elementwise rtol does
not fit them: an element a thousandth of its tensor's largest carries
the rounding of that tensor's large sums (dst_weight's second-step
gradient: 0.0777 apart by 3.2e-5 in a tensor up to 220, 1.5e-7 of it).
The biases that feed a BatchNorm (BN_FED, the bn case) have an exact
gradient of 0, so their gradient is rounding noise that amsgrad turns
into steps of up to ~lr of either sign, on each side its own: after each
step the ranks set them to the JAX step's values, as
tests/test_torch_unc_train.py does. The ranks' parameters are compared
bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu.parallel.dp import make_dp_mesh, shard_batch
from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu.train.losses import scm_loss as jloss
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.train import checkpoint as ck

from test_torch_dist import run_ranks, scm_dp_rank, scm_model
from test_torch_scm_data import batches, jax_config, make_records, small_config
from test_torch_scm_ops import close_to_max, perturb

BSZ, LR, LR_MULT, STEPS = 8, 1e-2, 0.5, 2
TOL = dict(rtol=2e-4, atol=1e-5)
# (neg_slope, match_loss_w, match_reg_w, rep_reg_w) per case; the bn
# case puts the global BatchNorm statistics and the rep regulariser's
# global count under test
CASES = {"plain": (False, (0.2, 0.1, 0.05, 0.0)),
         "bn": (True, (0.2, 0.1, 0.05, 1e-3))}
# DMPNN's biases before a BatchNorm: the layer's own (through a Dense)
# and its update MLPs' first
BN_FED = ("nbias", "ebias", "nmlp.fc0.bias", "emlp.fc0.bias")


def _numpy_tree(tree):
    return jax.tree.map(lambda x: np.asarray(x, np.float32), tree)


def _case(bn, scal, seed):
    cfg = small_config(rep_dmpnn_batch_norm=bn)
    jm = jbuild(jax_config(cfg))
    pats, gras = make_records(BSZ, 4, 4, 12, 24, 4, 4, seed=seed)
    (jp, jgr), _ = batches(pats, gras)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jp, jgr)
    rng = np.random.default_rng(seed)
    params = perturb(v["params"], rng, 0.02)
    stats = perturb(v["batch_stats"], rng, 0.02) if bn else {}
    spec = dict(cfg=cfg, pats=pats, gras=gras,
                params=_numpy_tree(params), stats=_numpy_tree(stats),
                counts=rng.poisson(3.0, (BSZ, 1)).astype(np.float32),
                nw=rng.poisson(1.0, (BSZ, 12)).astype(np.float32),
                ew=rng.poisson(1.0, (BSZ, 48)).astype(np.float32),
                scal=scal, lr=LR, lr_mult=LR_MULT, steps=STEPS)
    return spec, jm, (jp, jgr), params, stats


def _jax_dp(spec, jm, jbatch, params, stats):
    """The JAX DP step on a 2-device mesh, STEPS times -> (per-step
    losses, per-step gradients in port names, final state in port
    names, the step-0 gradient)."""
    mesh = make_dp_mesh(2)
    data = (*jbatch, *(jnp.asarray(spec[k]) for k in ("counts", "nw", "ew")))
    scal = tuple(map(jnp.float32, spec["scal"]))
    key = jax.random.PRNGKey(0)

    @jax.jit
    def grads(p, bs, pattern, graph, counts, nw, ew):
        def loss_fn(p):
            variables = {"params": p, **({"batch_stats": bs} if bs else {})}
            out, _ = jm.apply(variables, pattern, graph, train=True,
                              rngs={"dropout": key}, mutable=["batch_stats"])
            return jloss(out, counts, nw, ew, bp_loss="MSE",
                         neg_slope=scal[0], match_loss_w=scal[1],
                         match_reg_w=scal[2], rep_reg_w=scal[3],
                         eval_metric="MAE")["total"]
        return jax.grad(loss_fn)(p)

    tx = jdrv.make_optimizer(lr=LR)
    state = jdrv.dp_replicate_state(mesh, jdrv.TrainState.create(
        {"params": jax.tree.map(jnp.array, params),
         **({"batch_stats": stats} if stats else {})}, tx))
    step = jdrv.make_train_step(jm, tx, return_weights="nodeedge",
                                eval_metric="MAE", mesh=mesh)
    losses, gs, pins = [], [], []
    with mesh:
        sharded = shard_batch(mesh, *data)
        for _ in range(STEPS):
            gs.append(sm.params_from_flax(_numpy_tree(grads(
                state.params, state.batch_stats, *sharded))))
            state, ls = step(state, *data, *scal, jnp.float32(LR_MULT), key)
            losses.append({k: float(v) for k, v in ls.items()})
            pins.append({k: v.numpy() for k, v in sm.params_from_flax(
                _numpy_tree(state.params)).items()
                if spec["stats"] and k.endswith(BN_FED)})
    final = sm.params_from_flax(_numpy_tree(state.params),
                                _numpy_tree(state.batch_stats))
    spec["pins"] = pins
    return losses, gs, final


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    specs, jax_runs = {}, {}
    for i, (name, (bn, scal)) in enumerate(CASES.items()):
        spec, *rest = _case(bn, scal, seed=4 + i)
        specs[name] = spec
        jax_runs[name] = _jax_dp(spec, *rest)
    ranks = run_ranks(scm_dp_rank, tmp, specs, str(tmp))
    return dict(specs=specs, jax=jax_runs, ranks=ranks, ckpt=tmp / "epoch1")


def _close(got: dict, want: dict, what: str):
    for k, w in want.items():
        np.testing.assert_allclose(got[k], np.asarray(w), err_msg=f"{what} {k}",
                                   **TOL)


def _close_grads(got: dict, want: dict, what: str):
    gmax = max(float(np.abs(w).max()) for w in want.values())
    for k, w in want.items():
        close_to_max(got[k], w, 1e-4, f"{what} {k}", 1e-5 * gmax)


@pytest.mark.parametrize("name", list(CASES))
def test_dp_losses_and_gradients_match_the_jax_dp_step(runs, name):
    """Both steps: every loss and every parameter gradient (summed over
    the ranks) against the JAX DP step's on the same state."""
    jl, jg, _ = runs["jax"][name]
    for r in runs["ranks"]:
        for s in range(STEPS):
            _close(r[name]["losses"][s], jl[s], f"step {s} loss")
            _close_grads(r[name]["grads"][s],
                         {k: v.numpy() for k, v in jg[s].items()},
                         f"step {s} gradient")


@pytest.mark.parametrize("name", list(CASES))
def test_dp_parameters_and_statistics_after_two_steps(runs, name):
    """The parameters and the BatchNorm running statistics after 2 steps
    against the JAX DP step's, and equal bit for bit on both ranks."""
    _, _, final = runs["jax"][name]
    a, b = (r[name]["state"] for r in runs["ranks"])
    _close(a, {k: v.numpy() for k, v in final.items()}, "state")
    assert set(a) == set(final)
    if name == "bn":
        assert any(k.endswith("running_mean") for k in a)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("name", list(CASES))
def test_ragged_batch_is_computed_whole_on_every_rank(runs, name):
    """A batch that does not split: every rank computes it whole with no
    cross-rank statistics, and the gradients, each seeded 1 / size and
    summed, are the whole batch's (the JAX DP step's first gradient)."""
    _, jg, _ = runs["jax"][name]
    a, b = (r[name]["ragged_grads"] for r in runs["ranks"])
    _close_grads(a, {k: v.numpy() for k, v in jg[0].items()},
                 "ragged gradient")
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_dp_composes_with_amp_and_chunks(runs):
    """amp bf16 with two microbatches (each rank its share of each): the
    losses are finite and the parameters stay equal on the ranks
    (tests/test_parallel.py:202's demand)."""
    a, b = (r["amp_chunks"] for r in runs["ranks"])
    for losses in (a["losses"], b["losses"]):
        assert all(np.isfinite(v) for step in losses for v in step.values())
    assert a["losses"] == b["losses"]
    for k in a["state"]:
        np.testing.assert_array_equal(a["state"][k], b["state"][k],
                                      err_msg=k)


def test_dp_checkpoint_round_trips(runs):
    """Rank 0 saves the bn case's state after its DP steps; restored into
    a fresh DP run (rank 0 reads, dp_replicate_state hands it on) and
    into a single-device model, every tensor is the saved one."""
    saved = runs["ranks"][0]["bn"]["state"]
    for r in runs["ranks"]:
        for k, v in saved.items():
            np.testing.assert_array_equal(r["resumed"]["state"][k], v,
                                          err_msg=k)
        assert r["resumed"]["count"] == STEPS
        np.testing.assert_array_equal(
            np.concatenate([m.ravel() for m in r["resumed"]["mu"]]),
            np.concatenate([m.ravel() for m in
                            runs["ranks"][0]["resumed"]["mu"]]))
    single = scm_model(runs["specs"]["bn"])
    ck.restore_state(str(runs["ckpt"]), single)
    for k, v in single.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), saved[k], err_msg=k)
