"""The port's SCM training path (train/scm_driver.py, train/losses.py)
against the JAX package on the CPU: the optimizer against optax's chain,
the criteria, and one train step against make_train_step (chunked and
not). The scm_er_counting gate is tests/test_torch_scm_gate.py.

Tolerances: the optimizer 1e-6 per element (float32 arithmetic in the
same order; optax's bias corrections are float32 too); parameters after
a train step 1e-5 of each tensor's largest magnitude plus 1e-6 absolute
(the gradients' 1e-4 relative error times a learning rate of 1e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu.train.losses import bp_criterion as jbp
from dualmessagepassing_tpu.train.losses import eval_criterion as jev
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.train import losses as tl
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv

from test_torch_scm_model import get_case
from test_torch_scm_ops import close_to_max


def test_optimizer_matches_optax_chain():
    """Five steps on the same gradients: step 2 clips (global norm above
    8), steps 3-5 shrink the gradient so amsgrad's max of the
    bias-corrected second moment binds; the LR multiplier varies."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    scales = [1.0, 20.0, 0.3, 0.05, 0.01]
    mults = [1.0, 0.5, 1.0, 0.25, 2.0]
    grads = [{k: (sc * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for sc in scales]

    tx = jdrv.make_optimizer(lr=1e-2, weight_decay=1e-2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tdrv.make_optimizer(tp.values(), lr=1e-2, weight_decay=1e-2)
    binds = 0
    for g, mult in zip(grads, mults):
        jg = {k: jnp.asarray(v) for k, v in g.items()}
        updates, state = tx.update(jg, state, jp)
        jp = optax.apply_updates(
            jp, jax.tree.map(lambda u: u * mult, updates))
        nu_max_before = [s["nu_max"].clone() for s in opt.state]
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step(mult)
        binds += sum(int((s["nu_max"] == before).sum()) for s, before in
                     zip(opt.state, nu_max_before))
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(jp[k]), rtol=0, atol=1e-6)
    assert binds > 0                  # the max held its old value somewhere
    ams = state[1]
    for s, k in zip(opt.state, tp):
        np.testing.assert_allclose(s["nu_max"].numpy(),
                                   np.asarray(ams.nu_max[k]), rtol=1e-6)
    back = tdrv.make_optimizer(tp.values(), lr=1e-2)
    back.load_state_dict(opt.state_dict())
    assert back.count == 5
    assert all(torch.equal(a["mu"], b["mu"])
               for a, b in zip(back.state, opt.state))


def test_criteria_match_jax():
    rng = np.random.default_rng(1)
    pred, target = (rng.normal(size=(5, 3)).astype(np.float32) * 2
                    for _ in range(2))
    for kind in ("MAE", "MSE", "SMSE"):
        np.testing.assert_allclose(
            tl.bp_criterion(kind, torch.from_numpy(pred),
                            torch.from_numpy(target), 0.2).item(),
            float(jbp(kind, jnp.asarray(pred), jnp.asarray(target), 0.2)),
            rtol=1e-6)
        np.testing.assert_allclose(
            tl.eval_criterion(kind, torch.from_numpy(pred),
                              torch.from_numpy(target)).item(),
            float(jev(kind, jnp.asarray(pred), jnp.asarray(target))),
            rtol=1e-6)
    with pytest.raises(NotImplementedError):
        tl.bp_criterion("bogus", torch.zeros(1), torch.zeros(1), 0.0)


@pytest.mark.parametrize("chunks", [1, 2])
def test_train_step_matches_jax(chunks):
    """One step of make_train_step (f32, amsgrad chain, LR multiplier
    0.5) on the model test's batch: the losses and every parameter after
    the update."""
    case = get_case(False)
    jm, (jp, jgr) = case["jm"], case["jb"]
    counts, nw, ew = (case[k] for k in ("counts", "nw", "ew"))
    scal = (0.2, 0.1, 0.05, 0.0)
    tx = jdrv.make_optimizer(lr=1e-2)
    # the JAX step donates its state: give it a copy of the weights
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), case["params"])
    state = jdrv.TrainState.create({"params": params}, tx)
    jstep = jdrv.make_train_step(jm, tx, return_weights="nodeedge",
                                 eval_metric="MAE", accum_chunks=chunks)
    state, jlosses = jstep(state, jp, jgr, jnp.asarray(counts),
                           jnp.asarray(nw), jnp.asarray(ew),
                           *map(jnp.float32, scal), jnp.float32(0.5),
                           jax.random.PRNGKey(0))
    m = sm.build_model(case["cfg"], device="cpu")
    m.load_state_dict(sm.params_from_flax(case["params"]))
    step = tdrv.make_train_step(m, tdrv.make_optimizer(m.parameters(), 1e-2),
                                return_weights="nodeedge",
                                eval_metric="MAE", accum_chunks=chunks)
    tlosses = step(*case["tb"], torch.from_numpy(counts),
                   torch.from_numpy(nw), torch.from_numpy(ew), *scal, 0.5)
    assert set(tlosses) == set(jlosses)
    for k in jlosses:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]),
                                   rtol=1e-5, atol=1e-7, err_msg=k)
    want = sm.params_from_flax(state.params)
    for k, p in m.named_parameters():
        close_to_max(p, want[k].numpy(), 1e-5, k, 1e-6)
    assert step.optimizer.count == 1


def test_auto_chunks_follow_the_jax_rule():
    assert [tdrv.auto_chunks(b) for b in (8, 128, 256, 384, 2048, 200)] == \
        [1, 1, 2, 3, 16, 1]
    case = get_case(False)
    m = sm.build_model(case["cfg"], device="cpu")
    step = tdrv.make_train_step(m, tdrv.make_optimizer(m.parameters(), 1e-2),
                                accum_chunks=4)
    with pytest.raises(ValueError):
        step(*case["tb"], torch.zeros(6, 1), None, None, 0.2, 0.0, 0.0, 0.0)
