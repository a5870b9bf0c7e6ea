"""tests/test_regression.py::test_scm_er_counting_regression run by the
port (the scm_er_counting gate): the port's copies of the data and the
sampler, its train_epoch, train step, optimizer, schedules and
evaluate_epoch, from the JAX init carried across by params_from_flax,
held to tests/data/regression_expected.json with that test's own
relative tolerances.
"""

import json
import os

import jax
import numpy as np

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu.data import dataset as jds
from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu_torch.data.dataset import GraphAdjDataset
from dualmessagepassing_tpu_torch.data.synthetic import generate_dataset
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv
from dualmessagepassing_tpu_torch.train.samplers import BucketSampler

from test_torch_scm_data import jax_config, small_config
from test_torch_scm_ops import close_to_max

EXPECTED = os.path.join(os.path.dirname(__file__), "data",
                        "regression_expected.json")
# tests/test_regression.py's train config
REGRESSION_CONFIG = {"train_epochs": 6, "neg_pred_slp": 0.2,
                     "match_loss_w": 0.1, "match_reg_w": 0.0,
                     "rep_reg_w": 0.0, "scheduler": "constant",
                     "pred_return_weights": "nodeedge"}


def _regression_setup():
    """tests/test_regression.py:52-110's data, config and JAX init, with
    the port's copies of the data (same arrays) and config."""
    data = generate_dataset(48, seed=13, pv=3, pe=3, gv=8, ge=16,
                            num_vlabels=2, num_elabels=2,
                            p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    cfg = small_config(max_ngv=8, max_ngvl=2, max_nge=16, max_ngel=2,
                       max_npv=4, max_npvl=2, max_npe=4, max_npel=2)
    jtrain = jds.GraphAdjDataset(data[:40])
    jm = jbuild(jax_config(cfg))
    _, pattern, graph, _, _ = jtrain.batchify(range(8), "none")
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), pattern, graph)
    return data, cfg, jm, jtrain, params


def _sampler(ds, **kw):
    return BucketSampler(ds.sizes(), ["g_len", "p_len"], batch_size=8,
                         seed=0, **kw)


def _jax_recipe(jm, jtrain, params):
    """The JAX recipe's 30 training steps: the state before each step and
    after the last (numpy copies: the JAX step donates its state)."""
    tx = jdrv.make_optimizer(lr=1e-2)
    state = jdrv.TrainState.create(params, tx)
    step = jdrv.make_train_step(jm, tx, bp_loss="MSE",
                                return_weights="nodeedge")
    states = []

    def recording_step(state, *args):
        states.append(jax.tree.map(np.array, (state.params,
                                              state.opt_state[1])))
        return step(state, *args)

    sampler = BucketSampler(jtrain.sizes(), ["g_len", "p_len"],
                            batch_size=8, seed=0)
    for epoch in range(6):
        sampler.set_epoch(epoch)
        state, _ = jdrv.train_epoch(state, recording_step, jtrain, sampler,
                                    REGRESSION_CONFIG, epoch,
                                    jax.random.PRNGKey(1))
    states.append(jax.tree.map(np.array, (state.params, state.opt_state[1])))
    return states


def _load(model, opt, jax_state):
    """A JAX (params, amsgrad state) into the port's model and optimizer."""
    params, ams = jax_state
    model.load_state_dict(sm.params_from_flax(params))
    names = [n for n, _ in model.named_parameters()]
    for key in ("mu", "nu", "nu_max"):
        tree = sm.params_from_flax(getattr(ams, key))
        for n, st in zip(names, opt.state):
            st[key].copy_(tree[n])
    opt.count = int(ams.count)


def test_scm_er_counting_gate_through_the_port():
    """tests/test_regression.py:52-110 run by the port: its data and
    sampler copies, its train_epoch, train step, optimizer, schedules and
    evaluate_epoch, from the JAX init — held to regression_expected.json
    with that test's own tolerances.

    The recipe is chaotic under float32 rounding: the JAX recipe itself,
    from its init times (1 + 1e-6 noise), ends at final train losses from
    0.88 to 1.12 and dev AUCs from 0.36 to 0.71, and a free-running port
    (whose every step agrees with JAX to ~1e-7, 1e-5 at a cancelling
    bias) lands on one of those JAX outcomes, not on the pinned one. So
    each of the 30 steps starts from the JAX recipe's own state (weights
    and amsgrad moments), the port's step must reproduce JAX's next state
    (1e-4 of each tensor's largest magnitude plus 1e-6), and the epoch
    losses and the dev metrics are the port's, on that trajectory."""
    data, cfg, jm, jtrain, params = _regression_setup()
    states = _jax_recipe(jm, jtrain, params)
    assert len(states) == 31
    train_ds, dev_ds = GraphAdjDataset(data[:40]), GraphAdjDataset(data[40:])
    model = sm.build_model(cfg, device="cpu")
    opt = tdrv.make_optimizer(model.parameters(), lr=1e-2)
    step = tdrv.make_train_step(model, opt, bp_loss="MSE",
                                return_weights="nodeedge")
    taken = []

    def synced_step(*args):
        k = len(taken)
        _load(model, opt, states[k])
        losses = step(*args)
        want = sm.params_from_flax(states[k + 1][0])
        for n, p in model.named_parameters():
            close_to_max(p, want[n].numpy(), 1e-4, f"step {k} {n}", 1e-6)
        taken.append(k)
        return losses

    synced_step.model, synced_step.optimizer = model, opt
    sampler = _sampler(train_ds)
    for epoch in range(6):
        sampler.set_epoch(epoch)
        totals = tdrv.train_epoch(synced_step, train_ds, sampler,
                                  REGRESSION_CONFIG, epoch)
    assert len(taken) == 30
    _load(model, opt, states[30])
    results = tdrv.evaluate_epoch(tdrv.make_eval_step(model), dev_ds,
                                  _sampler(dev_ds, shuffle=False),
                                  return_weights="nodeedge")
    got = {"final_train_loss": totals["total"], "dev_MAE": results["MAE"],
           "dev_MSE": results["MSE"], "dev_RMSE": results["RMSE"],
           "dev_MNED": results["MNED"], "dev_AUC": results["AUC"]}
    with open(EXPECTED) as f:
        expected = json.load(f)["scm_er_counting"]
    tol = {"final_train_loss": 0.15, "dev_MAE": 0.10, "dev_MSE": 0.20,
           "dev_RMSE": 0.10, "dev_MNED": 0.15, "dev_AUC": 0.08}
    assert set(expected) == set(got)
    for k, v in expected.items():
        assert abs(got[k] - v) <= tol[k] * max(abs(v), 1e-6), (k, got[k], v)
    assert np.isfinite(results["MEED"]) and results["time_avg"] > 0
    assert len(results["predictions"]) == 8 and totals["edges_per_sec"] > 0


def test_scm_er_counting_recipe_runs_free_on_the_port():
    """The same recipe with no syncing, all of it the port's: the loss
    falls from the first epoch to the last and every metric is finite
    (where it ends is chaotic, see the test above)."""
    data, cfg, _, _, params = _regression_setup()
    train_ds, dev_ds = GraphAdjDataset(data[:40]), GraphAdjDataset(data[40:])
    model = sm.build_model(cfg, device="cpu")
    model.load_state_dict(sm.params_from_flax(params["params"]))
    step = tdrv.make_train_step(
        model, tdrv.make_optimizer(model.parameters(), lr=1e-2),
        bp_loss="MSE", return_weights="nodeedge")
    sampler = _sampler(train_ds)
    losses = []
    for epoch in range(6):
        sampler.set_epoch(epoch)
        losses.append(tdrv.train_epoch(step, train_ds, sampler,
                                       REGRESSION_CONFIG, epoch)["total"])
    results = tdrv.evaluate_epoch(tdrv.make_eval_step(model), dev_ds,
                                  _sampler(dev_ds, shuffle=False), "nodeedge")
    assert losses[-1] < losses[0] and np.isfinite(losses).all()
    assert all(np.isfinite(results[k]) for k in ("MAE", "MSE", "RMSE",
                                                 "MNED", "MEED", "AUC"))
