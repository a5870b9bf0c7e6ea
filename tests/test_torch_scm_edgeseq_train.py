"""The training side of the port's SCM sequence networks (models/
edgeseq.py, train/scm_driver.py) against the JAX package on the CPU, on
tests/test_torch_scm_edgeseq.py's batches and weights:

  * amp bf16 against the JAX package's own amp error, for CNN, LSTM and
    TXL, on AMP_DRAWS weight draws: the port's L2 distance to the JAX
    float32 result over the JAX package's amp distance, for the
    predictions, the loss (its denominator plus 2**-8 of the float32
    loss) and all the gradients, at most AMP_RATIO = 1.25 on every draw.
    Both packages gate the bf16 embedding by a float32 mask (edgeseq.py:
    169,174), so under amp the networks compute in float32 on parameters
    rounded to bf16; the port rounds them as the JAX package's cast does.
    The JAX amp function is compiled without XLA's excess precision:
    with it, XLA on the CPU skips bf16 roundings inside its fusions, and
    on CNN's BatchNorm over six small patterns (an ill-conditioned draw)
    the port's error comes to 10.46 times that JAX error (this file run
    as a script with --excess-precision). Without it, on
    these draws, the ratios of the predictions were 0.80-1.08, of the
    gradients 0.96-1.01, of the loss 0.01-0.91 (this file run as a
    script prints them).
  * K3's calls per forward and train step equal k3_launches (the 4
    degree tables with pred_with_deg, else none).
  * rep_remat gives the same gradients and BatchNorm statistics, with
    and without dropout.
  * One make_train_step and one evaluate_epoch with match_weights edge
    against the JAX package's scm_driver, for CNN: the weight targets refined to the
    pooled length in the step (losses rtol 1e-5 / atol 1e-6, parameters
    1e-5 of each tensor's largest magnitude plus 1e-6) and before the
    EED sums (1e-5).
"""

import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.data import dataset as jds
from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu_torch.data import dataset as tds
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.ops import scatter as tsc
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv

from test_torch_scm_amp import remat_matches_plain
from test_torch_scm_edgeseq import seq_batches, seq_case, seq_config
from test_torch_scm_ops import close_to_max
from test_torch_scm_rep_nets import _jax_grads, amp_ratios


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are tiny and the test workers share
    the CPU's cores (tests/test_torch_scm_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


AMP_NETS = [("CNN", {}), ("RNN", {}),
            ("TXL", dict(rep_txl_seg_len=4, rep_txl_mem_len=3))]
# the amp rule's bound on each draw's ratio (module docstring)
AMP_RATIO = 1.25


def amp_case(net, kw):
    """seq_case with the JAX package's amp train function compiled
    without XLA's excess precision, so that it rounds to bf16 at every
    cast it writes (by default XLA on the CPU keeps bf16 chains inside a
    fusion in float32); test_torch_scm_rep_nets.jax_run then uses it."""
    case = seq_case(net, **kw)
    if "exact" not in case["fns"]:
        w = case["draws"][0]
        case["fns"][(True, True)] = jax.jit(_jax_grads(case, True, True)) \
            .lower(w["params"], w["stats"]).compile(
                {"xla_allow_excess_precision": False})
        case["fns"]["exact"] = True
    return case


@pytest.mark.parametrize("net, kw", AMP_NETS)
def test_model_amp_against_jax_amp_error(net, kw):
    """Per weight draw, the port's amp distance to the JAX float32 result
    over the JAX package's own amp distance, for the predictions, the
    loss and the gradients: at most AMP_RATIO (the two round the same
    values to bf16, in other summation orders)."""
    case = amp_case(net, kw)
    draws = [amp_ratios(case, w) for w in case["draws"]]
    for name in ("preds", "loss", "grads"):
        r = np.array([d[name] for d in draws])
        assert (r <= AMP_RATIO).all(), (name, r)


K3_VARIANTS = [("CNN", {}), ("CNN", {"pred_with_deg": True}),
               ("RNN", {"pred_with_deg": True, "rep_remat": True}),
               ("TXL", {"rep_txl_seg_len": 4}),
               ("TXL", {"pred_with_deg": True, "share_rep_net": False})]


@pytest.mark.parametrize("net, kw", K3_VARIANTS)
def test_k3_calls_equal_the_derived_count(net, kw, monkeypatch):
    """K3's calls (its plain version's, on the CPU) of one eval forward
    and of one train forward and backward."""
    cfg = seq_config(rep_net=net, **kw)
    _, _, tb = seq_batches(4, 5)
    calls = []
    real = tsc.segment_sum_unsorted

    def spy(msg, receivers, num_nodes):
        calls.append(msg.shape)
        return real(msg, receivers, num_nodes)

    monkeypatch.setattr(tsc, "segment_sum_unsorted", spy)
    m = sm.build_model(cfg, device="cpu")
    with torch.no_grad():
        tdrv.apply_model(m, *tb)
    n_eval = len(calls)
    calls.clear()
    out = tdrv.apply_model(m, *tb, train=True)
    (out["pred_c"].sum() + out["pred_e"].sum()).backward()
    assert (n_eval, len(calls)) == (sm.k3_launches(cfg, train=False),
                                    sm.k3_launches(cfg, train=True))
    assert n_eval == (4 if cfg.pred_with_deg else 0)


@pytest.mark.parametrize("net, kw", [
    ("CNN", {}), ("RNN", dict(rep_rnn_type="GRU")),
    ("RNN", dict(rep_rnn_bidirectional=True))])
def test_remat_gives_the_same_gradients(net, kw):
    """rep_remat recomputes each CNN/RNN layer in the backward: the same
    gradients, in f32 and under amp (whose rounded parameters the
    recomputation uses too), and CNN's BatchNorm statistics updated
    once; then with rep_dropout 0.1 the same masks in the recomputation
    (tests/test_torch_scm_amp.remat_matches_plain: gradients,
    statistics, the generator's state), and TXL, which the JAX package
    does not rematerialise, trains with both set."""
    _, _, tb = seq_batches(4, 6)
    for amp in (False, True):
        grads, stats = [], []
        for remat in (False, True):
            m = sm.build_model(seq_config(rep_net=net, rep_remat=remat,
                                          **kw), device="cpu")
            # the parameter values each call of the first layer sees: the
            # recomputation's must be the forward's (bf16-rounded under
            # amp), which the bf16-rounded gradients would hardly show
            seen = []
            layer = getattr(m.g_rep_net, "cnn_0" if net == "CNN"
                            else "rnn_0")
            layer.register_forward_pre_hook(lambda mod, args: seen.append(
                [p.detach().clone() for p in mod.parameters()]))
            out = tdrv.apply_model(m, *tb, amp=amp, train=True)
            (out["pred_c"].sum() + out["pred_e"].square().sum()).backward()
            grads.append({k: p.grad for k, p in m.named_parameters()})
            stats.append({k: b.clone() for k, b in m.named_buffers()})
            # pattern and graph, then (remat) their recomputations
            assert len(seen) == (4 if remat else 2)
            for a, b in zip(seen[:2], seen[2:]):
                for x, y in zip(a, b):
                    assert torch.equal(x, y)
        for k in grads[0]:
            torch.testing.assert_close(grads[1][k], grads[0][k], rtol=0,
                                       atol=1e-7)
        for k in stats[0]:
            torch.testing.assert_close(stats[1][k], stats[0][k], rtol=0,
                                       atol=0)

    def loss(out):
        return out["pred_c"].sum() + out["pred_e"].square().sum()

    for amp in (False, True):
        remat_matches_plain(seq_config(rep_net=net, rep_dropout=0.1, **kw),
                            tb, loss, amp=amp)
    remat_matches_plain(seq_config(rep_net="TXL", rep_dropout=0.1,
                                   rep_txl_seg_len=4), tb, loss)


def test_train_step_and_evaluate_refine_the_targets_as_jax():
    """CNN (length 16 -> 20) with match_weights edge: one make_train_step
    on gold edge weights of the sequence's length, refined (sum-pooled)
    in the step, against the JAX step's losses and updated parameters;
    then evaluate_epoch over a CollateView of the records, whose EED sums
    run over the 20 pooled positions, against the JAX package's (which
    the JAX CLI gets with model=)."""
    case = seq_case("CNN", bsz=8, seed=9)
    cfg, jm = case["cfg"], case["jm"]
    (pats, gras), jb, tb = seq_batches(8, 9)
    rng = np.random.default_rng(2)
    counts = rng.poisson(3.0, (8, 1)).astype(np.float32)
    ew = rng.poisson(1.0, (8, 16)).astype(np.float32) * \
        tb[1].mask.numpy()
    scal = (0.2, 0.1, 0.05, 1e-3)

    tx = jdrv.make_optimizer(lr=1e-2)
    params = jax.tree.map(lambda x: jnp.array(x, copy=True), case["params"])
    stats = jax.tree.map(lambda x: jnp.array(x, copy=True), case["stats"])
    state = jdrv.TrainState.create({"params": params, "batch_stats": stats},
                                   tx)
    jstep = jdrv.make_train_step(jm, tx, return_weights="edge",
                                 eval_metric="MAE")
    state, jlosses = jstep(state, *jb, jnp.asarray(counts),
                           jnp.zeros((8, 16)), jnp.asarray(ew),
                           *map(jnp.float32, scal), jnp.float32(0.5),
                           jax.random.PRNGKey(0))
    m = sm.build_model(cfg, device="cpu")
    m.load_state_dict(sm.params_from_flax(case["params"], case["stats"]))
    step = tdrv.make_train_step(m, tdrv.make_optimizer(m.parameters(), 1e-2),
                                return_weights="edge", eval_metric="MAE")
    tlosses = step(*tb, torch.from_numpy(counts), torch.zeros(8, 16),
                   torch.from_numpy(ew), *scal, 0.5)
    assert float(jlosses["match_e_loss"]) > 0
    for k in jlosses:
        np.testing.assert_allclose(tlosses[k].item(), float(jlosses[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    want = sm.params_from_flax(state.params, state.batch_stats)
    sd = m.state_dict()
    for k, v in want.items():
        close_to_max(sd[k], v.numpy(), 1e-5, k, 1e-6)

    # evaluate_epoch on a dataset of the same records and made-up weights
    data = [{"id": str(i), "pattern": p, "graph": g,
             "counts": float(counts[i, 0]), "subisomorphisms": None,
             "node_weights": None,
             "edge_weights": rng.poisson(1.0, int(g["n_edge"])).astype(
                 np.float32)} for i, (p, g) in enumerate(zip(pats, gras))]
    sampler = [list(range(4)), list(range(4, 8))]
    jres = jdrv.evaluate_epoch(
        state.variables(), jdrv.make_eval_step(jm),
        jds.CollateView(jds.GraphAdjDataset(data), "edgeseq"), sampler,
        return_weights="edge", model=jm)
    tres = tdrv.evaluate_epoch(
        tdrv.make_eval_step(m),
        tds.CollateView(tds.GraphAdjDataset(data), "edgeseq"), sampler,
        return_weights="edge")
    assert len(tres["EED"]) == 8 and np.isnan(tres["MNED"])
    np.testing.assert_allclose(tres["EED"], jres["EED"], rtol=1e-5,
                               atol=1e-5)
    for k in ("MAE", "MSE", "MEED"):
        assert tres[k] == pytest.approx(jres[k], rel=1e-5), k
    # the targets were refined: unrefined [B, 16] weights cannot meet the
    # [B, 20] predictions
    assert m.refine_edge_weights(torch.zeros(1, 16, 1)).shape[1] == 20


if __name__ == "__main__":
    # the amp ratios per weight draw, from the repository's root:
    # PYTHONPATH=.:$PYTHONPATH python tests/test_torch_scm_edgeseq_train.py
    # (--excess-precision: the JAX amp step as XLA compiles it by default)
    import conftest  # noqa: F401  (jax on the CPU, highest precision)

    excess = "--excess-precision" in sys.argv
    torch.set_num_threads(1)
    for net, kw in AMP_NETS:
        case = seq_case(net, **kw) if excess else amp_case(net, kw)
        ratios = [amp_ratios(case, w) for w in case["draws"]]
        for name in ("preds", "loss", "grads"):
            r = np.array([x[name] for x in ratios])
            print(f"{net} {name}: geometric mean "
                  f"{np.exp(np.log(r).mean()):.3f}, single draws "
                  f"{np.round(r, 3).tolist()}", flush=True)
