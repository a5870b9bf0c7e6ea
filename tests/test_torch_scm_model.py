"""The port's SCM flagship model (models/scm_models.DMPNN over
models/basemodel.GraphAdjModelV2) against the JAX package's on the CPU,
with the JAX init carried across by params_from_flax: the whole forward
(pred_c, pred_v, pred_e and every embedding and rep), scm_loss and every
parameter gradient in float32, at the flagship's options
(ScalarFilter, SumPredictNet, nodeedge, reversed edges) on a small
envelope (tests/test_torch_scm_data.small_config).

Tolerances: float32 outputs 1e-5 of each tensor's largest magnitude on
its valid rows; gradients 1e-4 of each tensor's largest magnitude plus
1e-5 of the largest gradient (biases feeding a BatchNorm have exact
gradient 0); the loss 1e-5 relative. amp bf16, the K3 launch count and
remat: tests/test_torch_scm_amp.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu.train.losses import scm_loss as jloss
from dualmessagepassing_tpu.utils.amp import cast_floats, compute_dtype_scope
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.train.losses import scm_loss as tloss
from dualmessagepassing_tpu_torch.train.scm_driver import apply_model

from test_torch_scm_data import batches, jax_config, make_records, small_config
from test_torch_scm_ops import close_to_max, perturb

LOSS_KW = dict(bp_loss="MSE", neg_slope=0.2, match_loss_w=0.1,
               match_reg_w=0.05, rep_reg_w=1e-3)
REPS = ("p_v_emb", "p_e_emb", "g_v_emb", "g_e_emb",
        "p_v_rep", "p_e_rep", "g_v_rep", "g_e_rep")
# weights are the JAX init plus N(0, PERTURB) noise, so zero-initialised
# biases and heads carry signal
PERTURB = 0.02
MASK_OF = {"p_v": "p_v_mask", "p_e": "p_e_mask", "g_v": "g_v_mask",
           "g_e": "g_e_mask"}


def make_case(batch_norm: bool, bsz: int = 6, seed: int = 4):
    cfg = small_config(rep_dmpnn_batch_norm=batch_norm)
    jm = jbuild(jax_config(cfg))
    pats, gras = make_records(bsz, 4, 4, 12, 24, 4, 4, seed=seed)
    (jp, jgr), (tp, tgr) = batches(pats, gras)
    v = jax.jit(jm.init)(jax.random.PRNGKey(0), jp, jgr)
    rng = np.random.default_rng(seed)
    params = perturb(v["params"], rng, PERTURB)
    stats = perturb(v["batch_stats"], rng, PERTURB) if batch_norm else {}
    counts = rng.poisson(3.0, (bsz, 1)).astype(np.float32)
    nw = rng.poisson(1.0, (bsz, 12)).astype(np.float32)
    ew = rng.poisson(1.0, (bsz, 48)).astype(np.float32)
    return dict(cfg=cfg, jm=jm, jb=(jp, jgr), tb=(tp, tgr), params=params,
                stats=stats, counts=counts, nw=nw, ew=ew, jax={})


_CASES = {}


def get_case(batch_norm: bool):
    """make_case, once per process (the JAX programs compile once)."""
    if batch_norm not in _CASES:
        _CASES[batch_norm] = make_case(batch_norm)
    return _CASES[batch_norm]


@pytest.fixture(params=[False, True], ids=["f32", "bn"])
def case(request):
    return get_case(request.param)


def port_model(case):
    m = sm.build_model(case["cfg"], device="cpu")
    m.load_state_dict(sm.params_from_flax(case["params"], case["stats"]),
                      strict=True)
    return m


def jax_run(case, amp: bool, train: bool):
    """(outputs, losses, parameter gradients, updated batch stats) of the
    JAX model, the way make_train_step(amp=...) computes them; computed
    once per case."""
    if (amp, train) not in case["jax"]:
        case["jax"][(amp, train)] = _jax_run(case, amp, train)
    return case["jax"][(amp, train)]


def _jax_run(case, amp: bool, train: bool):
    jm, (jp, jgr) = case["jm"], case["jb"]
    counts, nw, ew = (jnp.asarray(case[k]) for k in ("counts", "nw", "ew"))

    @jax.jit
    def f(params):
        def loss_fn(p):
            variables = {"params": p}
            if case["stats"]:
                variables["batch_stats"] = case["stats"]
            if amp:
                with compute_dtype_scope(jnp.bfloat16):
                    out, mut = jm.apply(
                        {**variables, "params": cast_floats(p, jnp.bfloat16)},
                        jp, jgr, train=train, mutable=["batch_stats"])
                out = cast_floats(out, jnp.float32)
            else:
                out, mut = jm.apply(variables, jp, jgr, train=train,
                                    mutable=["batch_stats"])
            losses = jloss(out, counts, nw, ew, **LOSS_KW)
            return losses["total"], (out, losses, mut)
        return jax.grad(loss_fn, has_aux=True)(params)

    grads, (out, losses, mut) = f(case["params"])
    return (out, losses, sm.params_from_flax(grads),
            mut.get("batch_stats", {}))


def port_run(case, amp: bool, train: bool):
    m = port_model(case)
    tp, tgr = case["tb"]
    out = apply_model(m, tp, tgr, amp=amp, train=train)
    losses = tloss(out, *(torch.from_numpy(case[k])
                          for k in ("counts", "nw", "ew")), **LOSS_KW)
    losses["total"].backward()
    return out, losses, {k: p.grad for k, p in m.named_parameters()}, m


def _rows(out, key):
    """A tensor of the output dict and its valid-row mask (or None)."""
    mask = next((out[v] for k, v in MASK_OF.items() if key.startswith(k)),
                None)
    if key in ("pred_v", "pred_e"):
        mask = out["g_v_mask" if key == "pred_v" else "g_e_mask"]
    return out[key], mask


def test_params_from_flax_consumes_every_leaf(case):
    sd = sm.params_from_flax(case["params"], case["stats"])
    n = len(jax.tree.leaves(case["params"])) + len(jax.tree.leaves(
        case["stats"]))
    assert len(sd) == n
    m = sm.build_model(case["cfg"], device="cpu", seed=3)
    assert set(sd) == set(m.state_dict())
    for k, v in m.state_dict().items():
        assert v.shape == sd[k].shape, k
    # the sequence networks build on the same configuration
    # (tests/test_torch_scm_edgeseq.py holds them against the JAX package)
    for net in ("CNN", "RNN", "TXL"):
        seq = sm.build_model(case["cfg"].replace(rep_net=net), device="cpu")
        assert type(seq) is sm.MODEL_REGISTRY[net]
    with pytest.raises(ValueError):
        sm.build_model(case["cfg"].replace(rep_net="GIN"), device="cpu")


@pytest.mark.parametrize("train", [False, True])
def test_forward_matches_jax(case, train):
    # without BatchNorm (and dropout 0) train and eval mode compute the
    # same forward in the JAX model: its one compiled train run serves
    jout = jax_run(case, amp=False, train=train or not case["stats"])[0]
    with torch.no_grad():
        tout = apply_model(port_model(case), *case["tb"], train=train)
    for key in ("pred_c", "pred_v", "pred_e") + REPS:
        got, mask = _rows(tout, key)
        want = np.asarray(jout[key])
        if mask is not None:
            np.testing.assert_array_equal(mask.numpy(),
                                          np.asarray(_rows(jout, key)[1]))
            got, want = got.numpy()[mask.numpy()], want[mask.numpy()]
        close_to_max(got, want, 1e-5, key)


def test_loss_and_every_gradient_match_jax_f32(case):
    _, jl, jg, jstats = jax_run(case, amp=False, train=True)
    _, tl, tg, m = port_run(case, amp=False, train=True)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    assert set(tg) == set(jg) and all(g is not None for g in tg.values())
    gmax = max(float(v.abs().max()) for v in jg.values())
    for k in jg:
        close_to_max(tg[k], jg[k].numpy(), 1e-4, k, 1e-5 * gmax)
    sd = m.state_dict()
    for k, v in sm.params_from_flax({}, jstats).items():
        np.testing.assert_allclose(sd[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
