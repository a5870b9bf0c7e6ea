"""The port's SCM flagship model under amp bf16 against the JAX
package's own amp error, K3's calls per forward and train step against
the derived count (models/scm_models.k3_launches, which chip_smoke.py
checks on the card), and the rematerialised rep net.

amp bf16: both sides round to bf16 at different places (XLA also keeps
fused elementwise chains in float32 on the CPU, where torch rounds after
each operator), so the port is held to the JAX package's own amp error
on the same weights and batch (tests/test_torch_scm_model.make_case) —
per tensor (outputs on valid rows, the loss, every gradient) the port's
amp result may be at most 1.5 times as far from JAX's float32 result as
JAX's amp result is, plus one bf16 rounding (2**-8) of the tensor's
float32 maximum; and 1.5 times in L2 over all gradients.
"""

import math

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.ops import scatter as tsc
from dualmessagepassing_tpu_torch.train.scm_driver import apply_model

from test_torch_scm_data import batches, make_records, small_config
from test_torch_scm_model import _rows, get_case, jax_run, port_run


def test_amp_forward_loss_and_gradients_against_jax_amp_error():
    """The flagship's options (no BatchNorm), amp bf16 train mode."""
    case = get_case(False)
    jf_out, jf_l, jf_g, _ = jax_run(case, amp=False, train=True)
    ja_out, ja_l, ja_g, _ = jax_run(case, amp=True, train=True)
    ta_out, ta_l, ta_g, _ = port_run(case, amp=True, train=True)

    def held(port, jax_amp, f32, name):
        port, jax_amp, f32 = (np.asarray(x, np.float32)
                              for x in (port, jax_amp, f32))
        err = np.abs(port - f32).max()
        own = np.abs(jax_amp - f32).max()
        bound = 1.5 * own + 2 ** -8 * np.abs(f32).max()
        assert err <= bound, (name, err, own)

    for key in ("pred_c", "pred_v", "pred_e"):
        assert ta_out[key].dtype == torch.float32
        mask = _rows(ta_out, key)[1]
        sel = (slice(None),) if mask is None else (mask.numpy(),)
        held(ta_out[key].detach().numpy()[sel], np.asarray(ja_out[key])[sel],
             np.asarray(jf_out[key])[sel], key)
    held(ta_l["total"].item(), float(ja_l["total"]), float(jf_l["total"]),
         "loss")
    for k in jf_g:
        assert ta_g[k].dtype == torch.float32
        held(ta_g[k].numpy(), ja_g[k].numpy(), jf_g[k].numpy(), k)

    def dist(a, b):
        return math.sqrt(sum(float(((a[k] - b[k]) ** 2).sum()) for k in b))
    assert dist(ta_g, jf_g) <= 1.5 * dist(ja_g, jf_g)


@pytest.mark.parametrize("variant", [{}, {"pred_with_deg": True},
                                     {"rep_remat": True},
                                     {"rep_num_graph_layers": 3,
                                      "share_rep_net": False}])
def test_k3_calls_per_forward_and_step_equal_the_derived_count(
        variant, monkeypatch):
    """Every K3 call the model makes (ops.scatter's segment_sum_unsorted,
    which launches K3 on a CUDA tensor) counted on the CPU: one eval
    forward, then one forward and backward, against
    scm_models.k3_launches — the count chip_smoke.py checks on the card."""
    calls = []
    real = tsc.segment_sum_unsorted

    def spy(msg, receivers, num_nodes):
        calls.append(msg.shape[1])
        return real(msg, receivers, num_nodes)

    monkeypatch.setattr(tsc, "segment_sum_unsorted", spy)
    cfg = small_config(**variant)
    m = sm.build_model(cfg, device="cpu")
    pats, gras = make_records(4, 4, 4, 12, 24, 4, 4, seed=5)
    _, (tp, tgr) = batches(pats, gras)
    with torch.no_grad():
        apply_model(m, tp, tgr)
    assert len(calls) == sm.k3_launches(cfg, train=False)
    calls.clear()
    out = apply_model(m, tp, tgr, train=True)
    (out["pred_c"].sum() + out["pred_v"].sum()
     + out["pred_e"].sum()).backward()
    assert len(calls) == sm.k3_launches(cfg, train=True)


def remat_matches_plain(cfg, tb, loss_fn, amp: bool = False, seed: int = 7):
    """One train-mode forward and backward of cfg's model with rep_remat
    off and on, the dropout masks drawn from a generator seeded alike:
    the gradients agree within 1e-7, the running statistics and the
    generator's state after the step are equal (the recomputation
    replays the forward's masks and does not rewind the live generator),
    and with dropout the step drew from the generator. -> the plain
    run's (gradients, buffers)."""
    runs = []
    for remat in (False, True):
        m = sm.build_model(cfg.replace(rep_remat=remat), device="cpu")
        gen = torch.Generator().manual_seed(seed)
        start = gen.get_state()
        loss_fn(apply_model(m, *tb, amp=amp, train=True,
                            generator=gen)).backward()
        runs.append(({k: p.grad for k, p in m.named_parameters()},
                     {k: b.clone() for k, b in m.named_buffers()},
                     gen.get_state()))
    (g0, b0, r0), (g1, b1, r1) = runs
    if cfg.rep_dropout > 0:
        assert not torch.equal(r0, start), "no dropout mask was drawn"
    assert torch.equal(r1, r0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=0, atol=1e-7)
    for k in b0:
        assert torch.equal(b1[k], b0[k]), k
    return g0, b0


def test_remat_gives_the_same_gradients():
    """DMPNN with rep_remat against the plain stack: without dropout, and
    with rep_dropout 0.1 and BatchNorm (statistics updated once)."""
    pats, gras = make_records(4, 4, 4, 12, 24, 4, 4, seed=6)
    _, tb = batches(pats, gras)
    for kw in ({}, {"rep_dropout": 0.1, "rep_dmpnn_batch_norm": True}):
        _, stats = remat_matches_plain(
            small_config(**kw), tb, lambda out: out["pred_c"].sum()
            + out["pred_e"].square().sum())
    assert any(k.endswith("running_mean") for k in stats)
