"""The port's SCM sequence networks CNN, RNN and TXL (models/edgeseq.py)
against the JAX package on the CPU, with random weights of the JAX
model's shapes (tests/test_torch_scm_rep_nets.random_variables) carried
across by params_from_flax, on tests/test_edgeseq.py's small sizes (hid
16, 2 layers, L <= 16) with the flagship's options (ScalarFilter,
SumPredictNet, reversed edges, edge weights): CNN at k = 2, k = 3 and
one stride-2 geometry (k = 4, padding 1, where no pool window lies in
the padding alone; the default padding k // 2 makes such windows, -inf,
and NaN through the BatchNorm in both packages), LSTM, GRU and the tanh
RNN each uni- and bidirectional, TXL with two and more segments (its
memories used), and CNN with the encodings and degrees as prediction
features and nothing shared; CNN's eval forward.

Tolerances: pred_c, pred_e, every embedding and rep over all positions
(pads included) within 1e-5 of each tensor's largest magnitude plus
1e-6; the refined masks equal; scm_loss and its parts to rtol 1e-5 /
atol 1e-6; every parameter gradient within 1e-5 of its tensor's largest
magnitude plus 1e-6 of the largest gradient (float32 sums in other
orders through 16 recurrent steps); the updated BatchNorm statistics to
1e-5 relative. amp, K3's calls, remat and scm_driver's refine hooks:
tests/test_torch_scm_edgeseq_train.py.
"""

import jax
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu import graph as jg
from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch.models import scm_models as sm

from test_torch_scm_data import jax_config, make_records
from test_torch_scm_data import small_config as _small_config
from test_torch_scm_ops import close_to_max
from test_torch_scm_rep_nets import jax_run, port_run, random_variables


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes are tiny and the test workers share
    the CPU's cores (tests/test_torch_scm_cli.py)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def seq_config(**kw):
    """tests/test_edgeseq.py's sizes with reversed edges: pattern <= 4 V
    / 6 tuples, graph <= 8 V / 16 tuples, 3 vertex and 6 edge labels."""
    base = dict(max_ngv=8, max_ngvl=3, max_nge=16, max_ngel=6, max_npv=4,
                max_npvl=3, max_npe=6, max_npel=6,
                pred_return_weights="edge")
    base.update(kw)
    return _small_config(**base)


def seq_batches(bsz, seed):
    """(records, JAX EdgeSeqBatch pair, port EdgeSeqBatch pair) of ragged
    graphs with reversed edges (tests/test_torch_scm_data.make_records)."""
    pats, gras = make_records(bsz, 4, 3, 8, 8, 3, 3, seed=seed)
    seqs = [[jg.record_to_edgeseq(r) for r in recs] for recs in (pats,
                                                                   gras)]
    return ((pats, gras), tuple(jg.batch_edgeseqs(s) for s in seqs),
            tuple(tg.batch_edgeseqs(s) for s in seqs))


_CASES = {}
AMP_DRAWS = 4


def seq_case(net: str, bsz: int = 6, seed: int = 4, **kw):
    """The JAX model, a batch, targets (the edge weights drawn at the
    refined length) and AMP_DRAWS weight draws, once per process."""
    key = (net, bsz, seed, tuple(sorted(kw.items())))
    if key in _CASES:
        return _CASES[key]
    cfg = seq_config(rep_net=net, **kw)
    jm = jbuild(jax_config(cfg))
    _, jb, tb = seq_batches(bsz, seed)
    rng = np.random.default_rng(seed)
    out_len = sm.build_model(cfg, device="cpu").refine_edge_weights(
        torch.zeros(bsz, tb[1].max_len, 1)).shape[1]
    case = dict(cfg=cfg, jm=jm, jb=jb, tb=tb, rng=rng, fns={},
                shapes=jax.eval_shape(jm.init, jax.random.PRNGKey(0), *jb),
                counts=rng.poisson(3.0, (bsz, 1)).astype(np.float32),
                nw=np.zeros((bsz, tb[1].max_len), np.float32),
                ew=rng.poisson(1.0, (bsz, out_len)).astype(np.float32))
    shapes = case["shapes"]
    case["draws"] = [dict(params=random_variables(shapes["params"], rng),
                          stats=random_variables(
                              shapes.get("batch_stats", {}), rng))
                     for _ in range(AMP_DRAWS)]
    case.update(case["draws"][0])
    _CASES[key] = case
    return case


OUTPUTS = ("pred_c", "pred_e", "p_e_emb", "g_e_emb", "p_e_rep", "g_e_rep")


def check_model_f32(case, train=True):
    sd = sm.params_from_flax(case["params"], case["stats"])
    assert len(sd) == len(jax.tree.leaves(case["params"])) + len(
        jax.tree.leaves(case["stats"]))
    assert set(sd) == set(sm.build_model(case["cfg"], device="cpu",
                                         seed=3).state_dict())
    jout, jl, jg_, jstats = jax_run(case, case, amp=False, train=train)
    tout, tl, tg_, m = port_run(case, case, amp=False, train=train)
    for key in OUTPUTS:
        want = np.asarray(jout[key])
        assert tout[key].shape == want.shape, key
        close_to_max(tout[key], want, 1e-5, key, 1e-6)
    for key in ("pred_v", "p_v_rep", "g_v_rep", "p_v_mask", "g_v_mask"):
        assert tout[key] is None and jout[key] is None, key
    for key in ("p_e_mask", "g_e_mask"):
        np.testing.assert_array_equal(tout[key].numpy(),
                                      np.asarray(jout[key]), err_msg=key)
    for k in jl:
        np.testing.assert_allclose(tl[k].item(), float(jl[k]), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    assert set(tg_) == set(jg_) and all(g is not None for g in tg_.values())
    gmax = max(float(v.abs().max()) for v in jg_.values())
    for k in jg_:
        close_to_max(tg_[k], jg_[k].numpy(), 1e-5, k, 1e-6 * gmax)
    sdm = m.state_dict()
    for k, v in sm.params_from_flax({}, jstats).items():
        np.testing.assert_allclose(sdm[k].numpy(), v.numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=k)
    return tout


MODELS = {
    "CNN-k2": ("CNN", {}),
    "CNN-k3": ("CNN", dict(rep_cnn_kernel_sizes=(3,))),
    "CNN-k4s2": ("CNN", dict(rep_cnn_kernel_sizes=(4,),
                             rep_cnn_strides=(2,), rep_cnn_paddings=(1,))),
    "LSTM": ("RNN", {}),
    "LSTM-bi": ("RNN", dict(rep_rnn_bidirectional=True)),
    "GRU": ("RNN", dict(rep_rnn_type="GRU")),
    "GRU-bi": ("RNN", dict(rep_rnn_type="GRU", rep_rnn_bidirectional=True)),
    "RNN": ("RNN", dict(rep_rnn_type="RNN", rep_rnn_layer_norm=True)),
    "RNN-bi": ("RNN", dict(rep_rnn_type="RNN", rep_rnn_bidirectional=True)),
    "TXL": ("TXL", dict(rep_txl_seg_len=4, rep_txl_mem_len=3)),
    "TXL-post-norm": ("TXL", dict(rep_txl_seg_len=6, rep_txl_mem_len=8,
                                  rep_txl_clamp_len=5,
                                  rep_txl_pre_norm=False)),
    "CNN-features": ("CNN", dict(pred_with_enc=True, pred_with_deg=True,
                                 share_enc_net=False, share_emb_net=False,
                                 share_rep_net=False)),
}


@pytest.mark.parametrize("name", list(MODELS))
def test_model_forward_loss_and_gradients_match_jax(name):
    net, kw = MODELS[name]
    case = seq_case(net, **kw)
    out = check_model_f32(case)
    if name == "CNN-k2":
        # k = 2, padding 1: two tuples longer per layer
        assert out["g_e_rep"].shape[1] == 16 + 2 * 2
    if net == "TXL":
        # the graph's 16 tuples span more than one segment
        assert case["tb"][1].max_len > case["cfg"].rep_txl_seg_len


def test_model_eval_forward_matches_jax():
    """train=False: CNN's BatchNorm on its running statistics."""
    check_model_f32(seq_case("CNN"), train=False)
