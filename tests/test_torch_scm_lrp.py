"""The port's local relational pooling against the JAX package on the
CPU: the perm enumeration (data/lrp.py), the LRP collate (data/dataset.
batchify_lrp, CollateView "lrp"), the perm projection and mean pooling,
and the LRP and DMPLRP models (models/lrp.py), with the JAX weights
carried across by params_from_flax.

Tolerances: host arrays equal (dtypes too); perm_project and
perm_mean_pool 1e-5 of the largest output, their input gradients 1e-4;
the models as tests/test_torch_scm_rep_nets.py holds CompGCN, R-GCN and
R-GIN (float32 forward, loss and every gradient; amp against the JAX
package's own amp error). A chunked train step (two microbatches, one
update) against one unchunked step: the losses to 1e-6 relative and the
gradient to 1e-5 relative plus 1e-6 of its largest entry (the same sums
in two halves).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import graph as jg
from dualmessagepassing_tpu.data import dataset as jds
from dualmessagepassing_tpu.data import lrp as jdl
from dualmessagepassing_tpu.data import synthetic as jsyn
from dualmessagepassing_tpu.models import lrp as jlrp
from dualmessagepassing_tpu_torch.data import dataset as tds
from dualmessagepassing_tpu_torch.data import lrp as tdl
from dualmessagepassing_tpu_torch.models import lrp as tlrp
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv

from test_torch_scm_data import (assert_batch_equal, batches, make_records,
                                 small_config)
from test_torch_scm_ops import close_to_max
from test_torch_scm_rep_nets import (PERM_FIELDS, check_model_amp,
                                     check_model_f32, count_k3_calls,
                                     family_case, lrp_batches,
                                     one_torch_thread)  # noqa: F401


def _records(seed, n=40):
    """Random records with duplicate edges and self loops, half of them
    with their reversed edges."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = int(rng.integers(1, 9))
        e = int(rng.integers(0, 20))
        rec = jg.single_graph(v, rng.integers(0, v, e), rng.integers(0, v, e),
                              v_max=10, e_max=24)
        out.append(jg.add_reversed_edges(rec, 2) if i % 2 else rec)
    return out


def assert_perms_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        assert np.asarray(got[k]).dtype == np.asarray(want[k]).dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("seq_len", [2, 3, 4])
def test_perm_enumeration_equals_jax(seq_len):
    dup = jg.single_graph(3, [0, 0, 0, 1, 2, 1], [1, 1, 2, 2, 0, 1])
    n_dup = 0
    for rec in _records(seq_len) + [dup, jg.add_reversed_edges(dup, 1)]:
        assert tdl.count_perms(rec, seq_len) == jdl.count_perms(rec, seq_len)
        want = jdl.record_to_lrp_perms(rec, seq_len)
        assert_perms_equal(tdl.record_to_lrp_perms(rec, seq_len), want)
        p_max = int(want["n_perm"]) + 3
        assert_perms_equal(tdl.record_to_lrp_perms(rec, seq_len, p_max),
                           jdl.record_to_lrp_perms(rec, seq_len, p_max))
        n_dup += int(want["perm_edge_mask"].sum())
        if want["n_perm"] > 0:
            with pytest.raises(ValueError, match="exceed"):
                tdl.record_to_lrp_perms(rec, seq_len, int(want["n_perm"]) - 1)
    assert n_dup > 0
    # the last of the duplicate (0, 1) edges wins
    perms = tdl.record_to_lrp_perms(dup, seq_len)
    cells = perms["perm_edge"][perms["perm_edge_mask"]]
    assert 1 in cells and 0 not in cells


def _lrp_datasets(n=16, seed=21):
    kw = dict(pv=3, pe=3, gv=8, ge=16, num_vlabels=2, num_elabels=2,
              p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    return [mod.GraphAdjDataset(jsyn.generate_dataset(n, seed=seed, **kw))
            .add_reversed_edges(2, 2) for mod in (jds, tds)]


def assert_lrp_batch_equal(t_batch, j_batch):
    assert isinstance(t_batch, tlrp.LRPGraphBatch)
    assert_batch_equal(t_batch, j_batch)
    for f in PERM_FIELDS:
        got = getattr(t_batch, f)
        assert got.dtype == (torch.bool if "mask" in f else torch.int64), f
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(j_batch, f)),
                                      err_msg=f)


def test_batchify_lrp_equals_jax():
    """The collate, through CollateView("lrp"), batch for batch; a later
    batch whose perm envelope is larger enumerates a record again, a
    smaller one slices its cached tables."""
    jd, td = _lrp_datasets()
    jv = jds.CollateView(jd, "lrp", lrp_seq_len=4)
    tv = tds.CollateView(td, "lrp", lrp_seq_len=4)
    for idx in ([0, 5, 7, 3], list(range(16)), [3, 0]):
        a, b = jv.batchify(idx, "nodeedge"), tv.batchify(idx, "nodeedge")
        assert a[0] == b[0]
        assert_lrp_batch_equal(b[1], a[1])
        assert_lrp_batch_equal(b[2], a[2])
        for x, y in zip((a[3], *a[4]), (b[3], *b[4])):
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
    assert tds.collate_kind_for("DMPLRP") == "lrp"
    # the same records through the EdgeSeq collate (CNN, RNN, TXL)
    a = jds.CollateView(jd, "edgeseq").batchify([0, 5, 7, 3], "edge")
    b = tds.CollateView(td, "edgeseq").batchify([0, 5, 7, 3], "edge")
    for f in ("u", "v", "el", "mask", "rev_flag"):
        np.testing.assert_array_equal(getattr(b[2], f).numpy(),
                                      np.asarray(getattr(a[2], f)))
    np.testing.assert_array_equal(b[4][1].numpy(), np.asarray(a[4][1]))


def test_lrp_batch_to_and_slice_keep_the_perm_tables():
    _, td = _lrp_datasets(n=6)
    _, _, graph, _, _ = td.batchify_lrp(range(6))
    for got, rows in ((graph.to("cpu"), slice(None)),
                      (graph.slice(slice(2, 5)), slice(2, 5)),
                      (graph.to("cpu", True).slice(slice(1, 2)),
                       slice(1, 2))):
        assert isinstance(got, tlrp.LRPGraphBatch)
        for f in PERM_FIELDS + ("senders", "node_mask"):
            assert torch.equal(getattr(got, f), getattr(graph, f)[rows]), f
    assert graph.replace(n_node=graph.n_node + 1).perm_node is \
        graph.perm_node


@pytest.fixture(scope="module")
def lrp_graphs():
    pats, gras = make_records(5, 4, 4, 12, 24, 4, 4, seed=8)
    jb, tb = lrp_batches(pats, gras, *batches(pats, gras))
    return jb[1], tb[1]


def test_perm_project_and_pool_match_jax(lrp_graphs):
    jgr, tgr = lrp_graphs
    rng = np.random.default_rng(2)
    b, v, e = 5, 12, 48
    p = tgr.perm_node.shape[1]
    h = rng.normal(size=(b, v, 6)).astype(np.float32)
    x = rng.normal(size=(b, e, 6)).astype(np.float32)
    w = rng.normal(size=(6, 7, 16)).astype(np.float32)
    cot = rng.normal(size=(b, v, 7)).astype(np.float32)

    def f(hh, xx, ww):
        return jlrp.perm_mean_pool(jgr, jlrp.perm_project(jgr, hh, xx, ww, 4))

    def run(args, c):
        out, vjp = jax.vjp(f, *args)
        return out, vjp(c), jlrp.perm_project(jgr, *args, 4)

    out, jgrads, want = jax.jit(run)(tuple(jnp.asarray(a) for a in (h, x, w)),
                                     jnp.asarray(cot))
    ht, xt, wt = (torch.from_numpy(a).requires_grad_() for a in (h, x, w))
    proj = tlrp.perm_project(tgr, ht, xt, wt, 4)
    assert proj.shape == (b, p, 7)
    got = tlrp.perm_mean_pool(tgr, proj)
    nm = tgr.node_mask.numpy()
    close_to_max(got.detach().numpy()[nm], np.asarray(out)[nm], 1e-5)
    got.backward(torch.from_numpy(cot))
    for t, j, name in zip((ht, xt, wt), jgrads, "hxw"):
        close_to_max(t.grad, j, 1e-4, name)
    # the projection alone, on the real perms
    pm = tgr.perm_mask.numpy()
    close_to_max(proj.detach().numpy()[pm], np.asarray(want)[pm], 1e-5)


def test_pool_counts_past_256_under_bf16():
    """A node with out-degree 8 owns 8 * 7 * 6 = 336 perms, here 256 of
    them with feature 1 and 80 with 0: the mean is 256/336. The port sums
    the rows and counts the perms in float32 (K3) and its bf16 mean is
    that to bf16 rounding. The JAX package sums both in bf16 under amp,
    where 256 + 1 rounds back to 256, and gets 256/256 = 1 (ROADMAP queue
    3)."""
    rec = jg.single_graph(9, [0] * 8, list(range(1, 9)))
    (_, jp), (_, tp) = lrp_batches([rec], [rec], *batches([rec], [rec]))
    owner = tp.perm_owner[0].numpy()
    assert (owner == 0).sum() == 336 and (owner[:336] == 0).all()
    feat = np.zeros((1, len(owner), 3), np.float32)
    feat[0, :256] = 1.0
    got = tlrp.perm_mean_pool(tp, torch.from_numpy(feat).bfloat16())
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy()[0, 0], 256 / 336,
                               rtol=2 ** -8)
    np.testing.assert_array_equal(got.float().numpy()[0, 1:], 0.0)
    jax_bf16 = np.asarray(jlrp.perm_mean_pool(
        jp, jnp.asarray(feat, jnp.bfloat16)), np.float32)
    np.testing.assert_array_equal(jax_bf16[0, 0], 1.0)
    np.testing.assert_allclose(np.asarray(jlrp.perm_mean_pool(
        jp, jnp.asarray(feat)))[0, 0], 256 / 336, rtol=1e-6)


# LRP with BatchNorm also at seq_len 3 (3 + 9 cells a perm)
LRP_MODELS = {"LRP": {}, "DMPLRP": {},
              "LRP-bn": dict(rep_lrp_batch_norm=True, lrp_seq_len=3)}


@pytest.mark.parametrize("name", list(LRP_MODELS))
def test_model_forward_loss_and_gradients_match_jax(name):
    check_model_f32(family_case(name.split("-")[0], **LRP_MODELS[name]))


@pytest.mark.parametrize("net", ["LRP", "DMPLRP"])
def test_model_amp_against_jax_amp_error(net):
    check_model_amp(family_case(net))


@pytest.mark.parametrize("net, kw", [("LRP", {}), ("DMPLRP", {}),
                                     ("LRP", {"pred_with_deg": True,
                                              "share_rep_net": False})])
def test_k3_calls_equal_the_derived_count(net, kw, monkeypatch):
    cfg = small_config(rep_net=net, **kw)
    pats, gras = make_records(4, 4, 4, 12, 24, 4, 4, seed=5)
    _, tb = lrp_batches(pats, gras, *batches(pats, gras))
    assert count_k3_calls(cfg, tb, monkeypatch) == (
        sm.k3_launches(cfg, train=False), sm.k3_launches(cfg, train=True))


def test_a_plain_batch_is_refused():
    m = sm.build_model(small_config(rep_net="LRP"), device="cpu")
    _, tb = batches(*make_records(2, 4, 4, 12, 24, 4, 4, seed=1))
    with pytest.raises(TypeError, match="LRPGraphBatch"):
        tdrv.apply_model(m, *tb)


class GradRecorder:
    """An optimizer that applies nothing and keeps the gradient each
    step hands it."""

    def __init__(self, params):
        self.params = list(params)
        self.count = 0
        self.grads = None

    def zero_grad(self):
        for p in self.params:
            p.grad = None

    def step(self, lr_mult=1.0):
        self.grads = [p.grad.clone() for p in self.params]


@pytest.mark.parametrize("net", ["LRP", "DMPLRP"])
def test_chunked_train_step_equals_one_step(net):
    """make_train_step with accum_chunks=2 slices the LRP batches into two
    microbatches (GraphBatch.slice keeps the perm tables): the losses and
    the gradient it hands the optimizer equal one unchunked step's (the
    rep regulariser off: it is each chunk's own mean)."""
    _, td = _lrp_datasets(n=8)
    _, pat, gra, counts, (nw, ew) = td.batchify_lrp(range(8), "nodeedge")
    cfg = small_config(rep_net=net, max_ngv=8, max_ngvl=2, max_nge=32,
                       max_ngel=4, max_npvl=2, max_npel=4)
    m = sm.build_model(cfg, device="cpu", seed=2)
    gen = torch.Generator().manual_seed(0)
    with torch.no_grad():
        for p in m.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    out = []
    for k in (1, 2):
        rec = GradRecorder(m.parameters())
        step = tdrv.make_train_step(m, rec, return_weights="nodeedge",
                                    accum_chunks=k)
        losses = step(pat, gra, counts, nw, ew, 0.2, 0.1, 0.05, 0.0)
        out.append((losses, rec.grads))
    (l1, g1), (l2, g2) = out
    for name in l1:
        np.testing.assert_allclose(l2[name].item(), l1[name].item(),
                                   rtol=1e-6, atol=1e-8, err_msg=name)
    gmax = max(float(g.abs().max()) for g in g1)
    assert gmax > 0
    for a, b in zip(g2, g1):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6 * gmax)
