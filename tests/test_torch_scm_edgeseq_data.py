"""The port's EdgeSeq host data against the JAX package, array for array:
the records and batches (dualmessagepassing_tpu_torch/graph.py:
record_to_edgeseq, edgeseq_add_tuples, edgeseq_to_graph,
batch_edgeseqs, EdgeSeqBatch), the EdgeSeq collate (data/dataset.py:
batchify_edgeseq, CollateView(kind="edgeseq")) and its per-record cache;
then the sequence networks' pure functions (models/edgeseq.py): the
pooling of every geometry the JAX package accepts, all-pad end windows
included, rel_shift against the JAX package and the numpy oracle of
tests/test_edgeseq.py, and CNN.refine_edge_weights. Host arrays and
integer results are equal, not close; float pools and shifts equal to
1e-6 (the same sums in another order).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import graph as jg
from dualmessagepassing_tpu.data import dataset as jds
from dualmessagepassing_tpu.data import synthetic as jsyn
from dualmessagepassing_tpu.models import edgeseq as jes
from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch.data import dataset as tds
from dualmessagepassing_tpu_torch.models import edgeseq as tes
from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig

from test_edgeseq import oracle_rel_shift
from test_torch_scm_data import make_records

SEQ_FIELDS = ("u", "v", "ul", "el", "vl", "mask", "rev_flag", "n_tuple")


def assert_records_equal(a, b):
    assert set(a) == set(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]),
                                      err_msg=k)
        assert np.asarray(b[k]).dtype == np.asarray(a[k]).dtype, k


def assert_seq_batch_equal(t, j):
    for f in SEQ_FIELDS:
        np.testing.assert_array_equal(getattr(t, f).numpy(),
                                      np.asarray(getattr(j, f)), err_msg=f)
    assert t.num_nodes == j.num_nodes


# ---------------------------------------------------------------------------
# records and batches
# ---------------------------------------------------------------------------

def test_records_equal_jax():
    """record_to_edgeseq (with "order") on ragged records with reversed
    edges and repeated (u, v) pairs, then edgeseq_add_tuples (equal keys,
    an overflowing envelope) and edgeseq_to_graph."""
    pats, gras = make_records(6, 4, 5, 8, 12, 3, 2, seed=2)
    rng = np.random.default_rng(3)
    for rec in pats + gras:
        a, b = jg.record_to_edgeseq(rec), tg.record_to_edgeseq(rec)
        assert_records_equal(a, b)
        n = int(a["n_tuple"])
        keys = list(zip(b["u"][:n], b["v"][:n], b["el"][:n]))
        assert keys == sorted(keys)
        # equal keys among the new tuples and with existing ones
        new = np.stack([a["u"][:1].repeat(2), a["v"][:1].repeat(2),
                        rng.integers(0, 3, 2), a["el"][:1].repeat(2),
                        rng.integers(0, 3, 2)], 1).astype(a["u"].dtype)
        new = np.concatenate([new, rng.integers(0, 9, (len(a["u"]), 5))
                              .astype(a["u"].dtype)])
        a2, b2 = jg.edgeseq_add_tuples(a, new), tg.edgeseq_add_tuples(b, new)
        assert_records_equal(a2, b2)
        assert len(b2["u"]) == n + len(new)       # the envelope grew
        for kw in ({}, dict(v_max=12, e_max=64)):
            assert_records_equal(jg.edgeseq_to_graph(a2, **kw),
                                 tg.edgeseq_to_graph(b2, **kw))


def test_edgeseq_batch_equals_jax_and_keeps_num_nodes():
    pats, gras = make_records(5, 4, 3, 8, 8, 3, 3, seed=1)
    recs = [tg.record_to_edgeseq(r) for r in gras]
    t = tg.batch_edgeseqs(recs)
    assert_seq_batch_equal(t, jg.batch_edgeseqs(recs))
    assert t.u.dtype == torch.int64 and t.mask.dtype == torch.bool
    assert (t.batch_size, t.max_len, t.num_nodes) == (5, 16, 8)
    part = t.slice(slice(1, 3)).to("cpu")
    assert type(part) is tg.EdgeSeqBatch and part.num_nodes == 8
    assert part.batch_size == 2 and part.device == torch.device("cpu")
    np.testing.assert_array_equal(part.v.numpy(), t.v[1:3].numpy())
    # the degree tables (K3's plain version on the CPU) against the JAX
    # package's one-hot sums
    j = jg.batch_edgeseqs(recs)
    np.testing.assert_array_equal(t.out_degrees().numpy(),
                                  np.asarray(j.out_degrees()))
    np.testing.assert_array_equal(t.in_degrees().numpy(),
                                  np.asarray(j.in_degrees()))


def _datasets(n=24, rev=True, loops=False):
    data = jsyn.generate_dataset(n, seed=5, pv=3, pe=3, gv=8, ge=12,
                                 num_vlabels=2, num_elabels=2, p_v_max=4,
                                 p_e_max=4, g_v_max=8, g_e_max=12)
    out = []
    for _ in range(2):
        ds = (jds.GraphAdjDataset if not out else tds.GraphAdjDataset)(
            [{k: (dict(v) if isinstance(v, dict) else v)
              for k, v in x.items()} for x in data])
        if loops:
            ds.remove_loops()
        if rev:
            ds.add_reversed_edges(2, 2)
        out.append(ds)
    return out


@pytest.mark.parametrize("rev, loops", [(True, False), (False, True)])
def test_edgeseq_collate_equals_jax(rev, loops):
    """CollateView(kind="edgeseq").batchify == the JAX package's, with
    and without the edge weights; the weights follow the tuple sort, so
    each row's sum is the record's."""
    jd, td = _datasets(rev=rev, loops=loops)
    jv, tv = jds.CollateView(jd, "edgeseq"), tds.CollateView(td, "edgeseq")
    for idx in ([0, 5, 7, 3], list(range(10, 20))):
        for weights in ("edge", "node,edge", "none"):
            a, b = jv.batchify(idx, weights), tv.batchify(idx, weights)
            assert a[0] == b[0]
            assert_seq_batch_equal(b[1], a[1])
            assert_seq_batch_equal(b[2], a[2])
            np.testing.assert_array_equal(b[3].numpy(), np.asarray(a[3]))
            assert b[3].dtype == torch.float32 and b[4][0] is None
            if "edge" not in weights:
                assert b[4][1] is None and a[4][1] is None
                continue
            np.testing.assert_array_equal(b[4][1].numpy(),
                                          np.asarray(a[4][1]))
            for row, i in zip(b[4][1].numpy(), idx):
                assert row.sum() == pytest.approx(
                    float(np.sum(td[i]["edge_weights"])), rel=1e-6)
    assert tds.collate_kind_for("TXL") == "edgeseq"
    with pytest.raises(ValueError):
        tds.CollateView(td, "sequence")


def test_edgeseq_cache_follows_the_transforms():
    """Each record caches its sequences beside the record they came from;
    add_reversed_edges replaces the record (the cache is made again) and
    remove_loops changes it in place (the cache is dropped), as in the
    JAX package."""
    jd, td = _datasets(rev=False)
    idx = list(range(8))
    before = td.batchify_edgeseq(idx, "edge")
    assert all("_edgeseq_graph" in td[i] for i in idx)
    cached = td[0]["_edgeseq_graph"][1]
    assert td.batchify_edgeseq([0])[2].u.shape[1] == 12
    assert td[0]["_edgeseq_graph"][1] is cached        # reused
    for ds in (jd, td):
        ds.batchify_edgeseq(idx, "edge")
        ds.remove_loops()
    assert not any("_edgeseq_graph" in td[i] for i in idx)
    for ds in (jd, td):
        ds.add_reversed_edges(2, 2)
    a, b = jd.batchify_edgeseq(idx, "edge"), td.batchify_edgeseq(idx, "edge")
    assert_seq_batch_equal(b[2], a[2])
    np.testing.assert_array_equal(b[4][1].numpy(), np.asarray(a[4][1]))
    assert b[2].u.shape[1] == 2 * before[2].u.shape[1]


# ---------------------------------------------------------------------------
# the sequence networks' pure functions
# ---------------------------------------------------------------------------

# (kernel, stride, padding): the CNN defaults k = 2, 3 (padding k // 2),
# the pool of stride 2 (kernel k // s = 1 with padding 1: both end
# windows lie in the padding), a padding of more than half the window
# (torch's pools refuse it), windows longer than the padded sequence
POOLS = [(2, 1, 1), (3, 1, 1), (2, 2, 1), (1, 1, 1), (3, 2, 3), (4, 2, 2),
         (1, 2, 0), (9, 1, 1), (20, 3, 2)]


@pytest.mark.parametrize("kernel, stride, padding", POOLS)
def test_pools_equal_reduce_window(kernel, stride, padding):
    rng = np.random.default_rng(kernel * 10 + stride)
    x = rng.normal(size=(2, 7, 3)).astype(np.float32)
    for use_max, jfn in ((True, jes._max_pool1d), (False, jes._sum_pool1d)):
        want = np.asarray(jfn(jnp.asarray(x), kernel, stride, padding))
        got = tes._pool1d(torch.from_numpy(x), kernel, stride, padding,
                          use_max).numpy()
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    with pytest.raises(ValueError):
        tes.max_pool1d(torch.from_numpy(x), 0, 1, 1)


def test_rel_shift_equals_jax_and_the_oracle():
    rng = np.random.default_rng(0)
    for shape in ((2, 3, 5, 4), (1, 4, 4, 2), (2, 4, 7, 3)):
        x = rng.normal(size=shape).astype(np.float32)
        got = tes.rel_shift(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, np.asarray(
            jes.rel_shift(jnp.asarray(x))))
        np.testing.assert_array_equal(got, oracle_rel_shift(x))


@pytest.mark.parametrize("geometry", [
    dict(), dict(rep_cnn_kernel_sizes=(3,)),
    dict(rep_cnn_kernel_sizes=(4,), rep_cnn_strides=(2,),
         rep_cnn_paddings=(1,)),
    dict(rep_cnn_kernel_sizes=(2, 3), rep_cnn_strides=(2, 1))])
def test_cnn_refine_equals_jax(geometry):
    """CNN.refine_edge_weights on weights (sum pools) and masks (max
    pools) equals the JAX model's; the JAX model's refine reads only its
    config, so it is called unbound."""
    cfg = ModelConfig(max_ngv=8, max_ngvl=3, max_nge=16, max_ngel=3,
                      max_npv=4, max_npvl=3, max_npe=6, max_npel=3,
                      hid_dim=16, rep_net="CNN", rep_num_graph_layers=2,
                      **geometry)
    from test_torch_scm_data import jax_config
    jm = jes.CNN(jax_config(cfg))
    tm = tes.CNN(cfg)
    rng = np.random.default_rng(1)
    w = rng.poisson(1.0, (3, 16, 1)).astype(np.float32)
    for use_max in (False, True):
        want = np.asarray(jm.refine_edge_weights(jnp.asarray(w), use_max))
        got = tm.refine_edge_weights(torch.from_numpy(w), use_max).numpy()
        np.testing.assert_array_equal(got, want)
    assert tes.cnn_geometry(cfg) == jes.cnn_geometry(jax_config(cfg))
