"""Host data of the port's SCM path against the JAX package, array for
array: the graph records and batches (dualmessagepassing_tpu_torch/
graph.py), the subgraph-isomorphism ground truth (data/subiso.py, native
and numpy), the synthetic pairs (data/synthetic.py), the dataset and its
collate (data/dataset.py), the eigenvalue bounds (ops/spectral.py), the
samplers (train/samplers.py), the schedules (train/schedules.py) and the
position table (ops/encoding.py). Everything here is host numpy, so the
arrays must be equal, not close.

Also the shared helpers of the tests/test_torch_scm_*.py files: small
flagship-shaped configurations and batches, made from a seed with numpy.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu import graph as jg
from dualmessagepassing_tpu import native as jnative
from dualmessagepassing_tpu.data import dataset as jds
from dualmessagepassing_tpu.data import subiso as jsub
from dualmessagepassing_tpu.data import synthetic as jsyn
from dualmessagepassing_tpu.models.basemodel import ModelConfig as JConfig
from dualmessagepassing_tpu.ops import encoding as jenc
from dualmessagepassing_tpu.ops import spectral as jspec
from dualmessagepassing_tpu.train import samplers as jsmp
from dualmessagepassing_tpu.train import schedules as jsch
from dualmessagepassing_tpu_torch import graph as tg
from dualmessagepassing_tpu_torch import native as tnative
from dualmessagepassing_tpu_torch.data import dataset as tds
from dualmessagepassing_tpu_torch.data import subiso as tsub
from dualmessagepassing_tpu_torch.data import synthetic as tsyn
from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
from dualmessagepassing_tpu_torch.ops import encoding as tenc
from dualmessagepassing_tpu_torch.ops import spectral as tspec
from dualmessagepassing_tpu_torch.train import samplers as tsmp
from dualmessagepassing_tpu_torch.train import schedules as tsch

GRAPH_FIELDS = ("senders", "receivers", "node_id", "node_label",
                "edge_label", "node_mask", "edge_mask", "rev_flag",
                "n_node", "n_edge")

# ---------------------------------------------------------------------------
# shared helpers
# ---------------------------------------------------------------------------


def small_config(**kw) -> ModelConfig:
    """__graft_entry__._flagship_config's options (ScalarFilter,
    SumPredictNet, nodeedge, reversed edges doubling E and the edge
    labels) on a small envelope: pattern <= 4V/4E, graph <= 12V/24E,
    4 labels, hid 16, 2 layers."""
    base = dict(max_ngv=12, max_ngvl=4, max_nge=2 * 24, max_ngel=2 * 4,
                max_npv=4, max_npvl=4, max_npe=2 * 4, max_npel=2 * 4,
                hid_dim=16, rep_num_pattern_layers=2, rep_num_graph_layers=2,
                pred_hid_dim=16, filter_net="ScalarFilter",
                pred_return_weights="nodeedge")
    base.update(kw)
    return ModelConfig(**base)


def jax_config(cfg: ModelConfig) -> JConfig:
    return JConfig(**dataclasses.asdict(cfg))


def make_records(bsz, pv, pe, gv, ge, nvl, nel, seed=0, ragged=True):
    """(pattern records, graph records): __graft_entry__._make_batch's
    random graphs with reversed edges; ragged=True draws each graph's
    true size below the envelope, so every batch has pad slots."""
    rng = np.random.default_rng(seed)
    pats, gras = [], []
    for _ in range(bsz):
        recs = []
        for v, e in ((pv, pe), (gv, ge)):
            nv = int(rng.integers(2, v + 1)) if ragged else v
            ne = int(rng.integers(1, e + 1)) if ragged else e
            r = jg.single_graph(
                nv, rng.integers(0, nv, ne), rng.integers(0, nv, ne),
                node_labels=rng.integers(0, nvl, nv),
                edge_labels=rng.integers(0, nel, ne), v_max=v, e_max=e)
            recs.append(jg.add_reversed_edges(r, nel))
        pats.append(recs[0])
        gras.append(recs[1])
    return pats, gras


def batches(pats, gras):
    """-> (JAX GraphBatch pair, port GraphBatch pair) of the records."""
    return ((jg.batch_graphs(pats), jg.batch_graphs(gras)),
            (tg.batch_graphs(pats), tg.batch_graphs(gras)))


def assert_batch_equal(t_batch, j_batch):
    for f in GRAPH_FIELDS:
        np.testing.assert_array_equal(getattr(t_batch, f).numpy(),
                                      np.asarray(getattr(j_batch, f)),
                                      err_msg=f)


# ---------------------------------------------------------------------------
# graph records and batches
# ---------------------------------------------------------------------------

def test_single_graph_and_reversed_edges_equal_jax():
    rng = np.random.default_rng(0)
    s, r = rng.integers(0, 5, 7), rng.integers(0, 5, 7)
    vl, el = rng.integers(0, 3, 5), rng.integers(0, 2, 7)
    a = jg.single_graph(5, s, r, vl, el, v_max=8, e_max=10)
    b = tg.single_graph(5, s, r, vl, el, v_max=8, e_max=10)
    for ra, rb in ((a, b), (jg.add_reversed_edges(a, 2),
                            tg.add_reversed_edges(b, 2))):
        assert set(ra) == set(rb)
        for k in ra:
            np.testing.assert_array_equal(rb[k], ra[k], err_msg=k)
            assert np.asarray(rb[k]).dtype == np.asarray(ra[k]).dtype, k
    with pytest.raises(ValueError):
        tg.single_graph(9, s, r, v_max=8, e_max=10)


def test_compact_record_equals_jax():
    rec = jg.single_graph(4, [0, 1, 2], [1, 2, 3], v_max=4, e_max=6)
    rec["edge_mask"] = np.array([True, False, True, False, True, False])
    a, b = jg.compact_record(rec), tg.compact_record(rec)
    for k in a:
        np.testing.assert_array_equal(b[k], a[k], err_msg=k)


def test_batch_graphs_and_dense_collate_equal_jax():
    pats, gras = make_records(5, 4, 4, 12, 24, 4, 4, seed=1)
    (jp, jgr), (tp, tgr) = batches(pats, gras)
    assert_batch_equal(tp, jp)
    assert_batch_equal(tgr, jgr)
    assert tp.senders.dtype == torch.int64 and tp.edge_mask.dtype == torch.bool
    assert (tgr.batch_size, tgr.max_nodes, tgr.max_edges) == (5, 12, 48)
    dense = {k: np.stack([r[k] for r in gras]) for k in GRAPH_FIELDS}
    idx = np.array([3, 0, 4])
    assert_batch_equal(tg.batch_graphs_dense(dense, idx),
                       jg.batch_graphs([gras[i] for i in idx]))
    # to(), slice() and flatten() keep every field
    half = tgr.to("cpu").slice(slice(1, 3))
    assert_batch_equal(half, jg.batch_graphs(gras[1:3]))
    flat_t, flat_j = tgr.flatten(), jgr.flatten()
    assert flat_t.num_nodes == flat_j.num_nodes
    for f in ("senders", "receivers", "edge_mask", "rev_flag"):
        np.testing.assert_array_equal(getattr(flat_t, f).numpy(),
                                      np.asarray(getattr(flat_j, f)))


def test_degrees_equal_jax():
    pats, gras = make_records(4, 4, 4, 12, 24, 4, 4, seed=2)
    (_, jgr), (_, tgr) = batches(pats, gras)
    np.testing.assert_array_equal(tgr.out_degrees().numpy(),
                                  np.asarray(jgr.out_degrees()))
    np.testing.assert_array_equal(tgr.in_degrees().numpy(),
                                  np.asarray(jgr.in_degrees()))
    assert tgr.out_degrees().dtype == torch.float32


# ---------------------------------------------------------------------------
# subisomorphisms and synthetic pairs
# ---------------------------------------------------------------------------

def _pair_arrays(seed):
    """A pattern planted twice into a random graph (generate_pair's
    plant), as int64 arrays of the real nodes and edges."""
    x = jsyn.generate_pair(np.random.default_rng(seed), pv=3, pe=3, gv=8,
                           ge=20, plant=2)
    out = []
    for rec in (x["pattern"], x["graph"]):
        m = rec["edge_mask"]
        out += [rec[k][m].astype(np.int64) for k in ("senders", "receivers")]
        out += [rec["node_label"][: int(rec["n_node"])].astype(np.int64),
                rec["edge_label"][m].astype(np.int64)]
    return out


@pytest.mark.parametrize("use_native", [True, False])
def test_subisomorphisms_and_weights_equal_jax(use_native):
    """The enumerator and the edge weights, through the C++ kernels and
    through numpy, against the JAX package's numpy enumerator."""
    assert tnative.available() == jnative.available()
    found = 0
    for seed in range(6):
        ps, pr, pvl, pel, gs, gr, gvl, gel = _pair_arrays(seed)
        want = jsub.enumerate_subisomorphisms(ps, pr, pvl, pel, gs, gr, gvl,
                                              gel, use_native=False)
        got = tsub.enumerate_subisomorphisms(ps, pr, pvl, pel, gs, gr, gvl,
                                             gel, use_native=use_native)
        np.testing.assert_array_equal(got, want)
        found += len(want)
        np.testing.assert_array_equal(tsub.node_subiso_weights(8, got),
                                      jsub.node_subiso_weights(8, want))
        np.testing.assert_array_equal(
            tsub.edge_subiso_weights(ps, pr, pel, gs, gr, gel, got,
                                     use_native=use_native),
            jsub.edge_subiso_weights(ps, pr, pel, gs, gr, gel, want))
    assert found > 0


def test_generate_dataset_equals_jax():
    kw = dict(pv=3, pe=3, gv=8, ge=16, num_vlabels=2, num_elabels=2,
              p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    a = jsyn.generate_dataset(12, seed=13, **kw)
    b = tsyn.generate_dataset(12, seed=13, **kw)
    planted = jsyn.generate_dataset(3, seed=2, plant=2, **kw)
    assert [x["counts"] for x in a] == [x["counts"] for x in b]
    for x, y in zip(a + planted, b + tsyn.generate_dataset(3, seed=2,
                                                           plant=2, **kw)):
        assert x["id"] == y["id"] and x["counts"] == y["counts"]
        for k in ("subisomorphisms", "node_weights", "edge_weights"):
            np.testing.assert_array_equal(y[k], x[k], err_msg=k)
        for side in ("pattern", "graph"):
            for k in x[side]:
                np.testing.assert_array_equal(y[side][k], x[side][k])
    with pytest.raises(ValueError):
        tsyn.generate_pair(np.random.default_rng(0), pv=9, gv=8, plant=1)


# ---------------------------------------------------------------------------
# dataset, collate, bounds
# ---------------------------------------------------------------------------

def _datasets(n=20, seed=13, rev=True, loops=False):
    kw = dict(pv=3, pe=3, gv=8, ge=16, num_vlabels=2, num_elabels=2,
              p_v_max=4, p_e_max=4, g_v_max=8, g_e_max=16)
    out = []
    for mod in (jds, tds):
        data = jsyn.generate_dataset(n, seed=seed, **kw)
        if loops:   # a self loop in every graph
            for x in data:
                x["graph"]["receivers"][0] = x["graph"]["senders"][0]
        ds = mod.GraphAdjDataset(data)
        if loops:
            ds.remove_loops()
        if rev:
            ds.add_reversed_edges(2, 2)
        out.append(ds)
    return out


@pytest.mark.parametrize("auto_envelope", [False, True])
@pytest.mark.parametrize("rev, loops", [(True, False), (False, True)])
def test_batchify_equals_jax(auto_envelope, rev, loops):
    jd, td = _datasets(rev=rev, loops=loops)
    jv = jds.CollateView(jd, "graph", auto_envelope=auto_envelope)
    tv = tds.CollateView(td, "graph", auto_envelope=auto_envelope)
    assert tv.sizes() == jv.sizes() and len(tv) == len(jv)
    for idx in ([0, 5, 7, 3], list(range(10, 20))):
        a, b = jv.batchify(idx, "nodeedge"), tv.batchify(idx, "nodeedge")
        assert a[0] == b[0]
        assert_batch_equal(b[1], a[1])
        assert_batch_equal(b[2], a[2])
        for x, y in zip((a[3], *a[4]), (b[3], *b[4])):
            assert y.dtype == torch.float32
            np.testing.assert_array_equal(y.numpy(), np.asarray(x))
        c = td.batchify(idx, "none")
        assert c[4] == (None, None)
    assert td.compute_eigenvalue_bounds() == jd.compute_eigenvalue_bounds()
    # the EdgeSeq collate of CNN, RNN and TXL (tests/test_torch_scm_
    # edgeseq_data.py holds it field for field)
    idx = [0, 5, 7, 3]
    a = jds.CollateView(jd, "edgeseq").batchify(idx, "edge")
    b = tds.CollateView(td, "edgeseq").batchify(idx, "edge")
    for f in ("u", "v", "ul", "el", "vl", "mask", "rev_flag"):
        np.testing.assert_array_equal(getattr(b[2], f).numpy(),
                                      np.asarray(getattr(a[2], f)))
    np.testing.assert_array_equal(b[4][1].numpy(), np.asarray(a[4][1]))
    assert tds.collate_kind_for("CNN") == jds.collate_kind_for("CNN")


def test_dataset_save_load_round_trip(tmp_path):
    _, td = _datasets(n=4)
    td.save(str(tmp_path / "d.pkl"))
    back = tds.GraphAdjDataset().load(str(tmp_path / "d.pkl"))
    assert back.sizes() == td.sizes()
    assert_batch_equal(back.batchify([1, 2])[2], td.batchify([1, 2])[2])


def test_spectral_host_helpers_equal_jax():
    rng = np.random.default_rng(4)
    s, r = rng.integers(0, 9, 30), rng.integers(0, 9, 30)
    mask = rng.random(30) < 0.8
    for a, b in ((tspec.degrees_np(s, r, 9, mask),
                  jspec.degrees_np(s, r, 9, mask)),
                 (tspec.compute_norm_np(s, r, 9, True, mask),
                  jspec.compute_norm_np(s, r, 9, True, mask)),
                 (tspec.compute_norm_np(s, r, 9, False),
                  jspec.compute_norm_np(s, r, 9, False))):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    assert tspec.largest_eigenvalue_bounds_np(s, r, 9, mask) == \
        jspec.largest_eigenvalue_bounds_np(s, r, 9, mask)
    assert tspec.largest_eigenvalue_bounds_np(s[:0], r[:0], 9) == (0.0, 0.0)


# ---------------------------------------------------------------------------
# samplers, schedules, encodings
# ---------------------------------------------------------------------------

def _sizes(n, seed=3):
    rng = np.random.default_rng(seed)
    return [{"g_len": int(a), "p_len": int(b)}
            for a, b in zip(rng.integers(1, 30, n), rng.integers(1, 6, n))]


@pytest.mark.parametrize("shuffle, drop_last", [(False, False),
                                                 (True, False), (True, True)])
def test_bucket_sampler_order_equals_jax(shuffle, drop_last):
    sizes = _sizes(37)
    a = jsmp.BucketSampler(sizes, ["g_len", "p_len"], 8, shuffle, 5,
                           drop_last)
    b = tsmp.BucketSampler(sizes, ["g_len", "p_len"], 8, shuffle, 5,
                           drop_last)
    assert len(a) == len(b) and a.full_len == b.full_len
    for epoch in range(3):
        a.set_epoch(epoch)
        b.set_epoch(epoch)
        for x, y in zip(list(a), list(b), strict=True):
            np.testing.assert_array_equal(y, x)


@pytest.mark.parametrize("learning_by, group_by",
                         [("g_len", None), ("p_len", ["g_len", "p_len"])])
def test_curriculum_sampler_order_equals_jax(learning_by, group_by):
    sizes = _sizes(41, seed=4)
    for ratio in (0.5, 0.75, 1.0):
        a = jsmp.CurriculumSampler(sizes, learning_by, ratio, 8, group_by,
                                   True, 2)
        b = tsmp.CurriculumSampler(sizes, learning_by, ratio, 8, group_by,
                                   True, 2)
        assert len(a) == len(b)
        for x, y in zip(list(a), list(b), strict=True):
            np.testing.assert_array_equal(y, x)


def test_schedules_equal_jax():
    for spec in (0.2, "0.5", "anneal_cosine$1.0$0.01",
                 "anneal_linear$0.0$1.0", "cyclical_linear$0.0$1.0",
                 "cyclical_cosine$1.0$0.0"):
        a, b = jsch.scalar_schedule(spec, 500), tsch.scalar_schedule(spec, 500)
        assert [a(s) for s in range(0, 520, 7)] == \
            [b(s) for s in range(0, 520, 7)]
    for name in ("constant", "constant_with_warmup", "linear",
                 "linear_with_warmup", "linear_with_warmup_and_restart",
                 "cosine", "cosine_with_warmup",
                 "cosine_with_warmup_and_restart"):
        a = jsch.lr_schedule(name, 30, 400, 2, 1e-3)
        b = tsch.lr_schedule(name, 30, 400, 2, 1e-3)
        assert [a(s) for s in range(0, 420, 3)] == \
            [b(s) for s in range(0, 420, 3)]
    cfg = {"train_batch_size": 32, "train_epochs": 10,
           "early_stop_rounds": 3, "weight_decay": 1e-5}
    assert tsch.derive_schedule_config(4096, cfg) == \
        jsch.derive_schedule_config(4096, cfg)
    assert [tsch.anneal_fn("cosine", s) for s in (0, 300, 900, 20000)] == \
        [jsch.anneal_fn("cosine", s) for s in (0, 300, 900, 20000)]
    with pytest.raises(ValueError):
        tsch.scalar_schedule("bogus", 10)


def test_position_table_equals_jax():
    np.testing.assert_array_equal(tenc.position_table(10, 17, 0.5),
                                  jenc.position_table(10, 17, 0.5))


def test_small_config_translates_to_jax():
    cfg = small_config()
    assert dataclasses.asdict(jax_config(cfg)) == dataclasses.asdict(cfg)
    assert cfg.enc_dims("graph") == jax_config(cfg).enc_dims("graph")
    assert cfg.replace(hid_dim=8).hid_dim == 8
    jax.tree_util.tree_leaves(())   # jax imported and on the CPU
