"""Port host pipeline (dualmessagepassing_tpu_torch/unc/data.py, the CSR
plan of ops/segment_kernel.py) against the JAX package's host code.

Every comparison feeds both packages the same inputs and a
np.random.default_rng of the same seed, and requires identical arrays
(the code is host numpy in both; no tolerance applies). The samplers
are checked on the native C++ path and on the numpy fallback.
"""

import numpy as np
import pytest

from dualmessagepassing_tpu import native as jax_native
from dualmessagepassing_tpu.unc import data as jd
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu_torch import native as t_native
from dualmessagepassing_tpu_torch.ops.segment_kernel import attach_csr_plan
from dualmessagepassing_tpu_torch.unc import data as td
from dualmessagepassing_tpu_torch.unc import driver as tdrv


def tiny_hin(seed=0, n=60, e=240, r=3):
    """A small heterogeneous graph as (triplets, num_nodes, num_rels)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, n, e)
    dst = (src + rng.integers(1, n, e)) % n
    rel = rng.integers(0, r, e)
    return np.stack([src, rel, dst], axis=1).astype(np.int64), n, r


def assert_same_dict(a, b):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)
        assert np.asarray(a[k]).dtype == np.asarray(b[k]).dtype, k


@pytest.fixture(params=["native", "numpy"])
def sampler_impl(request, monkeypatch):
    if request.param == "native":
        if not (jax_native.available() and t_native.available()):
            pytest.skip("g++ could not build the native host sampler")
    else:
        monkeypatch.setattr(jax_native, "available", lambda: False)
        monkeypatch.setattr(t_native, "available", lambda: False)
    return request.param


def test_load_unsupervised_and_whole_graph(tmp_path):
    t, n, r = tiny_hin()
    path = tmp_path / "link.dat"
    with open(path, "w") as f:
        f.write(f"{n} {r}\n")
        for row in t:
            f.write("%d %d %d\n" % tuple(row))
    a, b = jd.load_unsupervised(str(path)), td.load_unsupervised(str(path))
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1:] == b[1:]
    ga, gb = jd.WholeGraph(n, r, t), td.WholeGraph(n, r, t)
    for k in ("senders", "receivers", "edge_type", "in_order", "in_ptr",
              "out_order", "out_ptr", "in_deg", "out_deg"):
        np.testing.assert_array_equal(getattr(ga, k), getattr(gb, k))


@pytest.mark.parametrize("kind", ["randomwalk", "neighbor"])
def test_samplers_match(sampler_impl, kind):
    t, n, r = tiny_hin()
    seeds = np.unique(t[:10, [0, 2]].reshape(-1))
    ga, gb = jd.WholeGraph(n, r, t), td.WholeGraph(n, r, t)
    fa = getattr(jd, f"sample_subgraph_by_{kind}s"
                 if kind == "randomwalk" else "sample_subgraph_by_neighbors")
    fb = getattr(td, f"sample_subgraph_by_{kind}s"
                 if kind == "randomwalk" else "sample_subgraph_by_neighbors")
    a = fa(ga, seeds, 3, 5, np.random.default_rng(7))
    b = fb(gb, seeds, 3, 5, np.random.default_rng(7))
    assert_same_dict(a, b)


def test_negative_sampling_dropout_and_norms():
    t, n, r = tiny_hin()
    np.testing.assert_array_equal(
        jd.negative_sampling(t[:50], n, 5, np.random.default_rng(3)),
        td.negative_sampling(t[:50], n, 5, np.random.default_rng(3)))
    g = jd.WholeGraph(n, r, t)
    sub = jd.sample_subgraph_by_neighbors(
        g, np.arange(20), 2, 6, np.random.default_rng(4))
    assert_same_dict(jd.edge_dropout(sub, 0.5, np.random.default_rng(5)),
                     td.edge_dropout(sub, 0.5, np.random.default_rng(5)))
    for norm in ("in", "out", "both"):
        np.testing.assert_array_equal(jd.compute_edgenorm(sub, norm),
                                      td.compute_edgenorm(sub, norm))
    np.testing.assert_array_equal(
        jd.convert_subgraph_nids(t[:30, 0], sub["nid"]),
        td.convert_subgraph_nids(t[:30, 0], sub["nid"]))


@pytest.mark.parametrize("with_norm", [True, False])
def test_pad_subgraph_matches(with_norm):
    """Equal to the JAX package's forward-only padding (send_keys=False)."""
    t, n, r = tiny_hin()
    g = jd.WholeGraph(n, r, t)
    sub = jd.sample_subgraph_by_randomwalks(
        g, np.arange(15), 2, 5, np.random.default_rng(6))
    samples = np.stack([np.arange(8), np.zeros(8, np.int64),
                        np.arange(8)[::-1]], 1)
    labels = np.ones(8, np.float32)
    norm = jd.compute_edgenorm(sub) if with_norm else None
    e_max = len(sub["senders"]) + 37
    assert_same_dict(
        jd.pad_subgraph(sub, samples, labels, n, e_max, 12, edge_norm=norm,
                        send_keys=False),
        td.pad_subgraph(sub, samples, labels, n, e_max, 12, edge_norm=norm))
    with pytest.raises(ValueError):
        td.pad_subgraph(sub, samples, labels, n, len(sub["senders"]) - 1, 12)


@pytest.mark.parametrize("sampler", ["randomwalk", "neighbor"])
def test_sample_batch_matches(sampler_impl, sampler):
    t, n, r = tiny_hin()
    g_a, g_b = jd.WholeGraph(n, r, t), td.WholeGraph(n, r, t)
    args = (sampler, 3, 5, 0.5, 5, n, min(n * 5, g_a.num_edges), 40 * 6)
    a = jdrv.sample_batch(g_a, t[:40], *args, np.random.default_rng(11),
                          send_keys=False)
    b = tdrv.sample_batch(g_b, t[:40], *args, np.random.default_rng(11))
    assert_same_dict(a, b)


def test_save_embeddings_byte_for_byte(tmp_path):
    embs = np.random.default_rng(2).normal(size=(7, 5)).astype(np.float32)
    pa, pb = tmp_path / "a.dat", tmp_path / "b.dat"
    jd.save_embeddings(str(pa), "header --n-hidden 5", embs)
    td.save_embeddings(str(pb), "header --n-hidden 5", embs)
    assert pa.read_bytes() == pb.read_bytes()
    idx = np.arange(7)[::-1]
    jd.save_embeddings(str(pa), "h", embs, idx)
    td.save_embeddings(str(pb), "h", embs, idx)
    assert pa.read_bytes() == pb.read_bytes()


def test_csr_plan_excludes_pads():
    """sk_rowptr covers the real prefix only: the pad tail repeats the
    last real receiver, and no row may claim a pad slot."""
    t, n, r = tiny_hin()
    g = jd.WholeGraph(n, r, t)
    padded = jdrv.sample_batch(g, t[:40], "randomwalk", 3, 5, 0.5, 5, n,
                               g.num_edges, 240, np.random.default_rng(1),
                               send_keys=False)
    n_real = int(padded["edge_mask"].sum())
    assert n_real < len(padded["receivers"])       # the case has pads
    plan = attach_csr_plan(padded)
    rp = plan["sk_rowptr"]
    assert rp.dtype == np.int32 and rp.shape == (n + 1,)
    assert plan["n_real"] == n_real == rp[-1]
    recv = padded["receivers"][:n_real]
    np.testing.assert_array_equal(
        np.repeat(np.arange(n), np.diff(rp)), recv)
    # a row pointer built over the whole padded stream would differ
    full = np.searchsorted(padded["receivers"], np.arange(n + 1))
    assert full[-1] == len(padded["receivers"]) != rp[-1]


def test_csr_plan_rejects_unsorted():
    padded = {"node_mask": np.ones(4, bool),
              "edge_mask": np.array([True, True, True, False]),
              "receivers": np.array([2, 1, 3, 3])}
    with pytest.raises(ValueError):
        attach_csr_plan(padded)
