"""The halo library of the port (dualmessagepassing_tpu_torch/parallel/
halo.py) and its two benches (bench/halo_bench.py,
bench/partition_bench.py) against the JAX package's
(dualmessagepassing_tpu/parallel/halo.py, scripts/partition_bench.py):

  * assign_owners and build_halo_partition array for array, degree and
    range, at tests/test_halo.py:34's and :83's sizes, at 2 and 8 shards,
    and the invariants of tests/test_halo.py:83;
  * the halo forward over two gloo ranks on the CPU against JAX's
    make_halo_dmp_apply on a 2-device 'ep' mesh of conftest's virtual CPU
    devices (node rows unsharded, edge rows mapped back through
    edge_perm) and against the port's full-sum forward
    (parallel/edge_partition.py), both partitioners, at test_halo.py:34's
    sizes (V 24, E 96, H 8, 2 layers), atol 1e-5 and rtol 1e-5 (the JAX
    test's);
  * halo_bench.run at --v 200 --edges 2000 over the same two ranks (it
    asserts its halo forwards against its full sums itself);
  * partition_bench's records at n 512 over 4 shards equal to the
    script's, but build_s (a host time).

One spawn (tests/test_torch_dist.halo_lib_rank) computes what the
two-rank comparisons read; JAX runs in the pytest process only.
"""

import importlib.util
import json
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from dualmessagepassing_tpu.parallel import edge_partition as jep
from dualmessagepassing_tpu.parallel import halo as jhalo
from dualmessagepassing_tpu_torch.bench import halo_bench, partition_bench
from dualmessagepassing_tpu_torch.parallel import halo as thalo

from test_torch_dist import halo_lib_rank, run_ranks

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(atol=1e-5, rtol=1e-5)
METHODS = ("degree", "range")
BENCH = dict(v=200, edges=[2000], h=64, layers=2, iters=5)


def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("ep",))


def unshard_edges(part, edge_out):
    """Each rank's [Ep, H] edge rows -> [E, H] in the original edge
    order, through edge_perm (tests/test_halo.py:67-76)."""
    ks = part["edge_mask"].sum(1)
    packed = np.concatenate([np.asarray(x)[:k] for x, k in zip(edge_out, ks)])
    out = np.zeros_like(packed)
    out[part["edge_perm"]] = packed
    return out


def _graph(v, e, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, v, e).astype(np.int32),
            rng.integers(0, v, e).astype(np.int32), rng.random(e) < 0.5)


@pytest.mark.parametrize("n", [2, 8])
@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("v, e", [(24, 96), (40, 200)])
def test_partition_equals_the_jax_package(v, e, method, n):
    senders, receivers, rev = _graph(v, e, seed=v + e)
    np.testing.assert_array_equal(
        thalo.assign_owners(senders, receivers, v, n, method),
        jhalo.assign_owners(senders, receivers, v, n, method))
    got = thalo.build_halo_partition(senders, receivers, rev, v, n, method)
    want = jhalo.build_halo_partition(senders, receivers, rev, v, n, method)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[k].dtype == w.dtype, k
            np.testing.assert_array_equal(got[k], w, err_msg=k)
        else:
            assert got[k] == w, k


@pytest.mark.parametrize("method", METHODS)
def test_partition_invariants(method):
    """tests/test_halo.py:83's, and B the largest real boundary."""
    V, E = 40, 200
    senders, receivers, _ = _graph(V, E, seed=83)
    part = thalo.build_halo_partition(senders, receivers, np.zeros(E, bool),
                                      V, 8, method)
    owned = part["owned_slice"]
    assert sorted(owned[owned >= 0].tolist()) == list(range(V))
    assert sorted(part["edge_perm"].tolist()) == list(range(E))
    assert part["edge_mask"].sum() == E
    assert part["send_idx"].max() < part["Vp"]
    # each rank's edges have their receivers in its owned slice
    for s in range(8):
        k = int(part["edge_mask"][s].sum())
        rows = part["local_receivers"][s, :k]
        assert (rows < part["Vp"]).all()
        off = int(part["edge_mask"][:s].sum())
        np.testing.assert_array_equal(
            owned[s][rows], receivers[part["edge_perm"][off: off + k]])
    assert part["send_mask"].sum(-1).max() == part["B"]


def _cases():
    V, E, H, L = 24, 96, 8, 2
    senders, receivers, rev = _graph(V, E, seed=34)
    rng = np.random.default_rng(35)
    node_feat = rng.normal(size=(V, H)).astype(np.float32)
    edge_feat = rng.normal(size=(E, H)).astype(np.float32)
    params = [{k: np.asarray(x) for k, x in layer.items()}
              for layer in jep.init_edge_parallel_params(
                  jax.random.PRNGKey(0), L, H)]
    arrays = jep.pad_to_multiple(
        {"senders": senders, "receivers": receivers, "rev_flag": rev}, 2)
    return {m: dict(V=V, senders=senders, receivers=receivers, rev=rev,
                    node_feat=node_feat, edge_feat=edge_feat, params=params,
                    method=m, arrays=arrays) for m in METHODS}


def _jax_halo(c):
    mesh = mesh2()
    part = jhalo.build_halo_partition(c["senders"], c["receivers"],
                                      c["rev"], c["V"], 2,
                                      method=c["method"])
    sharded = jhalo.shard_halo_arrays(mesh, part, c["node_feat"],
                                      c["edge_feat"])
    fwd = jhalo.make_halo_dmp_apply(mesh, num_layers=len(c["params"]))
    with mesh:
        h, e = jax.jit(fwd)(c["params"],
                            *[sharded[k] for k in jhalo.ARG_ORDER])
    return (jhalo.unshard_nodes(part, h),
            unshard_edges(part, np.asarray(e)), part)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    cases = _cases()
    ranks = run_ranks(halo_lib_rank, tmp_path_factory.mktemp("halo"), cases,
                      BENCH)
    return dict(cases=cases, ranks=ranks,
                jax={m: _jax_halo(c) for m, c in cases.items()})


@pytest.mark.parametrize("method", METHODS)
def test_halo_forward_matches_jax_and_the_full_sum(runs, method):
    c = runs["cases"][method]
    jh, je, part = runs["jax"][method]
    ranks = [r[method] for r in runs["ranks"]]
    h = thalo.unshard_nodes(part, [r["h"] for r in ranks])
    e = unshard_edges(part, [r["e"] for r in ranks])
    np.testing.assert_allclose(h, jh, **TOL)
    np.testing.assert_allclose(e, je, **TOL)
    # the full sum: node rows replicated, edge rows in contiguous blocks
    e_full = np.concatenate([r["e_full"] for r in ranks])[:len(c["senders"])]
    np.testing.assert_allclose(h, ranks[0]["h_full"], **TOL)
    np.testing.assert_allclose(e, e_full, **TOL)
    # the pad slots' edge rows are zero
    for s, r in enumerate(ranks):
        k = int(part["edge_mask"][s].sum())
        assert not r["e"][k:].any()


def test_halo_bench_holds_the_halo_forward_to_the_full_sum(runs):
    recs = runs["ranks"][0]["bench"]
    assert [(r["graph"], r["partition"]) for r in recs] == [
        (g, m) for g in ("power_law", "community95")
        for m in ("range", "degree")]
    for r, r1 in zip(recs, runs["ranks"][1]["bench"]):
        assert r["max_err"] <= halo_bench.HALO_TOL
        assert r["psum_ms"] > 0 and r["halo_ms"] > 0
        assert (r["V"], r["E"], r["ranks"]) == (200, 2000, 2)
        assert r["psum_MB_per_layer"] == round(2 * 200 * 64 * 4 / 2 ** 20, 2)
        assert r["halo_MB_per_layer"] == round(
            2 * r["B_max"] * 64 * 4 / 2 ** 20, 2)
        # the partition fields are the same on both ranks
        assert {k: r1[k] for k in ("B_max", "Vp", "Ep")} == {
            k: r[k] for k in ("B_max", "Vp", "Ep")}


def test_partition_bench_records_equal_the_script(monkeypatch, capsys):
    spec = importlib.util.spec_from_file_location(
        "jax_partition_bench", ROOT / "scripts" / "partition_bench.py")
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    monkeypatch.setattr(sys, "argv", ["partition_bench.py", "512", "4"])
    script.main()
    want = [json.loads(line) for line in capsys.readouterr().out.splitlines()
            if line.startswith("{")]
    got = partition_bench.run(512, 4, print_fn=lambda line: None)
    assert len(got) == len(want) == 6
    for g, w in zip(got, want):
        assert g.pop("build_s") >= 0
        w.pop("build_s")
        assert g == w
