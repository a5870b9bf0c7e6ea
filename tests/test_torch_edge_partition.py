"""The edge-partitioned demonstration layer of the port
(dualmessagepassing_tpu_torch/parallel/edge_partition.py) over two gloo
ranks on the CPU and on one rank, against the JAX package's
make_edge_parallel_dmp_apply and make_edge_parallel_train_step on a
2-device 'ep' mesh of conftest's virtual CPU devices, at
tests/test_parallel.py's sizes: the forward at :48's (V 12, E 64, H 16,
2 layers), the train step on :114's graph (V 32, 240 triplets doubled,
R 3, H 16, lr 0.05, 6 steps). The same inputs, drawn from the seeds here
with numpy, and the same weights (params_from_jax).

One spawn (tests/test_torch_dist.edge_partition_rank) computes what the
two-rank comparisons read; JAX runs in the pytest process only.

Tolerances: the forward rtol 1e-5, atol 1e-5 on every row, the pad
edges' rows included (JAX leaves them unmasked: their endpoints are node
0); the train step's losses rtol 1e-5, the layer parameters and the
relation table after each step rtol 1e-4, atol 1e-6 (float32 sums in
another order); the two ranks bit for bit equal. A leaky ReLU input
within float32 rounding of zero (chip_smoke.py's FLIP_TOL of its
tensor's largest magnitude) could take the other slope in the port and
part the gradients by more than rounding: the test finds none on these
inputs (a float64 run of the layer at each step's parameters), so the
flip rule has nothing to act on.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from dualmessagepassing_tpu.data.synthetic import generate_large_graph
from dualmessagepassing_tpu.parallel import edge_partition as jep
from dualmessagepassing_tpu_torch.parallel import edge_partition as tep

from test_torch_dist import edge_partition_rank, run_ranks

F32 = dict(rtol=1e-5, atol=1e-5)
PARAMS = dict(rtol=1e-4, atol=1e-6)
# chip_smoke.py's flip rule: a leaky ReLU input within this share of its
# tensor's largest magnitude of zero
FLIP_TOL = 1e-7


def mesh2():
    return Mesh(np.array(jax.devices()[:2]), axis_names=("ep",))


def _numpy_params(params):
    return [{k: np.asarray(v) for k, v in layer.items()} for layer in params]


def _fwd_case(seed=11):
    rng = np.random.default_rng(seed)
    V, E, H = 12, 64, 16
    # padded to a multiple of 6 (66 rows, which two ranks split): E = 64
    # would split without a pad edge
    arrays = jep.pad_to_multiple({
        "senders": rng.integers(0, V, E).astype(np.int32),
        "receivers": rng.integers(0, V, E).astype(np.int32),
        "rev_flag": rng.random(E) < 0.5}, 6)
    node_feat = rng.normal(size=(V, H)).astype(np.float32)
    edge_feat = rng.normal(size=(len(arrays["senders"]), H)).astype(
        np.float32)
    params = _numpy_params(jep.init_edge_parallel_params(
        jax.random.PRNGKey(0), 2, H))
    return dict(V=V, arrays=arrays, node_feat=node_feat, edge_feat=edge_feat,
                params=params)


def _step_case(seed=12):
    rng = np.random.default_rng(seed)
    V, H, R = 32, 16, 3
    triplets, _ = generate_large_graph(V, 240, R, seed=1, power_law=True)
    senders = np.concatenate([triplets[:, 0], triplets[:, 2]]).astype(
        np.int32)
    receivers = np.concatenate([triplets[:, 2], triplets[:, 0]]).astype(
        np.int32)
    rev = np.concatenate([np.zeros(240, bool), np.ones(240, bool)])
    arrays = jep.pad_to_multiple(
        {"senders": senders, "receivers": receivers, "rev_flag": rev}, 2)
    return dict(
        V=V, arrays=arrays, lr=0.05, steps=6,
        params=_numpy_params(jep.init_edge_parallel_params(
            jax.random.PRNGKey(0), 2, H)),
        w_rel=(0.1 * np.asarray(jax.random.normal(
            jax.random.PRNGKey(1), (R, H)))).astype(np.float32),
        node_feat=(rng.normal(size=(V, H)) * 0.1).astype(np.float32),
        edge_feat=(rng.normal(size=(len(arrays["senders"]), H)) * 0.1
                   ).astype(np.float32),
        samples=triplets[:64].astype(np.int64),
        labels=(rng.random(64) < 0.5).astype(np.float32))


def _jax_forward(c):
    mesh = mesh2()
    fwd = jep.make_edge_parallel_dmp_apply(mesh, c["V"], num_layers=2)
    with mesh:
        sh = jep.shard_flat_edges(mesh, c["arrays"])
        h, e = jax.jit(fwd)(
            c["params"], jnp.asarray(c["node_feat"]),
            jnp.asarray(c["edge_feat"]), sh["senders"], sh["receivers"],
            sh["rev_flag"], sh["edge_mask"])
    return np.asarray(h), np.asarray(e)


def _jax_steps(c):
    mesh = mesh2()
    step = jep.make_edge_parallel_train_step(mesh, c["V"], 2, lr=c["lr"])
    params, w = c["params"], jnp.asarray(c["w_rel"])
    out = {"losses": [], "params": [], "w_rel": []}
    with mesh:
        sh = jep.shard_flat_edges(mesh, c["arrays"])
        for _ in range(c["steps"]):
            params, w, loss = step(
                params, w, jnp.asarray(c["node_feat"]),
                jnp.asarray(c["edge_feat"]), sh["senders"], sh["receivers"],
                sh["rev_flag"], sh["edge_mask"], jnp.asarray(c["samples"]),
                jnp.asarray(c["labels"]))
            out["losses"].append(float(loss))
            out["params"].append(_numpy_params(params))
            out["w_rel"].append(np.asarray(w))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    fwd, step = _fwd_case(), _step_case()
    ranks = run_ranks(edge_partition_rank, tmp_path_factory.mktemp("ep"),
                      fwd, step)
    one = edge_partition_rank(None, fwd, step)
    return dict(fwd=fwd, step=step, ranks=ranks, one=one,
                jax_fwd=_jax_forward(fwd), jax_steps=_jax_steps(step))


def test_pad_to_multiple_equals_the_jax_package():
    rng = np.random.default_rng(5)
    cases = [({"senders": np.arange(10), "receivers": np.arange(10)}, 8),
             ({"senders": rng.integers(0, 9, 13).astype(np.int32),
               "receivers": rng.integers(0, 9, 13).astype(np.int32),
               "rev_flag": rng.random(13) < 0.5,
               "edge_mask": rng.random(13) < 0.8,
               "feat": rng.normal(size=(13, 3)).astype(np.float32)}, 4)]
    for arrays, n in cases:
        want = jep.pad_to_multiple(arrays, n)
        got = tep.pad_to_multiple(arrays, n)
        assert sorted(got) == sorted(want)
        for k in want:
            assert got[k].dtype == want[k].dtype, k
            np.testing.assert_array_equal(got[k], want[k])


def test_params_from_jax_round_trip():
    params = _numpy_params(jep.init_edge_parallel_params(
        jax.random.PRNGKey(3), 3, 8))
    got = tep.params_from_jax(params, "cpu")
    assert len(got) == 3
    for layer, want in zip(got, params):
        assert sorted(layer) == sorted(want)
        for k, v in layer.items():
            assert v.dtype == torch.float32 and v.device.type == "cpu"
            np.testing.assert_array_equal(v.numpy(), want[k])


def test_init_draws_the_jax_law():
    h, neig, eeig = 16, 4.0, 2.0
    params = tep.init_edge_parallel_params(
        2, h, neig, eeig, generator=torch.Generator().manual_seed(0),
        device="cpu")
    want = jep.init_edge_parallel_params(jax.random.PRNGKey(0), 2, h, neig,
                                         eeig)
    # xavier-uniform over [h, h]: U(-a, a), a = sqrt(6 / 2h), over the
    # eigenvalue
    a = np.sqrt(6.0 / (2 * h))
    for layer, ref in zip(params, want):
        assert sorted(layer) == sorted(ref)
        for k, v in layer.items():
            assert tuple(v.shape) == ref[k].shape and v.dtype == torch.float32
            if k in ("nbias", "ebias"):
                assert not v.any()
                continue
            bound = a / (neig if k in tep.NODE_WEIGHTS else eeig)
            assert float(v.abs().max()) <= bound
            # 256 uniform draws reach past 0.9 of the bound (p ~ 1e-11
            # that none does) and straddle zero
            assert float(v.abs().max()) > 0.9 * bound
            assert 0.2 < float((v > 0).float().mean()) < 0.8
    # another generator draws other numbers
    other = tep.init_edge_parallel_params(
        2, h, generator=torch.Generator().manual_seed(1), device="cpu")
    assert not torch.equal(other[0]["in_weight"], params[0]["in_weight"])


def test_forward_matches_jax_on_two_ranks_and_one(runs):
    jh, je = runs["jax_fwd"]
    for label, h, e in (
            ("two ranks", runs["ranks"][0]["h"],
             np.concatenate([r["e"] for r in runs["ranks"]])),
            ("one rank", runs["one"]["h"], runs["one"]["e"])):
        np.testing.assert_allclose(h, jh, **F32, err_msg=label)
        # every edge row, the pad's included
        np.testing.assert_allclose(e, je, **F32, err_msg=label)
    np.testing.assert_array_equal(runs["ranks"][0]["h"],
                                  runs["ranks"][1]["h"])
    # the pad row is a real computation, not a zero row
    assert np.abs(je[~runs["fwd"]["arrays"]["edge_mask"]]).max() > 0


def test_train_steps_match_jax(runs):
    want = runs["jax_steps"]
    for label, got in (("rank 0", runs["ranks"][0]), ("one rank",
                                                      runs["one"])):
        np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5,
                                   err_msg=label)
        for s in range(len(want["losses"])):
            for layer, ref in zip(got["params"][s], want["params"][s]):
                for k in ref:
                    np.testing.assert_allclose(
                        layer[k], ref[k], **PARAMS,
                        err_msg=f"{label} step {s} {k}")
            np.testing.assert_allclose(got["w_rel"][s], want["w_rel"][s],
                                       **PARAMS, err_msg=f"{label} step {s}")
    assert want["losses"][-1] < want["losses"][0]
    assert runs["ranks"][0]["losses"][-1] < runs["ranks"][0]["losses"][0]


def test_ranks_stay_equal_bit_for_bit(runs):
    a, b = runs["ranks"]
    assert a["losses"] == b["losses"]
    for s in range(len(a["losses"])):
        np.testing.assert_array_equal(a["w_rel"][s], b["w_rel"][s])
        for la, lb in zip(a["params"][s], b["params"][s]):
            for k in la:
                np.testing.assert_array_equal(la[k], lb[k])


def _preactivations(c, params):
    """The leaky ReLU inputs of every layer (node, then edge), float64,
    at `params`."""
    a = {k: torch.from_numpy(np.asarray(v)) for k, v in c["arrays"].items()}
    snd, rcv = a["senders"].long(), a["receivers"].long()
    rev, em = a["rev_flag"][:, None], a["edge_mask"][:, None]
    h = torch.from_numpy(c["node_feat"]).double()
    e = torch.from_numpy(c["edge_feat"]).double()
    deg = torch.zeros(c["V"], dtype=torch.float64).index_add_(
        0, snd, em[:, 0].double())
    d = torch.log2(1 + deg)[rcv][:, None]
    out = []
    for i, p in enumerate(params):
        p = {k: torch.tensor(np.asarray(v), dtype=torch.float64)
             for k, v in p.items()}
        hs, hd = h @ p["src_weight"], h @ p["dst_weight"]
        msg = torch.where(rev, hd[snd] - hs[rcv], hd[rcv] - hs[snd])
        nm = torch.where(rev, e @ p["out_weight"], -(e @ p["in_weight"]))
        agg = torch.zeros_like(h).index_add_(0, rcv, torch.where(em, nm, 0))
        n_pre = h @ p["nloop_weight"] + agg + p["nbias"]
        e_pre = (e @ p["eloop_weight"] + msg + 2 * (1 + d) * (
            e @ (p["src_weight"] - p["dst_weight"])) + p["ebias"])
        out += [n_pre, e_pre]
        h = torch.nn.functional.leaky_relu(n_pre, 1 / 5.5)
        e = torch.nn.functional.leaky_relu(e_pre, 1 / 5.5)
        if i < len(params) - 1:
            h, e = torch.tanh(h), torch.tanh(e)
    return out


def test_no_leaky_relu_input_lies_within_rounding_of_zero(runs):
    c = runs["step"]
    steps = [c["params"]] + runs["jax_steps"]["params"][:-1]
    for s, params in enumerate(steps):
        for x in _preactivations(c, params):
            near = x.abs() <= FLIP_TOL * x.abs().max()
            assert not near.any(), (s, int(near.sum()))
