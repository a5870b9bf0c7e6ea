"""Port embedding export (dualmessagepassing_tpu_torch/unc/driver.py)
against the JAX package's export loop.

The JAX side is make_unc_embed_step driven by the loop of
dualmessagepassing_tpu/unc/driver.py:672-687, written out here; the
port runs export_embeddings on the converted weights. Both sample from
np.random.default_rng of the same seed, so they see the same requests.
Tolerance: 1e-5 abs and rel on the float32 embedding table (the forward
agrees to that, tests/test_torch_unc_model.py; the moving average is
the same numpy code on both sides); coverage is equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu.unc.data import WholeGraph, save_embeddings
from dualmessagepassing_tpu_torch.unc import data as td
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import model as tm

from test_torch_unc_data import tiny_hin
from test_torch_unc_model import perturb

H, LAYERS, GBS, NEG, DEPTH, WIDTH, SPLIT = 16, 2, 20, 3, 3, 5, 0.5


def jax_export(model, variables, graph, triplets, num_nodes, rng):
    """driver.py:666-688 for the single-device learned-embedding model."""
    embed = jdrv.make_unc_embed_step(model)
    v_max = num_nodes
    e_max = min(v_max * WIDTH, graph.num_edges)
    node_emb = np.asarray(variables["params"]["model"]["node_emb"],
                          np.float32).copy()
    sampled = set()
    bsz = GBS * 4
    for i in range(0, len(triplets), bsz):
        edges = triplets[i: i + bsz]
        subp = jdrv.sample_batch(graph, edges, "randomwalk", DEPTH, WIDTH,
                                 SPLIT, NEG, v_max, e_max,
                                 GBS * 4 * (1 + NEG), rng, send_keys=False)
        h = np.asarray(embed(variables,
                             {k: jnp.asarray(v) for k, v in subp.items()}))
        nm = subp["node_mask"]
        nid = subp["nid"][nm]
        sub_in_deg = np.bincount(subp["receivers"][subp["edge_mask"]],
                                 minlength=len(subp["nid"]))[nm]
        coef = (sub_in_deg + 1.0) / (graph.in_deg[nid] + 1.0)
        node_emb[nid] = (node_emb[nid] * (1 - coef[:, None])
                         + h[nm] * coef[:, None])
        sampled.update(int(x) for x in nid)
    return node_emb, len(sampled) / num_nodes


@pytest.mark.parametrize("n_triplets", [240, 60])
def test_export_matches_jax_loop(tmp_path, n_triplets):
    t, n, r = tiny_hin(seed=9, n=90, e=n_triplets)
    model = jm.UNCTrainModel(num_nodes=n, num_rels=r, h_dim=H, nlabel=0,
                             num_hidden_layers=LAYERS, dropout=0.0,
                             backbone="DMPNN", sorted_edges=True)
    g = WholeGraph(n, r, t)
    first = jdrv.sample_batch(g, t[:GBS], "randomwalk", DEPTH, WIDTH, SPLIT,
                              NEG, n, g.num_edges, GBS * (1 + NEG),
                              np.random.default_rng(0))
    variables = jm.init_unc_variables(
        model, jax.random.PRNGKey(0),
        {k: jnp.asarray(v) for k, v in first.items()})
    rng = np.random.default_rng(3)
    variables = {"params": perturb(variables["params"], rng),
                 "batch_stats": perturb(variables["batch_stats"], rng)}
    want, want_cov = jax_export(model, variables, g, t, n,
                                np.random.default_rng(42))

    port = tm.UNCTrainModel(n, r, H, num_hidden_layers=LAYERS)
    port.load_state_dict(tm.params_from_flax(variables["params"],
                                             variables["batch_stats"]))
    records = []
    got, cov = tdrv.export_embeddings(
        port, td.WholeGraph(n, r, t), t, GBS, rng=np.random.default_rng(42),
        sampler="randomwalk", sample_depth=DEPTH, sample_width=WIDTH,
        graph_split_size=SPLIT, negative_rate=NEG,
        on_request=records.append, log=lambda s: None)
    assert got.dtype == np.float32 and got.shape == (n, H)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert cov == want_cov
    assert len(records) == -(-n_triplets // (GBS * 4))
    assert all(rec["forward_ms"] is None for rec in records)  # no CUDA here
    assert records[-1]["coverage"] == cov

    # emb.dat: header + one line per node, byte-identical to the JAX writer
    pa, pb = tmp_path / "jax.dat", tmp_path / "port.dat"
    save_embeddings(str(pa), "args", want)
    td.save_embeddings(str(pb), "args", want)
    assert pa.read_bytes() == pb.read_bytes()
    td.save_embeddings(str(pb), "args", got)
    assert len(pb.read_text().splitlines()) == n + 1
