"""Port supervised UNC training (dualmessagepassing_tpu_torch/unc/data.py
label helpers, unc/model.py:UNCTrainModel.supervised_loss and node_fc,
unc/driver.py:sample_supervised_batch, make_unc_supervised_step and
train_unc_supervised, cli/unc_train.py's supervised, backbone and
attributed command lines) against the JAX package.

The host helpers are numpy in both packages: the same inputs and a
np.random.default_rng of the same seed give identical arrays. The JAX
model runs on the CPU at `highest` matmul precision (tests/conftest.py),
the port on the plain versions of its kernels; dropout is 0.

Tolerances:
  * supervised loss and every gradient, float32 — rtol 1e-4, atol 1e-6
    per tensor (tests/test_torch_unc_train.py's: the same float32
    arithmetic in another summation order);
  * train_unc_supervised — per-step losses rtol 1e-5 (no backbone here
    has a BatchNorm, so nothing is pinned), every batch array-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.unc import data as jd
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import model as jm
from dualmessagepassing_tpu_torch.cli import unc_evaluate as tcli_eval
from dualmessagepassing_tpu_torch.cli import unc_train as tcli
from dualmessagepassing_tpu_torch.ops import segment_kernel as tsk
from dualmessagepassing_tpu_torch.unc import data as td
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import model as tm

from test_torch_unc_data import tiny_hin
from test_torch_unc_model import perturb

H, LAYERS, REG, LR, NLABEL = 16, 2, 1e-2, 1e-2, 3
F32_TOL = dict(rtol=1e-4, atol=1e-6)


def labels_of(t, n_labeled, multi):
    """Incident triplet indices and labels of nodes 0..n_labeled-1, as
    load_supervised and load_label return them."""
    indices = {}
    for i, row in enumerate(t):
        for v in (int(row[0]), int(row[2])):
            if v < n_labeled:
                indices.setdefault(v, []).append(i)
    labels = {v: (np.array([v % NLABEL, (v + 1) % NLABEL]) if multi
                  else v % NLABEL) for v in indices}
    return indices, labels


def write_files(tmp_path, t, n, r, multi=False, attr_width=6):
    with open(tmp_path / "link.dat", "w") as f:
        f.write(f"{n} {r}\n")
        for row in t:
            f.write("%d %d %d\n" % tuple(row))
    rng = np.random.default_rng(4)
    with open(tmp_path / "node.dat", "w") as f:
        for v in range(n):
            f.write(f"{v}\t" + ",".join(
                f"{x:.5f}" for x in rng.normal(size=attr_width)) + "\n")
    with open(tmp_path / "label.dat", "w") as f:
        for v in range(0, n, 2):
            lab = f"{v % NLABEL},{(v + 1) % NLABEL}" if multi \
                else str(v % NLABEL)
            f.write(f"{v}\t{lab}\n")


# -----------------------------------------------------------------------------
# host helpers
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("multi", [False, True])
def test_label_and_supervised_loaders_match_jax(tmp_path, multi):
    t, n, r = tiny_hin(seed=3)
    write_files(tmp_path, t, n, r, multi)
    a = jd.load_label(str(tmp_path / "label.dat"))
    b = td.load_label(str(tmp_path / "label.dat"))
    assert a[0] == b[0] and a[2:] == b[2:] and b[3] == multi
    assert a[1].keys() == b[1].keys()
    for k in a[1]:
        np.testing.assert_array_equal(a[1][k], b[1][k])
    for attributed in (False, True):
        ja = jd.load_supervised(str(tmp_path / "link.dat"),
                                str(tmp_path / "node.dat"), a[0], attributed)
        tb = td.load_supervised(str(tmp_path / "link.dat"),
                                str(tmp_path / "node.dat"), b[0], attributed)
        np.testing.assert_array_equal(ja[0], tb[0])
        assert ja[1:5] == tb[1:5]
        if attributed:
            np.testing.assert_array_equal(ja[5], tb[5])
        else:
            assert ja[5] is tb[5] is None


@pytest.mark.parametrize("multi", [False, True])
def test_label_sampling_and_matching_match_jax(multi):
    t, n, r = tiny_hin(seed=3)
    indices, labels = labels_of(t, 20, multi)
    for if_train, batch_index in ((True, 0), (False, 0), (False, 2)):
        ra, rb = np.random.default_rng(7), np.random.default_rng(7)
        ea, na = jd.labeled_edges_sampling(indices, len(indices), if_train,
                                           6, batch_index, ra)
        eb, nb = td.labeled_edges_sampling(indices, len(indices), if_train,
                                           6, batch_index, rb)
        np.testing.assert_array_equal(ea, eb)
        assert na == nb
        assert ra.integers(0, 2 ** 62) == rb.integers(0, 2 ** 62)
    nid = np.arange(0, 40, 3)
    la, ia = jd.match_labels_to_subgraph(nid, na, labels, NLABEL, multi)
    lb, ib = td.match_labels_to_subgraph(nid, nb, labels, NLABEL, multi)
    np.testing.assert_array_equal(la, lb)
    np.testing.assert_array_equal(ia, ib)
    assert la.dtype == lb.dtype and len(ib) > 0


# -----------------------------------------------------------------------------
# supervised loss and gradients
# -----------------------------------------------------------------------------

def jax_model(n, r, backbone, multi):
    return jm.UNCTrainModel(num_nodes=n, num_rels=r, h_dim=H, nlabel=NLABEL,
                            num_hidden_layers=LAYERS, dropout=0.0,
                            reg_param=REG, backbone=backbone, multi=multi,
                            sorted_edges=True)


@pytest.mark.parametrize("backbone, multi", [
    ("DMPNN", False), ("DMPNN", True), ("CompGCN", True), ("RGIN", False)])
def test_supervised_loss_and_every_gradient_match_jax(backbone, multi):
    t, n, r = tiny_hin(seed=5, n=100, e=400)
    indices, labels = labels_of(t, 40, multi)
    g = td.WholeGraph(n, r, t)
    padded, ml, mi, mm = tdrv.sample_supervised_batch(
        g, t, t[:60], indices, labels, NLABEL, multi, 16, "randomwalk", 3,
        5, 0.5, n, g.num_edges, np.random.default_rng(0))
    assert 0 < mm.sum() < len(mm)             # a padded label envelope
    model = jax_model(n, r, backbone, multi)
    sub = {k: jnp.asarray(v) for k, v in padded.items()}
    v = jm.init_unc_variables(model, jax.random.PRNGKey(0), sub)
    rng = np.random.default_rng(1)
    params = perturb(v["params"], rng)
    stats = perturb(v.get("batch_stats", {}), rng)

    @jax.jit
    def f(p):
        def loss_fn(p):
            (out, pred), _ = jm.apply_unc_forward(
                model, p, stats, sub, jax.random.PRNGKey(0))
            return model.apply(
                {"params": p}, out, sub["edge_type"], sub["edge_mask"], pred,
                jnp.asarray(ml), jnp.asarray(mi), jnp.asarray(mm), multi,
                method=jm.UNCTrainModel.supervised_loss)
        return jax.value_and_grad(loss_fn)(p)

    jl, jg = f(params)
    jg = tm.params_from_flax(jg)
    m = tm.UNCTrainModel(n, r, H, LAYERS, reg_param=REG, backbone=backbone,
                         nlabel=NLABEL, multi=multi)
    m.load_state_dict(tm.params_from_flax(params, stats))
    st = tdrv.to_device(tsk.attach_csr_plan(padded, sender_plan=True), "cpu")
    out, pred = tm.apply_unc_supervised_forward(m, st, train=True)
    loss = m.supervised_loss(out, st["edge_type"], st["edge_mask"], pred,
                             torch.from_numpy(ml), torch.from_numpy(mi),
                             torch.from_numpy(mm), multi)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-6)
    tg = {k: p.grad for k, p in m.named_parameters()}
    assert set(tg) == set(jg) and all(x is not None for x in tg.values())
    for k in jg:
        np.testing.assert_allclose(tg[k].numpy(), jg[k].numpy(), err_msg=k,
                                   **F32_TOL)


# -----------------------------------------------------------------------------
# train_unc_supervised
# -----------------------------------------------------------------------------

TRAIN_KW = dict(lr=LR, graph_batch_size=50, label_batch_size=8,
                graph_split_size=0.5, sampler="randomwalk", sample_depth=2,
                sample_width=5, n_epochs=2, grad_norm=1.0, seed=3)


@pytest.mark.parametrize("backbone, multi", [("CompGCN", False),
                                             ("RGCN", True)])
def test_train_unc_supervised_matches_jax(backbone, multi, monkeypatch):
    """Every batch and every step's loss against the JAX package's
    train_unc_supervised from the same initial weights."""
    t, n, r = tiny_hin(seed=8, n=100, e=200)
    indices, labels = labels_of(t, 40, multi)
    seen = {"losses": [], "batches": []}
    orig_init, orig_step = jdrv.init_unc_variables, \
        jdrv.make_unc_supervised_step

    def init(*a, **k):
        seen["variables"] = orig_init(*a, **k)
        return seen["variables"]

    def make_step(*a, **k):
        step = orig_step(*a, **k)

        class Step:
            lower = step.lower

            def __call__(self, *args):
                seen["batches"].append(args[3:7])
                out = step(*args)
                seen["losses"].append(float(out[-1]))
                return out
        return Step()

    monkeypatch.setattr(jdrv, "init_unc_variables", init)
    monkeypatch.setattr(jdrv, "make_unc_supervised_step", make_step)
    jdrv.train_unc_supervised(t, n, r, indices, labels, NLABEL, multi,
                              h_dim=H, n_layers=LAYERS, reg_param=REG,
                              dropout=0.0, backbone=backbone,
                              log=lambda s: None, **TRAIN_KW)
    v = seen["variables"]
    m = tm.UNCTrainModel(n, r, H, LAYERS, reg_param=REG, backbone=backbone,
                         nlabel=NLABEL, multi=multi)
    m.load_state_dict(tm.params_from_flax(v["params"]))
    batches = []
    orig_port = tdrv.make_unc_supervised_step

    def record(*a, **k):
        step = orig_port(*a, **k)
        return lambda sub, *lab: batches.append((sub, *lab)) or step(sub, *lab)

    monkeypatch.setattr(tdrv, "make_unc_supervised_step", record)
    epochs = []
    assert tdrv.train_unc_supervised(m, t, n, r, indices, labels,
                                     multi=multi, on_epoch=epochs.append,
                                     log=lambda s: None, **TRAIN_KW) is m
    got = [x for e in epochs for x in e["losses"]]
    assert len(got) == len(seen["losses"]) == 8
    np.testing.assert_allclose(got, seen["losses"], rtol=1e-5)
    for (jsub, jml, jmi, jmm), (tsub, tml, tmi, tmm) in zip(seen["batches"],
                                                            batches):
        for k in jsub:
            np.testing.assert_array_equal(np.asarray(jsub[k]),
                                          tsub[k].numpy(), err_msg=k)
        for a, b in ((jml, tml), (jmi, tmi), (jmm, tmm)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


# -----------------------------------------------------------------------------
# the CLI: every backbone, supervised, attributed; scored by unc_evaluate
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("extra", [
    ["--model", "CompGCN"], ["--model", "RGCN"], ["--model", "RGIN"],
    ["--supervised", "True"], ["--attributed", "True"],
    ["--supervised", "True", "--model", "RGIN"]])
def test_cli_trains_every_command_line_and_evaluate_scores_it(tmp_path,
                                                              extra):
    t, n, r = tiny_hin(seed=2, n=40, e=160)
    write_files(tmp_path, t, n, r)
    out = tmp_path / "emb.dat"
    tcli.main(["--link", str(tmp_path / "link.dat"),
               "--node", str(tmp_path / "node.dat"),
               "--label", str(tmp_path / "label.dat"), "--output", str(out),
               "--n_hidden", "8", "--graph_batch_size", "40",
               "--label_batch_size", "8", "--n_epochs", "1",
               "--sample_depth", "2", "--sample_width", "4",
               "--device", "cpu"] + extra)
    lines = out.read_text().splitlines()
    assert len(lines) == n + 1 and len(lines[1].split("\t")[1].split()) == 8
    with open(tmp_path / "lab.dat", "w") as f:
        for v in range(0, 30):
            f.write(f"{v}\t{v % 2}\n")
    with open(tmp_path / "lab.dat.test", "w") as f:
        for v in range(30, n):
            f.write(f"{v}\t{v % 2}\n")
    res = tcli_eval.main(["--task", "nc", "--emb_file", str(out),
                          "--label_file", str(tmp_path / "lab.dat"),
                          "--label_test_file", str(tmp_path / "lab.dat.test"),
                          "--record_file", str(tmp_path / "record.dat")])
    assert 0 <= res["nc"]["Macro-F1"] <= 1 and 0 <= res["nc"]["Micro-F1"] <= 1
    assert (tmp_path / "record.dat").read_text().count("Macro-F1") == 1
