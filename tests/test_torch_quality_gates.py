"""The learning gates through the port (gates/scm_convergence.py,
gates/unc_convergence.py) against the scripts they copy
(scripts/scm_convergence.py, scripts/unc_convergence.py), on the CPU.

Always: the data generators and the SCM family specs, array for array;
matching_learned and the metric helpers against the scripts' and
scikit-learn's; the port's UNC `smoke` run under the assertions of
tests/test_unc_quality.py:31-42; a tiny SCM ER run. The longer reruns
are gated by the JAX tests' variables (UNC_QUALITY, SCM_MATCHING), with
the JAX tests' thresholds.
"""

import copy
import os
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.data.synthetic import generate_pair as jpair
from dualmessagepassing_tpu_torch.gates import scm_convergence as tscm
from dualmessagepassing_tpu_torch.gates import unc_convergence as tunc

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "scripts"))
import scm_convergence as jscm  # noqa: E402
import unc_convergence as junc  # noqa: E402

from test_torch_scm_cli import assert_tree_equal  # noqa: E402

QUIET = dict(log=lambda s: None)


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and the test workers
    share the CPU's cores, where OpenMP threads waiting on a busy core
    cost far more than the work they split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scale", ["smoke", "ci", "multi"])
def test_unc_generators_equal_the_script(scale):
    p = tunc.SCALES[scale]
    assert p == junc.SCALES[scale]
    args = (p["V"], p["E"], p["C"], p["R"], p["noise"])
    if p.get("multilabel"):
        got = tunc.make_hin_multi(*args, p["overlap"], 3)
        want = junc.make_hin_multi(*args, p["overlap"], 3)
        assert_tree_equal(tunc.make_attri(got[1], p["attr_flip"], 8),
                          junc.make_attri(want[1], p["attr_flip"], 8))
    else:
        got, want = tunc.make_hin(*args, 3), junc.make_hin(*args, 3)
    assert_tree_equal(got, want)
    assert_tree_equal(tunc.split_lp(got[0], p["V"], 0.05, 4),
                      junc.split_lp(want[0], p["V"], 0.05, 4))


def test_unc_scales_equal_the_script():
    assert tunc.SCALES == junc.SCALES


@pytest.mark.parametrize("family", ["er", "complex", "mutag"])
def test_scm_family_and_pairs_equal_the_script(family):
    """The family specs, and the pairs the gate trains on: the script's
    loop (generate_pair with the family's sampler, the count tail drawn
    again) over the JAX package's generate_pair."""
    got, want = tscm.family_spec(family), jscm._family_spec(family)
    for k in want:
        if k != "sample":
            assert got[k] == want[k], k
    r1, r2 = np.random.default_rng(5), np.random.default_rng(5)
    for _ in range(20):
        assert got["sample"](r1) == want["sample"](r2)
    n = 24 if family == "er" else 6
    rng = np.random.default_rng(1)
    data = []
    for i in range(n):
        while True:
            rec = jpair(rng, num_vlabels=want["nvl"],
                        num_elabels=want["nel"],
                        p_num_vlabels=want["p_nvl"],
                        p_num_elabels=want["p_nel"], pair_id=f"P{i}-G{i}",
                        **want["caps"], **want["sample"](rng))
            if rec["counts"] <= want["count_cap"]:
                data.append(rec)
                break
    assert_tree_equal(tscm.make_pairs(family, n, 1), data)


def test_matching_learned_equals_the_script():
    rng = np.random.default_rng(2)
    traj = [{"epoch": e, **{k: float(rng.uniform(10, 100))
                            for k in ("dev_MNED", "dev_MEED")}}
            for e in range(-1, 9)]
    base = {"dev_zero": {"MNED": 60.0, "MEED": 80.0},
            "train_zero": {"MNED": 50.0, "MEED": 70.0}}
    fit = {"MNED": 30.0, "MEED": 75.0}
    probe = {"MNED_vs_zero": 0.3, "MEED_vs_zero": 0.6}
    for args in ((traj,), (traj, base, fit), (traj, base, fit, probe)):
        assert tscm.matching_learned(*copy.deepcopy(args)) == \
            jscm.matching_learned(*copy.deepcopy(args))


def test_multilabel_f1_equals_sklearn():
    from sklearn.metrics import f1_score

    rng = np.random.default_rng(3)
    t = rng.random((40, 5)) < 0.3
    p = rng.random((40, 5)) < 0.3
    t[:, 4] = p[:, 4] = False               # a column with no labels
    for avg in ("macro", "micro"):
        assert tunc.multilabel_f1(t, p, avg) == pytest.approx(
            f1_score(t, p, average=avg, zero_division=0), abs=1e-12)


def test_fast_multilabel_protocol_equals_the_script():
    """The chance-level baselines' protocol (per-class stratified 5-fold
    LinearSVC at C = 1, and lp) on random embeddings: the port's
    LIBLINEAR copy and folds against scikit-learn's, as the script runs
    them."""
    p = tunc.SCALES["multi_smoke"]
    trip, mem = tunc.make_hin_multi(p["V"], p["E"], p["C"], p["R"],
                                    p["noise"], p["overlap"], 0)
    _, lp_lines = tunc.split_lp(trip, p["V"], 0.05, 1)
    embs = np.random.default_rng(7).normal(
        size=(p["V"], 8)).astype(np.float32)
    got = tunc._eval_embs_multi(embs, mem, lp_lines, "random", fast=True,
                                **QUIET)
    want = junc._eval_embs_multi(embs, mem, lp_lines, "random", fast=True,
                                 **QUIET)
    assert got == want


def jax_scm_init(family: str, seed: int, hid: int = 64) -> dict:
    """The initial weights the JAX script's run() draws for the gate's
    model (model.init with PRNGKey(seed) on a batch of 8 pairs with
    reversed edges), as the port's state_dict: the gates' init_weights."""
    import jax

    from dualmessagepassing_tpu import build_model as jbuild
    from dualmessagepassing_tpu.data.dataset import GraphAdjDataset
    from dualmessagepassing_tpu_torch.models.scm_models import \
        params_from_flax

    spec = jscm._family_spec(family)
    data = tscm.make_pairs(family, 8, seed)
    ds = GraphAdjDataset(data).add_reversed_edges(spec["p_nel"], spec["nel"])
    _, pattern, graph, _, _ = ds.batchify(range(8), "none")
    model = jbuild(jscm._family_model_config(spec, hid))
    v = jax.jit(model.init)(jax.random.PRNGKey(seed), pattern, graph)
    return params_from_flax(v["params"], v.get("batch_stats"))


def jax_unc_init(scale: str, seed: int) -> dict:
    """The initial weights the JAX package's train_unc draws in the
    script's run_train (init_unc_variables with PRNGKey(seed); they
    depend on the batch's shapes only), as the port's state_dict."""
    import jax
    import jax.numpy as jnp

    from dualmessagepassing_tpu.unc import driver as jdrv
    from dualmessagepassing_tpu.unc import model as jm
    from dualmessagepassing_tpu.unc.data import WholeGraph
    from dualmessagepassing_tpu_torch.unc.model import params_from_flax

    p, trip, _, _ = tunc.hin_and_split(scale, seed, 0.05, lambda s: None)
    graph = WholeGraph(p["V"], p["R"], trip)
    gbs = p["graph_batch_size"]
    first = jdrv.sample_batch(
        graph, trip[:gbs], "randomwalk", p["sample_depth"],
        p["sample_width"], p["graph_split_size"], 5, p["V"],
        min(p["V"] * p["sample_width"], graph.num_edges), gbs * 6,
        np.random.default_rng(seed), send_keys=True)
    model = jm.UNCTrainModel(
        num_nodes=p["V"], num_rels=p["R"], h_dim=p["h_dim"], nlabel=0,
        num_hidden_layers=p["n_layers"], dropout=tunc.DROPOUT,
        reg_param=tunc.REG_PARAM, backbone="DMPNN")
    v = jm.init_unc_variables(model, jax.random.PRNGKey(seed),
                              {k: jnp.asarray(x) for k, x in first.items()})
    return params_from_flax(v["params"], v.get("batch_stats"))


def test_scm_gate_from_the_jax_init_tracks_the_script():
    """The port's gate started from the JAX script's initial weights
    follows the script's run, float32 on the CPU: the pre-training dev
    row, and each epoch's train loss and dev metrics (1e-4 relative: the
    same arithmetic in another summation order, over 8 steps)."""
    kw = dict(pairs=96, max_epochs=2, early_stop=2, bsz=16, lr=1e-3,
              amp=False, seed=0, probe_steps=2, hid=16, family="er")
    want = jscm.run(**kw, **QUIET)
    got = tscm.run(**kw, device="cpu", init_weights=jax_scm_init(
        "er", 0, hid=16), **QUIET)
    assert got["baselines"] == want["baselines"]
    assert len(got["trajectory"]) == len(want["trajectory"]) == 3
    for g, w in zip(got["trajectory"], want["trajectory"]):
        for k, v in w.items():
            if k == "epoch_s" or v is None:
                continue
            assert g[k] == pytest.approx(v, rel=1e-4, nan_ok=True), \
                (w["epoch"], k)


def test_unc_smoke_gate_through_the_port():
    """tests/test_unc_quality.py:31-42's assertions on the port's run."""
    result = tunc.run("smoke", seed=0, supervised=True, device="cpu",
                      **QUIET)
    for block in ("trained", "untrained", "random"):
        for k in ("macro_f1", "micro_f1", "lp_auc", "lp_mrr"):
            assert np.isfinite(result[block][k]), (block, k)
    assert np.isfinite(result["supervised"]["macro_f1"])
    assert result["coverage"] > 0.9
    assert set(result["gaps"]) == {"nc_macro_gap_vs_random",
                                   "lp_auc_gap_vs_random",
                                   "nc_macro_gap_vs_untrained"}
    assert result["platform"] == "cpu"


def test_unc_gate_stage_all_trains_in_a_subprocess(tmp_path, monkeypatch,
                                                  capfd):
    """--stage all: the train stage runs the port's module in a child
    process (the only one that would hold the card), which writes the
    npz that this process evaluates."""
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    state, out = tmp_path / "state.npz", tmp_path / "out.json"
    result = tunc.main(["--scale", "smoke", "--cpu", "--no-supervised",
                        "--state", str(state), "--out", str(out)])
    assert state.exists() and out.exists()
    assert "train stage done" in capfd.readouterr().out
    assert result["platform"] == "cpu" and result["supervised"] is None
    st = np.load(state)
    assert st["embs"].shape == (tunc.SCALES["smoke"]["V"],
                                tunc.SCALES["smoke"]["h_dim"])


def test_scm_er_gate_runs_tiny():
    result = tscm.run(pairs=64, max_epochs=2, early_stop=2, bsz=16,
                      lr=1e-3, amp=True, seed=0, probe_steps=4,
                      family="er", device="cpu", **QUIET)
    ml = result["matching_learned"]
    for k in ("dev_MNED_vs_zero", "dev_MEED_vs_zero", "train_MNED_vs_zero",
              "train_MEED_vs_zero", "dev_MNED_vs_untrained"):
        assert np.isfinite(ml[k]), (k, ml)
    assert len(result["trajectory"]) == 3        # epoch -1, 0, 1
    assert result["config"]["family"] == "er"


@pytest.mark.skipif(not os.environ.get("UNC_QUALITY"),
                    reason="minutes on the CPU; set UNC_QUALITY=1")
def test_unc_ci_gate_through_the_port():
    """tests/test_unc_quality.py:45-61's thresholds."""
    result = tunc.run("ci", seed=0, supervised=True, device="cpu", **QUIET)
    assert result["gaps"]["nc_macro_gap_vs_random"] >= 0.35, result["gaps"]
    assert result["gaps"]["lp_auc_gap_vs_random"] >= 0.12, result["gaps"]
    assert result["gaps"]["nc_macro_gap_vs_untrained"] >= 0.35, \
        result["gaps"]
    assert result["trained"]["macro_f1"] >= 0.8
    assert result["quality_ok"]
    assert result["supervised"]["train_fit_acc"] >= 0.95


@pytest.mark.skipif(not os.environ.get("UNC_QUALITY"),
                    reason="minutes on the CPU; set UNC_QUALITY=1")
def test_unc_multi_gate_through_the_port():
    """tests/test_unc_quality.py:95-110's thresholds."""
    result = tunc.run("multi", seed=0, supervised=True, device="cpu",
                      **QUIET)
    assert result["quality_ok"], result["gaps"]
    assert result["trained"]["macro_f1"] >= 0.7
    assert result["supervised"]["beats_attr_probe"], result["supervised"]


@pytest.mark.skipif(not os.environ.get("SCM_MATCHING"),
                    reason="~20 min on the CPU; set SCM_MATCHING=1")
def test_scm_er_matching_through_the_port(capsys):
    """tests/test_scm_matching_quality.py:65-80's run and limits, at seeds
    0-11 in both packages, the limits held on the dev ratios' mean over
    the seeds. The seed draws the data and the initial weights, and one
    draw decides the ratios: single seeds miss the limits in both
    packages (PERF.md §6). Prints each package's per-seed ratios."""
    kw = dict(pairs=384, max_epochs=12, early_stop=12, bsz=64, lr=1e-3,
              amp=True, probe_steps=60, family="er", **QUIET)
    limits = {"dev_MNED_vs_zero": 0.9, "dev_MEED_vs_zero": 1.05}
    runs = {"port": lambda seed: tscm.run(seed=seed, device="cpu", **kw),
            "jax": lambda seed: jscm.run(seed=seed, **kw)}
    for name, run in runs.items():
        mls = [run(seed)["matching_learned"] for seed in range(12)]
        for k, limit in limits.items():
            values = [m[k] for m in mls]
            with capsys.disabled():
                print(f"{name} {k}: mean {np.mean(values):.6f}, {values}")
            assert np.mean(values) < limit, (name, k, values)
