"""Port UNC evaluation (dualmessagepassing_tpu_torch/unc/evaluate.py,
unc/linear_svc.py over csrc/linear_svc.cpp, cli/unc_evaluate.py) against
scikit-learn and the JAX package's sklearn-based unc/evaluate.py, and
the port's end-to-end unc_nc gate.

Tolerances:
  * folds — index for index equal to sklearn's KFold/StratifiedKFold;
  * f1_score and roc_auc_score — 1e-12 absolute;
  * LinearSVC coef_ and intercept_ — within 1e-9 of the largest
    coefficient (measured: bitwise equal, since the solvers are
    LIBLINEAR's own code and TRON calls scipy's BLAS as scikit-learn's
    does), predictions equal;
  * the protocols and the evaluate CLI on the fixture files of
    tests/test_unc.py:364-440, and the C each tuner picks — equal to the
    JAX package's results (1e-12);
  * unc_nc — the fixture of tests/test_regression.py:113-148 trained by
    the port from the JAX package's initial weights and scored by the
    port must land within the relative tolerances that
    tests/test_regression.py:147 holds tests/data/regression_expected.json's
    unc_nc values to. This test only reads that file.
"""

import json
import os
import warnings

import numpy as np
import pytest
import sklearn.metrics as skm
import sklearn.model_selection as skms
import sklearn.svm as sksvm
from sklearn.exceptions import ConvergenceWarning, UndefinedMetricWarning

from dualmessagepassing_tpu.cli.unc_evaluate import main as jax_eval_cli
from dualmessagepassing_tpu.unc import driver as jdrv
from dualmessagepassing_tpu.unc import evaluate as jev
from dualmessagepassing_tpu_torch.cli.unc_evaluate import main as eval_cli
from dualmessagepassing_tpu_torch.unc import driver as tdrv
from dualmessagepassing_tpu_torch.unc import evaluate as tev
from dualmessagepassing_tpu_torch.unc import model as tm
from dualmessagepassing_tpu_torch.unc.linear_svc import LinearSVC

EXPECTED = os.path.join(os.path.dirname(__file__), "data",
                        "regression_expected.json")


@pytest.fixture(autouse=True)
def quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", ConvergenceWarning)
        warnings.simplefilter("ignore", UndefinedMetricWarning)
        yield


# -----------------------------------------------------------------------------
# folds and metrics
# -----------------------------------------------------------------------------

def test_kfold_equals_sklearn():
    for n in (5, 7, 23, 100):
        for rs in (1, 7):
            a = list(skms.KFold(5, shuffle=True, random_state=rs).split(
                np.zeros((n, 1))))
            b = list(tev.KFold(5, random_state=rs).split(
                np.zeros((n, 1))))
            assert len(a) == len(b) == 5
            for (tra, tea), (trb, teb) in zip(a, b):
                np.testing.assert_array_equal(tra, trb)
                np.testing.assert_array_equal(tea, teb)
    with pytest.raises(ValueError):
        next(tev.KFold(5, random_state=1).split(np.zeros((3, 1))))


@pytest.mark.parametrize("labels", [
    "multiclass", "binary", "bool", "imbalanced", "strings"])
def test_stratified_kfold_equals_sklearn(labels):
    rng = np.random.default_rng(3)
    y = {"multiclass": rng.integers(0, 4, 53),
         "binary": rng.integers(0, 2, 40),
         "bool": rng.random(37) < 0.3,
         "imbalanced": np.r_[np.zeros(40, int), np.ones(6, int),
                             np.full(9, 2)][rng.permutation(55)],
         "strings": np.array(list("abcab") * 7)}[labels]
    for rs in (1, 2):
        a = list(skms.StratifiedKFold(5, shuffle=True, random_state=rs)
                 .split(np.zeros((len(y), 1)), y))
        b = list(tev.StratifiedKFold(5, random_state=rs)
                 .split(np.zeros((len(y), 1)), y))
        for (tra, tea), (trb, teb) in zip(a, b):
            np.testing.assert_array_equal(tra, trb)
            np.testing.assert_array_equal(tea, teb)


def test_f1_and_auc_equal_sklearn():
    rng = np.random.default_rng(5)
    for trial in range(20):
        k = 2 + trial % 4
        y = rng.integers(0, k, 40)
        p = np.where(rng.random(40) < 0.6, y, rng.integers(0, k + 1, 40))
        for avg in ("macro", "micro"):
            assert abs(tev.f1_score(y, p, average=avg)
                       - skm.f1_score(y, p, average=avg)) <= 1e-12
        yb, pb = y % 2, p % 2
        for a, b in ((yb, pb), (yb.astype(bool), pb.astype(bool)),
                     (yb, np.zeros_like(pb))):
            assert abs(tev.f1_score(a, b, average="binary")
                       - skm.f1_score(a, b, average="binary")) <= 1e-12
        score = rng.normal(size=40).round(1)            # ties included
        for s in (score, pb):
            assert abs(tev.roc_auc_score(yb, s)
                       - skm.roc_auc_score(yb, s)) <= 1e-12
    assert np.isnan(tev.roc_auc_score(np.ones(5, int), np.arange(5.0)))
    for s in (np.zeros(6), np.array([0.0, 0, 1, 1, 1, 1])):  # 1-2 thresholds
        y = np.array([0, 1, 0, 1, 1, 0])
        assert tev.roc_auc_score(y, s) == skm.roc_auc_score(y, s)
    assert tev.f1_score([0, 0], [0, 0], average="binary") == 0.0


# -----------------------------------------------------------------------------
# LinearSVC
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(10, 16), (60, 16), (300, 12)])
@pytest.mark.parametrize("classes, multi_class", [
    (2, "ovr"), (4, "ovr"), (2, "crammer_singer")])
def test_linear_svc_equals_sklearn(shape, classes, multi_class):
    """coef_/intercept_ against sklearn's LinearSVC at C in {1e-2, 1,
    1e2} and max_iter 3 and 1000: the dual solver (10 x 16), the primal
    (60 x 16, 300 x 12), Crammer-Singer on two classes."""
    rng = np.random.default_rng(shape[0] + classes)
    n, d = shape
    X = rng.normal(size=(n, d)).astype(np.float32)
    X[rng.random(X.shape) < 0.1] = 0.0
    y = rng.integers(0, classes, n) * 3 + 1          # labels 1, 4, 7, 10
    y[:classes] = np.arange(classes) * 3 + 1
    for C in (1e-2, 1.0, 1e2):
        for it in (3, 1000):
            a = sksvm.LinearSVC(C=C, max_iter=it, multi_class=multi_class,
                                random_state=1).fit(X, y)
            b = LinearSVC(C=C, max_iter=it, multi_class=multi_class,
                          random_state=1).fit(X, y)
            scale = max(np.abs(a.coef_).max(), np.abs(a.intercept_).max())
            assert b.coef_.shape == a.coef_.shape
            np.testing.assert_allclose(b.coef_, a.coef_, rtol=0,
                                       atol=1e-9 * scale)
            np.testing.assert_allclose(b.intercept_, a.intercept_, rtol=0,
                                       atol=1e-9 * scale)
            assert b.n_iter_ == a.n_iter_
            np.testing.assert_array_equal(b.classes_, a.classes_)
            np.testing.assert_array_equal(b.predict(X), a.predict(X))
            np.testing.assert_allclose(b.decision_function(X),
                                       a.decision_function(X), rtol=0,
                                       atol=1e-9 * scale * d)


def test_linear_svc_refuses_one_class():
    with pytest.raises(ValueError, match="2 classes"):
        LinearSVC(1.0, 100, "ovr", 1).fit(np.ones((4, 2)), np.zeros(4))


# -----------------------------------------------------------------------------
# the protocols against the JAX package's (tests/test_unc.py:364-440)
# -----------------------------------------------------------------------------

def multilabel_fixture(tmp_path):
    rng = np.random.default_rng(0)
    n = 60
    embs = rng.normal(size=(n, 8)).astype(np.float32)
    emb_dict = {str(i): embs[i] for i in range(n)}

    def write4(path, idxs):
        with open(path, "w") as f:
            for i in idxs:
                labs = ["a" if embs[i, 0] > 0 else "b"]
                if embs[i, 1] > 0:
                    labs.append("c")
                f.write(f"{i}\tx\t0\t{','.join(labs)}\n")

    write4(tmp_path / "label.dat", range(0, 40))
    write4(tmp_path / "label.dat.test", range(40, 60))
    return emb_dict


@pytest.mark.parametrize("supervised", [True, False])
def test_multilabel_protocols_equal_jax(tmp_path, supervised):
    emb_dict = multilabel_fixture(tmp_path)
    args = (str(tmp_path / "label.dat"), str(tmp_path / "label.dat.test"),
            emb_dict)
    a = jev.nc_evaluate(*args, supervised=supervised, multi=True)
    b = tev.nc_evaluate(*args, supervised=supervised, multi=True)
    np.testing.assert_allclose(b, a, rtol=0, atol=1e-12)
    assert min(b) > 0.85


def cli_fixture(tmp_path, variant="four_classes"):
    """"test_unc": the files of tests/test_unc.py:410-431 (seed 0, two
    classes, one negative link per seed node); "four_classes": seed 1,
    four classes (LinearSVC's one-vs-rest over several problems) and two
    negative links per seed node."""
    four = variant == "four_classes"
    rng = np.random.default_rng(1 if four else 0)
    n = 50
    embs = rng.normal(size=(n, 6)).astype(np.float32)

    def label(i):
        return int(embs[i, 0] > 0) + (2 * int(embs[i, 1] > 1) if four else 0)

    with open(tmp_path / "emb.dat", "w") as f:
        f.write("header args\n")
        for i in range(n):
            f.write(f"{i}\t" + " ".join(f"{x:.6f}" for x in embs[i]) + "\n")
    with open(tmp_path / "label.dat", "w") as f:
        for i in range(0, 35):
            f.write(f"{i}\t{label(i)}\n")
    with open(tmp_path / "label.dat.test", "w") as f:
        for i in range(35, 50):
            f.write(f"{i}\t{label(i)}\n")
    with open(tmp_path / "link.dat.test", "w") as f:
        for i in range(0, 40, 2):
            f.write(f"{i}\t{i + 1}\t1\n")
            f.write(f"{i}\t{(i + 7) % n}\t0\n")
            if four:
                f.write(f"{i}\t{(i + 11) % n}\t0\n")


@pytest.mark.parametrize("variant", ["test_unc", "four_classes"])
@pytest.mark.parametrize("supervised", ["False", "True"])
def test_evaluate_cli_equals_jax(tmp_path, supervised, variant):
    """nc (unsupervised 5-fold or semi-supervised) and lp through both
    CLIs, and their record files, byte for byte."""
    cli_fixture(tmp_path, variant)
    res = {}
    for name, cli in (("jax", jax_eval_cli), ("port", eval_cli)):
        res[name] = cli([
            "--task", "both", "--emb_file", str(tmp_path / "emb.dat"),
            "--label_file", str(tmp_path / "label.dat"),
            "--label_test_file", str(tmp_path / "label.dat.test"),
            "--link_test_file", str(tmp_path / "link.dat.test"),
            "--supervised", supervised,
            "--record_file", str(tmp_path / f"record_{name}.dat")])
    for task, scores in res["jax"].items():
        for k, v in scores.items():
            assert abs(res["port"][task][k] - v) <= 1e-12, (task, k)
            assert 0 <= v <= 1
    assert (tmp_path / "record_jax.dat").read_text() == \
        (tmp_path / "record_port.dat").read_text()


def test_tuners_pick_jax_cs(tmp_path):
    """The binary-search C tuners on every fold of the fixtures."""
    cli_fixture(tmp_path)
    emb = tev.load_emb_dict(str(tmp_path / "emb.dat"))
    ids, labs = tev._read_label_file(str(tmp_path / "label.dat"))
    X = np.asarray([emb[i] for i in ids])
    y = np.asarray([int(v) for v in labs])
    for tr, _ in tev.StratifiedKFold(5, random_state=1).split(X, y):
        assert tev.single_label_binary_search_cv(X[tr], y[tr]) == \
            jev.single_label_binary_search_cv(X[tr], y[tr])
    mat = (X[:, :3] > 0).T
    assert tev.multi_label_binary_search_cv(X, mat) == \
        jev.multi_label_binary_search_cv(X, mat)


# -----------------------------------------------------------------------------
# the unc_nc gate through the port
# -----------------------------------------------------------------------------

def regression_fixture():
    """tests/test_regression.py:120-135: a fixed-seed 2-community HIN."""
    rng = np.random.default_rng(5)
    n_per, r = 20, 2
    n = 2 * n_per
    rows = []
    for c in range(2):
        base = c * n_per
        for _ in range(200):
            a, b = rng.integers(0, n_per, 2)
            if a != b:
                rows.append((base + a, c, base + b))
    for _ in range(8):
        a = rng.integers(0, n_per)
        b = n_per + rng.integers(0, n_per)
        rows.append((a, rng.integers(0, r), b))
    triplets = np.asarray(sorted(set(map(tuple, rows))), np.int64)
    return triplets, n, r, np.repeat([0, 1], n_per)


def test_unc_nc_gate_through_the_port(monkeypatch):
    triplets, n, r, labels = regression_fixture()
    kw = dict(lr=1e-2, negative_rate=2, graph_batch_size=64,
              graph_split_size=0.9, sampler="randomwalk", sample_depth=2,
              sample_width=6, n_epochs=8, v_max=n, e_max=len(triplets) + 20,
              seed=0)

    class Initialised(Exception):
        pass

    seen = {}

    def init(*a, **k):
        seen["variables"] = jdrv.init_unc_variables.__wrapped__(*a, **k)
        raise Initialised

    init.__wrapped__ = jdrv.init_unc_variables
    monkeypatch.setattr(jdrv, "init_unc_variables", init)
    with pytest.raises(Initialised):              # JAX's initial weights
        jdrv.train_unc(triplets, n, r, h_dim=16, n_layers=2, reg_param=0.01,
                       log=lambda s: None, **kw)
    v = seen["variables"]
    # the JAX model's dropout (0.2 by default) is a no-op in DualGraphConv
    m = tm.UNCTrainModel(n, r, 16, num_hidden_layers=2, dropout=0.2,
                         reg_param=0.01)
    m.load_state_dict(tm.params_from_flax(v["params"], v["batch_stats"]))
    embs, coverage = tdrv.train_unc(m, triplets, n, r, log=lambda s: None,
                                    **kw)
    macro, micro = tev.nc_evaluate_arrays(embs, np.arange(n), labels)
    got = {"coverage": coverage, "macro_f1": macro, "micro_f1": micro}
    rel_tol = {"coverage": 0.01, "macro_f1": 0.10, "micro_f1": 0.10}
    with open(EXPECTED) as f:
        expected = json.load(f)["unc_nc"]
    assert set(expected) == set(rel_tol)
    for k, want in expected.items():
        assert abs(got[k] - want) <= rel_tol[k] * max(abs(want), 1e-6), \
            (k, got[k], want)


# -----------------------------------------------------------------------------
# unc_transform and the reference's command shapes
# -----------------------------------------------------------------------------

def test_transform_cli_writes_the_jax_files(tmp_path):
    """An HNE-format dataset (tests/test_loader_fixtures.py:116-150, with
    attributes) through both transform CLIs: the same files, byte for
    byte."""
    from dualmessagepassing_tpu.cli.unc_transform import main as jax_main
    from dualmessagepassing_tpu_torch.cli.unc_transform import main

    raw = tmp_path / "raw"
    raw.mkdir()
    (raw / "node.dat").write_text(
        "0\tapple\t0\t0.1,0.2\n1\tbanana\t0\t0.3,0.4\n"
        "2\tcherry\t1\t0.5,0.6\n3\tdate\t1\t0.7,0.8\n")
    (raw / "link.dat").write_text(
        "0\t2\t0\t1.0\n1\t3\t1\t1.0\n2\t1\t0\t2.0\n")
    (raw / "label.dat").write_text("0\tapple\t0\t1\n3\tdate\t1\t0\n")
    (raw / "label.dat.test").write_text("1\tbanana\t0\t1\n")
    (raw / "link.dat.test").write_text("1\t2\t1\n0\t3\t0\n")
    (raw / "meta.dat").write_text(
        "Node Total: = 4\nNode Type_0: = 2\nNode Type_1: = 2\n"
        "Edge Total: = 3\nEdge Type_0: = 2\nEdge Type_1: = 1\n"
        "Label Total: = 2\n")
    for name, cli in (("jax", jax_main), ("port", main)):
        cli(["--data_dir", str(raw), "--out_dir", str(tmp_path / name),
             "--attributed", "True", "--supervised", "true"])
    files = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert files == ["label.dat", "link.dat", "node.dat", "seed_node.dat"]
    assert files == sorted(p.name for p in (tmp_path / "port").iterdir())
    for f in files:
        assert (tmp_path / "port" / f).read_text() == \
            (tmp_path / "jax" / f).read_text(), f


def test_reference_command_shapes_derive_the_jax_paths(tmp_path,
                                                       monkeypatch):
    """transform.sh's single-dash flags and evaluate.sh's --dataset /
    --model derive the HNE-layout paths the JAX CLIs derive
    (tests/test_reference_commands.py:192-231)."""
    import dualmessagepassing_tpu_torch.cli.unc_evaluate as ev
    import dualmessagepassing_tpu_torch.cli.unc_transform as tr

    monkeypatch.chdir(tmp_path)      # the derived record path is relative

    seen = {}
    monkeypatch.setattr(
        "dualmessagepassing_tpu_torch.unc.transform.transform",
        lambda data_dir, out_dir, attributed, supervised:
            seen.update(data_dir=data_dir, out_dir=out_dir,
                        attributed=attributed, supervised=supervised))
    tr.main(["-dataset", "PubMed", "-model", "DMPNN", "-attributed",
             "False", "-supervised", "False"])
    assert seen == {"data_dir": "../Data/PubMed",
                    "out_dir": "../Model/DMPNN/data/PubMed",
                    "attributed": False, "supervised": False}
    calls = {}
    monkeypatch.setattr(
        "dualmessagepassing_tpu_torch.unc.evaluate.load_emb_dict",
        lambda path: calls.update(emb=path) or {})
    monkeypatch.setattr(
        "dualmessagepassing_tpu_torch.unc.evaluate.nc_evaluate",
        lambda label, label_test, emb, supervised, multi:
            calls.update(label=label, label_test=label_test,
                         supervised=supervised, multi=multi) or (0.0, 0.0))
    ev.main(["--dataset", "Yelp", "--model", "DMPNN", "--task", "nc",
             "--attributed", "False", "--supervised", "False",
             "--emb_file", "emb_noattr.dat"])
    assert calls == {"emb": "emb_noattr.dat",
                     "label": "../Data/Yelp/label.dat",
                     "label_test": "../Data/Yelp/label.dat.test",
                     "supervised": False, "multi": True}
