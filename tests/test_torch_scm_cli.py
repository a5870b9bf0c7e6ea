"""The port's SCM command lines (cli/config.py, cli/scm_train.py,
cli/scm_evaluate.py) and what they stand on (utils/io.py, utils/log.py,
data/dual.py, train/checkpoint.py, scm_driver.MultiSteps) against the
JAX package on the CPU.

Tolerances: the config dicts, the model configs, the readers, the log
lines, the dual conversion, expand_params and the dataset cache are
exact (equal values, equal arrays); MultiSteps against optax.MultiSteps
1e-6 per element (float32 arithmetic, optax's Welford mean); a restored
checkpoint gives eval outputs bitwise equal to those before the save.
"""

import copy
import dataclasses
import itertools
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from dualmessagepassing_tpu import build_model as jbuild
from dualmessagepassing_tpu.cli import config as jcfg
from dualmessagepassing_tpu.cli import scm_train as jtrain
from dualmessagepassing_tpu.data import dual as jdual
from dualmessagepassing_tpu.data.dataset import GraphAdjDataset as JDataset
from dualmessagepassing_tpu.data.synthetic import generate_dataset as jgen
from dualmessagepassing_tpu.train import checkpoint as jckpt
from dualmessagepassing_tpu.train import scm_driver as jdrv
from dualmessagepassing_tpu.utils import io as jio
from dualmessagepassing_tpu.utils import log as jlog
from dualmessagepassing_tpu_torch.cli import config as tcfg
from dualmessagepassing_tpu_torch.cli import scm_evaluate as teval
from dualmessagepassing_tpu_torch.cli import scm_train as ttrain
from dualmessagepassing_tpu_torch.data import dual as tdual
from dualmessagepassing_tpu_torch.data.dataset import \
    GraphAdjDataset as TDataset
from dualmessagepassing_tpu_torch.models import scm_models as sm
from dualmessagepassing_tpu_torch.train import checkpoint as tckpt
from dualmessagepassing_tpu_torch.train import scm_driver as tdrv
from dualmessagepassing_tpu_torch.utils import io as tio
from dualmessagepassing_tpu_torch.utils import log as tlog

from test_loader_fixtures import GML_TEXT
from test_reference_commands import (COMPLEX, ERDOS_RENYI, MUTAG, REGULAR,
                                     _split)

README = {"erdos-renyi": ERDOS_RENYI, "regular": REGULAR,
          "complex": COMPLEX, "mutag": MUTAG}
# a tiny synthetic run of the CLI (tests/test_cli.py's sizes)
TINY = ["--synthetic", "True", "--synthetic_pairs", "16",
        "--max_npv", "3", "--max_npe", "3", "--max_ngv", "6",
        "--max_nge", "10", "--hid_dim", "8", "--pred_hid_dim", "8",
        "--rep_num_pattern_layers", "1", "--rep_num_graph_layers", "1",
        "--train_batch_size", "8", "--eval_batch_size", "8",
        "--match_weights", "node,edge", "--device", "cpu"]
VOCAB2 = ["--max_npvl", "2", "--max_npel", "2", "--max_ngvl", "2",
          "--max_ngel", "2"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the shapes here are tiny, and the test workers
    share the CPU's cores, where OpenMP threads waiting on a busy core
    cost far more than the work they split."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def assert_tree_equal(a, b, path="") -> None:
    """Equal nested dicts/lists of arrays and scalars, exactly."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            assert_tree_equal(a[k], b[k], f"{path}.{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_tree_equal(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
    else:
        assert a == b, path


# --- cli/config.py ----------------------------------------------------------

@pytest.mark.parametrize("name", list(README))
def test_readme_commands_parse_to_the_jax_config(name):
    """The four README command lines (all --rep_net DMPNN) give the JAX
    CLI's config dict, plus the port's --device (default cuda)."""
    argv = _split(README[name])
    got = tcfg.get_train_config(argv)
    assert got.pop("device") == "cuda"
    assert got == jcfg.get_train_config(argv)


@pytest.mark.parametrize("add_rev", ["True", "False"])
@pytest.mark.parametrize("dual", ["False", "True"])
@pytest.mark.parametrize("name", ["erdos-renyi", "complex"])
def test_model_configs_equal_jax(name, add_rev, dual):
    """process_model_config (reversed-edge doubling, the dual sizes) and
    to_model_config give the JAX package's ModelConfig, field for
    field."""
    argv = _split(README[name]) + ["--add_rev", add_rev,
                                   "--convert_dual", dual]
    t = tcfg.to_model_config(tcfg.process_model_config(
        tcfg.get_train_config(argv)))
    j = jcfg.to_model_config(jcfg.process_model_config(
        jcfg.get_train_config(argv)))
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    if name == "erdos-renyi" and add_rev == "True" and dual == "True":
        assert t.max_ngv == 96         # the dual graph's V: 2 * 48 edges


def test_config_defaults_equal_jax():
    got = tcfg.get_train_config([])
    got.pop("device")
    assert got == jcfg.get_train_config([])


def test_refused_at_parse_time(tmp_path, monkeypatch):
    """All nine representation networks of the JAX CLI parse, the
    sequence networks to the JAX CLI's config. Data parallelism (refused
    here until slice E1 ported it) trains: --dp_devices 2 --device cpu
    runs an epoch on two gloo ranks and rank 0 writes the run; what the
    JAX CLI refuses is refused before any data is built: a batch size
    that the ranks do not divide, and more ranks than visible cards."""
    for net in ("CNN", "RNN", "TXL"):
        argv = ["--rep_net", net, "--rep_rnn_type", "GRU",
                "--rep_cnn_kernel_sizes", "3"]
        got = tcfg.get_train_config(argv)
        assert got.pop("device") == "cuda"
        assert got == jcfg.get_train_config(argv)
    for net in ("DMPNN", "CompGCN", "RGCN", "RGIN", "LRP", "DMPLRP"):
        assert tcfg.get_train_config(["--rep_net", net])["rep_net"] == net
    argv = TINY + ["--dp_devices", "2", "--train_epochs", "1",
                   "--save_model_dir", str(tmp_path / "dp")]
    run = ttrain.main(argv)
    for name in ("log.txt", "config.json", "dev_results0.json",
                 "test_results0.json"):
        assert os.path.exists(os.path.join(run, name)), name
    log = open(os.path.join(run, "log.txt")).read()
    assert "data parallel: 2 ranks over gloo" in log
    assert os.listdir(tmp_path / "dp") == [os.path.basename(run)]
    with pytest.raises(ValueError, match="divisible"):
        ttrain.main(TINY + ["--dp_devices", "3"])
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="visible"):
        ttrain.main([a if a != "cpu" else "cuda" for a in TINY]
                    + ["--dp_devices", "2"])


def test_attention_predict_nets_refused_at_parse_time():
    """All seven attention predict nets of the JAX package (models/
    pred_attn.py:527-535), the memory nets among them, and the pooling
    nets parse and build with --pred_num_heads, --pred_mem_len and
    --pred_mem_init, each memory net over several of the ten mem_inits;
    an unknown mem_init raises at build, as in the JAX package. (The
    memory nets were refused here, naming slice D2b-ii, until that slice
    ported them.)"""
    from dualmessagepassing_tpu.models.pred_attn import ATTN_PRED_NETS
    from dualmessagepassing_tpu_torch.models import pred as tpred
    from dualmessagepassing_tpu_torch.models import pred_attn as tattn
    assert set(ATTN_PRED_NETS) == set(tattn.ATTN_PRED_NETS)
    names = ["SumPredictNet", "MeanPredictNet", "MaxPredictNet",
             *tattn.ATTN_PRED_NETS]
    inits = itertools.cycle(tattn.MEM_INITS)
    for name in names:
        for init in [next(inits) for _ in range(3 if "Mem" in name
                                                or name == "DIAMNet"
                                                else 1)]:
            cfg = tcfg.get_train_config(TINY + [
                "--pred_net", name, "--pred_num_heads", "2",
                "--pred_mem_len", "3", "--pred_mem_init", init])
            assert (cfg["pred_net"], cfg["pred_mem_init"]) == (name, init)
            mcfg = tcfg.to_model_config(tcfg.process_model_config(cfg))
            net = sm.build_model(mcfg, device="cpu").pred_net_v
            attn = getattr(net, "g_attn", None)
            assert (attn is not None) == (name in tattn.ATTN_PRED_NETS)
            if isinstance(attn, tattn.MemDotAttention):
                assert (attn.mem_len, attn.mem_init) == (3, init)
                attn = attn.attn
            if isinstance(net, tattn.DIAMNet):
                assert (net.mem_len, net.mem_init) == (3, init)
            assert attn is None or attn.num_heads == 2
    for name in ("DIAMNet", "SumMemAttnPredictNet"):
        with pytest.raises(NotImplementedError, match="mem_init"):
            tpred.build_pred_net(name, 8, 6, "relu", 0.0, True,
                                 mem_init="circular")


def test_gpu_id_minus_one_asks_for_cuda(tmp_path):
    """--gpu_id -1 (the default) without --device cpu means the current
    CUDA device, never the CPU: with no card the CLI raises before it
    writes or builds anything."""
    cfg = tcfg.get_train_config(["--gpu_id", "-1"])
    assert tcfg.train_device(dict(cfg, device="cpu")).type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("this check needs a machine without CUDA")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcfg.train_device(cfg)
    argv = [a for a in TINY if a not in ("--device", "cpu")]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ttrain.main(argv + ["--gpu_id", "-1",
                            "--save_model_dir", str(tmp_path)])
    assert os.listdir(tmp_path) == []


# --- utils/io.py, utils/log.py ------------------------------------------------

def _write_fixture(root, split_files: bool):
    """A reference-format dataset: two patterns, per-pattern graph
    directories of 10 graphs (routed by g_idx % 10) or a split file set;
    the graphs are the hand-written igraph GML."""
    pdir, gdir, mdir = root / "patterns", root / "graphs", root / "metadata"
    pdir.mkdir(parents=True)
    mdir.mkdir()
    for p in ("P_0", "P_1"):
        (pdir / f"{p}.gml").write_text(GML_TEXT)
        (gdir / p).mkdir(parents=True)
        rows = ["g_id,counts,subisomorphisms"]
        for i in range(10):
            (gdir / p / f"G_N3_E2_{i}.gml").write_text(GML_TEXT)
            rows.append(f'G_N3_E2_{i},{i % 3},"{[[0, 2, 1]] * (i % 3)}"')
        (mdir / f"{p}.csv").write_text("\n".join(rows) + "\n")
    if split_files:
        for name, ids in (("train", range(0, 6)), ("dev", range(6, 8)),
                          ("test", range(8, 10))):
            (mdir / f"{name}.txt").write_text(
                "".join(f"{i}\n" for i in ids))
    return str(pdir), str(gdir), str(mdir)


@pytest.mark.parametrize("split_files", [False, True])
def test_load_data_equals_jax(tmp_path, split_files):
    dirs = _write_fixture(tmp_path, split_files)
    got, got_shared = tio.load_data(*dirs)
    want, want_shared = jio.load_data(*dirs)
    assert got_shared == want_shared
    assert_tree_equal(dict(got), dict(want))
    assert sum(len(v) for v in got.values()) == 20
    path = os.path.join(dirs[0], "P_0.gml")
    assert_tree_equal(tio.read_gml_graph(path), jio.read_gml_graph(path))


def test_str_helpers_and_results_equal_jax(tmp_path):
    for s in ("True", "no", "1"):
        assert tio.str2bool(s) == jio.str2bool(s)
    for s in ("1, 2,null,x", "anneal_cosine$1$0", "0.5,[2]"):
        assert tio.str2list(s) == jio.str2list(s)
        assert tio.str2value(s) == jio.str2value(s)
    res = {"MAE": np.float32(0.5), "n": np.int64(3),
           "pred": np.arange(3, dtype=np.float32),
           "t": torch.tensor([1.5, 2.0])}
    tio.save_results(res, str(tmp_path / "r.json"))
    assert json.load(open(tmp_path / "r.json")) == {
        "MAE": 0.5, "n": 3, "pred": [0.0, 1.0, 2.0], "t": [1.5, 2.0]}


LOG_KW = [dict(loss=0.123456, n=7, tag="x"), dict(MAE=12.5), {}]


@pytest.mark.parametrize("kw", LOG_KW)
def test_log_lines_equal_jax(kw):
    for args in (("train", 3, 100, 5, 50), ("dev", -1, -1, -1, -1),
                 ("test", 12, 200, -1, -1)):
        assert tlog.generate_log_line(*args, **kw) == \
            jlog.generate_log_line(*args, **kw)
    assert tlog.generate_best_line("dev", 4, 10, **kw) == \
        jlog.generate_best_line("dev", 4, 10, **kw)


def _write_log(mod, path, tag):
    logger = mod.init_logger(str(path), log_tag=tag)
    for epoch, (dev, test) in enumerate([(9.5, 9.7), (7.25, 8.0),
                                         (8.0, 7.0), (6.125, 6.5)]):
        logger.info("data_type: %-10s\tepoch: %05d/%05d\tloss: %.6f"
                    % ("train", epoch, 4, 1.0 / (epoch + 1)))
        if epoch != 2:
            for split, v in (("dev", dev), ("test", test)):
                logger.info(mod.generate_best_line(split, epoch, 4,
                                                   **{"eval-MAE": v}))
    mod.close_logger(logger)


def test_best_epochs_read_across_packages(tmp_path):
    """Each package finds the best epoch in the log the other wrote."""
    _write_log(tlog, tmp_path / "port.txt", "DMPNN")
    _write_log(jlog, tmp_path / "jax.txt", "DMPNN")
    want = {"eval-MAE": {"dev": (3, 6.125), "test": (3, 6.5)}}
    for name in ("port.txt", "jax.txt"):
        path = str(tmp_path / name)
        assert tlog.get_best_epochs(path) == want
        assert jlog.get_best_epochs(path) == want


# --- data/dual.py -------------------------------------------------------------

def test_convert_dataset_to_dual_equals_jax():
    data = jgen(12, seed=5, pv=3, pe=3, gv=7, ge=12, num_vlabels=1,
                num_elabels=2, p_v_max=4, p_e_max=5, g_v_max=8, g_e_max=14)
    tds = TDataset(copy.deepcopy(data)).add_reversed_edges(2, 2)
    jds = JDataset(copy.deepcopy(data)).add_reversed_edges(2, 2)
    tdual.convert_dataset_to_dual(tds)
    jdual.convert_dataset_to_dual(jds)
    assert_tree_equal(tds.data, jds.data)
    assert any(len(x["subisomorphisms"]) for x in tds.data)
    rec = data[0]["graph"]
    assert_tree_equal(tdual.convert_to_dual_record(rec, 40),
                      jdual.convert_to_dual_record(rec, 40))


# --- train/checkpoint.py, scm_driver.MultiSteps --------------------------------

def _jax_params(argv):
    """A JAX model's flax params for a CLI command line (the JAX CLI's
    model build and init)."""
    cfg = jcfg.get_train_config(argv)
    model = jbuild(jcfg.to_model_config(jcfg.process_model_config(cfg)))
    ds = jtrain.build_datasets(cfg, logging.getLogger("test"))
    for d in ds.values():
        d.dataset.add_reversed_edges(cfg["max_npel"], cfg["max_ngel"])
    _, pattern, graph, _, _ = ds["train"].batchify(range(2), "none")
    return model.init(jax.random.PRNGKey(0), pattern, graph)["params"]


def test_expand_params_identity():
    """port.expand_params(params_from_flax(old), params_from_flax(new))
    == params_from_flax(jax.expand_params(old, new)), exactly, growing
    the label vocabularies (and the multihot widths) at the front."""
    base = [a for a in TINY if a not in ("--device", "cpu")]
    old = _jax_params(base + VOCAB2)
    new = _jax_params(base + ["--max_npvl", "5", "--max_npel", "5",
                              "--max_ngvl", "5", "--max_ngel", "5"])
    got = tckpt.expand_params(sm.params_from_flax(old),
                              sm.params_from_flax(new))
    want = sm.params_from_flax(jckpt.expand_params(old, new))
    assert set(got) == set(want)
    grown = 0
    for k in want:
        assert torch.equal(got[k], want[k]), k
        grown += got[k].shape != sm.params_from_flax(old)[k].shape
    assert grown > 0
    with pytest.raises(ValueError, match="rank mismatch"):
        tckpt.expand_params({"w": torch.zeros(2)}, {"w": torch.zeros(2, 3)})


def test_multisteps_matches_optax():
    """--train_grad_steps 2: four calls with the same gradients and LR
    multipliers against optax.MultiSteps over the JAX optimizer; the
    inner step count (amsgrad's bias corrections) advances on updates
    only, the outer count (the LR clock) on every call."""
    rng = np.random.default_rng(0)
    shapes = {"a": (5, 3), "b": (7,)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: (sc * rng.normal(size=s)).astype(np.float32)
              for k, s in shapes.items()} for sc in (1.0, 30.0, 0.3, 0.05)]
    mults = [1.0, 0.5, 2.0, 0.25]

    tx = optax.MultiSteps(jdrv.make_optimizer(lr=1e-2, weight_decay=1e-2),
                          2)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    state = tx.init(jp)
    tp = {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
          for k, v in params.items()}
    opt = tdrv.MultiSteps(tdrv.make_optimizer(tp.values(), lr=1e-2,
                                              weight_decay=1e-2), 2)
    for i, (g, mult) in enumerate(zip(grads, mults)):
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                   state, jp)
        jp = optax.apply_updates(jp, jax.tree.map(lambda u: u * mult,
                                                  updates))
        for k, p in tp.items():
            p.grad = torch.from_numpy(g[k])
        opt.step(mult)
        for k, p in tp.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]),
                                       rtol=0, atol=1e-6)
        assert opt.count == i + 1
        assert opt.inner.count == int(state.gradient_step) == (i + 1) // 2
    back = tdrv.MultiSteps(tdrv.make_optimizer(tp.values(), lr=1e-2), 2)
    back.load_state_dict(opt.state_dict())
    assert (back.count, back.inner.count) == (4, 2)


def test_restored_checkpoint_evaluates_bitwise(tmp_path):
    """save_state -> a fresh model restored from it gives eval outputs
    bitwise equal to the saved model's, and its optimizer state."""
    cfg = tcfg.get_train_config(TINY + VOCAB2)
    logger = logging.getLogger("test")
    ds = ttrain.build_datasets(cfg, logger)
    bounds = ttrain.transform_datasets(ds, cfg, remove_loops=False)
    model, _ = ttrain.build_scm_model(cfg, bounds, "cpu")
    tx = tdrv.make_optimizer(model.parameters(), 1e-2)
    step = tdrv.make_train_step(model, tx, return_weights="node,edge")
    _, pat, gra, counts, (nw, ew) = ds["train"].batchify(range(8),
                                                         "node,edge")
    step(pat, gra, counts, nw, ew, 0.2, 0.1, 0.01, 1e-4)
    gen = torch.Generator().manual_seed(3)
    tckpt.save_state(str(tmp_path / "epoch0"), model, tx, tx.count, gen)
    tckpt.save_params(str(tmp_path / "params"), model.state_dict())

    fresh, _ = ttrain.build_scm_model(dict(cfg, seed=9), bounds, "cpu")
    fresh_tx = tdrv.make_optimizer(fresh.parameters(), 1e-2)
    fresh_gen = torch.Generator()
    saved = tckpt.restore_state(str(tmp_path / "epoch0"), fresh, fresh_tx,
                                fresh_gen)
    assert saved["step"] == 1 and fresh_tx.count == 1
    assert torch.equal(fresh_gen.get_state(), gen.get_state())
    want = tdrv.make_eval_step(model)(pat, gra)
    got = tdrv.make_eval_step(fresh)(pat, gra)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    sd = tckpt.restore_params(str(tmp_path / "params"))
    assert all(torch.equal(sd[k], v) for k, v in model.state_dict().items())


# --- cli/scm_train.py, cli/scm_evaluate.py -------------------------------------

def test_dataset_cache_reads_across_packages(tmp_path):
    """--save_data_dir: the pickles one package writes, the other reads,
    record for record."""
    argv = TINY + VOCAB2
    logger = logging.getLogger("test")
    for writer, reader in ((jtrain, ttrain), (ttrain, jtrain)):
        d = str(tmp_path / writer.__name__.split(".")[0])
        cfg = (tcfg if writer is ttrain else jcfg).get_train_config(
            [a for a in argv if writer is ttrain or a not in
             ("--device", "cpu")] + ["--save_data_dir", d])
        made = writer.build_datasets(cfg, logger)
        assert sorted(os.listdir(d)) == [f"{k}_dataset.pkl"
                                         for k in ("dev", "test", "train")]
        read = reader.build_datasets(dict(cfg, synthetic=False), logger)
        for k in ("train", "dev", "test"):
            assert_tree_equal(read[k].dataset.data, made[k].dataset.data)


def test_cli_training_follows_the_jax_cli(tmp_path, monkeypatch):
    """The port's CLI and the JAX CLI on the same synthetic set, from the
    same initial weights (the JAX CLI's draw, carried over with
    params_from_flax), float32 on the CPU: each epoch's logged train loss
    and dev/test metrics agree to 1e-4 relative (the same arithmetic in
    another summation order). The matching losses are on, so train batches
    that carried other weights than the JAX CLI's (none) would show."""
    follow_the_jax_cli(tmp_path, monkeypatch, [])


@pytest.mark.parametrize("extra", [
    ["--rep_net", "RGCN"],
    # the JAX step compiles anew for each batch's perm envelope: 24 pairs
    ["--rep_net", "LRP", "--synthetic_pairs", "24"],
    ["--rep_net", "CNN"],
    ["--rep_net", "RNN", "--rep_rnn_bidirectional", "True"],
    ["--rep_net", "TXL", "--rep_txl_seg_len", "8", "--rep_txl_mem_len",
     "8"]], ids=["RGCN", "LRP", "CNN", "RNN", "TXL"])
def test_cli_training_follows_the_jax_cli_for_other_nets(tmp_path,
                                                         monkeypatch, extra):
    """test_cli_training_follows_the_jax_cli for R-GCN (the node-only
    scaffold, no edge head), LRP (the LRP collate) and the sequence
    networks (the EdgeSeq collate; CNN's pooling refines the dev/test
    edge weights before the EED, as the JAX CLI's evaluate_epoch(model=)
    does; TXL over four segments)."""
    follow_the_jax_cli(tmp_path, monkeypatch, extra)


def follow_the_jax_cli(tmp_path, monkeypatch, extra):
    import re

    import dualmessagepassing_tpu.train as jtrain_pkg

    init = {}
    create = jtrain_pkg.TrainState.create

    def spy(variables, tx):     # a host copy: the JAX step donates them
        init.update(jax.tree.map(np.array, variables))
        return create(variables, tx)

    monkeypatch.setattr(jtrain_pkg.TrainState, "create", spy)
    build = ttrain.build_scm_model

    def from_jax_init(config, bounds, device):
        model, cfg = build(config, bounds, device)
        model.load_state_dict(sm.params_from_flax(
            init["params"], init.get("batch_stats")))
        return model, cfg

    monkeypatch.setattr(ttrain, "build_scm_model", from_jax_init)
    argv = TINY + VOCAB2 + ["--train_epochs", "2", "--synthetic_pairs",
                            "48", "--max_ngv", "8", "--max_nge", "16"] + extra
    dj = jtrain.main([a for a in argv if a not in ("--device", "cpu")]
                     + ["--save_model_dir", str(tmp_path / "j")])
    dt = ttrain.main(argv + ["--save_model_dir", str(tmp_path / "t")])

    def train_losses(d):
        return [float(x) for x in re.findall(
            r"data_type: train\s+\tepoch: \d+/\d+\tloss: (\S+)",
            open(os.path.join(d, "log.txt")).read())]

    want = train_losses(dj)
    assert len(want) == 2
    assert train_losses(dt) == pytest.approx(want, rel=1e-4)
    for split in ("dev", "test"):
        for epoch in range(2):
            name = f"{split}_results{epoch}.json"
            w = json.load(open(os.path.join(dj, name)))
            g = json.load(open(os.path.join(dt, name)))
            for k in ("MAE", "MSE", "RMSE", "MNED", "MEED"):
                assert g[k] == pytest.approx(w[k], rel=1e-4, nan_ok=True), \
                    (name, k)


def test_cli_train_finetune_dual_evaluate(tmp_path):
    """The CLI on --device cpu as tests/test_cli.py runs the JAX one:
    train (with --train_grad_steps 2), finetune onto a larger vocabulary,
    a --convert_dual run, then scm_evaluate on the first run; the files
    are written, the metrics finite, and scm_evaluate's dev metrics for
    the best epoch equal the training run's (the same data, checkpoint
    and CPU arithmetic)."""
    d1 = ttrain.main(TINY + VOCAB2 + [
        "--train_epochs", "2", "--train_grad_steps", "2",
        "--save_model_dir", str(tmp_path / "a")])
    files = os.listdir(d1)
    for name in ("config.json", "log.txt", "dev_results0.json",
                 "test_results1.json"):
        assert name in files
    best = tlog.get_best_epochs(os.path.join(d1, "log.txt"))
    epoch = best["eval-MAE"]["dev"][0]
    assert jlog.get_best_epochs(os.path.join(d1, "log.txt")) == best
    assert os.path.exists(os.path.join(d1, f"epoch{epoch}",
                                       tckpt.STATE_FILE))

    d2 = ttrain.main(TINY + [
        "--max_npvl", "5", "--max_npel", "5", "--max_ngvl", "5",
        "--max_ngel", "5", "--train_epochs", "1", "--load_model_dir", d1,
        "--save_model_dir", str(tmp_path / "b")])
    assert "finetuning from" in open(os.path.join(d2, "log.txt")).read()
    d3 = ttrain.main(TINY + VOCAB2 + [
        "--train_epochs", "1", "--convert_dual", "True",
        "--save_model_dir", str(tmp_path / "c")])
    for d in (d2, d3):
        res = json.load(open(os.path.join(d, "dev_results0.json")))
        assert all(np.isfinite(res[k]) for k in ("MAE", "MSE", "MNED"))

    if not torch.cuda.is_available():       # the card unless asked
        with pytest.raises(RuntimeError, match="no CUDA device"):
            teval.main(["--load_model_dir", d1])
    out = teval.main(["--load_model_dir", d1, "--device", "cpu"])
    assert sorted(out) == ["dev", "test", "train"]
    for split in out:
        assert any(f.startswith(f"eval_{split}_results")
                   for f in os.listdir(d1))
        assert np.isfinite(out[split]["MAE"])
    logged = json.load(open(os.path.join(d1, f"dev_results{epoch}.json")))
    for k in ("MAE", "MSE", "RMSE", "MNED", "MEED"):
        assert out["dev"][k] == logged[k], k


@pytest.mark.parametrize("net", ["CompGCN", "RGCN", "RGIN", "LRP", "DMPLRP",
                                 "CNN", "RNN", "TXL"])
def test_cli_train_finetune_evaluate_other_nets(tmp_path, net):
    """Each SCM graph and sequence network through the CLIs on --device
    cpu: train, finetune onto a larger vocabulary (expand_params), then
    scm_evaluate of the first run, whose best-epoch dev metrics equal the
    training log's (the same data, checkpoint and CPU arithmetic). The
    sequence networks predict edge weights only: their MNED is NaN, as
    in the JAX package, and their MEED finite."""
    base = TINY + ["--rep_net", net, "--train_epochs", "1"]
    d1 = ttrain.main(base + VOCAB2 + ["--save_model_dir",
                                      str(tmp_path / "a")])
    assert os.path.basename(d1).startswith(f"{net}_SumPredictNet_")
    d2 = ttrain.main(base + ["--max_npvl", "5", "--max_npel", "5",
                             "--max_ngvl", "5", "--max_ngel", "5",
                             "--load_model_dir", d1,
                             "--save_model_dir", str(tmp_path / "b")])
    assert "finetuning from" in open(os.path.join(d2, "log.txt")).read()
    for d in (d1, d2):
        res = json.load(open(os.path.join(d, "dev_results0.json")))
        weights = "MEED" if net in ("CNN", "RNN", "TXL") else "MNED"
        assert all(np.isfinite(res[k]) for k in ("MAE", "MSE", weights))
    out = teval.main(["--load_model_dir", d1, "--device", "cpu"])
    logged = json.load(open(os.path.join(d1, "dev_results0.json")))
    for k in ("MAE", "MSE", "RMSE", "MNED", "MEED"):
        assert out["dev"][k] == pytest.approx(logged[k], rel=1e-6,
                                              nan_ok=True), k
