"""The FLOP and byte counts against hand counts at a tiny size, and the
FLOP counts against what torch's FlopCounterMode counts in the plain
references' forward (every row real)."""

from __future__ import annotations

import copy

import numpy as np
import torch
from torch.utils.flop_counter import FlopCounterMode

from perfbench.core.manifest import load_file, resolve, BENCH_DIR
from perfbench.core.precision import Matmul
from perfbench.core.weights import make_weights

UNC_COUNTS = load_file(BENCH_DIR / "counts" / "unc_pubmed_dmpnn.py", "c")
SCM_COUNTS = load_file(BENCH_DIR / "counts" / "scm_complex_dmpnn.py", "c")


def test_unc_bytes_by_hand():
    s = {"nodes": 5, "edges": 7, "samples": 6, "hidden": 4, "layers": 1,
         "rels": 2}
    # W = 9; K1: fwd 112+80+24, recv-gather bwd 252+180+24,
    # send-gather bwd 252+56+180+24; K2: fwd 252+180+56, bwd 112+80+56
    assert UNC_COUNTS.kernel_bytes(s) == {"K1": 1184, "K2": 736}
    assert UNC_COUNTS.kernel_bytes(dict(s, layers=2))["K1"] == 2368


def test_unc_flops_by_hand():
    s = {"nodes": 5, "edges": 7, "samples": 6, "hidden": 4, "layers": 1,
         "rels": 2}
    # layer 2·16·(25 + 42) = 2144; relation rows and mean 2·2·7·4·4 = 448;
    # DistMult 2·6·2·4 = 96; edge_fc 2·7·16 = 224; its rows 2·7·2·4 = 112
    assert UNC_COUNTS.forward_flops(s) == 2144 + 448 + 96 + 224 + 112
    assert UNC_COUNTS.train_step(s)[0] == 3 * 3024


def test_scm_bytes_by_hand():
    s = {"batch": 1, "p_nodes": 2, "p_edges": 2, "g_nodes": 3,
         "g_edges": 4, "hidden": 2, "pred_hidden": 2, "layers": 1,
         "enc_vl": 2, "enc_el": 2}
    # pattern: sum 16+16+16, degrees 8+8+16, bwd 2·(32+32+16);
    # graph:   sum 32+24+32, degrees 16+12+32, bwd 2·(64+48+32)
    fwd = 48 + 32 + 88 + 60
    assert SCM_COUNTS.k3_bytes(s, False) == fwd
    assert SCM_COUNTS.k3_bytes(s, True) == fwd + 160 + 288


def _unc_batch(rng, v, e, s, r):
    nid = np.arange(v)
    snd = rng.integers(0, v, e)
    rcv = np.sort(rng.integers(0, v, e))
    rcv[:v] = np.arange(v)          # every node has an in-edge
    rcv.sort()
    et = rng.integers(0, 2 * r, e)
    samples = np.stack([rng.integers(0, v, s), rng.integers(0, r, s),
                        rng.integers(0, v, s)], 1)
    return {"nid": nid, "node_mask": np.ones(v, bool),
            "senders": snd, "receivers": rcv, "edge_type": et,
            "rev_flag": et >= r, "edge_mask": np.ones(e, bool),
            "samples": samples, "sample_mask": np.ones(s, bool),
            "labels": (np.arange(s) < s // 6).astype(np.float32)}


def test_unc_flops_match_the_reference_forward():
    cell = resolve("unc_pubmed_dmpnn-train")
    ref = cell.reference
    config = copy.deepcopy(cell.config)
    config["data"].update(num_nodes=9, num_links=20)
    hp = ref.hparams(config)
    batch = _unc_batch(np.random.default_rng(0), 9, 23, 12, hp["num_rels"])
    W = make_weights(ref.param_spec(config), 3, "cpu")
    b = ref.batch_tensors(batch, "cpu")
    with FlopCounterMode(display=False) as fc:
        ref.loss_fn(W, b, hp, Matmul("float32", torch.device("cpu")))
    s = {"nodes": 9, "edges": 23, "samples": 12, "hidden": hp["hidden"],
         "layers": hp["layers"], "rels": hp["num_rels"]}
    assert fc.get_total_flops() == UNC_COUNTS.forward_flops(s)


def test_scm_flops_match_the_reference_forward():
    cell = resolve("scm_complex_dmpnn-eval")
    ref = cell.reference
    hp = ref.hparams(cell.config)
    rng = np.random.default_rng(1)
    n = 3
    raw = {"p_src": rng.integers(0, 8, (n, 8)),
           "p_dst": rng.integers(0, 8, (n, 8)),
           "p_vl": rng.integers(0, 8, (n, 8)),
           "p_el": rng.integers(0, 8, (n, 8)),
           "g_src": rng.integers(0, 64, (n, 256)),
           "g_dst": rng.integers(0, 64, (n, 256)),
           "g_vl": rng.integers(0, 16, (n, 64)),
           "g_el": rng.integers(0, 16, (n, 256)),
           "counts": np.ones(n, np.float32)}
    W = make_weights(ref.param_spec(cell.config), 3, "cpu")
    bt = ref.batch(raw, list(range(n)), hp, "cpu")
    with FlopCounterMode(display=False) as fc:
        ref.forward(W, bt, hp, Matmul("float32", torch.device("cpu")))
    s = {"batch": n, "p_nodes": 8 * n, "p_edges": 16 * n,
         "g_nodes": 64 * n, "g_edges": 512 * n, "hidden": 64,
         "pred_hidden": 64, "layers": 3, "enc_vl": 8, "enc_el": 10}
    assert fc.get_total_flops() == SCM_COUNTS.forward_flops(s)
