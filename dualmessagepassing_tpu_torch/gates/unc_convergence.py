"""The UNC learning gates through the port: scripts/unc_convergence.py
(generators 44-160, eval helpers 161-285, SCALES 286-345, run_train
379-436, _train_supervised 439-513, run_eval 516-627, run/main 630-707)
over the port's train_unc, train_unc_supervised, the evaluation
protocols of unc/evaluate.py and unc/linear_svc.py (no scikit-learn),
on the card unless --cpu asks for the CPU.

A planted HIN whose only community signal is its topology (relation
types uniform, communities noisy, degrees skewed) is trained to early
stop, and its embeddings are scored by the reference's protocols (5-fold
LinearSVC node classification, Hadamard link prediction), beside a
random-embedding baseline and an untrained-model export. A supervised
arm runs too: free embeddings with a single-label head, or (the multi
scale) attributed inputs with a multi-label head, held against a linear
probe on the raw attributes. The gate:

  quality_ok       — nc macro-F1 gap vs random >= 0.15 and lp AUC gap vs
                     random >= 0.10 (the script's 610-611);
  beats_attr_probe — (multi) the head's held-out macro-F1 above the
                     attribute probe's.

python -m dualmessagepassing_tpu_torch.gates.unc_convergence --scale ci
  --stage all (default): train in a subprocess (the only process that
    holds the card), which saves the embeddings to an npz; evaluate in
    this process on the host;  --stage train / --stage eval: one half.
The data and the protocols are the script's; initial weights and the
dropout stream are torch's, so a run reaches the gate's thresholds, not
the JAX run's numbers.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def make_hin(V: int, E: int, C: int, R: int, noise: float, seed: int):
    """Planted noisy-community HIN -> (triplets [E, 3] int64, labels [V]
    community ids). Communities have lognormal-skewed sizes; each edge
    picks a source node uniformly, then a destination in the same
    community with probability 1 - noise (else in another community);
    the relation type is uniform over R and carries no community
    information."""
    rng = np.random.default_rng(seed)
    sizes = rng.lognormal(0.0, 0.5, C)
    sizes = np.maximum((sizes / sizes.sum() * V).astype(int), 2)
    sizes[-1] += V - sizes.sum()
    comm = np.repeat(np.arange(C), sizes)
    rng.shuffle(comm)
    members = [np.where(comm == c)[0] for c in range(C)]

    src = rng.integers(0, V, int(E * 1.2))
    intra = rng.random(len(src)) >= noise
    dst = np.empty_like(src)
    for c in range(C):
        m = members[c]
        sel = (comm[src] == c) & intra
        dst[sel] = m[rng.integers(0, len(m), sel.sum())]
        selx = (comm[src] == c) & ~intra
        other = np.concatenate([members[(c + k) % C] for k in range(1, C)])
        dst[selx] = other[rng.integers(0, len(other), selx.sum())]
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rel = rng.integers(0, R, len(src))
    triplets = np.unique(
        np.stack([src, rel, dst], 1).astype(np.int64), axis=0)
    rng.shuffle(triplets)
    return triplets[:E], comm


def make_hin_multi(V: int, E: int, C: int, R: int, noise: float,
                   overlap: float, seed: int):
    """Overlapping-community HIN for the multi-label (Yelp) protocol ->
    (triplets [E, 3], membership [V, C] bool): `overlap` of the nodes
    carry a second community; an edge's source picks one of its
    communities and links inside it with probability 1 - noise (else
    anywhere); relations uniform over R."""
    rng = np.random.default_rng(seed)
    comm = rng.integers(0, C, V)
    second = np.full(V, -1)
    sel = rng.random(V) < overlap
    second[sel] = (comm[sel] + 1 + rng.integers(0, C - 1, sel.sum())) % C
    members = [np.flatnonzero((comm == c) | (second == c))
               for c in range(C)]
    src = rng.integers(0, V, int(E * 1.3))
    use2 = (second[src] >= 0) & (rng.random(len(src)) < 0.5)
    ec = np.where(use2, second[src], comm[src])
    intra = rng.random(len(src)) >= noise
    dst = np.empty_like(src)
    for c in range(C):
        m = members[c]
        i_sel = (ec == c) & intra
        dst[i_sel] = m[rng.integers(0, len(m), i_sel.sum())]
        x_sel = (ec == c) & ~intra
        dst[x_sel] = rng.integers(0, V, x_sel.sum())
    keep = src != dst
    src, dst = src[keep], dst[keep]
    rel = rng.integers(0, R, len(src))
    triplets = np.unique(
        np.stack([src, rel, dst], 1).astype(np.int64), axis=0)
    rng.shuffle(triplets)
    mem = np.zeros((V, C), bool)
    mem[np.arange(V), comm] = True
    mem[sel, second[sel]] = True
    return triplets[:E], mem


def make_attri(mem: np.ndarray, flip: float, seed: int) -> np.ndarray:
    """Noisy node attributes for the attributed configuration (reference
    Model/DMPNN/run.sh attributed=True): the [V, C] membership, a `flip`
    fraction of nodes rewritten to one random community, plus Gaussian
    noise — a linear probe on them is capped below ceiling."""
    rng = np.random.default_rng(seed)
    att = mem.astype(np.float32).copy()
    n_v, n_c = att.shape
    sel = rng.random(n_v) < flip
    att[sel] = 0.0
    att[sel, rng.integers(0, n_c, sel.sum())] = 1.0
    att += rng.normal(0.0, 0.3, att.shape).astype(np.float32)
    return att


def split_lp(triplets: np.ndarray, V: int, frac: float, seed: int):
    """Hold out `frac` of the edges as lp positives plus as many uniform
    negatives -> (train_triplets, lp_lines)."""
    rng = np.random.default_rng(seed)
    n_test = int(len(triplets) * frac)
    order = rng.permutation(len(triplets))
    test, train = triplets[order[:n_test]], triplets[order[n_test:]]
    present = {(int(a), int(b)) for a, _, b in triplets}
    lines = [f"{int(a)}\t{int(b)}\t1" for a, _, b in test]
    n_neg = 0
    while n_neg < n_test:
        a, b = int(rng.integers(0, V)), int(rng.integers(0, V))
        if a != b and (a, b) not in present:
            lines.append(f"{a}\t{b}\t0")
            n_neg += 1
    return train, lines


def multilabel_f1(y_true: np.ndarray, y_pred: np.ndarray,
                  average: str) -> float:
    """sklearn.metrics.f1_score(y_true, y_pred, average, zero_division=0)
    on [n, C] 0/1 indicator matrices: per column 2 tp / (2 tp + fp + fn)
    (0 where that is 0/0), "macro" their mean over all C columns, "micro"
    from the summed counts."""
    t, p = np.asarray(y_true).astype(bool), np.asarray(y_pred).astype(bool)
    tp = (t & p).sum(0).astype(np.float64)
    denom = 2 * tp + (~t & p).sum(0) + (t & ~p).sum(0)
    if average == "micro":
        tp, denom = tp.sum(keepdims=True), denom.sum(keepdims=True)
    elif average != "macro":
        raise ValueError(f"average {average!r}")
    f = np.divide(2 * tp, denom, out=np.zeros(len(tp)), where=denom != 0)
    return float(f.mean())


def _lp_scores(embs: np.ndarray, lp_lines) -> tuple:
    from ..unc.evaluate import lp_evaluate

    with tempfile.NamedTemporaryFile("w", suffix=".dat", delete=False) as f:
        f.write("\n".join(lp_lines))
        lp_path = f.name
    try:
        return lp_evaluate(lp_path, {str(i): embs[i]
                                     for i in range(len(embs))})
    finally:
        os.unlink(lp_path)


def _eval_embs(embs: np.ndarray, labels: np.ndarray, lp_lines, tag, log,
               nc_cap: int | None = None) -> dict:
    """Single-label nc (nc_evaluate_arrays; a stratified subsample of
    nc_cap nodes for the chance-level baselines, whose C search is slow
    on non-separable embeddings) and lp."""
    from ..unc.evaluate import nc_evaluate_arrays

    nc_ids = np.arange(len(labels))
    if nc_cap is not None and len(nc_ids) > nc_cap:
        per = max(nc_cap // int(labels.max() + 1), 2)
        rng = np.random.default_rng(99)
        keep = np.concatenate([
            rng.permutation(np.flatnonzero(labels == c))[:per]
            for c in range(int(labels.max() + 1))])
        nc_ids = np.sort(keep)
    macro, micro = nc_evaluate_arrays(embs, nc_ids, labels[nc_ids])
    auc, mrr = _lp_scores(embs, lp_lines)
    out = {"macro_f1": round(float(macro), 6),
           "micro_f1": round(float(micro), 6),
           "lp_auc": round(float(auc), 6), "lp_mrr": round(float(mrr), 6)}
    log(f"{tag}: {out}")
    return out


def _eval_embs_multi(embs: np.ndarray, mem: np.ndarray, lp_lines, tag,
                     log, nc_cap: int | None = None,
                     fast: bool = False) -> dict:
    """Multi-label twin of _eval_embs: the reference's merged-file 5-fold
    per-class binary-F1 protocol (node_classification.py:147-196) over
    label files in the Yelp format. fast=True (the chance-level
    baselines): per class, a 5-fold stratified LinearSVC at C = 1 instead
    of the crammer_singer C search (a chance-level F1 is C-insensitive)."""
    from ..unc.evaluate import StratifiedKFold, f1_score, nc_evaluate
    from ..unc.linear_svc import LinearSVC

    ids = np.arange(len(mem))
    if nc_cap is not None and len(ids) > nc_cap:
        rng = np.random.default_rng(99)
        ids = np.sort(rng.permutation(len(mem))[:nc_cap])
    if fast:
        y = mem[ids].astype(np.int64)
        x = embs[ids]
        scores, weights = [], []
        for c_i in range(y.shape[1]):
            col = y[:, c_i]
            if col.sum() in (0, len(col)):
                continue
            folds = []
            skf = StratifiedKFold(n_splits=5, random_state=1)
            for tr, te in skf.split(x, col):
                clf = LinearSVC(C=1.0, max_iter=300, multi_class="ovr",
                                random_state=1)
                clf.fit(x[tr], col[tr])
                folds.append(f1_score(col[te], clf.predict(x[te]),
                                      average="binary"))
            scores.append(np.mean(folds))
            weights.append(col.sum())
        sc = np.asarray(scores, np.float64)
        w = np.asarray(weights, np.float64)
        auc, mrr = _lp_scores(embs, lp_lines)
        out = {"macro_f1": round(float(sc.mean()), 6),
               "micro_f1": round(float((sc * w).sum() / w.sum()), 6),
               "lp_auc": round(float(auc), 6),
               "lp_mrr": round(float(mrr), 6),
               "protocol": "fast_baseline_c1"}
        log(f"{tag}: {out}")
        return out
    lines = ["%d\t_\t0\t%s" % (i, ",".join(map(str, np.flatnonzero(mem[i]))))
             for i in ids]
    emb_dict = {str(i): embs[i] for i in range(len(embs))}
    paths = []
    try:
        for text in ("\n".join(lines), ""):   # the protocol merges both
            with tempfile.NamedTemporaryFile("w", suffix=".dat",
                                             delete=False) as f:
                f.write(text)
                paths.append(f.name)
        macro, micro = nc_evaluate(paths[0], paths[1], emb_dict,
                                   supervised=False, multi=True)
    finally:
        for p in paths:
            os.unlink(p)
    auc, mrr = _lp_scores(embs, lp_lines)
    out = {"macro_f1": round(float(macro), 6),
           "micro_f1": round(float(micro), 6),
           "lp_auc": round(float(auc), 6), "lp_mrr": round(float(mrr), 6)}
    log(f"{tag}: {out}")
    return out


# The script's scales (its regime notes: structure-only community
# recovery needs long training — 24 epochs; graph_split_size 0.9 is the
# reference grid's largest value).
SCALES = {
    "full": dict(V=6000, E=72000, C=12, R=4, noise=0.15, h_dim=50,
                 n_layers=2, n_epochs=24, graph_batch_size=2048,
                 graph_split_size=0.9, sample_width=6, sample_depth=2,
                 sup_label_frac=0.5),
    "pubmed": dict(V=20000, E=240000, C=40, R=4, noise=0.15, h_dim=50,
                   n_layers=2, n_epochs=24, graph_batch_size=4096,
                   graph_split_size=0.9, sample_width=6, sample_depth=2,
                   sup_label_frac=0.5),
    "ci": dict(V=1200, E=14400, C=4, R=3, noise=0.15, h_dim=24,
               n_layers=2, n_epochs=24, graph_batch_size=1024,
               graph_split_size=0.9, sample_width=6, sample_depth=2,
               sup_label_frac=0.5),
    # multi-label (Yelp protocol); the supervised arm is attributed and
    # multi-label, with noisy attributes (attr_flip)
    "multi": dict(V=2000, E=28000, C=6, R=3, noise=0.15, h_dim=32,
                  n_layers=2, n_epochs=24, graph_batch_size=1024,
                  graph_split_size=0.9, sample_width=6, sample_depth=2,
                  sup_label_frac=0.5, multilabel=True, overlap=0.3,
                  attr_flip=0.4),
    # harness wiring only, no quality claim
    "smoke": dict(V=300, E=3600, C=3, R=2, noise=0.1, h_dim=16,
                  n_layers=2, n_epochs=4, graph_batch_size=256,
                  graph_split_size=0.9, sample_width=6, sample_depth=2,
                  sup_label_frac=0.5),
    # every arm through the fast fixed-C protocol on a 6,000-row subsample
    "pubmed_multi": dict(V=20000, E=240000, C=40, R=4, noise=0.15,
                         h_dim=50, n_layers=2, n_epochs=48,
                         graph_batch_size=4096, graph_split_size=0.9,
                         sample_width=6, sample_depth=2,
                         sup_label_frac=0.5, multilabel=True, overlap=0.3,
                         attr_flip=0.4, nc_cap_all=6000,
                         nc_fast_all=True),
    "multi_smoke": dict(V=300, E=3600, C=3, R=2, noise=0.1, h_dim=16,
                        n_layers=2, n_epochs=4, graph_batch_size=256,
                        graph_split_size=0.9, sample_width=6,
                        sample_depth=2, sup_label_frac=0.5,
                        multilabel=True, overlap=0.3, attr_flip=0.4),
}
# the JAX driver's defaults that the script leaves as they are
DROPOUT, REG_PARAM, LR = 0.2, 0.01, 1e-2


def hin_and_split(scale: str, seed: int, lp_frac: float, log):
    """Deterministic in (scale, seed, lp_frac): both stages rebuild the
    HIN -> (scale params, train triplets, labels, lp lines)."""
    p = SCALES[scale]
    V, E, C, R = p["V"], p["E"], p["C"], p["R"]
    t0 = time.perf_counter()
    if p.get("multilabel"):
        triplets, labels = make_hin_multi(V, E, C, R, p["noise"],
                                          p["overlap"], seed)
    else:
        triplets, labels = make_hin(V, E, C, R, p["noise"], seed)
    train_trip, lp_lines = split_lp(triplets, V, lp_frac, seed + 1)
    log(f"HIN: V={V} E={len(triplets)} C={C} R={R} noise={p['noise']} "
        f"({time.perf_counter() - t0:.1f}s); lp holdout {len(lp_lines)} rows")
    return p, train_trip, labels, lp_lines


def _model(p, R, device, seed, **kw):
    import torch

    from ..unc.model import UNCTrainModel

    return UNCTrainModel(
        p["V"], R, p["h_dim"], num_hidden_layers=p["n_layers"],
        dropout=DROPOUT, reg_param=REG_PARAM,
        generator=torch.Generator().manual_seed(seed), **kw).to(device)


def run_train(scale: str, seed: int, lp_frac: float, supervised: bool,
              state_path: str, device="cuda", init_weights=None,
              log=print) -> None:
    """Stage 1, every step that touches the device: train the model and
    its untrained twin, export their embeddings, run the supervised arm,
    and savez everything run_eval needs to state_path. init_weights: a
    state_dict (or the path of one saved with torch.save) the trained
    model starts from instead of its generator's draw, e.g. the JAX
    package's initial weights through unc/model.params_from_flax."""
    import torch

    from ..unc.driver import train_unc

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --cpu to run on "
                           "the CPU")
    p, train_trip, labels, _lp = hin_and_split(scale, seed, lp_frac, log)
    V, C, R = p["V"], p["C"], p["R"]
    kw = dict(graph_batch_size=p["graph_batch_size"],
              graph_split_size=p["graph_split_size"], sampler="randomwalk",
              sample_depth=p["sample_depth"], sample_width=p["sample_width"],
              n_epochs=p["n_epochs"], v_max=V, seed=seed, log=log)

    model = _model(p, R, device, seed)
    if isinstance(init_weights, str):
        init_weights = torch.load(init_weights, map_location="cpu",
                                  weights_only=True)
    if init_weights is not None:
        model.load_state_dict(init_weights)
    t0 = time.perf_counter()
    embs, coverage = train_unc(model, train_trip, V, R, lr=LR, **kw)
    train_s = time.perf_counter() - t0
    log(f"trained: coverage {coverage:.3f} in {train_s:.0f}s")
    # the untrained export: the same pipeline at a vanishing learning
    # rate for one epoch (export coverage does not depend on training)
    embs_u, _cov = train_unc(_model(p, R, device, seed), train_trip, V, R,
                             lr=1e-12, **dict(kw, n_epochs=1))

    state = dict(embs=embs, embs_u=embs_u, coverage=np.float64(coverage),
                 train_s=np.float64(train_s), platform=np.str_(device.type),
                 device_name=np.str_(torch.cuda.get_device_name(device)
                                     if device.type == "cuda" else "cpu"))
    if supervised:
        attri = None
        if p.get("multilabel"):
            # the reference's supervised pairing: attributed inputs and a
            # multi-label head (run.sh attributed=True)
            log("multi scale: supervised arm = attributed configuration "
                "(attribute inputs + multi-label head, noisy attributes)")
            attri = make_attri(labels, p["attr_flip"], seed + 5)
            state["attri"] = attri
        sup_out, sup_fc, tr_nodes, te_nodes = _train_supervised(
            p, train_trip, labels, V, C, R, kw, seed, device, log,
            attri=attri, multi=bool(p.get("multilabel")))
        state.update(sup_out=sup_out, sup_fc=sup_fc, tr_nodes=tr_nodes,
                     te_nodes=te_nodes)
    np.savez_compressed(state_path, **state)
    log(f"train stage done -> {state_path}")


def _train_supervised(p, train_trip, labels, V, C, R, kw, seed, device,
                      log, attri=None, multi=False):
    """The supervised arm on the device: label sup_label_frac of the
    nodes, train, then embed every node through covering subgraphs with
    node_fc's predictions (argmax single-label, logit > 0 multi-label)
    -> (embeddings, predictions, train nodes, held-out nodes)."""
    import torch

    from ..ops.segment_kernel import attach_csr_plan
    from ..unc.data import (WholeGraph, compute_edgenorm, pad_subgraph,
                            sample_subgraph_by_randomwalks)
    from ..unc.driver import to_device, train_unc_supervised
    from ..unc.model import apply_unc_supervised_forward

    rng = np.random.default_rng(seed + 3)
    perm = rng.permutation(V)
    n_tr = int(V * p["sup_label_frac"])
    tr_nodes, te_nodes = perm[:n_tr], perm[n_tr:]
    # incident edge indices per labeled node (train edges only)
    inc = {int(n): [] for n in tr_nodes}
    for i, (a, _r, b) in enumerate(train_trip):
        if int(a) in inc:
            inc[int(a)].append(i)
        if int(b) in inc:
            inc[int(b)].append(i)
    tr_idx = {n: v for n, v in inc.items() if v}
    if multi:
        tr_lab = {n: np.flatnonzero(labels[n]) for n in tr_idx}
    else:
        tr_lab = {n: int(labels[n]) for n in tr_idx}
    model = _model(p, R, device, seed, nlabel=C, multi=multi,
                   node_attri=attri)
    train_unc_supervised(model, train_trip, V, R, tr_idx, tr_lab,
                         multi=multi, lr=LR,
                         label_batch_size=min(512, len(tr_idx)), **kw)

    g = WholeGraph(V, R, train_trip)
    out = np.zeros((V, p["h_dim"]), np.float32)
    fc_pred = (np.zeros((V, C), np.int64) if multi
               else np.zeros(V, np.int64))
    got = np.zeros(V, bool)
    e_max = min(V * p["sample_width"], g.num_edges)
    srng = np.random.default_rng(seed + 11)
    for s0 in range(0, V, p["graph_batch_size"]):
        seeds = np.arange(s0, min(s0 + p["graph_batch_size"], V))
        sub = sample_subgraph_by_randomwalks(
            g, seeds, p["sample_depth"], p["sample_width"], srng)
        padded = attach_csr_plan(pad_subgraph(
            sub, np.zeros((0, 3), np.int64), np.zeros(0, np.float32), V,
            e_max, 1, edge_norm=compute_edgenorm(sub)))
        with torch.inference_mode():
            o, pr = apply_unc_supervised_forward(
                model, to_device(padded, device))
        h, pr = o[0].cpu().numpy(), pr.cpu().numpy()
        nid = sub["nid"]
        out[nid] = h[: len(nid)]
        if multi:   # sigmoid(x) > 0.5 <=> logit > 0
            fc_pred[nid] = (pr[: len(nid)] > 0).astype(np.int64)
        else:
            fc_pred[nid] = pr[: len(nid)].argmax(-1)
        got[nid] = True
    log(f"supervised export coverage: {got.mean():.3f}")
    return out, fc_pred, tr_nodes, te_nodes


def run_eval(scale: str, seed: int, lp_frac: float, state_path: str,
             log=print) -> dict:
    """Stage 2, host only: the protocols over the stage-1 state -> the
    result dict (the script's, plus eval_seconds and the device name)."""
    from ..unc.evaluate import f1_score, single_label_binary_search_cv
    from ..unc.linear_svc import LinearSVC

    t_eval = time.perf_counter()
    st = np.load(state_path, allow_pickle=False)
    p, _train_trip, labels, lp_lines = hin_and_split(scale, seed, lp_frac,
                                                     log)
    embs, embs_u = st["embs"], st["embs_u"]

    ev = _eval_embs_multi if p.get("multilabel") else _eval_embs
    base_kw = {"fast": True} if p.get("multilabel") else {}
    trained_kw = {}
    if p.get("nc_cap_all"):
        trained_kw["nc_cap"] = p["nc_cap_all"]
    if p.get("nc_fast_all"):
        trained_kw["fast"] = True
    trained = ev(embs, labels, lp_lines, "trained", log, **trained_kw)
    untrained = ev(embs_u, labels, lp_lines, "untrained", log,
                   nc_cap=4000, **base_kw)
    # the random-embedding baseline, made here
    embs_r = np.random.default_rng(seed + 7).normal(
        size=embs.shape).astype(np.float32)
    random_b = ev(embs_r, labels, lp_lines, "random", log, nc_cap=4000,
                  **base_kw)

    sup = None
    if "sup_out" in st.files and p.get("multilabel"):
        # the head's held-out per-class F1 against a linear probe on the
        # raw (noisy) attributes
        fc_pred, attri = st["sup_fc"], st["attri"]
        tr_nodes, te_nodes = st["tr_nodes"], st["te_nodes"]
        y = labels.astype(np.int64)            # [V, C] membership
        probe = np.zeros((len(te_nodes), y.shape[1]), np.int64)
        for c_i in range(y.shape[1]):
            clf = LinearSVC(C=1.0, max_iter=3000, multi_class="ovr",
                            random_state=0)
            clf.fit(attri[tr_nodes], y[tr_nodes, c_i])
            probe[:, c_i] = clf.predict(attri[te_nodes])
        sup = {
            "mode": "attributed_multilabel",
            "train_fit_macro": round(multilabel_f1(
                y[tr_nodes], fc_pred[tr_nodes], "macro"), 6),
            "heldout_fc_macro": round(multilabel_f1(
                y[te_nodes], fc_pred[te_nodes], "macro"), 6),
            "heldout_fc_micro": round(multilabel_f1(
                y[te_nodes], fc_pred[te_nodes], "micro"), 6),
            "attr_probe_macro": round(multilabel_f1(
                y[te_nodes], probe, "macro"), 6),
        }
        sup["beats_attr_probe"] = bool(
            sup["heldout_fc_macro"] > sup["attr_probe_macro"])
        log(f"supervised (attributed multi): {sup}")
    elif "sup_out" in st.files:
        out, fc_pred = st["sup_out"], st["sup_fc"]
        tr_nodes, te_nodes = st["tr_nodes"], st["te_nodes"]
        c = single_label_binary_search_cv(out[tr_nodes], labels[tr_nodes])
        clf = LinearSVC(C=c, max_iter=3000, multi_class="ovr",
                        random_state=0)
        clf.fit(out[tr_nodes], labels[tr_nodes])
        preds = clf.predict(out[te_nodes])
        sup = {"train_fit_acc": round(float(np.mean(
                   labels[tr_nodes] == fc_pred[tr_nodes])), 6),
               "heldout_fc_acc": round(float(np.mean(
                   labels[te_nodes] == fc_pred[te_nodes])), 6),
               "macro_f1": round(f1_score(labels[te_nodes], preds,
                                          average="macro"), 6),
               "micro_f1": round(f1_score(labels[te_nodes], preds,
                                          average="micro"), 6)}
        log(f"supervised: {sup}")

    gaps = {
        "nc_macro_gap_vs_random":
            round(trained["macro_f1"] - random_b["macro_f1"], 6),
        "lp_auc_gap_vs_random":
            round(trained["lp_auc"] - random_b["lp_auc"], 6),
        "nc_macro_gap_vs_untrained":
            round(trained["macro_f1"] - untrained["macro_f1"], 6),
    }
    quality_ok = bool(gaps["nc_macro_gap_vs_random"] >= 0.15
                      and gaps["lp_auc_gap_vs_random"] >= 0.10)
    return {
        "metric": "unc_quality_macro_f1",
        "value": trained["macro_f1"],
        "unit": "macro_f1",
        "platform": str(st["platform"]),
        "device_name": str(st["device_name"]),
        "config": {**p, "scale": scale, "seed": seed, "lp_frac": lp_frac},
        "coverage": round(float(st["coverage"]), 6),
        "train_seconds": round(float(st["train_s"]), 1),
        "eval_seconds": round(time.perf_counter() - t_eval, 1),
        "trained": trained,
        "untrained": untrained,
        "random": random_b,
        "supervised": sup,
        "gaps": gaps,
        "quality_ok": quality_ok,
    }


def run(scale: str = "full", seed: int = 0, lp_frac: float = 0.05,
        supervised: bool = True, device="cuda", init_weights=None,
        log=print) -> dict:
    """Train and evaluate in this process (tests; the CPU)."""
    with tempfile.TemporaryDirectory() as td:
        sp = os.path.join(td, "state.npz")
        run_train(scale, seed, lp_frac, supervised, sp, device,
                  init_weights, log)
        return run_eval(scale, seed, lp_frac, sp, log)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", choices=list(SCALES), default="full")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--cpu", action="store_true",
                    help="train on the CPU (default: the card)")
    ap.add_argument("--no-supervised", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--check", default=None)
    ap.add_argument("--stage", choices=["all", "train", "eval"],
                    default="all",
                    help="train = the device work only (savez the state, "
                         "exit); eval = the host protocols over a saved "
                         "state; all = train in a subprocess, then eval "
                         "here (this process never holds the card)")
    ap.add_argument("--init-weights", default=None,
                    help="a torch.save'd state_dict the trained model "
                         "starts from (e.g. the JAX package's init)")
    ap.add_argument("--state", default=None,
                    help="state npz path (default: in the temporary "
                         "directory, named by scale and seed)")
    args = ap.parse_args(argv)
    device = "cpu" if args.cpu else "cuda"
    state_path = args.state or os.path.join(
        tempfile.gettempdir(),
        f"unc_conv_state_{args.scale}_{args.seed}.npz")
    t0 = time.perf_counter()
    if args.stage == "train":
        run_train(args.scale, args.seed, 0.05, not args.no_supervised,
                  state_path, device, args.init_weights)
        return None
    if args.stage == "all":
        cmd = [sys.executable, "-m", __spec__.name, "--stage", "train",
               "--scale", args.scale, "--seed", str(args.seed),
               "--state", state_path]
        if args.cpu:
            cmd.append("--cpu")
        if args.no_supervised:
            cmd.append("--no-supervised")
        if args.init_weights:
            cmd += ["--init-weights", args.init_weights]
        rc = subprocess.run(cmd).returncode
        if rc != 0:
            print(f"train stage failed (exit {rc})")
            sys.exit(rc)
    result = run_eval(args.scale, args.seed, 0.05, state_path)
    result["seconds"] = round(time.perf_counter() - t0, 1)
    print(json.dumps(result))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    if args.check:
        with open(args.check) as f:
            ref = json.load(f)
        bad = []
        if not result["quality_ok"]:
            bad.append(f"quality gate failed: {result['gaps']}")
        for k in ("macro_f1", "micro_f1", "lp_auc", "lp_mrr"):
            v, got = ref["trained"][k], result["trained"][k]
            if got < v - 0.08:       # quality must not regress (abs tol)
                bad.append(f"trained.{k}: expected >= {v - 0.08}, got {got}")
        if bad:
            print("UNC QUALITY GATE FAILED: " + "; ".join(bad))
            sys.exit(1)
        print("unc quality gate OK")
    return result


if __name__ == "__main__":
    main()
