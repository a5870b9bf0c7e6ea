"""UNC downstream evaluation: LinearSVC node classification and link
prediction (dualmessagepassing_tpu/unc/evaluate.py:1-369), without
scikit-learn.

Reference: UnsupervisedNodeClassification/Evaluate/
(node_classification.py, link_prediction.py, utils.py). Host code in both
packages (SURVEY §2.3): it takes no torch device. The JAX package calls
scikit-learn; the machine with the H100 has none, so this module carries
numpy copies of what it calls, equal to scikit-learn 1.9's on the same
inputs (tests/test_torch_unc_evaluate.py):
  * KFold and StratifiedKFold with shuffle=True (model_selection/
    _split.py: _iter_test_indices, _make_test_folds), index for index;
  * f1_score (macro, micro, binary) and roc_auc_score (binary labels);
  * LinearSVC, LIBLINEAR's solvers in C++ (unc/linear_svc.py).

Protocols:
  * unsupervised nc: merge label + label.test, 5-fold StratifiedKFold,
    LinearSVC with binary-search C, Macro/Micro-F1;
  * semi-supervised nc: train on label file, test on label.test;
  * link prediction: Hadamard edge features, 5-fold KFold over seed nodes,
    AUC + per-node MRR;
  * multi-label nc (the Yelp protocol), semi- and unsupervised.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterator, Tuple

import numpy as np

from .linear_svc import LinearSVC

seed = 1
max_iter = 300


# =============================================================================
# scikit-learn's folds and metrics, as numpy
# =============================================================================

class KFold:
    """sklearn.model_selection.KFold(n_splits, shuffle=True,
    random_state): the test folds are consecutive chunks of the indices
    shuffled by RandomState(random_state), the first n % k one longer;
    both index arrays of a split come out sorted."""

    def __init__(self, n_splits: int, random_state: int):
        self.n_splits = n_splits
        self.random_state = random_state

    def split(self, X) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        n = len(X)
        if self.n_splits > n:
            raise ValueError(f"Cannot have number of splits n_splits="
                             f"{self.n_splits} greater than the number of "
                             f"samples: n_samples={n}.")
        indices = np.arange(n)
        np.random.RandomState(self.random_state).shuffle(indices)
        sizes = np.full(self.n_splits, n // self.n_splits, dtype=int)
        sizes[: n % self.n_splits] += 1
        folds = np.zeros(n, dtype=int)
        current = 0
        for k, size in enumerate(sizes):
            folds[indices[current: current + size]] = k
            current += size
        yield from _split_by_folds(folds, self.n_splits)


class StratifiedKFold:
    """sklearn.model_selection.StratifiedKFold(n_splits, shuffle=True,
    random_state): classes numbered by first appearance, each fold's
    share of each class dealt round-robin over the sorted labels, each
    class's fold labels shuffled by one RandomState(random_state), class
    by class."""

    def __init__(self, n_splits: int, random_state: int):
        self.n_splits = n_splits
        self.random_state = random_state

    def _make_test_folds(self, y) -> np.ndarray:
        rng = np.random.RandomState(self.random_state)
        y = np.asarray(y).ravel()
        _, y_idx, y_inv = np.unique(y, return_index=True, return_inverse=True)
        _, class_perm = np.unique(y_idx, return_inverse=True)
        y_encoded = class_perm[y_inv]
        n_classes = len(y_idx)
        y_counts = np.bincount(y_encoded)
        if np.all(self.n_splits > y_counts):
            raise ValueError(f"n_splits={self.n_splits} cannot be greater "
                             "than the number of members in each class.")
        y_order = np.sort(y_encoded)
        allocation = np.asarray(
            [np.bincount(y_order[i:: self.n_splits], minlength=n_classes)
             for i in range(self.n_splits)])
        test_folds = np.empty(len(y), dtype="i")
        for k in range(n_classes):
            folds_for_class = np.arange(self.n_splits).repeat(allocation[:, k])
            rng.shuffle(folds_for_class)
            test_folds[y_encoded == k] = folds_for_class
        return test_folds

    def split(self, X, y) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        yield from _split_by_folds(self._make_test_folds(y), self.n_splits)


def _split_by_folds(folds: np.ndarray, n_splits: int):
    indices = np.arange(len(folds))
    for k in range(n_splits):
        test = folds == k
        yield indices[~test], indices[test]


def f1_score(y_true, y_pred, average: str = "binary") -> float:
    """sklearn.metrics.f1_score for label vectors: per label
    2 tp / (true + predicted), 0 where both are 0; "macro" the mean over
    the labels present in either vector, "micro" from the summed counts,
    "binary" label 1 of a binary problem."""
    y_true, y_pred = np.asarray(y_true).ravel(), np.asarray(y_pred).ravel()
    present = np.unique(np.concatenate([y_true, y_pred]))
    if average == "binary":
        if len(present) > 2:
            raise ValueError("Target is multiclass but average='binary'.")
        if 1 not in present.tolist() and len(present) >= 2:
            raise ValueError(f"pos_label=1 is not a valid label. It should "
                             f"be one of {present.tolist()}")
        labels = np.asarray([1])
    elif average in ("macro", "micro"):
        labels = present
    else:
        raise ValueError(f"average {average!r}")
    tp = np.asarray([np.sum((y_true == c) & (y_pred == c)) for c in labels])
    pred = np.asarray([np.sum(y_pred == c) for c in labels])
    true = np.asarray([np.sum(y_true == c) for c in labels])
    if average == "micro":
        tp, pred, true = tp.sum(keepdims=True), pred.sum(keepdims=True), \
            true.sum(keepdims=True)
    denom = true.astype(np.float64) + pred.astype(np.float64)
    f = np.divide(2.0 * tp, denom, out=np.zeros(len(tp)), where=denom != 0)
    return float(f.mean())


def roc_auc_score(y_true, y_score) -> float:
    """sklearn.metrics.roc_auc_score for binary y_true: the trapezoid
    area under the ROC curve over the distinct score thresholds (nan,
    as scikit-learn returns, where y_true holds one class)."""
    y_true = np.asarray(y_true).ravel()
    y_score = np.asarray(y_score).ravel()
    classes = np.unique(y_true)
    if len(classes) != 2:
        return float("nan")
    y_true = (y_true == classes[1]).astype(np.float64)
    order = np.argsort(y_score, kind="mergesort")[::-1]
    y_score, y_true = y_score[order], y_true[order]
    distinct = np.where(np.diff(y_score))[0]
    thresholds = np.r_[distinct, y_true.size - 1]
    tps = np.cumsum(y_true, dtype=np.float64)[thresholds]
    fps = 1 + thresholds - tps
    if len(fps) > 2:                 # drop collinear points, as sklearn
        keep = np.where(np.r_[True, np.logical_or(np.diff(fps, 2),
                                                  np.diff(tps, 2)), True])[0]
        tps, fps = tps[keep], fps[keep]
    tps, fps = np.r_[0, tps], np.r_[0, fps]
    fpr, tpr = fps / fps[-1], tps / tps[-1]
    return float(np.sum(np.diff(fpr) * (tpr[1:] + tpr[:-1]) / 2.0))


# =============================================================================
# single-label node classification and link prediction
# =============================================================================

def single_label_binary_search_cv(data, labels, multi_class="ovr") -> float:
    """Binary-search C tuner (Evaluate/utils.py:16-45)."""
    best_c = 1.0
    span = int(labels.max() - labels.min() + 1)
    c0 = 10.0 ** (-span)
    c1 = 1 / c0
    cnt = 0
    max_cnt = 2 * span - 1
    while cnt < max_cnt and abs(c0 - c1) > 1e-10:
        rng = np.random.RandomState(cnt)
        idx = rng.choice(len(data), size=(int(len(data) * (cnt + 1) / max_cnt),),
                         replace=False)
        cd, cl = data[idx], labels[idx]
        if len(np.unique(cl)) < 2:
            # degenerate subsample (possible on tiny datasets; the reference
            # assumes datasets large enough to never hit this)
            cnt += 1
            continue
        scores = []
        for c in (c0, c1):
            clf = LinearSVC(random_state=seed,
                            max_iter=int(100 * (cnt + 1) / max_cnt),
                            multi_class=multi_class, C=c)
            clf.fit(cd, cl)
            preds = clf.predict(cd)
            scores.append(f1_score(cl, preds, average="macro")
                          + f1_score(cl, preds, average="micro"))
        if scores[0] > scores[1]:
            best_c = c0
            c1 /= 10
        else:
            best_c = c1
            c0 *= 10
        cnt += 1
    return best_c


def _read_label_file(path) -> Tuple[list, list]:
    ids, labels = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            ids.append(parts[0])
            labels.append(parts[-1])
    return ids, labels


def load_emb_dict(path: str) -> Dict[str, np.ndarray]:
    """emb.dat -> {node id string: vector} (Evaluate/evaluate.py)."""
    emb = {}
    with open(path) as f:
        f.readline()  # args header
        for line in f:
            idx, vec = line.rstrip("\n").split("\t")
            emb[idx] = np.asarray(vec.split(" "), np.float32)
    return emb


def _single_label_cv(embs: np.ndarray, labels: np.ndarray):
    """5-fold StratifiedKFold LinearSVC -> (macro_f1, micro_f1)."""
    macro, micro = [], []
    skf = StratifiedKFold(n_splits=5, random_state=seed)
    for tr, te in skf.split(embs, labels):
        c = single_label_binary_search_cv(embs[tr], labels[tr])
        clf = LinearSVC(random_state=seed, max_iter=max_iter,
                        multi_class="ovr", C=c)
        clf.fit(embs[tr], labels[tr])
        preds = clf.predict(embs[te])
        macro.append(f1_score(labels[te], preds, average="macro"))
        micro.append(f1_score(labels[te], preds, average="micro"))
    return float(np.mean(macro)), float(np.mean(micro))


def unsupervised_single_label_nc(label_path, label_test_path, emb_dict):
    """5-fold CV on merged labels (node_classification.py:61-84)."""
    labels, embs = [], []
    for p in (label_path, label_test_path):
        ids, labs = _read_label_file(p)
        for i, l in zip(ids, labs):
            labels.append(int(l))
            embs.append(emb_dict[i])
    return _single_label_cv(np.asarray(embs), np.asarray(labels))


def nc_evaluate_arrays(embs: np.ndarray, node_ids: np.ndarray,
                       labels: np.ndarray):
    """Array-facing unsupervised nc protocol: same 5-fold LinearSVC CV as
    unsupervised_single_label_nc, for embeddings already in memory."""
    return _single_label_cv(np.asarray(embs)[np.asarray(node_ids)],
                            np.asarray(labels))


def semisupervised_single_label_nc(label_path, label_test_path, emb_dict):
    """Train/test split protocol (node_classification.py:33-59)."""

    def load(p):
        ids, labs = _read_label_file(p)
        return (np.asarray([int(l) for l in labs]),
                np.asarray([emb_dict[i] for i in ids]))

    trl, tre = load(label_path)
    tel, tee = load(label_test_path)
    c = single_label_binary_search_cv(tre, trl)
    clf = LinearSVC(random_state=seed, max_iter=max_iter, multi_class="ovr",
                    C=c)
    clf.fit(tre, trl)
    preds = clf.predict(tee)
    return (float(f1_score(tel, preds, average="macro")),
            float(f1_score(tel, preds, average="micro")))


def lp_evaluate(test_file_path, emb_dict):
    """Hadamard edge features + 5-fold CV -> (AUC, MRR)
    (link_prediction.py:53-88)."""
    posi, nega = defaultdict(set), defaultdict(set)
    with open(test_file_path) as f:
        for line in f:
            left, right, label = line.rstrip("\n").split("\t")
            (posi if label == "1" else nega)[left].add(right)

    edge_embs, edge_labels = defaultdict(list), defaultdict(list)
    for store, lab in ((posi, 1), (nega, 0)):
        for left, rights in store.items():
            for right in rights:
                edge_embs[left].append(emb_dict[left] * emb_dict[right])
                edge_labels[left].append(lab)
    for n in edge_embs:
        edge_embs[n] = np.asarray(edge_embs[n])
        edge_labels[n] = np.asarray(edge_labels[n])

    seed_nodes = np.asarray(list(edge_embs.keys()))
    auc, mrr = [], []
    kf = KFold(n_splits=5, random_state=seed)
    for tr, te in kf.split(np.zeros((len(seed_nodes), 1))):
        tr_embs = np.concatenate([edge_embs[n] for n in seed_nodes[tr]])
        tr_labs = np.concatenate([edge_labels[n] for n in seed_nodes[tr]])
        te_embs = np.concatenate([edge_embs[n] for n in seed_nodes[te]])
        te_labs = np.concatenate([edge_labels[n] for n in seed_nodes[te]])
        c = single_label_binary_search_cv(tr_embs, tr_labs)
        clf = LinearSVC(random_state=seed, max_iter=max_iter,
                        multi_class="ovr", C=c)
        clf.fit(tr_embs, tr_labs)
        auc.append(roc_auc_score(te_labs, clf.predict(te_embs)))
        conf = clf.decision_function(te_embs)
        curr, off = [], 0
        for i in te:
            n = seed_nodes[i]
            k = len(edge_labels[n])
            order = np.argsort(-conf[off: off + k])
            rank = np.empty_like(order)
            rank[order] = np.arange(k)
            pos = np.argwhere(edge_labels[n] == 1).flatten()
            if len(pos):  # nodes with no positive test edge carry no MRR term
                curr.append(1.0 / (1 + rank[pos].min()))
            off += k
        mrr.append(np.mean(curr))
    return float(np.mean(auc)), float(np.mean(mrr))


# =============================================================================
# multi-label node classification (Yelp protocol)
# =============================================================================

def _read_multilabel_file(path):
    """Rows are ``index \\t _ \\t nclass \\t labels`` with comma-separated
    labels; each distinct (nclass, label) pair is one binary class
    (node_classification.py:87-131)."""
    ids, pairs = [], []
    with open(path) as f:
        for line in f:
            parts = line.strip().split("\t")
            ids.append(parts[0])
            pairs.append([(parts[2], l) for l in parts[3].split(",")])
    return ids, pairs


def _binary_label_matrix(pairs, label_dict=None):
    """[(nclass, label), ...] per node -> [num_classes, num_nodes] bool.
    Pass a shared ``label_dict`` when two files must agree on class
    indices (the reference builds them per file by first appearance,
    node_classification.py:103-129, and can misalign them; keyed here)."""
    if label_dict is None:
        label_dict = {}
    for node_pairs in pairs:
        for p in node_pairs:
            if p not in label_dict:
                label_dict[p] = len(label_dict)
    mat = np.zeros((len(label_dict), len(pairs)), bool)
    for i, node_pairs in enumerate(pairs):
        for p in node_pairs:
            mat[label_dict[p], i] = True
    return mat


def multi_label_binary_search_cv(data, binary_labels) -> float:
    """C tuner scoring per-class binary-F1 macro+micro on growing
    subsamples (Evaluate/utils.py:48-89)."""
    best_c = 1.0
    n_cls = len(binary_labels)
    c0 = 10.0 ** (-n_cls)
    c1 = 1 / c0
    cnt = 0
    max_cnt = 2 * n_cls - 1
    while cnt < max_cnt and abs(c0 - c1) > 1e-10:
        rng = np.random.RandomState(cnt)
        idx = rng.choice(len(data), size=(int(len(data) * (cnt + 1) / max_cnt),),
                         replace=False)
        cd, cl = data[idx], binary_labels[:, idx]
        totals = []
        for c in (c0, c1):
            scores, weights = [], []
            for nlabels in cl:
                if len(np.unique(nlabels)) < 2:
                    continue  # degenerate subsample guard (as in single-label)
                clf = LinearSVC(random_state=seed,
                                max_iter=int(100 * (cnt + 1) / max_cnt),
                                multi_class="crammer_singer", C=c)
                clf.fit(cd, nlabels)
                preds = clf.predict(cd)
                scores.append(f1_score(nlabels, preds, average="binary"))
                weights.append(nlabels.sum())
            if not scores:
                totals.append(0.0)
                continue
            scores = np.asarray(scores, np.float64)
            weights = np.asarray(weights, np.float64)
            totals.append(scores.mean() + (scores * weights).sum() / weights.sum())
        if totals[0] > totals[1]:
            best_c = c0
            c1 /= 10
        else:
            best_c = c1
            c0 *= 10
        cnt += 1
    return best_c


def semisupervised_multi_label_nc(label_path, label_test_path, emb_dict):
    """Per-class one-vs-rest LinearSVC, train on label file, test on
    label.test; macro = mean of binary F1s, micro = support-weighted
    (node_classification.py:87-145)."""
    tr_ids, tr_pairs = _read_multilabel_file(label_path)
    te_ids, te_pairs = _read_multilabel_file(label_test_path)
    tr_embs = np.asarray([emb_dict[i] for i in tr_ids])
    te_embs = np.asarray([emb_dict[i] for i in te_ids])
    label_dict = {}
    tr_mat = _binary_label_matrix(tr_pairs, label_dict)
    te_mat = _binary_label_matrix(te_pairs, label_dict)
    # classes absent from one side get zero rows so indices stay aligned
    n_cls = len(label_dict)
    if len(tr_mat) < n_cls:
        tr_mat = np.vstack([tr_mat, np.zeros(
            (n_cls - len(tr_mat), tr_mat.shape[1]), bool)])
    if len(te_mat) < n_cls:
        te_mat = np.vstack([te_mat, np.zeros(
            (n_cls - len(te_mat), te_mat.shape[1]), bool)])
    scores, weights = [], []
    for tr_label, te_label in zip(tr_mat, te_mat):
        if not tr_label.any() or not te_label.any():
            continue  # class unseen on one side: no trainable/testable signal
        c = multi_label_binary_search_cv(tr_embs, tr_label[None, :])
        clf = LinearSVC(random_state=seed, max_iter=max_iter,
                        multi_class="crammer_singer", C=c)
        clf.fit(tr_embs, tr_label)
        preds = clf.predict(te_embs)
        scores.append(f1_score(te_label, preds, average="binary"))
        weights.append(te_label.sum())
    scores = np.asarray(scores, np.float64)
    weights = np.asarray(weights, np.float64)
    return float(scores.mean()), float((scores * weights).sum() / weights.sum())


def unsupervised_multi_label_nc(label_path, label_test_path, emb_dict):
    """Merged-file 5-fold protocol; Cs are tuned once per fold on the most
    frequent class then shared across classes
    (node_classification.py:147-196, whose fold loop cannot run as
    written; the JAX package's repair is kept)."""
    ids, pairs = [], []
    for p in (label_path, label_test_path):
        i, pr = _read_multilabel_file(p)
        ids += i
        pairs += pr
    embs = np.asarray([emb_dict[i] for i in ids])
    mat = _binary_label_matrix(pairs)

    anchor = mat[mat.sum(axis=1).argmax()].astype(np.int32)
    cs = []
    skf = StratifiedKFold(n_splits=5, random_state=seed)
    for tr, _te in skf.split(embs, anchor):
        cs.append(multi_label_binary_search_cv(embs[tr], mat[:, tr]))

    scores, weights = [], []
    for binary_label in mat:
        fold_scores = []
        skf = StratifiedKFold(n_splits=5, random_state=seed)
        for nsplit, (tr, te) in enumerate(skf.split(embs, binary_label)):
            clf = LinearSVC(random_state=seed, max_iter=max_iter,
                            multi_class="crammer_singer", C=cs[nsplit])
            clf.fit(embs[tr], binary_label[tr])
            preds = clf.predict(embs[te])
            fold_scores.append(f1_score(binary_label[te], preds,
                                        average="binary"))
        scores.append(np.mean(fold_scores))
        weights.append(binary_label.sum())
    scores = np.asarray(scores, np.float64)
    weights = np.asarray(weights, np.float64)
    return float(scores.mean()), float((scores * weights).sum() / weights.sum())


def nc_evaluate(label_path, label_test_path, emb_dict,
                supervised: bool = False, multi: bool = False):
    """Dispatcher mirroring node_classification.py:18-29 (the reference
    keys multi-label on dataset == Yelp; here it is an explicit flag)."""
    if multi:
        fn = (semisupervised_multi_label_nc if supervised
              else unsupervised_multi_label_nc)
    else:
        fn = (semisupervised_single_label_nc if supervised
              else unsupervised_single_label_nc)
    return fn(label_path, label_test_path, emb_dict)
