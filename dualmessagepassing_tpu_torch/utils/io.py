"""Data/config IO: GML parsing (no igraph), metadata CSVs, splits, configs
(a copy of dualmessagepassing_tpu/utils/io.py).

Reference: SubgraphCountingMatching/utils/io.py:43-292.
igraph is not available in this environment, so `.gml` files are parsed with
a small tokenizer (the datasets use plain igraph-written GML: graph [ node
[ id/label ] edge [ source/target/label/key ] ]).  Semantics preserved:

  * `load_data(pattern_dir, graph_dir, metadata_dir)` -> {train, dev, test}
    lists of {id, pattern, graph, counts, subisomorphisms} records, with
    splits from train/dev/test.txt or g_idx % 10 (% 3 for shared-graph sets)
    (io.py:145-220). Graph records are converted to our padded host format
    lazily by the dataset layer.
  * config save/load as JSON; str2bool/str2list/str2value CLI helpers;
    save_results with an encoder for numpy arrays and torch tensors.
"""

from __future__ import annotations

import ast
import csv
import json
import os
import re
from collections import OrderedDict
from typing import Any, Dict, List

import numpy as np


# =============================================================================
# GML
# =============================================================================

_TOKEN = re.compile(r'"[^"]*"|\[|\]|[^\s\[\]]+')


def parse_gml(text: str) -> Dict[str, Any]:
    """Parse a GML document into nested dicts (lists for repeated keys)."""
    tokens = _TOKEN.findall(text)
    pos = 0

    def value(tok):
        if tok.startswith('"'):
            return tok[1:-1]
        try:
            return int(tok)
        except ValueError:
            try:
                return float(tok)
            except ValueError:
                return tok

    def parse_block():
        nonlocal pos
        out: Dict[str, Any] = {}
        while pos < len(tokens):
            tok = tokens[pos]
            if tok == "]":
                pos += 1
                return out
            key = tok
            pos += 1
            if tokens[pos] == "[":
                pos += 1
                val = parse_block()
            else:
                val = value(tokens[pos])
                pos += 1
            if key in out:
                if not isinstance(out[key], list):
                    out[key] = [out[key]]
                out[key].append(val)
            else:
                out[key] = val
        return out

    doc = parse_block()
    return doc.get("graph", doc)


def read_gml_graph(path: str) -> Dict[str, np.ndarray]:
    """.gml -> raw host graph dict {num_nodes, senders, receivers,
    node_labels, edge_labels} (io.py:43-60 with int casts of id/label/key)."""
    g = parse_gml(open(path).read())
    nodes = g.get("node", [])
    edges = g.get("edge", [])
    if isinstance(nodes, dict):
        nodes = [nodes]
    if isinstance(edges, dict):
        edges = [edges]
    ids = [int(n["id"]) for n in nodes]
    order = {nid: i for i, nid in enumerate(sorted(ids))}
    node_labels = np.zeros(len(nodes), np.int64)
    for n in nodes:
        node_labels[order[int(n["id"])]] = int(n.get("label", 0))
    senders = np.asarray([order[int(e["source"])] for e in edges], np.int64)
    receivers = np.asarray([order[int(e["target"])] for e in edges], np.int64)
    edge_labels = np.asarray([int(e.get("label", 0)) for e in edges], np.int64)
    return {
        "num_nodes": len(nodes),
        "senders": senders,
        "receivers": receivers,
        "node_labels": node_labels,
        "edge_labels": edge_labels,
    }


# =============================================================================
# metadata + load_data
# =============================================================================

def read_metadata_csv(path: str) -> Dict[str, Dict[str, Any]]:
    """g_id -> {counts, subisomorphisms} (io.py:99-115)."""
    meta = {}
    with open(path, newline="") as f:
        reader = csv.reader(f)
        header = next(reader)
        gid = header.index("g_id")
        cnt = header.index("counts")
        iso = header.index("subisomorphisms")
        for row in reader:
            meta[row[gid]] = {
                "counts": int(row[cnt]),
                "subisomorphisms": np.asarray(
                    ast.literal_eval(row[iso]), dtype=np.int64),
            }
    return meta


def _gml_dir(dirpath: str) -> Dict[str, Dict]:
    out = {}
    for fn in sorted(os.listdir(dirpath)):
        full = os.path.join(dirpath, fn)
        if os.path.isdir(full):
            out[fn] = _gml_dir(full)
        elif fn.endswith(".gml"):
            out[os.path.splitext(fn)[0]] = read_gml_graph(full)
    return out


def load_data(pattern_dir: str, graph_dir: str, metadata_dir: str):
    """-> ({train, dev, test}: record lists, shared_graph) (io.py:145-220)."""
    patterns = _gml_dir(pattern_dir)
    # patterns are flat; lift out of any subdirectories (io.py:81-96)
    flat_patterns = {}
    for k, v in patterns.items():
        if isinstance(v, dict) and "senders" not in v:
            flat_patterns.update(v)
        else:
            flat_patterns[k] = v
    patterns = flat_patterns
    graphs = _gml_dir(graph_dir)
    # the reference merges up only a subdir named like the parent dir
    # ("graphs/graphs", io.py:75-78); per-pattern subdirs stay nested
    base = os.path.basename(os.path.normpath(graph_dir))
    if base in graphs and (base == "graphs" or "G_" not in base):
        graphs.update(graphs.pop(base))
    meta = {}
    for fn in sorted(os.listdir(metadata_dir)):
        if fn.endswith(".csv"):
            meta[os.path.splitext(fn)[0]] = read_metadata_csv(
                os.path.join(metadata_dir, fn))

    def read_split(name):
        p = os.path.join(metadata_dir, name)
        if os.path.exists(p):
            return set(int(x) for x in open(p))
        return None

    tri, dvi, tei = (read_split(n) for n in ("train.txt", "dev.txt",
                                             "test.txt"))

    splits = OrderedDict(train=[], dev=[], test=[])
    shared_graph = True

    def route(x, g_idx, mod):
        if tri is not None:
            if g_idx in tri:
                splits["train"].append(x)
        elif g_idx % mod > 1:
            splits["train"].append(x)
        if dvi is not None:
            if g_idx in dvi:
                splits["dev"].append(x)
        elif g_idx % mod == 0:
            splits["dev"].append(x)
        if tei is not None:
            if g_idx in tei:
                splits["test"].append(x)
        elif g_idx % mod == 1:
            splits["test"].append(x)

    for p, pattern in patterns.items():
        if p in graphs and isinstance(graphs[p], dict) and \
                not ("senders" in graphs[p]):
            shared_graph = False
            for g, graph in graphs[p].items():
                x = {"id": f"{p}-{g}", "pattern": pattern, "graph": graph,
                     "counts": meta[p][g]["counts"],
                     "subisomorphisms": meta[p][g]["subisomorphisms"]}
                route(x, int(g.rsplit("_", 1)[-1]), 10)
        else:
            for g, graph in graphs.items():
                if not isinstance(graph, dict) or "senders" not in graph:
                    continue
                x = {"id": f"{p}-{g}", "pattern": pattern, "graph": graph,
                     "counts": meta[p][g]["counts"],
                     "subisomorphisms": meta[p][g]["subisomorphisms"]}
                route(x, int(g.rsplit("_", 1)[-1]), 3)
    return splits, shared_graph


# =============================================================================
# config / results
# =============================================================================

def str2value(x: str):
    try:
        return ast.literal_eval(x)
    except (ValueError, SyntaxError):
        return x


def str2bool(x: str) -> bool:
    return x.lower() in ("true", "yes", "1")


def str2list(x: str) -> List:
    out = []
    for item in x.split(","):
        item = item.strip()
        if item in ("", "null"):
            continue
        out.append(str2value(item))
    return out


def load_config(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


def save_config(config: Dict, path: str):
    with open(path, "w") as f:
        json.dump(dict(config), f)


class TensorEncoder(json.JSONEncoder):
    """numpy scalars and arrays, and torch tensors (anything with
    tolist), as JSON numbers and lists."""

    def default(self, obj):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        if hasattr(obj, "tolist"):
            return obj.tolist()
        return super().default(obj)


def save_results(results: Dict, path: str):
    with open(path, "w") as f:
        json.dump(results, f, cls=TensorEncoder)
