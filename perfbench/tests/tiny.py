"""Cells of BENCHMARK.json at sizes a CPU test holds: the same loops,
references, counts and limits, with fewer nodes, links, pairs and rows
a batch (widths, depths and flags as published)."""

from __future__ import annotations

import copy
import dataclasses

from perfbench.core.manifest import resolve

TINY_ARGV = {"--graph-batch-size": "60", "--train_batch_size": "16",
             "--eval_batch_size": "16"}


def _argv(argv):
    out = list(argv)
    for i, a in enumerate(out[:-1]):
        if a in TINY_ARGV:
            out[i + 1] = TINY_ARGV[a]
    return out


def tiny_cell(workload: str):
    cell = resolve(workload)
    config = copy.deepcopy(cell.config)
    config["argv"] = _argv(config["argv"])
    if "data" in config:
        config["data"].update(num_nodes=300, num_links=1200)
    traffic = dict(cell.traffic)
    if "batches" in traffic:
        traffic.update(batches=4, sample_threads=2)
    if "pairs" in traffic:
        traffic.update(pairs=48)
    return dataclasses.replace(cell, config=config, traffic=traffic)
