"""The set-up the SCM loops share: the command line's config, the pairs
from the seed as the program's dataset, and the model with the
benchmark's weights, built as cli/scm_train.py builds it.

The pairs sit at the configuration's envelope (every pattern max_npv
nodes and max_npe edges, every graph max_ngv and max_nge), with labels
drawn from the configuration's label counts, Poisson counts and node
weights (traffic: count_mean, weight_mean); the dataset then adds the
reversed edges, as the command line's transform does.
"""

from __future__ import annotations

import numpy as np
import torch

from dualmessagepassing_tpu_torch.cli.config import (get_train_config,
                                                     process_model_config,
                                                     to_model_config)
from dualmessagepassing_tpu_torch.data.dataset import GraphAdjDataset
from dualmessagepassing_tpu_torch.graph import single_graph
from dualmessagepassing_tpu_torch.models.scm_models import build_model

from ..core.generators import scm_pairs
from ..core.weights import make_weights


def train_config(config: dict) -> dict:
    return get_train_config(list(config["argv"])
                            + list(config.get("extra_argv", [])))


def make_raw(cfg: dict, traffic: dict, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return scm_pairs(traffic["pairs"], cfg["max_npv"], cfg["max_npe"],
                     cfg["max_npvl"], cfg["max_npel"], cfg["max_ngv"],
                     cfg["max_nge"], cfg["max_ngvl"], cfg["max_ngel"],
                     traffic["count_mean"], traffic["weight_mean"], rng)


def make_dataset(raw: dict, cfg: dict) -> GraphAdjDataset:
    pv, gv = cfg["max_npv"], cfg["max_ngv"]
    records = []
    for i in range(len(raw["counts"])):
        records.append({
            "id": i,
            "pattern": single_graph(pv, raw["p_src"][i], raw["p_dst"][i],
                                    raw["p_vl"][i], raw["p_el"][i]),
            "graph": single_graph(gv, raw["g_src"][i], raw["g_dst"][i],
                                  raw["g_vl"][i], raw["g_el"][i]),
            "counts": float(raw["counts"][i]),
            "node_weights": raw["node_weights"][i],
            "edge_weights": None, "subisomorphisms": None})
    ds = GraphAdjDataset(records)
    if cfg["add_rev"]:
        ds.add_reversed_edges(cfg["max_npel"], cfg["max_ngel"])
    return ds


def make_model(ctx, cfg: dict):
    model = build_model(to_model_config(process_model_config(cfg)),
                        device=ctx.device)
    spec = ctx.cell.reference.param_spec(ctx.config)
    model.load_state_dict(make_weights(spec, ctx.seed, ctx.device),
                          strict=True)
    return model


class Sizes:
    """The real sizes of any batch of the dataset, as counts/ reads them."""

    def __init__(self, dataset, model):
        mc = model.cfg
        enc = mc.enc_dims("graph")
        self.fixed = {"hidden": mc.hid_dim, "pred_hidden": mc.pred_hid_dim,
                      "layers": mc.rep_num_graph_layers,
                      "enc_vl": enc["vl"], "enc_el": enc["el"]}
        self.rows = {
            f"{side}_{what}": np.asarray([int(x[key][f"n_{what[:-1]}"])
                                          for x in dataset.data])
            for side, key in (("p", "pattern"), ("g", "graph"))
            for what in ("nodes", "edges")}

    def __call__(self, indices) -> dict:
        idx = np.asarray(indices)
        out = {k: int(v[idx].sum()) for k, v in self.rows.items()}
        return out | self.fixed | {"batch": len(idx)}


class SpanData:
    """The dataset as train_epoch sees it: its collate inside a span, the
    rows of every batch kept in `seen`."""

    def __init__(self, dataset, ctx):
        self.dataset, self.ctx = dataset, ctx
        self.seen = []

    def sizes(self):
        return self.dataset.sizes()

    def batchify(self, indices, return_weights="none"):
        self.seen.append(indices)
        with self.ctx.span("collate"):
            return self.dataset.batchify(indices, return_weights)


def torch_generator(device, seed: int) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed % (2 ** 63))
