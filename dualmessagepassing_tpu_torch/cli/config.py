"""CLI flag system for the SCM workload (a copy of
dualmessagepassing_tpu/cli/config.py: the same three argument groups,
flag for flag and default for default, and --device).

Reference: SubgraphCountingMatching/config.py:8-786.
Flag names match the reference so commands translate directly; values land
in a flat dict (the reference's config dict), and `process_model_config`
(train.py:38-65) derives model-facing sizes (reversed-edge doubling, dual
size formulas) before ModelConfig construction.

--device picks the torch device (default cuda); --gpu_id N >= 0 picks
cuda:N, and -1 the current CUDA device, never the CPU (the reference's
command lines pass --gpu_id 0): the CPU only with --device cpu.
--dp_devices N > 1 trains on N ranks (cli/scm_train.py).
"""

from __future__ import annotations

import argparse
import math
from copy import deepcopy
from typing import Any, Dict

import torch

from ..utils.io import str2bool, str2list, str2value


def add_model_config(parser):
    g = parser.add_argument_group("model")
    g.add_argument("--rep_net", type=str, default="DMPNN",
                   choices=["CNN", "RNN", "TXL", "RGCN", "RGIN", "CompGCN",
                            "DMPNN", "LRP", "DMPLRP"])
    g.add_argument("--hid_dim", type=int, default=64)
    g.add_argument("--rep_num_pattern_layers", type=int, default=3)
    g.add_argument("--rep_num_graph_layers", type=int, default=3)
    g.add_argument("--rep_residual", type=str2bool, default=True)
    g.add_argument("--rep_dropout", type=float, default=0.0)
    # recompute each DMP layer in the backward (memory <-> recompute)
    g.add_argument("--rep_remat", type=str2bool, default=False)
    # bf16 forward/backward with f32 master params (utils/amp.py)
    g.add_argument("--amp", type=str2bool, default=False)
    g.add_argument("--rep_act_func", type=str, default="leaky_relu")
    g.add_argument("--share_rep_net", type=str2bool, default=True)
    g.add_argument("--share_emb_net", type=str2bool, default=True)
    g.add_argument("--share_enc_net", type=str2bool, default=True)
    g.add_argument("--enc_net", type=str, default="Multihot",
                   choices=["Multihot", "Position"])
    g.add_argument("--enc_base", type=int, default=2)
    g.add_argument("--emb_net", type=str, default="Equivariant",
                   choices=["Orthogonal", "Uniform", "Normal", "Equivariant"])
    g.add_argument("--filter_net", type=str, default="ScalarFilter",
                   choices=["None", "ScalarFilter"])
    # arch-specific
    g.add_argument("--rep_dmpnn_num_mlp_layers", type=int, default=2)
    g.add_argument("--rep_dmpnn_batch_norm", type=str2bool, default=False)
    g.add_argument("--rep_compgcn_comp_opt", type=str, default="corr")
    g.add_argument("--rep_compgcn_edge_norm", type=str, default="none")
    g.add_argument("--rep_compgcn_batch_norm", type=str2bool, default=False)
    g.add_argument("--rep_rgcn_regularizer", type=str, default="bdd")
    g.add_argument("--rep_rgcn_num_bases", type=int, default=4)
    g.add_argument("--rep_rgcn_edge_norm", type=str, default="in")
    g.add_argument("--rep_rgcn_batch_norm", type=str2bool, default=False)
    g.add_argument("--rep_rgin_regularizer", type=str, default="bdd")
    g.add_argument("--rep_rgin_num_bases", type=int, default=4)
    g.add_argument("--rep_rgin_num_mlp_layers", type=int, default=2)
    g.add_argument("--rep_rgin_batch_norm", type=str2bool, default=False)
    g.add_argument("--rep_cnn_batch_norm", type=str2bool, default=True)
    g.add_argument("--rep_cnn_kernel_sizes", type=str2list, default=[2])
    g.add_argument("--rep_cnn_paddings", type=str2list, default=[-1])
    g.add_argument("--rep_cnn_strides", type=str2list, default=[1])
    g.add_argument("--rep_rnn_type", type=str, default="LSTM")
    g.add_argument("--rep_rnn_bidirectional", type=str2bool, default=False)
    g.add_argument("--rep_rnn_layer_norm", type=str2bool, default=False)
    g.add_argument("--rep_txl_num_heads", type=int, default=4)
    # dead flags in the reference too (config.py:63,284: parsed, never
    # consumed — TXL heads come from --rep_txl_num_heads); accepted so
    # reference commands parse verbatim
    g.add_argument("--rep_txl_layer_norm", type=str2bool, default=True,
                   help="accepted for reference-command compatibility "
                        "(unused in the reference as well)")
    g.add_argument("--rep_num_heads", type=int, default=4,
                   help="accepted for reference-command compatibility "
                        "(unused in the reference as well)")
    g.add_argument("--rep_txl_seg_len", type=int, default=64)
    g.add_argument("--rep_txl_mem_len", type=int, default=64)
    g.add_argument("--rep_txl_clamp_len", type=int, default=-1)
    g.add_argument("--rep_txl_pre_norm", type=str2bool, default=True)
    g.add_argument("--lrp_seq_len", type=int, default=4)
    g.add_argument("--rep_lrp_batch_norm", type=str2bool, default=False)
    g.add_argument("--gnn_add_node_id", type=str2bool, default=False)
    g.add_argument("--gnn_add_edge_id", type=str2bool, default=False)
    g.add_argument("--node_pred", type=str2bool, default=True)
    g.add_argument("--edge_pred", type=str2bool, default=True)
    # prediction
    g.add_argument("--pred_net", type=str, default="SumPredictNet")
    g.add_argument("--pred_hid_dim", type=int, default=64)
    g.add_argument("--pred_act_func", type=str, default="relu")
    g.add_argument("--pred_dropout", type=float, default=0.0)
    g.add_argument("--pred_with_enc", type=str2bool, default=False)
    g.add_argument("--pred_with_deg", type=str2bool, default=False)
    g.add_argument("--pred_infer_steps", type=int, default=1)
    g.add_argument("--pred_num_heads", type=int, default=4)
    g.add_argument("--pred_mem_len", type=int, default=4)
    g.add_argument("--pred_mem_init", type=str, default="mean")


def add_data_config(parser):
    g = parser.add_argument_group("data")
    g.add_argument("--pattern_dir", type=str, default="")
    g.add_argument("--graph_dir", type=str, default="")
    g.add_argument("--metadata_dir", type=str, default="")
    g.add_argument("--save_data_dir", type=str, default="")
    g.add_argument("--save_model_dir", type=str, default="dumps/model")
    g.add_argument("--load_model_dir", type=str, default="")
    g.add_argument("--synthetic", type=str2bool, default=False,
                   help="generate an in-repo synthetic ER dataset instead "
                        "of loading GML data")
    g.add_argument("--synthetic_pairs", type=int, default=256)
    g.add_argument("--max_npv", type=int, default=4)
    g.add_argument("--max_npvl", type=int, default=8)
    g.add_argument("--max_npe", type=int, default=10)
    g.add_argument("--max_npel", type=int, default=8)
    g.add_argument("--max_ngv", type=int, default=64)
    g.add_argument("--max_ngvl", type=int, default=16)
    g.add_argument("--max_nge", type=int, default=256)
    g.add_argument("--max_ngel", type=int, default=16)
    g.add_argument("--add_rev", type=str2bool, default=True)
    g.add_argument("--convert_dual", type=str2bool, default=False)
    g.add_argument("--remove_loops", type=str2bool, default=False)
    g.add_argument("--auto_envelope", type=str2bool, default=False,
                   help="shrink batch padding to power-of-two envelopes "
                        "(pairs with bucket batching)")


def add_train_config(parser):
    g = parser.add_argument_group("train")
    g.add_argument("--gpu_id", type=int, default=-1,
                   help="with --device cuda: the card's index (-1: the "
                        "current CUDA device, never the CPU)")
    g.add_argument("--device", type=str, default="cuda",
                   help="torch device to train on: cuda, cuda:N or cpu")
    g.add_argument("--seed", type=int, default=0)
    g.add_argument("--train_epochs", type=int, default=100)
    g.add_argument("--train_batch_size", type=int, default=64)
    g.add_argument("--eval_batch_size", type=int, default=64)
    g.add_argument("--train_ratio", type=float, default=1.0)
    g.add_argument("--train_grad_steps", type=int, default=1)
    # the batch as N equal microbatches, one update (the same gradient;
    # train/scm_driver.make_train_step accum_chunks). Batch size must be
    # divisible by it. 0 (default) = ~128-pair chunks picked from the
    # batch size; 1 = never chunk.
    g.add_argument("--train_microbatch_chunks", type=int, default=0)
    # data parallelism over N ranks, one a device (cli/scm_train.py)
    g.add_argument("--dp_devices", type=int, default=1)
    g.add_argument("--lr", type=float, default=1e-3)
    g.add_argument("--weight_decay", type=float, default=1e-5)
    g.add_argument("--max_grad_norm", type=float, default=8.0)
    g.add_argument("--scheduler", type=str,
                   default="cosine_with_warmup_and_restart")
    g.add_argument("--early_stop_rounds", type=int, default=10)
    g.add_argument("--bp_loss", type=str, default="MSE",
                   choices=["MAE", "MSE", "SMSE"])
    g.add_argument("--eval_metric", type=str, default="MAE",
                   choices=["MAE", "MSE", "SMSE", "AUC"])
    g.add_argument("--neg_pred_slp", type=str2value,
                   default="anneal_cosine$1.0$0.01")
    g.add_argument("--match_weights", type=str, default="none",
                   help="none|node|edge|node,edge — matching supervision")
    g.add_argument("--match_loss_w", type=str2value, default=0.1)
    g.add_argument("--match_reg_w", type=str2value, default=0.0001)
    g.add_argument("--rep_reg_w", type=str2value, default=0.0001)
    g.add_argument("--curriculum_warmup_epochs", type=int, default=-1)
    g.add_argument("--train_log_steps", type=int, default=-1,
                   help="in-epoch logging period in steps (reference "
                        "train.py:726); <=0 keeps the driver default")
    g.add_argument("--num_workers", type=int, default=1,
                   help="accepted for reference-command compatibility; "
                        "the host pipeline is vectorized numpy + C++ "
                        "kernels (no DataLoader worker pool to size)")
    g.add_argument("--profile_dir", type=str, default="",
                   help="write a torch.profiler trace of the first epoch "
                        "here")


def get_train_config(argv=None) -> Dict[str, Any]:
    parser = argparse.ArgumentParser("scm-train")
    add_model_config(parser)
    add_data_config(parser)
    add_train_config(parser)
    args = parser.parse_args(argv)
    cfg = vars(args)
    cfg["base"] = cfg.pop("enc_base")
    if cfg.get("train_log_steps", -1) > 0:
        cfg["log_every"] = cfg["train_log_steps"]
    return cfg


def process_model_config(config: Dict[str, Any]) -> Dict[str, Any]:
    """Reversed-edge doubling + dual size formulas (train.py:38-65)."""
    mc = deepcopy(config)
    if config.get("add_rev"):
        mc["max_nge"] *= 2
        mc["max_ngel"] *= 2
        mc["max_npe"] *= 2
        mc["max_npel"] *= 2
    if config.get("convert_dual"):
        max_ngv, max_npv = mc["max_ngv"], mc["max_npv"]
        avg_gd = math.ceil(mc["max_nge"] / mc["max_ngv"])
        avg_pd = math.ceil(mc["max_npe"] / mc["max_npv"])
        mc["max_ngv"] = mc["max_nge"]
        mc["max_nge"] = (avg_gd * avg_gd) * max_ngv // 2 - max_ngv
        mc["max_npv"] = mc["max_npe"]
        mc["max_npe"] = (avg_pd * avg_pd) * max_npv // 2 - max_npv
        mc["max_ngvl"], mc["max_ngel"] = mc["max_ngel"], mc["max_ngvl"]
        mc["max_npvl"], mc["max_npel"] = mc["max_npel"], mc["max_npvl"]
    return mc


def train_device(config: Dict[str, Any]) -> torch.device:
    """The device config["device"] and config["gpu_id"] pick: cuda (the
    default) is cuda:gpu_id, or the current CUDA device for gpu_id -1,
    and raises when there is no CUDA device; the CPU only when asked."""
    dev = torch.device(config.get("device", "cuda"))
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass --device cpu to run on the "
                           "CPU")
    if dev.index is None:
        gpu = config.get("gpu_id", -1)
        dev = torch.device("cuda", gpu if gpu >= 0
                           else torch.cuda.current_device())
    return dev


def to_model_config(config: Dict[str, Any]):
    """Project the flat CLI dict onto ModelConfig fields."""
    import dataclasses

    from ..models.basemodel import ModelConfig

    fields = {f.name for f in dataclasses.fields(ModelConfig)}
    kw = {k: v for k, v in config.items() if k in fields}
    kw["pred_return_weights"] = config.get("match_weights", "none")
    for key in ("rep_cnn_kernel_sizes", "rep_cnn_paddings",
                "rep_cnn_strides"):
        if key in kw and isinstance(kw[key], list):
            kw[key] = tuple(kw[key])
    return ModelConfig(**kw)
