#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): UNC training
and embedding export, the kernel bench, and SCM subgraph counting and
matching with DMPNN, the other graph networks, the sequence networks,
the attention and the memory predict nets, and scale-out over
torch.distributed (data parallel, edge-partitioned and owner-sharded
halo training, the north-star gate, the demonstration layer, the halo
library and its benches, the dry run), the helpers off every model
path and the examples, with the port's four CUDA kernels built from
this checkout.

    python3 chip_smoke.py          # from the root of the checkout

Phases (any failure raises and the script exits non-zero):
  0 device   require CUDA; print nvidia-smi's name and power limit, the
             torch and CUDA versions;
  1 build    nvcc-build the two kernel libraries at once and g++-build
             the host sampler; print the seconds each took;
  2 kernels  each kernel against its plain PyTorch version on the card:
             K1/K2 in f32 and bf16, widths 1/3/50/101/128/129, a hub row
             of 5,000 edges, empty rows, a pad tail, K2 bitwise also with
             its table and output at misaligned storage offsets
             (K2_OFFSETS), K1 twice with the same bits; K1 with a hub of
             100,000 edges, V = 1, no edges, and through a row index
             (rows=) bitwise equal to the permuted copy; K3 and K4 at the
             kernel bench's four sizes, and their plain versions timed at
             the largest; the three autograd Functions' gradients at the
             training path's shapes against the same Functions on the CPU
             (plain versions). Then K1 (W = 50, 101) and K2 (W = 101, 50),
             their plain versions and (K2) one index_select timed at the
             path's shapes, f32 and bf16: CUDA events around the call and
             the device time torch.profiler records
             (kernel_bench.time_call);
  3 model    one sampled PubMed-scale batch through the model on the card
             and on the CPU (plain kernel versions), f32 and amp bf16;
  4 serving  export_embeddings in amp bf16 at the unc_infer envelope
             (V=65,536, E=524,288, R=3); the forward launch counts must
             rise by n_layers per forward;
  5 training one PubMed-scale training batch: the loss and every
             parameter gradient on the card against the CPU, f32 and amp
             bf16; K1 at the three shapes it has in a train step, on that
             batch's own plans (the plans' row lengths; receiver plan H = 50
             and W = 101, sender plan W = 101 through sk2_order, and the
             index_select + K1 it replaces), f32 and bf16, beside its plain
             version, one index_add_ and its HBM bound; a torch.profiler
             trace of three train steps (top device
             operations); then train_unc at the run.sh configuration with
             n_epochs=1 (rescaled to 4 epochs of 25 steps, unless the loss
             rises first) and its f32 export of 7 requests. One line per
             epoch: loss, host sampling ms, step ms (CUDA events), device
             busy and idle share. Per step K1 must launch 2 forward and 4
             backward times and K2 2 and 2; per export request each 2;
  6 bench    the port's kernel bench (bench/kernel_bench.py) at 20
             iterations, one JSON line per variant with its event and
             device times; K3 and K4 launched;
  7 backbones CompGCN, R-GCN and R-GIN at the run.sh width (dropout 0):
             one PubMed-scale training batch, the loss and every parameter
             gradient on the card against the CPU (phase 5's bounds), f32
             and amp bf16; the K1/K2 launches of one train step against
             BACKBONE_STEP_LAUNCHES; an f32 step's CUDA-event ms and
             torch.profiler device ms with K1's and K2's shares; then
             train_unc on the first BACKBONE_LINKS links (n_epochs=1
             rescales to 2 epochs of 10 steps) and its export of 3
             requests, launches counted from zero;
  8 attributed DMPNN with a frozen ATTR_WIDTH-wide attribute table made
             from the seed: loss and gradients on the card against the
             CPU, f32 and amp bf16, and one step's launches;
  9 supervised train_unc_supervised (DMPNN, label_batch_size 512),
             single-label (SUP_CLASSES classes) and multi-label, on
             synthetic labels of SUP_LABELED nodes: the loss and
             gradients of one batch on the card against the CPU (f32),
             then SUP_LINKS links for one epoch of 3 steps, launches
             counted from zero;
 10 evaluate nc_evaluate_arrays on phase 5's exported embeddings with
             phase 9's synthetic single-label labels (the first
             EVAL_NODES labeled nodes, SUP_CLASSES classes) and
             lp_evaluate on a synthetic link.dat.test (LP_SEEDS seed
             nodes, one true link and LP_NEG random ones each): Macro/
             Micro-F1, AUC, MRR and seconds, each in [0, 1] — host code,
             the port's LinearSVC (g++-built LIBLINEAR solvers);
 11 SCM      the flagship DMPNN of subgraph counting and matching
             (__graft_entry__.py:_flagship_config: pattern <= 8 V / 8 E,
             graph <= 64 V / 256 E, 16 labels, reversed edges, hid 64, 3
             layers, ScalarFilter, SumPredictNet, nodeedge), batches drawn
             as __graft_entry__.py:_make_batch draws them: K3 against its
             plain version at the train step's shapes (V = 8,192, E =
             65,536, H = 64 and 128, f32 and bf16), timed beside its plain
             version, one index_add_ and its bound; one bsz-128 batch's
             pred_c/pred_v/pred_e, loss and every gradient on the card
             against the CPU, f32 and amp bf16, with K3's launches against
             models/scm_models.k3_launches; the train step at bsz 128 and
             the eval step at bsz 512 (bench.py:116,621; the bsz-2,048
             step left the run for phase 18's time), CUDA-
             event and torch.profiler device ms, K3's share, pairs/s and
             edges/s; then the user's path counted from zero:
             generate_dataset (an ER set at the scm_er_counting sizes),
             BucketSampler, train_epoch for SCM_LEARN["epochs"] epochs at
             scm_train's default learning-rate schedule and
             evaluate_epoch — the loss finite and falling, MAE/MNED/MEED
             printed, K3's launches equal to the derived count;
 12 SCM CLI  the reference's Erdos-Renyi command line at its published
             widths (SCM_CLI_ER: hid 64, Multihot base 2, Equivariant,
             DMPNN 3 + 3 layers, SumPredictNet, --match_weights node,
             reversed edges, bsz 64) through cli/scm_train.main on the
             card, on a synthetic ER set of SCM_CLI_PAIRS pairs (--synthetic
             True) for SCM_CLI_EPOCHS epochs; a finetune of that run onto
             a 2-label vertex vocabulary (--load_model_dir, expand_params)
             and a --convert_dual True run, one epoch each; then
             cli/scm_evaluate.main on the first run. Each run's files
             (log.txt, config.json, the results JSONs, epoch{N}/), K3's
             launches counted from zero around each run against the count
             derived from models/scm_models.k3_launches and the CLI's
             samplers, seconds per epoch, train and eval pairs/s, and
             scm_evaluate's best-epoch dev metrics against the training
             run's within SCM_EVAL_REL (AUC SCM_EVAL_AUC);
 13 gates    the learning gates at their smoke sizes on the card:
             gates/unc_convergence.run("smoke") under the assertions of
             tests/test_unc_quality.py:31-42 (K1 and K2 launched each
             way), and gates/scm_convergence.run at SCM_GATE (the ER run of
             tests/test_scm_matching_quality.py:65-80) with K3's launches
             against the derived count and its matching_learned block,
             then at the other SCM_GATE_SEEDS: that test's limits
             (SCM_GATE_LIMITS) on the dev ratios' mean over the seeds,
             each seed's ratios and verdict printed;
 14 SCM nets the other graph networks of the paper's SCM tables, CompGCN,
             R-GCN, R-GIN, LRP and DMPLRP, at the flagship's
             configuration with the rep net swapped (R-GCN/R-GIN: R = 32
             relations): K3 against its plain version at its two new
             call shapes (the relation fold, 65,536 edge rows into
             262,144 rows; the LRP pool, the perm rows into 8,192), timed
             beside its plain version, one index_add_ and its bound; per
             network a bsz-16 batch on the card against the CPU (the
             outputs, the loss and every gradient, f32 and amp bf16, phase
             11's bounds, K3's launches against k3_launches), the train
             step at bsz 128 and the eval forward at 512 (events, device
             ms and K3's share but for UNPROFILED_NETS, peak device
             memory, LRP's perm envelope p_max), and the reference's ER
             command line with its
             --rep_net for one epoch on phase 12's data, then
             cli/scm_evaluate and a finetune onto a 2-label vertex
             vocabulary, K3's launches counted from zero against the
             derived count;
 15 SCM seq  the sequence networks of the paper's SCM tables, CNN (k 2:
             the graph's 512 tuples become 518), RNN (LSTM) and TXL
             (seg_len 64, mem_len 64, 4 heads: 8 segments), at the
             flagship's configuration with the rep net swapped: per
             network a bsz-16 batch on the card against the CPU (phase
             14's checks; CNN's edge-weight targets refined to 518), the
             train step at bsz 128 and the eval forward at 512 (events,
             device ms but for TXL (UNPROFILED_NETS), peak memory),
             pred_with_deg at bsz 128 (K3's
             degree tables, the only K3 launches of these networks: the
             tables, the forward and every gradient on the card against
             the CPU in f32, and one train step's launches, 4 per chunk,
             against k3_launches), the reference's ER
             command line with its --rep_net for one epoch on phase 12's
             data, cli/scm_evaluate and a finetune onto a 2-label vertex
             vocabulary (no K3 launch derived, none made); and a
             bidirectional GRU at the same size, card against CPU once.
             Before them, K3 against its plain version at the degree
             tables' shape (65,536 tuple rows of one column into 8,192
             node rows), timed beside it, one index_add_ and its bound;
 16 SCM attn the attention predict nets (ATTN_NETS: Mean, Sum and Max
             AttnPredictNet over DMPNN, MeanAttnPredictNet over CNN;
             infer_steps 1, 4 heads, sparsemax) at the flagship's
             configuration with the pred net swapped (nodeedge: the
             graph's self-attention over 64 nodes and 512 edges): per
             network a bsz-16 batch on the card against the CPU (phase
             14's checks; the f32 bounds widened by twice the CPU's own
             float32 error, its distance to a float64 run of the CPU;
             the outputs held in two stages: the predict nets' inputs,
             then the outputs against the CPU's predict nets fed the
             card's inputs, that bound widened by each device's own
             float32 error on them),
             per network the train step at bsz 128 and the eval forward
             at 512 (events, peak memory, K3's launches; for ATTN_TIMED,
             MeanAttn over DMPNN, also device ms and the
             share of the sparsemax's sort and scan kernels by
             torch.profiler); the ER command line with
             --pred_net MeanAttnPredictNet for one epoch on phase 12's
             data, then cli/scm_evaluate; and the remat repair: DMPNN
             with REMAT_KW (rep_remat, dropout 0.1, BatchNorm) at bsz
             16, its gradients, running statistics and dropout
             generator's state against the run without remat from the
             same generator seed, K3's launches (the recomputation's
             among them) against k3_launches;
 17 SCM mem  the memory predict nets (MEM_CMP: MeanMemAttn mean,
             SumMemAttn circular_lstm, MaxMemAttn attn, DIAMNet mean and
             circular_lstm over DMPNN, DIAMNet circular_attn over CNN;
             mem_len 4, phase 16's heads and round) at the flagship's
             configuration with the pred net swapped: per network a
             bsz-16 batch on the card against the CPU under phase 16's
             rule; the train step at bsz 128 and the eval forward at 512
             of MEM_STEP (Mean, Sum and Max MemAttn and DIAMNet at mean
             over DMPNN, DIAMNet circular_lstm: events, peak memory, K3's
             launches;
             for MEM_TIMED, DIAMNet circular_lstm, also device ms and
             the shares of the sparsemax's sort and scan kernels and of
             cuDNN's RNN kernels by torch.profiler);
             the ER command line with --pred_net
             DIAMNet --pred_mem_init circular_lstm for one epoch on phase
             12's data, then cli/scm_evaluate; before them, DIAMNet
             circular_lstm's window LSTMs against a float64 run of them,
             float32 by cuDNN, by torch's native CUDA LSTM and by the CPU
             (lstm_f64_errors);
 18 dist     scale-out over torch.distributed (parallel/): the flagship's
             data-parallel train step (bsz 128, 64 pairs a rank) and the
             PubMed batch edge-partitioned (DMPNN at full width, one step
             of CompGCN, R-GCN and R-GIN), each as two ranks sharing
             cuda:0 over gloo and as a world of one over NCCL (NCCL
             refuses two ranks on one card), held against the one-rank
             step on the card (DP under phase 11's train bounds, EP under
             phase 5's), the ranks' states bit for bit equal, K3's
             launches per DP rank and K1's and K2's per EP rank; K1 and K2
             at the EP shard shape and K3 at the DP rank's against their
             plain versions, timed (after phase 6, early in the run, as
             CUPTI late in a long process has dropped whole traces);
             then train_epoch (one epoch) and
             train_unc (BACKBONE_LINKS links) over the two gloo ranks,
             launches counted from zero; then, in the same processes,
             the E4 work (E4): the demonstration layer
             (parallel/edge_partition.py) at bench/halo_bench.py's size
             (V 100,000, E 1,000,000, H 64, 2 layers) on its power-law
             and community graphs, two ranks against one rank on the
             card (each layer's forward and the first gradients under
             phase 5's f32 bounds, at most MAX_FLIPS leaky ReLU inputs
             on the other side of zero, each within FLIP_TOL, 6 SGD
             steps: losses,
             parameters, the ranks bit for bit equal, K3's launches),
             halo_bench.run at that size (each halo forward held to its
             full sum), dryrun_multichip over the gloo ranks and the
             NCCL world of one, and bench/partition_bench.py on the host
             (PARTITION_BENCH); K3 at the demonstration layer's and the
             halo layer's rank shapes against its plain version, timed
             early in the run (e4_kernels). The two ranks' step times
             are those of two ranks sharing one card, no scale-out
             speed;
 19 halo     owner-sharded (halo) UNC training (parallel/halo_unc.py):
             phase 18's PubMed batch and models partitioned over two
             ranks sharing cuda:0 over gloo (degree partitioner: Vp =
             31,555, B = Vp, Vt = 94,666) and a world of one over NCCL
             (in phase 18's NCCL process), every backbone's loss and
             gradients (f32, amp bf16) held against phase 18's one-rank
             step under phase 5's bounds and phase 18's flip rule, K1's
             and K2's launches per rank; the DMPNN step timed, the
             exchange of one layer and the loss's gather timed (CUDA
             events and host ms); K1 and K2 at a halo
             rank's shapes against their plain versions, timed (early in
             the run, beside phase 18's); then train_unc (bfs, amp,
             BACKBONE_LINKS links, every node's row exported) and the
             north-star gate (gates/northstar.py at its CI envelope: v
             2,000, e 40,000, 6 amp steps, a checkpoint restored mid-run)
             over the two gloo ranks, launches counted from zero;
 20 helpers, examples  (a, early in the run, after phase 18's kernels)
             the four helpers (scatter_sum_flat, scatter_max_edges,
             segment_softmax_edges, edge_norm_device) at the flagship's
             graph side (bsz 128, E 512, V 64, H 64) and the flat graph
             of scatter_sum_flat's docstring (V 82,465, E 497,664, H 64,
             receivers partly given as r - V, some edges masked), f32 and
             bf16: output and gradient on the card against the CPU under
             phase 11's bounds, K3's launches per call and per backward
             counted from zero and held to HELPER_K3, each timed beside
             one PyTorch call (index_add_, scatter_reduce amax) and its
             bytes over 3.35 TB/s; K3 at the flat sum's and the softmax
             denominator's shapes against its plain version, timed; (b)
             the examples (dualmessagepassing_tpu_torch/examples/):
             quickstart_scm and performance_levers' SCM step (f32, amp:
             losses, gradients, parameters after the step) and one-device
             train_unc (losses, embeddings) on cuda:0 against the CPU,
             and, inside phase 18's spawns (the gloo pair, the NCCL world
             of one), multichip_dp, edge_parallel and the owner-sharded
             train_unc against the same on the CPU (train_unc at the same
             world size: the gloo ranks again over the CPU, the NCCL
             world's in this process over a gloo group of one), each
             run's launches counted from zero.

The model is the reference's UNC DMPNN run.sh configuration (n_hidden 50,
n_layers 2, negative_sample 5, graph_batch_size 10000, graph_split_size
0.5, randomwalk sampler, depth 3, width 10) on a synthetic heterogeneous
graph of PubMed's published size (63,109 nodes, 244,986 links, 10 link
types) made from --seed, with random weights from a CPU torch.Generator.

Phases 7-9 and 11-20 print {"paths": {...}} before the kernels line: the
kernel launches of each of their training runs, counted from zero just
before it and read just after (phases 18-19's per rank, rank 0's
printed).

The second-to-last line is {"kernels": [...]}: per kernel its launches
(K1, K2: phase 5's training and export, forward and backward; K3: phase
11's SCM learning run, with the bench's as "launches_bench"; K4: phase
6's kernel bench), its max abs error against the plain version,
and the kernel's, its plain version's and one PyTorch call's (library:
index_add_ or index_select) times, each as CUDA-event ms ("ms",
"plain_ms", "library_ms") and torch.profiler device ms ("device_ms",
...), beside "bound_ms", the bytes it must move over 3.35 TB/s: K1 at the
training batch's receiver plan, H = 50 ("_recv_w101", "_send_w101" for
the other two), K2 at the path's W = 101 ("_w50"), K3 at the SCM train
step's f32 H = 64 shape (the other three as "_bfloat16_h64", ...; the
bench's largest size as "_bench"; phase 14's relation fold and LRP pool
as "_rel_fold", "_lrp_pool" and their "_bfloat16" twins; phase 15's
degree tables as "_edgeseq_deg", its degree steps' launches as
"launches_scm_seq_deg_step"; phase 16's train steps' launches as
"launches_scm_attn_step", phase 17's as "launches_scm_mem_step"; phase
18's DP rank shape as "_dp_rank", its launches a step as
"launches_dp_rank_step"; K1's and K2's EP shard shape as "_ep_shard",
their launches per EP rank and step as "launches_ep_rank_step"; phase
19's halo rank shapes as "_halo_vp" (K1 into Vp, H = 50),
"_halo_vt_send" (K1 into Vt through the sender order, W = 101) and
"_halo_table" (K2 from the [Vt, 101] table), their launches per halo
rank and step as "launches_halo_rank_step"; K3 at phase 18's E4 rank
shapes as "_ep_layer" and "_halo_layer", its launches per
demonstration-layer step on rank 0 as "launches_ep_layer_step" and in
halo_bench's run as "launches_halo_bench_rank0"; K3 at phase 20's helper
shapes as "_flat_sum", "_softmax_denom_flagship", "_softmax_denom_flat"
and their "_bfloat16" twins, each helper's launches per call and per
backward as "launches_helpers"), K4 at
the
bench's largest size (and at the smallest as "_64x4096": event, device,
plain and bound times).
The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dualmessagepassing_tpu_torch import native
from dualmessagepassing_tpu_torch.bench import kernel_bench
from dualmessagepassing_tpu_torch.cli import config as scm_config
from dualmessagepassing_tpu_torch.cli import scm_evaluate, scm_train
from dualmessagepassing_tpu_torch.data.dataset import (GraphAdjDataset,
                                                       lrp_batch)
from dualmessagepassing_tpu_torch.data.lrp import (count_perms,
                                                   record_to_lrp_perms)
from dualmessagepassing_tpu_torch.data.synthetic import (
    generate_community_graph, generate_dataset, generate_large_graph)
from dualmessagepassing_tpu_torch.bench import halo_bench, partition_bench
from dualmessagepassing_tpu_torch.bench import scm_learn_spread as learn_spread
from dualmessagepassing_tpu_torch.constants import LEAKY_RELU_A
from dualmessagepassing_tpu_torch.dryrun import (_flagship_config,
                                                 dryrun_multichip)
from dualmessagepassing_tpu_torch.examples import edge_parallel as ex_ep
from dualmessagepassing_tpu_torch.examples import multichip_dp as ex_dp
from dualmessagepassing_tpu_torch.examples import performance_levers as ex_pl
from dualmessagepassing_tpu_torch.examples import quickstart_scm as ex_qs
from dualmessagepassing_tpu_torch.parallel.edge_partition import (
    edge_parallel_dmp_apply, edge_parallel_grads, init_edge_parallel_params,
    make_edge_parallel_train_step, pad_to_multiple, shard_flat_edges)
from dualmessagepassing_tpu_torch.parallel.halo import build_halo_partition
from dualmessagepassing_tpu_torch.gates import scm_convergence as scm_gate
from dualmessagepassing_tpu_torch.gates import unc_convergence as unc_gate
from dualmessagepassing_tpu_torch.graph import (add_reversed_edges,
                                                batch_edgeseqs, batch_graphs,
                                                record_to_edgeseq,
                                                single_graph)
from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
from dualmessagepassing_tpu_torch.models.layers import MaskedBatchNorm
from dualmessagepassing_tpu_torch.models.pred_attn import WindowLSTMMem
from dualmessagepassing_tpu_torch.models.scm_models import (build_model,
                                                            k3_launches)
from dualmessagepassing_tpu_torch.ops import scatter as scm_ops
from dualmessagepassing_tpu_torch.ops import scatter_kernels as sc
from dualmessagepassing_tpu_torch.ops import segment_kernel as sk
from dualmessagepassing_tpu_torch.ops.build import (ALL_CUDA_KERNELS,
                                                    build_cuda_kernels)
from dualmessagepassing_tpu_torch.ops.spectral import edge_norm_device
from dualmessagepassing_tpu_torch.parallel import dist, dp
from dualmessagepassing_tpu_torch.gates import northstar
from dualmessagepassing_tpu_torch.parallel.dist import (all_gather_rows,
                                                        all_reduce_grads,
                                                        all_reduce_sum,
                                                        halo_exchange,
                                                        split_rows)
from dualmessagepassing_tpu_torch.parallel.ep_unc import (
    attach_ep_csr_plans, make_ep_train_step, pad_e_max, shard_sub)
from dualmessagepassing_tpu_torch.parallel.halo_unc import (
    halo_envelope, halo_rank_shard, make_halo_train_step)
from dualmessagepassing_tpu_torch.unc.data import WholeGraph, save_embeddings
from dualmessagepassing_tpu_torch.unc import evaluate
from dualmessagepassing_tpu_torch.unc.driver import (
    export_embeddings, make_unc_optimizer, make_unc_train_step, sample_batch,
    sample_supervised_batch, to_device, train_unc, train_unc_supervised)
from dualmessagepassing_tpu_torch.unc.model import (
    UNCTrainModel, apply_unc_forward, apply_unc_supervised_forward)
from dualmessagepassing_tpu_torch.train import scm_driver
from dualmessagepassing_tpu_torch.train.losses import scm_loss
from dualmessagepassing_tpu_torch.train.samplers import (BucketSampler,
                                                         CurriculumSampler)
from dualmessagepassing_tpu_torch.utils.log import get_best_epochs

# the reference's UNC DMPNN run.sh (tests/test_reference_commands.py:154)
N_HIDDEN, N_LAYERS, NEG, GBS = 50, 2, 5, 10000
SPLIT, DEPTH, WIDTH = 0.5, 3, 10
LR, REG, GRAD_NORM = 1e-2, 1e-2, 1.0
# PubMed's published size (SURVEY.md:456)
PUBMED = dict(num_nodes=63109, num_links=244986, num_rels=10)
# its envelope: e_max = min(v_max * WIDTH, 2 * num_links)
PUBMED_E_MAX = 489972
# bench.py build_unc_infer envelope: V=65,536 and E=524,288 doubled edges
UNC_INFER = dict(num_nodes=65536, num_links=262144, num_rels=3)

# --- tolerances --------------------------------------------------------
# K1 f32 vs the plain index_add_ (atomics: another summation order):
# |k - p| <= 2**-20 * sum_e |msg[e]| per element, i.e. 16 f32 ulps of
# the row's absolute sum — at least the worst-case bound n * 2**-24 for
# rows of <= 16 edges, and ~12 (~18) standard deviations of random-order
# rounding for the 5,000-edge (100,000-edge) hub. bf16 adds one bf16 ulp
# (2**-7 rel) of the output, since both round their f32 sum once. Empty
# rows are 0. K1 sums in an order fixed by the shapes: two calls give the
# same bits.
K1_ABS_SUM_TOL = 2.0 ** -20
BF16_REL = 2.0 ** -7
# model forward on the card vs the CPU (plain kernel versions), node
# embeddings on valid rows, |h| <= ~0.3 at this configuration. f32:
# cuBLAS and the CPU BLAS sum matmuls in different orders (TF32 off),
# ~1e-7 per product; 2e-5 leaves two orders of magnitude. amp bf16: on
# the CPU the bf16 forward of this batch differs from the f32 forward by
# at most 2.7e-3 (mean 4.0e-4) — one device's bf16 rounding; two devices
# that round at different places differ by at most about twice that.
MODEL_F32_ATOL = 2e-5
MODEL_BF16_ATOL = 1e-2
MODEL_BF16_MEAN_ATOL = 1e-3
# K3 (f32 atomics, another order every run) and K4 (K1's kernel) against
# their plain versions: K1's bound, 2**-20 of each row's absolute sum.
# The Functions' gradients: the kernels they launch — K2 bitwise, K1 (and
# its bf16 rounding) as above.
# Training gradients, card vs CPU, per parameter tensor k: f32 — cuBLAS
# and the CPU sum in other orders, ~1e-6 relative over the batch's
# 490k-row reductions, and the biases that feed a BatchNorm have an
# exact gradient of 0 and return rounding noise only; so
# max|card - cpu| <= 1e-4 * max|g_cpu[k]| + 1e-5 * max_k max|g_cpu[k]|.
# amp bf16 — the card and the CPU round to bf16 at different places
# (tests/test_torch_unc_train.py measures JAX's and the port's amp noise
# on the CPU); the card's amp gradient may be at most 1.5 times as far
# from the CPU's f32 gradient as the CPU's amp gradient is, plus one
# bf16 rounding (2**-8) of the tensor's f32 maximum, per tensor, and 1.5
# times in L2 over all tensors. The loss: 1e-5 (f32), 1e-3 (amp)
# relative.
TRAIN_F32_REL, TRAIN_F32_GLOBAL = 1e-4, 1e-5
TRAIN_AMP_FACTOR = 1.5
# K2 is checked bitwise with its table and output at these element
# offsets into their storage: aligned, and three misaligned pairs
K2_OFFSETS = ((0, 0), (1, 3), (3, 1), (0, 5))
# per train step with N_LAYERS layers: K1 aggregation, receiver and
# sender cotangents; K2 receiver gather, aggregation cotangent
K1_FWD, K1_BWD, K2_FWD, K2_BWD = N_LAYERS, 2 * N_LAYERS, N_LAYERS, N_LAYERS

# --- phase 11: SCM ---------------------------------------------------------
# bench.py's default train batch and the scm_infer batch (bench.py:
# 116,621); its large train batch, 2,048, is no longer timed here
SCM_BSZ, SCM_INFER_BSZ = 128, 512
# real edges per pair: graph 256 and pattern 8, each with its reversed
# copy (bench.py:770)
SCM_EDGES_PER_PAIR = 2 * 256 + 2 * 8
# the learning run (bench/scm_learn_spread.py): an ER set at the
# scm_er_counting sizes, the flagship's widths and options, scm_train's
# default schedule (cosine with its derived warmup): at a constant rate
# the loss reaches a plateau by epoch 1, where one epoch's mean moves by
# up to 2 with the last bits of the weights (K3's atomic order), and
# "falling" would be a draw
SCM_LEARN = learn_spread.LEARN
SCM_LOSS = dict(bp_loss="MSE", neg_slope=0.2, match_loss_w=0.1,
                match_reg_w=0.05, rep_reg_w=1e-4)
# SCM outputs and gradients, card vs CPU: f32 — outputs within 1e-4 of
# each tensor's largest magnitude (cuBLAS and the CPU sum matmuls in
# other orders, K3's atomics in no fixed order), the loss 1e-5 relative,
# gradients phase 5's TRAIN_F32_REL / TRAIN_F32_GLOBAL; amp bf16 —
# phase 5's rule: at most TRAIN_AMP_FACTOR times as far from the CPU's
# f32 result as the CPU's amp result is, plus 2**-8 of the tensor's f32
# maximum, per tensor, and TRAIN_AMP_FACTOR in L2 over all gradients;
# the loss 1e-3 relative.
SCM_F32_OUT_REL = 1e-4

# --- phase 12: the SCM command lines ---------------------------------------
# the reference's Erdos-Renyi command line at its published widths
# (tests/test_reference_commands.py:20-43), flag for flag but its data
# directories: a synthetic ER set of SCM_CLI_PAIRS train pairs made from
# the seed stands in for them, and the run is cut from 100 epochs to
# SCM_CLI_EPOCHS; the finetune (a larger vertex-label vocabulary) and the
# dual-graph run take one epoch each
SCM_CLI_ER = (
    "--add_rev True --hid_dim 64 --node_pred True --edge_pred False "
    "--match_weights node --enc_net Multihot --enc_base 2 "
    "--emb_net Equivariant --share_emb_net True --rep_net DMPNN "
    "--rep_num_pattern_layers 3 --rep_num_graph_layers 3 "
    "--rep_residual True --rep_dropout 0.0 --share_rep_net True "
    "--pred_net SumPredictNet --pred_hid_dim 64 --pred_dropout 0.0 "
    "--max_npv 4 --max_npe 10 --max_npvl 1 --max_npel 1 "
    "--max_ngv 10 --max_nge 48 --max_ngvl 1 --max_ngel 1 "
    "--train_grad_steps 1 --train_batch_size 64 --train_log_steps 10 "
    "--eval_batch_size 64 --lr 1e-3 --train_epochs 100 --seed 0 "
    "--gpu_id 0").split()
SCM_CLI_PAIRS, SCM_CLI_EPOCHS = 4096, 2
# scm_evaluate's dev metrics for the best epoch against the training
# run's, the same data and checkpoint: K3 sums in f32 with atomics, in
# another order every launch (~1e-7 relative per sum), which reaches the
# predicted counts through 3 + 3 layers and the predictor at ~1e-6
# relative; MAE, MSE, RMSE, MNED and MEED within 1e-4 of max(|value|,
# 1), AUC within 1e-3 (a reordered pair of near-equal predictions)
SCM_EVAL_REL, SCM_EVAL_AUC = 1e-4, 1e-3

# --- phase 13: the learning gates at their smoke sizes ---------------------
# tests/test_scm_matching_quality.py:65-80's ER run
SCM_GATE = dict(pairs=384, max_epochs=12, early_stop=12, bsz=64, lr=1e-3,
                amp=True, seed=0, probe_steps=60, family="er")
# tests/test_scm_matching_quality.py:74-76's limits on the dev MNED/MEED
# ratios to the zero predictor. The seed draws the data and the initial
# weights, and one draw decides the ratios: in the JAX package one seed
# in three fails them (PERF.md §6), so they are held on the mean over
# SCM_GATE_SEEDS, and each seed's verdict is printed.
SCM_GATE_SEEDS = range(12)
SCM_GATE_LIMITS = {"dev_MNED_vs_zero": 0.9, "dev_MEED_vs_zero": 1.05}

# --- phase 14: the SCM graph networks --------------------------------------
# the flagship's configuration with the rep net swapped (R-GCN and R-GIN
# read max_ngel = 32 relations)
SCM_NETS = ("CompGCN", "RGCN", "RGIN", "LRP", "DMPLRP")
LRP_NETS = ("LRP", "DMPLRP")
# the networks whose train and eval steps are timed by events only, not
# profiled, to keep the run inside its limit (the four torch.profiler
# traces of a network's timing took ~18 s in phase 17)
UNPROFILED_NETS = ("LRP", "DMPLRP", "TXL")
# card against CPU on a bsz-16 flagship batch: the CPU runs it too, and
# LRP's ~4,000 perms a graph make the CPU's f32 and amp steps the slow
# part; the train step is timed at bsz 128, the eval forward at 512, as
# phase 11's
SCM_NET_CMP_BSZ = 16

# --- phase 15: the SCM sequence networks -----------------------------------
# the flagship's configuration with the rep net swapped; TXL at seg_len
# 64, mem_len 64 and 4 heads (the defaults, stated); the networks' K3
# launches are the degree tables of pred_with_deg only
SEQ_NETS = {"CNN": {}, "RNN": dict(rep_rnn_type="LSTM"),
            "TXL": dict(rep_txl_seg_len=64, rep_txl_mem_len=64,
                        rep_txl_num_heads=4)}
SEQ_GRU = dict(rep_net="RNN", rep_rnn_type="GRU", rep_rnn_bidirectional=True)

# --- phase 16: the attention predict nets ---------------------------------
# (pred net, rep net): the flagship's configuration with the pred net
# swapped, over DMPNN and over CNN (phase 15's configuration); one
# inference round and 4 heads (the JAX package's defaults, stated)
ATTN_NETS = (("MeanAttnPredictNet", "DMPNN"), ("SumAttnPredictNet", "DMPNN"),
             ("MaxAttnPredictNet", "DMPNN"), ("MeanAttnPredictNet", "CNN"))
ATTN_KW = dict(pred_infer_steps=1, pred_num_heads=4)
# every net's train step and eval forward run on the card, timed by
# events with their K3 launches checked; those of ATTN_TIMED are also
# profiled (torch.profiler: device ms and kernel shares; a profile costs
# seconds of host time, ~20 s a network, which the run's limit does not
# leave for all)
ATTN_TIMED = (("MeanAttnPredictNet", "DMPNN"),)
# the device kernels of the sparsemax's sort and cumsum (torch.sort's and
# torch.cumsum's kernels, matched by name)
SPARSEMAX_KERNELS = ("sort", "scan")
# the remat repair: DMPNN rematerialised with dropout and BatchNorm
REMAT_KW = dict(rep_remat=True, rep_dropout=0.1, rep_dmpnn_batch_norm=True)

# --- phase 17: the memory predict nets ------------------------------------
# (pred net, rep net, mem_init): card against CPU; the train step and the
# eval forward of MEM_STEP on the card, timed by events, those of
# MEM_TIMED also profiled (phase 16's rule); mem_len 4 (the JAX package's
# default, stated) and phase 16's heads and inference round
MEM_CMP = (("MeanMemAttnPredictNet", "DMPNN", "mean"),
           ("SumMemAttnPredictNet", "DMPNN", "circular_lstm"),
           ("MaxMemAttnPredictNet", "DMPNN", "attn"),
           ("DIAMNet", "DMPNN", "mean"),
           ("DIAMNet", "DMPNN", "circular_lstm"),
           ("DIAMNet", "CNN", "circular_attn"))
MEM_STEP = (("MeanMemAttnPredictNet", "DMPNN", "mean"),
            ("SumMemAttnPredictNet", "DMPNN", "mean"),
            ("MaxMemAttnPredictNet", "DMPNN", "mean"),
            ("DIAMNet", "DMPNN", "mean"),
            ("DIAMNet", "DMPNN", "circular_lstm"))
# (MeanMemAttn and DIAMNet at mean are timed by events only, not
# profiled, to keep the run inside its limit: ~20 s each, profiled)
MEM_TIMED = (("DIAMNet", "DMPNN", "circular_lstm"),)
MEM_KW = dict(ATTN_KW, pred_mem_len=4)
MEM_NETS = ("MeanMemAttnPredictNet", "SumMemAttnPredictNet",
            "MaxMemAttnPredictNet", "DIAMNet")
# cuDNN's recurrent kernels (their names hold one of these, lower case)
RNN_KERNELS = ("rnn", "lstm")

# --- phase 18: scale-out ----------------------------------------------------
# DIST_STEPS data-parallel steps of the flagship at bsz SCM_BSZ, its loss
# weights (phase 11's timing ones) and learning rate; the later steps'
# losses against the one-rank step's within DP_LATER_LOSS_REL relative:
# the states part by the first step's last-bit differences, which
# amsgrad's per-element normalisation carries into its next updates
DIST_STEPS = 3
DP_SCAL, DP_LR = (0.2, 0.1, 0.05, 1e-4), 1e-3
DP_LATER_LOSS_REL = 1e-4
# EP's f32 gradients: where a leaky ReLU's input lies within float32
# rounding of zero, the EP step and the one-rank step (which sum in
# other orders) may take different slopes (1 or 1/5.5) there, and the
# gradients then part by far more than rounding (one PubMed node's
# input 1.04e-7 from zero moved node_emb's gradient 6.5 times phase 5's
# bound, NVIDIA H100). So where the two runs put such inputs on
# different sides of zero, the f32 gradients are held against the
# one-rank step taken again on the EP step's side of them, provided
# there are at most MAX_FLIPS and each lies, in both runs, within
# FLIP_TOL of zero, as a share of its tensor's largest magnitude over the
# real rows (about one float32 unit in the last place of that magnitude:
# the input is a difference of BatchNorm-scaled values of that size).
# More flips, or one further from zero, fail as a fault of the EP path.
FLIP_TOL, MAX_FLIPS = 1e-7, 8
# the edge-partitioned backbones (DMPNN timed, the others one step)
EP_BACKBONES = ("DMPNN", "CompGCN", "RGCN", "RGIN")

# --- phase 19: owner-sharded (halo) training --------------------------------
# the partitioner of the halo steps and kernel shapes (train_unc runs
# bfs); at two ranks on PubMed's 63,109 nodes Vp = 31,555 and B = Vp
HALO_PARTITION = "degree"

# --- phase 18's E4 work: the demonstration layer, the halo library ----------
# bench/halo_bench.py's graphs at its first size (V 100,000, E 1,000,000:
# power-law, and as many communities as ranks with 95 % of the edges
# inside one; seed 0), H 64, 2 layers; the demonstration layer's train
# step as tests/test_parallel.py:114 runs it (features at 0.1, 6 SGD
# steps) on the graph's first 10,000 triplets as DistMult samples with
# random labels, at lr 0.05 (the test's) on the community graph. The
# layer's sums are unnormalised, and the power-law graph's hub sums
# ~22,000 in-edges: its first loss is in the hundreds, and at lr 1e-5
# to 0.05 its loss oscillates or overflows within six steps (float32 on
# the CPU at this size); at 1e-6 it falls smoothly
E4 = dict(v=100_000, e=1_000_000, h=64, layers=2, steps=6, samples=10_000,
          iters=5, lr={"power_law": 1e-6, "community95": 0.05})
# K3 launches of the demonstration layer (parallel/edge_partition.py): a
# forward counts the out-degrees once and sums each layer's messages
# once; a train step's backward adds the two endpoint gathers of each
# layer but the last (the last layer's edge rows do not reach the loss)
# and the loss's three DistMult gathers; a halo forward sums each
# layer's messages once (the out-degrees come from the host)
E4_FWD_K3 = 1 + E4["layers"]
E4_STEP_K3 = E4_FWD_K3 + 2 * (E4["layers"] - 1) + 3
E4_HALO_K3 = E4["layers"]
# partition_bench (host only) at its defaults and at ARCHITECTURE.md:209's
# size: (nodes, shards)
PARTITION_BENCH = ((4096, 8), (65_536, 8))

# --- phases 7-10 ---------------------------------------------------------
# Per train step of the other backbones (unc/model.py), N_LAYERS layers,
# 2R = 20 edge types: CompGCN aggregates once per layer (K1 forward, K2
# backward) and gathers its senders once (K1 backward); R-GCN and R-GIN
# aggregate once per relation type (2R K1 forward, 2R K2 backward per
# layer) and gather their senders once (K1 backward). An export forward
# launches the forward counts of a step.
TYPES = 2 * PUBMED["num_rels"]
BACKBONE_STEP_LAUNCHES = {
    "CompGCN": {"segment_sum_sorted:fwd": N_LAYERS,
                "segment_sum_sorted:bwd": N_LAYERS,
                "gather_rows_sorted:bwd": N_LAYERS},
    "RGCN": {"segment_sum_sorted:fwd": TYPES * N_LAYERS,
             "segment_sum_sorted:bwd": N_LAYERS,
             "gather_rows_sorted:bwd": TYPES * N_LAYERS},
}
BACKBONE_STEP_LAUNCHES["RGIN"] = BACKBONE_STEP_LAUNCHES["RGCN"]
DMPNN_STEP_LAUNCHES = {"segment_sum_sorted:fwd": K1_FWD,
                       "segment_sum_sorted:bwd": K1_BWD,
                       "gather_rows_sorted:fwd": K2_FWD,
                       "gather_rows_sorted:bwd": K2_BWD}
# train_unc at reduced depth: the first 100,000 links, 10 batches of GBS;
# n_epochs=1 rescales to ceil(10 * GBS / 63,109) = 2 epochs; the export
# covers the same links in ceil(100,000 / (4 GBS)) = 3 requests
BACKBONE_LINKS = 100000
# HNE's PubMed node attributes are 200 wide
ATTR_WIDTH = 200
# supervised: PubMed's 8 classes on 4,000 synthetic labeled nodes; one
# epoch over the first 30,000 links (3 steps)
SUP_CLASSES, SUP_LABELED, SUP_LINKS, SUP_LABEL_BATCH = 8, 4000, 30000, 512
# evaluation: 1,000 of phase 9's single-label nodes; link prediction
# over 500 seed nodes
EVAL_NODES, LP_SEEDS, LP_NEG = 1000, 500, 5


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def synthetic_hin(num_nodes: int, num_links: int, num_rels: int,
                  rng: np.random.Generator) -> np.ndarray:
    """Distinct (src, rel, dst) links without self loops, endpoints drawn
    with Pareto-skewed popularity as in real heterogeneous graphs."""
    w = rng.pareto(2.0, num_nodes) + 1.0
    p = w / w.sum()
    keys = np.zeros(0, np.int64)
    while len(keys) < num_links:
        k = int((num_links - len(keys)) * 1.3) + 16
        s = rng.choice(num_nodes, k, p=p)
        d = rng.choice(num_nodes, k, p=p)
        r = rng.integers(0, num_rels, k)
        new = ((s * num_rels + r) * num_nodes + d)[s != d]
        allk = np.concatenate([keys, new])
        _, first = np.unique(allk, return_index=True)
        keys = allk[np.sort(first)]
    keys = keys[:num_links]
    d = keys % num_nodes
    r = (keys // num_nodes) % num_rels
    s = keys // (num_nodes * num_rels)
    return np.stack([s, r, d], axis=1).astype(np.int64)


def make_model(num_nodes: int, num_rels: int, seed: int,
               dropout: float = 0.2, **kw) -> UNCTrainModel:
    """Random port weights from a CPU generator, with non-trivial
    BatchNorm affine terms and running statistics (DMPNN); kw picks the
    backbone, inputs and head (UNCTrainModel)."""
    gen = torch.Generator().manual_seed(seed)
    model = UNCTrainModel(num_nodes, num_rels, N_HIDDEN,
                          num_hidden_layers=N_LAYERS, dropout=dropout,
                          reg_param=REG, generator=gen, **kw)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, MaskedBatchNorm):
                f = bn.weight.numel()
                bn.weight.add_(0.1 * torch.randn(f, generator=gen))
                bn.bias.add_(0.1 * torch.randn(f, generator=gen))
                bn.running_mean.copy_(0.1 * torch.randn(f, generator=gen))
                bn.running_var.copy_(0.5 + torch.rand(f, generator=gen))
    return model


def timed_pair(label: str, kernel, plain, extra: str = "") -> dict:
    """CUDA-event and torch.profiler device times of a kernel call and
    of its plain version (30 calls each), printed on one line."""
    k_ev, k_dev = kernel_bench.time_call(kernel, 30)
    p_ev, p_dev = kernel_bench.time_call(plain, 30)
    print(f"timing {label}: kernel {k_ev:.4f} ms event, {k_dev:.4f} ms "
          f"device; plain {p_ev:.4f} ms event, {p_dev:.4f} ms device{extra}")
    return dict(ms=k_ev, device_ms=k_dev, plain_ms=p_ev,
                plain_device_ms=p_dev)


# --- phase 2: kernels ----------------------------------------------------

def kernel_case(rng, v, e_real, e_pad, hub_edges, empty, width, dtype, dev):
    """A receiver-sorted stream: a hub row, a band of empty rows, uniform
    receivers elsewhere, and a pad tail that repeats the last receiver and
    carries garbage messages."""
    lo, hi = empty
    pool = np.concatenate([np.arange(0, lo), np.arange(hi, v)])
    recv = np.sort(np.concatenate([
        np.full(hub_edges, pool[len(pool) // 3]),
        rng.choice(pool, e_real - hub_edges)]))
    recv_padded = np.concatenate([recv, np.full(e_pad, recv[-1])])
    row_ptr = np.searchsorted(recv, np.arange(v + 1)).astype(np.int32)
    msg = rng.normal(size=(e_real + e_pad, width)).astype(np.float32)
    msg[e_real:] = 1e3                      # must never be read
    table = rng.normal(size=(v, width)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return (t(msg).to(dtype), t(row_ptr), t(table).to(dtype),
            t(recv_padded), e_real)


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def check_k1(msg, row_ptr, empty, rows=None) -> float:
    """K1 within its bound of the plain version, empty rows zero, and
    the same bits from a second call."""
    got = sk.segment_sum_sorted(msg, row_ptr, rows=rows)
    want = sk.segment_sum_sorted_plain(msg, row_ptr, rows)
    abs_sum = sk.segment_sum_sorted_plain(msg.float().abs(), row_ptr, rows)
    err = (got.float() - want.float()).abs()
    bound = K1_ABS_SUM_TOL * abs_sum
    if msg.dtype == torch.bfloat16:
        bound = bound + BF16_REL * torch.maximum(got.float().abs(),
                                                 want.float().abs())
    check(bool((err <= bound).all()),
          f"K1 {msg.dtype} H={msg.shape[1]}: max err {err.max().item()} "
          "exceeds the stated bound")
    check(bool((got[empty[0]: empty[1]] == 0).all()), "K1 empty rows not 0")
    again = sk.segment_sum_sorted(msg, row_ptr, rows=rows)
    check(torch.equal(bits(got), bits(again)),
          f"K1 {msg.dtype} H={msg.shape[1]}: two calls differ in their bits")
    return err.max().item()


def check_k1_edges(draw, dev) -> None:
    """K1 where a merge path can go wrong, f32 and bf16: a hub row of
    100,000 edges among empty rows, V = 1, no edges at all, and a row
    index (rows=) against the permuted copy it replaces, bitwise."""
    for dtype in (torch.float32, torch.bfloat16):
        for width in (50, 101):
            msg, rp, _, _, n_real = kernel_case(
                draw, 3000, 120000, 2000, 100000, (1000, 2000), width, dtype,
                dev)
            err = check_k1(msg, rp, (1000, 2000))
            one = torch.tensor([0, n_real], dtype=torch.int32, device=dev)
            err_one = check_k1(msg, one, (0, 0))
            none = torch.zeros(3001, dtype=torch.int32, device=dev)
            check_k1(msg, none, (0, 3000))
            perm = torch.from_numpy(draw.permutation(n_real)).to(dev)
            err_rows = check_k1(msg, rp, (1000, 2000), rows=perm)
            copy_sum = sk.segment_sum_sorted(msg.index_select(0, perm), rp)
            check(torch.equal(bits(sk.segment_sum_sorted(msg, rp, rows=perm)),
                              bits(copy_sum)),
                  f"K1 {dtype} W={width}: rows= differs from the permuted copy")
            torch.cuda.synchronize()
            print(f"kernels: {str(dtype)[6:]:8s} width {width:3d} K1 hub of "
                  f"100,000 edges max abs err {err:.3e}, V = 1 {err_one:.3e}, "
                  f"no edges 0, rows= {err_rows:.3e} and bitwise equal to "
                  "the permuted copy; every call twice, same bits")


def check_k2(table, idx, n_real, offsets=(0, 0)) -> float:
    """K2 bitwise against its plain version. With offsets (t, o) the
    table is read from, and the rows written into, views that start t
    and o elements into their storage (16-byte misaligned for t, o not
    multiples of 16 bytes), and the storage around out must stay as it
    was."""
    t_off, o_off = offsets
    e, w = idx.numel(), table.shape[1]
    if t_off:
        buf = torch.empty(table.numel() + t_off, dtype=table.dtype,
                          device=table.device)
        table = buf[t_off:].view_as(table).copy_(table)
    out = None
    if o_off:
        guard = torch.full((e * w + o_off + 16,), 3.0, dtype=table.dtype,
                           device=table.device)
        out = guard[o_off: o_off + e * w].view(e, w)
    got = sk.gather_rows_sorted(table, idx, n_real, out=out)
    want = sk.gather_rows_sorted_plain(table, idx, n_real)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    check(torch.equal(got.view(bits), want.view(bits)),
          f"K2 {table.dtype} W={w} offsets {offsets} not bitwise equal")
    check(bool((got[n_real:] == 0).all()), "K2 pad tail not zero")
    if o_off:
        check(bool((guard[:o_off] == 3).all()
                   and (guard[o_off + e * w:] == 3).all()),
              f"K2 W={w} offsets {offsets} wrote outside its output")
    return (got.float() - want.float()).abs().max().item()


def phase_kernels(dev, rng, extra) -> dict:
    """K1 and K2 against their plain versions, then timed at the path's
    shapes. `rng` draws what it drew before this phase had `extra`, so
    that the later phases see the same data; `extra` draws the rest."""
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            # widths 3 and 129 draw from `extra`
            for width, draw in ((1, rng), (3, extra), (50, rng), (101, rng),
                                (128, rng), (129, extra)):
                msg, rp, table, idx, n_real = kernel_case(
                    draw, 6000, 25000, 3000, 5000, (1000, 2000), width,
                    dtype, dev)
                err = check_k1(msg, rp, (1000, 2000))
                for offsets in K2_OFFSETS:
                    check_k2(table, idx, n_real, offsets)
                torch.cuda.synchronize()
                print(f"kernels: {str(dtype)[6:]:8s} width {width:3d} "
                      f"K1 max abs err {err:.3e} (within bound, same bits "
                      f"twice), K2 bitwise equal at (table, out) element "
                      f"offsets {K2_OFFSETS}")
        check_k1_edges(extra, dev)

        # timing at the path's shapes: E = e_max of the PubMed envelope,
        # all real. K1 at H = 50 (aggregation) and W = 2H+1 = 101 (the
        # receiver cotangent); K2 at W = 101 (receiver gather) and W = 50
        # (the aggregation's cotangent)
        v, e, w = PUBMED["num_nodes"], PUBMED_E_MAX, 2 * N_HIDDEN + 1
        timed = {}
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
            recv = np.sort(rng.integers(0, v, e))
            row_ptr = t(np.searchsorted(recv, np.arange(v + 1)).astype(
                np.int32))
            idx = t(recv)
            msgs = {N_HIDDEN: rng.normal(size=(e, N_HIDDEN))}
            tables = {w: rng.normal(size=(v, w)),
                      N_HIDDEN: extra.normal(size=(v, N_HIDDEN))}
            msgs[w] = rng.normal(size=(e, w))
            for h, m in msgs.items():
                msg = t(m.astype(np.float32)).to(dtype)
                err = check_k1(msg, row_ptr, (0, 0))
                timed[(name, "K1", h)] = dict(err=err, **timed_pair(
                    f"{name}: K1 segment_sum_sorted E={e} V={v} W={h}",
                    lambda: sk.segment_sum_sorted(msg, row_ptr),
                    lambda: sk.segment_sum_sorted_plain(msg, row_ptr),
                    f" (max abs err {err:.3e})"))
                del msg
            for h, tb in tables.items():
                table = t(tb.astype(np.float32)).to(dtype)
                err = check_k2(table, idx, e)
                nbytes = (e * h + v * h) * table.element_size() + e * 8
                times = timed_pair(
                    f"{name}: K2 gather_rows_sorted E={e} V={v} W={h}",
                    lambda: sk.gather_rows_sorted(table, idx, e),
                    lambda: sk.gather_rows_sorted_plain(table, idx, e))
                times["library_ms"], times["library_device_ms"] = \
                    kernel_bench.time_call(
                        lambda: table.index_select(0, idx), 30)
                times["bound_ms"] = hbm_ms(nbytes)
                share = nbytes / (kernel_bench.HBM_GBPS * 1e6) / times[
                    "device_ms"]
                print(f"timing {name}: K2 W={h} moves {nbytes / 1e6:.1f} MB:"
                      f" {100 * share:.1f} % of HBM bandwidth (3.35 TB/s) "
                      f"by device time; index_select "
                      f"{times['library_ms']:.4f} ms event, "
                      f"{times['library_device_ms']:.4f} ms device")
                timed[(name, "K2", h)] = dict(err=err, hbm_share=share,
                                              **times)
    return timed


def check_sum(name: str, got, want, abs_sum) -> float:
    """got against want within K1_ABS_SUM_TOL of each row's absolute sum."""
    err = (got.float() - want.float()).abs()
    check(bool((err <= K1_ABS_SUM_TOL * abs_sum).all()),
          f"{name}: max err {err.max().item()} exceeds the stated bound")
    return err.max().item()


def phase_scatter_kernels(dev) -> dict:
    """K3 and K4 against their plain versions at the kernel bench's four
    sizes (H = 64; K3 also in bf16); the errors at the largest; the
    plain versions timed at the smallest and the largest. Phase 6's
    kernel bench times the kernels."""
    sizes = kernel_bench.DEFAULT_SIZES.split(",")
    plain = {}
    with torch.inference_mode():
        for spec in sizes:
            v, e = (int(t) for t in spec.split("x"))
            x = kernel_bench.make_inputs(v, e, 64, 0, dev)
            errs = {}
            for dtype in (torch.float32, torch.bfloat16):
                m = x["msg"].to(dtype)
                abs_sum = sc.segment_sum_unsorted_plain(m.float().abs(),
                                                        x["recv"], v)
                errs[f"K3 {str(dtype)[6:]}"] = check_sum(
                    f"K3 {dtype} {spec}",
                    sc.segment_sum_unsorted(m, x["recv"], v),
                    sc.segment_sum_unsorted_plain(m, x["recv"], v), abs_sum)
            abs_sum = sc.csr_segment_sum_plain(x["msg_sorted"].abs(),
                                               x["row_ptr"])
            errs["K4 float32"] = check_sum(
                f"K4 {spec}", sc.csr_segment_sum(x["msg_sorted"],
                                                 x["row_ptr"]),
                sc.csr_segment_sum_plain(x["msg_sorted"], x["row_ptr"]),
                abs_sum)
            torch.cuda.synchronize()
            print(f"kernels: V={v} E={e} H=64 " + ", ".join(
                f"{k} max abs err {val:.3e}" for k, val in errs.items())
                + " (within bound)")
            if spec == sizes[0] or spec == sizes[-1]:
                plain[spec] = time_plain_scatter(x, v, e)
    # the plain versions at the smallest and the largest size (the bench
    # times the kernels and the one index_add_ call)
    return dict(k3_err=errs["K3 float32"], k4_err=errs["K4 float32"],
                plain=plain[sizes[-1]], plain_small=plain[sizes[0]])


def time_plain_scatter(x, v, e) -> dict:
    """K3's and K4's plain versions timed on kernel_bench inputs."""
    plain = {}
    plain["k3_ms"], plain["k3_device_ms"] = kernel_bench.time_call(
        lambda: sc.segment_sum_unsorted_plain(x["msg"], x["recv"], v), 30)
    plain["k4_ms"], plain["k4_device_ms"] = kernel_bench.time_call(
        lambda: sc.csr_segment_sum_plain(x["msg_sorted"], x["row_ptr"]), 30)
    print(f"timing: plain versions at V={v} E={e} H=64: K3 "
          f"{plain['k3_ms']:.4f} ms event, {plain['k3_device_ms']:.4f} ms "
          f"device; K4 {plain['k4_ms']:.4f} ms event, "
          f"{plain['k4_device_ms']:.4f} ms device")
    return plain


def phase_functions(dev, rng) -> None:
    """The three autograd Functions at the training path's shapes (E =
    e_max with a pad tail, V = PubMed, gathers of width 2H+1, the
    aggregation of width H): gradients on the card (kernels) against
    the same Functions on the CPU (plain versions), f32 and bf16."""
    v, e, pad = PUBMED["num_nodes"], PUBMED_E_MAX, PUBMED_E_MAX // 25
    n_real, w = e - pad, 2 * N_HIDDEN + 1
    recv = np.sort(rng.integers(0, v, n_real))
    recv_padded = np.concatenate([recv, np.full(pad, recv[-1])])
    row_ptr = np.searchsorted(recv, np.arange(v + 1)).astype(np.int32)
    senders = np.concatenate([rng.integers(0, v, n_real),
                              np.zeros(pad, np.int64)])
    order = np.argsort(senders, kind="stable")
    order = order[order < n_real]           # attach_csr_plan's sk2_order
    sk2 = np.searchsorted(senders[order], np.arange(v + 1)).astype(np.int32)
    table = rng.normal(size=(v, w)).astype(np.float32)
    g_rows = rng.normal(size=(e, w)).astype(np.float32)
    g_rows[n_real:] = 0                     # as the model's pad rows are
    msg = rng.normal(size=(e, N_HIDDEN)).astype(np.float32)
    msg[n_real:] = 0
    g_nodes = rng.normal(size=(v, N_HIDDEN)).astype(np.float32)
    cases = {
        "GatherRowsSorted": (lambda d: lambda t: sk.GatherRowsSorted.apply(
            t, d["recv"], n_real, d["rp"]), table, g_rows),
        "GatherRowsPerm": (lambda d: lambda t: sk.GatherRowsPerm.apply(
            t, d["senders"], d["order"], d["sk2"]), table, g_rows),
        "SegmentSumSorted": (lambda d: lambda t: sk.SegmentSumSorted.apply(
            t, d["rp"], d["recv"], n_real), msg, g_nodes),
    }
    # K1's bound needs each row's absolute sum of the cotangent it sums
    abs_sums = {
        "GatherRowsSorted": sk.segment_sum_sorted_plain(
            torch.from_numpy(np.abs(g_rows)), torch.from_numpy(row_ptr)),
        "GatherRowsPerm": sk.segment_sum_sorted_plain(
            torch.from_numpy(np.abs(g_rows[order])), torch.from_numpy(sk2))}
    for dtype in (torch.float32, torch.bfloat16):
        for name, (make, x, g) in cases.items():
            grads = {}
            for device in ("cpu", dev):
                t = lambda a: torch.from_numpy(a).to(device)  # noqa: E731
                d = dict(recv=t(recv_padded), rp=t(row_ptr),
                         senders=t(senders), order=t(order), sk2=t(sk2))
                xin = t(x).to(dtype).requires_grad_()
                make(d)(xin).backward(t(g).to(dtype))
                grads[device] = xin.grad
            torch.cuda.synchronize()
            got, want = grads[dev].cpu(), grads["cpu"]
            check(got.dtype == dtype, f"{name} gradient dtype {got.dtype}")
            if name not in abs_sums:        # backward is K2: a gather
                check(torch.equal(got, want),
                      f"{name} {dtype}: gradient not bitwise equal")
                err = 0.0
            else:
                bound = K1_ABS_SUM_TOL * abs_sums[name]
                if dtype == torch.bfloat16:
                    bound = bound + BF16_REL * torch.maximum(
                        got.float().abs(), want.float().abs())
                diff = (got.float() - want.float()).abs()
                check(bool((diff <= bound).all()),
                      f"{name} {dtype}: gradient max err {diff.max().item()}"
                      " exceeds the stated bound")
                err = diff.max().item()
            print(f"functions: {name} {str(dtype)[6:]} gradient card vs "
                  f"cpu max abs err {err:.3e} (within bound)")


# --- phase 3: model on the card against the CPU ---------------------------

def phase_model(model, graph, triplets, seed, dev) -> None:
    padded = sk.attach_csr_plan(sample_batch(
        graph, triplets[: 4 * GBS], "randomwalk", DEPTH, WIDTH, SPLIT, NEG,
        graph.num_nodes, min(graph.num_nodes * WIDTH, graph.num_edges),
        4 * GBS * (1 + NEG), np.random.default_rng(seed)))
    nm = torch.from_numpy(padded["node_mask"])
    cpu_model = copy.deepcopy(model).cpu()
    dev_model = copy.deepcopy(model).to(dev)
    sub_cpu = to_device(padded, "cpu")
    sub_dev = to_device(padded, dev)
    for amp in (False, True):
        with torch.inference_mode():
            h_cpu = apply_unc_forward(cpu_model, sub_cpu, amp=amp)[0]
            h_dev = apply_unc_forward(dev_model, sub_dev, amp=amp)[0].cpu()
        check(bool(torch.isfinite(h_dev).all()), "non-finite h on the card")
        err = (h_dev[nm] - h_cpu[nm]).abs()
        name = "amp bf16" if amp else "f32"
        print(f"model: {name} card vs cpu on {int(nm.sum())} valid rows "
              f"(n_real {padded['n_real']}): max abs err "
              f"{err.max().item():.3e}, mean {err.mean().item():.3e}, "
              f"max |h| {h_cpu[nm].abs().max().item():.3e}")
        if amp:
            check(err.max().item() <= MODEL_BF16_ATOL
                  and err.mean().item() <= MODEL_BF16_MEAN_ATOL,
                  "amp bf16 forward on the card disagrees with the CPU")
        else:
            check(err.max().item() <= MODEL_F32_ATOL,
                  "f32 forward on the card disagrees with the CPU")


# --- phase 5: training ----------------------------------------------------

def train_batch(graph, triplets, seed) -> dict:
    """One sampled training batch of GBS triplets with both CSR plans."""
    v = graph.num_nodes
    return sk.attach_csr_plan(sample_batch(
        graph, triplets[:GBS], "randomwalk", DEPTH, WIDTH, SPLIT, NEG, v,
        min(v * WIDTH, graph.num_edges), GBS * (1 + NEG),
        np.random.default_rng(seed), send_keys=True), sender_plan=True)


def loss_and_grads(model, sub, amp):
    """Loss and float32 gradients (on the CPU) of one train-mode forward
    of a copy of `model` (train mode updates its BN statistics)."""
    model = copy.deepcopy(model)
    out = apply_unc_forward(model, sub, amp=amp, train=True)
    loss = model.unsupervised_loss(
        out, sub["edge_type"], sub["edge_mask"], sub["samples"],
        sub["labels"], sub["sample_mask"], sub["node_mask"])
    loss.backward()
    return loss.item(), {k: p.grad.detach().float().cpu()
                         for k, p in model.named_parameters()}


def phase_train_grads(model, graph, triplets, seed, dev,
                      label: str = "train grads", loss_fn=None,
                      amps=(False, True)) -> dict:
    """The loss and every gradient of one training batch on the card
    against the CPU. loss_fn(model, amp) -> (loss, grads), given the
    padded batch, replaces the unsupervised loss (phase 9)."""
    cpu_model = copy.deepcopy(model).cpu()
    dev_model = copy.deepcopy(model).to(dev)
    if loss_fn is None:
        padded = train_batch(graph, triplets, seed)
        subs = {"cpu": to_device(padded, "cpu"), "card": to_device(padded,
                                                                   dev)}

        def loss_fn(m, amp):
            return loss_and_grads(m, subs["card" if m is dev_model
                                          else "cpu"], amp)
        print(f"{label}: batch of {GBS} triplets, n_real "
              f"{padded['n_real']}, {int(padded['node_mask'].sum())} nodes")
    res = {(where, amp): loss_fn(m, amp)
           for where, m in (("cpu", cpu_model), ("card", dev_model))
           for amp in amps}
    torch.cuda.synchronize()
    f32 = res[("cpu", False)][1]
    gmax = max(g.abs().max().item() for g in f32.values())

    def dist(a, b):
        return sum(((a[k] - b[k]) ** 2).sum().item() for k in a) ** 0.5

    worst = {}
    for amp in amps:
        (lc, gc), (ld, gd) = res[("cpu", amp)], res[("card", amp)]
        check(np.isfinite(ld), "non-finite loss on the card")
        check(abs(ld - lc) <= (1e-3 if amp else 1e-5) * abs(lc),
              f"loss card {ld} vs cpu {lc} (amp={amp})")
        ratio = 0.0
        for k in gc:
            check(bool(torch.isfinite(gd[k]).all()), f"non-finite grad {k}")
            scale = f32[k].abs().max().item()
            if amp:
                card = (gd[k] - f32[k]).abs().max().item()
                cpu = (gc[k] - f32[k]).abs().max().item()
                bound = TRAIN_AMP_FACTOR * cpu + 2.0 ** -8 * scale
                err = card
            else:
                err = (gd[k] - gc[k]).abs().max().item()
                bound = TRAIN_F32_REL * scale + TRAIN_F32_GLOBAL * gmax
            check(err <= bound, f"{k} (amp={amp}): card err {err:.3e} "
                  f"exceeds {bound:.3e}")
            ratio = max(ratio, err / bound)
        if amp:
            l2_card, l2_cpu = dist(gd, f32), dist(gc, f32)
            check(l2_card <= TRAIN_AMP_FACTOR * l2_cpu,
                  f"amp gradient L2 distance {l2_card} vs cpu {l2_cpu}")
        name = "amp bf16" if amp else "f32"
        worst[name] = ratio
        print(f"{label} {name}: loss card {ld:.7f} cpu {lc:.7f}; "
              f"{len(gc)} gradients within bound (worst at "
              f"{ratio:.3f} of it)" + (
                  f"; L2 to cpu f32: card {l2_card:.3e}, cpu amp "
                  f"{l2_cpu:.3e}" if amp else ""))
    return worst


def plan_stats(row_ptr: np.ndarray) -> str:
    n = np.diff(row_ptr)
    return (f"max {n.max()}, p99 {np.percentile(n, 99):.0f}, mean "
            f"{n.mean():.2f}")


def hbm_ms(nbytes: int) -> float:
    """Bytes over the H100's HBM3 bandwidth, in ms."""
    return nbytes / (kernel_bench.HBM_GBPS * 1e6)


def phase_k1_train_shapes(graph, triplets, seed, dev) -> dict:
    """K1 at the three call shapes of one training batch, on the batch's
    own plans, f32 and bf16: the receiver plan at H = 50 (aggregation)
    and W = 2H+1 (receiver cotangent), and the sender plan at W = 2H+1
    (sender cotangent), read through sk2_order (rows=) as the backward
    does; beside it the way before rows= existed, an index_select into
    sender order and K1 on the copy, each timed. Beside each: its plain
    version, one index_add_ (in msg's dtype, the receivers given) and the
    HBM bound of the bytes K1 must move."""
    padded = train_batch(graph, triplets, seed)
    n, v = padded["n_real"], len(padded["node_mask"])
    e = len(padded["receivers"])
    print(f"k1 plans: n_real {n}, V {v}, E {e}; receiver rows "
          f"{plan_stats(padded['sk_rowptr'])}; sender rows "
          f"{plan_stats(padded['sk2_rowptr'])}")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    plans = {"recv": (t(padded["sk_rowptr"]), t(padded["receivers"][:n]),
                      None),
             "send": (t(padded["sk2_rowptr"]), t(padded["senders"][:n]),
                      t(padded["sk2_order"]))}
    rng = np.random.default_rng(seed)
    w = 2 * N_HIDDEN + 1
    timed = {}
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            name = str(dtype)[6:]
            for plan, h in (("recv", N_HIDDEN), ("recv", w), ("send", w)):
                row_ptr, idx, order = plans[plan]
                msg = t(rng.normal(size=(e, h)).astype(np.float32)).to(dtype)
                nbytes = (n * h + v * h) * msg.element_size() + (v + 1) * 4
                if order is not None:
                    nbytes += n * 8
                err = check_k1(msg, row_ptr, (0, 0), rows=order)
                res = dict(err=err, bound_ms=hbm_ms(nbytes), **timed_pair(
                    f"{name}: K1 train batch {plan} plan n_real={n} V={v} "
                    f"W={h}" + (" rows=sk2_order" if plan == "send" else ""),
                    lambda: sk.segment_sum_sorted(msg, row_ptr, rows=order),
                    lambda: sk.segment_sum_sorted_plain(msg, row_ptr,
                                                        order)))
                res["library_ms"], res["library_device_ms"] = \
                    kernel_bench.time_call(lambda: torch.zeros(
                        v, h, dtype=dtype, device=dev).index_add_(
                            0, idx, msg[:n]), 30)
                extra = ""
                if order is not None:
                    perm = msg.index_select(0, order)
                    res["perm_ms"], res["perm_device_ms"] = \
                        kernel_bench.time_call(
                            lambda: msg.index_select(0, order), 30)
                    res["copy_ms"], res["copy_device_ms"] = \
                        kernel_bench.time_call(
                            lambda: sk.segment_sum_sorted(perm, row_ptr), 30)
                    extra = (f"; without rows=: index_select into sender "
                             f"order {res['perm_ms']:.4f} ms event, "
                             f"{res['perm_device_ms']:.4f} ms device, then "
                             f"K1 {res['copy_ms']:.4f} ms event, "
                             f"{res['copy_device_ms']:.4f} ms device")
                    del perm
                print(f"timing {name}: K1 {plan} W={h}: bound "
                      f"{res['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB), "
                      f"{100 * res['bound_ms'] / res['device_ms']:.1f} % of "
                      f"it by device time; index_add_ "
                      f"{res['library_ms']:.4f} ms event, "
                      f"{res['library_device_ms']:.4f} ms device{extra} "
                      f"(max abs err {err:.3e})")
                timed[(name, plan, h)] = res
                del msg
    return timed


def phase_profile(model, graph, triplets, seed, dev) -> dict:
    """Three train steps of a copy of the model under torch.profiler, f32
    and amp bf16: device time per step and the top device operations;
    then five steps timed with CUDA events."""
    sub = to_device(train_batch(graph, triplets, seed), dev)
    out = {}
    for amp in (False, True):
        m = copy.deepcopy(model).to(dev)
        step = make_unc_train_step(
            m, make_unc_optimizer(m, LR, 100, GRAD_NORM), amp=amp)
        step(sub)
        torch.cuda.synchronize()
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        t0 = time.perf_counter()
        with torch.profiler.profile(activities=acts) as prof:
            for _ in range(3):
                step(sub)
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / 3
        events = kernel_bench.device_events(prof)
        total = kernel_bench.per_call_us(events, 3) / 1e3
        name = "amp bf16" if amp else "f32"
        print(f"profile {name}: {total:.3f} ms device time per train step "
              f"(torch.profiler, 3 steps), {wall:.3f} ms wall per step")
        for e in sorted(events, key=kernel_bench.device_us,
                        reverse=True)[:12]:
            ms = kernel_bench.per_call_us([e], 3) / 1e3
            print(f"profile {name}:   {ms:8.4f} ms {100 * ms / total:5.1f} % "
                  f"x{e.count // 3:<4d} {e.key[:90]}")
        step_ms = kernel_bench.cuda_median_ms(lambda: step(sub), 5,
                                              warmup=0)
        print(f"profile {name}: train step {step_ms:.3f} ms (CUDA events, "
              "median of 5)")
        out[name] = dict(device_ms=total, wall_ms=wall, step_ms=step_ms)
    return out


def phase_train(model, triplets, seed) -> dict:
    """train_unc at the run.sh configuration, n_epochs=1, then its f32
    export; the launch counts of the whole run."""
    epochs, requests = [], []

    def on_epoch(rec):
        steps = rec["step_ms"]
        busy = sum(steps) / rec["wall_ms"]
        epochs.append(rec)
        print(f"train epoch {rec['epoch']}: loss {rec['loss']:.6f}, "
              f"{rec['steps']} steps, host sampling "
              f"{statistics.median(rec['sample_ms']):.1f} ms median per "
              f"batch (2 threads), main loop waited "
              f"{sum(rec['wait_ms']):.1f} ms, step "
              f"{statistics.median(steps):.3f} ms median "
              f"({min(steps):.3f}-{max(steps):.3f}, CUDA events), epoch "
              f"{rec['wall_ms']:.1f} ms wall: device busy {100 * busy:.2f} "
              f"%, idle {100 * (1 - busy):.2f} %")

    def on_request(rec):
        requests.append(rec)
        print(f"serve f32 request {rec['request']}: forward "
              f"{rec['forward_ms']:.3f} ms (CUDA events), host sampling "
              f"{rec['sample_ms']:.1f} ms, {rec['n_real']} edges, "
              f"{rec['n_nodes']} nodes, coverage {rec['coverage']:.4f}")

    sk.reset_launch_counts()
    t0 = time.perf_counter()
    emb, cov = train_unc(
        model, triplets, PUBMED["num_nodes"], PUBMED["num_rels"], lr=LR,
        negative_rate=NEG, graph_batch_size=GBS, graph_split_size=SPLIT,
        sampler="randomwalk", sample_depth=DEPTH, sample_width=WIDTH,
        n_epochs=1, grad_norm=GRAD_NORM, seed=seed, on_epoch=on_epoch,
        on_request=on_request, log=lambda s: print(f"train: {s}"))
    launches = dict(sk.LAUNCHES)
    wall = time.perf_counter() - t0
    steps = sum(rec["steps"] for rec in epochs)
    n_req = len(requests)
    check(all(np.isfinite(rec["losses"]).all() for rec in epochs),
          "non-finite training loss")
    want_req = -(-PUBMED["num_links"] // (4 * GBS))     # 7 at PubMed size
    check(n_req == want_req, f"{n_req} export requests, expected {want_req}")
    want = {"segment_sum_sorted:fwd": K1_FWD * (steps + n_req),
            "segment_sum_sorted:bwd": K1_BWD * steps,
            "gather_rows_sorted:fwd": K2_FWD * (steps + n_req),
            "gather_rows_sorted:bwd": K2_BWD * steps}
    check(launches == want, f"launches {launches}, expected {want} for "
          f"{steps} steps and {n_req} export forwards")
    check(emb.shape == (PUBMED["num_nodes"], N_HIDDEN), "embedding shape")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "emb.dat")
        save_embeddings(path, "chip_smoke synthetic PubMed", emb)
        with open(path) as f:
            n_lines = sum(1 for _ in f)
    check(n_lines == PUBMED["num_nodes"] + 1, f"emb.dat has {n_lines} lines")
    print(f"train: {len(epochs)} epochs, {steps} steps, {n_req} export "
          f"requests in {wall:.1f} s wall; coverage {cov:.4f}, emb.dat "
          f"{n_lines} lines; launches {launches} (as counted: per step K1 "
          f"{K1_FWD} fwd + {K1_BWD} bwd, K2 {K2_FWD} fwd + {K2_BWD} bwd; "
          f"per export forward {N_LAYERS} each)")
    return launches, emb


# --- phase 4: serving -----------------------------------------------------

def run_export(model, graph, triplets, gbs, amp, seed, label):
    records = []
    start = dict(sk.LAUNCHES)

    def on_request(rec):
        launches = dict(sk.LAUNCHES)
        prev = records[-1]["launches"] if records else start
        for name in ("segment_sum_sorted:fwd", "gather_rows_sorted:fwd"):
            rise = launches.get(name, 0) - prev.get(name, 0)
            check(rise == N_LAYERS,
                  f"{name} launched {rise} times in one forward, "
                  f"expected n_layers={N_LAYERS}")
        rec["launches"] = launches
        records.append(rec)
        print(f"serve {label} request {rec['request']}: forward "
              f"{rec['forward_ms']:.3f} ms (CUDA events), host sampling "
              f"{rec['sample_ms']:.1f} ms, {rec['n_real']} edges, "
              f"{rec['n_nodes']} nodes, coverage {rec['coverage']:.4f}")

    emb, cov = export_embeddings(
        model, graph, triplets, gbs, rng=np.random.default_rng(seed),
        sampler="randomwalk", sample_depth=DEPTH, sample_width=WIDTH,
        graph_split_size=SPLIT, negative_rate=NEG, amp=amp,
        on_request=on_request, log=lambda s: print(f"serve {label}: {s}"))
    check(emb.shape == (graph.num_nodes, N_HIDDEN), "embedding shape")
    check(bool(np.isfinite(emb).all()), "non-finite embeddings")
    return emb, cov, records


# --- phases 7-10: the other backbones, attributes, supervised, evaluation --

def step_launches(model, sub, make_step) -> dict:
    """The kernel launches of one train step of a copy of `model`."""
    m = copy.deepcopy(model)
    step = make_step(m, make_unc_optimizer(m, LR, 100, GRAD_NORM))
    torch.cuda.synchronize()
    sk.reset_launch_counts()
    step(sub)
    torch.cuda.synchronize()
    return dict(sk.LAUNCHES)


def profile_step(model, sub, label) -> dict:
    """An f32 train step of a copy of `model`: torch.profiler device ms
    (3 steps) with K1's and K2's shares, and CUDA-event ms (median of
    5)."""
    m = copy.deepcopy(model)
    step = make_unc_train_step(m, make_unc_optimizer(m, LR, 100, GRAD_NORM))
    step(sub)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(3):
            step(sub)
        torch.cuda.synchronize()
    events = kernel_bench.device_events(prof)
    total = kernel_bench.per_call_us(events, 3) / 1e3
    k1 = kernel_bench.per_call_us(
        [e for e in events if "segment_sum" in e.key], 3) / 1e3
    k2 = kernel_bench.per_call_us(
        [e for e in events if "gather_rows_sorted" in e.key], 3) / 1e3
    step_ms = kernel_bench.cuda_median_ms(lambda: step(sub), 5, warmup=0)
    print(f"{label} profile f32: train step {step_ms:.3f} ms (CUDA events, "
          f"median of 5), {total:.3f} ms device time per step "
          f"(torch.profiler, 3 steps); K1 {k1:.3f} ms ({100 * k1 / total:.1f}"
          f" %), K2 {k2:.3f} ms ({100 * k2 / total:.1f} %)")
    for e in sorted(events, key=kernel_bench.device_us, reverse=True)[:6]:
        ms = kernel_bench.per_call_us([e], 3) / 1e3
        print(f"{label} profile f32:   {ms:8.4f} ms {100 * ms / total:5.1f} "
              f"% x{e.count // 3:<4d} {e.key[:90]}")
    return dict(step_ms=step_ms, device_ms=total, k1_ms=k1, k2_ms=k2)


def epoch_line(label):
    def on_epoch(rec):
        steps = [ms for ms in rec["step_ms"] if ms is not None] or [0.0]
        print(f"{label} epoch {rec['epoch']}: loss {rec['loss']:.6f}, "
              f"{rec['steps']} steps, step {statistics.median(steps):.3f} ms "
              f"median ({min(steps):.3f}-{max(steps):.3f}, CUDA events)"
              + (f", epoch {rec['wall_ms']:.1f} ms wall" if "wall_ms" in rec
                 else ""))
    return on_epoch


def phase_backbones(graph, triplets, seed, dev) -> dict:
    """Phase 7: each other backbone's gradients, launches, step profile
    and a reduced train_unc with its export."""
    out = {}
    sub = to_device(train_batch(graph, triplets, seed), dev)
    n_req = -(-BACKBONE_LINKS // (4 * GBS))
    for i, backbone in enumerate(("CompGCN", "RGCN", "RGIN")):
        label = f"backbone {backbone}"
        model = make_model(PUBMED["num_nodes"], PUBMED["num_rels"],
                           seed + 10 + i, dropout=0.0, backbone=backbone)
        worst = phase_train_grads(model, graph, triplets, seed, dev,
                                  label=f"{label} grads")
        model = model.to(dev)
        per_step = BACKBONE_STEP_LAUNCHES[backbone]
        got = step_launches(model, sub, make_unc_train_step)
        check(got == per_step, f"{label}: one step launched {got}, "
              f"expected {per_step}")
        prof = profile_step(model, sub, label)
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        epochs = []
        on_epoch = epoch_line(label)
        emb, cov = train_unc(
            model, triplets[:BACKBONE_LINKS], PUBMED["num_nodes"],
            PUBMED["num_rels"], lr=LR, negative_rate=NEG,
            graph_batch_size=GBS, graph_split_size=SPLIT,
            sampler="randomwalk", sample_depth=DEPTH, sample_width=WIDTH,
            n_epochs=1, grad_norm=GRAD_NORM, seed=seed + i,
            on_epoch=lambda rec: (epochs.append(rec), on_epoch(rec)),
            log=lambda msg: None)
        launches = dict(sk.LAUNCHES)
        steps = sum(rec["steps"] for rec in epochs)
        fwd = per_step["segment_sum_sorted:fwd"]
        want = {k: v * steps for k, v in per_step.items()}
        want["segment_sum_sorted:fwd"] = fwd * (steps + n_req)
        check(launches == want, f"{label} train_unc launched {launches}, "
              f"expected {want} for {steps} steps and {n_req} export "
              "forwards")
        check(all(np.isfinite(rec["losses"]).all() for rec in epochs)
              and bool(np.isfinite(emb).all()), f"{label}: non-finite")
        print(f"{label} train_unc: {len(epochs)} epochs, {steps} steps, "
              f"{n_req} export requests in {time.perf_counter() - t0:.1f} s "
              f"wall, coverage {cov:.4f}; launches {launches} (per step "
              f"{per_step}; per export forward K1 {fwd})")
        out[backbone] = dict(worst=worst, launches_step=got,
                             launches_run=launches, **prof)
        del model
    return out


def attributes(num_nodes: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(
        size=(num_nodes, ATTR_WIDTH)).astype(np.float32)


def phase_attributed(graph, triplets, seed, dev) -> dict:
    """Phase 8: DMPNN over a frozen attribute table."""
    model = make_model(PUBMED["num_nodes"], PUBMED["num_rels"], seed,
                       node_attri=attributes(PUBMED["num_nodes"], seed))
    worst = phase_train_grads(model, graph, triplets, seed, dev,
                              label="attributed DMPNN grads")
    sub = to_device(train_batch(graph, triplets, seed), dev)
    got = step_launches(model.to(dev), sub, make_unc_train_step)
    check(got == DMPNN_STEP_LAUNCHES, f"attributed DMPNN: one step launched "
          f"{got}, expected {DMPNN_STEP_LAUNCHES}")
    print(f"attributed DMPNN: {ATTR_WIDTH}-wide attributes, one step "
          f"launches {got}")
    return dict(worst=worst, launches_step=got)


def synthetic_labels(triplets, rng, multi: bool):
    """SUP_LABELED labeled nodes among the first SUP_LINKS links'
    endpoints -> (train_indices, train_labels) as unc/data.py's
    load_supervised and load_label build them."""
    links = triplets[:SUP_LINKS]
    pool = np.unique(links[:, [0, 2]])
    labeled = set(rng.choice(pool, SUP_LABELED, replace=False).tolist())
    indices = {}
    for i, (a, _, b) in enumerate(links.tolist()):
        if a in labeled:
            indices.setdefault(a, []).append(i)
        if b in labeled:
            indices.setdefault(b, []).append(i)
    if multi:
        labels = {v: np.unique(rng.integers(0, SUP_CLASSES,
                                            rng.integers(1, 4)))
                  for v in indices}
    else:
        labels = {v: int(rng.integers(0, SUP_CLASSES)) for v in indices}
    return links, indices, labels


def phase_supervised(graph, triplets, seed, dev) -> dict:
    """Phase 9: one supervised batch on the card against the CPU, then
    train_unc_supervised for one epoch, single- and multi-label."""
    out = {}
    for multi in (False, True):
        label = f"supervised {'multi' if multi else 'single'}-label"
        rng = np.random.default_rng(seed + int(multi))
        links, indices, labels = synthetic_labels(triplets, rng, multi)
        model = make_model(PUBMED["num_nodes"], PUBMED["num_rels"],
                           seed + int(multi), nlabel=SUP_CLASSES,
                           multi=multi)
        v = PUBMED["num_nodes"]
        padded, ml, mi, mm = sample_supervised_batch(
            graph, links, links[:GBS], indices, labels, SUP_CLASSES, multi,
            SUP_LABEL_BATCH, "randomwalk", DEPTH, WIDTH, SPLIT, v,
            min(v * WIDTH, graph.num_edges), np.random.default_rng(seed))
        padded = sk.attach_csr_plan(padded, sender_plan=True)

        def loss_fn(m, amp):
            m = copy.deepcopy(m)
            dev_of = next(m.parameters()).device
            sub = to_device(padded, dev_of)
            t = lambda a: torch.from_numpy(a).to(dev_of)  # noqa: E731
            out_, pred = apply_unc_supervised_forward(m, sub, amp=amp,
                                                      train=True)
            loss = m.supervised_loss(out_, sub["edge_type"],
                                     sub["edge_mask"], pred, t(ml), t(mi),
                                     t(mm), multi)
            loss.backward()
            return loss.item(), {k: p.grad.detach().float().cpu()
                                 for k, p in m.named_parameters()}

        print(f"{label}: {len(indices)} labeled nodes, batch n_real "
              f"{padded['n_real']}, {int(mm.sum())} matched labels")
        worst = phase_train_grads(model, graph, triplets, seed, dev,
                                  label=f"{label} grads", loss_fn=loss_fn,
                                  amps=(False,))
        model = model.to(dev)
        sk.reset_launch_counts()
        epochs = []
        on_epoch = epoch_line(label)
        t0 = time.perf_counter()
        train_unc_supervised(
            model, links, PUBMED["num_nodes"], PUBMED["num_rels"], indices,
            labels, multi=multi, lr=LR, graph_batch_size=GBS,
            label_batch_size=SUP_LABEL_BATCH, graph_split_size=SPLIT,
            sampler="randomwalk", sample_depth=DEPTH, sample_width=WIDTH,
            n_epochs=1, grad_norm=GRAD_NORM, seed=seed,
            on_epoch=lambda rec: (epochs.append(rec), on_epoch(rec)),
            log=lambda msg: None)
        launches = dict(sk.LAUNCHES)
        steps = sum(rec["steps"] for rec in epochs)
        want = {k: n * steps for k, n in DMPNN_STEP_LAUNCHES.items()}
        check(launches == want, f"{label}: launched {launches}, expected "
              f"{want} for {steps} steps")
        check(all(np.isfinite(rec["losses"]).all() for rec in epochs),
              f"{label}: non-finite loss")
        print(f"{label} train_unc_supervised: {steps} steps in "
              f"{time.perf_counter() - t0:.1f} s wall, losses "
              f"{[round(x, 6) for rec in epochs for x in rec['losses']]}; "
              f"launches {launches}")
        out["multi" if multi else "single"] = dict(
            worst=worst, launches_run=launches, labels=labels,
            step_ms=[ms for rec in epochs for ms in rec["step_ms"]])
        del model
    return out


def phase_evaluate(emb, triplets, labeled, seed) -> dict:
    """Phase 10: the UNC evaluation of phase 5's embeddings; `labeled`
    maps node -> class (phase 9's single-label labels)."""
    rng = np.random.default_rng(seed)
    n = len(emb)
    nodes = np.asarray(list(labeled)[:EVAL_NODES])
    labels = np.asarray([labeled[v] for v in nodes.tolist()])
    t0 = time.perf_counter()
    macro, micro = evaluate.nc_evaluate_arrays(emb, nodes, labels)
    nc_s = time.perf_counter() - t0
    seeds = rng.choice(np.unique(triplets[:, 0]), LP_SEEDS, replace=False)
    first = {}
    for a, _, b in triplets.tolist():
        first.setdefault(a, b)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "link.dat.test")
        with open(path, "w") as f:
            for s_ in seeds.tolist():
                f.write(f"{s_}\t{first[s_]}\t1\n")
                for o in rng.choice(n, LP_NEG, replace=False).tolist():
                    f.write(f"{s_}\t{o}\t0\n")
        emb_dict = {str(i): emb[i] for i in range(n)}
        t0 = time.perf_counter()
        auc, mrr = evaluate.lp_evaluate(path, emb_dict)
        lp_s = time.perf_counter() - t0
    scores = {"Macro-F1": macro, "Micro-F1": micro, "AUC": auc, "MRR": mrr}
    check(all(0.0 <= v <= 1.0 for v in scores.values()),
          f"evaluation scores outside [0, 1]: {scores}")
    print(f"evaluate nc: {len(nodes)} nodes, {SUP_CLASSES} synthetic "
          f"classes, 5-fold LinearSVC: Macro-F1 {macro:.4f}, Micro-F1 "
          f"{micro:.4f}, {nc_s:.2f} s")
    print(f"evaluate lp: {LP_SEEDS} seed nodes x (1 + {LP_NEG}) test links: "
          f"AUC {auc:.4f}, MRR {mrr:.4f}, {lp_s:.2f} s")
    return dict(nc_s=nc_s, lp_s=lp_s, **scores)


# --- phase 11: the SCM flagship ------------------------------------------

def scm_flagship_config() -> ModelConfig:
    """__graft_entry__.py:_flagship_config (39-53), which bench.py:116
    trains, as dryrun.py copies it: the Complex-dataset envelope,
    pattern <= 8V/8E, graph <= 64V/256E, 16 labels, reversed edges
    doubling E and the edge labels; hid 64, 3 layers, ScalarFilter,
    SumPredictNet, nodeedge."""
    return _flagship_config()


def scm_make_batch(bsz, pv, pe, gv, ge, nvl, nel, seed=0, lrp_seq_len=0,
                   edgeseq=False):
    """__graft_entry__.py:_make_batch with the port's graph builders:
    random pattern/graph pairs with reversed edges, the same draws; with
    lrp_seq_len > 0, LRP batches (each record's perm tables at the
    batch's largest perm count, data/dataset.batchify_lrp's); with
    edgeseq, EdgeSeq batches (data/dataset.batchify_edgeseq's)."""
    rng = np.random.default_rng(seed)
    pats, gras = [], []
    for _ in range(bsz):
        p = single_graph(
            pv, rng.integers(0, pv, pe), rng.integers(0, pv, pe),
            node_labels=rng.integers(0, nvl, pv),
            edge_labels=rng.integers(0, nel, pe), v_max=pv, e_max=pe)
        g = single_graph(
            gv, rng.integers(0, gv, ge), rng.integers(0, gv, ge),
            node_labels=rng.integers(0, nvl, gv),
            edge_labels=rng.integers(0, nel, ge), v_max=gv, e_max=ge)
        pats.append(add_reversed_edges(p, nel))
        gras.append(add_reversed_edges(g, nel))
    if edgeseq:
        return tuple(batch_edgeseqs([record_to_edgeseq(r) for r in recs])
                     for recs in (pats, gras))
    if not lrp_seq_len:
        return batch_graphs(pats), batch_graphs(gras)

    def lift(recs):
        p_max = max(count_perms(r, lrp_seq_len) for r in recs) or 1
        return lrp_batch(batch_graphs(recs), [
            {k: a for k, a in record_to_lrp_perms(
                r, lrp_seq_len, p_max).items() if k != "n_perm"}
            for r in recs])
    return lift(pats), lift(gras)


def scm_batch(bsz, seed, cfg=None):
    """A flagship batch and its targets (counts as bench.py draws them,
    node and edge weights), on the CPU; LRP or EdgeSeq batches where
    cfg's rep_net needs them."""
    net = cfg.rep_net if cfg is not None else None
    lrp = cfg.lrp_seq_len if net in LRP_NETS else 0
    pattern, graph = scm_make_batch(bsz, 8, 8, 64, 256, 16, 16, seed=seed,
                                    lrp_seq_len=lrp,
                                    edgeseq=net in SEQ_NETS)
    rng = np.random.default_rng(seed + 1)
    t = lambda a: torch.from_numpy(a.astype(np.float32))  # noqa: E731
    return (pattern, graph, t(rng.poisson(4.0, (bsz, 1))),
            t(rng.poisson(1.0, (bsz, 64))), t(rng.poisson(1.0, (bsz, 512))))


def scm_model(cfg, seed):
    """The flagship model from the seed, every weight moved by N(0, 0.02)
    so the zero-initialised heads carry signal; on the CPU."""
    model = build_model(cfg, device="cpu", seed=seed)
    gen = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for p in model.parameters():
            p.add_(0.02 * torch.randn(p.shape, generator=gen))
    return model


def scm_k3_shapes(dev, seed) -> dict:
    """K3 against its plain version at the flagship train step's shapes
    (bsz 128: V = 8,192 node rows, E = 65,536 edge rows, the batch's own
    flat receivers), H = 64 and 128 (the aggregation and the endpoint
    gathers' backward), f32 and bf16; each timed beside its plain version,
    one index_add_ and its HBM bound."""
    _, graph = scm_make_batch(SCM_BSZ, 8, 8, 64, 256, 16, 16, seed=seed)
    flat = scm_ops.flat_index(graph.receivers, 64, graph.edge_mask).to(dev)
    rng = np.random.default_rng(seed)
    return {(str(dtype)[6:], h): k3_timed("SCM", flat, SCM_BSZ * 64, h,
                                          dtype, dev, rng)
            for h in (64, 128) for dtype in (torch.float32, torch.bfloat16)}


def k3_timed(label, flat, rows, h, dtype, dev, rng) -> dict:
    """K3 at one call shape (flat receivers on the card, `rows` output
    rows, random H-wide messages): checked against its plain version
    within 2**-20 of each row's absolute sum, timed beside it, one
    index_add_ and its HBM bound (the real rows' messages read once, the
    index, the output written once)."""
    e = flat.numel()
    n_real = int((flat < rows).sum())
    msg = torch.from_numpy(rng.normal(size=(e, h)).astype(np.float32)).to(
        dev, dtype)
    name = str(dtype)[6:]
    with torch.inference_mode():
        abs_sum = sc.segment_sum_unsorted_plain(msg.float().abs(), flat,
                                                rows)
        err = check_sum(f"K3 {label} {dtype} H={h}",
                        sc.segment_sum_unsorted(msg, flat, rows),
                        sc.segment_sum_unsorted_plain(msg, flat, rows),
                        abs_sum)
        nbytes = n_real * h * msg.element_size() + e * 8 + rows * h * 4
        res = dict(err=err, bound_ms=hbm_ms(nbytes), **timed_pair(
            f"{name}: K3 {label} V={rows} E={e} H={h}",
            lambda: sc.segment_sum_unsorted(msg, flat, rows),
            lambda: sc.segment_sum_unsorted_plain(msg, flat, rows),
            f" (max abs err {err:.3e})"))
        # index_add_ raises on the dropped rows' index: it gets the rest
        keep = flat < rows
        flat_k, msg_k = flat[keep], msg[keep]
        res["library_ms"], res["library_device_ms"] = \
            kernel_bench.time_call(lambda: torch.zeros(
                rows, h, dtype=dtype, device=dev).index_add_(
                    0, flat_k, msg_k), 30)
    print(f"timing {name}: K3 {label} H={h}: bound "
          f"{res['bound_ms']:.4f} ms ({nbytes / 1e6:.1f} MB), "
          f"{100 * res['bound_ms'] / res['device_ms']:.1f} % of "
          f"it by device time; index_add_ "
          f"{res['library_ms']:.4f} ms event, "
          f"{res['library_device_ms']:.4f} ms device")
    return res


def k3_dict(n: int) -> dict:
    """The launch counts of n K3 launches (no entry for none)."""
    return {"segment_sum_unsorted": n} if n else {}


def scm_loss_and_grads(model, batch, amp):
    """Outputs (pred_c/v/e on the CPU), the loss and float32 CPU
    gradients of one train-mode forward and backward of `model`, and the
    K3 launches it made."""
    pattern, graph, counts, nw, ew = batch
    # the edge targets at the predictions' length (CNN pools), as the
    # train step refines them
    ew = scm_driver.refine_weights(model, "edge", ew)
    sk.reset_launch_counts()
    out = scm_driver.apply_model(model, pattern, graph, amp=amp, train=True)
    losses = scm_loss(out, counts, nw, ew, **SCM_LOSS)
    losses["total"].backward()
    launches = dict(sk.LAUNCHES)
    preds = {k: out[k].detach().float().cpu() for k in
             ("pred_c", "pred_v", "pred_e") if out[k] is not None}
    grads = {k: p.grad.detach().float().cpu()
             for k, p in model.named_parameters()}
    model.zero_grad(set_to_none=True)
    return preds, losses["total"].item(), grads, launches


PRED_NET_ATTRS = ("pred_net", "pred_net_v", "pred_net_e")


@contextlib.contextmanager
def pred_net_inputs(model, feed=None, dtype=None):
    """Within it, each predict net of `model` (its attributes of
    PRED_NET_ATTRS) records the floating inputs of its call (the
    pattern's and the graph's rows, float64 copies on the CPU) in the
    yielded dict under "<attribute>.<position>"; with `feed` (such a
    dict) it takes those instead of its own, on their device and in
    `dtype` (default: its own inputs' dtype)."""
    seen, hooks = {}, []

    def pre(name):
        def hook(module, args):
            args = list(args)
            for i, a in enumerate(args):
                if torch.is_tensor(a) and a.is_floating_point():
                    key = f"{name}.{i}"
                    if feed is not None:
                        args[i] = feed[key].to(device=a.device,
                                               dtype=dtype or a.dtype)
                    seen[key] = args[i].detach().double().cpu()
            return tuple(args)
        return hook

    for name in PRED_NET_ATTRS:
        if getattr(model, name, None) is not None:
            hooks.append(getattr(model, name).register_forward_pre_hook(
                pre(name)))
    try:
        yield seen
    finally:
        for h in hooks:
            h.remove()


def scm_outputs_from(cfg, model, batch, feed, dtype=torch.float32) -> dict:
    """pred_c/v/e (float64, on the CPU) of a train-mode forward in
    `dtype` of a copy of `model` (on the CPU) whose predict nets take the
    inputs `feed` (pred_net_inputs') in place of their own."""
    m = copy.deepcopy(model).to(dtype)
    pattern, graph = batch[:2]
    # EdgeSeqModel rounds its parameters for any dtype but float32
    kw = ({"params_rounded": True}
          if cfg.rep_net in SEQ_NETS and dtype != torch.float32 else {})
    with torch.no_grad(), pred_net_inputs(m, feed):
        out = m(pattern, graph, train=True, dtype=dtype, **kw)
    return {k: out[k].double() for k in ("pred_c", "pred_v", "pred_e")
            if out[k] is not None}


def scm_card_outputs_f64(card, batch, feed) -> dict:
    """pred_c/v/e (float64, on the CPU) of a train-mode forward of a copy
    of the card's model whose predict nets run in float64 on the card,
    fed `feed` (the card's float32 inputs to them) in float64; the rest
    of the model runs in float32 (K3 has no float64 build)."""
    m = copy.deepcopy(card)
    for name in PRED_NET_ATTRS:
        if getattr(m, name, None) is not None:
            getattr(m, name).double()
    pattern, graph = batch[:2]
    with torch.no_grad(), pred_net_inputs(m, feed, torch.float64):
        out = m(pattern, graph, train=True, dtype=torch.float32)
    return {k: out[k].double().cpu() for k in ("pred_c", "pred_v", "pred_e")
            if out[k] is not None}


def scm_f64_errors(cfg, model, batch, f32, f32_inputs) -> dict:
    """The CPU's own float32 error: per output (pred_c/v/e), the loss
    ("loss"), per gradient and per predict net's input (f32_inputs, the
    CPU's, pred_net_inputs' keys), the largest distance of the CPU's
    float32 result (`f32`, scm_loss_and_grads') to a float64 run of the
    same model and batch on the CPU (BatchNorm keeps its statistics in
    float32)."""
    m = copy.deepcopy(model).double()
    pattern, graph, counts, nw, ew = batch
    ew = scm_driver.refine_weights(m, "edge", ew)
    # EdgeSeqModel rounds its parameters for any dtype but float32
    kw = {"params_rounded": True} if cfg.rep_net in SEQ_NETS else {}
    with pred_net_inputs(m) as inputs:
        out = m(pattern, graph, train=True, dtype=torch.float64, **kw)
    losses = scm_loss(out, counts.double(), nw.double(), ew.double(),
                      **SCM_LOSS)
    losses["total"].backward()
    preds, loss, grads, _ = f32
    own = {k: (preds[k].double() - out[k].detach()).abs().max().item()
           for k in preds}
    own.update({k: (grads[k].double() - p.grad).abs().max().item()
                for k, p in m.named_parameters()})
    own.update({k: (f32_inputs[k] - inputs[k]).abs().max().item()
                for k in f32_inputs})
    own["loss"] = abs(loss - losses["total"].item())
    return own


def scm_card_vs_cpu(cfg, dev, seed, bsz=SCM_BSZ,
                    amps=(False, True), f64_slack: bool = False) -> dict:
    """One flagship batch (bsz 128) on the card and on the CPU, f32 and
    (amps) amp bf16: pred_c/pred_v/pred_e, the loss and every gradient; K3's
    launches of the card's forward and backward against the derived
    count. The amp loss: the flagship's (DMPNN, SumPredictNet) within
    1e-3 relative of the CPU's; the other networks' and predict nets'
    under the amp rule of the gradients (phase 5's:
    TRAIN_AMP_FACTOR times the CPU amp loss's distance to the CPU f32
    loss, plus 2**-8 of it): CompGCN's amp loss at the flagship width
    sits ~1 % below its f32 loss on the card and on the CPU alike, and
    2.6e-3 apart (bsz 16 on an NVIDIA H100 80GB HBM3: 178.18 on the card,
    178.65 on the CPU, 180.04 in f32), and SumAttnPredictNet's over DMPNN
    ~12 % above it and 0.45 % apart (9.964e9 on the card, 1.0009e10 on
    the CPU, 8.905e9 in f32). With f64_slack the loss's and each
    gradient's f32 bound grows by twice the CPU's own float32 error on
    that tensor (scm_f64_errors), and the outputs are held in two
    stages: the predict nets' inputs on the card against the CPU's, under
    the outputs' rule so widened, and the card's outputs against the
    CPU's model whose predict nets take the card's inputs
    (scm_outputs_from), the bound widened by each device's own float32
    error there: the CPU's against a float64 run of it, the card's
    against a float64 run of the card's predict nets on the same inputs
    (scm_card_outputs_f64). |card - CPU| <= |card - f64| + |f64 - CPU|;
    what the check still holds is that the two float64 runs agree within
    SCM_F32_OUT_REL of the output's scale. (The whole model has no
    float64 run on the card: K3 has no float64 build.) Before: twice the
    CPU's own error; DIAMNet circular_lstm's pred_v sat at 0.79-0.92 of
    that, since cuDNN's float32 LSTM is ~10x further from float64 than
    the CPU's and torch's native CUDA LSTM (lstm_f64_errors). The
    attention nets' sparsemax
    weights are differences of large scores, so a predict net turns its
    inputs' last-bit differences into ~1e-4 of its output: over DMPNN at
    phase 16's seed (bsz 16, NVIDIA H100 80GB HBM3, 700 W) the card's
    MaxAttnPredictNet inputs sat at 0.006-0.007 of their bound, yet the
    CPU's own predict nets fed them moved its outputs by 0.57-0.82 of the
    end-to-end bound, and the card's outputs stood at 0.58-1.07 of it.
    Those end-to-end shares are printed, not held."""
    batch = scm_batch(bsz, seed, cfg)
    model = scm_model(cfg, seed)
    card = copy.deepcopy(model).to(dev)
    dev_batch = [x.to(dev) for x in batch]
    res, inputs, own_fed = {}, {}, {}
    for amp in amps:
        with pred_net_inputs(model) as cpu_in:
            res[("cpu", amp)] = scm_loss_and_grads(model, batch, amp)
        with pred_net_inputs(card) as card_in:
            res[("card", amp)] = scm_loss_and_grads(card, dev_batch, amp)
        torch.cuda.synchronize()
        if not amp:
            inputs = dict(cpu=cpu_in, card=card_in)
    want_launches = k3_dict(k3_launches(cfg, train=True))
    flagship = (cfg.rep_net, cfg.pred_net) == ("DMPNN", "SumPredictNet")
    f32_out, f32_loss, f32_grads, _ = res[("cpu", False)]
    own, staged, in_ratio, in_worst = {}, "", 0.0, None
    # the f32 outputs' reference
    out_ref = f32_out
    if f64_slack:
        own = scm_f64_errors(cfg, model, batch, res[("cpu", False)],
                             inputs["cpu"])
        out_ref = scm_outputs_from(cfg, model, batch, inputs["card"])
        # each device's own float32 error on the predict nets fed the
        # card's inputs: the CPU's against its float64 run, the card's
        # against the card's float64 run of its predict nets
        cpu64 = scm_outputs_from(cfg, model, batch, inputs["card"],
                                 torch.float64)
        card64 = scm_card_outputs_f64(card, dev_batch, inputs["card"])
        card32 = res[("card", False)][0]
        own_fed = {k: (out_ref[k] - cpu64[k]).abs().max().item()
                   + (card32[k].double() - card64[k]).abs().max().item()
                   for k in out_ref}
        for k, cpu in inputs["cpu"].items():
            err = (inputs["card"][k] - cpu).abs().max().item()
            bound = SCM_F32_OUT_REL * cpu.abs().max().item() + 2 * own[k]
            check(err <= bound, f"SCM f32 {k} (a predict net's input): "
                  f"card err {err:.3e} exceeds {bound:.3e}")
            if bound and err / bound >= in_ratio:
                in_ratio, in_worst = err / bound, k

        def e2e(out):
            """out's worst share of the end-to-end bound."""
            shares = [0.0]
            for k, ref in f32_out.items():
                bound = SCM_F32_OUT_REL * ref.abs().max().item() + 2 * own[k]
                if bound:
                    shares.append(
                        (out[k].double() - ref).abs().max().item() / bound)
            return max(shares)
        staged = (f"; predict nets' inputs at {in_ratio:.3f} of their "
                  f"bound; of the end-to-end bound (not held): the card's "
                  f"outputs {e2e(res[('card', False)][0]):.3f}, the CPU's "
                  f"fed the card's inputs {e2e(out_ref):.3f}")
        rel = {k: own[k] / max(f32_out[k].abs().max().item(), 1e-30)
               for k in f32_out}
        rel["loss"] = own["loss"] / max(abs(f32_loss), 1e-30)
        g_rel = max(own[k] / max(f32_grads[k].abs().max().item(), 1e-30)
                    for k in f32_grads)
        print(f"scm {cfg.rep_net} {cfg.pred_net} cpu f32 against f64, of "
              "each tensor's largest magnitude: " + ", ".join(
                  f"{k} {v:.3e}" for k, v in rel.items())
              + f"; gradients up to {g_rel:.3e}")
    gmax = max(g.abs().max().item() for g in f32_grads.values())
    worst = {}
    for amp in amps:
        (po, lc, gc, lcpu), (pd, ld, gd, lcard) = res[("cpu", amp)], \
            res[("card", amp)]
        name = "amp bf16" if amp else "f32"
        check(lcpu == {} and lcard == want_launches,
              f"SCM {name}: K3 launched {lcard} on the card, expected "
              f"{want_launches}")
        if amp and not flagship:
            loss_bound = (TRAIN_AMP_FACTOR * abs(lc - f32_loss)
                          + 2.0 ** -8 * abs(f32_loss))
            loss_err = abs(ld - f32_loss)
        else:
            loss_bound = (1e-3 if amp else 1e-5) * abs(lc)
            loss_err = abs(ld - lc)
        if not amp:
            loss_bound += 2 * own.get("loss", 0.0)
        check(np.isfinite(ld) and loss_err <= loss_bound,
              f"SCM {cfg.rep_net} {name}: loss card {ld} vs cpu {lc} (cpu "
              f"f32 {f32_loss}): {loss_err:.4g} exceeds {loss_bound:.4g}")
        ratio, at = (0.0, None) if amp else (in_ratio, in_worst)
        for k in list(po) + list(gc):
            got, cpu = (pd[k], po[k]) if k in po else (gd[k], gc[k])
            ref = f32_out[k] if k in po else f32_grads[k]
            check(bool(torch.isfinite(got).all()), f"SCM {name}: non-finite "
                  f"{k}")
            scale = ref.abs().max().item()
            if amp:
                err = (got - ref).abs().max().item()
                bound = (TRAIN_AMP_FACTOR * (cpu - ref).abs().max().item()
                         + 2.0 ** -8 * scale)
            elif k in po:
                err = (got.double() - out_ref[k]).abs().max().item()
                bound = SCM_F32_OUT_REL * scale + own_fed.get(
                    k, 2 * own.get(k, 0.0))
                if f64_slack:
                    before = SCM_F32_OUT_REL * scale + 2 * own[k]
                    staged += (f"; {k} at {err / bound:.3f} of its bound "
                               f"(under the rule before it: "
                               f"{err / before:.3f})")
            else:
                err = (got - cpu).abs().max().item()
                bound = (TRAIN_F32_REL * scale + TRAIN_F32_GLOBAL * gmax
                         + 2 * own.get(k, 0.0))
            check(err <= bound, f"SCM {name} {k}: card err {err:.3e} "
                  f"exceeds {bound:.3e}")
            if bound and err / bound >= ratio:
                ratio, at = err / bound, k
        extra = "" if amp else staged
        if amp:
            def dist(a, b):
                return sum(((a[k] - b[k]) ** 2).sum().item()
                           for k in a) ** 0.5
            l2_card, l2_cpu = dist(gd, f32_grads), dist(gc, f32_grads)
            check(l2_card <= TRAIN_AMP_FACTOR * l2_cpu,
                  f"SCM amp gradient L2 distance {l2_card} vs cpu {l2_cpu}")
            extra = (f"; L2 to cpu f32: card {l2_card:.3e}, cpu amp "
                     f"{l2_cpu:.3e}")
        worst[name] = ratio
        deg = " pred_with_deg" if cfg.pred_with_deg else ""
        if cfg.pred_net != "SumPredictNet":
            deg += f" {cfg.pred_net}"
        if cfg.pred_net in MEM_NETS:
            deg += f" {cfg.pred_mem_init}"
        print(f"scm {cfg.rep_net}{deg} grads {name}: bsz {bsz}, loss card "
              f"{ld:.7f} cpu {lc:.7f}; {'/'.join(po)} and {len(gc)} "
              f"gradients within bound (worst at {ratio:.3f} of it, {at})"
              f"{extra}; "
              f"K3 launches {lcard}")
    return worst


def scm_profile(fn, calls=3):
    """torch.profiler over `calls` calls of fn: device ms per call and
    K3's ms per call."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = kernel_bench.device_events(prof)
    total = kernel_bench.per_call_us(events, calls) / 1e3
    k3 = kernel_bench.per_call_us(
        [e for e in events if "segment_sum_unsorted" in e.key], calls) / 1e3
    return total, k3, events


def kernel_share(events, calls, names) -> float:
    """Device ms per call of the kernels whose name holds one of `names`
    (lower case)."""
    return kernel_bench.per_call_us(
        [e for e in events if any(n in e.key.lower() for n in names)],
        calls) / 1e3


def scm_timing(cfg, dev, seed, train_bszs=(SCM_BSZ,),
               eval_bsz=SCM_INFER_BSZ, shares=(), profile=True) -> dict:
    """The flagship train step (make_train_step: auto ~128-pair chunks)
    at the bszs given (bsz 128), f32 and amp bf16, and the eval step at
    bsz 512:
    CUDA-event ms (median of 5 calls, wrapper and host work included),
    torch.profiler device ms with K3's share (and, per group of names in
    `shares`, that of the kernels whose names hold one of the group's),
    pairs/s and edges/s (real graph
    and pattern edges), each step's peak device memory; each step's K3
    launches against the derived count. An LRP batch's perm envelope
    (p_max, pattern and graph) is printed. profile=False leaves out
    torch.profiler (the device ms and shares): events, memory and
    launches only."""
    base = scm_model(cfg, seed)
    out = {}
    tag = "" if cfg.rep_net == "DMPNN" else f"{cfg.rep_net} "
    if cfg.pred_net != "SumPredictNet":
        tag += f"{cfg.pred_net} "
    if cfg.pred_net in MEM_NETS:
        tag += f"{cfg.pred_mem_init} "

    def share_of(events, dv, calls):
        extra, text = {}, ""
        for names in shares:
            ms = kernel_share(events, calls, names)
            extra["/".join(names) + "_ms"] = ms
            text += (f"; {'/'.join(names)} kernels {ms:.3f} ms "
                     f"({100 * ms / dv:.1f} %)")
        return extra, text
    for bsz in train_bszs:
        batch = [x.to(dev) for x in scm_batch(bsz, seed + bsz, cfg)]
        chunks = scm_driver.auto_chunks(bsz)
        if cfg.rep_net in LRP_NETS:
            print(f"scm {tag}bsz {bsz}: p_max pattern "
                  f"{batch[0].perm_node.shape[1]}, graph "
                  f"{batch[1].perm_node.shape[1]} perms a graph")
        for amp in (False, True):
            name = f"{tag}train bsz {bsz} {'amp bf16' if amp else 'f32'}"
            model = copy.deepcopy(base).to(dev)
            step = scm_driver.make_train_step(
                model, scm_driver.make_optimizer(model.parameters(), 1e-3),
                return_weights="nodeedge", amp=amp)

            def run():
                return step(*batch, 0.2, 0.1, 0.05, 1e-4)

            run()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            sk.reset_launch_counts()
            losses = run()
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
            want = chunks * k3_launches(cfg, train=True)
            check(dict(sk.LAUNCHES) == k3_dict(want),
                  f"SCM {name}: K3 launched {dict(sk.LAUNCHES)}, expected "
                  f"{want} ({chunks} chunks)")
            check(np.isfinite(losses["total"].item()), f"SCM {name}: loss")
            ev = kernel_bench.cuda_median_ms(run, 5, warmup=0)
            if not profile:
                out[name] = dict(event_ms=ev, pairs_s=bsz / ev * 1e3,
                                 chunks=chunks, peak_gib=peak)
                print(f"scm {name}: step {ev:.3f} ms (CUDA events, median "
                      f"of 5; not profiled); {chunks} chunks, {want} K3 "
                      f"launches per step; peak device memory {peak:.3f} "
                      "GiB")
                del model, step
                continue
            dv, k3, events = scm_profile(run)
            extra, text = share_of(events, dv, 3)
            out[name] = dict(event_ms=ev, device_ms=dv, k3_ms=k3,
                             pairs_s=bsz / ev * 1e3,
                             edges_s=bsz * SCM_EDGES_PER_PAIR / ev * 1e3,
                             device_edges_s=bsz * SCM_EDGES_PER_PAIR / dv
                             * 1e3, chunks=chunks, peak_gib=peak, **extra)
            print(f"scm {name}: step {ev:.3f} ms (CUDA events, median of 5"
                  f"), {dv:.3f} ms device time (torch.profiler, 3 steps), K3"
                  f" {k3:.3f} ms ({100 * k3 / dv:.1f} %){text}; {chunks} "
                  f"chunks, {want} K3 launches per step; "
                  f"{bsz / ev * 1e3:.0f} pairs/"
                  f"s, {bsz * SCM_EDGES_PER_PAIR / ev * 1e6:.4g} edges/s by "
                  f"events, {bsz * SCM_EDGES_PER_PAIR / dv * 1e6:.4g} by "
                  f"device time; peak device memory {peak:.3f} GiB")
            for e in sorted(events, key=kernel_bench.device_us,
                            reverse=True)[:5]:
                ms = kernel_bench.per_call_us([e], 3) / 1e3
                print(f"scm {name}:   {ms:8.4f} ms {100 * ms / dv:5.1f} % "
                      f"x{-(-e.count // 3):<5d} {e.key[:80]}")
            del model, step
        del batch
    pattern, graph, *_ = [x.to(dev) for x in scm_batch(eval_bsz, seed + 7,
                                                       cfg)]
    model = copy.deepcopy(base).to(dev)
    for amp in (False, True):
        name = f"{tag}eval bsz {eval_bsz} {'amp bf16' if amp else 'f32'}"
        eval_step = scm_driver.make_eval_step(model, amp=amp)
        eval_step(pattern, graph)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        sk.reset_launch_counts()
        pred_c = eval_step(pattern, graph)[0]
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated(dev) / 2 ** 30
        want = k3_launches(cfg, train=False)
        check(dict(sk.LAUNCHES) == k3_dict(want),
              f"SCM {name}: K3 launched {dict(sk.LAUNCHES)}, expected {want}")
        check(pred_c.shape == (eval_bsz, 1)
              and bool(torch.isfinite(pred_c).all()), f"SCM {name}: pred_c")
        ev = kernel_bench.cuda_median_ms(lambda: eval_step(pattern, graph),
                                         10, warmup=0)
        if not profile:
            out[name] = dict(event_ms=ev, samples_s=eval_bsz / ev * 1e3,
                             peak_gib=peak)
            print(f"scm {name}: forward {ev:.3f} ms (CUDA events, median of "
                  f"10; not profiled); {want} K3 launches; peak device "
                  f"memory {peak:.3f} GiB")
            continue
        dv, k3, events = scm_profile(lambda: eval_step(pattern, graph))
        extra, text = share_of(events, dv, 3)
        out[name] = dict(event_ms=ev, device_ms=dv, k3_ms=k3,
                         samples_s=eval_bsz / ev * 1e3, peak_gib=peak,
                         **extra)
        print(f"scm {name}: forward {ev:.3f} ms (CUDA events, median of 10)"
              f", {dv:.3f} ms device time, K3 {k3:.3f} ms "
              f"({100 * k3 / dv:.1f} %){text}; {eval_bsz / ev * 1e3:.0f} "
              f"samples/s by events, {eval_bsz / dv * 1e3:.0f} by device"
              f" time; peak device memory {peak:.3f} GiB")
    return out


def scm_learning_run(dev, seed) -> dict:
    """The user's SCM path on the card, counted from zero
    (bench/scm_learn_spread.learning_run): generate_dataset (an ER set at
    the scm_er_counting sizes, reversed edges added), the flagship's
    widths and options, BucketSampler, make_train_step and train_epoch
    for SCM_LEARN["epochs"] epochs under scm_train's default
    learning-rate schedule (derive_schedule_config), then make_eval_step
    and evaluate_epoch. The losses must be finite and fall; K3's launches
    must equal the derived count of the steps and eval forwards."""
    sk.reset_launch_counts()
    run = learn_spread.learning_run(dev, seed, log=print)
    launches = dict(sk.LAUNCHES)
    losses, results, steps = run["losses"], run["results"], run["steps"]
    want = (steps * scm_driver.auto_chunks(SCM_LEARN["bsz"])
            * k3_launches(learn_spread.learning_config(), True)
            + run["eval_batches"]
            * k3_launches(learn_spread.learning_config(), False))
    check(launches == {"segment_sum_unsorted": want},
          f"SCM learning run launched {launches}, expected K3 x {want}")
    check(learn_spread.falling(losses),
          f"SCM learning run: losses {losses} not finite and falling")
    scores = {k: results[k] for k in ("MAE", "MSE", "RMSE", "AUC", "MNED",
                                      "MEED")}
    check(all(np.isfinite(v) for v in scores.values()),
          f"SCM evaluation: {scores}")
    print(f"scm learn: {SCM_LEARN['n_train']} train / "
          f"{SCM_LEARN['n_dev']} dev ER pairs made in {run['gen_s']:.2f} s "
          f"({'native' if native.available() else 'numpy'} subiso); {steps} "
          f"steps and {run['eval_batches']} eval batches in "
          f"{run['seconds']:.1f} s; dev " + ", ".join(
              f"{k} {v:.4f}" for k, v in scores.items())
          + f"; eval forward {1e3 * results['time_avg']:.4f} ms per pair; "
          f"K3 launches {launches}")
    return dict(losses=losses, launches=launches, **scores)


def phase_scm(dev, seed) -> dict:
    """Phase 11: K3 at the SCM shapes, the flagship on the card against
    the CPU, the step and eval timings, and the learning run."""
    t0 = time.perf_counter()
    cfg = scm_flagship_config()
    out = {"k3": scm_k3_shapes(dev, seed)}
    out["worst"] = scm_card_vs_cpu(cfg, dev, seed + 1)
    out["timing"] = scm_timing(cfg, dev, seed + 2)
    out["learn"] = scm_learning_run(dev, seed + 3)
    out["step_launches"] = k3_launches(cfg, train=True)
    print(f"scm: phase 11 took {time.perf_counter() - t0:.1f} s")
    return out


def scm_cli_expected_k3(run_dir: str, evaluate: bool = False) -> int:
    """K3 launches of one scm_train run (evaluate=False) or of one
    scm_evaluate run of it, derived from its config.json and the code:
    each train step launches k3_launches(cfg, True) per chunk, each eval
    forward k3_launches(cfg, False); the train batches per epoch are the
    CLI's CurriculumSampler's (used_ratio rising over the warmup), the
    eval batches BucketSampler's over dev and test (and train, in
    scm_evaluate)."""
    config = json.load(open(os.path.join(run_dir, "config.json")))
    cfg = scm_config.to_model_config(scm_config.process_model_config(config))
    n = config["synthetic_pairs"]
    n_eval = {"train": n, "dev": max(n // 8, 1), "test": max(n // 8, 1)}
    ebsz = config["eval_batch_size"]

    def eval_batches(split):
        return len(BucketSampler([None] * n_eval[split], [], ebsz))

    fwd = k3_launches(cfg, train=False)
    if evaluate:
        return fwd * sum(eval_batches(k) for k in n_eval)
    bsz, epochs = config["train_batch_size"], config["train_epochs"]
    warmup = max(1, int(0.2 * epochs))
    steps = sum(len(CurriculumSampler(
        [None] * n, ["p_len", "g_len"], min(1.0, 0.5 + 0.5 * e / warmup),
        bsz, group_by=["g_len", "p_len"])) for e in range(epochs))
    return (steps * scm_driver.auto_chunks(bsz) * k3_launches(cfg, True)
            + epochs * fwd * (eval_batches("dev") + eval_batches("test")))


def scm_cli_run(label: str, argv, root: str) -> dict:
    """scm_train.main on the card with K3's launches counted from zero:
    -> its directory, launches, seconds, the log's epoch lines."""
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    run_dir = scm_train.main(argv + ["--save_model_dir",
                                     os.path.join(root, label)])
    wall = time.perf_counter() - t0
    launches = dict(sk.LAUNCHES)
    files = os.listdir(run_dir)
    config = json.load(open(os.path.join(run_dir, "config.json")))
    epochs = config["train_epochs"]
    for name in ["config.json", "log.txt"] + [
            f"{split}_results{e}.json" for split in ("dev", "test")
            for e in range(epochs)]:
        check(name in files, f"scm cli {label}: {name} not written")
    best = get_best_epochs(os.path.join(run_dir, "log.txt"))
    epoch = best["eval-" + config["eval_metric"]]["dev"][0]
    check(os.path.exists(os.path.join(run_dir, f"epoch{epoch}",
                                      "state.pt")),
          f"scm cli {label}: epoch{epoch}/ not written")
    want = scm_cli_expected_k3(run_dir)
    check(launches == k3_dict(want),
          f"scm cli {label}: launched {launches}, expected K3 x {want}")
    log = open(os.path.join(run_dir, "log.txt")).read()
    thr = [tuple(float(x) for x in m) for m in re.findall(
        r"train throughput: ([\d.]+) edges/s, ([\d.]+) pairs/s, "
        r"epoch ([\d.]+) s", log)]
    check(len(thr) == epochs, f"scm cli {label}: {len(thr)} epoch lines")
    dev = [json.load(open(os.path.join(run_dir, f"dev_results{e}.json")))
           for e in range(epochs)]
    # the sequence networks predict no node weights: their MNED is NaN
    scores = ("MAE", "MSE") + (() if config["rep_net"] in SEQ_NETS
                               else ("MNED",))
    for e, r in enumerate(dev):
        check(all(np.isfinite(r[k]) for k in scores),
              f"scm cli {label}: dev epoch {e} {r['MAE']}")
    eval_pps = [len(r["counts"]) / r["time_total"] for r in dev]
    print(f"scm cli {label}: {wall:.1f} s in all, best dev epoch {epoch}; "
          "per epoch " + "; ".join(
              f"{s:.3f} s, {pps:.1f} train pairs/s, {eps:.1f} eval pairs/s"
              f" (dev MAE {r['MAE']:.4f}, MNED {r['MNED']:.4f})"
              for (_, pps, s), eps, r in zip(thr, eval_pps, dev))
          + f"; K3 launches {launches} (derived {want})")
    return dict(dir=run_dir, launches=launches, best_epoch=epoch,
                dev=dev, seconds=wall)


def phase_scm_cli(seed: int) -> dict:
    """Phase 12: the reference's ER command line through cli/scm_train on
    the card (a synthetic set, SCM_CLI_EPOCHS epochs), a finetune of it
    onto a larger vertex-label vocabulary (expand_params), a dual-graph
    run, and cli/scm_evaluate of the first run: each run's files, K3's
    launches against the derived count, and scm_evaluate's best-epoch dev
    metrics against the training run's within SCM_EVAL_REL / _AUC."""
    t0 = time.perf_counter()
    root = tempfile.mkdtemp(prefix="scm_cli_")
    base = SCM_CLI_ER + ["--synthetic", "True", "--synthetic_pairs",
                         str(SCM_CLI_PAIRS), "--seed", str(seed)]
    runs = {"train": scm_cli_run("train", base + [
        "--train_epochs", str(SCM_CLI_EPOCHS),
        "--save_data_dir", os.path.join(root, "data_train")], root)}
    runs["finetune"] = scm_cli_run("finetune", base + [
        "--train_epochs", "1", "--max_ngvl", "2", "--max_npvl", "2",
        "--load_model_dir", runs["train"]["dir"]], root)
    check("finetuning from" in open(os.path.join(
        runs["finetune"]["dir"], "log.txt")).read(), "finetune did not load")
    runs["dual"] = scm_cli_run("dual", base + [
        "--train_epochs", "1", "--convert_dual", "True"], root)

    launches = scm_cli_evaluate("", runs["train"])
    print(f"scm cli: phase 12 took {time.perf_counter() - t0:.1f} s")
    paths = {f"scm_cli_{k}": v["launches"] for k, v in runs.items()}
    paths["scm_cli_evaluate"] = launches
    return paths, os.path.join(root, "data_train")


def scm_cli_evaluate(label: str, first: dict) -> dict:
    """cli/scm_evaluate.main on a scm_cli_run's directory, K3's launches
    counted from zero against the derived count, its files, and its
    best-epoch dev metrics against the training run's within
    SCM_EVAL_REL (AUC SCM_EVAL_AUC) -> the launches."""
    sk.reset_launch_counts()
    t1 = time.perf_counter()
    out = scm_evaluate.main(["--load_model_dir", first["dir"]])
    wall = time.perf_counter() - t1
    launches = dict(sk.LAUNCHES)
    want = scm_cli_expected_k3(first["dir"], evaluate=True)
    check(launches == k3_dict(want),
          f"scm_evaluate {label}launched {launches}, expected K3 x {want}")
    check(sum(f.startswith("eval_") and f.endswith(".json")
              for f in os.listdir(first["dir"])) == 3,
          f"scm_evaluate {label}results not written")
    logged = first["dev"][first["best_epoch"]]
    gaps = {}
    for k in ("MAE", "MSE", "RMSE", "MNED", "MEED", "AUC"):
        # NaN on both sides where the run has no such target (MEED with
        # --match_weights node; AUC with one count class)
        a, b = out["dev"][k], logged[k]
        if np.isnan(a) or np.isnan(b):
            gaps[k] = 0.0 if np.isnan(a) and np.isnan(b) else np.inf
        else:
            gaps[k] = abs(a - b) / (1.0 if k == "AUC" else max(abs(b), 1.0))
        check(gaps[k] <= (SCM_EVAL_AUC if k == "AUC" else SCM_EVAL_REL),
              f"scm_evaluate {label}dev {k} {a} vs the training log's {b}")
    n_pairs = sum(len(r["counts"]) for r in out.values())
    t_fwd = sum(r["time_total"] for r in out.values())
    print(f"scm cli {label}evaluate: {wall:.1f} s, {n_pairs} pairs, "
          f"{n_pairs / t_fwd:.1f} eval pairs/s (forwards); best-epoch dev "
          "against the training log: " + ", ".join(
              f"{k} {v:.3e}" for k, v in gaps.items())
          + f" (bounds {SCM_EVAL_REL:g} relative, AUC {SCM_EVAL_AUC:g}); "
          f"K3 launches {launches}")
    return launches


def scm_gate_expected_k3(result: dict) -> int:
    """K3 launches of a gates/scm_convergence run, from its result: the
    train steps of every epoch and the probe's, the eval forwards of the
    pre-training dev eval, each epoch's dev eval, the final test and
    train-fit evals and the probe's eval."""
    c = result["config"]
    cfg = scm_gate.family_model_config(scm_gate.family_spec(c["family"]),
                                       c["hid"])
    n_dev = max(c["pairs"] // 6, 8)
    n_train = c["pairs"] - 2 * n_dev
    epochs = len(result["trajectory"]) - 1
    steps = (epochs * len(BucketSampler([None] * n_train, [], c["bsz"]))
             * scm_driver.auto_chunks(c["bsz"]))
    probe = result["overfit_probe"]
    steps += probe["steps"] * scm_driver.auto_chunks(probe["pairs"])
    dev_batches = len(BucketSampler([None] * n_dev, [], c["bsz"]))
    forwards = (1 + epochs) * dev_batches + 2 * dev_batches + 1
    return (steps * k3_launches(cfg, True)
            + forwards * k3_launches(cfg, False))


def phase_gates(dev) -> dict:
    """Phase 13: gates/unc_convergence.run("smoke") (the assertions of
    tests/test_unc_quality.py:31-42) and gates/scm_convergence.run at
    SCM_GATE on the card, launches counted from zero around each; then
    the SCM gate at the other SCM_GATE_SEEDS, SCM_GATE_LIMITS held on the
    mean over the seeds."""
    t0 = time.perf_counter()
    sk.reset_launch_counts()
    unc = unc_gate.run("smoke", seed=0, supervised=True, device=dev,
                       log=lambda s: None)
    unc_launches = dict(sk.LAUNCHES)
    for block in ("trained", "untrained", "random"):
        for k in ("macro_f1", "micro_f1", "lp_auc", "lp_mrr"):
            check(bool(np.isfinite(unc[block][k])), f"unc gate {block} {k}")
    check(bool(np.isfinite(unc["supervised"]["macro_f1"])),
          "unc gate supervised macro_f1")
    check(unc["coverage"] > 0.9, f"unc gate coverage {unc['coverage']}")
    check(set(unc["gaps"]) == {"nc_macro_gap_vs_random",
                               "lp_auc_gap_vs_random",
                               "nc_macro_gap_vs_untrained"},
          f"unc gate gaps {unc['gaps']}")
    check(unc["platform"] == "cuda", f"unc gate ran on {unc['platform']}")
    for key in DMPNN_STEP_LAUNCHES:
        check(unc_launches.get(key, 0) > 0,
              f"unc gate: {key} never launched ({unc_launches})")
    print(f"gates: unc smoke {unc['train_seconds']} s train, "
          f"{unc['eval_seconds']} s eval; trained " + json.dumps(
              unc["trained"]) + f", gaps {json.dumps(unc['gaps'])}, "
          f"supervised {json.dumps(unc['supervised'])}; launches "
          f"{unc_launches}")

    sk.reset_launch_counts()
    scm = scm_gate.run(device=dev, log=lambda s: None, **SCM_GATE)
    scm_launches = dict(sk.LAUNCHES)
    want = scm_gate_expected_k3(scm)
    check(scm_launches == {"segment_sum_unsorted": want},
          f"scm gate launched {scm_launches}, expected K3 x {want}")
    ml = scm["matching_learned"]
    check(all(np.isfinite(v) for k, v in ml.items()
              if not isinstance(v, bool)), f"scm gate ratios {ml}")
    print(f"gates: scm er {scm['seconds']} s, {len(scm['trajectory']) - 1}"
          f" epochs, final {json.dumps(scm['final'])}")
    print("gates: scm er matching_learned " + json.dumps(ml))
    t1 = time.perf_counter()
    runs = [ml] + [scm_gate.run(device=dev, log=lambda s: None,
                                **dict(SCM_GATE, seed=seed))
                   ["matching_learned"] for seed in SCM_GATE_SEEDS[1:]]
    for seed, m in zip(SCM_GATE_SEEDS, runs):
        within = all(m[k] < v for k, v in SCM_GATE_LIMITS.items())
        print(f"gates: scm er seed {seed} dev MNED/MEED vs zero "
              f"{m['dev_MNED_vs_zero']}/{m['dev_MEED_vs_zero']} "
              f"{'within' if within else 'NOT within'} the limits")
    means = {k: float(np.mean([m[k] for m in runs])) for k in SCM_GATE_LIMITS}
    for k, limit in SCM_GATE_LIMITS.items():
        check(means[k] < limit, f"scm er gate: mean {k} {means[k]:.6f} over "
              f"seeds {list(SCM_GATE_SEEDS)}, limit {limit}")
    n_within = sum(all(m[k] < v for k, v in SCM_GATE_LIMITS.items())
                   for m in runs)
    print(f"gates: scm er over {len(runs)} seeds: mean dev ratios "
          f"{json.dumps(means)} (limits {json.dumps(SCM_GATE_LIMITS)}), "
          f"{n_within} single seeds within, "
          f"{time.perf_counter() - t1:.1f} s")
    print(f"gates: phase 13 took {time.perf_counter() - t0:.1f} s")
    return {"unc_gate_smoke": unc_launches, "scm_gate_er": scm_launches}


def scm_k3_net_shapes(dev, seed) -> dict:
    """K3 at its two call shapes new in phase 14, on a flagship LRP batch
    (bsz 128): the R-GCN/R-GIN relation fold, the graph's E edge rows
    into B*V*R rows at (b*V + receiver)*R + label (models/rgnn.
    relation_sums), and the LRP pool, the B*P perm rows into B*V rows at
    their owners (models/lrp.perm_mean_pool); H = 64, f32 and bf16."""
    cfg = scm_flagship_config().replace(rep_net="LRP")
    _, graph = scm_make_batch(SCM_BSZ, 8, 8, 64, 256, 16, 16, seed=seed,
                              lrp_seq_len=cfg.lrp_seq_len)
    r, v = cfg.max_ngel, cfg.max_ngv
    rel = graph.edge_label
    ok = graph.edge_mask & (rel < r)
    calls = {"rel_fold": (scm_ops.flat_index(graph.receivers * r + rel,
                                             v * r, ok), SCM_BSZ * v * r),
             "lrp_pool": (scm_ops.flat_index(graph.perm_owner, v,
                                             graph.perm_mask), SCM_BSZ * v)}
    rng = np.random.default_rng(seed)
    out = {}
    for name, (flat, rows) in calls.items():
        for dtype in (torch.float32, torch.bfloat16):
            out[(name, str(dtype)[6:])] = k3_timed(
                name.replace("_", " "), flat.to(dev), rows, 64, dtype, dev,
                rng)
    return out


def phase_scm_nets(dev, seed, data_dir) -> tuple:
    """Phase 14: K3 at the relation fold's and the LRP pool's shapes; then
    per SCM graph network at the flagship's configuration: a bsz-16 batch
    on the card and on the CPU (pred_c/pred_v/pred_e, the loss and every
    gradient, f32 and amp bf16, K3's launches against k3_launches), the
    train step at bsz 128 and the eval forward at 512 (events, device ms,
    K3's share, peak memory, LRP's perm envelope), and the reference's
    ER command line with its --rep_net for one epoch on phase 12's data
    (data_dir), then cli/scm_evaluate of it and, as phase 12, a finetune
    of it onto a 2-label vertex vocabulary; K3's launches counted from
    zero around each command -> (results, paths)."""
    t0 = time.perf_counter()
    out = {"k3": scm_k3_net_shapes(dev, seed)}
    paths = {}
    root = tempfile.mkdtemp(prefix="scm_nets_")
    cli = SCM_CLI_ER + ["--synthetic", "True", "--synthetic_pairs",
                        str(SCM_CLI_PAIRS), "--seed", str(seed),
                        "--train_epochs", "1", "--save_data_dir", data_dir]
    for i, net in enumerate(SCM_NETS):
        t1 = time.perf_counter()
        cfg = scm_flagship_config().replace(rep_net=net)
        worst = scm_card_vs_cpu(cfg, dev, seed + 10 * i, SCM_NET_CMP_BSZ)
        timing = scm_timing(cfg, dev, seed + 10 * i + 1,
                            train_bszs=(SCM_BSZ,),
                            profile=net not in UNPROFILED_NETS)
        paths.update(scm_net_cli(net, cli, root))
        out[net] = dict(worst=worst, timing=timing,
                        step_launches=k3_launches(cfg, train=True),
                        eval_launches=k3_launches(cfg, train=False))
        print(f"scm nets: {net} took {time.perf_counter() - t1:.1f} s; K3 "
              f"per train step {out[net]['step_launches']}, per eval "
              f"forward {out[net]['eval_launches']}")
    print(f"scm nets: phase 14 took {time.perf_counter() - t0:.1f} s")
    return out, paths


def scm_net_cli(net: str, cli, root: str, extra=()) -> dict:
    """The ER command line `cli` with --rep_net net for one epoch, then
    cli/scm_evaluate of it and, as phase 12, a finetune of it onto a
    2-label vertex vocabulary; K3's launches counted from zero around
    each command -> their paths."""
    paths = {}
    run = scm_cli_run(net, cli + ["--rep_net", net, *extra], root)
    paths[f"scm_cli_{net}"] = run["launches"]
    paths[f"scm_cli_{net}_evaluate"] = scm_cli_evaluate(f"{net} ", run)
    tune = scm_cli_run(f"{net}_finetune", cli[:-2] + [
        "--rep_net", net, *extra, "--max_ngvl", "2", "--max_npvl", "2",
        "--load_model_dir", run["dir"]], root)
    check("finetuning from" in open(os.path.join(
        tune["dir"], "log.txt")).read(), f"{net} finetune did not load")
    paths[f"scm_cli_{net}_finetune"] = tune["launches"]
    return paths


def scm_k3_deg_shape(dev, seed) -> dict:
    """K3 at the sequence networks' one call shape, pred_with_deg's
    degree tables at the train step's bsz 128: the graph's 65,536 tuple
    rows, one column, into 128 x 64 node rows at their u (the
    out-degrees), the batch's own flat index; f32, the tables' dtype."""
    _, graph = scm_make_batch(SCM_BSZ, 8, 8, 64, 256, 16, 16, seed=seed,
                              edgeseq=True)
    flat = scm_ops.flat_index(graph.u, graph.num_nodes, graph.mask)
    return k3_timed("edgeseq degrees", flat.to(dev),
                    SCM_BSZ * graph.num_nodes, 1, torch.float32, dev,
                    np.random.default_rng(seed))


def scm_deg_step(cfg, dev, seed) -> tuple:
    """cfg has pred_with_deg. On the train step's batch (bsz 128): the
    pattern's and the graph's degree tables on the card (K3) equal the
    CPU's (integer counts, exactly); the outputs, the loss and every
    gradient on the card against the CPU in f32 (scm_card_vs_cpu, with
    K3's 4 launches of the forward as derived); then one train step
    (make_train_step, f32), K3's launches counted from zero against the
    derived count, its 4 degree tables per chunk -> (launches, worst)."""
    batch = scm_batch(SCM_BSZ, seed, cfg)
    for name, seq in zip(("pattern", "graph"), batch[:2]):
        card = seq.to(dev)
        for fn in ("out_degrees", "in_degrees"):
            got, want = getattr(card, fn)().cpu(), getattr(seq, fn)()
            check(torch.equal(got, want),
                  f"SCM {cfg.rep_net} {name} {fn}: the card's differ from "
                  f"the CPU's by {(got - want).abs().max().item()}")
    worst = scm_card_vs_cpu(cfg, dev, seed, SCM_BSZ, amps=(False,))
    batch = [x.to(dev) for x in batch]
    model = scm_model(cfg, seed).to(dev)
    step = scm_driver.make_train_step(
        model, scm_driver.make_optimizer(model.parameters(), 1e-3),
        return_weights="nodeedge")
    sk.reset_launch_counts()
    losses = step(*batch, 0.2, 0.1, 0.05, 1e-4)
    torch.cuda.synchronize()
    launches = dict(sk.LAUNCHES)
    want = scm_driver.auto_chunks(SCM_BSZ) * k3_launches(cfg, train=True)
    check(want > 0 and launches == k3_dict(want),
          f"SCM {cfg.rep_net} pred_with_deg step: K3 launched {launches}, "
          f"expected {want}")
    check(np.isfinite(losses["total"].item()),
          f"SCM {cfg.rep_net} pred_with_deg step: loss")
    print(f"scm {cfg.rep_net} pred_with_deg step: degree tables equal "
          f"the CPU's; loss {losses['total'].item():.6f}, K3 launches "
          f"{launches} (derived {want})")
    return launches, worst


def phase_scm_seq(dev, seed, data_dir) -> tuple:
    """Phase 15: K3 at the degree tables' shape; then per SCM sequence
    network (SEQ_NETS) at the flagship's configuration, a bsz-16 batch
    on the card against the CPU (phase 14's checks), the train step at
    bsz 128 and the eval forward at 512, pred_with_deg at bsz 128 (the
    degree tables, the forward and the gradients on the card against
    the CPU, and one train step's K3 launches), and the ER command
    line with its --rep_net for one epoch on phase 12's data (data_dir),
    cli/scm_evaluate and a finetune; then a bidirectional GRU on the card
    against the CPU -> (results, paths)."""
    t0 = time.perf_counter()
    out, paths = {"k3_deg": scm_k3_deg_shape(dev, seed)}, {}
    root = tempfile.mkdtemp(prefix="scm_seq_")
    cli = SCM_CLI_ER + ["--synthetic", "True", "--synthetic_pairs",
                        str(SCM_CLI_PAIRS), "--seed", str(seed),
                        "--train_epochs", "1", "--save_data_dir", data_dir]
    for i, (net, kw) in enumerate(SEQ_NETS.items()):
        t1 = time.perf_counter()
        cfg = scm_flagship_config().replace(rep_net=net, **kw)
        worst = scm_card_vs_cpu(cfg, dev, seed + 10 * i, SCM_NET_CMP_BSZ)
        timing = scm_timing(cfg, dev, seed + 10 * i + 1,
                            train_bszs=(SCM_BSZ,),
                            profile=net not in UNPROFILED_NETS)
        deg, deg_worst = scm_deg_step(cfg.replace(pred_with_deg=True), dev,
                                      seed + 10 * i + 2)
        paths[f"scm_{net}_pred_with_deg_step"] = deg
        extra = [a for k, v in kw.items() for a in (f"--{k}", str(v))]
        paths.update(scm_net_cli(net, cli, root, extra))
        out[net] = dict(worst=worst, timing=timing, deg_step=deg,
                        deg_worst=deg_worst,
                        step_launches=k3_launches(cfg, train=True))
        print(f"scm seq: {net} took {time.perf_counter() - t1:.1f} s")
    cfg = scm_flagship_config().replace(**SEQ_GRU)
    out["GRU-bi"] = dict(worst=scm_card_vs_cpu(cfg, dev, seed + 40,
                                               SCM_NET_CMP_BSZ))
    print(f"scm seq: phase 15 took {time.perf_counter() - t0:.1f} s")
    return out, paths


def scm_remat_on_card(dev, seed) -> dict:
    """The remat repair on the card: DMPNN at the flagship with REMAT_KW
    (dropout 0.1 drawn from a CUDA generator, BatchNorm) against the
    same model without remat, both from the same weights and the same
    generator seed, at bsz 16: one train-mode forward and backward each.
    The generator's state after the step is equal; the gradients agree
    within phase 11's f32 bounds and the running statistics within 1e-5
    relative (K3's float atomics sum in another order at each launch, so
    the two runs' bits may differ), each tensor's largest difference
    over its largest magnitude; K3's launches, the recomputation's among
    them, against k3_launches -> the remat run's launches."""
    cfg = scm_flagship_config().replace(**REMAT_KW)
    pattern, graph, counts, nw, ew = [x.to(dev) for x in scm_batch(
        SCM_NET_CMP_BSZ, seed, cfg)]
    runs = {}
    for remat in (False, True):
        c = cfg.replace(rep_remat=remat)
        model = scm_model(c, seed).to(dev)
        gen = torch.Generator(device=dev).manual_seed(seed)
        start = gen.get_state()
        sk.reset_launch_counts()
        out = scm_driver.apply_model(model, pattern, graph, train=True,
                                     generator=gen)
        losses = scm_loss(out, counts, nw, ew, **SCM_LOSS)
        losses["total"].backward()
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
        want = k3_launches(c, train=True)
        check(launches == k3_dict(want), f"SCM remat={remat}: K3 launched "
              f"{launches}, expected {want}")
        check(not torch.equal(gen.get_state(), start),
              "SCM remat: no dropout mask was drawn")
        runs[remat] = dict(
            loss=losses["total"].item(), state=gen.get_state(),
            launches=launches,
            grads={k: p.grad.cpu() for k, p in model.named_parameters()},
            stats={k: b.cpu() for k, b in model.named_buffers()
                   if "running" in k})
    plain, rem = runs[False], runs[True]
    check(torch.equal(plain["state"], rem["state"]),
          "SCM remat: the dropout generator ends elsewhere than without "
          "remat")
    gmax = max(g.abs().max().item() for g in plain["grads"].values())
    worst = 0.0
    for k, g in plain["grads"].items():
        bound = TRAIN_F32_REL * g.abs().max().item() + TRAIN_F32_GLOBAL * gmax
        err = (rem["grads"][k] - g).abs().max().item()
        check(err <= bound, f"SCM remat gradient {k}: {err:.3e} exceeds "
              f"{bound:.3e}")
        worst = max(worst, err / bound)
    stat_err = max((rem["stats"][k] - v).abs().max().item()
                   / v.abs().max().item() for k, v in plain["stats"].items())
    check(len(plain["stats"]) > 0 and stat_err <= 1e-5,
          f"SCM remat: running statistics differ by {stat_err:.3e}")
    check(abs(rem["loss"] - plain["loss"]) <= 1e-5 * abs(plain["loss"]),
          f"SCM remat: loss {rem['loss']} vs {plain['loss']}")
    print(f"scm remat (dropout {cfg.rep_dropout}, BatchNorm) bsz "
          f"{SCM_NET_CMP_BSZ}: loss {rem['loss']:.7f} vs {plain['loss']:.7f}"
          f" without remat; the generator ends in the same state; "
          f"{len(plain['grads'])} gradients within bound (worst at "
          f"{worst:.3f} of it), {len(plain['stats'])} running statistics "
          f"within {stat_err:.3e} relative; K3 launches {rem['launches']} "
          f"(without remat {plain['launches']})")
    return rem["launches"]


def phase_scm_attn(dev, seed, data_dir) -> tuple:
    """Phase 16: per attention predict net of ATTN_NETS at the
    flagship's configuration, a bsz-16 batch on the card against the CPU
    (phase 14's checks, the f32 bounds widened by the CPU's own float32
    error), and its train step at bsz 128 and eval forward at 512
    (events, peak memory; for ATTN_TIMED device ms and the sparsemax
    kernels' share); the
    ER command line with --pred_net MeanAttnPredictNet for one epoch on
    phase 12's data (data_dir), then cli/scm_evaluate; and the remat
    repair on the card -> (results, paths)."""
    t0 = time.perf_counter()
    out, paths = {}, {}
    for i, (pred, rep) in enumerate(ATTN_NETS):
        t1 = time.perf_counter()
        cfg = scm_flagship_config().replace(rep_net=rep, pred_net=pred,
                                            **ATTN_KW)
        worst = scm_card_vs_cpu(cfg, dev, seed + 10 * i, SCM_NET_CMP_BSZ,
                                f64_slack=True)
        timing = scm_timing(cfg, dev, seed + 10 * i + 1,
                            train_bszs=(SCM_BSZ,),
                            shares=(SPARSEMAX_KERNELS,),
                            profile=(pred, rep) in ATTN_TIMED)
        out[f"{pred}/{rep}"] = dict(
            worst=worst, timing=timing,
            step_launches=k3_launches(cfg, train=True))
        print(f"scm attn: {pred} over {rep} took "
              f"{time.perf_counter() - t1:.1f} s")
    root = tempfile.mkdtemp(prefix="scm_attn_")
    net = "MeanAttnPredictNet"
    run = scm_cli_run(net, SCM_CLI_ER + [
        "--synthetic", "True", "--synthetic_pairs", str(SCM_CLI_PAIRS),
        "--seed", str(seed), "--train_epochs", "1", "--save_data_dir",
        data_dir, "--pred_net", net], root)
    paths[f"scm_cli_{net}"] = run["launches"]
    paths[f"scm_cli_{net}_evaluate"] = scm_cli_evaluate(f"{net} ", run)
    paths["scm_remat_dropout_bn"] = scm_remat_on_card(dev, seed + 50)
    print(f"scm attn: phase 16 took {time.perf_counter() - t0:.1f} s")
    return out, paths


def lstm_f64_errors(dev, seed) -> dict:
    """DIAMNet circular_lstm at phase 17's configuration, seed and bsz 16:
    each window LSTM (WindowLSTMMem, the node and the edge head) run
    again on the inputs it had in a float32 forward on the CPU, in float32
    by cuDNN's LSTM, by torch's own CUDA LSTM (cuDNN disabled in a scoped
    context) and by the CPU's, each against a float64 run on the CPU; the
    largest distance over the slots as a share of the float64 slots'
    largest magnitude, and as a share of phase 16's rule for outputs
    (SCM_F32_OUT_REL of it) -> {head: {run: share}}."""
    cfg = scm_flagship_config().replace(
        rep_net="DMPNN", pred_net="DIAMNet", pred_mem_init="circular_lstm",
        **MEM_KW)
    pattern, graph, *_ = scm_batch(SCM_NET_CMP_BSZ, seed, cfg)
    model = scm_model(cfg, seed)
    seen, hooks = {}, []
    for name in PRED_NET_ATTRS:
        net = getattr(model, name, None)
        if net is not None and isinstance(getattr(net, "mem_layer", None),
                                          WindowLSTMMem):
            hooks.append(net.mem_layer.register_forward_pre_hook(
                lambda mod, args, name=name: seen.__setitem__(
                    name, (mod, [a.detach() for a in args]))))
    with torch.no_grad():
        model(pattern, graph, train=True, dtype=torch.float32)
    for h in hooks:
        h.remove()
    out = {}
    with torch.no_grad():
        for name, (mod, (x, mask)) in seen.items():
            ref = copy.deepcopy(mod).double()(x.double(), mask)[0]
            scale = ref.abs().max().item()
            card = copy.deepcopy(mod).to(dev)
            xd, md = x.to(dev), mask.to(dev)
            runs = {"cpu": mod(x, mask)[0], "cudnn": card(xd, md)[0]}
            with torch.backends.cudnn.flags(enabled=False):
                runs["cuda_native"] = card(xd, md)[0]
            out[name] = {k: (v.double().cpu() - ref).abs().max().item()
                         / scale for k, v in runs.items()}
            print(f"scm mem: DIAMNet circular_lstm {name} window LSTM "
                  f"[{x.shape[0]} x {mod.mem_len} windows of "
                  f"{x.shape[1]} rows] f32 against float64, of the "
                  "slots' largest magnitude: " + ", ".join(
                      f"{k} {v:.3e} ({v / SCM_F32_OUT_REL:.3f} of "
                      f"{SCM_F32_OUT_REL:g})" for k, v in out[name].items()))
    return out


def phase_scm_mem(dev, seed, data_dir) -> tuple:
    """Phase 17: per memory predict net and init of MEM_CMP at the
    flagship's configuration, a bsz-16 batch on the card against the CPU
    (phase 16's rule); per one of MEM_STEP the train step at bsz 128
    and the eval forward at 512 (events, peak memory; for MEM_TIMED
    device ms and the sparsemax's and cuDNN's RNN kernels' shares); the
    ER command line with
    --pred_net DIAMNet --pred_mem_init circular_lstm for one epoch on
    phase 12's data (data_dir), then cli/scm_evaluate -> (results,
    paths)."""
    t0 = time.perf_counter()
    out, paths = {}, {}

    def config(pred, rep, init):
        return scm_flagship_config().replace(
            rep_net=rep, pred_net=pred, pred_mem_init=init, **MEM_KW)

    out["lstm_f64"] = lstm_f64_errors(
        dev, seed + 10 * MEM_CMP.index(("DIAMNet", "DMPNN", "circular_lstm")))
    for i, key in enumerate(MEM_CMP):
        t1 = time.perf_counter()
        cfg = config(*key)
        out["/".join(key)] = dict(
            worst=scm_card_vs_cpu(cfg, dev, seed + 10 * i, SCM_NET_CMP_BSZ,
                                  f64_slack=True),
            step_launches=k3_launches(cfg, train=True))
        print(f"scm mem: {' '.join(key)} card vs cpu took "
              f"{time.perf_counter() - t1:.1f} s")
    for i, key in enumerate(MEM_STEP):
        t1 = time.perf_counter()
        cfg = config(*key)
        out.setdefault("/".join(key), dict(
            step_launches=k3_launches(cfg, train=True)))["timing"] = \
            scm_timing(cfg, dev, seed + 10 * i + 1, train_bszs=(SCM_BSZ,),
                       shares=(SPARSEMAX_KERNELS, RNN_KERNELS),
                       profile=key in MEM_TIMED)
        print(f"scm mem: {' '.join(key)} timing took "
              f"{time.perf_counter() - t1:.1f} s")
    root = tempfile.mkdtemp(prefix="scm_mem_")
    net, init = "DIAMNet", "circular_lstm"
    run = scm_cli_run(f"{net}_{init}", SCM_CLI_ER + [
        "--synthetic", "True", "--synthetic_pairs", str(SCM_CLI_PAIRS),
        "--seed", str(seed), "--train_epochs", "1", "--save_data_dir",
        data_dir, "--pred_net", net, "--pred_mem_init", init], root)
    paths[f"scm_cli_{net}_{init}"] = run["launches"]
    paths[f"scm_cli_{net}_{init}_evaluate"] = scm_cli_evaluate(
        f"{net} {init} ", run)
    print(f"scm mem: phase 17 took {time.perf_counter() - t0:.1f} s")
    return out, paths


# --- phase 18: scale-out over torch.distributed ----------------------------

def dist_profile(world, fn, calls=3):
    """Device ms per call of fn by torch.profiler on rank 0 (None on the
    other ranks, which call fn as often: its collectives pair with rank
    0's)."""
    if world.rank == 0:
        return scm_profile(fn, calls)[0]
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return None


def dist_dp_steps(world, spec, dev) -> dict:
    """This rank's share of the flagship batch (dp.shard_batch) through
    DIST_STEPS data-parallel train steps: the losses, the first step's
    gradients (summed over the ranks), each step's K3 launches, the state
    after the steps, then the step's CUDA-event ms (median of 5) and
    device ms (rank 0's torch.profiler, 3 steps)."""
    model = copy.deepcopy(spec["model"]).to(dev)
    step = scm_driver.make_train_step(
        model, scm_driver.make_optimizer(model.parameters(), DP_LR),
        return_weights="nodeedge", world=world)
    scm_driver.dp_replicate_state(step)
    mine = [x.to(dev) for x in dp.shard_batch(world, *spec["batch"])]
    losses, launches, grads = [], [], None
    for s in range(DIST_STEPS):
        sk.reset_launch_counts()
        out = step(*mine, *DP_SCAL)
        torch.cuda.synchronize()
        launches.append(dict(sk.LAUNCHES))
        losses.append(float(out["total"]))
        if s == 0:
            grads = {k: p.grad.float().cpu().numpy()
                     for k, p in model.named_parameters()}
    state = {k: v.cpu().numpy() for k, v in model.state_dict().items()}

    def run():
        return step(*mine, *DP_SCAL)
    ev = kernel_bench.cuda_median_ms(run, 5, warmup=1)
    return dict(losses=losses, launches=launches, grads=grads, state=state,
                rows=mine[2].shape[0], event_ms=ev,
                device_ms=dist_profile(world, run))


def bn_hooks(model, record=None, force=None) -> list:
    """Forward hooks on the BatchNorms of `model`'s update MLPs (their
    outputs are the leaky ReLU's inputs): each output goes into `record`
    (name -> tensor), or, with `force` (name -> (rows, cols, signs)),
    those elements are put on the given side of zero (their magnitude
    kept, the gradient passed as it is) -> the hooks' handles."""
    handles = []
    for name, mod in model.named_modules():
        if not (isinstance(mod, MaskedBatchNorm) and name.endswith("mlp.bn")):
            continue

        def hook(mod, args, out, name=name):
            if record is not None:
                record[name] = out.detach()
            if force is None or name not in force:
                return None
            rows, cols, signs = (torch.as_tensor(a, device=out.device)
                                 for a in force[name])
            want = out.detach().clone()
            want[rows, cols] = signs.to(out.dtype) * want[rows, cols].abs()
            return out + (want - out.detach())
        handles.append(mod.register_forward_hook(hook))
    return handles


def ep_loss_grads(model, sub, amp, world=None, record=None, force=None,
                  owner=False):
    """Loss, float32 gradients (numpy) and the kernel launches of one
    train-mode forward and backward of a copy of `model`, over the ranks
    of `world` where given (each rank seeds 1 / size, the gradients
    summed over the ranks; owner=True: the node rows owner-sharded, the
    halo mode); record and force are bn_hooks'."""
    m = copy.deepcopy(model)
    handles = bn_hooks(m, record, force)
    sk.reset_launch_counts()
    with split_rows(m, world, owner=owner):
        out = apply_unc_forward(m, sub, amp=amp, train=True)
        loss = m.unsupervised_loss(
            out, sub["edge_type"], sub["edge_mask"], sub["samples"],
            sub["labels"], sub["sample_mask"], sub["node_mask"])
        (loss / (world.size if world else 1)).backward()
    if world is not None:
        all_reduce_grads(m.parameters(), world)
    torch.cuda.synchronize()
    for h in handles:
        h.remove()
    return (loss.item(), {k: p.grad.float().cpu().numpy()
                          for k, p in m.named_parameters()},
            dict(sk.LAUNCHES))


def near_zero(record, node_mask, n_real) -> dict:
    """The real rows' elements of each update MLP's BatchNorm output
    (bn_hooks' record) within FLIP_TOL of the real rows' largest
    magnitude of zero: where two float32 runs that round the forward
    differently may give the leaky ReLU other slopes -> name -> (rows,
    cols, values, largest magnitude)."""
    out = {}
    for name, x in record.items():
        real = (torch.as_tensor(node_mask, device=x.device)
                if x.shape[0] == len(node_mask)
                else torch.arange(x.shape[0], device=x.device) < n_real)
        scale = x[real].abs().max().item()
        near = (x.abs() <= FLIP_TOL * scale) & real[:, None]
        rows, cols = torch.nonzero(near, as_tuple=True)
        out[name] = (rows.cpu().numpy(), cols.cpu().numpy(),
                     x[rows, cols].cpu().numpy(), scale)
    return out


def shard_values(record, near, shard_rows, node_rows=None) -> dict:
    """This rank's BatchNorm outputs at the elements of `near` it holds:
    edge rows through shard_rows (global real edge -> this rank's row,
    -1 where another rank holds it), node rows through node_rows (the
    same for the subgraph's node rows; None: every rank holds them as
    they are) -> name -> values (0 where not held)."""
    out = {}
    for name, (rows, cols, _, _) in near.items():
        x = record[name].cpu().numpy()
        if "emlp" in name:
            local = shard_rows[rows]
        else:
            local = rows if node_rows is None else node_rows[rows]
        held = local >= 0
        out[name] = np.zeros(len(rows), x.dtype)
        out[name][held] = x[local[held], cols[held]]
    return out


def dist_ep(world, spec, dev) -> dict:
    """This rank's slice of the PubMed batch with its own plans: per
    backbone the loss, gradients and launches, f32 and amp bf16; then
    DMPNN's edge-partitioned train step, CUDA-event ms (median of 5) and
    device ms (rank 0's torch.profiler, 3 steps), and the [V, H]
    all-reduce's ms (CUDA events, median of 10)."""
    shard = attach_ep_csr_plans(shard_sub(spec["padded"], world),
                                sender_plan=True)
    sub = to_device(shard, dev)
    out = {"n_real": shard["n_real"], "grads": {}}
    for name, model in spec["models"].items():
        m = copy.deepcopy(model).to(dev)
        record = {}
        out["grads"][name] = {amp: ep_loss_grads(
            m, sub, amp, world, record=None if amp else record)
            for amp in (False, True)}
        if name in spec["near"]:
            # this rank's real edges are the run of the stream from lo
            n = int(spec["padded"]["edge_mask"].sum())
            lo = min(world.rank * -(-n // world.size), n)
            rows = np.full(n, -1)
            rows[lo: lo + shard["n_real"]] = np.arange(shard["n_real"])
            out.setdefault("near", {})[name] = shard_values(
                record, spec["near"][name], rows)
    m = copy.deepcopy(spec["models"]["DMPNN"]).to(dev)
    step = make_ep_train_step(m, make_unc_optimizer(m, LR, 100, GRAD_NORM),
                              world)
    out["event_ms"] = kernel_bench.cuda_median_ms(lambda: step(sub), 5,
                                                  warmup=1)
    out["device_ms"] = dist_profile(world, lambda: step(sub))
    x = torch.randn(PUBMED["num_nodes"], N_HIDDEN, device=dev)
    out["allreduce_ms"] = kernel_bench.cuda_median_ms(
        lambda: all_reduce_sum(x, world), 10, warmup=2)
    return out


def dist_dp_epoch(world, spec, dev) -> dict:
    """train_epoch for one epoch over the ranks (every rank the same
    batches, its own rows), counted from zero: the loss, the steps, K3's
    launches and the state after it."""
    model = build_model(spec["cfg"], device=dev, seed=spec["seed"])
    step = scm_driver.make_train_step(
        model, scm_driver.make_optimizer(model.parameters(),
                                         SCM_LEARN["lr"]),
        return_weights="nodeedge", world=world)
    scm_driver.dp_replicate_state(step)
    sampler = BucketSampler(spec["data"].sizes(), ["g_len", "p_len"],
                            SCM_LEARN["bsz"], shuffle=True, seed=spec["seed"])
    sk.reset_launch_counts()
    rec = scm_driver.train_epoch(step, spec["data"], sampler,
                                 {"train_epochs": 1, "neg_pred_slp": 0.2,
                                  "match_loss_w": 0.1,
                                  "pred_return_weights": "nodeedge"}, 0)
    torch.cuda.synchronize()
    return dict(loss=rec["total"], steps=len(sampler),
                launches=dict(sk.LAUNCHES), seconds=rec["seconds"],
                state={k: v.cpu().numpy()
                       for k, v in model.state_dict().items()})


def dist_train_unc(world, spec, dev) -> dict:
    """train_unc as this rank of `world` on the first BACKBONE_LINKS
    links (n_epochs=1) and its export, counted from zero: the launches,
    rank 0's epochs, the embeddings' checksum and the state after it."""
    model = copy.deepcopy(spec["model"]).to(dev)
    epochs = []
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    emb, cov = train_unc(
        model, spec["triplets"], PUBMED["num_nodes"], PUBMED["num_rels"],
        lr=LR, negative_rate=NEG, graph_batch_size=GBS,
        graph_split_size=SPLIT, sampler="randomwalk", sample_depth=DEPTH,
        sample_width=WIDTH, n_epochs=1, grad_norm=GRAD_NORM,
        seed=spec["seed"], on_epoch=epochs.append, log=lambda msg: None,
        world=world)
    torch.cuda.synchronize()
    return dict(launches=dict(sk.LAUNCHES), epochs=epochs, coverage=cov,
                seconds=time.perf_counter() - t0,
                emb_finite=bool(np.isfinite(emb).all()),
                emb_sum=float(np.abs(emb).sum()), emb_shape=emb.shape,
                state={k: v.cpu().numpy()
                       for k, v in model.state_dict().items()})


def dist_rank(world, spec) -> dict:
    """One rank of phase 18: the DP steps, the EP gradients and step,
    (spec["halo"]) phase 19's halo gradients, step and collectives on
    the same batch, (spec["runs"]) train_epoch and train_unc over the
    ranks, the E4 work (e4_rank: spec["e4"]) and phase 20's examples
    (examples_rank: spec["examples"])."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = world.device
    t0 = time.perf_counter()
    out = {"dp": dist_dp_steps(world, spec["dp"], dev),
           "ep": dist_ep(world, spec["ep"], dev)}
    if spec.get("halo"):
        out["halo"] = dist_halo(world, spec["ep"], dev)
    if spec.get("runs"):
        out["dp_epoch"] = dist_dp_epoch(world, spec["runs"]["dp_epoch"], dev)
        out["train_unc"] = dist_train_unc(world, spec["runs"]["train_unc"],
                                          dev)
    out["e4"] = e4_rank(world, spec["e4"], dev)
    out["examples"] = examples_rank(world, spec["examples"])
    out["seconds"] = time.perf_counter() - t0
    return out


def library_times(fn, label) -> tuple:
    """(event ms, device ms) of one PyTorch call, as kernel_bench.time_call
    measures them; the device ms None where torch.profiler records no
    device time for it (late in a long process CUPTI has dropped a whole
    trace of index_select, three traces running, on an H100)."""
    event = kernel_bench.cuda_median_ms(fn, 30)
    try:
        return event, kernel_bench.device_ms(fn, 30)
    except RuntimeError as err:
        print(f"timing {label}: {err}; its device ms not measured")
        return event, None


def dist_kernels(dev, dp_batch, padded, seed) -> dict:
    """K1 and K2 against their plain versions at the EP shard shape (rank
    0's slice of the PubMed batch, 2 ranks: its real edges into rows over
    the full V), K3 at the DP rank's shape (64 flagship pairs: 4,096 node
    rows, 32,768 edge rows, H = 64), f32; each timed beside its plain
    version, one PyTorch call and its HBM bound."""
    world = dist.World(0, 2, dev, "gloo")
    shard = attach_ep_csr_plans(shard_sub(padded, world))
    n, v = shard["n_real"], len(shard["node_mask"])
    e = len(shard["receivers"])
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    row_ptr, idx = t(shard["sk_rowptr"]), t(shard["receivers"])
    w = 2 * N_HIDDEN + 1
    out = {}
    with torch.inference_mode():
        msg = t(rng.normal(size=(e, N_HIDDEN)).astype(np.float32))
        err = check_k1(msg, row_ptr, (0, 0))
        nbytes = (n + v) * N_HIDDEN * 4 + (v + 1) * 4
        res = dict(err=err, bound_ms=hbm_ms(nbytes), **timed_pair(
            f"float32: K1 EP shard n_real={n} of E={e} V={v} W={N_HIDDEN}",
            lambda: sk.segment_sum_sorted(msg, row_ptr),
            lambda: sk.segment_sum_sorted_plain(msg, row_ptr),
            f" (max abs err {err:.3e})"))
        res["library_ms"], res["library_device_ms"] = library_times(
            lambda: torch.zeros(v, N_HIDDEN, device=dev).index_add_(
                0, idx[:n], msg[:n]), "K1 EP shard index_add_")
        out["K1"] = res
        table = t(rng.normal(size=(v, w)).astype(np.float32))
        err = check_k2(table, idx, n)
        # the table's rows that the rank's real edges name, read once
        # (about half the table: the rank's receivers), the real edges'
        # indices, the whole output written once (the pad tail's zero
        # rows too)
        rows = int(idx[:n].unique().numel())
        nbytes = (rows + e) * w * 4 + n * 8
        res = dict(err=err, bound_ms=hbm_ms(nbytes), **timed_pair(
            f"float32: K2 EP shard n_real={n} of E={e} V={v} ({rows} "
            f"rows read) W={w}",
            lambda: sk.gather_rows_sorted(table, idx, n),
            lambda: sk.gather_rows_sorted_plain(table, idx, n)))
        # one index_select of the real edges' rows (it leaves out the pad
        # tail's zero rows, which K2 writes: half the output here)
        res["library_ms"], res["library_device_ms"] = library_times(
            lambda: table.index_select(0, idx[:n]), "K2 EP shard index_select")
        out["K2"] = res
        for name in ("K1", "K2"):
            r = out[name]
            lib = r["library_device_ms"]
            print(f"timing float32: {name} EP shard: bound "
                  f"{r['bound_ms']:.4f} ms, "
                  f"{100 * r['bound_ms'] / r['device_ms']:.1f} % of it by "
                  f"device time; library {r['library_ms']:.4f} ms event, "
                  + ("device not measured" if lib is None
                     else f"{lib:.4f} ms device"))
    graph = dp_batch[1]
    half = SCM_BSZ // 2
    flat = scm_ops.flat_index(graph.receivers[:half], 64,
                              graph.edge_mask[:half]).to(dev)
    out["K3"] = k3_timed("DP rank", flat, half * 64, 64, torch.float32, dev,
                         rng)
    return out


def dist_inputs(seed, graph, triplets) -> tuple:
    """Phase 18's data, made from the seed: the flagship batch at bsz
    SCM_BSZ and the PubMed training batch with its sender sort, its edge
    envelope a multiple of 2 -> (dp_batch, padded)."""
    v = graph.num_nodes
    padded = sample_batch(
        graph, triplets[:GBS], "randomwalk", DEPTH, WIDTH, SPLIT, NEG, v,
        pad_e_max(min(v * WIDTH, graph.num_edges), 2), GBS * (1 + NEG),
        np.random.default_rng(seed + 2), send_keys=True)
    return scm_batch(SCM_BSZ, seed + 1, scm_flagship_config()), padded


def hold_against_one_rank(tag, key, runs, ref, near, models, sub, dev,
                          split_nodes) -> dict:
    """Each backbone's loss, f32 and amp bf16 gradients and launches of
    every rank of each run (label, results: res[key]["grads"][backbone]
    [amp] = (loss, gradients, launches), res[key]["near"][backbone] =
    shard_values) against the one-rank step's (`ref`: the same, of
    ep_loss_grads on the whole batch `sub`), under phase 5's f32 bounds
    and amp rule; the f32 gradients against the one-rank step taken
    again on the sharded step's side of the leaky ReLU inputs whose sign
    the two runs differ on (FLIP_TOL, MAX_FLIPS). Edge rows are held by
    one rank each; node rows by every rank, or (split_nodes) by their
    owner alone. -> worst share of the bound, by run and backbone."""
    worst = {}
    for b in EP_BACKBONES:
        want = (DMPNN_STEP_LAUNCHES if b == "DMPNN"
                else BACKBONE_STEP_LAUNCHES[b])
        (lc, g32, _), (la, ga, _) = ref[b][False], ref[b][True]
        for label, ranks in runs:
            ratios, flip_note, gc = {}, "", g32
            if b in near:
                force, total, far = {}, 0, 0.0
                for name, (rows, cols, refv, scale) in near[b].items():
                    got = (sum(r[key]["near"][b][name] for r in ranks)
                           if split_nodes or "emlp" in name
                           else ranks[0][key]["near"][b][name])
                    flip = np.sign(got) != np.sign(refv)
                    if flip.any():
                        force[name] = (rows[flip], cols[flip],
                                       np.sign(got[flip]))
                        far = max(far, float(np.abs(got[flip]).max()) / scale)
                    total += int(flip.sum())
                check(total <= MAX_FLIPS and far <= FLIP_TOL,
                      f"dist {tag} {b} {label}: {total} leaky ReLU inputs on "
                      f"the other side of zero than in the one-rank step, "
                      f"up to {far:.2e} of their scale from it (at most "
                      f"{MAX_FLIPS} within {FLIP_TOL:g} are rounding)")
                if force:
                    gc = ep_loss_grads(copy.deepcopy(models[b]).to(dev), sub,
                                       False, force=force)[1]
                flip_note = (f"; {total} leaky ReLU inputs on the other side "
                             f"of zero than in the one-rank step (up to "
                             f"{far:.2e} of their scale from it), the "
                             f"one-rank f32 step taken again on the {tag} "
                             "step's side of them")
            gmax = max(float(np.abs(g).max()) for g in gc.values())
            for r, res in enumerate(ranks):
                for amp in (False, True):
                    ld, gd, launches = res[key]["grads"][b][amp]
                    name = "amp bf16" if amp else "f32"
                    check(launches == want, f"dist {tag} {b} {label} rank "
                          f"{r} {name}: launched {launches}, expected {want}")
                    ref_l = la if amp else lc
                    check(np.isfinite(ld) and abs(ld - ref_l) <= (
                        1e-3 if amp else 1e-5) * abs(ref_l),
                        f"dist {tag} {b} {label} rank {r} {name}: loss {ld} "
                        f"vs one rank {ref_l}")
                    ratio = 0.0
                    for k, g in (g32 if amp else gc).items():
                        scale = float(np.abs(g).max())
                        err = float(np.abs(gd[k] - g).max())
                        if amp:
                            bound = (TRAIN_AMP_FACTOR * float(
                                np.abs(ga[k] - g).max()) + 2.0 ** -8 * scale)
                        else:
                            bound = (TRAIN_F32_REL * scale
                                     + TRAIN_F32_GLOBAL * gmax)
                        check(err <= bound, f"dist {tag} {b} {label} rank "
                              f"{r} {name} {k}: err {err:.3e} exceeds "
                              f"{bound:.3e}")
                        ratio = max(ratio, err / bound)
                    if amp:
                        l2 = lambda x, y: sum(  # noqa: E731
                            float(((x[k] - y[k]) ** 2).sum())
                            for k in y) ** 0.5
                        check(l2(gd, g32) <= TRAIN_AMP_FACTOR * l2(ga, g32),
                              f"dist {tag} {b} {label} rank {r}: amp L2 "
                              f"{l2(gd, g32)} vs one rank {l2(ga, g32)}")
                    ratios[name] = max(ratios.get(name, 0.0), ratio)
            worst[f"{key} {b} {label}"] = ratios
            l0 = ranks[0][key]["grads"][b][False][0]
            print(f"dist {tag} {b} {label}: loss {l0:.7f} vs one rank "
                  f"{lc:.7f}; gradients within "
                  f"bound (worst f32 {ratios['f32']:.3f}, amp "
                  f"{ratios['amp bf16']:.3f}); launches {want} on each "
                  f"rank; rank 0's n_real {ranks[0][key]['n_real']}"
                  f"{flip_note}")
    return worst


def phase_dist(dev, seed, graph, triplets, kernels, examples) -> tuple:
    """Phase 18: data-parallel SCM training (the flagship, bsz 128: 64
    pairs a rank) and edge-partitioned UNC training (the PubMed batch,
    DMPNN at full width, one step of each other backbone), each as two
    ranks on cuda:0 over gloo and as a world of one over NCCL, held
    against the one-rank step on the card: DP under phase 11's train
    bounds (the later steps' losses under DP_LATER_LOSS_REL), EP under
    phase 5's f32 bounds and amp rule; the ranks' states bit for bit
    equal; K3's launches per DP rank and step, K1's and K2's per EP
    rank; K1 and K2 at the EP shard shape and K3 at the DP rank's shape
    against their plain versions; then (gloo) train_epoch for one epoch
    and train_unc on BACKBONE_LINKS links over the two ranks, launches
    counted from zero; and the E4 work in the same processes (e4_rank,
    hold_e4): the demonstration layer and bench/halo_bench.py at E4's
    size over the two gloo ranks, dryrun_multichip over both worlds,
    bench/partition_bench.py on the host; and phase 20's examples over
    both worlds (examples_rank on `examples`, which phase 20 holds). Two
    ranks sharing one card time no scale-out: their step times are
    printed as what they are.
    -> (results, paths, kernel rows). `kernels` are dist_kernels' rows
    of the same data (dist_inputs) with e4_kernels', which main measures
    early in the run: late in a long process CUPTI has dropped whole
    traces."""
    t0 = time.perf_counter()
    cfg = scm_flagship_config()
    dp_model = scm_model(cfg, seed)
    dp_batch, padded = dist_inputs(seed, graph, triplets)
    models = {b: make_model(PUBMED["num_nodes"], PUBMED["num_rels"],
                            seed + 3 + i, dropout=0.0, backbone=b)
              for i, b in enumerate(EP_BACKBONES)}

    # the one-rank steps on the card
    m = copy.deepcopy(dp_model).to(dev)
    step = scm_driver.make_train_step(
        m, scm_driver.make_optimizer(m.parameters(), DP_LR),
        return_weights="nodeedge")
    batch = [x.to(dev) for x in dp_batch]
    ref_losses = []
    for s in range(DIST_STEPS):
        ref_losses.append(float(step(*batch, *DP_SCAL)["total"]))
        if s == 0:
            ref_grads = {k: p.grad.float().cpu().numpy()
                         for k, p in m.named_parameters()}
    ref_state = {k: x.cpu().numpy() for k, x in m.state_dict().items()}
    run = lambda: step(*batch, *DP_SCAL)  # noqa: E731
    ref_dp = dict(event_ms=kernel_bench.cuda_median_ms(run, 5, warmup=1),
                  device_ms=scm_profile(run)[0])
    sub = to_device(sk.attach_csr_plan(padded, sender_plan=True), dev)
    n_real = int(padded["edge_mask"].sum())
    ref_ep, near = {}, {}
    for b, mm in models.items():
        record = {}
        ref_ep[b] = {amp: ep_loss_grads(copy.deepcopy(mm).to(dev), sub, amp,
                                        record=None if amp else record)
                     for amp in (False, True)}
        if record:
            near[b] = near_zero(record, padded["node_mask"], n_real)
        del record
    m = copy.deepcopy(models["DMPNN"]).to(dev)
    ustep = make_unc_train_step(m, make_unc_optimizer(m, LR, 100, GRAD_NORM))
    ref_ep_time = dict(event_ms=kernel_bench.cuda_median_ms(
        lambda: ustep(sub), 5, warmup=1), device_ms=scm_profile(
        lambda: ustep(sub))[0])
    del m, step, ustep, batch
    torch.cuda.empty_cache()

    n_tr = SCM_LEARN["n_train"]
    learn_cfg = scm_flagship_config().replace(
        max_ngv=8, max_ngvl=2, max_nge=32, max_ngel=4, max_npv=4,
        max_npvl=2, max_npe=8, max_npel=4)
    data = GraphAdjDataset(generate_dataset(
        n_tr, seed=seed + 5, pv=3, pe=3, gv=8, ge=16, num_vlabels=2,
        num_elabels=2, p_v_max=4, p_e_max=4, g_v_max=8,
        g_e_max=16)).add_reversed_edges(2, 2)
    spec = dict(dp=dict(model=dp_model, batch=dp_batch),
                ep=dict(padded=padded, models=models, near=near),
                examples=examples)
    runs = dict(dp_epoch=dict(cfg=learn_cfg, data=data, seed=seed + 6),
                train_unc=dict(model=models["DMPNN"],
                               triplets=triplets[:BACKBONE_LINKS],
                               seed=seed + 7))
    print(f"dist: one-rank references took "
          f"{time.perf_counter() - t0:.1f} s")
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        gloo = dist.launch(dist_rank, 2, backend="gloo",
                           devices=[str(dev)] * 2,
                           init_file=os.path.join(tmp, "gloo"),
                           args=(dict(spec, runs=runs, e4=dict(
                               full=True, seed=seed + 57)),), timeout=900,
                           collective_timeout=300)
        t_gloo = time.perf_counter() - t1
        t1 = time.perf_counter()
        # the world of one also runs phase 19's halo work, which phase 19
        # reads (one NCCL process for both phases)
        nccl = dist.launch(dist_rank, 1, backend="nccl", devices=[str(dev)],
                           init_file=os.path.join(tmp, "nccl"),
                           args=(dict(spec, halo=True, e4=dict(full=False)),),
                           timeout=600, collective_timeout=300)
        t_nccl = time.perf_counter() - t1
    print(f"dist: gloo, two ranks on {dev}: {t_gloo:.1f} s wall (ranks "
          f"{', '.join(f'{r['seconds']:.1f}' for r in gloo)} s of work); "
          f"NCCL, a world of one: {t_nccl:.1f} s wall "
          f"({nccl[0]['seconds']:.1f} s of work, phase 19's halo work "
          "included)")

    # DP against the one-rank step
    gmax = max(float(np.abs(g).max()) for g in ref_grads.values())
    want_k3 = k3_dict(k3_launches(cfg, train=True))
    worst = {}
    for label, ranks in (("gloo 2 ranks", gloo), ("nccl 1 rank", nccl)):
        ratio = 0.0
        for r, res in enumerate(ranks):
            d = res["dp"]
            check(all(x == want_k3 for x in d["launches"]),
                  f"dist DP {label} rank {r}: K3 launched {d['launches']}, "
                  f"expected {want_k3} a step")
            for s, (got, ref) in enumerate(zip(d["losses"], ref_losses)):
                rel = 1e-5 if s == 0 else DP_LATER_LOSS_REL
                check(np.isfinite(got) and abs(got - ref) <= rel * abs(ref),
                      f"dist DP {label} rank {r} step {s}: loss {got} vs "
                      f"one rank {ref}")
            for k, g in ref_grads.items():
                err = float(np.abs(d["grads"][k] - g).max())
                bound = (TRAIN_F32_REL * float(np.abs(g).max())
                         + TRAIN_F32_GLOBAL * gmax)
                check(err <= bound, f"dist DP {label} rank {r} {k}: err "
                      f"{err:.3e} exceeds {bound:.3e}")
                ratio = max(ratio, err / bound)
        worst[f"dp {label}"] = ratio
        dpar = max(float(np.abs(ranks[0]["dp"]["state"][k] - x).max())
                   for k, x in ref_state.items())
        print(f"dist DP {label}: bsz {SCM_BSZ}, {ranks[0]['dp']['rows']} "
              f"pairs a rank; losses {ranks[0]['dp']['losses']} vs one rank "
              f"{ref_losses}; step-0 gradients within phase 11's bound "
              f"(worst at {ratio:.3f} of it); K3 {want_k3} a step on each "
              f"rank; parameters after {DIST_STEPS} steps within "
              f"{dpar:.3e} of the one-rank step's")
    a, b = (r["dp"]["state"] for r in gloo)
    check(all(np.array_equal(a[k], b[k]) for k in a),
          "dist DP: the ranks' states differ")
    print(f"dist DP timing, flagship f32: one rank bsz {SCM_BSZ} "
          f"{ref_dp['event_ms']:.3f} ms events, {ref_dp['device_ms']:.3f} "
          f"ms device; two ranks sharing one card over gloo (not a "
          f"scale-out speed), rank 0's {SCM_BSZ // 2} pairs "
          f"{gloo[0]['dp']['event_ms']:.3f} ms events, "
          f"{gloo[0]['dp']['device_ms']:.3f} ms device; NCCL world of one "
          f"{nccl[0]['dp']['event_ms']:.3f} / "
          f"{nccl[0]['dp']['device_ms']:.3f}")

    # EP against the one-rank step; the f32 gradients against the one-rank
    # step taken on the EP step's side of the leaky ReLU inputs whose sign
    # the two runs differ on (FLIP_TOL, MAX_FLIPS)
    worst.update(hold_against_one_rank(
        "EP", "ep", (("gloo 2 ranks", gloo), ("nccl 1 rank", nccl)),
        ref_ep, near, models, sub, dev, split_nodes=False))
    print(f"dist EP timing, PubMed DMPNN f32: one rank "
          f"{ref_ep_time['event_ms']:.3f} ms events, "
          f"{ref_ep_time['device_ms']:.3f} ms device; two ranks sharing one "
          f"card over gloo (not a scale-out speed), rank 0 "
          f"{gloo[0]['ep']['event_ms']:.3f} / {gloo[0]['ep']['device_ms']:.3f}"
          f"; NCCL world of one {nccl[0]['ep']['event_ms']:.3f} / "
          f"{nccl[0]['ep']['device_ms']:.3f}; the [{PUBMED['num_nodes']}, "
          f"{N_HIDDEN}] f32 all-reduce: gloo, two ranks on one card "
          f"{gloo[0]['ep']['allreduce_ms']:.3f} ms, NCCL world of one "
          f"{nccl[0]['ep']['allreduce_ms']:.3f} ms (CUDA events)")

    # the runs over the two gloo ranks, counted from zero
    paths = {}
    e0, e1 = (r["dp_epoch"] for r in gloo)
    want = k3_dict(e0["steps"] * k3_launches(learn_cfg, train=True))
    check(e0["launches"] == want and e1["launches"] == want,
          f"dist DP train_epoch: K3 launched {e0['launches']}, "
          f"{e1['launches']}; expected {want} on each rank")
    check(np.isfinite(e0["loss"]) and e0["loss"] == e1["loss"]
          and all(np.array_equal(e0["state"][k], e1["state"][k])
                  for k in e0["state"]),
          "dist DP train_epoch: the ranks differ")
    paths["dist_dp_train_epoch_rank0"] = e0["launches"]
    print(f"dist DP train_epoch: {n_tr} ER pairs, bsz {SCM_LEARN['bsz']} "
          f"over 2 ranks, {e0['steps']} steps in {e0['seconds']:.2f} s, loss "
          f"{e0['loss']:.6f} on both ranks, states equal; K3 {want} each")
    t0_, t1_ = (r["train_unc"] for r in gloo)
    steps = sum(rec["steps"] for rec in t0_["epochs"])
    n_req = -(-BACKBONE_LINKS // (4 * GBS))
    want = {"segment_sum_sorted:fwd": K1_FWD * (steps + n_req),
            "segment_sum_sorted:bwd": K1_BWD * steps,
            "gather_rows_sorted:fwd": K2_FWD * (steps + n_req),
            "gather_rows_sorted:bwd": K2_BWD * steps}
    check(t0_["launches"] == want and t1_["launches"] == want,
          f"dist train_unc: launched {t0_['launches']}, {t1_['launches']}; "
          f"expected {want} on each rank")
    check(t0_["emb_finite"] and t0_["emb_shape"] == (PUBMED["num_nodes"],
                                                     N_HIDDEN)
          and t0_["emb_sum"] == t1_["emb_sum"]
          and all(np.array_equal(t0_["state"][k], t1_["state"][k])
                  for k in t0_["state"]), "dist train_unc: the ranks differ")
    paths["dist_ep_train_unc_rank0"] = t0_["launches"]
    for rec in t0_["epochs"]:
        step_ms = [ms for ms in rec["step_ms"] if ms is not None] or [0.0]
        print(f"dist train_unc epoch {rec['epoch']}: loss {rec['loss']:.6f}, "
              f"{rec['steps']} steps, step "
              f"{statistics.median(step_ms):.3f} ms median (CUDA "
              f"events, rank 0 of two sharing one card), host sampling "
              f"{statistics.median(rec['sample_ms']):.1f} ms median")
    print(f"dist train_unc: {len(t0_['epochs'])} epochs, {steps} steps, "
          f"{n_req} export requests in {t0_['seconds']:.1f} s over 2 gloo "
          f"ranks on one card; coverage {t0_['coverage']:.4f}; launches "
          f"{want} on each rank; states and embeddings equal")
    # the E4 work: the demonstration layer, the halo library, the dry run
    e4_launches, e4_paths = hold_e4(gloo, nccl)
    paths.update(e4_paths)
    # the kernels line prints rank 0's counts of one step, as read
    ep0 = gloo[0]["ep"]["grads"]["DMPNN"][False]
    launches = {"ep_step_per_rank": ep0[2],
                "dp_step_per_rank": gloo[0]["dp"]["launches"][0],
                "e4": e4_launches}
    print(f"dist: phase 18 took {time.perf_counter() - t0:.1f} s")
    refs = dict(ref_ep=ref_ep, near=near, models=models, padded=padded,
                one_rank_ms=ref_ep_time, nccl=nccl)
    return dict(worst=worst, kernels=kernels, launches=launches, refs=refs,
                examples={"gloo 2 ranks": [r["examples"] for r in gloo],
                          "nccl 1 rank": [r["examples"] for r in nccl]}
                ), paths

# --- phase 18's E4 work: the demonstration layer, the halo library, the
# dry run -------------------------------------------------------------------

def e4_graphs() -> dict:
    """bench/halo_bench.py's two graphs at E4's size, over two ranks."""
    v, e = E4["v"], E4["e"]
    return {"power_law": generate_large_graph(v, e, seed=0)[0],
            "community95": generate_community_graph(
                v, e, num_communities=2, p_intra=0.95, seed=0)[0]}


def e4_preact(out: torch.Tensor) -> torch.Tensor:
    """A leaky ReLU's input, from its output."""
    return torch.where(out >= 0, out, out / LEAKY_RELU_A)


def e4_flips(got: torch.Tensor, want: torch.Tensor) -> tuple:
    """(count, worst): the leaky ReLU inputs (from the outputs `got` and
    `want` of one layer) on the other side of zero in the two runs, and
    the largest distance of one from zero, in either run, as a share of
    that run's largest magnitude."""
    a, b = e4_preact(got), e4_preact(want)
    flip = torch.sign(a) != torch.sign(b)
    n = int(flip.sum())
    if not n:
        return 0, 0.0
    return n, max(float(a[flip].abs().max() / a.abs().max()),
                  float(b[flip].abs().max() / b.abs().max()))


def e4_edge_parallel(world, dev, trip, lr, seed) -> dict:
    """The demonstration layer on one graph (random rev flags, features,
    weights and relation table from the seed; SGD at rate lr), as this
    rank of `world` and as one rank (world None) on the same card: each
    layer's forward output (the forward cut after it), the largest error
    against the one-rank path's as a share of phase 5's f32 bound and
    the leaky ReLU inputs on the other side of zero (e4_flips; node
    rows, replicated, and this rank's edge rows); the first step's
    gradients against the one-rank path's under the same bound; then
    E4["steps"] train steps both ways: the losses, the parameters after
    each against the one-rank path's, the parameters after the last,
    the step's CUDA-event ms; K3's launches of the sharded forward and
    of a sharded step."""
    v, e, h, layers = E4["v"], E4["e"], E4["h"], E4["layers"]
    rng = np.random.default_rng(seed)
    arrays = pad_to_multiple({"senders": trip[:, 0],
                              "receivers": trip[:, 2],
                              "rev_flag": rng.random(e) < 0.5}, world.size)
    labels = torch.tensor(rng.random(E4["samples"]) < 0.5,
                          dtype=torch.float32, device=dev)
    samples = torch.tensor(trip[:E4["samples"]], device=dev)
    # features at 0.1, as tests/test_parallel.py:114 draws them
    gen = torch.Generator(device=dev).manual_seed(seed)
    x = 0.1 * torch.randn(v, h, generator=gen, device=dev)
    ef = 0.1 * torch.randn(len(arrays["senders"]), h, generator=gen,
                           device=dev)
    w_rel = 0.1 * torch.randn(int(trip[:, 1].max()) + 1, h, generator=gen,
                              device=dev)
    params = init_edge_parallel_params(
        layers, h, generator=torch.Generator().manual_seed(seed), device=dev)
    blk = len(arrays["senders"]) // world.size
    rows = slice(world.rank * blk, (world.rank + 1) * blk)
    runs = ((shard_flat_edges(world, arrays, dev), ef[rows]),
            (shard_flat_edges(None, arrays, dev), ef))

    def edges(run):
        a, f = run
        return (f, a["senders"], a["receivers"], a["rev_flag"],
                a["edge_mask"])

    def flat(p, w):
        d = {f"{i}.{k}": t for i, layer in enumerate(p)
             for k, t in layer.items()}
        d["w_relation"] = w
        return d

    out = {"fwd_err": {}, "flips": {}}
    with torch.inference_mode():
        for depth in range(1, layers + 1):
            sk.reset_launch_counts()
            h2, e2 = edge_parallel_dmp_apply(params[:depth], x,
                                             *edges(runs[0]), v, world)
            torch.cuda.synchronize()
            out["fwd_launches"] = dict(sk.LAUNCHES)
            h1, e1 = edge_parallel_dmp_apply(params[:depth], x,
                                             *edges(runs[1]), v)
            e1 = e1[rows]
            gmax = max(float(h1.abs().max()), float(e1.abs().max()))
            for name, got, want in (("node", h2, h1), ("edge", e2, e1)):
                bound = (TRAIN_F32_REL * float(want.abs().max())
                         + TRAIN_F32_GLOBAL * gmax)
                key = f"layer {depth} {name}"
                out["fwd_err"][key] = float((got - want).abs().max()) / bound
                out["flips"][key] = e4_flips(got, want)
            del h1, e1, h2, e2

    # the first step's gradients both ways, under phase 5's f32 bound
    grads = {}
    for key, run, w in (("sharded", runs[0], world), ("one", runs[1], None)):
        _, g, g_rel = edge_parallel_grads(params, w_rel, x, *edges(run),
                                          samples, labels, v, w)
        grads[key] = flat(g, g_rel)
    gmax = max(float(g.abs().max()) for g in grads["one"].values())
    out["grad_err"] = max(
        float((grads["sharded"][k] - g).abs().max())
        / (TRAIN_F32_REL * float(g.abs().max()) + TRAIN_F32_GLOBAL * gmax)
        for k, g in grads["one"].items())
    del grads

    # E4["steps"] SGD steps both ways: the losses, and the parameters
    # after each step within rtol 1e-4, atol 1e-6 of the one-rank run's
    # (tests/test_torch_edge_partition.py's), as a share of that bound
    state = {"sharded": (params, w_rel), "one": (params, w_rel)}
    steps = {"sharded": make_edge_parallel_train_step(world, v, layers, lr),
             "one": make_edge_parallel_train_step(None, v, layers, lr)}
    out["losses"] = {"sharded": [], "one": []}
    out["param_err"] = 0.0
    ms = []
    for s in range(E4["steps"]):
        for key, run in (("sharded", runs[0]), ("one", runs[1])):
            p, w = state[key]
            sk.reset_launch_counts()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            p, w, loss = steps[key](p, w, x, *edges(run), samples, labels)
            b.record()
            torch.cuda.synchronize()
            if key == "sharded":
                ms.append(a.elapsed_time(b))
                if s == 0:
                    out["step_launches"] = dict(sk.LAUNCHES)
            state[key] = (p, w)
            out["losses"][key].append(loss.item())
        got, want = flat(*state["sharded"]), flat(*state["one"])
        out["param_err"] = max(out["param_err"], max(
            float(((got[k] - t).abs() / (1e-6 + 1e-4 * t.abs())).max())
            for k, t in want.items()))
    out["step_ms"] = statistics.median(ms)
    out["params"] = {k: t.cpu().numpy()
                     for k, t in flat(*state["sharded"]).items()}
    return out


def e4_rank(world, spec, dev) -> dict:
    """Phase 18's E4 work as one rank: (spec["full"]) the demonstration
    layer on both of e4_graphs' graphs (e4_edge_parallel) and
    bench/halo_bench.run at E4's size, every halo forward asserted
    against its full sum; then dryrun_multichip; each run's launches
    counted from zero."""
    out = {}
    torch.cuda.empty_cache()
    if spec["full"]:
        graphs = e4_graphs()
        out["edge_parallel"] = {
            name: e4_edge_parallel(world, dev, trip, E4["lr"][name],
                                   spec["seed"] + i)
            for i, (name, trip) in enumerate(graphs.items())}
        del graphs
        torch.cuda.empty_cache()
        sk.reset_launch_counts()
        t0 = time.perf_counter()
        out["halo_bench"] = halo_bench.run(
            world, v=E4["v"], edges=[E4["e"]], h=E4["h"],
            layers=E4["layers"], iters=E4["iters"],
            print_fn=lambda line: None)
        out["halo_bench_s"] = time.perf_counter() - t0
        out["halo_bench_launches"] = dict(sk.LAUNCHES)
        torch.cuda.empty_cache()
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    out["dryrun"] = dryrun_multichip(world)
    torch.cuda.synchronize()
    out["dryrun_s"] = time.perf_counter() - t0
    out["dryrun_launches"] = dict(sk.LAUNCHES)
    return out


def e4_kernels(dev, seed) -> dict:
    """K3 at the two call shapes of the E4 work, f32, H = 64, against its
    plain version, each timed beside one index_add_ and its HBM bound:
    rank 0's partial aggregation of the demonstration layer (its 500,000
    edge rows of the power-law graph into the V = 100,000 node rows), and
    rank 0's local aggregation of the halo layer (its edges of the
    degree partition into its Vp owned rows; the pad slots' receiver Vp
    is dropped)."""
    v, e = E4["v"], E4["e"]
    trip = generate_large_graph(v, e, seed=0)[0]
    rng = np.random.default_rng(seed)
    out = {"ep_layer": k3_timed(
        "EP layer rank", torch.from_numpy(trip[: e // 2, 2].copy()).to(dev),
        v, E4["h"], torch.float32, dev, rng)}
    part = build_halo_partition(trip[:, 0], trip[:, 2], np.zeros(e, bool), v,
                                2, method="degree")
    out["halo_layer"] = k3_timed(
        "halo layer rank", torch.from_numpy(part["local_receivers"][0]).to(
            dev), part["Vp"], E4["h"], torch.float32, dev, rng)
    out["halo_layer"]["shape"] = dict(vp=part["Vp"], ep=part["Ep"],
                                      n_real=int(part["edge_mask"][0].sum()))
    return out


def hold_e4(gloo, nccl) -> tuple:
    """Phase 18's E4 checks on the ranks' results (e4_rank's): the
    demonstration layer's forward and steps against the one-rank path
    (phase 5's f32 bounds; at most MAX_FLIPS leaky ReLU inputs on the
    other side of zero, each within FLIP_TOL of it: each such edge row
    moves a weight's gradient, a sum over every edge, by one term), K3's
    launches, the ranks bit for bit equal; halo_bench's records (its
    halo forwards held to the full sum in the ranks) and launches; the
    dry run's losses, equal over the gloo ranks, finite over NCCL. ->
    (launches for the kernels line, paths)."""
    paths, launches = {}, {}
    for name in gloo[0]["e4"]["edge_parallel"]:
        ranks = [r["e4"]["edge_parallel"][name] for r in gloo]
        for r, res in enumerate(ranks):
            check(res["fwd_launches"] == k3_dict(E4_FWD_K3)
                  and res["step_launches"] == k3_dict(E4_STEP_K3),
                  f"e4 {name} rank {r}: forward launched "
                  f"{res['fwd_launches']}, a step {res['step_launches']}; "
                  f"expected {E4_FWD_K3} and {E4_STEP_K3} K3 launches")
            worst = max(res["fwd_err"].values())
            check(worst <= 1.0 and res["grad_err"] <= 1.0
                  and res["param_err"] <= 1.0,
                  f"e4 {name} rank {r}: forward {res['fwd_err']}, first "
                  f"gradients {res['grad_err']:.3f} of phase 5's f32 bound; "
                  f"parameters {res['param_err']:.3f} of rtol 1e-4, atol "
                  "1e-6")
            for got, want in zip(res["losses"]["sharded"],
                                 res["losses"]["one"]):
                check(np.isfinite(got) and abs(got - want) <= 1e-5 * abs(
                    want), f"e4 {name} rank {r}: loss {got} vs one rank "
                    f"{want}")
            losses = res["losses"]["sharded"]
            check(losses[-1] < losses[0], f"e4 {name} rank {r}: the loss "
                  f"did not fall: {losses}")
        flips = {}
        for key in ranks[0]["flips"]:
            per = [res["flips"][key] for res in
                   (ranks[:1] if "node" in key else ranks)]
            flips[key] = (sum(n for n, _ in per), max(f for _, f in per))
            check(flips[key][0] <= MAX_FLIPS and flips[key][1] <= FLIP_TOL,
                  f"e4 {name} {key}: {flips[key][0]} leaky ReLU inputs on "
                  "the other side of zero than in the one-rank run, the "
                  f"farthest {flips[key][1]:.2e} of its scale from it (at "
                  f"most {MAX_FLIPS} within {FLIP_TOL:g} are rounding)")
        a, b = (res["params"] for res in ranks)
        check(ranks[0]["losses"]["sharded"] == ranks[1]["losses"]["sharded"]
              and all(np.array_equal(a[k], b[k]) for k in a),
              f"e4 {name}: the ranks differ")
        r0 = ranks[0]
        print(f"e4 edge-parallel {name} (V {E4['v']}, E {E4['e']}, H "
              f"{E4['h']}, {E4['layers']} layers, lr {E4['lr'][name]:g}; "
              "two gloo ranks on one card against one rank): forward "
              "within phase 5's f32 bound "
              f"(worst {max(r0['fwd_err'].values()):.3f} of it), leaky "
              f"ReLU inputs on the other side of zero {flips}; "
              f"{E4['steps']} steps, losses {r0['losses']['sharded']} vs "
              f"one rank {r0['losses']['one']}, first gradients within "
              f"{max(r['grad_err'] for r in ranks):.3f} of the bound, "
              f"parameters within "
              f"{max(r['param_err'] for r in ranks):.3f} of rtol 1e-4, "
              f"atol 1e-6, ranks bit for bit equal; K3 {E4_FWD_K3} a forward, "
              f"{E4_STEP_K3} a step; step {r0['step_ms']:.3f} ms median "
              "(CUDA events, rank 0 of two sharing one card: not a "
              "scale-out speed)")
        paths[f"e4_edge_parallel_{name}_step_rank0"] = r0["step_launches"]
        launches[f"ep_layer_{name}_fwd"] = r0["fwd_launches"]
        launches[f"ep_layer_{name}_step"] = r0["step_launches"]

    g0 = gloo[0]["e4"]
    for rec in g0["halo_bench"]:
        print(f"e4 halo_bench: {json.dumps(rec)}")
    per_graph = (2 + E4["iters"]) * (E4_FWD_K3 + 2 * E4_HALO_K3)
    want = k3_dict(2 * per_graph)
    check(all(r["e4"]["halo_bench_launches"] == want for r in gloo),
          f"e4 halo_bench: launched "
          f"{[r['e4']['halo_bench_launches'] for r in gloo]}, expected "
          f"{want} on each rank")
    print(f"e4 halo_bench: {len(g0['halo_bench'])} records in "
          f"{g0['halo_bench_s']:.1f} s over two gloo ranks on one card "
          f"(times by CUDA events, rank 0; not a scale-out speed); every "
          f"halo forward within {halo_bench.HALO_TOL:g} of its full sum "
          f"(worst {max(r['max_err'] for r in g0['halo_bench']):.2e}); K3 "
          f"{want} on each rank")
    paths["e4_halo_bench_rank0"] = g0["halo_bench_launches"]
    launches["halo_bench"] = g0["halo_bench_launches"]

    d = [r["e4"]["dryrun"] for r in gloo]
    check(d[0] == d[1], f"e4 dryrun: the gloo ranks' losses differ: {d}")
    print(f"e4 dryrun_multichip, two gloo ranks on one card: {d[0]} "
          f"({g0['dryrun_s']:.1f} s); NCCL world of one: "
          f"{nccl[0]['e4']['dryrun']} ({nccl[0]['e4']['dryrun_s']:.1f} s)")
    paths["e4_dryrun_gloo_rank0"] = g0["dryrun_launches"]
    paths["e4_dryrun_nccl"] = nccl[0]["e4"]["dryrun_launches"]

    t0 = time.perf_counter()
    for n, shards in PARTITION_BENCH:
        partition_bench.run(n, shards, print_fn=lambda line: print(
            f"e4 partition_bench (host): {line}"))
    print(f"e4 partition_bench: {time.perf_counter() - t0:.1f} s on the "
          "host")
    return launches, paths


# --- phase 19: owner-sharded (halo) UNC training ----------------------------

def wall_median_ms(fn, iters: int, warmup: int = 2) -> float:
    """Median host milliseconds of fn() followed by a synchronise: the
    whole of a collective whose gloo path waits on the host."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def halo_rows(meta, world, n_real) -> tuple:
    """(global real edge -> this rank's edge row, global node row -> this
    rank's owned row), -1 where another rank holds it."""
    es = meta["edge_perm"][world.rank]
    shard_rows = np.full(n_real, -1)
    shard_rows[es] = np.arange(len(es))
    node_rows = np.where(meta["owner"] == world.rank, meta["rank"], -1)
    return shard_rows, node_rows


def dist_halo(world, spec, dev) -> dict:
    """This rank's owned slice of the PubMed batch (partitioner
    HALO_PARTITION) with its own plans: per backbone the loss, gradients
    and launches, f32 and amp bf16; then DMPNN's owner-sharded train
    step, CUDA-event ms (median of 5) and device ms (rank 0's
    torch.profiler, 3 steps); the exchange of one layer ([n, B, H], f32
    and bf16) and the loss's gather of [Vp, H], each as CUDA-event and
    host ms (median of 10)."""
    padded = spec["padded"]
    env = halo_envelope(len(padded["nid"]), len(padded["senders"]),
                        world.size)
    shard, meta = halo_rank_shard(padded, world, env, HALO_PARTITION,
                                  sender_plan=True)
    sub = to_device(shard, dev)
    shard_rows, node_rows = halo_rows(meta, world,
                                      int(padded["edge_mask"].sum()))
    out = {"n_real": shard["n_real"], "envelope": env, "grads": {},
           "near": {}, "boundary": int(shard["send_mask"].sum())}
    for name, model in spec["models"].items():
        m = copy.deepcopy(model).to(dev)
        record = {}
        out["grads"][name] = {amp: ep_loss_grads(
            m, sub, amp, world, record=None if amp else record, owner=True)
            for amp in (False, True)}
        if name in spec["near"]:
            out["near"][name] = shard_values(record, spec["near"][name],
                                             shard_rows, node_rows)
    m = copy.deepcopy(spec["models"]["DMPNN"]).to(dev)
    step = make_halo_train_step(m, make_unc_optimizer(m, LR, 100,
                                                      GRAD_NORM), world)
    out["event_ms"] = kernel_bench.cuda_median_ms(lambda: step(sub), 5,
                                                  warmup=1)
    out["device_ms"] = dist_profile(world, lambda: step(sub))
    vp, _, b = env
    for dtype in (torch.float32, torch.bfloat16):
        send = torch.randn(world.size, b, N_HIDDEN, device=dev).to(dtype)
        fn = lambda: halo_exchange(send, world)  # noqa: E731
        out[f"exchange_{str(dtype)[6:]}"] = (
            kernel_bench.cuda_median_ms(fn, 10, warmup=2),
            wall_median_ms(fn, 10))
    rows = torch.randn(vp, N_HIDDEN, device=dev)
    fn = lambda: all_gather_rows(rows, world)  # noqa: E731
    out["gather"] = (kernel_bench.cuda_median_ms(fn, 10, warmup=2),
                     wall_median_ms(fn, 10))
    return out


def dist_halo_train_unc(world, spec, dev) -> dict:
    """train_unc(ep_mode="halo", ep_partition="bfs", amp=True) as this
    rank on the first BACKBONE_LINKS links (n_epochs=1: phase 18's
    2 epochs of 10 steps, 3 export requests) and its
    owner-sharded export, counted from zero: as dist_train_unc."""
    model = copy.deepcopy(spec["model"]).to(dev)
    epochs = []
    sk.reset_launch_counts()
    t0 = time.perf_counter()
    emb, cov = train_unc(
        model, spec["triplets"], PUBMED["num_nodes"], PUBMED["num_rels"],
        lr=LR, negative_rate=NEG, graph_batch_size=GBS,
        graph_split_size=SPLIT, sampler="randomwalk", sample_depth=DEPTH,
        sample_width=WIDTH, n_epochs=1, grad_norm=GRAD_NORM,
        seed=spec["seed"], amp=True, on_epoch=epochs.append,
        log=lambda msg: None, world=world, ep_mode="halo",
        ep_partition="bfs")
    torch.cuda.synchronize()
    return dict(launches=dict(sk.LAUNCHES), epochs=epochs, coverage=cov,
                seconds=time.perf_counter() - t0,
                emb_finite=bool(np.isfinite(emb).all()),
                emb_sum=float(np.abs(emb).sum()), emb_shape=emb.shape,
                state={k: v.cpu().numpy()
                       for k, v in model.state_dict().items()})


def halo_rank(world, spec) -> dict:
    """One rank of phase 19: the owner-sharded gradients, step and
    collectives, and (spec["runs"]) train_unc over the ranks."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = world.device
    t0 = time.perf_counter()
    out = {"halo": dist_halo(world, spec, dev)}
    if spec.get("runs"):
        out["train_unc"] = dist_halo_train_unc(world, spec["runs"], dev)
    out["seconds"] = time.perf_counter() - t0
    return out


def halo_kernels(dev, padded, seed) -> dict:
    """K1 and K2 at a halo rank's shapes (rank 0 of two, partitioner
    HALO_PARTITION, the PubMed batch), f32, against their plain versions,
    each timed beside one PyTorch call and its HBM bound: K1 summing the
    rank's real edges into its Vp owned rows at H = 50 (the
    aggregation); K1 summing W = 101 cotangent rows in sender order into
    the Vt rows of the composite table (the sender gather's backward,
    sk2_order / sk2_rowptr); K2 gathering the rank's receivers from the
    [Vt, 2H + 1] composite table."""
    world = dist.World(0, 2, dev, "gloo")
    env = halo_envelope(len(padded["nid"]), len(padded["senders"]), 2)
    shard, _ = halo_rank_shard(padded, world, env, HALO_PARTITION,
                               sender_plan=True)
    n, vp = shard["n_real"], len(shard["node_mask"])
    vt = len(shard["skt_rowptr"]) - 1
    e = len(shard["receivers"])
    w = 2 * N_HIDDEN + 1
    rng = np.random.default_rng(seed)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    recv, send = t(shard["receivers"]), t(shard["senders"])
    out = {}
    with torch.inference_mode():
        msg = t(rng.normal(size=(e, N_HIDDEN)).astype(np.float32))
        row_ptr = t(shard["sk_rowptr"])
        err = check_k1(msg, row_ptr, (0, 0))
        res = dict(err=err, bound_ms=hbm_ms((n + vp) * N_HIDDEN * 4
                                            + (vp + 1) * 4),
                   **timed_pair(
            f"float32: K1 halo rank n_real={n} of Ep={e} into Vp={vp} "
            f"W={N_HIDDEN}", lambda: sk.segment_sum_sorted(msg, row_ptr),
            lambda: sk.segment_sum_sorted_plain(msg, row_ptr),
            f" (max abs err {err:.3e})"))
        res["library_ms"], res["library_device_ms"] = library_times(
            lambda: torch.zeros(vp, N_HIDDEN, device=dev).index_add_(
                0, recv[:n], msg[:n]), "K1 halo Vp index_add_")
        out["K1_vp"] = res
        g = t(rng.normal(size=(e, w)).astype(np.float32))
        order, row_ptr_s = t(shard["sk2_order"]), t(shard["sk2_rowptr"])
        err = check_k1(g, row_ptr_s, (0, 0), rows=order)
        # the rank's real cotangent rows and their sender order read once,
        # the Vt rows written once
        res = dict(err=err, bound_ms=hbm_ms((n + vt) * w * 4 + n * 8
                                            + (vt + 1) * 4), **timed_pair(
            f"float32: K1 halo rank sender backward n_real={n} into "
            f"Vt={vt} W={w}",
            lambda: sk.segment_sum_sorted(g, row_ptr_s, rows=order),
            lambda: sk.segment_sum_sorted_plain(g, row_ptr_s, order),
            f" (max abs err {err:.3e})"))
        res["library_ms"], res["library_device_ms"] = library_times(
            lambda: torch.zeros(vt, w, device=dev).index_add_(
                0, send[:n], g[:n]), "K1 halo Vt index_add_")
        out["K1_vt_send"] = res
        table = t(rng.normal(size=(vt, w)).astype(np.float32))
        err = check_k2(table, recv, n)
        rows = int(recv[:n].unique().numel())
        res = dict(err=err, bound_ms=hbm_ms((rows + e) * w * 4 + n * 8),
                   **timed_pair(
            f"float32: K2 halo rank n_real={n} of Ep={e} from the [{vt}, "
            f"{w}] composite table ({rows} rows read)",
            lambda: sk.gather_rows_sorted(table, recv, n),
            lambda: sk.gather_rows_sorted_plain(table, recv, n)))
        res["library_ms"], res["library_device_ms"] = library_times(
            lambda: table.index_select(0, recv[:n]), "K2 halo index_select")
        # the bound of the real rows alone, what index_select writes: K2
        # also writes the Ep - n_real zero pad rows
        res["bound_real_ms"] = hbm_ms((rows + n) * w * 4 + n * 8)
        print(f"timing float32: K2_table halo rank: bound over the "
              f"{n} real rows alone {res['bound_real_ms']:.4f} ms "
              f"({e - n} of its {e} output rows are pads)")
        out["K2_table"] = res
    for name, r in out.items():
        lib = r["library_device_ms"]
        share = 100 * r["bound_ms"] / r["device_ms"]
        print(f"timing float32: {name} halo rank: bound "
              f"{r['bound_ms']:.4f} ms, {share:.1f} % of it by device "
              f"time; library {r['library_ms']:.4f} ms "
              "event, " + ("device not measured" if lib is None
                           else f"{lib:.4f} ms device"))
    out["shape"] = dict(vp=vp, vt=vt, ep=e, n_real=n)
    return out


def phase_halo(dev, seed, triplets, refs, kernels) -> tuple:
    """Phase 19: owner-sharded (halo) UNC training of the PubMed batch
    (phase 18's batch, models and one-rank references) as two ranks on
    cuda:0 over gloo (Vp = 31,555, B = Vp, Vt = 94,666) and as a world
    of one over NCCL (run in phase 18's NCCL process, refs["nccl"]):
    every backbone's loss and gradients (f32, amp
    bf16) against the one-rank step under phase 5's bounds and phase 18's
    flip rule, K1's and K2's launches per rank; DMPNN's step and the
    exchange timed; then train_unc (ep_partition bfs, amp) and the
    north-star gate at its CI envelope over the two gloo ranks, launches
    counted from zero. -> (results, paths). `kernels` are halo_kernels'
    rows, measured early in the run."""
    t0 = time.perf_counter()
    padded, models = refs["padded"], refs["models"]
    sub = to_device(sk.attach_csr_plan(padded, sender_plan=True), dev)
    spec = dict(padded=padded, models=models, near=refs["near"])
    runs = dict(model=models["DMPNN"], triplets=triplets[:BACKBONE_LINKS],
                seed=seed + 7)
    nccl = refs["nccl"]
    with tempfile.TemporaryDirectory() as tmp:
        t1 = time.perf_counter()
        gloo = dist.launch(halo_rank, 2, backend="gloo",
                           devices=[str(dev)] * 2,
                           init_file=os.path.join(tmp, "gloo"),
                           args=(dict(spec, runs=runs),), timeout=600,
                           collective_timeout=300)
        t_gloo = time.perf_counter() - t1
    env = gloo[0]["halo"]["envelope"]
    print(f"halo: gloo, two ranks on {dev}: {t_gloo:.1f} s wall (the NCCL "
          f"world of one ran in phase 18's process); per rank (Vp, Ep, B) = "
          f"{tuple(env)}, Vt = {env[0] + 2 * env[2] + 1}, boundary rows "
          f"{[r['halo']['boundary'] for r in gloo]}, real edges "
          f"{[r['halo']['n_real'] for r in gloo]}")
    worst = hold_against_one_rank(
        "halo", "halo", (("gloo 2 ranks", gloo), ("nccl 1 rank", nccl)),
        refs["ref_ep"], refs["near"], models, sub, dev, split_nodes=True)
    one = refs["one_rank_ms"]
    g0, n0 = gloo[0]["halo"], nccl[0]["halo"]
    print(f"halo timing, PubMed DMPNN f32: one rank {one['event_ms']:.3f} "
          f"ms events, {one['device_ms']:.3f} ms device; two ranks sharing "
          f"one card over gloo (not a scale-out speed), rank 0 "
          f"{g0['event_ms']:.3f} / {g0['device_ms']:.3f}; NCCL world of one "
          f"{n0['event_ms']:.3f} / {n0['device_ms']:.3f}")
    for label, r, size in (("gloo, two ranks on one card", g0, 2),
                           ("NCCL world of one", n0, 1)):
        print(f"halo exchange per layer, {label}: [{size}, "
              f"{r['envelope'][2]}, {N_HIDDEN}] f32 "
              f"{r['exchange_float32'][0]:.3f} ms events / "
              f"{r['exchange_float32'][1]:.3f} ms host, bf16 "
              f"{r['exchange_bfloat16'][0]:.3f} / "
              f"{r['exchange_bfloat16'][1]:.3f}; the loss's gather of "
              f"[{r['envelope'][0]}, {N_HIDDEN}] f32 {r['gather'][0]:.3f} / "
              f"{r['gather'][1]:.3f}")

    paths = {}
    t0_, t1_ = (r["train_unc"] for r in gloo)
    steps = sum(rec["steps"] for rec in t0_["epochs"])
    n_req = -(-BACKBONE_LINKS // (4 * GBS))
    want = {"segment_sum_sorted:fwd": K1_FWD * (steps + n_req),
            "segment_sum_sorted:bwd": K1_BWD * steps,
            "gather_rows_sorted:fwd": K2_FWD * (steps + n_req),
            "gather_rows_sorted:bwd": K2_BWD * steps}
    check(t0_["launches"] == want and t1_["launches"] == want,
          f"halo train_unc: launched {t0_['launches']}, {t1_['launches']}; "
          f"expected {want} on each rank")
    check(t0_["emb_finite"] and t0_["emb_shape"] == (PUBMED["num_nodes"],
                                                     N_HIDDEN)
          and t0_["emb_sum"] == t1_["emb_sum"]
          and all(np.array_equal(t0_["state"][k], t1_["state"][k])
                  for k in t0_["state"]), "halo train_unc: the ranks differ")
    paths["halo_train_unc_rank0"] = t0_["launches"]
    for rec in t0_["epochs"]:
        step_ms = [ms for ms in rec["step_ms"] if ms is not None] or [0.0]
        print(f"halo train_unc epoch {rec['epoch']}: loss {rec['loss']:.6f}, "
              f"{rec['steps']} amp steps, step "
              f"{statistics.median(step_ms):.3f} ms median (CUDA events, "
              f"rank 0 of two sharing one card), host sampling and bfs "
              f"partition {statistics.median(rec['sample_ms']):.1f} ms "
              "median")
    print(f"halo train_unc: {len(t0_['epochs'])} epochs, {steps} steps, "
          f"{n_req} export requests in {t0_['seconds']:.1f} s over 2 gloo "
          f"ranks on one card; coverage {t0_['coverage']:.4f}; every "
          f"node's row written ({t0_['emb_shape']}); launches {want} on "
          "each rank; states and embeddings equal")

    # the north-star gate at its CI envelope, its steps counted from zero
    t1 = time.perf_counter()
    ns = northstar.run(v=2000, e=40_000, steps=6, shards=2, batch=400,
                       depth=2, width=6, amp=True, log=None, backend="gloo",
                       devices=[str(dev)] * 2, timeout=600.0)
    check(len(ns["losses"]) == 6 and all(np.isfinite(ns["losses"]))
          and ns["loss_last_half_mean"] < ns["loss_first"]
          and ns["loss_decreased"] and ns["checkpoint_verified"]
          and ns["amp"] and 0.0 <= ns["sample_overlap_fraction"] <= 1.0,
          f"north-star gate failed: {ns}")
    want = {k: v * ns["steps"] for k, v in DMPNN_STEP_LAUNCHES.items()}
    check(ns["launches"] == want, f"north-star gate: launched "
          f"{ns['launches']}, expected {want} on rank 0")
    paths["halo_northstar_rank0"] = ns["launches"]
    print(f"halo north-star gate (v 2000, e 40000, 6 amp steps, two gloo "
          f"ranks on one card): losses {ns['losses']}, checkpoint verified, "
          f"step {ns['step_s_avg'] * 1e3:.1f} ms mean host, sampling "
          f"overlap {ns['sample_overlap_fraction']}, "
          f"{time.perf_counter() - t1:.1f} s wall")
    print(f"halo: phase 19 took {time.perf_counter() - t0:.1f} s")
    return dict(worst=worst, kernels=kernels,
                launches_step=g0["grads"]["DMPNN"][False][2]), paths


# --- phase 20: the helpers off every path and the examples ------------------

# K3 launches of one call of each helper and of its backward
# (ops/scatter.py): the flat sum's forward; the softmax's sum of the
# exponentials, then the backward of its two gathers
HELPER_K3 = {"scatter_sum_flat": (1, 0), "scatter_max_edges": (0, 0),
             "segment_softmax_edges": (1, 2), "edge_norm_device": (0, 0)}
# the flat graph of scatter_sum_flat's docstring (the JAX package's
# ops/scatter.py:131-139, the kernel bench's largest size), one batch of
# [1, E]; every HELPER_WRAP-th receiver r is given as r - V, which JAX's
# indexing wraps to r, and every HELPER_PAD-th edge is masked
HELPER_FLAT = dict(v=82465, e=497664, h=64)
HELPER_WRAP, HELPER_PAD = 16, 64


def helper_inputs(seed) -> dict:
    """Phase 20's two sizes, on the CPU: the flagship's graph side (bsz
    128, E 512 with reversed edges, V 64: scm_make_batch's receivers and
    mask) and HELPER_FLAT; per size the messages [B, E, H = 64], the
    scores [B, E] and the in-degrees [B, V] of the real edges."""
    rng = np.random.default_rng(seed)
    _, graph = scm_make_batch(SCM_BSZ, 8, 8, 64, 256, 16, 16, seed=seed)
    v, e = HELPER_FLAT["v"], HELPER_FLAT["e"]
    recv = rng.integers(0, v, e)
    recv[::HELPER_WRAP] -= v
    mask = np.ones(e, bool)
    mask[1::HELPER_PAD] = False
    sizes = {"flagship": dict(v=64, recv=graph.receivers.long(),
                              mask=graph.edge_mask),
             "flat": dict(v=v, recv=torch.from_numpy(recv)[None],
                          mask=torch.from_numpy(mask)[None])}
    for s in sizes.values():
        b, e = s["recv"].shape
        s["msg"] = torch.from_numpy(
            rng.normal(size=(b, e, HELPER_FLAT["h"])).astype(np.float32))
        s["scores"] = torch.from_numpy(
            rng.normal(size=(b, e)).astype(np.float32))
        idx, inside = scm_ops.jax_index(s["recv"], s["v"])
        s["deg"] = scm_ops.bincount_batched(idx, inside & s["mask"], s["v"])
    return sizes


def helper_calls(s, dev) -> dict:
    """name -> (the helper as a function of its float input, that input
    on the CPU, a function of the input on `dev` that returns one PyTorch
    call computing the same function (the real rows selected, the index
    expanded, before it; None where there is none), (the float input's
    and output's elements, the other bytes the function must move)) at
    one size, the indices on `dev`. The flat sum takes the batch
    flattened to B*V rows (ops/scatter.batch_index: receiver b*V + r,
    B*V where JAX's indexing drops r)."""
    v = s["v"]
    b, e = s["recv"].shape
    h = HELPER_FLAT["h"]
    recv, mask = s["recv"].to(dev), s["mask"].to(dev)
    flat, inside = scm_ops.batch_index(recv, v)
    fmask = mask.reshape(-1)
    rows = b * v
    keep = inside.reshape(-1) & fmask
    idx_keep = flat[keep]
    idx_max = flat[:, None].expand(-1, h).contiguous()

    def lib_sum(x):
        rows_x = x[keep]
        return lambda: torch.zeros(rows, h, dtype=x.dtype,
                                   device=dev).index_add_(0, idx_keep,
                                                          rows_x)

    def lib_max(x):
        # one more row takes the dropped receivers (index B*V)
        flat_x = x.reshape(b * e, h)
        return lambda: torch.full((rows + 1, h), -1e30, dtype=x.dtype,
                                  device=dev).scatter_reduce_(
            0, idx_max, flat_x, "amax", include_self=True)

    return {
        "scatter_sum_flat": (
            lambda x: scm_ops.scatter_sum_flat(x, flat, fmask, rows),
            s["msg"].reshape(b * e, h), lib_sum, (b * e * h, rows * h,
                                                  b * e * 9)),
        "scatter_max_edges": (
            lambda x: scm_ops.scatter_max_edges(x, recv, mask, v),
            s["msg"], lib_max, (b * e * h, rows * h, b * e * 9)),
        "segment_softmax_edges": (
            lambda x: scm_ops.segment_softmax_edges(x, recv, mask, v),
            s["scores"], None, (b * e, b * e, b * e * 9)),
        "edge_norm_device": (
            lambda x: edge_norm_device(x, recv, False), s["deg"], None,
            (rows, b * e, b * e * 8)),
    }


def helper_run(fn, x, dtype, grad, dev=None, g_seed=0) -> tuple:
    """fn on x cast to dtype (on dev, else the CPU), with (grad) a backward
    of a fixed random cotangent -> (output, input gradient or None, K3
    launches of the forward, of the backward: LAUNCHES read after
    each), float32 on the CPU."""
    x = x.to(dev or "cpu", dtype, copy=True).requires_grad_(grad)
    sk.reset_launch_counts()
    y = fn(x)
    if dev is not None:
        torch.cuda.synchronize()
    fwd = dict(sk.LAUNCHES)
    g, bwd = None, {}
    if grad:
        gen = torch.Generator().manual_seed(g_seed)
        ct = torch.randn(y.shape, generator=gen).to(y.device, dtype)
        sk.reset_launch_counts()
        y.backward(ct)
        if dev is not None:
            torch.cuda.synchronize()
        bwd = dict(sk.LAUNCHES)
        g = x.grad.float().cpu()
    return y.detach().float().cpu(), g, fwd, bwd


def phase_helpers(dev, seed) -> dict:
    """Phase 20 (a), early in the run (as phase 18's kernels): each helper
    of ops/scatter.py and ops/spectral.py at helper_inputs' two sizes, f32
    and bf16, on the card against its plain version on the CPU: the
    output and (but edge_norm_device) the input gradient under phase 11's
    bounds (f32: the flat sum K3's, 2**-20 of each row's absolute sum,
    the other outputs SCM_F32_OUT_REL of their largest magnitude, the
    gradients TRAIN_F32_REL + TRAIN_F32_GLOBAL of theirs; bf16: the amp
    rule against the CPU's f32 result); K3's launches of each call and
    of its backward exactly HELPER_K3's; each call timed (CUDA events,
    device ms) beside one PyTorch call of the same function (index_add_,
    scatter_reduce amax; none for the softmax and the norm) and the bytes
    it must move over 3.35 TB/s. Then K3 at its new call shapes against
    its plain version (k3_timed): the flat sum's (HELPER_FLAT, H = 64) and
    the softmax denominator's (one column into B*V rows, both sizes), f32
    and bf16. -> (K3 rows by (shape, dtype), the helpers' rows, K3's
    launches of each call and its backward by helper, size and dtype,
    as this run counted them)."""
    t0 = time.perf_counter()
    rows, worst, launches = [], 0.0, {}
    sizes = helper_inputs(seed)
    for size, s in sizes.items():
        on_cpu = helper_calls(s, "cpu")
        for name, (fn, x, lib, (n_in, n_out, other)) in helper_calls(
                s, dev).items():
            cpu_fn = on_cpu[name][0]
            grad = name != "edge_norm_device"
            ref = helper_run(cpu_fn, x, torch.float32, grad)
            for dtype in (torch.float32, torch.bfloat16):
                dname = str(dtype)[6:]
                got = helper_run(fn, x, dtype, grad, dev)
                cpu = ref if dtype == torch.float32 else helper_run(
                    cpu_fn, x, dtype, grad)
                want = (k3_dict(HELPER_K3[name][0]),
                        k3_dict(HELPER_K3[name][1]))
                check(got[2:] == want and cpu[2:] == ({}, {}),
                      f"helper {name} {size} {dname}: K3 launched "
                      f"{got[2:]} (forward, backward), expected {want}")
                counted = [c.get("segment_sum_unsorted", 0)
                           for c in got[2:]]
                launches[f"{name}_{size}_{dname}"] = counted
                shares = []
                for i, what in ((0, "output"), (1, "gradient")):
                    if got[i] is None:
                        continue
                    check(bool(torch.isfinite(got[i]).all()),
                          f"helper {name} {size} {dname}: non-finite {what}")
                    err = (got[i] - ref[i]).abs()
                    scale = ref[i].abs().max().item()
                    if dtype == torch.bfloat16:
                        bound = (TRAIN_AMP_FACTOR
                                 * (cpu[i] - ref[i]).abs().max().item()
                                 + 2.0 ** -8 * scale)
                    elif i == 1:
                        bound = (TRAIN_F32_REL + TRAIN_F32_GLOBAL) * scale
                    elif name == "scatter_sum_flat":
                        err = err / (K1_ABS_SUM_TOL * cpu_fn(x.abs())
                                     ).clamp_min(1e-30)
                        bound = 1.0
                    else:
                        bound = SCM_F32_OUT_REL * scale
                    share = err.max().item() / bound if bound else 0.0
                    check(share <= 1.0, f"helper {name} {size} {dname} "
                          f"{what}: at {share:.3f} of its bound")
                    shares.append(share)
                worst = max(worst, *shares)
                xc = x.to(dev, dtype)
                with torch.inference_mode():
                    ms, dms = library_times(lambda: fn(xc),
                                            f"helper {name} {size}")
                    lms = ldms = None
                    if lib is not None:
                        lms, ldms = library_times(lib(xc),
                                                  f"library {name} {size}")
                nbytes = (n_in + n_out) * dtype.itemsize + other
                row = dict(name=name, size=size, dtype=dname,
                           launches_fwd=counted[0],
                           launches_bwd=counted[1], err_share=shares,
                           ms=ms, device_ms=dms, library_ms=lms,
                           library_device_ms=ldms, bound_ms=hbm_ms(nbytes),
                           bound_by="bytes")
                rows.append(row)
                print(f"helper {name} {size} {dname}: card vs cpu "
                      + "/".join(f"{r:.3f}" for r in shares)
                      + " of the bound (output/gradient); K3 launches "
                      f"{counted} (forward, backward); {ms:.4f} ms "
                      f"event, {dms} ms device; library {lms} / {ldms}; "
                      f"bound {row['bound_ms']:.4f} ms")
    # K3 at its new call shapes
    rng = np.random.default_rng(seed + 1)
    k3 = {}
    for size, s in sizes.items():
        b = s["recv"].shape[0]
        flat, inside = scm_ops.batch_index(s["recv"], s["v"])
        # the flat size's one batch: its real rows, the others dropped
        keep = torch.where((inside & s["mask"]).reshape(-1), flat,
                           b * s["v"]).to(dev)
        flat = flat.to(dev)
        for dtype in (torch.float32, torch.bfloat16):
            dname = str(dtype)[6:]
            k3[(f"softmax_denom_{size}", dname)] = k3_timed(
                f"softmax denominator {size}", flat, b * s["v"], 1, dtype,
                dev, rng)
            if size == "flat":
                k3[("flat_sum", dname)] = k3_timed(
                    "flat sum", keep, s["v"], HELPER_FLAT["h"], dtype, dev,
                    rng)
    print(json.dumps({"helpers": rows}))
    print(f"helpers: phase 20 (a) took {time.perf_counter() - t0:.1f} s; "
          f"worst at {worst:.3f} of its bound")
    return dict(k3=k3, rows=rows, launches=launches)


def unc_example_launches(steps: int, layers: int = 1) -> dict:
    """K1's and K2's launches of performance_levers' train_unc: `steps`
    train steps and its one export request (150 links in requests of 4
    * 50), each a forward of `layers` layers."""
    n_req = -(-150 // (4 * ex_pl.UNC_KW["graph_batch_size"]))
    return {"segment_sum_sorted:fwd": layers * (steps + n_req),
            "segment_sum_sorted:bwd": 2 * layers * steps,
            "gather_rows_sorted:fwd": layers * (steps + n_req),
            "gather_rows_sorted:bwd": layers * steps}


def hold_step(label, got, cpu, amp_cpu=None) -> float:
    """An AdamW step's gradients (got["grads"]) and the parameters after
    it (got["params"], or the state's) against the CPU's float32 step
    (cpu). Float32: the gradients under phase 11's f32 rule, the
    parameters within 1e-6 where the CPU's gradient is above 1e-3 of its
    tensor's largest: there the first step is -lr (g / (|g| + eps) + wd
    p); a gradient that is rounding noise steps either way. amp (amp_cpu:
    the CPU's amp step): the gradients under phase 5's amp rule (per
    tensor at most TRAIN_AMP_FACTOR times the CPU amp's distance to cpu
    plus 2**-8 of the tensor's largest, TRAIN_AMP_FACTOR times it in L2
    over all), the parameters within 1e-6 of amp_cpu's where amp_cpu's
    gradient is above twice its tensor's bound (there both gradients
    have one sign). -> the share of the parameters held."""
    gmax = max(float(np.abs(g).max()) for g in cpu["grads"].values())
    after = "params" if "params" in cpu else "state"
    held = total = 0
    for k, g in cpu["grads"].items():
        gscale = float(np.abs(g).max())
        got_g = got["grads"][k]
        if amp_cpu is None:
            bound = TRAIN_F32_REL * gscale + TRAIN_F32_GLOBAL * gmax
            ref, sure = cpu, np.abs(g) > 1e-3 * gscale
        else:
            amp_g = amp_cpu["grads"][k]
            bound = (TRAIN_AMP_FACTOR * float(np.abs(amp_g - g).max())
                     + 2.0 ** -8 * gscale)
            ref, sure = amp_cpu, np.abs(amp_g) > 2 * bound
        err = float(np.abs(got_g - g).max())
        check(bool(np.isfinite(got_g).all()) and err <= bound,
              f"{label}: gradient {k} off the CPU's ({err:.3e} over "
              f"{bound:.3e})")
        check(np.allclose(got[after][k][sure], ref[after][k][sure], rtol=0,
                          atol=1e-6), f"{label}: {k} after the AdamW step")
        held += int(sure.sum())
        total += sure.size
    if amp_cpu is not None:
        def l2(a):
            return sum(float(((a["grads"][k] - g) ** 2).sum())
                       for k, g in cpu["grads"].items()) ** 0.5
        check(l2(got) <= TRAIN_AMP_FACTOR * l2(amp_cpu),
              f"{label}: amp gradient L2 distance {l2(got):.3e} vs the "
              f"CPU amp's {l2(amp_cpu):.3e}")
    return held / total


def hold_unc(label, got, amp_cpu, f32_cpu) -> float:
    """performance_levers' train_unc with amp (got) against the same run
    on the CPU: its steps and coverage amp_cpu's, each epoch's loss
    within 1e-3 relative of amp_cpu's (phase 5's amp loss bound), the
    embeddings finite, [30, 8] and within phase 5's amp rule of the CPU
    float32 run's (f32_cpu): TRAIN_AMP_FACTOR times amp_cpu's distance
    plus 2**-8 of their largest magnitude. -> the embeddings' error over
    its bound."""
    check(got["steps"] == amp_cpu["steps"]
          and got["coverage"] == amp_cpu["coverage"]
          and len(got["losses"]) == len(amp_cpu["losses"]),
          f"{label}: {got['steps']} steps, coverage {got['coverage']}, "
          f"{len(got['losses'])} epochs; the CPU's {amp_cpu['steps']}, "
          f"{amp_cpu['coverage']}, {len(amp_cpu['losses'])}")
    for i, (a, b) in enumerate(zip(got["losses"], amp_cpu["losses"])):
        check(np.isfinite(a) and abs(a - b) <= 1e-3 * abs(b),
              f"{label}: epoch {i} loss {a} vs the CPU's {b}")
    emb, ref = got["emb"], f32_cpu["emb"]
    check(emb.shape == (ex_pl.UNC_NODES, 8) and np.isfinite(emb).all(),
          f"{label}: embeddings of shape {emb.shape} or not finite")
    bound = (TRAIN_AMP_FACTOR * float(np.abs(amp_cpu["emb"] - ref).max())
             + 2.0 ** -8 * float(np.abs(ref).max()))
    err = float(np.abs(emb - ref).max())
    check(err <= bound, f"{label}: embeddings {err:.3e} from the CPU "
          f"float32 run's, bound {bound:.3e}")
    return err / bound


def examples_rank(world, spec) -> dict:
    """Phase 20's work in phase 18's ranks: the examples that run over
    ranks as this rank (multichip_dp's step on spec["state_dict"],
    edge_parallel's forward, performance_levers' owner-sharded
    train_unc), each run's launches counted from zero; over gloo also
    the owner-sharded train_unc's references, the same ranks on the CPU
    in float32 and amp ("halo_cpu")."""
    runs = (("dp", lambda: ex_dp.dp_step(world,
                                         state_dict=spec["state_dict"])),
            ("ep", lambda: ex_ep.ep_forward(world)),
            ("halo", lambda: ex_pl.unc_train(world)))
    out = {}
    for name, run in runs:
        sk.reset_launch_counts()
        out[name] = run()
        torch.cuda.synchronize()
        out[name]["launches"] = dict(sk.LAUNCHES)
    if world.backend == "gloo":
        on_cpu = dist.World(world.rank, world.size, torch.device("cpu"),
                            world.backend)
        out["halo_cpu"] = {amp: ex_pl.unc_train(on_cpu, amp=amp)
                           for amp in (False, True)}
    return out


def halo_cpu_one_rank() -> dict:
    """performance_levers' owner-sharded train_unc over a world of one
    rank on the CPU, float32 and amp: the NCCL world's reference, in this
    process (a gloo group of one, left before returning)."""
    with tempfile.TemporaryDirectory() as tmp:
        world = dist.init_world(0, 1, "gloo", "cpu",
                                os.path.join(tmp, "rdv"))
        try:
            return {amp: ex_pl.unc_train(world, amp=amp)
                    for amp in (False, True)}
        finally:
            torch.distributed.destroy_process_group()


def hold_rank_examples(results, sd) -> dict:
    """Each world's examples_rank results (label -> by rank) against the
    same examples on the CPU: the data-parallel loss within 1e-5
    relative of the one-device step's, its gradient and the parameters
    after it as hold_step holds them, K3 k3_launches a rank; the
    edge-partitioned forward's node rows and this rank's edge rows
    within phase 5's f32 bound of the one-rank forward's, K3 1 + 2
    (out-degrees, the two layers' sums) a rank; the owner-sharded
    train_unc as hold_unc holds it against the same world size on the
    CPU (the gloo ranks' own halo_cpu, the NCCL world's
    halo_cpu_one_rank), its embeddings equal over the ranks, K1's and
    K2's launches unc_example_launches' -> the paths entries."""
    paths = {}
    for label, ranks in results.items():
        n = len(ranks)
        one = ex_dp.dp_step(None, "cpu", n, sd)
        # E = 4,096 splits over 1 and 2 ranks: no pad edge
        ep_one = ex_ep.ep_forward(None, device="cpu")
        want_dp = k3_dict(k3_launches(ex_qs.CONFIG, train=True))
        want_ep = k3_dict(1 + ex_ep.LAYERS)
        blk = len(ep_one["edge_out"]) // n
        refs = [r.get("halo_cpu") for r in ranks]
        if refs[0] is None:
            check(n == 1, f"examples over {label}: no CPU reference")
            refs = [halo_cpu_one_rank()]
        worst = 0.0
        for r, res in enumerate(ranks):
            d, e, h = res["dp"], res["ep"], res["halo"]
            check(d["launches"] == want_dp and e["launches"] == want_ep,
                  f"example {label} rank {r}: K3 launched {d['launches']} "
                  f"(dp), {e['launches']} (ep); expected {want_dp}, "
                  f"{want_ep}")
            check(abs(d["loss"] - one["loss"]) <= 1e-5 * abs(one["loss"]),
                  f"example multichip_dp {label} rank {r}: loss "
                  f"{d['loss']} vs {one['loss']} on the CPU")
            hold_step(f"example multichip_dp {label} rank {r}", d, one)
            pairs = (("node", e["node_out"], ep_one["node_out"]),
                     ("edge", e["edge_out"],
                      ep_one["edge_out"][r * blk:(r + 1) * blk]))
            gmax = max(float(np.abs(w).max()) for _, _, w in pairs)
            for what, got, want in pairs:
                bound = (TRAIN_F32_REL * float(np.abs(want).max())
                         + TRAIN_F32_GLOBAL * gmax)
                err = float(np.abs(got - want).max())
                check(err <= bound, f"example edge_parallel {label} rank "
                      f"{r} {what}: err {err:.3e} exceeds {bound:.3e}")
            # every rank runs rank 0's steps; rank 0 counts them
            want_unc = unc_example_launches(ranks[0]["halo"]["steps"])
            check(h["launches"] == want_unc
                  and np.array_equal(h["emb"], ranks[0]["halo"]["emb"]),
                  f"example performance_levers halo {label} rank {r}: "
                  f"launched {h['launches']} (expected {want_unc}), or its "
                  "embeddings differ from rank 0's")
            ref = refs[min(r, len(refs) - 1)]
            worst = max(worst, hold_unc(
                f"example performance_levers halo {label} rank {r}", h,
                ref[True], ref[False]))
        tag = label.split()[0]
        for name in ("dp", "ep", "halo"):
            paths[f"example_{name}_{tag}_rank0"] = ranks[0][name]["launches"]
        print(f"examples over {label}: multichip_dp loss "
              f"{ranks[0]['dp']['loss']:.6f} (CPU one device "
              f"{one['loss']:.6f}); edge_parallel node and edge rows within "
              f"phase 5's bound; halo train_unc {ranks[0]['halo']['steps']} "
              f"steps, coverage {ranks[0]['halo']['coverage']:.2f}, losses "
              f"{ranks[0]['halo']['losses']} (CPU at {n} rank(s) "
              f"{refs[0][True]['losses']}), embeddings at {worst:.3f} of "
              "the amp bound")
    return paths


def phase_examples(dev, seed, dist_results) -> dict:
    """Phase 20 (b): quickstart_scm and performance_levers' SCM step (f32
    and amp) and single-device train_unc in this process on the card,
    against the same on the CPU: pred_c within SCM_F32_OUT_REL of its
    largest magnitude, the losses 1e-5 relative (f32) or under the amp
    rule, the gradients and the parameters after the step as hold_step
    holds them (the SCM step's amp run under its amp rule); K3's
    launches k3_launches' (the SCM step's 4 microbatches each a forward
    and a backward); train_unc's K1/K2 launches, and its losses and
    embeddings as hold_unc holds them. Weights: scm_model's perturbed
    seed weights. Then the ranks' examples (phase 18's spawns:
    hold_rank_examples). -> the paths entries."""
    t0 = time.perf_counter()
    paths = {}
    sd = scm_model(ex_qs.CONFIG, seed).state_dict()
    cpu = ex_qs.main("cpu", sd)
    sk.reset_launch_counts()
    card = ex_qs.main(str(dev), sd)
    paths["example_quickstart_scm"] = dict(sk.LAUNCHES)
    want = k3_dict(k3_launches(ex_qs.CONFIG, train=False)
                   + k3_launches(ex_qs.CONFIG, train=True))
    check(paths["example_quickstart_scm"] == want,
          f"example quickstart_scm: K3 launched "
          f"{paths['example_quickstart_scm']}, expected {want}")
    scale = float(np.abs(cpu["pred_c"]).max())
    check(float(np.abs(card["pred_c"] - cpu["pred_c"]).max())
          <= SCM_F32_OUT_REL * scale and scale > 0
          and abs(card["loss"] - cpu["loss"]) <= 1e-5 * abs(cpu["loss"]),
          f"example quickstart_scm: pred_c {card['pred_c'].ravel()} or loss "
          f"{card['loss']} vs the CPU's {cpu['pred_c'].ravel()}, "
          f"{cpu['loss']}")
    hold_step("example quickstart_scm", card, cpu)
    print(f"example quickstart_scm: pred_c {card['pred_c'].ravel()}, loss "
          f"{card['loss']:.6f} (CPU {cpu['loss']:.6f}), gradients and the "
          f"step within bound; K3 {want}")

    sd = scm_model(ex_pl.SCM_CONFIG, seed + 1).state_dict()
    cpu = {amp: ex_pl.scm_amp_microbatched("cpu", sd, amp) for amp in
           (False, True)}
    want = k3_dict(4 * k3_launches(ex_pl.SCM_CONFIG, train=True))
    for amp in (False, True):
        sk.reset_launch_counts()
        got = ex_pl.scm_amp_microbatched(str(dev), sd, amp)
        key = f"example_performance_levers_scm{'_amp' if amp else ''}"
        paths[key] = dict(sk.LAUNCHES)
        check(paths[key] == want, f"{key}: K3 launched {paths[key]}, "
              f"expected {want}")
        f32 = cpu[False]["losses"]
        for k, ref in f32.items():
            lc, lg = cpu[True]["losses"][k], got["losses"][k]
            bound = (TRAIN_AMP_FACTOR * abs(lc - ref)
                     + 2.0 ** -8 * abs(ref)) if amp else 1e-5 * abs(ref)
            check(np.isfinite(lg) and abs(lg - ref) <= bound,
                  f"{key}: loss {k} {lg} vs the CPU's {ref} (amp {lc})")
        held = hold_step(key, got, cpu[False], cpu[True] if amp else None)
        print(f"{key}, 4 microbatches: losses, gradients and the step "
              f"within bound of the CPU's ({held:.3f} of the parameters "
              f"held after it); K3 {paths[key]}")

    cpu = {amp: ex_pl.unc_train(None, "cpu", amp) for amp in (False, True)}
    sk.reset_launch_counts()
    got = ex_pl.unc_train(None, dev)
    paths["example_performance_levers_unc"] = dict(sk.LAUNCHES)
    want = unc_example_launches(got["steps"])
    check(paths["example_performance_levers_unc"] == want,
          f"example performance_levers train_unc: launched "
          f"{paths['example_performance_levers_unc']} (expected {want})")
    share = hold_unc("example performance_levers train_unc", got,
                     cpu[True], cpu[False])
    print(f"example performance_levers train_unc, one device, amp: "
          f"{got['steps']} steps, coverage {got['coverage']:.2f}, losses "
          f"{got['losses']} (CPU {cpu[True]['losses']}), embeddings at "
          f"{share:.3f} of the amp bound")
    paths.update(hold_rank_examples(dist_results, scm_model(
        ex_qs.CONFIG, seed).state_dict()))
    print(f"examples: phase 20 (b) took {time.perf_counter() - t0:.1f} s")
    return paths


def kernels_line(timed, timed_k1, timed_sc, rows, train_launches,
                 bench_launches, scm, scm_nets, scm_seq, scm_attn,
                 scm_mem, scm_dist, unc_halo, helpers) -> dict:
    """The {"kernels": [...]} line: per kernel its launches, error,
    times (event and device), its plain version's and one PyTorch
    call's (library), and its HBM bound."""
    src = "dualmessagepassing_tpu_torch/csrc/segment_kernels.cu"
    w = 2 * N_HIDDEN + 1

    def times(t, suffix=""):
        keys = ("ms", "device_ms", "plain_ms", "plain_device_ms",
                "library_ms", "library_device_ms", "bound_ms")
        return {k + suffix: t[k] for k in keys}

    def k12(name, replaces, main, others, ep_rank_step, halo_rank_step):
        fwd = train_launches[name + ":fwd"]
        bwd = train_launches[name + ":bwd"]
        out = {"name": name, "route": "cuda", "source": src,
               "replaces": replaces, "launches": fwd + bwd,
               "launches_fwd": fwd, "launches_bwd": bwd,
               "launches_ep_rank_step": ep_rank_step,
               "launches_halo_rank_step": halo_rank_step,
               "max_abs_err": max(t["err"] for t in (main, *others.values())),
               **times(main), "bound_by": "bytes"}
        for suffix, t in others.items():
            out.update(times(t, suffix))
        return out

    v_big, e_big = (int(t) for t in
                    kernel_bench.DEFAULT_SIZES.split(",")[-1].split("x"))
    v_small, e_small = (int(t) for t in
                        kernel_bench.DEFAULT_SIZES.split(",")[0].split("x"))
    by_size = {(r["V"], r["E"], r["variant"]): r for r in rows}
    plain_big, plain_small = timed_sc["plain"], timed_sc["plain_small"]

    def k34(name, source, replaces, variant, library, err, plain_key,
            index_bytes):
        """index_bytes(V, E): the index arrays' bytes at a size."""
        k = by_size[(v_big, e_big, variant)]
        lib = by_size[(v_big, e_big, library)]
        small = {key: by_size[(v_small, e_small, key)]
                 for key in (variant, library)}

        def bound(v, e):
            return hbm_ms((e * 64 + v * 64) * 4 + index_bytes(v, e))

        suffix = f"_{v_small}x{e_small}"
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": bench_launches[name],
                "max_abs_err": err, "ms": k["event_ms"],
                "device_ms": k["device_ms"],
                "plain_ms": plain_big[plain_key + "_ms"],
                "plain_device_ms": plain_big[plain_key + "_device_ms"],
                "library_ms": lib["event_ms"],
                "library_device_ms": lib["device_ms"], "library": library,
                "bound_ms": bound(v_big, e_big), "bound_by": "bytes",
                "size": f"{v_big}x{e_big}",
                "ms" + suffix: small[variant]["event_ms"],
                "device_ms" + suffix: small[variant]["device_ms"],
                "plain_ms" + suffix: plain_small[plain_key + "_ms"],
                "plain_device_ms" + suffix:
                    plain_small[plain_key + "_device_ms"],
                "library_device_ms" + suffix: small[library]["device_ms"],
                "bound_ms" + suffix: bound(v_small, e_small)}

    # K3's main path is phase 11's: its launches are the SCM learning
    # run's, its times those at the flagship train step's f32 H = 64
    # shape; the bench's stay beside them ("_bench")
    k3 = k34("segment_sum_unsorted",
             "dualmessagepassing_tpu_torch/csrc/scatter_kernels.cu",
             "dualmessagepassing_tpu/ops/pallas_scatter.py:109",
             "k3_segment_sum_unsorted", "plain_scatter", timed_sc["k3_err"],
             "k3", lambda v, e: e * 8)
    keys = ("launches", "max_abs_err", "ms", "device_ms", "plain_ms",
            "plain_device_ms", "library_ms", "library_device_ms", "bound_ms",
            "size")
    k3.update({k + "_bench": k3.pop(k) for k in keys})
    shapes = scm["k3"]
    k3.update(launches=scm["learn"]["launches"]["segment_sum_unsorted"],
              launches_scm_step=scm["step_launches"],
              max_abs_err=max(t["err"] for t in shapes.values()),
              size=f"{SCM_BSZ * 64}x{SCM_BSZ * 512}", **times(
                  shapes[("float32", 64)]))
    for (dtype, h), t in shapes.items():
        if (dtype, h) != ("float32", 64):
            k3.update(times(t, f"_{dtype}_h{h}"))
    # phase 14's two call shapes: the relation fold and the LRP pool
    for (call, dtype), t in scm_nets["k3"].items():
        k3.update(times(t, f"_{call}" + ("" if dtype == "float32"
                                         else f"_{dtype}")))
        k3["max_abs_err"] = max(k3["max_abs_err"], t["err"])
    k3["launches_scm_nets_step"] = {net: scm_nets[net]["step_launches"]
                                    for net in SCM_NETS}
    # phase 15: the sequence networks launch K3 for pred_with_deg's
    # degree tables only, at one call shape
    k3.update(times(scm_seq["k3_deg"], "_edgeseq_deg"))
    k3["max_abs_err"] = max(k3["max_abs_err"], scm_seq["k3_deg"]["err"])
    k3["launches_scm_seq_deg_step"] = {
        net: scm_seq[net]["deg_step"].get("segment_sum_unsorted", 0)
        for net in SEQ_NETS}
    # phase 16: the attention predict nets launch no K3 of their own
    k3["launches_scm_attn_step"] = {net: r["step_launches"]
                                    for net, r in scm_attn.items()}
    # phase 17: nor do the memory predict nets
    k3["launches_scm_mem_step"] = {net: r["step_launches"]
                                   for net, r in scm_mem.items()
                                   if "step_launches" in r}
    # phase 18: each DP rank's 64 pairs
    dk = scm_dist["kernels"]
    k3.update(times(dk["K3"], "_dp_rank"))
    k3["max_abs_err"] = max(k3["max_abs_err"], dk["K3"]["err"])
    k3["launches_dp_rank_step"] = scm_dist["launches"]["dp_step_per_rank"]
    # the E4 work: the demonstration layer's partial aggregation and the
    # halo layer's local one, each rank 0's of two
    for name in ("ep_layer", "halo_layer"):
        k3.update(times(dk[f"K3_{name}"], f"_{name}"))
        k3["max_abs_err"] = max(k3["max_abs_err"], dk[f"K3_{name}"]["err"])
    e4 = scm_dist["launches"]["e4"]
    k3["launches_ep_layer_step"] = {
        k[len("ep_layer_"):-len("_step")]: v.get("segment_sum_unsorted", 0)
        for k, v in e4.items() if k.endswith("_step")}
    k3["launches_halo_bench_rank0"] = e4["halo_bench"].get(
        "segment_sum_unsorted", 0)
    # phase 20: the helpers' call shapes (the flagship's flat sum is the
    # SCM step's shape above); launches per call and per backward
    for (shape, dtype), t in helpers["k3"].items():
        k3.update(times(t, f"_{shape}" + ("" if dtype == "float32"
                                          else f"_{dtype}")))
        k3["max_abs_err"] = max(k3["max_abs_err"], t["err"])
    k3["launches_helpers"] = helpers["launches"]
    per_rank = scm_dist["launches"]["ep_step_per_rank"]
    hk = unc_halo["kernels"]
    halo_step = unc_halo["launches_step"]

    return {"kernels": [
        k12("segment_sum_sorted",
            "dualmessagepassing_tpu/ops/segment_kernel.py:261",
            timed_k1[("float32", "recv", N_HIDDEN)],
            {f"_recv_w{w}": timed_k1[("float32", "recv", w)],
             f"_send_w{w}": timed_k1[("float32", "send", w)],
             "_ep_shard": dk["K1"], "_halo_vp": hk["K1_vp"],
             "_halo_vt_send": hk["K1_vt_send"]},
            {k: v for k, v in per_rank.items()
             if k.startswith("segment_sum_sorted")},
            {k: v for k, v in halo_step.items()
             if k.startswith("segment_sum_sorted")}),
        k12("gather_rows_sorted",
            "dualmessagepassing_tpu/ops/segment_kernel.py:572",
            timed[("float32", "K2", w)],
            {f"_w{N_HIDDEN}": timed[("float32", "K2", N_HIDDEN)],
             "_ep_shard": dk["K2"], "_halo_table": hk["K2_table"]},
            {k: v for k, v in per_rank.items()
             if k.startswith("gather_rows_sorted")},
            {k: v for k, v in halo_step.items()
             if k.startswith("gather_rows_sorted")}),
        k3,
        k34("csr_segment_sum", src,
            "dualmessagepassing_tpu/ops/pallas_scatter.py:225",
            "k4_csr_segment_sum", "plain_scatter_sorted",
            timed_sc["k4_err"], "k4", lambda v, e: (v + 1) * 4),
    ]}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()

    # phase 0: device
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0])
    kind = torch.cuda.get_device_name(0)
    print(f"device: {kind} x{torch.cuda.device_count()}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}, python "
          f"{sys.version.split()[0]}")
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # phase 1: build
    t0 = time.perf_counter()
    wall = build_cuda_kernels()
    for lib in ALL_CUDA_KERNELS:
        print(f"build: {lib.src.name} (nvcc sm_90a) "
              f"{lib.build_seconds:.2f} s")
        for line in lib.build_log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: ptxas {line.strip()}")
    print(f"build: CUDA libraries {wall:.2f} s wall, built at once")
    t0 = time.perf_counter()
    sampler = "native" if native.available() else "numpy"
    print(f"build: host sampler ({sampler}) {time.perf_counter() - t0:.2f} s")

    # phase 2: kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    timed = phase_kernels(dev, rng,
                          np.random.default_rng(args.seed + 7))
    timed_sc = phase_scatter_kernels(dev)
    phase_functions(dev, rng)

    # phase 3: the model on the card against the model on the CPU
    t0 = time.perf_counter()
    triplets = synthetic_hin(rng=rng, **PUBMED)
    graph = WholeGraph(PUBMED["num_nodes"], PUBMED["num_rels"], triplets)
    print(f"data: synthetic PubMed-scale HIN, {graph.num_nodes} nodes, "
          f"{len(triplets)} links, {graph.num_edges} directed edges, "
          f"max in-degree {graph.in_deg.max()}, "
          f"{time.perf_counter() - t0:.1f} s")
    model = make_model(PUBMED["num_nodes"], PUBMED["num_rels"], args.seed)
    phase_model(model, graph, triplets, args.seed + 1, dev)

    # phase 4: serving at the unc_infer envelope, counted from zero
    inf_triplets = synthetic_hin(rng=rng, **UNC_INFER)
    inf_graph = WholeGraph(UNC_INFER["num_nodes"], UNC_INFER["num_rels"],
                           inf_triplets)
    inf_model = make_model(UNC_INFER["num_nodes"], UNC_INFER["num_rels"],
                           args.seed + 3).to(dev)
    sk.reset_launch_counts()
    _, _, inf_recs = run_export(
        inf_model, inf_graph, inf_triplets, UNC_INFER["num_links"] // 4,
        True, args.seed + 4, "amp-bf16 unc_infer")
    check(len(inf_recs) == 1, "unc_infer export is one request")
    launches = dict(sk.LAUNCHES)
    check(launches == {"segment_sum_sorted:fwd": N_LAYERS,
                       "gather_rows_sorted:fwd": N_LAYERS},
          f"unc_infer launches {launches}")
    print(f"serve: launches {launches}")
    del inf_model, inf_graph, inf_triplets

    # phase 5: training — the main path, counted from zero
    phase_train_grads(model, graph, triplets, args.seed + 5, dev)
    timed_k1 = phase_k1_train_shapes(graph, triplets, args.seed + 5, dev)
    phase_profile(model, graph, triplets, args.seed + 6, dev)
    model = model.to(dev)
    train_launches, emb = phase_train(model, triplets, args.seed + 2)

    # phase 6: the kernel bench, counted from zero
    sk.reset_launch_counts()
    iters = 20
    rows = kernel_bench.run(kernel_bench.DEFAULT_SIZES, iters=iters,
                            print_fn=lambda line: print(f"bench: {line}"))
    bench_launches = dict(sk.LAUNCHES)
    # check, warm-up, events, profiler (more where a trace is taken again)
    per_size = 1 + 3 + 2 * iters
    n_sizes = len(kernel_bench.DEFAULT_SIZES.split(","))
    for name in ("segment_sum_unsorted", "csr_segment_sum"):
        check(bench_launches.get(name, 0) >= per_size * n_sizes,
              f"bench launched {name} {bench_launches.get(name, 0)} times")
    print(f"bench: launches {bench_launches}; total "
          f"{time.perf_counter() - t_start:.1f} s after the device check")
    # phase 18's kernels at its shapes, while the process is young
    dist_data = dist_inputs(args.seed + 50, graph, triplets)
    dist_k = dist_kernels(dev, *dist_data, args.seed + 54)
    # phase 19's at a halo rank's shapes, and K3 at phase 18's E4 shapes
    halo_k = halo_kernels(dev, dist_data[1], args.seed + 55)
    dist_k.update({f"K3_{k}": v for k, v in
                   e4_kernels(dev, args.seed + 56).items()})
    del dist_data
    # phase 20 (a): the helpers and K3 at their shapes, as early
    helpers = phase_helpers(dev, args.seed + 60)

    # phases 7-10: the other backbones, attributed inputs, supervised
    # training and the evaluation, each training run counted from zero
    backbones = phase_backbones(graph, triplets, args.seed + 8, dev)
    attributed = phase_attributed(graph, triplets, args.seed + 9, dev)
    supervised = phase_supervised(graph, triplets, args.seed + 11, dev)
    phase_evaluate(emb, triplets, supervised["single"]["labels"],
                   args.seed + 12)
    paths = {f"{k}_train_unc": v["launches_run"]
             for k, v in backbones.items()}
    paths["attributed_DMPNN_step"] = attributed["launches_step"]
    paths.update({f"supervised_{k}": v["launches_run"]
                  for k, v in supervised.items()})
    print(f"phases 7-10 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 11: the SCM flagship, its learning run counted from zero
    scm = phase_scm(dev, args.seed + 13)
    paths["scm_learning_run"] = scm["learn"]["launches"]
    print(f"phase 11 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phases 12-13: the SCM command lines and the learning gates, each
    # run counted from zero
    cli_paths, cli_data = phase_scm_cli(args.seed)
    paths.update(cli_paths)
    paths.update(phase_gates(dev))
    print(f"phases 12-13 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 14: the SCM graph networks, each command line counted from zero
    scm_nets, net_paths = phase_scm_nets(dev, args.seed, cli_data)
    paths.update(net_paths)
    print(f"phase 14 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 15: the SCM sequence networks, each run counted from zero
    scm_seq, seq_paths = phase_scm_seq(dev, args.seed + 20, cli_data)
    paths.update(seq_paths)
    print(f"phase 15 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 16: the attention predict nets and the remat repair, each run
    # counted from zero
    scm_attn, attn_paths = phase_scm_attn(dev, args.seed + 30, cli_data)
    paths.update(attn_paths)
    print(f"phase 16 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 17: the memory predict nets, each run counted from zero
    scm_mem, mem_paths = phase_scm_mem(dev, args.seed + 40, cli_data)
    paths.update(mem_paths)
    print(f"phase 17 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 18: data-parallel SCM and edge-partitioned UNC training over
    # torch.distributed, the runs over the ranks counted from zero
    examples = dict(state_dict=scm_model(ex_qs.CONFIG,
                                         args.seed + 61).state_dict())
    scm_dist, dist_paths = phase_dist(dev, args.seed + 50, graph, triplets,
                                      dist_k, examples)
    paths.update(dist_paths)
    print(f"phase 18 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 19: owner-sharded (halo) UNC training over torch.distributed
    # and the north-star gate, the runs over the ranks counted from zero
    unc_halo, halo_paths = phase_halo(dev, args.seed + 50, triplets,
                                      scm_dist.pop("refs"), halo_k)
    paths.update(halo_paths)
    print(f"phase 19 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    # phase 20 (b): the examples on the card, those over ranks run in
    # phase 18's spawns, each run counted from zero
    paths.update(phase_examples(dev, args.seed + 61,
                                scm_dist.pop("examples")))
    print(json.dumps({"paths": paths}))
    print(f"phase 20 done; total {time.perf_counter() - t_start:.1f} s "
          "after the device check")

    print(json.dumps(kernels_line(timed, timed_k1, timed_sc, rows,
                                  train_launches, bench_launches, scm,
                                  scm_nets, scm_seq, scm_attn, scm_mem,
                                  scm_dist, unc_halo, helpers)))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
