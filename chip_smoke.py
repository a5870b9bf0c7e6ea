#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): UNC DMPNN
training and embedding export, and the kernel bench, with the port's
four CUDA kernels built from this checkout.

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
             (K2_OFFSETS); K3 and K4 at the kernel
             bench's four sizes; the three autograd Functions' gradients
             at the training path's shapes against the same Functions on
             the CPU (plain versions). Then K1 (W = 50, 101) and K2
             (W = 101, 50) and their plain versions timed at the path's
             shapes, f32 and bf16: CUDA events around the call and the
             device time torch.profiler records (kernel_bench.time_call);
  3 model    one sampled PubMed-scale batch through the model on the card
             and on the CPU (plain kernel versions), f32 and amp bf16;
  4 serving  export_embeddings in amp bf16 at the unc_infer envelope
             (V=65,536, E=524,288, R=3); the forward launch counts must
             rise by n_layers per forward;
  5 training one PubMed-scale training batch: the loss and every
             parameter gradient on the card against the CPU, f32 and amp
             bf16; a torch.profiler trace of three train steps (top device
             operations); then train_unc at the run.sh configuration with
             n_epochs=1 (rescaled to 4 epochs of 25 steps, unless the loss
             rises first) and its f32 export of 7 requests. One line per
             epoch: loss, host sampling ms, step ms (CUDA events), device
             busy and idle share. Per step K1 must launch 2 forward and 4
             backward times and K2 2 and 2; per export request each 2;
  6 bench    the port's kernel bench (bench/kernel_bench.py) at 20
             iterations, one JSON line per variant with its event and
             device times; K3 and K4 launched.

The model is the reference's UNC DMPNN run.sh configuration (n_hidden 50,
n_layers 2, negative_sample 5, graph_batch_size 10000, graph_split_size
0.5, randomwalk sampler, depth 3, width 10) on a synthetic heterogeneous
graph of PubMed's published size (63,109 nodes, 244,986 links, 10 link
types) made from --seed, with random weights from a CPU torch.Generator.

The second-to-last line is {"kernels": [...]}: per kernel its launches
(K1, K2: phase 5's training and export, forward and backward; K3, K4:
phase 6's kernel bench), its max abs error against the plain version,
and the kernel's and the plain version's times, each as CUDA-event ms
("ms", "plain_ms") and torch.profiler device ms ("device_ms",
"plain_device_ms"): f32 at the path's shapes for K1 (W = 50; "_w101")
and K2 (W = 101; "_w50"), the bench's largest size for K3 and K4 (their
plain versions: the bench's index_add_ variants). The last line is
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from dualmessagepassing_tpu_torch import native
from dualmessagepassing_tpu_torch.bench import kernel_bench
from dualmessagepassing_tpu_torch.models.layers import MaskedBatchNorm
from dualmessagepassing_tpu_torch.ops import scatter_kernels as sc
from dualmessagepassing_tpu_torch.ops import segment_kernel as sk
from dualmessagepassing_tpu_torch.ops.build import (ALL_CUDA_KERNELS,
                                                    build_cuda_kernels)
from dualmessagepassing_tpu_torch.unc.data import WholeGraph, save_embeddings
from dualmessagepassing_tpu_torch.unc.driver import (export_embeddings,
                                                     make_unc_optimizer,
                                                     make_unc_train_step,
                                                     sample_batch, to_device,
                                                     train_unc)
from dualmessagepassing_tpu_torch.unc.model import (UNCTrainModel,
                                                    apply_unc_forward)

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
# rows of <= 16 edges, and ~12 standard deviations of random-order
# rounding for the 5,000-edge hub. bf16 adds one bf16 ulp (2**-7 rel) of
# the output, since both round their f32 sum once. Empty rows are 0.
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


def make_model(num_nodes: int, num_rels: int, seed: int) -> UNCTrainModel:
    """Random port weights from a CPU generator, with non-trivial
    BatchNorm affine terms and running statistics."""
    gen = torch.Generator().manual_seed(seed)
    model = UNCTrainModel(num_nodes, num_rels, N_HIDDEN,
                          num_hidden_layers=N_LAYERS, dropout=0.2,
                          reg_param=REG, generator=gen)
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


def check_k1(msg, row_ptr, empty) -> float:
    got = sk.segment_sum_sorted(msg, row_ptr)
    want = sk.segment_sum_sorted_plain(msg, row_ptr)
    abs_sum = sk.segment_sum_sorted_plain(msg.float().abs(), row_ptr)
    err = (got.float() - want.float()).abs()
    bound = K1_ABS_SUM_TOL * abs_sum
    if msg.dtype == torch.bfloat16:
        bound = bound + BF16_REL * torch.maximum(got.float().abs(),
                                                 want.float().abs())
    check(bool((err <= bound).all()),
          f"K1 {msg.dtype} H={msg.shape[1]}: max err {err.max().item()} "
          "exceeds the stated bound")
    check(bool((got[empty[0]: empty[1]] == 0).all()), "K1 empty rows not 0")
    return err.max().item()


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
                      f"K1 max abs err {err:.3e} (within bound), "
                      f"K2 bitwise equal at (table, out) element offsets "
                      f"{K2_OFFSETS}")

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
                share = nbytes / (kernel_bench.HBM_GBPS * 1e6) / times[
                    "device_ms"]
                print(f"timing {name}: K2 W={h} moves {nbytes / 1e6:.1f} MB:"
                      f" {100 * share:.1f} % of HBM bandwidth (3.35 TB/s) "
                      "by device time")
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
    sizes (H = 64; K3 also in bf16); the errors at the largest. Phase 6's
    kernel bench times them."""
    with torch.inference_mode():
        for spec in kernel_bench.DEFAULT_SIZES.split(","):
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
    return dict(k3_err=errs["K3 float32"], k4_err=errs["K4 float32"])


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


def phase_train_grads(model, graph, triplets, seed, dev) -> dict:
    padded = train_batch(graph, triplets, seed)
    cpu_model = copy.deepcopy(model).cpu()
    dev_model = copy.deepcopy(model).to(dev)
    sub_cpu, sub_dev = to_device(padded, "cpu"), to_device(padded, dev)
    res = {(where, amp): loss_and_grads(m, sub, amp)
           for where, m, sub in (("cpu", cpu_model, sub_cpu),
                                 ("card", dev_model, sub_dev))
           for amp in (False, True)}
    torch.cuda.synchronize()
    print(f"train grads: batch of {GBS} triplets, n_real "
          f"{padded['n_real']}, {int(padded['node_mask'].sum())} nodes")
    f32 = res[("cpu", False)][1]
    gmax = max(g.abs().max().item() for g in f32.values())

    def dist(a, b):
        return sum(((a[k] - b[k]) ** 2).sum().item() for k in a) ** 0.5

    worst = {}
    for amp in (False, True):
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
        print(f"train grads {name}: loss card {ld:.7f} cpu {lc:.7f}; "
              f"{len(gc)} gradients within bound (worst at "
              f"{ratio:.3f} of it)" + (
                  f"; L2 to cpu f32: card {l2_card:.3e}, cpu amp "
                  f"{l2_cpu:.3e}" if amp else ""))
    return worst


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
        total = sum(kernel_bench.device_us(e) for e in events) / 3e3
        name = "amp bf16" if amp else "f32"
        print(f"profile {name}: {total:.3f} ms device time per train step "
              f"(torch.profiler, 3 steps), {wall:.3f} ms wall per step")
        for e in sorted(events, key=kernel_bench.device_us,
                        reverse=True)[:12]:
            ms = kernel_bench.device_us(e) / 3e3
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
    return launches


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
    phase_profile(model, graph, triplets, args.seed + 6, dev)
    model = model.to(dev)
    train_launches = phase_train(model, triplets, args.seed + 2)

    # phase 6: the kernel bench, counted from zero
    sk.reset_launch_counts()
    iters = 20
    rows = kernel_bench.run(kernel_bench.DEFAULT_SIZES, iters=iters,
                            print_fn=lambda line: print(f"bench: {line}"))
    bench_launches = dict(sk.LAUNCHES)
    per_size = 1 + 3 + 2 * iters    # check, warm-up, events, profiler
    n_sizes = len(kernel_bench.DEFAULT_SIZES.split(","))
    for name in ("segment_sum_unsorted", "csr_segment_sum"):
        check(bench_launches.get(name, 0) == per_size * n_sizes,
              f"bench launched {name} {bench_launches.get(name, 0)} times")
    print(f"bench: launches {bench_launches}; total "
          f"{time.perf_counter() - t_start:.1f} s after the device check")

    src = "dualmessagepassing_tpu_torch/csrc/segment_kernels.cu"
    w = 2 * N_HIDDEN + 1

    def times(t, suffix=""):
        return {f"ms{suffix}": t["ms"], f"device_ms{suffix}": t["device_ms"],
                f"plain_ms{suffix}": t["plain_ms"],
                f"plain_device_ms{suffix}": t["plain_device_ms"]}

    def k12(name, replaces, main, other, suffix):
        fwd = train_launches[name + ":fwd"]
        bwd = train_launches[name + ":bwd"]
        return {"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": fwd + bwd,
                "launches_fwd": fwd, "launches_bwd": bwd,
                "max_abs_err": max(main["err"], other["err"]),
                **times(main), **times(other, suffix)}

    v_big, e_big = (int(t) for t in
                    kernel_bench.DEFAULT_SIZES.split(",")[-1].split("x"))
    largest = {r["variant"]: r for r in rows
               if (r["V"], r["E"]) == (v_big, e_big)}

    def k34(name, source, replaces, variant, plain, err):
        k, p = largest[variant], largest[plain]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": bench_launches[name],
                "max_abs_err": err, "ms": k["event_ms"],
                "device_ms": k["device_ms"], "plain_ms": p["event_ms"],
                "plain_device_ms": p["device_ms"], "plain": plain,
                "size": f"{v_big}x{e_big}"}

    print(json.dumps({"kernels": [
        k12("segment_sum_sorted",
            "dualmessagepassing_tpu/ops/segment_kernel.py:261",
            timed[("float32", "K1", N_HIDDEN)], timed[("float32", "K1", w)],
            f"_w{w}"),
        k12("gather_rows_sorted",
            "dualmessagepassing_tpu/ops/segment_kernel.py:572",
            timed[("float32", "K2", w)], timed[("float32", "K2", N_HIDDEN)],
            f"_w{N_HIDDEN}"),
        k34("segment_sum_unsorted",
            "dualmessagepassing_tpu_torch/csrc/scatter_kernels.cu",
            "dualmessagepassing_tpu/ops/pallas_scatter.py:109",
            "k3_segment_sum_unsorted", "plain_scatter", timed_sc["k3_err"]),
        k34("csr_segment_sum", src,
            "dualmessagepassing_tpu/ops/pallas_scatter.py:225",
            "k4_csr_segment_sum", "plain_scatter_sorted",
            timed_sc["k4_err"]),
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
