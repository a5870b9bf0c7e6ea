#!/usr/bin/env python3
"""Smoke run of the PyTorch port on one NVIDIA GPU (H100): the UNC DMPNN
embedding export, with its two CUDA kernels built from this checkout.

    python3 chip_smoke.py          # from the root of the checkout

Phases (any failure raises and the script exits non-zero):
  0 device   require CUDA; print nvidia-smi's name and power limit, the
             torch and CUDA versions;
  1 build    nvcc-build the segment kernels and g++-build the host
             sampler; print the seconds each took and which sampler runs;
  2 kernels  each kernel against its plain PyTorch version on the card
             (f32 and bf16, widths 1/50/101/128, a hub row of 5,000
             edges, empty rows, a pad tail), then both timed with CUDA
             events at the export path's shapes;
  3 model    one sampled PubMed-scale batch through the model on the card
             and on the CPU (plain kernel versions), f32 and amp bf16;
  4 serving  export_embeddings over the synthetic PubMed-scale HIN (7
             requests of 40,000 triplets, f32), then once in amp bf16 at
             the unc_infer envelope (V=65,536, E=524,288, R=3); the kernel
             launch counts must rise by n_layers per forward.

The model is the reference's UNC DMPNN run.sh configuration (n_hidden 50,
n_layers 2, negative_sample 5, graph_batch_size 10000, graph_split_size
0.5, randomwalk sampler, depth 3, width 10) on a synthetic heterogeneous
graph of PubMed's published size (63,109 nodes, 244,986 links, 10 link
types) made from --seed, with random weights from a CPU torch.Generator.

The second-to-last line is {"kernels": [...]}: per kernel its launches
in phase 4, its max abs error against the plain version and both times
(f32, path shapes). The last line is
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
from dualmessagepassing_tpu_torch.models.layers import MaskedBatchNorm
from dualmessagepassing_tpu_torch.ops import segment_kernel as sk
from dualmessagepassing_tpu_torch.ops.build import CUDA_KERNELS
from dualmessagepassing_tpu_torch.unc.data import WholeGraph, save_embeddings
from dualmessagepassing_tpu_torch.unc.driver import (export_embeddings,
                                                     sample_batch, to_device)
from dualmessagepassing_tpu_torch.unc.model import (UNCTrainModel,
                                                    apply_unc_forward)

# the reference's UNC DMPNN run.sh (tests/test_reference_commands.py:154)
N_HIDDEN, N_LAYERS, NEG, GBS = 50, 2, 5, 10000
SPLIT, DEPTH, WIDTH = 0.5, 3, 10
# PubMed's published size (SURVEY.md:456)
PUBMED = dict(num_nodes=63109, num_links=244986, num_rels=10)
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
                          generator=gen)
    with torch.no_grad():
        for bn in model.modules():
            if isinstance(bn, MaskedBatchNorm):
                f = bn.weight.numel()
                bn.weight.add_(0.1 * torch.randn(f, generator=gen))
                bn.bias.add_(0.1 * torch.randn(f, generator=gen))
                bn.running_mean.copy_(0.1 * torch.randn(f, generator=gen))
                bn.running_var.copy_(0.5 + torch.rand(f, generator=gen))
    return model


def cuda_median_ms(fn, runs: int = 30, warmup: int = 3) -> float:
    """Median over `runs` launches of fn, each timed with CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


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


def check_k2(table, idx, n_real) -> float:
    got = sk.gather_rows_sorted(table, idx, n_real)
    want = sk.gather_rows_sorted_plain(table, idx, n_real)
    bits = torch.int16 if got.dtype == torch.bfloat16 else torch.int32
    check(torch.equal(got.view(bits), want.view(bits)),
          f"K2 {table.dtype} W={table.shape[1]} not bitwise equal")
    check(bool((got[n_real:] == 0).all()), "K2 pad tail not zero")
    return (got.float() - want.float()).abs().max().item()


def phase_kernels(dev, rng) -> dict:
    with torch.inference_mode():
        for dtype in (torch.float32, torch.bfloat16):
            for width in (1, 50, 101, 128):
                msg, rp, table, idx, n_real = kernel_case(
                    rng, 6000, 25000, 3000, 5000, (1000, 2000), width,
                    dtype, dev)
                err = check_k1(msg, rp, (1000, 2000))
                check_k2(table, idx, n_real)
                torch.cuda.synchronize()
                print(f"kernels: {str(dtype)[6:]:8s} width {width:3d} "
                      f"K1 max abs err {err:.3e} (within bound), "
                      "K2 bitwise equal")

        # timing at the export path's shapes: E = e_max of the PubMed
        # envelope, all real; K1 H = 50, K2 width 2H+1 = 101
        v, e = PUBMED["num_nodes"], 489972
        timed = {}
        for dtype in (torch.float32, torch.bfloat16):
            recv = np.sort(rng.integers(0, v, e))
            row_ptr = torch.from_numpy(
                np.searchsorted(recv, np.arange(v + 1)).astype(np.int32)
            ).to(dev)
            idx = torch.from_numpy(recv).to(dev)
            msg = torch.from_numpy(rng.normal(size=(e, N_HIDDEN)).astype(
                np.float32)).to(dev, dtype)
            table = torch.from_numpy(rng.normal(
                size=(v, 2 * N_HIDDEN + 1)).astype(np.float32)).to(dev, dtype)
            k1_err = check_k1(msg, row_ptr, (0, 0))
            k2_err = check_k2(table, idx, e)
            k1 = cuda_median_ms(lambda: sk.segment_sum_sorted(msg, row_ptr))
            k1p = cuda_median_ms(
                lambda: sk.segment_sum_sorted_plain(msg, row_ptr))
            k2 = cuda_median_ms(lambda: sk.gather_rows_sorted(table, idx, e))
            k2p = cuda_median_ms(
                lambda: sk.gather_rows_sorted_plain(table, idx, e))
            name = str(dtype)[6:]
            print(f"timing {name}: K1 segment_sum_sorted E={e} V={v} "
                  f"H={N_HIDDEN}: kernel {k1:.4f} ms, plain {k1p:.4f} ms")
            print(f"timing {name}: K2 gather_rows_sorted E={e} V={v} "
                  f"W={2 * N_HIDDEN + 1}: kernel {k2:.4f} ms, "
                  f"plain {k2p:.4f} ms")
            timed[name] = dict(k1=k1, k1p=k1p, k2=k2, k2p=k2p,
                               k1_err=k1_err, k2_err=k2_err)
    return timed


# --- phase 3: model on the card against the CPU ---------------------------

def phase_model(model, graph, triplets, seed) -> None:
    padded = sk.attach_csr_plan(sample_batch(
        graph, triplets[: 4 * GBS], "randomwalk", DEPTH, WIDTH, SPLIT, NEG,
        graph.num_nodes, min(graph.num_nodes * WIDTH, graph.num_edges),
        4 * GBS * (1 + NEG), np.random.default_rng(seed)))
    nm = torch.from_numpy(padded["node_mask"])
    cpu_model = copy.deepcopy(model).cpu()
    dev_model = copy.deepcopy(model).cuda()
    sub_cpu = to_device(padded, "cpu")
    sub_dev = to_device(padded, "cuda")
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


# --- phase 4: serving -----------------------------------------------------

def run_export(model, graph, triplets, gbs, amp, seed, label):
    records = []
    start = dict(sk.LAUNCHES)

    def on_request(rec):
        launches = dict(sk.LAUNCHES)
        prev = records[-1]["launches"] if records else start
        for name in ("segment_sum_sorted", "gather_rows_sorted"):
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
    CUDA_KERNELS.load()
    print(f"build: segment kernels (nvcc sm_90a) "
          f"{CUDA_KERNELS.build_seconds:.2f} s")
    for line in CUDA_KERNELS.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas {line.strip()}")
    t0 = time.perf_counter()
    sampler = "native" if native.available() else "numpy"
    print(f"build: host sampler ({sampler}) {time.perf_counter() - t0:.2f} s")

    # phase 2: kernels against their plain versions
    rng = np.random.default_rng(args.seed)
    timed = phase_kernels(dev, rng)

    # phase 3: the model on the card against the model on the CPU
    t0 = time.perf_counter()
    triplets = synthetic_hin(rng=rng, **PUBMED)
    graph = WholeGraph(PUBMED["num_nodes"], PUBMED["num_rels"], triplets)
    print(f"data: synthetic PubMed-scale HIN, {graph.num_nodes} nodes, "
          f"{len(triplets)} links, {graph.num_edges} directed edges, "
          f"max in-degree {graph.in_deg.max()}, "
          f"{time.perf_counter() - t0:.1f} s")
    model = make_model(PUBMED["num_nodes"], PUBMED["num_rels"], args.seed)
    phase_model(model, graph, triplets, args.seed + 1)

    # phase 4: serving — the main path, counted from zero
    model = model.to(dev)
    sk.reset_launch_counts()
    emb, cov, recs = run_export(model, graph, triplets, GBS, False,
                                args.seed + 2, "f32")
    check(len(recs) == 7, f"{len(recs)} export requests, expected 7")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "emb.dat")
        save_embeddings(path, "chip_smoke synthetic PubMed", emb)
        with open(path) as f:
            n_lines = sum(1 for _ in f)
    check(n_lines == graph.num_nodes + 1, f"emb.dat has {n_lines} lines")
    print(f"serve f32: coverage {cov:.4f}, emb.dat {n_lines} lines")

    inf_triplets = synthetic_hin(rng=rng, **UNC_INFER)
    inf_graph = WholeGraph(UNC_INFER["num_nodes"], UNC_INFER["num_rels"],
                           inf_triplets)
    inf_model = make_model(UNC_INFER["num_nodes"], UNC_INFER["num_rels"],
                           args.seed + 3).to(dev)
    _, _, inf_recs = run_export(
        inf_model, inf_graph, inf_triplets, UNC_INFER["num_links"] // 4,
        True, args.seed + 4, "amp-bf16 unc_infer")
    check(len(inf_recs) == 1, "unc_infer export is one request")
    launches = dict(sk.LAUNCHES)
    n_forwards = len(recs) + len(inf_recs)
    for name in ("segment_sum_sorted", "gather_rows_sorted"):
        check(launches.get(name, 0) == N_LAYERS * n_forwards,
              f"{name}: {launches.get(name, 0)} launches in the main path, "
              f"expected {N_LAYERS * n_forwards}")
    print(f"serve: {n_forwards} forwards, launches {launches}, total "
          f"{time.perf_counter() - t_start:.1f} s after the device check")

    f32 = timed["float32"]
    src = "dualmessagepassing_tpu_torch/csrc/segment_kernels.cu"
    print(json.dumps({"kernels": [
        {"name": "segment_sum_sorted", "route": "cuda", "source": src,
         "replaces": "dualmessagepassing_tpu/ops/segment_kernel.py:261",
         "launches": launches["segment_sum_sorted"],
         "max_abs_err": f32["k1_err"], "ms": f32["k1"],
         "plain_ms": f32["k1p"]},
        {"name": "gather_rows_sorted", "route": "cuda", "source": src,
         "replaces": "dualmessagepassing_tpu/ops/segment_kernel.py:572",
         "launches": launches["gather_rows_sorted"],
         "max_abs_err": f32["k2_err"], "ms": f32["k2"], "plain_ms": f32["k2p"]},
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
