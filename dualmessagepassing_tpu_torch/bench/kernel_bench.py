"""Segment-sum and row-gather microbenchmark on one NVIDIA GPU — the
port of scripts/kernel_bench.py.

    python -m dualmessagepassing_tpu_torch.bench.kernel_bench [--iters 20]

For each V x E size (the JAX script's defaults) and H = 64 it times
these variants:

  plain_scatter         zeros.index_add_(recv, msg), unsorted stream
  plain_scatter_sorted  the same on the receiver-sorted stream
  onehot_matmul         one_hot(recv).T @ msg, only where the [E, V]
                        float32 one-hot fits in 1 GiB
  k3_segment_sum_unsorted  K3, the unsorted stream (ops/scatter_kernels)
  k4_csr_segment_sum    K4, the sorted stream and its row pointer
  k1_segment_sum_sorted K1 (ops/segment_kernel), the same inputs
and the gather pair over a [V, 128] bf16 table at the sorted receivers:
  plain_gather          table[idx]
  k2_gather_rows_sorted K2

Two times per call, both on the card (time_call):
  event_ms   CUDA events around the Python call, median of --iters
             calls: what an eager PyTorch loop feels, the wrapper's host
             work included — a short kernel leaves the card idle while
             the host runs the wrapper, and that idle time lands between
             the events;
  device_ms  torch.profiler: the summed duration of the device work the
             call launches (kernels, memsets, copies), over --iters
             calls, divided by --iters — the kernels' own time.

Each variant's result is checked against plain_scatter (float32 sums:
within 2**-20 of each row's absolute sum; gathers: bitwise) before it
is timed. The roofline is the bytes a variant must move over the
H100's HBM3 bandwidth (3.35 TB/s): E*H*4 read + V*H*4 written + E*8 of
int64 indices for the sums, E*128*2 written + V*128*2 read + E*8 for
the gathers; x_roofline is device_ms over it. One JSON line per
variant, after a line with the card's name and power limit
(nvidia-smi). A machine without a CUDA device exits non-zero: this
measures the card and nothing else.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from typing import Callable, Dict, Tuple

import numpy as np
import torch

from ..ops import scatter_kernels as sc
from ..ops import segment_kernel as sk

HBM_GBPS = 3350.0          # H100 SXM HBM3
ONEHOT_MAX_BYTES = 2 ** 30
SUM_TOL = 2.0 ** -20
DEFAULT_SIZES = "64x4096,512x65536,2048x262144,82465x497664"


def make_inputs(v: int, e: int, h: int, seed: int, device) -> Dict:
    """The JAX script's inputs: uniform int receivers, normal messages,
    their stable receiver sort and CSR row pointer, and a bf16 table."""
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, v, e)
    msg = rng.normal(size=(e, h)).astype(np.float32)
    order, row_ptr = sc.csr_sort_host(recv, v)
    table = rng.normal(size=(v, 128)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)  # noqa: E731
    return {"v": v, "e": e, "h": h, "recv": t(recv), "msg": t(msg),
            "recv_sorted": t(recv[order]), "msg_sorted": t(msg[order]),
            "row_ptr": t(row_ptr),
            "table": t(table).to(torch.bfloat16)}


def variants(x: Dict) -> Dict[str, Tuple[Callable, str]]:
    """name -> (call, kind): kind "sum" ([V, H] float32) or "gather"."""
    v, h = x["v"], x["h"]

    def plain_scatter(m, r):
        return torch.zeros(v, h, device=m.device).index_add_(0, r, m)

    out = {
        "plain_scatter": (lambda: plain_scatter(x["msg"], x["recv"]), "sum"),
        "plain_scatter_sorted": (
            lambda: plain_scatter(x["msg_sorted"], x["recv_sorted"]), "sum"),
    }
    if x["e"] * v * 4 <= ONEHOT_MAX_BYTES:
        out["onehot_matmul"] = (
            lambda: torch.nn.functional.one_hot(x["recv"], v).float().T
            @ x["msg"], "sum")
    out["k3_segment_sum_unsorted"] = (
        lambda: sc.segment_sum_unsorted(x["msg"], x["recv"], v), "sum")
    out["k4_csr_segment_sum"] = (
        lambda: sc.csr_segment_sum(x["msg_sorted"], x["row_ptr"]), "sum")
    out["k1_segment_sum_sorted"] = (
        lambda: sk.segment_sum_sorted(x["msg_sorted"], x["row_ptr"]), "sum")
    out["plain_gather"] = (lambda: x["table"][x["recv_sorted"]], "gather")
    out["k2_gather_rows_sorted"] = (
        lambda: sk.gather_rows_sorted(x["table"], x["recv_sorted"], x["e"]),
        "gather")
    return out


def check(x: Dict, name: str, got: torch.Tensor, kind: str) -> float:
    """Max abs error against the plain version; raises past the bound."""
    if kind == "gather":
        want = x["table"][x["recv_sorted"]]
        if not torch.equal(got, want):
            raise RuntimeError(f"{name}: gather not bitwise equal")
        return 0.0
    want = torch.zeros(x["v"], x["h"], device=got.device).index_add_(
        0, x["recv"], x["msg"])
    abs_sum = torch.zeros_like(want).index_add_(0, x["recv"], x["msg"].abs())
    err = (got - want).abs()
    if not bool((err <= SUM_TOL * abs_sum + 1e-30).all()):
        raise RuntimeError(f"{name}: max abs err {err.max().item()} "
                           "exceeds 2**-20 of the row's absolute sum")
    return err.max().item()


def roofline_ms(x: Dict, kind: str) -> float:
    v, e, h = x["v"], x["e"], x["h"]
    if kind == "gather":
        nbytes = e * 128 * 2 + v * 128 * 2 + e * 8
    else:
        nbytes = e * h * 4 + v * h * 4 + e * 8
    return nbytes / (HBM_GBPS * 1e9) * 1e3


def cuda_median_ms(fn: Callable, iters: int, warmup: int = 3) -> float:
    """Median over `iters` calls of fn, each between two CUDA events."""
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in pairs)


def device_us(evt) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, attr):
            return float(getattr(evt, attr))
    return 0.0


def device_events(prof) -> list:
    """The device-side events (kernels, copies, sets) of a trace; the
    operator events above them carry the same time again."""
    events = [e for e in prof.key_averages() if device_us(e) > 0]
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if getattr(e, "device_type", None) == cuda]
    return kernels or events


def device_ms(fn: Callable, iters: int) -> float:
    """Mean device time per call of fn: the device work that
    torch.profiler records over `iters` calls, summed, over `iters`."""
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(device_us(e) for e in device_events(prof))
    if total <= 0:
        raise RuntimeError("torch.profiler recorded no device time")
    return total / iters / 1e3


def time_call(fn: Callable, iters: int) -> Tuple[float, float]:
    """(event_ms, device_ms) of fn: 3 warm-up calls, `iters` calls
    between CUDA events, `iters` calls under torch.profiler."""
    return cuda_median_ms(fn, iters), device_ms(fn, iters)


def run(sizes: str = DEFAULT_SIZES, h: int = 64, iters: int = 20,
        seed: int = 0, print_fn: Callable[[str], None] = print):
    """Time every variant at every size on cuda:0 -> the rows printed."""
    if not torch.cuda.is_available():
        raise RuntimeError("kernel_bench measures a CUDA device and found "
                           "none")
    device = torch.device("cuda", 0)
    rows = []
    with torch.inference_mode():
        for spec in sizes.split(","):
            v, e = (int(s) for s in spec.split("x"))
            x = make_inputs(v, e, h, seed, device)
            for name, (fn, kind) in variants(x).items():
                err = check(x, name, fn(), kind)
                event, dev = time_call(fn, iters)
                bound = roofline_ms(x, kind)
                rows.append({"V": v, "E": e,
                             "H": 128 if kind == "gather" else h,
                             "variant": name, "event_ms": event,
                             "device_ms": dev, "roofline_ms": bound,
                             "x_roofline": dev / bound, "max_abs_err": err})
                print_fn(json.dumps(rows[-1]))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--sizes", type=str, default=DEFAULT_SIZES)
    ap.add_argument("--h", type=int, default=64)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("kernel_bench: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    run(args.sizes, args.h, args.iters, args.seed,
        print_fn=lambda s: print(s, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())
