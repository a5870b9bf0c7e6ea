"""One run of one cell: set-up, the measured window, the metrics, the
correctness check, and the result line.

The loop module of the cell's traffic mix supplies four calls:

  setup(ctx) -> state       build the program's objects, make the
                            inputs and weights from the seed, warm up
                            every shape, and drive the first steps
                            whose outputs the check compares;
  window(state, seconds, ctx) -> Window
                            the measured loop, until `seconds` pass;
  release(state)            free the program's device state (after
                            the peak memory is read);
  check(state, ctx) -> {name: value}
                            the numbers compared with their limits;
                            the reference runs here, after the window.

run_cell works on any device, so the CPU tests drive it at tiny sizes;
run.py refuses to start it without the cards the cell asks for.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass, field
from typing import Dict

import torch

from . import compare
from .manifest import Cell
from .trace import Tracer, inside_window, reduce


@dataclass
class Context:
    cell: Cell
    seed: int
    device: torch.device
    tracer: Tracer
    log: list = field(default_factory=list)

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def traffic(self) -> dict:
        return self.cell.traffic

    def span(self, name: str):
        return self.tracer.span(name)

    def note(self, line: str) -> None:
        """A line for standard error, printed before the check's lines."""
        self.log.append(line)


@dataclass
class Window:
    """What the loop measured: host seconds of the window, completed work
    by unit, the steps it ran, and the FLOPs and kernel bytes of those
    steps (counts/<config>.py)."""
    seconds: float
    units: Dict[str, float]
    steps: int
    flops: float = 0.0
    kernel_bytes: Dict[str, float] = field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             device: torch.device, t_start: float) -> dict:
    """The result dict of one run (run.py prints it as JSON)."""
    # the profiler runs only in a traced run: end-to-end metrics are
    # taken with it off
    tracer = Tracer(trace and device.type == "cuda")
    ctx = Context(cell, seed, device, tracer)
    state = cell.loop.setup(ctx)
    _sync(device)
    setup_s = time.perf_counter() - t_start
    host0 = host_times()
    with tracer.window():
        win = cell.loop.window(state, seconds, ctx)
    _sync(device)
    host1 = host_times()
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)
    spans = tracer.window_spans()
    ctx.note(host_line(win.seconds, host0, host1))
    ctx.note(timeline_line(tracer.spans))
    data = reduce(*tracer.events()) if tracer.profiler is not None else None
    record = {"setup_s": setup_s, "window": win, "trace": data,
              "spans": spans,
              "tf32": bool(torch.backends.cuda.matmul.allow_tf32)}
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        value = m.reader.read(record)
        if value is not None:
            metrics[m.name] = {"value": float(value), "unit": m.unit}
    cell.loop.release(state)
    if device.type == "cuda":
        torch.cuda.empty_cache()
    table = compare.checks(cell.loop.check(state, ctx), cell.limits)
    correct = compare.passed(table)
    result = {
        "correct": correct,
        "attempted": win.steps,
        "failed": sum(1 for v in table.values()
                      if not (v["value"] <= v["limit"])),
        "metrics": metrics,
        "device": device_info(device, cell.chips, peak,
                              data if trace else None),
    }
    if trace and data is not None:
        result["breakdown"] = data.breakdown()
    result["checks"] = table
    result["_log"] = ctx.log
    return result


def host_times() -> tuple:
    """(this process's CPU seconds, the calling thread's, the machine's
    steal seconds from /proc/stat or None)."""
    steal = None
    try:
        with open("/proc/stat") as f:
            fields = f.readline().split()
        steal = int(fields[8]) / os.sysconf("SC_CLK_TCK")
    except (OSError, IndexError, ValueError):
        pass
    return time.process_time(), time.thread_time(), steal


def host_line(seconds: float, t0: tuple, t1: tuple) -> str:
    """What the host gave the window: the process's and the loop
    thread's CPU seconds, and the seconds the hypervisor stole from the
    machine's CPUs, beside the window's length."""
    steal = (f"{t1[2] - t0[2]:.2f}" if t0[2] is not None
             and t1[2] is not None else "not read")
    return (f"host: window {seconds:.3f} s, process cpu {t1[0] - t0[0]:.3f} "
            f"s, loop thread cpu {t1[1] - t0[1]:.3f} s, machine steal "
            f"{steal} s")


def timeline_line(spans: list) -> str:
    """The steps ("dispatch" spans) that ended in each whole second of the
    window: a pace that drifts through the window shows here."""
    bounds, inside = inside_window(spans)
    if bounds is None:
        return "steps per second: no window"
    counts = [0] * max(1, int((bounds[1] - bounds[0]) // 1_000_000_000))
    for name, _, e in inside:
        if name == "dispatch":
            k = (e - bounds[0]) // 1_000_000_000
            if k < len(counts):
                counts[k] += 1
    return f"steps per second: {counts}"


def device_info(device: torch.device, chips: int, peak: int,
                data) -> dict:
    info = {"platform": "gpu" if device.type == "cuda" else device.type,
            "kind": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else "cpu"),
            "count": chips, "memory_peak_bytes": int(peak)}
    if data is not None:
        info["busy_s"] = data.busy_s
        info["window_s"] = data.window_s
    return info


def timed_loop(seconds: float, body):
    """Call body(i) for i = 0, 1, ... until `seconds` have passed since
    the first call began -> (host seconds, calls)."""
    t0 = time.perf_counter()
    i = 0
    while True:
        body(i)
        i += 1
        if time.perf_counter() - t0 >= seconds:
            return time.perf_counter() - t0, i


def tally(step_counts, summaries) -> tuple:
    """Sum step_counts(summary) -> (FLOPs, {kernel: bytes}) over the
    window's steps."""
    flops, kbytes = 0.0, {}
    for s in summaries:
        f, kb = step_counts(s)
        flops += f
        for k, v in kb.items():
            kbytes[k] = kbytes.get(k, 0.0) + v
    return flops, kbytes
