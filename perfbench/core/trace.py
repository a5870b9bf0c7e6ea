"""Spans around the harness's calls into the program, the profiler
window over the measured window, and the reduction of both to what the
metric readers read.

A span is a host interval named after the call it wraps ("dispatch",
"to_device", "collate", ...), kept in memory in every run with its
start and end on time.time_ns(), the clock the profiler gives device
activity (Unix epoch nanoseconds); a span costs two clock reads. The
profiler runs only in a traced run, and records device activity only
(CUPTI), so the host's own work is not slowed by op recording.

The reduction keeps, inside the "window" span:
  * device intervals: kernels, memsets and copies (the activity types
    "kernel", "gpu_memset", "gpu_memcpy"), each with its name;
  * host spans, with their nesting;
and derives busy seconds (the union of device intervals), the window's
seconds, device seconds by operation name, and the idle gaps between
device intervals, each named by the innermost span the host was in at
the gap's middle.
"""

from __future__ import annotations

import bisect
import contextlib
import time
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Tuple

DEVICE_ACTIVITIES = ("kernel", "gpu_memset", "gpu_memcpy")
WINDOW = "window"
NO_SPAN = "outside_spans"
NAME_CHARS = 160


class Tracer:
    """Spans for one run; `profile` runs the profiler around the window."""

    def __init__(self, profile: bool):
        self.profile = profile
        self.profiler = None
        self.spans: List[Tuple[str, int, int]] = []

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.time_ns()
        try:
            yield
        finally:
            self.spans.append((name, t0, time.time_ns()))

    @contextlib.contextmanager
    def window(self):
        """The measured window: under the profiler when tracing."""
        if not self.profile:
            with self.span(WINDOW):
                yield
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            with self.span(WINDOW):
                yield
            torch.cuda.synchronize()
        self.profiler = prof

    def window_spans(self) -> list:
        """The host spans inside the measured window, itself left out."""
        return inside_window(self.spans)[1]

    def events(self) -> Tuple[list, list]:
        """(device intervals, host spans) as (name, start_ns, end_ns)."""
        return kineto_events(self.profiler), self.spans


def _ns(ev, attr: str) -> int:
    if hasattr(ev, attr + "_ns"):
        return int(getattr(ev, attr + "_ns")())
    return int(getattr(ev, attr + "_us")() * 1000)


def _on_device(ev) -> bool:
    """A kernel, memset or copy: by its activity type where the event
    has one, else a device event that no annotation made."""
    if hasattr(ev, "activity_type"):
        return str(ev.activity_type()).lower() in DEVICE_ACTIVITIES
    user = getattr(ev, "is_user_annotation", None)
    return str(ev.device_type()).endswith("CUDA") and not (user and user())


def kineto_events(prof) -> list:
    """Device intervals (kernels, memsets, copies) of a finished
    torch.profiler run."""
    device = []
    for ev in prof.profiler.kineto_results.events():
        if _on_device(ev):
            start = _ns(ev, "start")
            device.append((ev.name(), start, start + _ns(ev, "duration")))
    return device


def merge(intervals: Iterable[Tuple[int, int]]) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


@dataclass
class TraceData:
    window_s: float
    busy_s: float
    device: List[Tuple[str, int, int]]          # inside the window
    spans: List[Tuple[str, int, int]]           # inside the window
    device_s_by_name: Dict[str, float] = field(default_factory=dict)
    idle_by_span: Dict[str, float] = field(default_factory=dict)

    def breakdown(self, top: int = 10) -> dict:
        """The device ops that took most time (names cut to NAME_CHARS)
        and the idle time by the span the host was in."""
        ops = sorted(self.device_s_by_name.items(), key=lambda x: -x[1])
        gaps = sorted(self.idle_by_span.items(), key=lambda x: -x[1])
        return {"device_ops": [[n[:NAME_CHARS], s] for n, s in ops[:top]],
                "idle_gaps": [[n, s] for n, s in gaps[:top]]}


def inside_window(spans: list) -> tuple:
    """((start, end) of the longest window span, or None; the other spans
    that overlap it)."""
    windows = [(s, e) for n, s, e in spans if n == WINDOW]
    if not windows:
        return None, []
    w0, w1 = max(windows, key=lambda x: x[1] - x[0])
    return (w0, w1), [(n, s, e) for n, s, e in spans
                      if n != WINDOW and e > w0 and s < w1]


def reduce(device: list, spans: list) -> Optional[TraceData]:
    """The traced window's numbers, or None without a window span."""
    bounds, host = inside_window(spans)
    if bounds is None:
        return None
    w0, w1 = bounds
    inside = []
    for name, s, e in device:
        s, e = max(s, w0), min(e, w1)
        if e > s:
            inside.append((name, s, e))
    busy = merge((s, e) for _, s, e in inside)
    by_name: Dict[str, float] = {}
    for name, s, e in inside:
        by_name[name] = by_name.get(name, 0.0) + (e - s) / 1e9
    bounds, labels = _segments(host)
    idle: Dict[str, float] = {}
    prev = w0
    for s, e in busy + [(w1, w1)]:
        if s > prev:
            i = bisect.bisect_right(bounds, (prev + s) // 2) - 1
            idle_name = labels[i] if i >= 0 else NO_SPAN
            idle[idle_name] = idle.get(idle_name, 0.0) + (s - prev) / 1e9
        prev = max(prev, e)
    return TraceData(
        window_s=(w1 - w0) / 1e9,
        busy_s=sum(e - s for s, e in busy) / 1e9,
        device=inside, spans=host, device_s_by_name=by_name,
        idle_by_span=idle)


def _segments(spans: list) -> Tuple[List[int], List[str]]:
    """The innermost span as a step function of time: (segment starts,
    their labels). Spans of one thread nest, so a stack sweep suffices."""
    bounds: List[int] = []
    labels: List[str] = []
    stack: list = []

    def close_until(t):
        while stack and stack[-1][2] <= t:
            end = stack.pop()[2]
            bounds.append(end)
            labels.append(stack[-1][0] if stack else NO_SPAN)

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        close_until(s)
        stack.append((name, s, e))
        bounds.append(s)
        labels.append(name)
    close_until(float("inf"))
    return bounds, labels
