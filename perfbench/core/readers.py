"""What the metric readers share: each metrics/<name>.py applies one of
these to the run's record and returns a number, or None where the run
has nothing for it to read (then the metric is left out of the line).

The record: setup_s (host seconds from process start to the window),
window (core.harness.Window), spans (the harness's host spans inside
the window, kept in every run), trace (core.trace.TraceData of the
traced window, or None), tf32 (the matmul TF32 flag during the run).
"""

from __future__ import annotations

import math
from typing import Iterable, Optional

from .peaks import HBM_BYTES_PER_S, matmul_peak


def device_ms(record: dict) -> Optional[float]:
    """Device time (kernels, memsets, copies) per step of the window."""
    t, w = record["trace"], record["window"]
    if t is None or not w.steps:
        return None
    return 1e3 * sum(t.device_s_by_name.values()) / w.steps


def mfu(record: dict) -> Optional[float]:
    """The window's matmul FLOPs over the window's seconds, as a share of
    the card's float32 matmul peak (TF32's where the flag was on): the
    whole step's share, beside the rate it bounds. Read in a traced run
    only, beside the rooflines."""
    t, w = record["trace"], record["window"]
    if t is None or w.seconds <= 0 or not w.flops:
        return None
    return 100.0 * w.flops / w.seconds / matmul_peak(record["tf32"])


def kernel_seconds(trace, names: Iterable[str],
                   memset_before: bool = False) -> float:
    """Device seconds of the kernels whose names contain one of `names`;
    with memset_before, the memset that the launcher issues right before
    each of them on the stream is counted as its own."""
    names = tuple(names)
    total, prev = 0.0, None
    for ev in sorted(trace.device, key=lambda x: x[1]):
        name, s, e = ev
        if any(n in name for n in names):
            total += (e - s) / 1e9
            if memset_before and prev is not None \
                    and "memset" in prev[0].lower() and prev[2] <= s:
                total += (prev[2] - prev[1]) / 1e9
        prev = ev
    return total


def roofline(record: dict, work: str, names: Iterable[str],
             memset_before: bool = False) -> Optional[float]:
    """The least time of the window's `work` bytes (counts/) at the card's
    bandwidth, as a share of the device time of the kernels doing it."""
    t, w = record["trace"], record["window"]
    if t is None or not w.kernel_bytes.get(work):
        return None
    secs = kernel_seconds(t, names, memset_before)
    if secs <= 0:
        return None
    return 100.0 * w.kernel_bytes[work] / HBM_BYTES_PER_S / secs


def host_rate(record: dict, unit: str) -> Optional[float]:
    """Work of every step completed in the window over the window's host
    seconds: the rate the host-paced loop gives a user of this machine."""
    w = record["window"]
    return w.units[unit] / w.seconds if w.seconds > 0 else None


def span_ms(record: dict, name: str) -> Optional[float]:
    """Mean host milliseconds of the spans `name` inside the window."""
    spans = [e - s for n, s, e in record["spans"] if n == name]
    return sum(spans) / len(spans) / 1e6 if spans else None


def idle_share(record: dict) -> Optional[float]:
    """The share of the window in which no kernel, memset or copy ran."""
    t = record["trace"]
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)


def latency_ms(record: dict, first: str, last: str,
               q: float) -> Optional[float]:
    """The q-quantile (nearest rank) over every request of the window of
    the host ms from the start of its span `first` to the end of the
    span `last` that follows it."""
    spans = record["spans"]
    starts = sorted(s for n, s, _ in spans if n == first)
    ends = sorted(e for n, _, e in spans if n == last)
    if not starts or len(starts) != len(ends):
        return None
    lat = sorted(e - s for s, e in zip(starts, ends))
    k = max(0, math.ceil(q * len(lat)) - 1)
    return lat[k] / 1e6
