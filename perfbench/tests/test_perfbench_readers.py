"""The reduction of a trace and the metric readers, on a hand-made window:
busy and idle time, idle gaps named by the host's span, span means,
the latency tail, the host rate, and the timeline of steps."""

from __future__ import annotations

import pytest

from perfbench.core import readers
from perfbench.core.harness import Window, timeline_line
from perfbench.core.trace import inside_window, reduce

MS = 1_000_000  # ns


def _record():
    # a 100 ms window; two requests, each dispatch then a read
    spans = [("window", 0, 100 * MS),
             ("dispatch", 0, 10 * MS), ("predictions_read", 10 * MS, 40 * MS),
             ("dispatch", 50 * MS, 55 * MS),
             ("predictions_read", 55 * MS, 95 * MS)]
    device = [("gemm", 5 * MS, 30 * MS), ("segment_sum", 20 * MS, 35 * MS),
              ("memset", 60 * MS, 70 * MS), ("before", -5 * MS, 2 * MS)]
    win = Window(0.1, {"pairs": 64}, 2, flops=6.7e9)
    return {"setup_s": 1.0, "window": win, "trace": reduce(device, spans),
            "spans": inside_window(spans)[1], "tf32": False}


def test_busy_idle_and_gaps():
    t = _record()["trace"]
    # busy: [0, 2] clipped + [5, 35] + [60, 70] = 42 ms
    assert t.busy_s == pytest.approx(0.042)
    assert t.window_s == pytest.approx(0.1)
    gaps = dict(t.breakdown()["idle_gaps"])
    # [2, 5] in dispatch; [35, 60] mid 47.5 in no span; [70, 100] reads
    assert gaps["dispatch"] == pytest.approx(0.003)
    assert gaps["outside_spans"] == pytest.approx(0.025)
    assert gaps["predictions_read"] == pytest.approx(0.030)


def test_readers():
    r = _record()
    assert readers.idle_share(r) == pytest.approx(58.0)
    assert readers.span_ms(r, "dispatch") == pytest.approx(7.5)
    assert readers.span_ms(r, "to_device") is None
    # latencies 40 and 45 ms: the nearest-rank 95th is the larger
    assert readers.latency_ms(r, "dispatch", "predictions_read",
                              0.95) == pytest.approx(45.0)
    assert readers.latency_ms(r, "dispatch", "predictions_read",
                              0.5) == pytest.approx(40.0)
    assert readers.host_rate(r, "pairs") == pytest.approx(640.0)
    # 6.7 GFLOP in the 0.1-s window, of the 67 TFLOP/s float32 peak
    assert readers.mfu(r) == pytest.approx(100 * 6.7e9 / 0.1 / 67e12)
    assert readers.device_ms(r) == pytest.approx((2 + 25 + 15 + 10) / 2)


def test_readers_without_a_trace_read_nothing():
    """An untraced run reads the host's spans and rate, and nothing of the
    device."""
    r = dict(_record(), trace=None)
    for value in (readers.idle_share(r), readers.device_ms(r),
                  readers.mfu(r)):
        assert value is None
    assert readers.span_ms(r, "dispatch") == pytest.approx(7.5)
    assert readers.latency_ms(r, "dispatch", "predictions_read",
                              0.95) == pytest.approx(45.0)
    assert readers.host_rate(r, "pairs") == pytest.approx(640.0)


def test_timeline_counts_steps_per_second():
    s = 1_000_000_000
    spans = [("window", 0, 3 * s), ("dispatch", 0, s // 2),
             ("dispatch", s // 2, s // 2 + 1), ("dispatch", 2 * s, 2 * s + 5)]
    assert timeline_line(spans) == "steps per second: [2, 0, 1]"
    assert timeline_line([]) == "steps per second: no window"
