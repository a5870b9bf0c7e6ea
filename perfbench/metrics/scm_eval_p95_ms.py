"""scm_eval_p95_ms: the 95th percentile over every batch of the window of
the host ms from the eval step's call to its predictions on the host
(the "dispatch" span's start to the "predictions_read" span's end)."""

from perfbench.core.readers import latency_ms


def read(record):
    return latency_ms(record, "dispatch", "predictions_read", 0.95)
