"""Each cell's run, at a tiny size on the CPU: the program's plain CPU
path against the plain reference comes out correct, and the control
(the reference with TF32 matmuls in the program's place) fails a limit."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.core import compare
from perfbench.core.harness import Context, run_cell
from perfbench.core.manifest import catalog
from perfbench.core.trace import Tracer
from perfbench.tests.tiny import tiny_cell

CELLS = [w["name"] for w in catalog()["workloads"]]
SEED = 2 ** 31 + 12345


@pytest.mark.parametrize("workload", CELLS)
def test_sound_run_is_correct(workload):
    result = run_cell(tiny_cell(workload), SEED, 0.3, False,
                      torch.device("cpu"), time.perf_counter())
    assert result["correct"], result["checks"]
    assert list(result)[-2:] == ["checks", "_log"]
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) >= {"setup_s"}


@pytest.mark.parametrize("workload", CELLS)
def test_control_fails_a_limit(workload):
    cell = tiny_cell(workload)
    ctx = Context(cell, SEED, torch.device("cpu"), Tracer(False))
    st = cell.loop.setup(ctx)
    if hasattr(st, "kept"):
        cell.loop.window(st, 0.3, ctx)
    cell.loop.release(st)
    table = compare.checks(cell.loop.control(st, ctx), cell.limits)
    assert not compare.passed(table), table
