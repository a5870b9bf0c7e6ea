"""A run with its timed path broken underneath comes out not correct:
once for each fault the cell's loop can have (tools/faults.py)."""

from __future__ import annotations

import time

import pytest
import torch

from perfbench.core.harness import run_cell
from perfbench.core.manifest import catalog, resolve
from perfbench.tests.tiny import tiny_cell
from perfbench.tools.faults import planted

CASES = [(w["name"], f) for w in catalog()["workloads"]
         for f in resolve(w["name"]).loop.FAULTS]


@pytest.mark.parametrize("workload,fault", CASES)
def test_fault_is_caught(workload, fault):
    cell = tiny_cell(workload)
    with planted(cell.traffic["loop"], fault):
        result = run_cell(cell, 77, 0.3, False, torch.device("cpu"),
                          time.perf_counter())
    assert result["correct"] is False, result["checks"]
    assert result["failed"] >= 1
