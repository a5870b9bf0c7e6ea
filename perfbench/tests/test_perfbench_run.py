"""run.py as the check starts it: with no card it exits non-zero and
prints no result; in a directory that holds only BENCHMARK.json and the
benchmark's files it does the same; on the card (skipped here) a short
run prints a correct result."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys

import pytest

from perfbench.core.manifest import ROOT

ARGS = ["--workload", "scm_complex_dmpnn-eval", "--seed", "3000000001",
        "--seconds", "1", "--trace", "0"]


def _run(cwd, timeout=300):
    return subprocess.run([sys.executable, "perfbench/run.py", *ARGS],
                          cwd=cwd, capture_output=True, text=True,
                          timeout=timeout)


def _has_result(out: str) -> bool:
    lines = out.strip().splitlines()
    if not lines:
        return False
    try:
        return "correct" in json.loads(lines[-1])
    except ValueError:
        return False


def test_no_card_no_result():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    proc = _run(ROOT)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run(tmp_path)
    assert proc.returncode != 0
    assert not _has_result(proc.stdout)


def test_short_run_on_the_card(cuda_device):
    proc = _run(ROOT, timeout=1200)
    assert proc.returncode == 0, proc.stderr[-2000:]
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert result["correct"] and result["device"]["platform"] == "gpu"
