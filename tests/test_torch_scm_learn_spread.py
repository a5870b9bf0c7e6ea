"""bench/scm_learn_spread.py on the CPU: the SCM learning run that
chip_smoke.py phase 11 checks, under scm_train's default learning-rate
schedule, and the module's repeats over perturbed initial weights."""

import json

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu_torch.bench import scm_learn_spread as ls


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the test workers share the CPU's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    out = ls.learning_run(torch.device("cpu"), ls.SEED)
    torch.set_num_threads(n)
    return out


def test_learning_run_falls_under_the_default_schedule(run):
    assert len(run["losses"]) == ls.LEARN["epochs"]
    assert ls.falling(run["losses"])
    batches = ls.LEARN["n_train"] // ls.LEARN["bsz"]
    assert run["steps"] == ls.LEARN["epochs"] * batches
    assert run["eval_batches"] == ls.LEARN["n_dev"] // ls.LEARN["bsz"]
    for k in ("MAE", "MSE", "RMSE", "AUC", "MNED", "MEED"):
        assert np.isfinite(run["results"][k]), k


def test_repeats_print_a_line_a_run_the_first_unperturbed(run, capsys):
    assert ls.main(["--runs", "2", "--device", "cpu"]) == 0
    lines = [json.loads(x) for x in capsys.readouterr().out.splitlines()]
    assert [x["run"] for x in lines[:2]] == [0, 1]
    # run 0 is learning_run itself, bit for bit on the CPU; run 1 starts
    # from weights scaled by 1 + EPS * N(0, 1)
    assert lines[0]["losses"] == run["losses"]
    assert lines[1]["losses"] != run["losses"]
    assert lines[2] == {"runs": 2, "falling": lines[0]["falling"]
                        + lines[1]["falling"], "schedule": "default",
                        "eps": ls.EPS, "device": "cpu"}


def test_falling_needs_the_last_epoch_below_each_of_the_first_two():
    assert ls.falling([125.0, 2.68, 2.41, 1.9])
    assert not ls.falling([125.0, 2.68, 2.41, 3.92])
    assert not ls.falling([125.0, 1.6, 2.41, 1.7])
    assert not ls.falling([125.0, float("nan"), 2.41, 1.9])


def test_an_unknown_schedule_is_refused():
    with pytest.raises(ValueError, match="default or constant"):
        ls.learning_run(torch.device("cpu"), ls.SEED, schedule="linear")
