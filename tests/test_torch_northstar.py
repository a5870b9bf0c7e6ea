"""The north-star gate through the port (gates/northstar.py, a port of
scripts/northstar_train.py) at tests/test_northstar.py's small envelope,
over two gloo ranks on the CPU instead of the 8-way virtual mesh: the
power-law graph, threaded random-walk and negative sampling with the
halo partition built in the prefetch threads, bf16-amp owner-sharded
train steps, a full-state checkpoint written and restored mid-run. The
gate's asserts are tests/test_northstar.py:30-38's."""

import numpy as np

from dualmessagepassing_tpu_torch.gates.northstar import run


def test_northstar_small_envelope_on_two_ranks():
    result = run(v=2000, e=40_000, steps=6, shards=2, batch=400, depth=2,
                 width=6, amp=True, log=None, device="cpu", timeout=600.0)

    assert result["steps"] == 6
    assert len(result["losses"]) == 6
    assert all(np.isfinite(x) for x in result["losses"])
    # monotone-ish: the mean of the last half is below the first loss
    assert result["loss_last_half_mean"] < result["loss_first"]
    assert result["loss_decreased"]
    assert result["checkpoint_verified"]
    # the JAX gate's "windowed" names its kernel; the port names the
    # route its aggregation took: the plain versions on the CPU
    assert result["backend"] == "plain" and result["amp"]
    assert 0.0 <= result["sample_overlap_fraction"] <= 1.0
    # the port's own: two ranks over gloo on the CPU, the JAX envelope
    assert (result["shards"], result["collectives"], result["platform"]) \
        == (2, "gloo", "cpu")
    assert result["envelope"]["vp"] == 1000
