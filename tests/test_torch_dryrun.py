"""The port's dry run (dualmessagepassing_tpu_torch/dryrun.py), the
counterpart of __graft_entry__.py: dryrun_multichip over two gloo ranks
on the CPU (one spawn) runs every part with finite losses, the same on
both ranks; entry("cpu")'s outputs have the shapes of the JAX entry's.
"""

import jax
import numpy as np

import __graft_entry__ as graft
from dualmessagepassing_tpu_torch import dryrun

from test_torch_dist import run_ranks

PARTS = {"dp_step": 1, "edge_parallel_sums": 2, "ep": 3, "halo": 3,
         "halo_amp": 2, "supervised": 1, "dp_train_epoch": 1}


def test_dryrun_multichip_on_two_ranks(tmp_path):
    ranks = run_ranks(dryrun.dryrun_multichip, tmp_path)
    assert ranks[0] == ranks[1]
    assert sorted(ranks[0]) == sorted(PARTS)
    for name, n in PARTS.items():
        values = np.atleast_1d(ranks[0][name])
        assert len(values) == n and np.isfinite(values).all(), name
    # the halo steps start from the weights and the first batch of the
    # edge-partitioned ones: the same loss, summed in another order
    np.testing.assert_allclose(ranks[0]["halo"][0], ranks[0]["ep"][0],
                               rtol=1e-5)


def test_entry_shapes_equal_the_jax_entry():
    fn, args = graft.entry()
    want = jax.eval_shape(fn, *args)
    got_fn, got_args = dryrun.entry("cpu")
    got = got_fn(*got_args)
    assert [tuple(g.shape) for g in got] == [tuple(w.shape) for w in want]
    assert all(np.isfinite(g.numpy()).all() for g in got)
