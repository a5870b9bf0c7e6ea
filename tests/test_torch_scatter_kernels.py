"""Plain versions of K3 and K4 (dualmessagepassing_tpu_torch/ops/
scatter_kernels.py) against the JAX package's own references on the
CPU, and the port's kernel bench (bench/kernel_bench.py) run through
the plain versions.

K3 (segment_sum_unsorted) is compared with segment_sum_auto, whose
non-TPU path is the XLA scatter (pallas_scatter.py:251-253): it drops
receivers >= V, as the Pallas kernel does, but wraps negative ones
Python-style, where the kernel drops them — so negatives are checked
against numpy. K4 (csr_segment_sum) is compared with the scatter
oracle of tests/test_scatter.py:121. Tolerance 1e-5 abs and rel: the
same float32 sums in another order. csr_sort_host must be array-equal.

The CUDA kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.ops import pallas_scatter as jps
from dualmessagepassing_tpu_torch.bench import kernel_bench as kb
from dualmessagepassing_tpu_torch.ops import scatter_kernels as sc
from dualmessagepassing_tpu_torch.ops import segment_kernel as tsk

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_plain_matches_segment_sum_auto(dtype):
    rng = np.random.default_rng(0)
    v, e, h = 64, 3000, 20
    recv = rng.integers(0, v + 8, e)               # some receivers >= V
    recv[:500] = 5                                 # a hub
    mask = rng.random(e) < 0.9
    msg = rng.normal(size=(e, h)).astype(np.float32)
    m = torch.from_numpy(msg).to(dtype)
    want = jps.segment_sum_auto(jnp.asarray(m.float().numpy()),
                                jnp.asarray(recv), jnp.asarray(mask), v)
    got = sc.segment_sum_unsorted(
        torch.where(torch.from_numpy(mask)[:, None], m, 0),
        torch.from_numpy(recv), v)
    assert got.dtype == torch.float32 and got.shape == (v, h)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_k3_plain_drops_negative_receivers():
    rng = np.random.default_rng(1)
    recv = rng.integers(-5, 12, 400)
    msg = rng.normal(size=(400, 3)).astype(np.float32)
    want = np.zeros((10, 3), np.float32)
    for r, row in zip(recv, msg):
        if 0 <= r < 10:
            want[r] += row
    got = sc.segment_sum_unsorted(torch.from_numpy(msg),
                                  torch.from_numpy(recv), 10)
    np.testing.assert_allclose(got.numpy(), want, **TOL)


def test_k4_plain_matches_scatter_oracle():
    """tests/test_scatter.py:104-123 on the port: the sorted stream with
    tile_e rows of padding past row_ptr[V] — here garbage, never read."""
    rng = np.random.default_rng(2)
    V, E, H, tile_e = 512, 4096, 64, 512
    recv = rng.integers(0, V, E).astype(np.int32)
    msg = rng.normal(size=(E, H)).astype(np.float32)
    order, row_ptr = sc.csr_sort_host(recv, V, tile_e)
    msg_s = np.concatenate([msg[order], np.full((tile_e, H), 1e3,
                                                np.float32)])
    got = sc.csr_segment_sum(torch.from_numpy(msg_s),
                             torch.from_numpy(row_ptr))
    want = jnp.zeros((V, H)).at[jnp.asarray(recv)].add(jnp.asarray(msg))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("seed", [0, 1])
def test_csr_sort_host_matches_jax(seed):
    rng = np.random.default_rng(seed)
    recv = rng.integers(0, 37, 500).astype(np.int32)
    for a, b in zip(jps.csr_sort_host(recv, 40), sc.csr_sort_host(recv, 40)):
        np.testing.assert_array_equal(a, b)
        assert a.dtype == b.dtype


def test_entry_points_refuse_autograd_and_non_cpu_tensors():
    msg = torch.zeros(4, 3, requires_grad=True)
    with pytest.raises(RuntimeError, match="not differentiable"):
        sc.segment_sum_unsorted(msg, torch.zeros(4, dtype=torch.int64), 2)
    with pytest.raises(RuntimeError, match="not differentiable"):
        sc.csr_segment_sum(msg, torch.zeros(3, dtype=torch.int32))
    meta = torch.zeros(4, 3, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.segment_sum_unsorted(meta, torch.zeros(4, dtype=torch.int64,
                                                  device="meta"), 2)
    with pytest.raises(ValueError, match="CUDA tensor"):
        sc.csr_segment_sum(meta, torch.zeros(3, dtype=torch.int32,
                                             device="meta"))
    assert "segment_sum_unsorted" not in tsk.LAUNCHES
    assert "csr_segment_sum" not in tsk.LAUNCHES


@pytest.mark.parametrize("spec", ["64x4096", "300x5000"])
def test_kernel_bench_variants_agree_on_the_cpu(spec):
    """Every variant of the bench at a small size, through the plain
    versions: the sums within the bench's own bound, the gathers
    bitwise. The one-hot variant runs where its [E, V] fits 1 GiB."""
    v, e = (int(x) for x in spec.split("x"))
    x = kb.make_inputs(v, e, 16, seed=0, device="cpu")
    vs = kb.variants(x)
    assert set(vs) == {
        "plain_scatter", "plain_scatter_sorted", "onehot_matmul",
        "k3_segment_sum_unsorted", "k4_csr_segment_sum",
        "k1_segment_sum_sorted", "plain_gather", "k2_gather_rows_sorted"}
    for name, (fn, kind) in vs.items():
        assert kb.check(x, name, fn(), kind) < 1e-4
        assert kb.roofline_ms(x, kind) > 0


def test_kernel_bench_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    assert kb.main(["--iters", "1", "--sizes", "64x4096"]) == 1
    with pytest.raises(RuntimeError, match="CUDA"):
        kb.run("64x4096", iters=1)
