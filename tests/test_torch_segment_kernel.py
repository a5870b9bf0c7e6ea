"""Plain versions of the port's segment kernels
(dualmessagepassing_tpu_torch/ops/segment_kernel.py) against the JAX
package's windowed kernels.

K1 (segment_sum_sorted) is compared with segment_sum_windowed_arrays
through its CPU fallback and with the Pallas body itself in interpret
mode; K2 (gather_rows_sorted) with windowed_row_broadcast in interpret
mode. Inputs are made with numpy from a seed: a hub row, an empty
128-row window, and a pad tail that repeats the last receiver and
carries non-zero garbage messages (neither version may read it).

Tolerances: K1 in float32 — 1e-5 abs and rel, since both sides sum the
same float32 values in stream order and differ only by the TPU
kernel's rounding; K1 in bf16 — both accumulate in float32 and round
once to bf16, so they may differ by one bf16 ulp (rel 2**-7, plus 1e-5
abs for sums that cancel to near zero); K2 — bitwise.

The CUDA kernels themselves run only on the card
(tests/test_torch_cuda_kernels.py, chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dualmessagepassing_tpu.ops import segment_kernel as sk
from dualmessagepassing_tpu_torch.ops import segment_kernel as tsk

TILE_E, WINDOW = 64, 128


def make_stream(seed, v=300, e_real=600, e_pad=100, h=50):
    """Receiver-sorted stream with a hub (row 3), an empty window (rows
    128..255) and a pad tail of e_pad slots."""
    rng = np.random.default_rng(seed)
    pool = np.concatenate([np.arange(0, 128), np.arange(256, v)])
    recv = rng.choice(pool, e_real)
    recv[: e_real // 3] = 3
    recv = np.sort(recv)
    recv_padded = np.concatenate([recv, np.full(e_pad, recv[-1])])
    msg = rng.normal(size=(e_real + e_pad, h)).astype(np.float32)
    row_ptr = np.searchsorted(recv, np.arange(v + 1)).astype(np.int32)
    return recv, recv_padded, msg, row_ptr


def torch_dtype(name):
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


def assert_k1_close(got, want, dtype):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    else:
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=1e-5)


def plain_k1(msg, row_ptr, dtype):
    m = torch.from_numpy(msg).to(torch_dtype(dtype))
    out = tsk.segment_sum_sorted(m, torch.from_numpy(row_ptr))
    assert out.dtype == m.dtype
    return out.float().numpy()


def jax_k1(msg, recv, v, dtype, interpret):
    plan = sk.build_pass_plan(recv, v, e_env=len(msg), v_env=v,
                              tile_e=TILE_E, window=WINDOW)
    sk.INTERPRET = interpret
    try:
        out = sk.segment_sum_windowed_arrays(
            jnp.asarray(msg).astype(dtype), jnp.asarray(plan["recv_col"]),
            jnp.asarray(plan["blk"]), jnp.asarray(plan["win"]),
            jnp.asarray(plan["first"]), num_nodes=v, tile_e=TILE_E,
            window=WINDOW, mode="highest" if dtype == "float32" else "hilo")
    finally:
        sk.INTERPRET = False
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("h", [1, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_jax_fallback(dtype, h):
    recv, _, msg, row_ptr = make_stream(0, h=h)
    got = plain_k1(msg, row_ptr, dtype)
    assert (got[128:256] == 0).all()                  # the empty window
    assert_k1_close(got, jax_k1(msg, recv, 300, dtype, False), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_matches_pallas_interpret(dtype):
    recv, _, msg, row_ptr = make_stream(1, h=50)
    assert_k1_close(plain_k1(msg, row_ptr, dtype),
                    jax_k1(msg, recv, 300, dtype, True), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_row_broadcast_interpret(dtype):
    """table rows on real slots, zero rows on the pad tail — bitwise."""
    v, v_env, e_env = 300, 384, 1024
    recv, recv_padded, _, _ = make_stream(2)
    n_real, e_total = len(recv), len(recv_padded)
    table = np.random.default_rng(3).normal(size=(v_env, 128))
    table_j = jnp.asarray(table).astype(dtype)
    plan = sk.build_pass_plan(recv, v, e_env=e_env, v_env=v_env,
                              tile_e=TILE_E, window=WINDOW)
    bp = sk.build_bcast_plan(recv, v, e_env=e_env, v_env=v_env,
                             tile_e=TILE_E, window=WINDOW)
    sk.INTERPRET = True
    try:
        want = sk.windowed_row_broadcast(
            table_j, jnp.asarray(plan["recv_col"]), jnp.asarray(bp["blk"]),
            jnp.asarray(bp["win"]), jnp.asarray(bp["first"]),
            tile_e=TILE_E, window=WINDOW)
    finally:
        sk.INTERPRET = False
    want = np.asarray(want.astype(jnp.float32))[:e_total]
    table_t = torch.from_numpy(np.array(table_j.astype(jnp.float32))) \
        .to(torch_dtype(dtype))
    got = tsk.gather_rows_sorted(table_t, torch.from_numpy(recv_padded),
                                 n_real)
    assert got.dtype == table_t.dtype and got.shape == (e_total, 128)
    got = got.float().numpy()
    np.testing.assert_array_equal(got[:n_real], want[:n_real])
    assert (got[n_real:] == 0).all() and (want[n_real:] == 0).all()


def test_entry_points_raise_on_requires_grad():
    recv, recv_padded, msg, row_ptr = make_stream(4, h=8)
    m = torch.from_numpy(msg).requires_grad_()
    with pytest.raises(RuntimeError, match="no backward"):
        tsk.segment_sum_sorted(m, torch.from_numpy(row_ptr))
    table = torch.zeros(300, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        tsk.gather_rows_sorted(table, torch.from_numpy(recv_padded),
                               len(recv))
    with torch.no_grad():       # the same inputs pass without autograd
        tsk.segment_sum_sorted(m, torch.from_numpy(row_ptr))


def test_non_cpu_tensors_never_take_the_plain_version():
    """Only a CPU tensor takes the plain version; any other device goes
    to the CUDA launcher, which rejects what is not a CUDA tensor."""
    msg = torch.zeros(4, 3, device="meta")
    row_ptr = torch.zeros(3, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsk.segment_sum_sorted(msg, row_ptr)
    idx = torch.zeros(4, dtype=torch.int64, device="meta")
    with pytest.raises(ValueError, match="CUDA tensor"):
        tsk.gather_rows_sorted(msg, idx, 2)
    assert sum(tsk.LAUNCHES.values()) == 0


def test_gather_rejects_bad_n_real():
    table, idx = torch.zeros(5, 2), torch.zeros(4, dtype=torch.int64)
    with pytest.raises(ValueError):
        tsk.gather_rows_sorted(table, idx, 5)
