"""The port's four helpers off every model path against the JAX package
on the CPU: scatter_sum_flat, scatter_max_edges, segment_softmax_edges
(dualmessagepassing_tpu_torch/ops/scatter.py, through K3's plain
version) and edge_norm_device (ops/spectral.py), forward in float32 and
bfloat16, and the gradients of the first three against jax.vjp.

The inputs are drawn with numpy from the seeds here: masked edges, pad
edges (masked, receiver 0, large values that must not leak), segments
that no edge reaches, receivers in [-V, 0) (JAX wraps them), >= V and
below -V (JAX drops the update; take_along_axis reads NaN), and maxima
tied on purpose (messages on a grid of halves).

Tolerances:
  * float32 forward and gradients: rtol 1e-6, atol 1e-6 (F32), except
    the forwards of scatter_max_edges and edge_norm_device, which round
    nothing JAX does not round the same way: equal bit for bit, NaN
    where JAX has NaN; scatter_max_edges' gradient rtol 1e-6 (float32)
    or one bfloat16 rounding, 2**-8 (a tie split k ways divides by k in
    the port, multiplies by 1/k in JAX);
  * bfloat16 scatter_sum_flat: JAX's CPU scatter rounds each partial sum
    of a row to bfloat16, the port sums in float32 and rounds once, so
    per row |port - JAX| <= (d + 1) * 2**-8 * sum|msg| (d the row's
    edges, each rounding at most half a bfloat16 ulp, 2**-9, of a
    partial sum, doubled); and the port within one bfloat16 rounding
    (2**-8 relative, plus 1e-6 of the row's absolute sum) of JAX's
    float32 sum;
  * bfloat16 segment_softmax_edges: the same partial-sum rounding in the
    denominator and the division's own rounding: per edge |port - JAX|
    <= (d + 2) * 2**-8 * |JAX| (d the segment's edges);
  * the bfloat16 gradient of scatter_sum_flat is a gather: bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dualmessagepassing_tpu.ops import scatter as jsc
from dualmessagepassing_tpu.ops import spectral as jsp
from dualmessagepassing_tpu_torch.ops import scatter as tsc
from dualmessagepassing_tpu_torch.ops import spectral as tsp

F32 = dict(rtol=1e-6, atol=1e-6)
BF16_ULP = 2.0 ** -8
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}
# V = 7 rows: -10 and -8 lie below -V, -7 wraps to row 0 and -2 to row
# 5, 7 and 9 lie at or past V; rows 4 and 6 receive no edge
V = 7
RECEIVERS = np.array([-10, -8, -7, -2, 0, 1, 2, 3, 7, 9])
B, E, H, PAD = 3, 24, 5, 4


def case(seed, tied=False):
    """(values [B, E, H] float32, receivers [B, E] int32, edge_mask
    [B, E]); the last PAD edges of each graph are pads (masked, receiver
    0, values 1e3); tied=True puts the values on a grid of halves."""
    rng = np.random.default_rng(seed)
    if tied:
        x = rng.integers(-3, 4, (B, E, H)) / 2.0
    else:
        x = rng.normal(size=(B, E, H))
    recv = rng.choice(RECEIVERS, (B, E))
    mask = rng.random((B, E)) < 0.8
    x[:, -PAD:] = 1e3
    recv[:, -PAD:] = 0
    mask[:, -PAD:] = False
    return x.astype(np.float32), recv.astype(np.int32), mask


def to_jax(x, dtype):
    return jnp.asarray(x, dtype)


def to_torch(x, dtype, grad=False):
    t = torch.tensor(x, dtype=dtype)
    return t.requires_grad_(grad)


def as_np(x):
    if torch.is_tensor(x):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x, jnp.float32))


def row_counts(recv, mask, n):
    """The number of real edges JAX puts in each row (wrapped, dropped
    outside [0, n)), per graph -> [B, n]."""
    idx = np.where(recv < 0, recv + n, recv)
    ok = mask & (idx >= 0) & (idx < n)
    out = np.zeros((recv.shape[0], n), np.int64)
    for b in range(recv.shape[0]):
        np.add.at(out[b], idx[b][ok[b]], 1)
    return out


def test_jax_index_wraps_and_drops_as_jax_does():
    """A stream with receivers [-1, 0, 5, 1] into 3 rows: the -1
    message lands on row 2, the 5 message drops; -4 (below -V) drops
    too, as JAX drops it."""
    msg = np.arange(1.0, 6.0, dtype=np.float32)[:, None]
    recv = np.array([-1, 0, 5, 1, -4], np.int32)
    mask = np.ones(5, bool)
    want = np.asarray(jsc.scatter_sum_flat(jnp.asarray(msg),
                                           jnp.asarray(recv),
                                           jnp.asarray(mask), 3))
    got = tsc.scatter_sum_flat(torch.tensor(msg), torch.tensor(recv),
                               torch.tensor(mask), 3)
    np.testing.assert_array_equal(want.ravel(), [2.0, 4.0, 1.0])
    np.testing.assert_array_equal(got.numpy(), want)
    idx, inside = tsc.jax_index(torch.tensor(recv), 3)
    assert idx.tolist()[:4] == [2, 0, 5, 1] and idx.dtype == torch.int64
    assert inside.tolist() == [True, True, False, True, False]


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_scatter_sum_flat_matches_jax(dtype):
    jdt, tdt = DTYPES[dtype]
    x, recv, mask = case(0)
    msg, recv, mask = x[0], recv[0], mask[0]
    g = np.random.default_rng(1).normal(size=(V, H)).astype(np.float32)
    want, vjp = jax.vjp(lambda m: jsc.scatter_sum_flat(
        m, jnp.asarray(recv), jnp.asarray(mask), V), to_jax(msg, jdt))
    (want_grad,) = vjp(to_jax(g, jdt))
    m = to_torch(msg, tdt, grad=True)
    got = tsc.scatter_sum_flat(m, torch.tensor(recv), torch.tensor(mask), V)
    got.backward(to_torch(g, tdt))
    assert got.dtype == tdt and got.shape == (V, H)
    assert not np.asarray(want)[[4, 6]].any()
    if dtype == "float32":
        np.testing.assert_allclose(as_np(got), as_np(want), **F32)
        np.testing.assert_allclose(as_np(m.grad), as_np(want_grad), **F32)
        return
    np.testing.assert_array_equal(as_np(m.grad), as_np(want_grad))
    # the row's absolute sum and JAX's float32 sum of the same bf16 values
    xb = as_np(to_jax(msg, jdt))
    abs_sum = np.asarray(jsc.scatter_sum_flat(
        jnp.abs(jnp.asarray(xb)), jnp.asarray(recv), jnp.asarray(mask), V))
    f32 = np.asarray(jsc.scatter_sum_flat(jnp.asarray(xb), jnp.asarray(recv),
                                          jnp.asarray(mask), V))
    d = row_counts(recv[None], mask[None], V)[0][:, None]
    np.testing.assert_array_less(np.abs(as_np(got) - as_np(want)),
                                 (d + 1) * BF16_ULP * abs_sum + 1e-30)
    np.testing.assert_array_less(np.abs(as_np(got) - f32),
                                 BF16_ULP * np.abs(f32) + 1e-6 * abs_sum
                                 + 1e-30)


def test_scatter_sum_flat_sorted_flag_changes_no_number():
    """indices_sorted=True on a sorted stream (tests/test_scatter.py:75):
    the same numbers as without it, and as JAX's."""
    rng = np.random.default_rng(2)
    recv = np.sort(rng.integers(0, 16, 64)).astype(np.int32)
    msg = rng.normal(size=(64, 8)).astype(np.float32)
    mask = rng.integers(0, 2, 64).astype(bool)
    want = np.asarray(jsc.scatter_sum_flat(
        jnp.asarray(msg), jnp.asarray(recv), jnp.asarray(mask), 16,
        indices_sorted=True))
    args = (torch.tensor(msg), torch.tensor(recv), torch.tensor(mask), 16)
    a = tsc.scatter_sum_flat(*args)
    b = tsc.scatter_sum_flat(*args, indices_sorted=True)
    np.testing.assert_array_equal(a.numpy(), b.numpy())
    np.testing.assert_allclose(b.numpy(), want, **F32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_scatter_max_edges_matches_jax(dtype, tied):
    jdt, tdt = DTYPES[dtype]
    x, recv, mask = case(3, tied)
    g = np.random.default_rng(4).normal(size=(B, V, H)).astype(np.float32)
    want, vjp = jax.vjp(lambda m: jsc.scatter_max_edges(
        m, jnp.asarray(recv), jnp.asarray(mask), V), to_jax(x, jdt))
    (want_grad,) = vjp(to_jax(g, jdt))
    m = to_torch(x, tdt, grad=True)
    got = tsc.scatter_max_edges(m, torch.tensor(recv), torch.tensor(mask), V)
    got.backward(to_torch(g, tdt))
    assert got.dtype == tdt and got.shape == (B, V, H)
    # empty rows are 0; the tied case splits a gradient somewhere
    assert not as_np(want)[:, [4, 6]].any()
    np.testing.assert_array_equal(as_np(got), as_np(want))
    # a gradient split k ways is the cotangent over k in the port and
    # times 1/k in JAX: one rounding apart
    rel = 1e-6 if dtype == "float32" else BF16_ULP
    np.testing.assert_allclose(as_np(m.grad), as_np(want_grad), rtol=rel,
                               atol=0)
    if tied:
        frac = np.abs(as_np(want_grad)) / np.maximum(
            np.abs(np.take_along_axis(
                g, np.where(recv < 0, recv + V, recv).clip(0, V - 1)
                [..., None].repeat(H, -1), 1)), 1e-30)
        assert ((frac > 0.2) & (frac < 0.8)).any()


def test_scatter_max_edges_splits_the_gradient_among_ties():
    """Two tied 1.0s get half the row's gradient each, as in JAX."""
    x = np.array([[[1.0], [1.0], [0.5], [2.0]]], np.float32)
    recv = np.array([[0, 0, 0, 1]], np.int32)
    mask = np.ones((1, 4), bool)
    want = jax.grad(lambda m: jsc.scatter_max_edges(
        m, jnp.asarray(recv), jnp.asarray(mask), 3).sum())(jnp.asarray(x))
    m = to_torch(x, torch.float32, grad=True)
    tsc.scatter_max_edges(m, torch.tensor(recv), torch.tensor(mask),
                          3).sum().backward()
    np.testing.assert_array_equal(np.asarray(want).ravel(),
                                  [0.5, 0.5, 0.0, 1.0])
    np.testing.assert_array_equal(m.grad.numpy(), np.asarray(want))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tied", [False, True], ids=["random", "tied"])
def test_segment_softmax_edges_matches_jax(dtype, tied):
    jdt, tdt = DTYPES[dtype]
    x, recv, mask = case(5, tied)
    scores = x[..., 0]
    g = np.random.default_rng(6).normal(size=(B, E)).astype(np.float32)
    want, vjp = jax.vjp(lambda s: jsc.segment_softmax_edges(
        s, jnp.asarray(recv), jnp.asarray(mask), V), to_jax(scores, jdt))
    (want_grad,) = vjp(to_jax(g, jdt))
    s = to_torch(scores, tdt, grad=True)
    got = tsc.segment_softmax_edges(s, torch.tensor(recv),
                                    torch.tensor(mask), V)
    got.backward(to_torch(g, tdt))
    assert got.dtype == tdt and got.shape == (B, E)
    want, got = as_np(want), as_np(got)
    # a receiver outside [-V, V) reads NaN in JAX, masked or not; a
    # masked edge in range is 0
    outside = (recv < -V) | (recv >= V)
    np.testing.assert_array_equal(np.isnan(want), outside)
    np.testing.assert_array_equal(np.isnan(got), outside)
    assert not want[~mask & ~outside].any()
    if dtype == "float32":
        np.testing.assert_allclose(got, want, **F32)
        np.testing.assert_allclose(as_np(s.grad), as_np(want_grad), **F32)
        return
    idx = np.where(recv < 0, recv + V, recv).clip(0, V - 1)
    d = np.take_along_axis(row_counts(recv, mask, V), idx, 1)
    ok = ~outside
    np.testing.assert_array_less(np.abs(got - want)[ok],
                                 ((d + 2) * BF16_ULP * np.abs(want))[ok]
                                 + 1e-30)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("self_loop", [True, False])
def test_edge_norm_device_matches_jax(dtype, self_loop):
    jdt, tdt = DTYPES[dtype]
    rng = np.random.default_rng(7)
    deg = rng.integers(0, 4, (B, V)).astype(np.float32)
    deg[:, 4] = 0
    _, recv, _ = case(8)
    want = jsp.edge_norm_device(to_jax(deg, jdt), jnp.asarray(recv),
                                self_loop)
    got = tsp.edge_norm_device(to_torch(deg, tdt), torch.tensor(recv),
                               self_loop)
    assert got.dtype == tdt and got.shape == (B, E, 1)
    np.testing.assert_array_equal(as_np(got), as_np(want))
    # integer degrees give float32 norms, as JAX's
    got_i = tsp.edge_norm_device(torch.tensor(deg.astype(np.int64)),
                                 torch.tensor(recv), self_loop)
    want_i = jsp.edge_norm_device(jnp.asarray(deg.astype(np.int32)),
                                  jnp.asarray(recv), self_loop)
    assert got_i.dtype == torch.float32 and want_i.dtype == jnp.float32
    np.testing.assert_array_equal(got_i.numpy(), np.asarray(want_i))
