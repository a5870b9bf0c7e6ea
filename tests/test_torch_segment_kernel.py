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

import jax
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


@pytest.mark.parametrize("width", [1, 3, 50, 101, 128, 129])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_take_rows(dtype, width):
    """gather_rows_sorted on the CPU against table[idx] with the pad tail
    zero, bitwise (NaN and -0 included), returned and written into an
    `out` view at an odd storage offset."""
    recv, recv_padded, _, _ = make_stream(6, h=width)
    n_real, e = len(recv), len(recv_padded)
    table = torch.from_numpy(np.random.default_rng(7).normal(
        size=(300, width)).astype(np.float32)).to(torch_dtype(dtype))
    table[3, 0], table[4, -1] = float("nan"), -0.0
    idx = torch.from_numpy(recv_padded)
    want = table[idx]
    want[n_real:] = 0
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    got = tsk.gather_rows_sorted(table, idx, n_real)
    assert torch.equal(got.view(bits), want.view(bits))
    buf = torch.full((e * width + 1,), 7.0, dtype=table.dtype)
    out = buf[1:].view(e, width)
    assert tsk.gather_rows_sorted(table, idx, n_real, out=out) is out
    assert torch.equal(out.view(bits), want.view(bits)) and buf[0] == 7.0
    with pytest.raises(ValueError, match="out must be"):
        tsk.gather_rows_sorted(table, idx, n_real, out=out.float()
                               if dtype == "bfloat16" else out.double())


def test_entry_points_raise_on_requires_grad():
    """The kernel entry points build no graph, so a call autograd records
    raises (a gradient would be lost silently); the autograd Functions
    take the same inputs."""
    recv, recv_padded, msg, row_ptr = make_stream(4, h=8)
    m = torch.from_numpy(msg).requires_grad_()
    with pytest.raises(RuntimeError, match="SegmentSumSorted"):
        tsk.segment_sum_sorted(m, torch.from_numpy(row_ptr))
    table = torch.zeros(300, 8, requires_grad=True)
    with pytest.raises(RuntimeError, match="GatherRowsSorted"):
        tsk.gather_rows_sorted(table, torch.from_numpy(recv_padded),
                               len(recv))
    with torch.no_grad():       # the same inputs pass without autograd
        tsk.segment_sum_sorted(m, torch.from_numpy(row_ptr))
    out = tsk.SegmentSumSorted.apply(m, torch.from_numpy(row_ptr),
                                     torch.from_numpy(recv_padded), len(recv))
    assert out.requires_grad


def _vjp_case(seed, dtype, w=21):
    """A padded receiver-sorted stream with its receiver and sender
    plans, a table and a cotangent whose pad rows are zero (as the
    model's are)."""
    recv, recv_padded, _, row_ptr = make_stream(seed)
    rng = np.random.default_rng(seed + 10)
    n_real, e, v = len(recv), len(recv_padded), 300
    senders = np.concatenate([rng.integers(0, v, n_real),
                              np.zeros(e - n_real, np.int64)])
    send_order = np.argsort(senders, kind="stable")
    sk2 = np.searchsorted(senders[send_order], np.arange(v + 1)).astype(
        np.int32)
    table = rng.normal(size=(v, w)).astype(np.float32)
    g_rows = rng.normal(size=(e, w)).astype(np.float32)
    g_rows[n_real:] = 0
    g_nodes = rng.normal(size=(v, w)).astype(np.float32)
    msg = rng.normal(size=(e, w)).astype(np.float32)
    msg[n_real:] = 0
    t = torch.from_numpy
    return dict(recv=recv_padded, senders=senders, send_order=send_order,
                row_ptr=row_ptr, sk2=sk2, n_real=n_real, table=table,
                g_rows=g_rows, g_nodes=g_nodes, msg=msg,
                t=dict(recv=t(recv_padded), senders=t(senders),
                       send_order=t(send_order), row_ptr=t(row_ptr),
                       sk2=t(sk2), table=t(table).to(torch_dtype(dtype)),
                       g_rows=t(g_rows).to(torch_dtype(dtype)),
                       g_nodes=t(g_nodes).to(torch_dtype(dtype)),
                       msg=t(msg).to(torch_dtype(dtype))))


def _port_grad(fn, x, g):
    x = x.clone().requires_grad_()
    fn(x).backward(g)
    return x.grad


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_autograd_pairings_match_jax_vjps(dtype):
    """The three Functions' plain-version gradients against the JAX
    package's custom VJPs of the same operations: the receiver gather
    (_take_rows, sorted), the sender gather (_take_rows_perm) and the
    aggregation (_segment_sum_f32). Every one sums in float32 and rounds
    once to the dtype, so they agree as K1 does (1e-5 in f32, one bf16
    ulp in bf16); the aggregation's backward is a gather — bitwise."""
    from dualmessagepassing_tpu.unc import model as jm

    c = _vjp_case(5, dtype)
    x = c["t"]
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    table = jnp.asarray(c["table"]).astype(jd)

    got = _port_grad(lambda tb: tsk.GatherRowsSorted.apply(
        tb, x["recv"], c["n_real"], x["row_ptr"]), x["table"], x["g_rows"])
    _, vjp = jax.vjp(lambda tb: jm._take_rows(tb, jnp.asarray(c["recv"]),
                                              sorted_idx=True), table)
    want = vjp(jnp.asarray(c["g_rows"]).astype(jd))[0]
    assert got.dtype == x["table"].dtype
    assert_k1_close(got.float(), want.astype(jnp.float32), dtype)

    got = _port_grad(lambda tb: tsk.GatherRowsPerm.apply(
        tb, x["senders"], x["send_order"], x["sk2"]), x["table"],
        x["g_rows"])
    _, vjp = jax.vjp(lambda tb: jm._take_rows_perm(
        tb, jnp.asarray(c["senders"]), jnp.asarray(c["send_order"]),
        jnp.asarray(c["senders"][c["send_order"]])), table)
    want = vjp(jnp.asarray(c["g_rows"]).astype(jd))[0]
    assert_k1_close(got.float(), want.astype(jnp.float32), dtype)

    got = _port_grad(lambda m: tsk.SegmentSumSorted.apply(
        m, x["row_ptr"], x["recv"], c["n_real"]), x["msg"], x["g_nodes"])
    _, vjp = jax.vjp(lambda m: jm._segment_sum_f32(
        m, jnp.asarray(c["recv"]), 300, 21, True),
        jnp.asarray(c["msg"]).astype(jd))
    want = np.asarray(vjp(jnp.asarray(c["g_nodes"]).astype(jd))[0]
                      .astype(jnp.float32))
    got = got.float().numpy()
    np.testing.assert_array_equal(got[:c["n_real"]], want[:c["n_real"]])
    assert (got[c["n_real"]:] == 0).all()       # K2 zeroes the pad tail


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


@pytest.mark.parametrize("h", [1, 50])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k1_plain_rows_reads_through_the_index(dtype, h):
    """segment_sum_sorted(msg, row_ptr, rows=...) on the CPU equals the
    plain sum of the permuted copy msg[rows], bitwise (the same float32
    additions in the same order); edges past row_ptr[V] are not read, so
    rows may be longer and msg may have pad rows."""
    recv, _, msg, row_ptr = make_stream(8, h=h)
    n = len(recv)
    rng = np.random.default_rng(9)
    perm = np.concatenate([rng.permutation(len(msg))[:n],
                           np.full(7, -1)])        # never read
    m = torch.from_numpy(msg).to(torch_dtype(dtype))
    rp = torch.from_numpy(row_ptr)
    got = tsk.segment_sum_sorted(m, rp, rows=torch.from_numpy(perm))
    want = tsk.segment_sum_sorted(m[torch.from_numpy(perm[:n])], rp)
    bits = torch.int16 if dtype == "bfloat16" else torch.int32
    assert got.dtype == m.dtype
    assert torch.equal(got.view(bits), want.view(bits))


@pytest.mark.parametrize("w", [21, 101])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gather_rows_perm_grad_matches_take_rows_win_perm(dtype, w):
    """GatherRowsPerm's gradient, which K1 sums through the sender order
    (rows=) with no permuted copy, against the JAX package's
    _take_rows_win_perm VJP, whose windowed kernel sums g[order] (Pallas
    in interpret mode). All edges real. bf16: the kernel's bf16 mode sums
    in f32, so K1's tolerance. f32: the VJP runs the kernel's default
    "hilo" mode (two bf16 passes, ~1e-4 accurate), held to the JAX
    package's own hilo tolerance (2e-3, tests/test_segment_kernel.py), and
    the port also to 1e-5 of the exact float64 sum."""
    from dualmessagepassing_tpu.unc.model import _take_rows_win_perm

    rng = np.random.default_rng(20 + w)
    v, e = 40, 192
    senders = rng.integers(0, v, e)
    senders[:50] = 7                                  # a hub
    rng.shuffle(senders)
    sub = {"node_mask": np.ones(v, bool), "edge_mask": np.ones(e, bool),
           "senders": senders,
           "receivers": np.sort(rng.integers(0, v, e))}
    planned = sk.attach_scatter_plan(sub, sender_plan=True)
    order = planned["send_order"]
    table = rng.normal(size=(v, w)).astype(np.float32)
    g = rng.normal(size=(e, w)).astype(np.float32)
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    plan = [jnp.asarray(planned[k]) for k in
            ("sk2_recv", "sk2_blk", "sk2_win", "sk2_first")]
    _, vjp = jax.vjp(lambda t: _take_rows_win_perm(
        t, jnp.asarray(senders), jnp.asarray(order), *plan),
        jnp.asarray(table).astype(jd))
    sk.INTERPRET = True
    try:
        want = vjp(jnp.asarray(g).astype(jd))[0]
    finally:
        sk.INTERPRET = False
    sk2 = np.searchsorted(senders[order], np.arange(v + 1)).astype(np.int32)
    t = torch.from_numpy
    got = _port_grad(lambda tb: tsk.GatherRowsPerm.apply(
        tb, t(senders), t(order), t(sk2)), t(table).to(torch_dtype(dtype)),
        t(g).to(torch_dtype(dtype)))
    assert got.dtype == torch_dtype(dtype)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == "bfloat16":
        assert_k1_close(got.float(), want, dtype)
    else:
        np.testing.assert_allclose(got.numpy(), want, rtol=2e-3, atol=2e-3)
        exact = np.zeros((v, w))
        np.add.at(exact, senders, g.astype(np.float64))
        assert_k1_close(got, exact, dtype)


def k1_partition(row_ptr, n_shares):
    """A numpy model of K1's partition (csrc/segment_kernels.cu:
    merge_split and segment_sum_kernel, the merge path): the V + N
    items (row ends and edges) in n_shares equal shares. Per share: the
    rows it writes whole, as {row: edges}; its head (the row it ends that
    began in an earlier share, its edges here, and the share holding the
    row's first edge); its carry (the row still open at its end, and its
    edges here)."""
    rp = np.asarray(row_ptr, np.int64)
    v, n = len(rp) - 1, int(rp[-1])
    total = v + n
    per = -(-total // n_shares)
    d = np.minimum(np.arange(n_shares + 1) * per, total)
    # rows whose end item lies before item d: row x ends at item
    # row_ptr[x + 1] + x
    x = np.searchsorted(rp[1:] + np.arange(1, v + 1), d, side="right")
    shares = []
    for s in range(n_shares):
        i0, i1 = int(x[s]), int(x[s + 1])
        j0, j1 = int(d[s] - i0), int(d[s + 1] - i1)
        head_cut = i0 < i1 and rp[i0] < j0
        whole, head, carry = {}, None, None
        for i in range(i0, i1):
            edges = range(max(j0, int(rp[i])), int(rp[i + 1]))
            if i == i0 and head_cut:
                head = (i, edges, int((rp[i] + i) // per))
            else:
                whole[i] = edges
        if i1 < v and j1 > max(j0, int(rp[i1])):
            carry = (i1, range(max(j0, int(rp[i1])), j1))
        shares.append((whole, head, carry))
    return shares


def k1_partition_cases():
    rng = np.random.default_rng(30)
    hub = np.sort(np.concatenate([rng.integers(0, 300, 400),
                                  np.full(2000, 120)]))
    hub = hub[(hub < 200) | (hub >= 260)]           # an empty band
    return {
        "hub_and_empty_band": np.searchsorted(hub, np.arange(301)),
        "one_row": np.array([0, 777]),               # V = 1
        "no_edges": np.zeros(51, np.int64),          # n_real = 0
        "all_in_one_row": np.array([0, 0, 0, 900, 900, 900]),
        "short_rows": np.searchsorted(np.sort(rng.integers(0, 500, 1900)),
                                      np.arange(501)),
    }


@pytest.mark.parametrize("n_shares", [1, 7, 64, 5000])
@pytest.mark.parametrize("case", sorted(k1_partition_cases()))
def test_k1_partition_covers_every_edge_and_row_once(case, n_shares):
    """In the model of K1's partition every edge is read once, for its
    own row; every row is written once: whole by one share, or after the
    grid barrier by the share that ends it, from the carries of exactly
    the shares from the one holding the row's first edge to its own,
    each carrying that row. The sums it builds equal the plain sums."""
    rp = k1_partition_cases()[case]
    v, n = len(rp) - 1, int(rp[-1])
    row_of = np.repeat(np.arange(v), np.diff(rp))
    msg = np.random.default_rng(31).normal(size=n)
    shares = k1_partition(rp, n_shares)
    reads = np.zeros(n, int)
    writes = np.zeros(v, int)
    out = np.zeros(v)
    carries = {}
    for s, (whole, head, carry) in enumerate(shares):
        for i, edges in whole.items():
            assert (row_of[list(edges)] == i).all()
            reads[list(edges)] += 1
            writes[i] += 1
            out[i] = msg[list(edges)].sum()
        if carry is not None:
            r, edges = carry
            assert (row_of[list(edges)] == r).all()
            reads[list(edges)] += 1
            carries[s] = (r, msg[list(edges)].sum())
    for s, (_, head, _) in enumerate(shares):     # after the barrier
        if head is None:
            continue
        r, edges, first = head
        assert (row_of[list(edges)] == r).all()
        reads[list(edges)] += 1
        assert first < s and all(carries[t][0] == r
                                 for t in range(first, s))
        assert first == 0 or carries.get(first - 1, (None,))[0] != r
        writes[r] += 1
        out[r] = sum(carries[t][1] for t in range(first, s)) + \
            msg[list(edges)].sum()
    assert (reads == 1).all() and (writes == 1).all()
    np.testing.assert_allclose(out, np.bincount(row_of, msg, minlength=v),
                               rtol=1e-12, atol=1e-12)
