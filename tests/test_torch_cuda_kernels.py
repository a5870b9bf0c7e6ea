"""The port's CUDA kernels on the card (they have no CPU mode).

Each test takes the `cuda` fixture, which skips it where
torch.cuda.is_available() is false — as on a CPU-only machine. On a
machine with the card and without jax (tests/conftest.py imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances as stated in chip_smoke.py: K1, K3 and K4 within 2**-20
of each row's absolute sum (plus one bf16 ulp for a bf16 K1 output);
K2 bitwise; the autograd Functions' gradients as the kernels they
launch.
"""

import copy

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu_torch.ops import scatter_kernels as sc
from dualmessagepassing_tpu_torch.ops import segment_kernel as sk
from dualmessagepassing_tpu_torch.unc.driver import (make_unc_optimizer,
                                                     make_unc_supervised_step,
                                                     make_unc_train_step,
                                                     to_device)
from dualmessagepassing_tpu_torch.unc.model import (UNCTrainModel,
                                                    apply_unc_forward)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda", 0)


def stream(seed, v=500, e_real=3000, e_pad=200, width=50):
    rng = np.random.default_rng(seed)
    recv = np.sort(rng.integers(0, v // 2, e_real))    # rows >= v/2 empty
    recv[:1000] = recv[0]                               # a hub
    recv = np.sort(recv)
    recv_padded = np.concatenate([recv, np.full(e_pad, recv[-1])])
    row_ptr = np.searchsorted(recv, np.arange(v + 1)).astype(np.int32)
    msg = rng.normal(size=(e_real + e_pad, width)).astype(np.float32)
    msg[e_real:] = 1e3
    return msg, row_ptr, recv_padded, e_real


@pytest.mark.parametrize("size", [(500, 3000), (5000, 30000)])
@pytest.mark.parametrize("width", [1, 50, 101, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, dtype, width, size):
    """A short stream (one block per row) and a longer one (merge path),
    each with a hub, empty rows and a pad tail."""
    v, e_real = size
    msg, row_ptr, _, _ = stream(0, v=v, e_real=e_real, width=width)
    m = torch.from_numpy(msg).to(cuda, dtype)
    rp = torch.from_numpy(row_ptr).to(cuda)
    with torch.inference_mode():
        got = sk.segment_sum_sorted(m, rp).float()
        want = sk.segment_sum_sorted_plain(m, rp).float()
        abs_sum = sk.segment_sum_sorted_plain(m.float().abs(), rp)
    torch.cuda.synchronize()
    bound = 2.0 ** -20 * abs_sum
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
    assert ((got - want).abs() <= bound).all()
    assert (got[v // 2:] == 0).all()


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def k1_within_bound(got, want, abs_sum, dtype):
    got, want = got.float(), want.float()
    bound = 2.0 ** -20 * abs_sum
    if dtype == torch.bfloat16:
        bound = bound + 2.0 ** -7 * torch.maximum(got.abs(), want.abs())
    return bool(((got - want).abs() <= bound).all())


@pytest.mark.parametrize("size", [(500, 3000), (5000, 30000)])
@pytest.mark.parametrize("width", [1, 50, 64, 101])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_is_deterministic(cuda, dtype, width, size):
    """Four calls give the same bits, in both regimes: the order of every
    add follows from the shapes alone."""
    msg, row_ptr, _, _ = stream(12, v=size[0], e_real=size[1], width=width)
    m = torch.from_numpy(msg).to(cuda, dtype)
    rp = torch.from_numpy(row_ptr).to(cuda)
    with torch.inference_mode():
        first = sk.segment_sum_sorted(m, rp)
        for _ in range(3):
            assert torch.equal(bits(sk.segment_sum_sorted(m, rp)),
                               bits(first))


@pytest.mark.parametrize("case", ["hub", "empty", "one_row", "rows",
                                  "empty_rows"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_merge_path_cases(cuda, dtype, case):
    """A hub of 100,000 edges among short rows, a row pointer with every
    row empty, all edges in one row (V = 1), a row index (rows=) against
    the permuted copy it replaces (bitwise) and the plain version, and an
    empty row index under an empty row pointer (an edge-partitioned rank
    whose share holds no real edge); the pad tail (1e3) is never
    read."""
    rng = np.random.default_rng(13)
    v, width = 2000, 101
    recv = np.sort(np.concatenate([np.full(100000, 700),
                                   rng.integers(0, v, 20000)]))
    row_ptr = np.searchsorted(recv, np.arange(v + 1)).astype(np.int32)
    n = len(recv)
    if case in ("empty", "empty_rows"):
        row_ptr[:] = 0
    elif case == "one_row":
        row_ptr = np.array([0, n], np.int32)
    msg = rng.normal(size=(n + 300, width)).astype(np.float32)
    msg[n:] = 1e3
    m = torch.from_numpy(msg).to(cuda, dtype)
    rp = torch.from_numpy(row_ptr).to(cuda)
    rows = (torch.from_numpy(rng.permutation(n)).to(cuda)
            if case == "rows" else None)
    if case == "empty_rows":
        rows = torch.zeros(0, dtype=torch.int64, device=cuda)
    with torch.inference_mode():
        got = sk.segment_sum_sorted(m, rp, rows=rows)
        want = sk.segment_sum_sorted_plain(m, rp, rows)
        abs_sum = sk.segment_sum_sorted_plain(m.float().abs(), rp, rows)
        if case == "rows":
            copy_sum = sk.segment_sum_sorted(m.index_select(0, rows), rp)
            assert torch.equal(bits(got), bits(copy_sum))
    torch.cuda.synchronize()
    assert got.shape == (len(row_ptr) - 1, width) and got.dtype == dtype
    assert k1_within_bound(got, want, abs_sum, dtype)
    if case in ("empty", "empty_rows"):
        assert (got == 0).all()


@pytest.mark.parametrize("width", [1, 3, 50, 101, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_bitwise(cuda, dtype, width):
    _, _, recv_padded, n_real = stream(1)
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(500, width)).astype(
        np.float32)).to(cuda, dtype)
    table[recv_padded[0], 0], table[recv_padded[-1], -1] = float("nan"), -0.0
    idx = torch.from_numpy(recv_padded).to(cuda)
    with torch.inference_mode():
        got = sk.gather_rows_sorted(table, idx, n_real)
        want = sk.gather_rows_sorted_plain(table, idx, n_real)
    torch.cuda.synchronize()
    assert torch.equal(bits(got), bits(want))
    assert (got[n_real:] == 0).all()


@pytest.mark.parametrize("offsets", [(1, 3), (2, 1), (3, 0), (0, 5)])
@pytest.mark.parametrize("width", [1, 3, 50, 101, 128, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_bitwise_at_offsets(cuda, dtype, width, offsets):
    """K2 on a table and into an output that start `offsets` elements
    into their storage (not 16-byte aligned), with a 5,000-edge hub,
    empty rows and a pad tail: bitwise, and nothing written outside."""
    rng = np.random.default_rng(11)
    v, e_real, e_pad = 3000, 12000, 700
    recv = np.sort(np.concatenate([np.full(5000, 17),
                                   rng.integers(0, v // 2, e_real - 5000)]))
    recv_padded = np.concatenate([recv, np.full(e_pad, recv[-1])])
    e = len(recv_padded)
    t_off, o_off = offsets
    t_buf = torch.from_numpy(rng.normal(size=v * width + t_off).astype(
        np.float32)).to(cuda, dtype)
    table = t_buf[t_off:].view(v, width)
    o_buf = torch.full((e * width + o_off + 9,), 5.0, dtype=dtype,
                       device=cuda)
    out = o_buf[o_off: o_off + e * width].view(e, width)
    idx = torch.from_numpy(recv_padded).to(cuda)
    with torch.inference_mode():
        got = sk.gather_rows_sorted(table, idx, e_real, out=out)
        want = sk.gather_rows_sorted_plain(table, idx, e_real)
    torch.cuda.synchronize()
    assert got is out
    assert torch.equal(bits(out), bits(want))
    assert (o_buf[:o_off] == 5).all() and (o_buf[o_off + e * width:] == 5).all()


def test_wrappers_validate_and_count(cuda):
    msg, row_ptr, recv_padded, n_real = stream(3, width=8)
    m = torch.from_numpy(msg).to(cuda)
    rp = torch.from_numpy(row_ptr).to(cuda)
    idx = torch.from_numpy(recv_padded).to(cuda)
    with torch.inference_mode():
        with pytest.raises(ValueError, match="contiguous"):
            sk.segment_sum_sorted(m.t().contiguous().t(), rp)
        with pytest.raises(TypeError):
            sk.segment_sum_sorted(m.half(), rp)
        with pytest.raises(TypeError):
            sk.segment_sum_sorted(m, rp.long())
        with pytest.raises(TypeError):
            sk.gather_rows_sorted(m, idx.int(), n_real)
        sk.reset_launch_counts()
        sk.segment_sum_sorted(m, rp)
        sk.gather_rows_sorted(m, idx, n_real)
        sk.segment_sum_sorted_plain(m, rp)
    assert dict(sk.LAUNCHES) == {"segment_sum_sorted:fwd": 1,
                                 "gather_rows_sorted:fwd": 1}


def test_model_forward_card_matches_cpu(cuda):
    """Tiny 2-layer model on a hand-made padded batch: the card (kernels)
    against the CPU (plain versions), f32 within 2e-5."""
    rng = np.random.default_rng(4)
    v, e, n_real = 64, 400, 350
    recv = np.sort(rng.integers(0, v, n_real))
    padded = {
        "nid": np.arange(v), "node_mask": np.ones(v, bool),
        "senders": np.concatenate([rng.integers(0, v, n_real),
                                   np.zeros(e - n_real, np.int64)]),
        "receivers": np.concatenate([recv, np.full(e - n_real, recv[-1])]),
        "edge_type": rng.integers(0, 6, e),
        "rev_flag": rng.random(e) < 0.5,
        "edge_mask": np.arange(e) < n_real,
        "edge_norm": rng.random((e, 1)).astype(np.float32),
    }
    padded = sk.attach_csr_plan(padded)
    model = UNCTrainModel(v, 3, 16, num_hidden_layers=2,
                          generator=torch.Generator().manual_seed(0))
    with torch.inference_mode():
        h_cpu = apply_unc_forward(model, to_device(padded, "cpu"))[0]
        h_dev = apply_unc_forward(model.to(cuda),
                                  to_device(padded, cuda))[0].cpu()
    torch.testing.assert_close(h_dev, h_cpu, rtol=0, atol=2e-5)


def within_abs_sum(got, want, abs_sum):
    return bool(((got - want).abs() <= 2.0 ** -20 * abs_sum).all())


@pytest.mark.parametrize("msg_offset", [0, 1])
@pytest.mark.parametrize("v, h", [(700, 64), (700, 63), (3000, 64),
                                  (3000, 1)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_matches_plain(cuda, dtype, v, h, msg_offset):
    """K3 with out-of-range receivers and a hub, at widths that take
    4-column items (H = 64) and single columns (63, 1), on msg at its
    storage's start and one element in (single columns again)."""
    rng = np.random.default_rng(5)
    e = 20000
    recv = rng.integers(-3, v + 5, e)          # out-of-range are dropped
    recv[:3000] = 11                            # a hub
    flat = torch.from_numpy(rng.normal(size=e * h + msg_offset).astype(
        np.float32)).to(cuda, dtype)
    m = flat[msg_offset:].view(e, h)
    r = torch.from_numpy(recv).to(cuda)
    with torch.inference_mode():
        sk.reset_launch_counts()
        got = sc.segment_sum_unsorted(m, r, v)
        want = sc.segment_sum_unsorted_plain(m, r, v)
        abs_sum = sc.segment_sum_unsorted_plain(m.float().abs(), r, v)
    torch.cuda.synchronize()
    assert dict(sk.LAUNCHES) == {"segment_sum_unsorted": 1}
    assert got.dtype == torch.float32
    assert within_abs_sum(got, want, abs_sum)


def test_k4_matches_plain_and_counts_apart(cuda):
    msg, row_ptr, _, _ = stream(6, width=64)
    m = torch.from_numpy(msg).to(cuda)
    rp = torch.from_numpy(row_ptr).to(cuda)
    with torch.inference_mode():
        sk.reset_launch_counts()
        got = sc.csr_segment_sum(m, rp)
        want = sc.csr_segment_sum_plain(m, rp)
        abs_sum = sc.csr_segment_sum_plain(m.abs(), rp)
        with pytest.raises(TypeError):
            sc.csr_segment_sum(m.bfloat16(), rp)
    torch.cuda.synchronize()
    assert within_abs_sum(got, want, abs_sum)
    assert dict(sk.LAUNCHES) == {"csr_segment_sum": 1}


def test_k4_at_the_bench_small_size(cuda):
    """K4 at 64 x 4,096, H = 64 (a short stream: one block per row), one
    launch counted per call."""
    rng = np.random.default_rng(14)
    recv = np.sort(rng.integers(0, 64, 4096))
    row_ptr = np.searchsorted(recv, np.arange(65)).astype(np.int32)
    m = torch.from_numpy(rng.normal(size=(4096, 64)).astype(
        np.float32)).to(cuda)
    rp = torch.from_numpy(row_ptr).to(cuda)
    with torch.inference_mode():
        sk.reset_launch_counts()
        got = sc.csr_segment_sum(m, rp)
        want = sc.csr_segment_sum_plain(m, rp)
        abs_sum = sc.csr_segment_sum_plain(m.abs(), rp)
    torch.cuda.synchronize()
    assert within_abs_sum(got, want, abs_sum)
    assert dict(sk.LAUNCHES) == {"csr_segment_sum": 1}


def _grad(fn, x, g):
    x = x.detach().clone().requires_grad_()
    fn(x).backward(g)
    return x.grad


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_autograd_functions_match_plain_gradients(cuda, dtype):
    """Each Function on the card (kernels forward and backward) against
    the same Function on the CPU (plain versions)."""
    rng = np.random.default_rng(7)
    msg, row_ptr, recv_padded, n_real = stream(8, width=101)
    v, e = len(row_ptr) - 1, len(recv_padded)
    senders = np.concatenate([rng.integers(0, v, n_real),
                              np.zeros(e - n_real, np.int64)])
    order = np.argsort(senders, kind="stable")
    order = order[order < n_real]           # attach_csr_plan's sk2_order
    sk2 = np.searchsorted(senders[order], np.arange(v + 1)).astype(np.int32)
    g_rows = rng.normal(size=(e, 101)).astype(np.float32)
    g_rows[n_real:] = 0
    table = rng.normal(size=(v, 101)).astype(np.float32)
    g_nodes = rng.normal(size=(v, 101)).astype(np.float32)
    cases = {
        "GatherRowsSorted": (lambda d: lambda tb: sk.GatherRowsSorted.apply(
            tb, d["recv"], n_real, d["rp"]), table, g_rows),
        "GatherRowsPerm": (lambda d: lambda tb: sk.GatherRowsPerm.apply(
            tb, d["senders"], d["order"], d["sk2"]), table, g_rows),
        "SegmentSumSorted": (lambda d: lambda mm: sk.SegmentSumSorted.apply(
            mm, d["rp"], d["recv"], n_real), msg * (np.arange(e) < n_real)[
                :, None], g_nodes),
    }
    for name, (make, x, g) in cases.items():
        grads = {}
        for dev in ("cpu", cuda):
            t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
            d = dict(recv=t(recv_padded), rp=t(row_ptr), senders=t(senders),
                     order=t(order), sk2=t(sk2))
            grads[str(dev)] = _grad(make(d), t(x).to(dtype),
                                    t(g).to(dtype)).cpu().float()
        torch.cuda.synchronize()
        got, want = grads[str(cuda)], grads["cpu"]
        if name == "SegmentSumSorted":
            assert torch.equal(got, want), name      # K2: a gather
        else:
            # K1 sums the cotangent rows in another order than the CPU's
            # index_add_: its bound, on the rows it sums
            g_abs = torch.from_numpy(np.abs(g))
            abs_sum = (sk.segment_sum_sorted_plain(
                g_abs, torch.from_numpy(row_ptr)) if name ==
                "GatherRowsSorted" else sk.segment_sum_sorted_plain(
                    g_abs, torch.from_numpy(sk2), torch.from_numpy(order)))
            assert k1_within_bound(got, want, abs_sum, dtype), name


def test_index_select_backward_sums_bf16_on_the_card(cuda):
    """The fault the sender gather's Function repairs: on the card,
    index_select's autograd backward sums a bf16 cotangent with bf16
    atomics, and a hub of 1,000 edges loses its precision; the Function
    sums in float32 (K1) and rounds once."""
    rng = np.random.default_rng(9)
    v, e, w = 50, 1500, 21
    senders = np.concatenate([np.full(1000, 7), rng.integers(0, v, e - 1000)])
    rng.shuffle(senders)
    order = np.argsort(senders, kind="stable")
    sk2 = np.searchsorted(senders[order], np.arange(v + 1)).astype(np.int32)
    g = torch.from_numpy((rng.normal(size=(e, w)) * 0.1 + 1.0).astype(
        np.float32)).to(cuda, torch.bfloat16)
    idx = torch.from_numpy(senders).to(cuda)
    want = torch.zeros(v, w, device=cuda).index_add_(0, idx, g.float())
    table = torch.zeros(v, w, dtype=torch.bfloat16, device=cuda)
    got = _grad(lambda tb: sk.gather_rows_perm(
        tb, idx, torch.from_numpy(order).to(cuda),
        torch.from_numpy(sk2).to(cuda)), table, g).float()
    plain = _grad(lambda tb: tb.index_select(0, idx), table, g).float()
    torch.cuda.synchronize()
    assert bool(((got - want).abs() <= 2.0 ** -8 * want.abs()).all())
    assert ((plain - want).abs() / want.abs()).max().item() > 8 * 2.0 ** -8


def test_train_step_card_matches_cpu(cuda):
    """One f32 train step of a tiny 2-layer model on a hand-made padded
    batch: the loss and every updated parameter on the card against the
    CPU, and the launches of one step (per layer K1 x3, K2 x2)."""
    rng = np.random.default_rng(10)
    v, e, n_real, s = 64, 400, 350, 60
    recv = np.sort(rng.integers(0, v, n_real))
    senders = np.concatenate([rng.integers(0, v, n_real),
                              np.zeros(e - n_real, np.int64)])
    order = np.argsort(senders, kind="stable")
    padded = {
        "nid": np.arange(v), "node_mask": np.ones(v, bool),
        "senders": senders, "send_order": order,
        "senders_sorted": senders[order],
        "receivers": np.concatenate([recv, np.full(e - n_real, recv[-1])]),
        "edge_type": rng.integers(0, 6, e),
        "rev_flag": rng.random(e) < 0.5,
        "edge_mask": np.arange(e) < n_real,
        "edge_norm": rng.random((e, 1)).astype(np.float32),
        "samples": np.stack([rng.integers(0, v, s), rng.integers(0, 3, s),
                             rng.integers(0, v, s)], 1),
        "labels": (np.arange(s) < 10).astype(np.float32),
        "sample_mask": np.arange(s) < 50,
    }
    padded = sk.attach_csr_plan(padded, sender_plan=True)
    gen = torch.Generator().manual_seed(1)
    model = UNCTrainModel(v, 3, 16, num_hidden_layers=2, reg_param=0.01,
                          generator=gen)
    cpu = copy.deepcopy(model)
    card = copy.deepcopy(model).to(cuda)
    loss_cpu = make_unc_train_step(cpu, make_unc_optimizer(cpu, 1e-2, 3))(
        to_device(padded, "cpu"))
    sk.reset_launch_counts()
    loss_card = make_unc_train_step(card, make_unc_optimizer(card, 1e-2, 3))(
        to_device(padded, cuda))
    torch.cuda.synchronize()
    assert dict(sk.LAUNCHES) == {
        "segment_sum_sorted:fwd": 2, "segment_sum_sorted:bwd": 4,
        "gather_rows_sorted:fwd": 2, "gather_rows_sorted:bwd": 2}
    assert abs(loss_card.item() - loss_cpu.item()) <= 1e-5
    for (k, a), b in zip(card.state_dict().items(),
                         cpu.state_dict().values()):
        if k.endswith(("nbias", "ebias", "fc0_bias", "running_mean")):
            continue        # BN-fed biases: Adam steps on rounding noise
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5,
                                   msg=k)


def _padded_train_batch(rng, v=64, e=400, n_real=350, s=60, rels=3):
    recv = np.sort(rng.integers(0, v, n_real))
    senders = np.concatenate([rng.integers(0, v, n_real),
                              np.zeros(e - n_real, np.int64)])
    order = np.argsort(senders, kind="stable")
    return sk.attach_csr_plan({
        "nid": np.arange(v), "node_mask": np.ones(v, bool),
        "senders": senders, "send_order": order,
        "senders_sorted": senders[order],
        "receivers": np.concatenate([recv, np.full(e - n_real, recv[-1])]),
        "edge_type": rng.integers(0, 2 * rels, e),
        "rev_flag": rng.random(e) < 0.5,
        "edge_mask": np.arange(e) < n_real,
        "edge_norm": rng.random((e, 1)).astype(np.float32),
        "samples": np.stack([rng.integers(0, v, s),
                             rng.integers(0, rels, s),
                             rng.integers(0, v, s)], 1),
        "labels": (np.arange(s) < 10).astype(np.float32),
        "sample_mask": np.arange(s) < 50,
    }, sender_plan=True)


# per train step of the 2-layer model over 2R = 6 edge types: K1 forward
# (aggregations), K1 backward (sender gathers; layer 0's input carries no
# gradient with attributed inputs except through DMPNN's endpoint table,
# and R-GCN's layer-0 aggregation then needs no cotangent),
# K2 backward (the aggregations' cotangents)
BACKBONE_STEP_LAUNCHES = {
    ("CompGCN", False): (2, 2, 2), ("CompGCN", True): (2, 1, 2),
    ("RGCN", False): (12, 2, 12), ("RGIN", False): (12, 2, 12),
    ("RGCN", True): (12, 1, 6)}


@pytest.mark.parametrize("backbone, attributed", sorted(
    BACKBONE_STEP_LAUNCHES) + [("DMPNN", True)])
def test_backbone_train_step_card_matches_cpu(cuda, backbone, attributed):
    """One f32 train step of each backbone (attributed: a frozen 20-wide
    attribute table) on the card against the CPU: the loss, every updated
    parameter, and the kernel launches of the step."""
    rng = np.random.default_rng(11)
    padded = _padded_train_batch(rng)
    attrs = rng.normal(size=(64, 20)).astype(np.float32) if attributed \
        else None
    model = UNCTrainModel(64, 3, 16, num_hidden_layers=2, reg_param=0.01,
                          generator=torch.Generator().manual_seed(2),
                          backbone=backbone, node_attri=attrs)
    cpu = copy.deepcopy(model)
    card = copy.deepcopy(model).to(cuda)
    loss_cpu = make_unc_train_step(cpu, make_unc_optimizer(cpu, 1e-2, 3))(
        to_device(padded, "cpu"))
    sk.reset_launch_counts()
    loss_card = make_unc_train_step(card, make_unc_optimizer(card, 1e-2, 3))(
        to_device(padded, cuda))
    torch.cuda.synchronize()
    if backbone == "DMPNN":
        want = {"segment_sum_sorted:fwd": 2, "segment_sum_sorted:bwd": 4,
                "gather_rows_sorted:fwd": 2, "gather_rows_sorted:bwd": 2}
    else:
        k1f, k1b, k2b = BACKBONE_STEP_LAUNCHES[(backbone, attributed)]
        want = {"segment_sum_sorted:fwd": k1f, "segment_sum_sorted:bwd": k1b,
                "gather_rows_sorted:bwd": k2b}
    assert dict(sk.LAUNCHES) == want
    assert abs(loss_card.item() - loss_cpu.item()) <= 1e-5
    for (k, a), b in zip(card.state_dict().items(),
                         cpu.state_dict().values()):
        if k.endswith(("nbias", "ebias", "fc0_bias", "running_mean")):
            continue        # BN-fed biases: Adam steps on rounding noise
        torch.testing.assert_close(a.cpu(), b, rtol=1e-4, atol=1e-5, msg=k)


@pytest.mark.parametrize("multi", [False, True])
def test_supervised_step_card_matches_cpu(cuda, multi):
    """One f32 supervised step (CompGCN, node_fc) on the card against
    the CPU: the loss and every updated parameter."""
    rng = np.random.default_rng(12)
    padded = _padded_train_batch(rng)
    n_lab = 20
    mi = rng.permutation(64)[:n_lab]
    ml = (rng.random((n_lab, 4)) < 0.4).astype(np.float32) if multi \
        else rng.integers(0, 4, n_lab)
    mm = np.arange(n_lab) < 15
    model = UNCTrainModel(64, 3, 16, num_hidden_layers=2, reg_param=0.01,
                          generator=torch.Generator().manual_seed(3),
                          backbone="CompGCN", nlabel=4, multi=multi)
    losses, states = [], []
    for dev in ("cpu", cuda):
        m = copy.deepcopy(model).to(dev)
        step = make_unc_supervised_step(m, make_unc_optimizer(m, 1e-2, 3),
                                        multi)
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        losses.append(step(to_device(padded, dev), t(ml), t(mi), t(mm)))
        states.append(m.state_dict())
    assert abs(losses[1].item() - losses[0].item()) <= 1e-5
    for k, a in states[1].items():
        torch.testing.assert_close(a.cpu(), states[0][k], rtol=1e-4,
                                   atol=1e-5, msg=k)


# --- the SCM flagship through K3 -----------------------------------------

@pytest.mark.parametrize("h", [64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_scm_functions_launch_k3_at_the_flagship_shapes(cuda, dtype, h):
    """ops/scatter.py's scatter_sum_edges and gather_nodes at the
    flagship's per-graph envelope (V = 64, E = 512) for B = 16 graphs, a
    quarter of the edge slots pads holding garbage receivers: forward and
    gradients on the card against the CPU (K3's plain version), and one K3
    launch per forward sum and per gather backward."""
    from dualmessagepassing_tpu_torch.ops import scatter as ops
    rng = np.random.default_rng(15)
    b, v, e = 16, 64, 512
    recv = rng.integers(0, v, (b, e))
    mask = np.arange(e)[None, :] < rng.integers(3 * e // 4, e + 1, (b, 1))
    recv = np.where(mask, recv, rng.integers(-5, 10 ** 6, (b, e)))
    msg = rng.normal(size=(b, e, h)).astype(np.float32)
    table = rng.normal(size=(b, v, h)).astype(np.float32)
    g_nodes = rng.normal(size=(b, v, h)).astype(np.float32)
    g_rows = rng.normal(size=(b, e, h)).astype(np.float32)
    res = {}
    for dev in ("cpu", cuda):
        t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
        m = t(msg).to(dtype).requires_grad_()
        tb = t(table).to(dtype).requires_grad_()
        r, mk = t(recv), t(mask)
        sk.reset_launch_counts()
        agg = ops.scatter_sum_edges(m, r, mk, v)
        rows = ops.gather_nodes(tb, r.clamp(0, v - 1))
        torch.autograd.backward((agg, rows), (t(g_nodes).to(dtype),
                                              t(g_rows).to(dtype)))
        torch.cuda.synchronize()
        res[str(dev)] = ([x.detach().cpu().float() for x in
                          (agg, rows, m.grad, tb.grad)], dict(sk.LAUNCHES))
    (got, launches), (want, none) = res[str(cuda)], res["cpu"]
    assert launches == {"segment_sum_unsorted": 2} and none == {}
    agg_abs = ops.scatter_sum_edges(torch.from_numpy(np.abs(msg)),
                                    torch.from_numpy(recv),
                                    torch.from_numpy(mask), v)
    gt_abs = torch.zeros(b * v, h).index_add_(
        0, ops.flat_index(torch.from_numpy(recv).clamp(0, v - 1), v),
        torch.from_numpy(np.abs(g_rows)).reshape(-1, h)).reshape(b, v, h)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    for name, g, w, a in (("sum", got[0], want[0], agg_abs),
                          ("gather backward", got[3], want[3], gt_abs)):
        bound = 2.0 ** -20 * a + ulp * torch.maximum(g.abs(), w.abs())
        assert bool(((g - w).abs() <= bound).all()), name
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])


def test_scm_train_step_card_matches_cpu(cuda):
    """A small flagship-shaped DMPNN (B = 8, graph 64 V / 512 E with
    reversed edges, hid 32, 2 layers): the losses and every parameter
    gradient on the card against the CPU (f32: 1e-4 of each tensor's
    largest magnitude plus 1e-5 of the largest gradient), and K3's
    launches of one train step against models/scm_models.k3_launches."""
    from dualmessagepassing_tpu_torch.graph import (add_reversed_edges,
                                                    batch_graphs,
                                                    single_graph)
    from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
    from dualmessagepassing_tpu_torch.models.scm_models import (
        build_model, k3_launches)
    from dualmessagepassing_tpu_torch.train.losses import scm_loss
    from dualmessagepassing_tpu_torch.train.scm_driver import (
        apply_model, make_optimizer, make_train_step)
    rng = np.random.default_rng(16)
    recs = []
    for v, e in ((8, 8), (64, 256)):
        side = []
        for _ in range(8):
            r = single_graph(v, rng.integers(0, v, e), rng.integers(0, v, e),
                             rng.integers(0, 16, v), rng.integers(0, 16, e))
            side.append(add_reversed_edges(r, 16))
        recs.append(batch_graphs(side))
    cfg = ModelConfig(max_ngv=64, max_ngvl=16, max_nge=512, max_ngel=32,
                      max_npv=8, max_npvl=16, max_npe=16, max_npel=32,
                      hid_dim=32, rep_num_pattern_layers=2,
                      rep_num_graph_layers=2, pred_hid_dim=32,
                      filter_net="ScalarFilter",
                      pred_return_weights="nodeedge")
    targets = [torch.from_numpy(rng.poisson(lam, shape).astype(np.float32))
               for lam, shape in ((3.0, (8, 1)), (1.0, (8, 64)),
                                  (1.0, (8, 512)))]
    scal = dict(neg_slope=0.2, match_loss_w=0.1, match_reg_w=0.05,
                rep_reg_w=1e-3)
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, seed=2)
        batch = [recs[0].to(dev), recs[1].to(dev)] + [
            x.to(dev) for x in targets]
        losses = scm_loss(apply_model(model, *batch[:2], train=True),
                          *batch[2:], **scal)
        losses["total"].backward()
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        step = make_train_step(model, make_optimizer(model.parameters(),
                                                     1e-3),
                               return_weights="nodeedge")
        sk.reset_launch_counts()
        stepped = step(*batch, *scal.values())
        torch.cuda.synchronize()
        out[str(dev)] = (losses["total"].item(), stepped["total"].item(),
                         grads, dict(sk.LAUNCHES))
    (lc, sc_, gc, kc), (lg, sg, gg, kg) = out["cpu"], out[str(cuda)]
    assert kc == {} and kg == {"segment_sum_unsorted":
                               k3_launches(cfg, train=True)}
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(sg - sc_) <= 1e-5 * abs(sc_)
    gmax = max(g.abs().max().item() for g in gc.values())
    for k in gc:
        bound = 1e-4 * gc[k].abs().max().item() + 1e-5 * gmax
        assert (gg[k] - gc[k]).abs().max().item() <= bound, k


# --- the SCM graph networks through K3 ------------------------------------

def graph_network_k3_calls(rng, b):
    """K3's two new call shapes at the flagship envelope (V = 64, E = 512
    with reversed edges, R = 32 edge labels): the R-GCN/R-GIN relation
    fold, E rows into B*V*R rows at (b*V + receiver)*R + label, a quarter
    of the slots pads; the LRP pool, B*P perm rows into B*V rows (P =
    4,096 perms a graph, their owners drawn by out-degree)."""
    from dualmessagepassing_tpu_torch.ops import scatter as ops
    v, e, r, p = 64, 512, 32, 4096
    recv = torch.from_numpy(rng.integers(0, v, (b, e)))
    label = torch.from_numpy(rng.integers(0, r + 4, (b, e)))
    mask = torch.from_numpy(np.arange(e)[None, :] < rng.integers(
        3 * e // 4, e + 1, (b, 1)))
    ok = mask & (label < r)
    fold = ops.flat_index(recv * r + label, v * r, ok)
    owner = torch.from_numpy(np.sort(rng.integers(0, v, (b, p)), 1))
    pmask = torch.from_numpy(np.arange(p)[None, :] < rng.integers(
        p // 2, p + 1, (b, 1)))
    pool = ops.flat_index(owner, v, pmask)
    return {"fold": (fold, b * v * r), "pool": (pool, b * v)}


@pytest.mark.parametrize("call", ["fold", "pool"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k3_at_the_graph_networks_shapes(cuda, dtype, call):
    """K3 against its plain version at bsz 128 (the relation fold: 65,536
    rows into 262,144; the LRP pool: 524,288 rows into 8,192), H = 64,
    within 2**-20 of each row's absolute sum."""
    rng = np.random.default_rng(17)
    idx, rows = graph_network_k3_calls(rng, 128)[call]
    msg = torch.from_numpy(rng.normal(size=(idx.numel(), 64)).astype(
        np.float32)).to(cuda, dtype)
    idx = idx.to(cuda)
    sk.reset_launch_counts()
    with torch.inference_mode():
        got = sc.segment_sum_unsorted(msg, idx, rows)
        want = sc.segment_sum_unsorted_plain(msg, idx, rows)
        abs_sum = sc.segment_sum_unsorted_plain(msg.float().abs(), idx, rows)
    torch.cuda.synchronize()
    assert dict(sk.LAUNCHES) == {"segment_sum_unsorted": 1}
    assert within_abs_sum(got, want, abs_sum)


@pytest.mark.parametrize("net", ["CompGCN", "RGCN", "RGIN", "LRP", "DMPLRP"])
def test_graph_network_train_step_card_matches_cpu(cuda, net):
    """Each SCM graph network at the flagship's width on a small batch (B
    = 4, graph 64 V / 256 E with reversed edges, 3 + 3 layers): the loss
    and every parameter gradient on the card against the CPU (f32: 1e-4
    of each tensor's largest magnitude plus 1e-5 of the largest
    gradient), K3's launches of the forward and backward against
    models/scm_models.k3_launches."""
    from dualmessagepassing_tpu_torch.data.dataset import lrp_batch
    from dualmessagepassing_tpu_torch.data.lrp import (count_perms,
                                                       record_to_lrp_perms)
    from dualmessagepassing_tpu_torch.graph import (add_reversed_edges,
                                                    batch_graphs,
                                                    single_graph)
    from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
    from dualmessagepassing_tpu_torch.models.scm_models import (
        build_model, k3_launches)
    from dualmessagepassing_tpu_torch.train.losses import scm_loss
    from dualmessagepassing_tpu_torch.train.scm_driver import apply_model
    rng = np.random.default_rng(18)
    sides = []
    for v, e in ((8, 8), (64, 256)):
        recs = [add_reversed_edges(single_graph(
            v, rng.integers(0, v, e), rng.integers(0, v, e),
            rng.integers(0, 16, v), rng.integers(0, 16, e)), 16)
            for _ in range(4)]
        gb = batch_graphs(recs)
        if net in ("LRP", "DMPLRP"):
            p_max = max(count_perms(r) for r in recs)
            gb = lrp_batch(gb, [{k: a for k, a in record_to_lrp_perms(
                r, 4, p_max).items() if k != "n_perm"} for r in recs])
        sides.append(gb)
    cfg = ModelConfig(max_ngv=64, max_ngvl=16, max_nge=512, max_ngel=32,
                      max_npv=8, max_npvl=16, max_npe=16, max_npel=32,
                      rep_net=net, filter_net="ScalarFilter",
                      pred_return_weights="nodeedge")
    targets = [torch.from_numpy(rng.poisson(lam, shape).astype(np.float32))
               for lam, shape in ((3.0, (4, 1)), (1.0, (4, 64)),
                                  (1.0, (4, 512)))]
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, seed=2)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(3)
            for p in model.parameters():
                p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(dev))
        batch = [s.to(dev) for s in sides] + [x.to(dev) for x in targets]
        sk.reset_launch_counts()
        losses = scm_loss(apply_model(model, *batch[:2], train=True),
                          *batch[2:], neg_slope=0.2, match_loss_w=0.1,
                          match_reg_w=0.05, rep_reg_w=1e-3)
        losses["total"].backward()
        torch.cuda.synchronize()
        out[str(dev)] = (losses["total"].item(), {
            k: p.grad.cpu() for k, p in model.named_parameters()},
            dict(sk.LAUNCHES))
    (lc, gc, kc), (lg, gg, kg) = out["cpu"], out[str(cuda)]
    assert kc == {} and kg == {"segment_sum_unsorted":
                               k3_launches(cfg, train=True)}
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    gmax = max(g.abs().max().item() for g in gc.values())
    for k in gc:
        bound = 1e-4 * gc[k].abs().max().item() + 1e-5 * gmax
        assert (gg[k] - gc[k]).abs().max().item() <= bound, k


# --- the SCM sequence networks ---------------------------------------------

@pytest.mark.parametrize("net, kw", [
    ("CNN", {}), ("RNN", {}),
    ("RNN", dict(rep_rnn_type="GRU", rep_rnn_bidirectional=True)),
    ("TXL", {})], ids=["CNN", "LSTM", "GRU-bi", "TXL"])
def test_sequence_network_train_step_card_matches_cpu(cuda, monkeypatch, net,
                                                     kw):
    """Each SCM sequence network at the flagship's width with
    pred_with_deg on a small batch (B = 4, graph 64 V / 256 E with
    reversed edges: 512 tuples, 3 + 3 layers; cuDNN's conv and RNN with
    TF32 off): the loss and every parameter gradient on the card against
    the CPU (f32: 1e-4 of each tensor's largest magnitude plus 1e-5 of
    the largest gradient), K3's launches (the 4 degree tables) against
    models/scm_models.k3_launches, and a make_train_step whose edge
    targets it refines to the predictions' length."""
    from dualmessagepassing_tpu_torch.graph import (add_reversed_edges,
                                                    batch_edgeseqs,
                                                    record_to_edgeseq,
                                                    single_graph)
    from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
    from dualmessagepassing_tpu_torch.models.scm_models import (
        build_model, k3_launches)
    from dualmessagepassing_tpu_torch.train.losses import scm_loss
    from dualmessagepassing_tpu_torch.train.scm_driver import (
        apply_model, make_optimizer, make_train_step, refine_weights)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    rng = np.random.default_rng(19)
    sides = []
    for v, e in ((8, 8), (64, 256)):
        sides.append(batch_edgeseqs([record_to_edgeseq(add_reversed_edges(
            single_graph(v, rng.integers(0, v, e), rng.integers(0, v, e),
                         rng.integers(0, 16, v), rng.integers(0, 16, e)),
            16)) for _ in range(4)]))
    cfg = ModelConfig(max_ngv=64, max_ngvl=16, max_nge=512, max_ngel=32,
                      max_npv=8, max_npvl=16, max_npe=16, max_npel=32,
                      rep_net=net, filter_net="ScalarFilter",
                      pred_with_deg=True, pred_return_weights="edge", **kw)
    targets = [torch.from_numpy(rng.poisson(lam, shape).astype(np.float32))
               for lam, shape in ((3.0, (4, 1)), (1.0, (4, 512)))]
    scal = dict(neg_slope=0.2, match_loss_w=0.1, match_reg_w=0.05,
                rep_reg_w=1e-3)
    out = {}
    for dev in ("cpu", cuda):
        model = build_model(cfg, device=dev, seed=2)
        with torch.no_grad():
            gen = torch.Generator().manual_seed(3)
            for p in model.parameters():
                p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(dev))
        batch = [s.to(dev) for s in sides] + [x.to(dev) for x in targets]
        sk.reset_launch_counts()
        losses = scm_loss(apply_model(model, *batch[:2], train=True),
                          batch[2], None,
                          refine_weights(model, "edge", batch[3]), **scal)
        losses["total"].backward()
        torch.cuda.synchronize()
        launches = dict(sk.LAUNCHES)
        grads = {k: p.grad.cpu() for k, p in model.named_parameters()}
        step = make_train_step(model, make_optimizer(model.parameters(),
                                                     1e-3),
                               return_weights="edge")
        stepped = step(*batch[:3], None, batch[3], *scal.values())
        out[str(dev)] = (losses["total"].item(), stepped["total"].item(),
                         grads, launches)
    (lc, sc_, gc, kc), (lg, sg, gg, kg) = out["cpu"], out[str(cuda)]
    assert kc == {} and kg == {"segment_sum_unsorted":
                               k3_launches(cfg, train=True)} == {
                                   "segment_sum_unsorted": 4}
    assert abs(lg - lc) <= 1e-5 * abs(lc) and abs(sg - sc_) <= 1e-5 * abs(sc_)
    gmax = max(g.abs().max().item() for g in gc.values())
    for k in gc:
        bound = 1e-4 * gc[k].abs().max().item() + 1e-5 * gmax
        assert (gg[k] - gc[k]).abs().max().item() <= bound, k


@pytest.mark.parametrize("rnn_type", ["LSTM", "GRU", "RNN"])
@pytest.mark.parametrize("bidirectional", [False, True])
def test_rnn_layer_weights_reach_cudnn_in_its_layout(cuda, monkeypatch,
                                                     rnn_type, bidirectional):
    """models/edgeseq.RNNLayer's weight buffer is cuDNN's layout: cuDNN
    takes it without compacting it (no warning), and the layer's output
    and input gradient on the card equal the CPU's (f32, TF32 off: 1e-4
    of each tensor's largest magnitude)."""
    import warnings
    from dualmessagepassing_tpu_torch.models.edgeseq import RNNLayer
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    layer = RNNLayer(32, 32, rnn_type, bidirectional,
                     generator=torch.Generator().manual_seed(5))
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(4, 24, 32)).astype(np.float32))
    out = {}
    for dev in ("cpu", cuda):
        xd = x.to(dev, copy=True).requires_grad_()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            y = layer.to(dev)(xd)
            (y * y).sum().backward()
        assert not [w for w in caught if "contiguous chunk" in str(w.message)]
        out[str(dev)] = (y.detach().cpu(), xd.grad.cpu())
    for got, want in zip(out[str(cuda)], out["cpu"]):
        assert (got - want).abs().max() <= 1e-4 * want.abs().max()


# --- the attention predict nets and the remat repair -----------------------

def _flagship_pairs(rng, rep_net):
    """B = 4 flagship pairs (pattern 8 V / 8 E, graph 64 V / 256 E, 16
    labels, reversed edges) as GraphBatches or (CNN, RNN) EdgeSeqBatches,
    and their targets (counts, node weights, edge weights)."""
    from dualmessagepassing_tpu_torch.graph import (add_reversed_edges,
                                                    batch_edgeseqs,
                                                    batch_graphs,
                                                    record_to_edgeseq,
                                                    single_graph)
    sides = []
    for v, e in ((8, 8), (64, 256)):
        recs = [add_reversed_edges(single_graph(
            v, rng.integers(0, v, e), rng.integers(0, v, e),
            rng.integers(0, 16, v), rng.integers(0, 16, e)), 16)
            for _ in range(4)]
        sides.append(batch_edgeseqs([record_to_edgeseq(r) for r in recs])
                     if rep_net in ("CNN", "RNN") else batch_graphs(recs))
    targets = [torch.from_numpy(rng.poisson(lam, shape).astype(np.float32))
               for lam, shape in ((3.0, (4, 1)), (1.0, (4, 64)),
                                  (1.0, (4, 512)))]
    return sides, targets


def _flagship_config(**kw):
    from dualmessagepassing_tpu_torch.models.basemodel import ModelConfig
    return ModelConfig(max_ngv=64, max_ngvl=16, max_nge=512, max_ngel=32,
                       max_npv=8, max_npvl=16, max_npe=16, max_npel=32,
                       filter_net="ScalarFilter",
                       pred_return_weights="nodeedge", **kw)


def _loss_and_grads(cfg, dev, sides, targets, seed=2, generator=None):
    """One train-mode forward (dropout from `generator`) and backward of
    the flagship model from `seed` (its weights moved by N(0, 0.02)):
    (loss, gradients on the CPU, running statistics, K3's launches)."""
    from dualmessagepassing_tpu_torch.models.scm_models import build_model
    from dualmessagepassing_tpu_torch.train.losses import scm_loss
    from dualmessagepassing_tpu_torch.train.scm_driver import (
        apply_model, refine_weights)
    model = build_model(cfg, device=dev, seed=seed)
    with torch.no_grad():
        gen = torch.Generator().manual_seed(seed + 1)
        for p in model.parameters():
            p.add_((0.02 * torch.randn(p.shape, generator=gen)).to(dev))
    batch = [s.to(dev) for s in sides] + [x.to(dev) for x in targets]
    sk.reset_launch_counts()
    losses = scm_loss(apply_model(model, *batch[:2], train=True,
                                  generator=generator),
                      batch[2], batch[3],
                      refine_weights(model, "edge", batch[4]),
                      neg_slope=0.2, match_loss_w=0.1, match_reg_w=0.05,
                      rep_reg_w=1e-3)
    losses["total"].backward()
    torch.cuda.synchronize()
    return (losses["total"].item(),
            {k: p.grad.cpu() for k, p in model.named_parameters()
             if p.grad is not None},
            {k: b.cpu() for k, b in model.named_buffers() if "running" in k},
            dict(sk.LAUNCHES))


def _grads_close(got, want):
    gmax = max(g.abs().max().item() for g in want.values())
    assert set(got) == set(want)
    for k in want:
        bound = 1e-4 * want[k].abs().max().item() + 1e-5 * gmax
        assert (got[k] - want[k]).abs().max().item() <= bound, k


@pytest.mark.parametrize("pred_net, rep_net", [
    ("MeanAttnPredictNet", "DMPNN"), ("SumAttnPredictNet", "DMPNN"),
    ("MaxAttnPredictNet", "DMPNN"), ("MeanAttnPredictNet", "CNN")])
def test_attention_predict_net_train_step_card_matches_cpu(
        cuda, monkeypatch, pred_net, rep_net):
    """An attention predict net at the flagship's width (4 heads,
    sparsemax, one inference round) over DMPNN or CNN on a small batch:
    the loss (1e-5 relative) and every parameter gradient (1e-4 of each
    tensor's largest magnitude plus 1e-5 of the largest gradient) on the
    card against the CPU; K3's launches those of the rep net alone
    (models/scm_models.k3_launches)."""
    from dualmessagepassing_tpu_torch.models.scm_models import k3_launches
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    sides, targets = _flagship_pairs(np.random.default_rng(20), rep_net)
    cfg = _flagship_config(rep_net=rep_net, pred_net=pred_net,
                           pred_num_heads=4)
    lc, gc, _, kc = _loss_and_grads(cfg, "cpu", sides, targets)
    lg, gg, _, kg = _loss_and_grads(cfg, cuda, sides, targets)
    want = k3_launches(cfg, train=True)
    assert kc == {} and kg == ({"segment_sum_unsorted": want} if want
                               else {})
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    _grads_close(gg, gc)


@pytest.mark.parametrize("pred_net, rep_net, mem_init", [
    ("MeanMemAttnPredictNet", "DMPNN", "mean"),
    ("SumMemAttnPredictNet", "DMPNN", "circular_lstm"),
    ("MaxMemAttnPredictNet", "DMPNN", "attn"),
    ("DIAMNet", "DMPNN", "circular_mean"),
    ("DIAMNet", "CNN", "lstm")])
def test_memory_predict_net_train_step_card_matches_cpu(
        cuda, monkeypatch, pred_net, rep_net, mem_init):
    """A memory predict net at the flagship's width (mem_len 4, 4 heads,
    sparsemax, one inference round) over DMPNN or CNN on a small batch,
    with an lstm and an attn init among them: the loss and every
    parameter gradient on the card against the CPU (the bounds of
    test_attention_predict_net_train_step_card_matches_cpu); K3's
    launches those of the rep net alone."""
    from dualmessagepassing_tpu_torch.models.scm_models import k3_launches
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    sides, targets = _flagship_pairs(np.random.default_rng(22), rep_net)
    cfg = _flagship_config(rep_net=rep_net, pred_net=pred_net,
                           pred_num_heads=4, pred_mem_len=4,
                           pred_mem_init=mem_init)
    lc, gc, _, kc = _loss_and_grads(cfg, "cpu", sides, targets)
    lg, gg, _, kg = _loss_and_grads(cfg, cuda, sides, targets)
    want = k3_launches(cfg, train=True)
    assert kc == {} and kg == ({"segment_sum_unsorted": want} if want
                               else {})
    assert abs(lg - lc) <= 1e-5 * abs(lc)
    _grads_close(gg, gc)


@pytest.mark.parametrize("rep_net, kw", [
    ("DMPNN", dict(rep_dmpnn_batch_norm=True)),
    ("CompGCN", dict(rep_compgcn_batch_norm=True)),
    ("CNN", {}), ("RNN", {})])
def test_remat_with_dropout_on_the_card(cuda, monkeypatch, rep_net, kw):
    """rep_remat with dropout 0.1 (a CUDA generator) and the family's
    BatchNorm on the card, against the run without remat from the same
    weights and generator seed: the generator's state after the step is
    equal, the loss within 1e-5 relative, the gradients as above and the
    running statistics within 1e-5 of each tensor's largest magnitude (K3
    sums with float atomics, in another order at each launch)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    sides, targets = _flagship_pairs(np.random.default_rng(21), rep_net)
    runs = []
    for remat in (False, True):
        cfg = _flagship_config(rep_net=rep_net, rep_remat=remat,
                               rep_dropout=0.1, **kw)
        gen = torch.Generator(device=cuda).manual_seed(5)
        start = gen.get_state()
        runs.append(_loss_and_grads(cfg, cuda, sides, targets,
                                    generator=gen) + (gen.get_state(),))
        assert not torch.equal(start, gen.get_state())
    (l0, g0, s0, _, r0), (l1, g1, s1, _, r1) = runs
    assert torch.equal(r0, r1)
    assert abs(l1 - l0) <= 1e-5 * abs(l0)
    _grads_close(g1, g0)
    assert set(s0) == set(s1) and (len(s0) > 0) == (rep_net != "RNN")
    for k in s0:
        assert (s1[k] - s0[k]).abs().max() <= 1e-5 * s0[k].abs().max(), k
