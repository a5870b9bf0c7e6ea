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


@pytest.mark.parametrize("width", [1, 50, 101, 128, 200])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k1_matches_plain(cuda, dtype, width):
    msg, row_ptr, _, _ = stream(0, width=width)
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
    assert (got[250:] == 0).all()


def bits(t):
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


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
            tol = 2.0 ** -7 * want.abs() + 1e-5 if dtype == torch.bfloat16 \
                else 1e-5 * want.abs() + 1e-5
            assert bool(((got - want).abs() <= tol).all()), name


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
