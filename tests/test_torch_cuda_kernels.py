"""The port's CUDA kernels on the card (they have no CPU mode).

Each test takes the `cuda` fixture, which skips it where
torch.cuda.is_available() is false — as on a CPU-only machine. On a
machine with the card and without jax (tests/conftest.py imports jax):

    python -m pytest --noconftest -q tests/test_torch_cuda_kernels.py

Tolerances as stated in chip_smoke.py: K1 within 2**-20 of each row's
absolute sum (plus one bf16 ulp in bf16); K2 bitwise.
"""

import numpy as np
import pytest
import torch

from dualmessagepassing_tpu_torch.ops import segment_kernel as sk
from dualmessagepassing_tpu_torch.unc.driver import to_device
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


@pytest.mark.parametrize("width", [1, 50, 101, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_bitwise(cuda, dtype, width):
    _, _, recv_padded, n_real = stream(1)
    rng = np.random.default_rng(2)
    table = torch.from_numpy(rng.normal(size=(500, width)).astype(
        np.float32)).to(cuda, dtype)
    idx = torch.from_numpy(recv_padded).to(cuda)
    with torch.inference_mode():
        got = sk.gather_rows_sorted(table, idx, n_real)
        want = sk.gather_rows_sorted_plain(table, idx, n_real)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert (got[n_real:] == 0).all()


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
    assert dict(sk.LAUNCHES) == {"segment_sum_sorted": 1,
                                 "gather_rows_sorted": 1}


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
