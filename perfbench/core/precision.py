"""The precision a plain reference computes in: float32 with TF32 off,
as the configurations state, or, for the control, TF32 inputs to every
matmul (the step a later change could be tempted to take). On the card
the control sets the backend's TF32 flag; on the CPU, which has no
TF32, it rounds each matmul's inputs to TF32's 10-bit mantissa, which
is what the tensor cores do with them."""

from __future__ import annotations

import contextlib

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to TF32 (10-bit mantissa, nearest even), in float32."""
    i = x.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & ~0x1FFF
    return i.view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """a @ b with TF32 inputs, forward and backward, float32 sums."""

    @staticmethod
    def forward(ctx, a, b):
        ra, rb = round_tf32(a), round_tf32(b)
        ctx.save_for_backward(ra, rb)
        return ra @ rb

    @staticmethod
    def backward(ctx, g):
        ra, rb = ctx.saved_tensors
        rg = round_tf32(g)
        grad_b = ra.transpose(-1, -2) @ rg
        if grad_b.dim() > rb.dim():        # b broadcast over a's batch
            grad_b = grad_b.reshape(-1, *rb.shape).sum(0)
        return rg @ rb.transpose(-1, -2), grad_b


class Matmul:
    """a @ b in float32, or with TF32 inputs for the control."""

    def __init__(self, precision: str, device: torch.device):
        if precision not in ("float32", "tf32"):
            raise ValueError(precision)
        self.emulate = precision == "tf32" and device.type != "cuda"
        self.flag = precision == "tf32" and device.type == "cuda"

    def __call__(self, a, b):
        if self.emulate:
            return _TF32Matmul.apply(a, b)
        return a @ b

    @contextlib.contextmanager
    def mode(self):
        old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = self.flag
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = old
