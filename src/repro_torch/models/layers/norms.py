"""RMSNorm (f32 statistics, cast back to the input dtype).

``apply`` is the JAX package's ``norms.apply``. Its forward goes through
``ops.rmsnorm`` and its backward through ``ops.rmsnorm_bwd`` (the Triton
kernels on the card, the plain versions on the CPU), joined by a
``torch.autograd.Function``; the JAX package lets XLA differentiate it."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


class _RMSNorm(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return ops.rmsnorm(x, scale, eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = ops.rmsnorm_bwd(dy.contiguous(), x, scale, ctx.eps)
        return dx, dscale, None


def apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return _RMSNorm.apply(x.contiguous(), params["scale"], eps)
