"""RMSNorm (f32 statistics, cast back to the input dtype).

``apply`` is the JAX package's ``norms.apply``. Its forward goes through
``ops.rmsnorm`` and its backward through ``ops.rmsnorm_bwd`` (on the card
the CUDA C++ forward and the Triton backward, on the CPU the plain
versions), joined by a ``torch.autograd.Function`` when a gradient is
wanted; the JAX package lets XLA differentiate it. The backward asks for dx only when the scale
needs no gradient."""
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
        # a frozen layer's scale is detached (core/gated.py): dx only, with
        # no column sums
        with_dscale = ctx.needs_input_grad[1]
        dx, dscale = ops.rmsnorm_bwd(dy.contiguous(), x, scale, ctx.eps,
                                     with_dscale=with_dscale)
        return dx, dscale, None


def apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    x, scale = x.contiguous(), params["scale"]
    if torch.is_grad_enabled() and (x.requires_grad or scale.requires_grad):
        return _RMSNorm.apply(x, scale, eps)
    # nothing to differentiate (decode, eval): no autograd node, whose
    # Python costs a host-bound decode step more than the launch
    return ops.rmsnorm(x, scale, eps)
