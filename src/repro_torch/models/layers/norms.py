"""RMSNorm (f32 statistics, cast back to the input dtype).

``apply`` is the JAX package's ``norms.apply``; it goes through
``ops.rmsnorm``, which computes exactly that (the Triton kernel on the card,
the plain version on the CPU)."""
from __future__ import annotations

import torch

from repro_torch.kernels import ops


def apply(params: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    return ops.rmsnorm(x.contiguous(), params["scale"], eps)
