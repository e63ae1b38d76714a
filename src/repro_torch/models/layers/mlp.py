"""Gated (SwiGLU/GeGLU) feed-forward layer — the U/G/D projections."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig

# jax.nn.gelu defaults to the tanh approximation
_ACTS = {"silu": F.silu, "gelu": lambda x: F.gelu(x, approximate="tanh")}


def apply(params: dict, cfg: ModelConfig, x: torch.Tensor) -> torch.Tensor:
    h = _ACTS[cfg.act](x @ params["wg"]) * (x @ params["wu"])
    return h @ params["wd"]
