"""Learning-rate schedules: pure functions of the step (a Python int).

The arithmetic is f32 (numpy scalars), as the JAX package's jnp version is,
and runs on the host, so reading the rate never waits for the card."""
from __future__ import annotations

import numpy as np

from repro_torch.configs.base import OptimizerConfig

_F = np.float32


def learning_rate(cfg: OptimizerConfig, step: int) -> float:
    t = _F(step)
    warm = np.minimum(_F(1.0), (t + _F(1)) / _F(max(1, cfg.warmup_steps)))
    if cfg.schedule == "constant":
        factor = _F(1.0)
    elif cfg.schedule in ("linear", "cosine"):
        frac = np.clip((t - _F(cfg.warmup_steps))
                       / _F(max(1, cfg.total_steps - cfg.warmup_steps)),
                       _F(0), _F(1))
        factor = (_F(1.0) - frac if cfg.schedule == "linear"
                  else _F(0.5) * (_F(1) + np.cos(_F(np.pi) * frac)))
    else:
        raise ValueError(cfg.schedule)
    return float(_F(cfg.lr) * warm * factor)
