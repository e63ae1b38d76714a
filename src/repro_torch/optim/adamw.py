"""Unmasked AdamW (port of the JAX package's ``optim/adamw.py``): the
optimizer the LoRA baseline steps its adapters with. The reference computes
it in XLA, outside any Pallas kernel; the port in plain PyTorch, one
leaf at a time, in f32 with the reference's order of operations.

The step is IN PLACE on the parameters and moments (the reference returns
new arrays); the count is a 0-d f32 tensor on the parameters' device, so
the step makes no host sync.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.partition import leaves, tree_map


def init_opt_state(params) -> dict:
    """f32 zero moments congruent with ``params`` and a 0-d f32 count."""
    def z(tree):
        return tree_map(lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                              device=x.device), tree)
    dev = leaves(params)[0].device
    return {"m": z(params), "v": z(params),
            "count": torch.zeros((), dtype=torch.float32, device=dev)}


@torch.no_grad()
def update(cfg: OptimizerConfig, params, grads, opt_state: dict, lr):
    """One AdamW step with bias correction from the shared count; ``lr`` is
    the scheduled rate (a Python float). Returns (params, opt_state): the
    same parameter and moment tensors, and the advanced count."""
    c = opt_state["count"] + 1.0
    bc1 = 1 - cfg.b1 ** c
    bc2 = 1 - cfg.b2 ** c

    def upd(p, g, m, v):
        gf = g.float()
        m2 = cfg.b1 * m + (1 - cfg.b1) * gf
        v2 = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mhat = m2 / bc1
        vhat = v2 / bc2
        pf = p.float()
        p2 = pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                        + cfg.weight_decay * pf)
        p.copy_(p2)    # rounds to the leaf's dtype, as astype does
        m.copy_(m2)
        v.copy_(v2)
        return p

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    return params, {"m": opt_state["m"], "v": opt_state["v"], "count": c}
