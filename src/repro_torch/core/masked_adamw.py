"""Block-masked AdamW, dense residency — the paper's "custom AdamW" (Alg. 1
lines 9-13); port of the dense half of the JAX package's
``core/masked_adamw.py``. The banked residency is ROADMAP Queue A item 6.

Selected blocks take a standard AdamW step (moments + weight decay);
unselected blocks keep parameters AND moments bit-identical. Bias
correction uses per-block step counts. Moments are f32 whatever the
parameter dtype.

The update is IN PLACE on the parameters and moments (the reference returns
new arrays): the stacked leaves go through ``ops.masked_adamw`` (the kernel
on the card), the unstacked ones (embedding, final norm, untied head)
through ``_adamw_rows`` in plain torch, as the reference computes them in
XLA outside its kernel.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import OptimizerConfig
from repro_torch.core.partition import (BlockPartition, leaf_masks, leaves,
                                        tree_map)
from repro_torch.kernels import ops


def init_opt_state(partition: BlockPartition, params: dict) -> dict:
    """Zero f32 moments congruent with ``params`` and zero per-block
    counts, on the device of the parameters."""
    dev = leaves(params)[0].device
    return {
        "m": tree_map(lambda x: torch.zeros(x.shape, device=dev), params),
        "v": tree_map(lambda x: torch.zeros(x.shape, device=dev), params),
        "counts": torch.zeros(partition.num_blocks, device=dev),
    }


def global_grad_norm(grads) -> torch.Tensor:
    sq = None
    for g in leaves(grads):
        t = g.float().square().sum()
        sq = t if sq is None else sq + t
    return torch.sqrt(sq)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled by min(1, max_norm / (norm + 1e-9)) in f32 and cast
    back, the global norm)."""
    norm = global_grad_norm(grads)
    scale = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def _adamw_rows(cfg: OptimizerConfig, p, g, m, v, sel, cnt, lr):
    """The masked-AdamW formula on one unstacked leaf, in plain torch (0-d
    ``sel`` and ``cnt``); writes p, m and v in place."""
    gf = g.float()
    m2 = torch.where(sel > 0, cfg.b1 * m + (1 - cfg.b1) * gf, m)
    v2 = torch.where(sel > 0, cfg.b2 * v + (1 - cfg.b2) * gf * gf, v)
    c = torch.clamp(cnt, min=1.0)
    mhat = m2 / (1 - cfg.b1 ** c)
    vhat = v2 / (1 - cfg.b2 ** c)
    pf = p.float()
    step = lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                 + cfg.weight_decay * pf)
    p.copy_(torch.where(sel > 0, pf - step, pf))
    m.copy_(m2)
    v.copy_(v2)


@torch.no_grad()
def update(cfg: OptimizerConfig, partition: BlockPartition, params: dict,
           grads: dict, opt_state: dict, mask: torch.Tensor, lr: float):
    """One masked step, in place. mask: [num_blocks]; lr: the scheduled
    rate (a Python float). Returns (params, opt_state), the same tensors."""
    counts = opt_state["counts"]
    counts += mask.float()
    masks = leaf_masks(partition, params, mask)
    counts_b = leaf_masks(partition, params, counts)

    def upd(p, g, m, v, sel, cnt):
        if sel.ndim == 1:   # a stacked leaf: one mask entry per row
            ops.masked_adamw(p, g, m, v, sel, cnt, lr, cfg.b1, cfg.b2,
                             cfg.eps, cfg.weight_decay)
        else:
            _adamw_rows(cfg, p, g, m, v, sel, cnt, lr)
        return p

    tree_map(upd, params, grads, opt_state["m"], opt_state["v"], masks,
             counts_b)
    return params, opt_state
