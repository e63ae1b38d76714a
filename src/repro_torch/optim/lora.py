"""LoRA baseline (paper §4.2; port of the JAX package's ``optim/lora.py``):
rank-r adapters on the Q, K, V, O, G, U, D projections, trained with
standard AdamW while the base weights stay frozen.

Adapters are kept in a FLAT dict keyed by the canonical "/"-joined leaf
path (the reference's keys, which its checkpoint files hold too),
mirroring the stacked-params layout: a target leaf of shape
[L, in..., out...] gets a: [L, fan_in, r] and b: [L, r, fan_out] (leading
L only for stacked groups), merged on the forward as
    w_eff = w + (alpha / r) * reshape(a @ b).

The merge's products are plain large matrix products (``torch.einsum``);
the reference computes them in XLA too, outside any Pallas kernel.
"""
from __future__ import annotations

import math
import zlib

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.partition import leaves, leaves_with_path, \
    tree_map_with_path
from repro_torch.models import lm

# leaf basenames LoRA targets (paper: Q, K, V, O, U, D, G projections)
TARGETS = ("wq", "wk", "wv", "wo", "wg", "wu", "wd")
# leaves whose fan-in spans all axes but the last (o-proj style)
_SPLIT_LAST = ("wo",)


def _is_target(path: str) -> bool:
    return path.split("/")[-1] in TARGETS


def _is_stacked(path: str) -> bool:
    return path.split("/")[0].endswith("layers")


def _fan_split(path: str, shape: tuple, stacked: bool):
    core = shape[1:] if stacked else shape
    base = path.split("/")[-1]
    if base in _SPLIT_LAST:
        return int(math.prod(core[:-1])), int(core[-1])
    return int(core[0]), int(math.prod(core[1:]))


def adapter_layout(cfg: ModelConfig, rank: int) -> dict:
    """{leaf path: (shape of a, shape of b, fan_in)} for every leaf LoRA
    targets, from the config's leaf shapes (``lm.param_shapes``), in the
    sorted key order of ``leaves``."""
    out = {}
    for path, shape in leaves_with_path(lm.param_shapes(cfg)):
        if not _is_target(path) or len(shape) < 2:
            continue
        stacked = _is_stacked(path)
        fan_in, fan_out = _fan_split(path, tuple(shape), stacked)
        lead = (shape[0],) if stacked else ()
        out[path] = ((*lead, fan_in, rank), (*lead, rank, fan_out), fan_in)
    return out


def init_lora(generator: torch.Generator, params: dict, cfg: ModelConfig,
              rank: int) -> dict:
    """-> flat dict {leaf_path: {"a": ..., "b": ...}} for targeted leaves,
    on the generator's device: a = N(0, 1) * fan_in^-0.5 in the leaf's
    dtype, b = 0. Only the generator's device and initial seed are used;
    nothing is drawn from it, so a generator that has drawn gives the same
    adapters as a fresh one of its seed. Each leaf draws from its own
    stream, seeded from that seed and the path's crc32 (not hash(): string
    hashing is salted per process) in 32 bits, all that the CPU's generator
    keeps of a seed."""
    dev = generator.device
    seed = generator.initial_seed()
    flat = dict(leaves_with_path(params))
    out = {}
    for path, (shape_a, shape_b, fan_in) in adapter_layout(cfg, rank).items():
        dtype = flat[path].dtype
        g = torch.Generator(device=dev).manual_seed(
            (seed * 0x9E3779B1 + zlib.crc32(path.encode())) % 2**32)
        a = torch.randn(shape_a, generator=g, device=dev) * fan_in**-0.5
        out[path] = {"a": a.to(dtype),
                     "b": torch.zeros(shape_b, dtype=dtype, device=dev)}
    return out


def merge(params: dict, lora_params: dict, cfg: ModelConfig,
          rank: int, alpha: float) -> dict:
    """w_eff = w + scale * a@b for targeted leaves; others pass through.
    Differentiable with respect to ``lora_params`` only (the base is
    detached, the reference's stop_gradient)."""
    scale = alpha / rank

    def one(path, w):
        w = w.detach()
        ab = lora_params.get(path)
        if ab is None:
            return w
        a, b = ab["a"], ab["b"]
        if a.ndim == 3:  # stacked
            delta = torch.einsum("lir,lro->lio", a, b).reshape(w.shape)
        else:
            delta = (a @ b).reshape(w.shape)
        return w + (scale * delta).to(w.dtype)

    return tree_map_with_path(one, params)


def num_lora_params(lora_params) -> int:
    return sum(x.numel() for x in leaves(lora_params))
