"""Architecture registry of the port: ``--arch <id>`` resolution.

The paper's three models and the JAX package's other three dense archs
are registered; its other families raise with the ROADMAP item that
ports them."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

# arch id -> module name
_ARCH_MODULES = {
    "qwen2.5-0.5b": "qwen2_5_0_5b",
    "llama3.2-1b": "llama3_2_1b",
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    # the reference's other dense archs
    "chatglm3-6b": "chatglm3_6b",
    "yi-9b": "yi_9b",
    "qwen2.5-32b": "qwen2_5_32b",
}


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r} for the PyTorch port; ported: "
            f"{sorted(_ARCH_MODULES)}. Other archs follow ROADMAP Queue A "
            f"item 12 (other families)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
