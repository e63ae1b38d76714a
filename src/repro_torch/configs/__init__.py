"""Architecture registry of the port: ``--arch <id>`` resolution.

Only the archs this slice serves are registered; the others raise with the
ROADMAP item that ports them."""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig  # noqa: F401

# arch id -> module name
_ARCH_MODULES = {
    "qwen2.5-0.5b": "qwen2_5_0_5b",
}


def _module(arch: str):
    if arch not in _ARCH_MODULES:
        raise KeyError(
            f"unknown arch {arch!r} for the PyTorch port; ported: "
            f"{sorted(_ARCH_MODULES)}. Other archs follow ROADMAP Queue A "
            f"items 15 (the paper's other two models) and 12 (other "
            f"families)")
    return importlib.import_module(
        f"repro_torch.configs.{_ARCH_MODULES[arch]}")


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    return _module(arch).SMOKE
