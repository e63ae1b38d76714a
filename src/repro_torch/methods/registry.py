"""String-keyed fine-tuning method registry (port of the JAX package's
``methods/registry.py``). Entries are factories ``(TrainConfig) ->
FinetuneMethod``."""
from __future__ import annotations

from typing import Callable

from repro_torch.configs.base import TrainConfig
from repro_torch.methods.base import FinetuneMethod

_METHODS: dict[str, Callable[[TrainConfig], FinetuneMethod]] = {}


def register(name: str, *aliases: str):
    """Decorator: register a method factory under ``name`` (+ aliases)."""
    def deco(factory: Callable[[TrainConfig], FinetuneMethod]):
        for n in (name, *aliases):
            if n in _METHODS:
                raise ValueError(f"fine-tuning method {n!r} already registered")
            _METHODS[n] = factory
        return factory
    return deco


def get_method(name: str) -> Callable[[TrainConfig], FinetuneMethod]:
    """Resolve a registered factory; raises KeyError listing alternatives."""
    try:
        return _METHODS[name]
    except KeyError:
        raise KeyError(f"unknown fine-tuning method {name!r}; "
                       f"available: {available()}") from None


def build(name: str, tcfg: TrainConfig) -> FinetuneMethod:
    """Resolve + instantiate a method for one training configuration."""
    return get_method(name)(tcfg)


def available() -> tuple:
    return tuple(sorted(_METHODS))
