"""Pluggable fine-tuning methods: one strategy API, a string-keyed registry
(port of the JAX package's ``methods``).

Registered: ``full`` (alias ``all``), ``adagradselect``, ``topk_grad``,
``random``, ``lisa`` and ``grass`` (the masked-selection family,
``methods/selection.py``); ``lora`` is registered by name and raises, as
ROADMAP Queue A item 4 ports it.
"""
from repro_torch.methods import selection as _selection  # noqa: F401
from repro_torch.methods.base import FinetuneMethod, TrainableReport  # noqa: F401
from repro_torch.methods.registry import (  # noqa: F401
    available,
    build,
    get_method,
    register,
)
