"""Pluggable fine-tuning methods: one strategy API, a string-keyed registry
(port of the JAX package's ``methods``).

Registered: ``full`` (alias ``all``), ``adagradselect``, ``topk_grad``,
``random``, ``lisa`` and ``grass`` (the masked-selection family,
``methods/selection.py``), and ``lora`` (the LoRA baseline,
``methods/lora.py``).
"""
from repro_torch.methods import lora as _lora  # noqa: F401
from repro_torch.methods import selection as _selection  # noqa: F401
from repro_torch.methods.base import FinetuneMethod, TrainableReport  # noqa: F401
from repro_torch.methods.registry import (  # noqa: F401
    available,
    build,
    get_method,
    register,
)
