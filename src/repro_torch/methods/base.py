"""The ``FinetuneMethod`` strategy protocol (port of the JAX package's
``methods/base.py``).

A fine-tuning method owns what the paper varies between its compared
approaches: the state a training run carries, how one step is built, and
how many parameters it trains, and which parameters the greedy eval
(``train/evaluate.py``) decodes with. The trainer is method-agnostic.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol, runtime_checkable

from repro_torch.configs.base import ModelConfig, OptimizerConfig


@dataclass(frozen=True)
class TrainableReport:
    """What a method trains (paper §3.3 memory model). ``opt_bytes`` is the
    modelled optimizer-state bytes (2 * P_selected * 4); under dense
    residency the resident bytes are the full m/v."""

    method: str
    num_params_total: int      # all model parameters
    num_params_trainable: int  # parameters the method may update per step
    opt_bytes: int             # modelled optimizer-state bytes (m + v)
    detail: str = ""
    opt_bytes_resident: int = -1  # measured device-resident bytes

    @property
    def trainable_fraction(self) -> float:
        return self.num_params_trainable / max(1, self.num_params_total)


@runtime_checkable
class FinetuneMethod(Protocol):
    """Strategy interface every registered method implements."""

    name: str

    def init_state(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                   seed: int = 0, device="cuda") -> dict:
        """Fresh TrainState: params + optimizer + method state."""
        ...

    def make_step(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig):
        """-> ``(state, batch) -> (state, metrics)``."""
        ...

    def eval_params(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    state: dict) -> dict:
        """Inference-ready parameter tree for the current state."""
        ...

    def trainable_param_report(self, model_cfg: ModelConfig,
                               state: dict) -> TrainableReport:
        """Trainable-parameter / optimizer-memory accounting."""
        ...
