"""LoRA as a registered FinetuneMethod (paper §4.2 baseline; port of the
JAX package's ``methods/lora.py``).

Rank-r adapters on the attention/MLP projections, trained with standard
AdamW (``optim/adamw.py``) while the base weights stay frozen
(merge-on-forward, see ``optim/lora.py``). state = {"base", "lora", "opt",
"step"}, the step a Python int as in the selection family.

Only the adapters are differentiated: the base reaches the model through
the merge, detached, so no gradient buffer of the base is made. The
forward and backward run the model's kernels (the RMSNorm forward, the
flash attention forward and backward) as every training path does; with
every norm scale frozen, the RMSNorm backward runs its dx-only mode. No
selection runs, so the block-norm and masked-AdamW kernels are off this
path. As in the reference, ``moment_residency``, ``offload`` and
``moment_dtype`` are ignored: the adapters' moments are f32 on the
parameters' device.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, OptimizerConfig
from repro_torch.core import masked_adamw
from repro_torch.core.offload import resident_opt_bytes
from repro_torch.core.partition import leaves
from repro_torch.device import resolve_device
from repro_torch.methods import registry
from repro_torch.methods.base import TrainableReport
from repro_torch.models import lm
from repro_torch.optim import adamw as plain_adamw
from repro_torch.optim import lora as lora_mod
from repro_torch.optim.schedules import learning_rate
from repro_torch.train import step as step_mod


class LoRAMethod:
    """FinetuneMethod: adapter-only training, frozen base."""

    name = "lora"

    def init_state(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                   seed: int = 0, device="cuda") -> dict:
        dev = resolve_device(device)
        base = lm.init(model_cfg,
                       torch.Generator(device=dev).manual_seed(seed),
                       device=dev)
        lora_p = lora_mod.init_lora(
            torch.Generator(device=dev).manual_seed(seed + 1), base,
            model_cfg, opt_cfg.lora_rank)
        return {"base": base, "lora": lora_p,
                "opt": plain_adamw.init_opt_state(lora_p), "step": 0}

    def make_step(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig):
        """-> ``step_fn(state, batch) -> (state, metrics)``; the adapters
        and their moments are updated in place."""
        lm.check_supported(model_cfg)
        rank, alpha = opt_cfg.lora_rank, opt_cfg.lora_alpha
        accum = lm.DTYPES[opt_cfg.accum_dtype]

        def step_fn(state, batch):
            def loss_fn(lp, mb):
                merged = lora_mod.merge(state["base"], lp, model_cfg, rank,
                                        alpha)
                return step_mod.model_loss(model_cfg, merged, mb)

            (loss, metrics), grads = step_mod.accumulate_grads(
                loss_fn, state["lora"], batch, opt_cfg.microbatch, accum)
            grads, gnorm = masked_adamw.clip_by_global_norm(
                grads, opt_cfg.grad_clip)
            lr = learning_rate(opt_cfg, state["step"])
            lora_p, opt = plain_adamw.update(opt_cfg, state["lora"], grads,
                                             state["opt"], lr)
            new_state = {"base": state["base"], "lora": lora_p, "opt": opt,
                         "step": state["step"] + 1}
            metrics = {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr}
            return new_state, metrics

        return step_fn

    def eval_params(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    state: dict) -> dict:
        return lora_mod.merge(state["base"], state["lora"], model_cfg,
                              opt_cfg.lora_rank, opt_cfg.lora_alpha)

    def trainable_param_report(self, model_cfg: ModelConfig,
                               state: dict) -> TrainableReport:
        total = sum(x.numel() for x in leaves(state["base"]))
        n_lora = lora_mod.num_lora_params(state["lora"])
        return TrainableReport(
            method=self.name, num_params_total=total,
            num_params_trainable=n_lora,
            opt_bytes=2 * n_lora * 4,  # f32 m + v on adapters only
            opt_bytes_resident=resident_opt_bytes(state["opt"])["device"],
            detail=f"adapters on {len(state['lora'])} leaf groups")


registry.register("lora")(lambda tcfg: LoRAMethod())
