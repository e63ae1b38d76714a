"""The masked-selection method family (port of the dense-residency half of
the JAX package's ``methods/selection.py``): one step factory, many
policies.

``full`` / ``adagradselect`` / ``topk_grad`` / ``random`` / ``lisa`` /
``grass`` share it: grads -> global-norm clip -> per-block norms -> policy
selection (core/adagradselect) -> block-masked AdamW, in place. The step
is a plain Python function over tensors; it never reads a value back to
the host, so consecutive steps queue on the card without waiting.

Not ported here, and raising: ``moment_residency="banked"`` (ROADMAP Queue
A item 6), ``gate_weight_grads`` and ``lora`` (item 4).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      SelectConfig, TrainConfig)
from repro_torch.core import adagradselect, masked_adamw
from repro_torch.core import partition as part_mod
from repro_torch.methods import registry
from repro_torch.methods.base import TrainableReport
from repro_torch.models import lm
from repro_torch.optim.schedules import learning_rate
from repro_torch.train import step as step_mod


def _check_opt(opt_cfg: OptimizerConfig) -> None:
    if opt_cfg.moment_residency == "banked":
        raise NotImplementedError(
            "moment_residency='banked' is not ported yet (ROADMAP Queue A "
            "item 6, 'Banked residency')")
    if opt_cfg.moment_residency != "device":
        raise ValueError(
            f"unknown moment_residency {opt_cfg.moment_residency!r}")
    if opt_cfg.offload != "none":
        raise NotImplementedError(
            f"offload={opt_cfg.offload!r} is not ported yet (ROADMAP Queue A "
            f"item 11, 'Distributed')")
    if opt_cfg.moment_dtype != "float32":
        raise NotImplementedError(
            "the port keeps f32 moments (the masked AdamW kernel takes f32 "
            "m and v)")


@dataclasses.dataclass(frozen=True)
class SelectionMethod:
    """FinetuneMethod for block-masked fine-tuning under one policy."""

    name: str
    sel_cfg: SelectConfig

    def slot_capacity(self, model_cfg: ModelConfig) -> int:
        """Length of the selection state's ``indices``: the policy's k plus
        any always-include blocks, capped at num_blocks."""
        nb = model_cfg.num_blocks
        return min(nb, self.sel_cfg.num_selected(nb)
                   + len(self.sel_cfg.always_include))

    def init_state(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                   seed: int = 0, device="cuda") -> dict:
        _check_opt(opt_cfg)
        return step_mod.init_train_state(
            model_cfg, seed, policy=self.sel_cfg.policy,
            select_k=self.slot_capacity(model_cfg), device=device)

    def make_step(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig):
        """-> ``step_fn(state, batch) -> (state, metrics)``; ``batch`` holds
        tensors on the device of the state. The state's tensors are updated
        in place; the returned state holds them, the new selection state and
        the advanced step."""
        _check_opt(opt_cfg)
        lm.check_supported(model_cfg)
        if model_cfg.gate_weight_grads:
            raise NotImplementedError(
                "gate_weight_grads=True is not ported (the port computes "
                "every layer's weight gradients)")
        sel_cfg = self.sel_cfg
        partition = part_mod.build_partition(model_cfg)
        accum = lm.DTYPES[opt_cfg.accum_dtype]

        def loss_fn(p, mb):
            return step_mod.model_loss(model_cfg, p, mb)

        def forward_select(params, sel_state, batch):
            (loss, metrics), grads = step_mod.accumulate_grads(
                loss_fn, params, batch, opt_cfg.microbatch, accum)
            grads, gnorm = masked_adamw.clip_by_global_norm(
                grads, opt_cfg.grad_clip)
            block_norms = part_mod.block_grad_norms(partition, grads)
            mask, sel_state = adagradselect.select(
                sel_cfg, sel_state, block_norms, partition.num_blocks)
            return grads, mask, sel_state, loss, metrics, gnorm, block_norms

        def step_fn(state, batch):
            grads, mask, sel_state, loss, metrics, gnorm, block_norms = \
                forward_select(state["params"], state["sel"], batch)
            lr = learning_rate(opt_cfg, state["step"])
            params, opt = masked_adamw.update(
                opt_cfg, partition, state["params"], grads, state["opt"],
                mask, lr)
            new_state = {"params": params, "opt": opt, "sel": sel_state,
                         "step": state["step"] + 1}
            return new_state, {
                **metrics, "loss": loss, "grad_norm": gnorm, "lr": lr,
                "epsilon": adagradselect.epsilon(sel_cfg, state["step"]),
                "num_selected": mask.sum(), "mask": mask,
                "block_norms": block_norms}

        return step_fn

    def trainable_param_report(self, model_cfg: ModelConfig,
                               state: dict) -> TrainableReport:
        """The §3.3 memory model: P_selected = the k largest blocks (worst
        case), opt bytes 2 * P_selected * 4; resident = the dense m/v."""
        partition = part_mod.build_partition(model_cfg)
        counts = part_mod.params_per_block(partition, state["params"])
        k = self.sel_cfg.num_selected(partition.num_blocks)
        p_sel = int(np.sort(counts)[::-1][:k].sum())
        resident = sum(t.numel() * t.element_size()
                       for t in part_mod.leaves(state["opt"]))
        return TrainableReport(
            method=self.name, num_params_total=int(counts.sum()),
            num_params_trainable=p_sel, opt_bytes=2 * p_sel * 4,
            opt_bytes_resident=resident,
            detail=f"policy={self.sel_cfg.policy} "
                   f"k={self.sel_cfg.k_percent:.0f}% "
                   f"({k}/{partition.num_blocks} blocks/step) "
                   f"resident={resident}B")


def _selection_factory(policy: str, name: str | None = None, **overrides):
    def factory(tcfg: TrainConfig) -> SelectionMethod:
        sel = dataclasses.replace(tcfg.select, policy=policy, **overrides)
        return SelectionMethod(name=name or policy, sel_cfg=sel)
    return factory


def _lora(tcfg: TrainConfig):
    raise NotImplementedError(
        "the LoRA baseline is not ported yet (ROADMAP Queue A item 4, "
        "'LoRA baseline')")


# full FT selects every block every step; k=100% makes the memory/trainable
# accounting agree with that.
registry.register("full", "all")(
    _selection_factory("all", name="full", k_percent=100.0))
registry.register("adagradselect")(_selection_factory("adagradselect"))
registry.register("topk_grad")(_selection_factory("topk_grad"))
registry.register("random")(_selection_factory("random"))
registry.register("lisa")(_selection_factory("lisa"))
registry.register("grass")(_selection_factory("grass"))
registry.register("lora")(_lora)
