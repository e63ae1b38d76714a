"""The masked-selection method family (port of the JAX package's
``methods/selection.py``): one step factory, many policies.

``full`` / ``adagradselect`` / ``topk_grad`` / ``random`` / ``lisa`` /
``grass`` share it: grads -> global-norm clip -> per-block norms -> policy
selection (core/adagradselect) -> block-masked AdamW, in place.

Two moment residencies (``opt_cfg.moment_residency``):

* ``"device"``: full f32 m/v on the card and the dense masked AdamW. The
  step never reads a value back to the host, so consecutive steps queue on
  the card without waiting.
* ``"banked"`` (paper §3.3): only the selected blocks' moments are on the
  card, in [k]-slot banks over a full store (host RAM under
  ``offload="host"``, pinned; the card under ``"none"``). Phase A
  (forward, backward, selection) gives the mask; then the step reads the
  selected indices back to the host — the one host sync per step that the
  design pays, as the reference does, since the boundary is planned on the
  host; then the boundary moves evicted and admitted blocks' moments
  between store and banks; phase B steps the bank rows
  (``ops.banked_masked_adamw``). The synchronous boundary queues its
  copies on the current stream without blocking the host. Under
  ``opt_cfg.async_swap`` (off by default) a ``core.swap.SwapPlanner``
  instead queues the predicted next boundary's copies on a copy stream
  while the card computes, and its predicted indices come back in the same
  host read; an exact prediction leaves only the bank commit on the
  critical path, a miss falls back to the synchronous swap
  (``step_fn.swap_stats``).

Not ported here, and raising: ``offload="zero1"`` and any offload under
dense residency (ROADMAP Queue A item 11), ``gate_weight_grads`` and
``lora`` (item 4).
"""
from __future__ import annotations

import dataclasses
import time

import torch

from repro_torch.configs.base import (ModelConfig, OptimizerConfig,
                                      SelectConfig, TrainConfig)
from repro_torch.core import adagradselect, masked_adamw, offload
from repro_torch.core import partition as part_mod
from repro_torch.core import swap as swap_mod
from repro_torch.methods import registry
from repro_torch.methods.base import TrainableReport
from repro_torch.models import lm
from repro_torch.optim.schedules import learning_rate
from repro_torch.train import step as step_mod


def _check_opt(opt_cfg: OptimizerConfig) -> None:
    if opt_cfg.moment_residency not in ("device", "banked"):
        raise ValueError(
            f"unknown moment_residency {opt_cfg.moment_residency!r}")
    ported = ("host", "none") if opt_cfg.moment_residency == "banked" \
        else ("none",)
    if opt_cfg.offload not in ported:
        raise NotImplementedError(
            f"offload={opt_cfg.offload!r} with moment_residency="
            f"{opt_cfg.moment_residency!r} is not ported yet (ROADMAP Queue "
            f"A item 11, 'Distributed')")
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
            select_k=self.slot_capacity(model_cfg),
            moment_residency=opt_cfg.moment_residency,
            store_policy=opt_cfg.offload, device=device)

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

        def step_metrics(metrics, loss, gnorm, lr, mask, block_norms, step):
            return {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr,
                    "epsilon": adagradselect.epsilon(sel_cfg, step),
                    "num_selected": mask.sum(), "mask": mask,
                    "block_norms": block_norms}

        if opt_cfg.moment_residency == "banked":
            return self._make_banked_step(opt_cfg, partition, forward_select,
                                          step_metrics)

        def step_fn(state, batch):
            grads, mask, sel_state, loss, metrics, gnorm, block_norms = \
                forward_select(state["params"], state["sel"], batch)
            lr = learning_rate(opt_cfg, state["step"])
            params, opt = masked_adamw.update(
                opt_cfg, partition, state["params"], grads, state["opt"],
                mask, lr)
            new_state = {"params": params, "opt": opt, "sel": sel_state,
                         "step": state["step"] + 1}
            return new_state, step_metrics(metrics, loss, gnorm, lr, mask,
                                           block_norms, state["step"])

        return step_fn

    def _make_banked_step(self, opt_cfg, partition, forward_select,
                          step_metrics):
        nb = partition.num_blocks
        planner = swap_mod.SwapPlanner(partition, nb,
                                       enabled=opt_cfg.async_swap)
        stats = planner.stats

        def step_fn(state, batch):
            t0 = time.perf_counter()
            grads, mask, sel_state, loss, metrics, gnorm, block_norms = \
                forward_select(state["params"], state["sel"], batch)
            ids = sel_state["indices"]
            cap = ids.shape[0]
            if planner.enabled:
                # the next selection's prediction depends only on this
                # post-select state: queue it now and read both together
                ids = torch.cat([ids, adagradselect.predict_next(
                    self.sel_cfg, sel_state, nb)])
            # the one host sync per step: [k] block ids, not a mask
            ids = ids.cpu().numpy()
            idx, pred = ids[:cap], ids[cap:]
            t1 = time.perf_counter()
            opt = state["opt"]
            slot_map = planner.resolve(idx, opt["banks"], opt["store"],
                                       opt["slot_map"])
            t2 = time.perf_counter()
            lr = learning_rate(opt_cfg, state["step"])
            masked_adamw.banked_update(
                opt_cfg, partition, state["params"], grads, opt["banks"],
                opt["counts"], mask, lr)
            # phase B is queued: queue the predicted next boundary behind it
            planner.dispatch(pred, opt["banks"], opt["store"], slot_map)
            t3 = time.perf_counter()
            stats.steps += 1
            stats.phase_a_us += (t1 - t0) * 1e6
            stats.swap_us += (t2 - t1) * 1e6
            stats.phase_b_us += (t3 - t2) * 1e6
            new_state = {"params": state["params"],
                         "opt": {**opt, "slot_map": slot_map},
                         "sel": sel_state, "step": state["step"] + 1}
            return new_state, step_metrics(metrics, loss, gnorm, lr, mask,
                                           block_norms, state["step"])

        # the planner, for the trainer's quiesce and the stats readers
        step_fn.swap_planner = planner
        step_fn.swap_stats = stats
        return step_fn

    def trainable_param_report(self, model_cfg: ModelConfig,
                               state: dict) -> TrainableReport:
        """The §3.3 memory model: P_selected = the k largest blocks (worst
        case), opt bytes 2 * P_selected * 4; resident = the optimizer
        state's measured bytes on the card (the host store is reported
        beside them)."""
        partition = part_mod.build_partition(model_cfg)
        rep = offload.optimizer_memory_report(
            partition, state["params"], self.sel_cfg.k_percent,
            opt_state=state["opt"])
        k = self.sel_cfg.num_selected(partition.num_blocks)
        resident = rep.mem_measured_device
        return TrainableReport(
            method=self.name, num_params_total=rep.p_total,
            num_params_trainable=rep.p_selected,
            opt_bytes=rep.mem_selective, opt_bytes_resident=resident,
            detail=f"policy={self.sel_cfg.policy} "
                   f"k={self.sel_cfg.k_percent:.0f}% "
                   f"({k}/{partition.num_blocks} blocks/step) "
                   f"resident={resident}B host={rep.mem_measured_host}B")


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
