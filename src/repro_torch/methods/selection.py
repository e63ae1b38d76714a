"""The masked-selection method family (port of the JAX package's
``methods/selection.py``): one step factory, many policies.

``full`` / ``adagradselect`` / ``topk_grad`` / ``random`` / ``lisa`` /
``grass`` share it: grads -> global-norm clip -> per-block norms -> policy
selection (core/adagradselect) -> block-masked AdamW, in place.

Two moment residencies (``opt_cfg.moment_residency``):

* ``"device"``: full m/v on the card and the dense masked AdamW. The
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

With ``model_cfg.gate_weight_grads`` the step chooses its mask BEFORE
the forward, as the reference does: ``select`` on zero instantaneous
norms, which leaves the policy's cumulative signal to decide (the same
(seed, step) draws as the ungated step). Only the body groups are gated:
the layers the mask leaves out run with detached parameters
(``core/gated.py``), so the backward launches none of their weight
gradients and their gradient rows are zero; the embedding, the final norm
and the head always get theirs. The clipped gradients' block norms then go
to ``adagradselect.observe``, and the masked AdamW steps with the chosen
mask. The host must know the mask before the forward to choose which
layers to detach, so a gated step reads it back: under dense residency
that is the step's one host read ([num_blocks] bools; the ungated dense
step makes none); under banked residency the same read carries the
selected indices (and the predicted next ones), and it moves from after
phase A to before the forward, so the step still makes one. The
prediction is then made from the state after ``select`` and before this
step's norms are observed; a miss costs only the synchronous swap.

Not ported here, and raising: ``offload="zero1"`` and any offload under
dense residency (ROADMAP Queue A item 11). The LoRA baseline is a method
of its own (``methods/lora.py``).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import obs
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
    if opt_cfg.moment_dtype not in ("float32", "bfloat16"):
        raise ValueError(f"unknown moment_dtype {opt_cfg.moment_dtype!r}; "
                         f"expected 'float32' or 'bfloat16'")


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
            store_policy=opt_cfg.offload, device=device,
            moment_dtype=lm.DTYPES[opt_cfg.moment_dtype])

    def make_step(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig):
        """-> ``step_fn(state, batch) -> (state, metrics)``; ``batch`` holds
        tensors on the device of the state. The state's tensors are updated
        in place; the returned state holds them, the new selection state and
        the advanced step."""
        _check_opt(opt_cfg)
        lm.check_supported(model_cfg)
        sel_cfg = self.sel_cfg
        partition = part_mod.build_partition(model_cfg)
        nb = partition.num_blocks
        accum = lm.DTYPES[opt_cfg.accum_dtype]
        gate = model_cfg.gate_weight_grads

        def preselect(sel_state):
            """Gate mode: (this step's mask, the state after its select),
            chosen before the forward from the cumulative signal."""
            zeros = torch.zeros((nb,), device=sel_state["mask"].device)
            return adagradselect.select(sel_cfg, sel_state, zeros, nb)

        def forward_select(params, sel_state, batch, pre_mask=None,
                           host_mask=None):
            """Loss, clipped grads, block norms and the mask. Gate mode
            passes ``pre_mask`` (``sel_state`` is then past its select) and
            its host copy ``host_mask``, which one set of layer masks takes
            to every microbatch."""
            masks = None if pre_mask is None else part_mod.layer_masks_dict(
                partition, torch.from_numpy(host_mask))

            def loss_fn(p, mb):
                return step_mod.model_loss(model_cfg, p, mb, masks=masks)

            (loss, metrics), grads = step_mod.accumulate_grads(
                loss_fn, params, batch, opt_cfg.microbatch, accum)
            grads, gnorm = masked_adamw.clip_by_global_norm(
                grads, opt_cfg.grad_clip)
            block_norms = part_mod.block_grad_norms(partition, grads)
            if pre_mask is None:
                mask, sel_state = adagradselect.select(
                    sel_cfg, sel_state, block_norms, nb)
            else:
                mask = pre_mask
                sel_state = adagradselect.observe(sel_cfg, sel_state,
                                                  block_norms)
            return grads, mask, sel_state, loss, metrics, gnorm, block_norms

        def step_metrics(metrics, loss, gnorm, lr, mask, block_norms, step):
            return {**metrics, "loss": loss, "grad_norm": gnorm, "lr": lr,
                    "epsilon": adagradselect.epsilon(sel_cfg, step),
                    "num_selected": mask.sum(), "mask": mask,
                    "block_norms": block_norms}

        if opt_cfg.moment_residency == "banked":
            return self._make_banked_step(
                opt_cfg, partition, forward_select, step_metrics,
                preselect if gate else None)

        def step_fn(state, batch):
            pre = {}
            sel_state = state["sel"]
            if gate:
                pre_mask, sel_state = preselect(sel_state)
                # the gated step's one host read: [num_blocks] bools
                pre = dict(pre_mask=pre_mask,
                           host_mask=pre_mask.cpu().numpy())
            grads, mask, sel_state, loss, metrics, gnorm, block_norms = \
                forward_select(state["params"], sel_state, batch, **pre)
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
                          step_metrics, preselect=None):
        """The banked step; ``preselect`` (gate mode) chooses the mask
        before the forward, and the step's one host read moves there."""
        nb = partition.num_blocks
        planner = swap_mod.SwapPlanner(partition, nb,
                                       enabled=opt_cfg.async_swap)
        stats = planner.stats

        def read_ids(sel_state, pre_mask=None):
            """The step's one host read -> (the gate's mask or None, the
            [k] selected ids, the predicted next ones): the planner's
            prediction is a function of this post-select state alone."""
            ids = sel_state["indices"]
            cap = ids.shape[0]
            lead = 0 if pre_mask is None else pre_mask.shape[0]
            parts = [ids] if pre_mask is None else [pre_mask.long(), ids]
            if planner.enabled:
                parts.append(adagradselect.predict_next(self.sel_cfg,
                                                        sel_state, nb))
            # the one host sync per step: block ids (and the gate's mask)
            host = torch.cat(parts).cpu().numpy()
            mask = None if pre_mask is None else host[:lead].astype(bool)
            return mask, host[lead:lead + cap], host[lead + cap:]

        def step_fn(state, batch):
            # each phase timed once: the SwapStats histograms and, while
            # tracing, a span of the same measurement
            with obs.timed(stats.phase_a, "phase_a"):
                if preselect is None:
                    (grads, mask, sel_state, loss, metrics, gnorm,
                     block_norms) = forward_select(state["params"],
                                                   state["sel"], batch)
                    _, idx, pred = read_ids(sel_state)
                else:
                    pre_mask, sel_state = preselect(state["sel"])
                    host_mask, idx, pred = read_ids(sel_state, pre_mask)
                    (grads, mask, sel_state, loss, metrics, gnorm,
                     block_norms) = forward_select(
                        state["params"], sel_state, batch,
                        pre_mask=pre_mask, host_mask=host_mask)
            opt = state["opt"]
            with obs.timed(stats.swap, "swap"):
                slot_map = planner.resolve(idx, opt["banks"], opt["store"],
                                           opt["slot_map"])
            with obs.timed(stats.phase_b, "phase_b"):
                lr = learning_rate(opt_cfg, state["step"])
                masked_adamw.banked_update(
                    opt_cfg, partition, state["params"], grads,
                    opt["banks"], opt["counts"], mask, lr)
                # phase B is queued: queue the predicted next boundary
                planner.dispatch(pred, opt["banks"], opt["store"], slot_map)
            stats.steps += 1
            new_state = {"params": state["params"],
                         "opt": {**opt, "slot_map": slot_map},
                         "sel": sel_state, "step": state["step"] + 1}
            return new_state, step_metrics(metrics, loss, gnorm, lr, mask,
                                           block_norms, state["step"])

        # the planner, for the trainer's quiesce and the stats readers
        step_fn.swap_planner = planner
        step_fn.swap_stats = stats
        return step_fn

    def eval_params(self, model_cfg: ModelConfig, opt_cfg: OptimizerConfig,
                    state: dict) -> dict:
        return state["params"]

    def trainable_param_report(self, model_cfg: ModelConfig,
                               state: dict) -> TrainableReport:
        """The §3.3 memory model: P_selected = the k largest blocks (worst
        case), opt bytes 2 * P_selected * B with B the moment dtype's bytes
        (4 for f32, 2 for bf16); resident = the optimizer state's measured
        bytes on the card (the host store is reported beside them)."""
        partition = part_mod.build_partition(model_cfg)
        rep = offload.optimizer_memory_report(
            partition, state["params"], self.sel_cfg.k_percent,
            bytes_per_param=offload.moment_itemsize(state["opt"]),
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


# full FT selects every block every step; k=100% makes the memory/trainable
# accounting agree with that.
registry.register("full", "all")(
    _selection_factory("all", name="full", k_percent=100.0))
registry.register("adagradselect")(_selection_factory("adagradselect"))
registry.register("topk_grad")(_selection_factory("topk_grad"))
registry.register("random")(_selection_factory("random"))
registry.register("lisa")(_selection_factory("lisa"))
registry.register("grass")(_selection_factory("grass"))
