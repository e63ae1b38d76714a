"""Method-agnostic training-step building blocks (port of the JAX package's
``train/step.py``): the masked next-token loss, gradients with microbatch
accumulation, and the TrainState of the masked-selection family (dense
or banked residency).

The step factories live in ``repro_torch.methods``. Parameters are plain
tensors that do not require grad; ``value_and_grad`` differentiates
detached copies that share their storage, so the optimizer can update the
parameters in place afterwards.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core import adagradselect, masked_adamw
from repro_torch.core import partition as part_mod
from repro_torch.device import resolve_device
from repro_torch.models import lm

# ----------------------------------------------------------------- loss


def next_token_loss(logits, tokens, loss_mask, shift: int = 1):
    """Masked CE: position t predicts token t+shift, as the gathered logit
    minus the logsumexp (in f32) over the vocabulary."""
    if shift:
        logits = logits[:, :-shift]
        targets = tokens[:, shift:]
        mask = loss_mask[:, shift:]
    else:
        targets, mask = tokens, loss_mask
    lse = torch.logsumexp(logits.float(), dim=-1)
    picked = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    ll = picked.float() - lse
    denom = torch.clamp(mask.sum(), min=1.0)
    return -(ll * mask).sum() / denom


def model_loss(cfg: ModelConfig, params, batch, masks=None):
    """-> (total loss, {"ce_loss", "aux_loss"}) of the dense LM. ``masks``:
    the host layer masks that gate the weight gradients under
    ``cfg.gate_weight_grads`` (``lm.apply_train``)."""
    logits, aux, _ = lm.apply_train(params, cfg, batch, masks=masks)
    loss = next_token_loss(logits, batch["tokens"], batch["loss_mask"])
    return loss + aux, {"ce_loss": loss, "aux_loss": aux}


def value_and_grad(loss_fn, params, batch):
    """-> ((loss, metrics), grads) with everything detached; ``grads`` has
    the structure of ``params``. A leaf the loss does not reach (a stacked
    leaf whose layers are all frozen under the gate) gets zeros, never
    ``None``: the reference's ``dparams_zero``."""
    with torch.enable_grad():
        ps = part_mod.tree_map(lambda p: p.detach().requires_grad_(True),
                               params)
        loss, met = loss_fn(ps, batch)
        loss.backward()
    grads = part_mod.tree_map(
        lambda p: torch.zeros_like(p) if p.grad is None else p.grad, ps)
    met = {k: v.detach() for k, v in met.items()}
    return (loss.detach(), met), grads


def accumulate_grads(loss_fn, params, batch, n_micro: int,
                     accum_dtype=torch.float32):
    """Mean grads over ``n_micro`` microbatches, summed in an
    ``accum_dtype`` buffer and cast back to the parameter dtype."""
    if n_micro <= 1:
        return value_and_grad(loss_fn, params, batch)
    micro = {k: v.reshape(n_micro, v.shape[0] // n_micro, *v.shape[1:])
             for k, v in batch.items()}
    acc = part_mod.tree_map(
        lambda p: torch.zeros(p.shape, dtype=accum_dtype, device=p.device),
        params)
    loss_acc, m_acc = 0.0, None
    for i in range(n_micro):
        (loss, met), g = value_and_grad(
            loss_fn, params, {k: v[i] for k, v in micro.items()})
        part_mod.tree_map(lambda a, x: a.add_(x), acc, g)
        loss_acc = loss_acc + loss
        m_acc = met if m_acc is None else {k: m_acc[k] + met[k]
                                           for k in met}
    scale = 1.0 / n_micro
    grads = part_mod.tree_map(lambda a, p: (a * scale).to(p.dtype), acc,
                              params)
    return ((loss_acc * scale, {k: v * scale for k, v in m_acc.items()}),
            grads)


# ----------------------------------------------------------------- state


def init_train_state(model_cfg: ModelConfig, seed: int = 0,
                     policy: str = "adagradselect",
                     select_k: int | None = None,
                     moment_residency: str = "device",
                     store_policy: str = "host",
                     device="cuda",
                     moment_dtype: torch.dtype = torch.float32) -> dict:
    """TrainState of the masked-selection family: params (random, from a
    generator seeded with ``seed`` on ``device``) + masked-AdamW moments +
    the policy's selection state + the step (a Python int).

    ``moment_residency == "device"``: ``state["opt"]`` is the dense layout
    ``{"m", "v", "counts"}``. ``"banked"``: the compact layout ``{"banks",
    "slot_map", "counts", "store"}``, [select_k]-slot banks on ``device``
    over a full store placed per ``store_policy`` ("host": host RAM,
    pinned on the card; "none": ``device``; see
    ``masked_adamw.init_banked_opt_state``). ``select_k`` sets both the
    bank capacity and the length of the selection state's ``indices``
    (default: ``num_blocks``). The moments are in ``moment_dtype``."""
    if moment_residency not in ("device", "banked"):
        raise ValueError(f"unknown moment_residency {moment_residency!r}; "
                         f"expected 'device' or 'banked'")
    dev = resolve_device(device)
    partition = part_mod.build_partition(model_cfg)
    params = lm.init(model_cfg, torch.Generator(device=dev).manual_seed(seed),
                     device=dev)
    if moment_residency == "banked":
        k = select_k if select_k is not None else partition.num_blocks
        opt = masked_adamw.init_banked_opt_state(partition, params, k,
                                                 store_policy, moment_dtype)
    else:
        opt = masked_adamw.init_opt_state(partition, params, moment_dtype)
    return {
        "params": params,
        "opt": opt,
        "sel": adagradselect.init_state(partition.num_blocks, seed,
                                        policy=policy, k=select_k,
                                        device=dev),
        "step": 0,
    }
