"""Parameter and train-state conversion between the JAX package and the
port.

``params_from_numpy`` takes the JAX package's parameters as a nested dict of
numpy arrays (what ``jax.device_get`` gives) and returns the port's tree of
tensors: the same key paths, the same stacked [L, ...] layout and, unless a
``dtype`` is given, the same dtype. ``params_to_numpy`` is its inverse.
``lora_from_numpy`` converts the LoRA baseline's flat adapter dict
(``{"layers/attn/wq": {"a", "b"}, ...}``) and ``lora_state_from_numpy`` its
whole ``{"base", "lora", "opt", "step"}`` state.
``train_state_from_numpy`` converts a whole TrainState of the
masked-selection family, dense or banked residency, so both packages can
take the same step from the same state; ``train_state_from_checkpoint``
does so for a ``step_N/proc_0.npz`` that the JAX package's
``CheckpointManager`` wrote. bf16 leaves may come as ``ml_dtypes.bfloat16``
(what JAX hands out) or as the raw 2-byte void (``|V2``) that the
reference's checkpoint writer leaves of them; both are viewed as bf16, bit
for bit. (The port's own files hold bf16 as uint16 bits and restore
through ``CheckpointManager.restore``, which reads every 2-byte leaf by its
target's dtype.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.checkpoint.manager import CheckpointManager, unflatten
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.optim import lora as lora_mod

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32}


def _leaf_to_tensor(arr, device, dtype) -> torch.Tensor:
    # a copy: the port updates parameters and moments in place, and the
    # array may be a read-only view of a JAX buffer
    arr = np.array(arr)
    # ml_dtypes.bfloat16, as JAX hands out, or the |V2 a reference
    # checkpoint restores it as
    if arr.dtype.name == "bfloat16" or arr.dtype == np.dtype("V2"):
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    elif arr.dtype in _NP_TO_TORCH:
        t = torch.from_numpy(arr)
    else:
        raise TypeError(f"unsupported parameter dtype {arr.dtype}")
    return t.to(device=device, dtype=dtype or t.dtype).contiguous()


def params_from_numpy(tree: dict, cfg: ModelConfig, device="cuda",
                      dtype: torch.dtype | None = None) -> dict:
    """Nested dict of numpy arrays -> nested dict of tensors on ``device``.
    Every key path and shape must match ``lm.param_shapes(cfg)``."""
    dev = resolve_device(device)
    shapes = lm.param_shapes(cfg)

    def walk(t, s, path):
        if set(t) != set(s):
            raise KeyError(f"{path or 'params'}: keys {sorted(t)} != "
                           f"expected {sorted(s)}")
        out = {}
        for k, v in t.items():
            p = f"{path}/{k}"
            if isinstance(s[k], dict):
                out[k] = walk(v, s[k], p)
                continue
            if tuple(np.shape(v)) != tuple(s[k]):
                raise ValueError(f"{p}: shape {tuple(np.shape(v))} != "
                                 f"expected {tuple(s[k])}")
            out[k] = _leaf_to_tensor(v, dev, dtype)
        return out
    return walk(tree, shapes, "")


def lora_from_numpy(tree: dict, cfg: ModelConfig, rank: int,
                    device="cuda", dtype: torch.dtype | None = None) -> dict:
    """The reference's flat adapter dict (or a moment tree of its form) as
    numpy -> the port's, on ``device``. Its keys and every shape must be
    those ``optim.lora.init_lora`` gives for ``cfg`` and ``rank``."""
    dev = resolve_device(device)
    want = {path: {"a": a, "b": b}
            for path, (a, b, _) in lora_mod.adapter_layout(cfg, rank).items()}
    if set(tree) != set(want):
        raise KeyError(f"adapter keys {sorted(tree)} != expected "
                       f"{sorted(want)}")
    out = {}
    for path, ab in tree.items():
        if set(ab) != {"a", "b"}:
            raise KeyError(f"{path}: keys {sorted(ab)} != ['a', 'b']")
        out[path] = {}
        for k in ("a", "b"):
            if tuple(np.shape(ab[k])) != tuple(want[path][k]):
                raise ValueError(f"{path}/{k}: shape {tuple(np.shape(ab[k]))}"
                                 f" != expected {tuple(want[path][k])} "
                                 f"(rank {rank})")
            out[path][k] = _leaf_to_tensor(ab[k], dev, dtype)
    return out


def lora_state_from_numpy(state: dict, cfg: ModelConfig, rank: int,
                          device="cuda") -> dict:
    """A JAX LoRA TrainState as numpy (``base``, ``lora``, ``opt`` = {m, v,
    count}, ``step``) -> the port's on ``device``, so both packages can
    take the same step from the same state."""
    dev = resolve_device(device)
    opt = state["opt"]
    if set(opt) != {"m", "v", "count"}:
        raise ValueError(f"opt state keys {sorted(opt)}: not the LoRA "
                         f"layout (m, v, count)")
    return {
        "base": params_from_numpy(state["base"], cfg, dev),
        "lora": lora_from_numpy(state["lora"], cfg, rank, dev),
        "opt": {"m": lora_from_numpy(opt["m"], cfg, rank, dev),
                "v": lora_from_numpy(opt["v"], cfg, rank, dev),
                "count": _leaf_to_tensor(opt["count"], dev, None)},
        "step": int(np.asarray(state["step"])),
    }


def params_to_numpy(params: dict) -> dict:
    """Inverse of ``params_from_numpy``: tensors -> numpy arrays on the host,
    bf16 as ``ml_dtypes.bfloat16`` (the type JAX hands out)."""
    def leaf(t: torch.Tensor):
        t = t.detach().cpu()
        if t.dtype == torch.bfloat16:
            import ml_dtypes
            return t.view(torch.uint16).numpy().view(ml_dtypes.bfloat16)
        return t.numpy()
    return {k: (params_to_numpy(v) if isinstance(v, dict) else leaf(v))
            for k, v in params.items()}


def _tree_to_tensors(tree, device, pin=False):
    if isinstance(tree, dict):
        return {k: _tree_to_tensors(v, device, pin) for k, v in tree.items()}
    t = _leaf_to_tensor(tree, device, None)
    return t.pin_memory() if pin else t


def _banked_opt_from_numpy(opt: dict, dev, offload: str) -> dict:
    """A JAX banked ``opt`` (banks, host ``slot_map``, counts, store) -> the
    port's, with the store placed per ``offload``: "host" keeps it in host
    RAM (pinned when the banks are on the card), "none" puts it on
    ``dev``."""
    if offload not in ("host", "none"):
        raise NotImplementedError(
            f"offload={offload!r} is not ported yet (ROADMAP Queue A item "
            f"11, 'Distributed')")
    banks = {}
    for key, bank in opt["banks"].items():
        banks[key] = {
            "m": _tree_to_tensors(bank["m"], dev),
            "v": _tree_to_tensors(bank["v"], dev),
            "slots": torch.tensor(np.asarray(bank["slots"], np.int32),
                                  device=dev)}
    store_dev = dev if offload == "none" else torch.device("cpu")
    return {
        "banks": banks,
        "slot_map": np.array(opt["slot_map"], np.int32),
        "counts": _leaf_to_tensor(opt["counts"], dev, None),
        "store": _tree_to_tensors(opt["store"], store_dev,
                                  pin=offload == "host"
                                  and dev.type == "cuda"),
    }


def train_state_from_numpy(state: dict, cfg: ModelConfig, device="cuda",
                           offload: str = "host") -> dict:
    """A JAX TrainState as numpy (``params``, ``opt``, ``sel`` and
    ``step``) -> the port's TrainState on ``device``. ``opt`` is the dense
    layout (m, v, counts) or the banked one (banks, slot_map, counts,
    store; the store placed per ``offload``, "host" or "none"). The
    selection state's PRNG key (uint32 [2], ``jax.random.PRNGKey``) becomes
    the port's generator ``seed`` (the key's two words as one integer); the
    key itself is kept as ``jax_key`` for tests."""
    dev = resolve_device(device)
    opt = state["opt"]
    if set(opt) == {"m", "v", "counts"}:
        out_opt = {"m": params_from_numpy(opt["m"], cfg, dev),
                   "v": params_from_numpy(opt["v"], cfg, dev),
                   "counts": _leaf_to_tensor(opt["counts"], dev, None)}
    elif set(opt) == {"banks", "slot_map", "counts", "store"}:
        out_opt = _banked_opt_from_numpy(opt, dev, offload)
    else:
        raise ValueError(f"opt state keys {sorted(opt)}: neither the dense "
                         f"(m, v, counts) nor the banked (banks, slot_map, "
                         f"counts, store) layout")

    def tensor(a, dtype=None):
        return _leaf_to_tensor(a, dev, dtype)

    sel = {k: v for k, v in state["sel"].items() if k != "key"}
    key = np.asarray(state["sel"]["key"], np.uint32)
    out_sel = {"step": int(np.asarray(sel.pop("step"))),
               "seed": (int(key[0]) << 32) | int(key[1]),
               "jax_key": key,
               "mask": torch.tensor(np.asarray(sel.pop("mask"), bool),
                                    device=dev),
               "indices": torch.tensor(np.asarray(sel.pop("indices")),
                                       dtype=torch.int64, device=dev)}
    out_sel.update({k: tensor(v) for k, v in sel.items()})
    return {
        "params": params_from_numpy(state["params"], cfg, dev),
        "opt": out_opt,
        "sel": out_sel,
        "step": int(np.asarray(state["step"])),
    }


def train_state_from_checkpoint(directory: str, cfg: ModelConfig,
                                step: int | None = None, device="cuda",
                                offload: str = "host") -> tuple[dict, int]:
    """(the port's TrainState, step) from a checkpoint directory that the
    JAX package's ``CheckpointManager`` wrote (the latest step unless one is
    given), dense or banked, f32 or bf16: ``train_state_from_numpy`` on its
    leaves, each read as the file holds it."""
    flat, step = CheckpointManager(directory).load_flat(step)
    return train_state_from_numpy(unflatten(flat), cfg, device,
                                  offload), step
