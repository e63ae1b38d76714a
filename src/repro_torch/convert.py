"""Parameter and train-state conversion between the JAX package and the
port.

``params_from_numpy`` takes the JAX package's parameters as a nested dict of
numpy arrays (what ``jax.device_get`` gives) and returns the port's tree of
tensors: the same key paths, the same stacked [L, ...] layout and, unless a
``dtype`` is given, the same dtype. ``params_to_numpy`` is its inverse.
``train_state_from_numpy`` converts a whole TrainState of the
masked-selection family, dense or banked residency, so both packages can
take the same step from the same state.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm

_NP_TO_TORCH = {np.dtype(np.float32): torch.float32,
                np.dtype(np.float16): torch.float16,
                np.dtype(np.int32): torch.int32}


def _leaf_to_tensor(arr, device, dtype) -> torch.Tensor:
    # a copy: the port updates parameters and moments in place, and the
    # array may be a read-only view of a JAX buffer
    arr = np.array(arr)
    if arr.dtype.name == "bfloat16":   # ml_dtypes.bfloat16, as JAX hands out
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
