"""Layer-selection controller: a registry of ``SelectionPolicy`` objects
(port of the JAX package's ``core/adagradselect.py``).

The paper's Algorithm 2 (``adagradselect``) is one entry in a string-keyed
policy registry beside its baselines (``topk_grad`` = Alg. 1, ``random``,
``all`` = full fine-tuning) and the beyond-paper ``lisa`` and ``grass``.
Each policy declares its own state on top of the common fields

    {"step": int, "seed": int, "mask": bool[num_blocks],
     "indices": long[k]}

``step`` is a host-side Python int (the JAX package keeps a device scalar):
the policies branch on it without reading anything back from the card.
``seed`` replaces the JAX PRNG key. Selection is deterministic given
(seed, step): each ``select`` draws its noise from a ``torch.Generator``
seeded from the pair, on the device of the mask, in a fixed order (eps,
dir, gum, rnd). The draws are plain tensors passed to ``propose``, so a
caller can supply its own (the tests hand in the JAX package's draws).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import SelectConfig
from repro_torch.core import selection

# --------------------------------------------------------------- registry

_POLICIES: dict[str, "SelectionPolicy"] = {}


def register_policy(name: str):
    """Class decorator: instantiate and register a SelectionPolicy."""
    def deco(cls):
        cls.name = name
        _POLICIES[name] = cls()
        return cls
    return deco


def get_policy(name: str) -> "SelectionPolicy":
    try:
        return _POLICIES[name]
    except KeyError:
        raise ValueError(f"unknown selection policy {name!r}; "
                         f"available: {available_policies()}") from None


def available_policies() -> tuple:
    return tuple(sorted(_POLICIES))


class SelectionPolicy:
    """One mask-proposal rule. Policies are stateless singletons; all
    trajectory state lives in the (per-policy) state dict.

    ``draws`` holds this step's noise: "eps" a 0-d uniform, "gum" [N]
    Gumbels, "rnd" [N] uniforms, and "dir" the Dirichlet(freq + delta)
    probabilities [N] for policies whose state has ``freq``."""

    name = "base"

    def extra_state(self, num_blocks: int, device) -> dict:
        """Policy-specific state fields (beyond step/seed/mask/indices)."""
        return {}

    def propose(self, cfg: SelectConfig, state: dict, draws: dict,
                block_norms: torch.Tensor, k: int,
                num_blocks: int) -> torch.Tensor:
        """-> bool mask [num_blocks] with exactly k True entries."""
        raise NotImplementedError

    def update(self, cfg: SelectConfig, state: dict, mask: torch.Tensor,
               block_norms: torch.Tensor) -> dict:
        """New values for this policy's ``extra_state`` fields."""
        return {}

    def observe(self, cfg: SelectConfig, state: dict,
                block_norms: torch.Tensor) -> dict:
        """Post-hoc norm observation (gate mode)."""
        if "cum_norms" in state:
            return {**state, "cum_norms": state["cum_norms"] + block_norms}
        return state

    def predict_next(self, cfg: SelectConfig, state: dict, draws: dict,
                     num_blocks: int, k: int) -> torch.Tensor:
        """Predicted mask of the NEXT ``select``, from the post-select state
        alone (the next step's norms are unknown): ``propose`` with zero
        norms. Exact for the rules that read no norms (``random``,
        ``lisa``, ``all``); the cumulative-signal approximation for
        ``adagradselect`` and ``grass``."""
        zeros = torch.zeros((num_blocks,), device=state["mask"].device)
        return self.propose(cfg, state, draws, zeros, k, num_blocks)


@register_policy("all")
class FullPolicy(SelectionPolicy):
    """Every block, every step — full fine-tuning."""

    def propose(self, cfg, state, draws, block_norms, k, num_blocks):
        return torch.ones((num_blocks,), dtype=torch.bool,
                          device=block_norms.device)


@register_policy("random")
class RandomPolicy(SelectionPolicy):
    """Uniform k-subset, redrawn every step."""

    def propose(self, cfg, state, draws, block_norms, k, num_blocks):
        return selection.random_mask(draws["rnd"], k)


@register_policy("topk_grad")
class TopKGradPolicy(SelectionPolicy):
    """Paper Alg. 1: rank by this step's instantaneous gradient norms."""

    def propose(self, cfg, state, draws, block_norms, k, num_blocks):
        return selection.topk_mask(block_norms, k)

    def predict_next(self, cfg, state, draws, num_blocks, k):
        # no state to rank by: selections drift slowly (BlockLLM), so the
        # best guess is the current mask
        return state["mask"]


@register_policy("adagradselect")
class AdaGradSelectPolicy(SelectionPolicy):
    """Paper Alg. 2: eps-greedy exploration over the cumulative-norm top-k,
    Dirichlet(freq + delta) exploitation via Gumbel-top-k sampling."""

    def extra_state(self, num_blocks, device):
        return {"freq": torch.zeros(num_blocks, device=device),
                "cum_norms": torch.zeros(num_blocks, device=device)}

    def propose(self, cfg, state, draws, block_norms, k, num_blocks):
        signal = state["cum_norms"] + block_norms  # cumulative (§3.2)
        explore_mask = selection.topk_mask(signal, k)
        exploit_mask = selection.sample_without_replacement(
            draws["dir"], draws["gum"], k)
        do_explore = draws["eps"] < epsilon(cfg, state["step"])
        return torch.where(do_explore, explore_mask, exploit_mask)

    def update(self, cfg, state, mask, block_norms):
        return {"freq": state["freq"] + mask.float(),
                "cum_norms": state["cum_norms"] + block_norms}


@register_policy("lisa")
class LisaPolicy(SelectionPolicy):
    """LISA-style: a uniform-random k-subset held fixed for
    ``cfg.lisa_interval`` steps, then resampled (arXiv:2403.17919 idiom)."""

    def propose(self, cfg, state, draws, block_norms, k, num_blocks):
        if state["step"] % cfg.lisa_interval == 0:
            return selection.random_mask(draws["rnd"], k)
        return state["mask"]


@register_policy("grass")
class GrassPolicy(SelectionPolicy):
    """GRASS-style importance sampling: draw k blocks without replacement
    with probability proportional to the cumulative gradient-norm signal
    raised to ``cfg.grass_temperature``."""

    def extra_state(self, num_blocks, device):
        return {"cum_norms": torch.zeros(num_blocks, device=device)}

    def propose(self, cfg, state, draws, block_norms, k, num_blocks):
        signal = state["cum_norms"] + block_norms
        w = torch.pow(signal + 1e-12, cfg.grass_temperature)
        probs = w / torch.clamp(w.sum(), min=1e-20)
        return selection.sample_without_replacement(probs, draws["gum"], k)

    def update(self, cfg, state, mask, block_norms):
        return {"cum_norms": state["cum_norms"] + block_norms}


# ------------------------------------------------------------- controller


def selected_indices(mask: torch.Tensor, k: int) -> torch.Tensor:
    """Static-shape [k] vector of selected block ids (ascending), padded
    with ``num_blocks`` when fewer than k blocks are selected."""
    n = mask.shape[0]
    ids = torch.where(mask, torch.arange(n, device=mask.device), n)
    return torch.sort(ids).values[:k]


def init_state(num_blocks: int, seed: int = 0,
               policy: str = "adagradselect", k: int | None = None,
               device="cpu") -> dict:
    """Per-policy state: common fields + the policy's extras. ``k`` fixes
    the length of ``indices`` (default: ``num_blocks``)."""
    k = num_blocks if k is None else min(k, num_blocks)
    mask0 = torch.ones((num_blocks,), dtype=torch.bool, device=device)
    return {
        "step": 0,
        "seed": int(seed),
        "mask": mask0,
        "indices": selected_indices(mask0, k),
        **get_policy(policy).extra_state(num_blocks, device),
    }


def epsilon(cfg: SelectConfig, step: int) -> float:
    """eps_t = eps0 * exp(-lambda * t) in f32, zeroed from epoch 2 on."""
    if step >= cfg.steps_per_epoch:
        return 0.0
    t = np.float32(step)
    return float(np.float32(cfg.epsilon0)
                 * np.exp(np.float32(-cfg.epsilon_decay) * t))


def step_generator(seed: int, step: int, device) -> torch.Generator:
    """The generator of one ``select`` call, seeded from (seed, step)."""
    mixed = np.random.SeedSequence([seed, step]).generate_state(1, np.uint64)
    return torch.Generator(device=device).manual_seed(int(mixed[0] >> 1))


def make_draws(cfg: SelectConfig, state: dict, num_blocks: int) -> dict:
    """This step's noise, from ``step_generator`` in a fixed order."""
    dev = state["mask"].device
    gen = step_generator(state["seed"], state["step"], dev)
    draws = {"eps": torch.rand((), generator=gen, device=dev)}
    if "freq" in state:
        draws["dir"] = selection.dirichlet_probs(gen, state["freq"],
                                                 cfg.dirichlet_delta)
    draws["gum"] = selection.gumbel(gen, num_blocks, dev)
    draws["rnd"] = torch.rand(num_blocks, generator=gen, device=dev)
    return draws


def select(cfg: SelectConfig, state: dict, block_norms: torch.Tensor,
           num_blocks: int, draws: dict | None = None
           ) -> tuple[torch.Tensor, dict]:
    """One selection iteration. ``block_norms``: this step's per-block
    gradient L2 norms [num_blocks] f32. ``draws``: this step's noise
    (default: ``make_draws``). Returns (mask [num_blocks] bool, new
    state)."""
    pol = get_policy(cfg.policy)
    k = cfg.num_selected(num_blocks)
    if draws is None:
        draws = make_draws(cfg, state, num_blocks)
    mask = pol.propose(cfg, state, draws, block_norms, k, num_blocks)
    mask = selection.apply_always_include(mask, cfg.always_include)
    new_state = {
        **state,
        **pol.update(cfg, state, mask, block_norms),
        "step": state["step"] + 1,
        "mask": mask,
    }
    if "indices" in state:
        new_state["indices"] = selected_indices(mask,
                                                state["indices"].shape[0])
    return mask, new_state


def observe(cfg: SelectConfig, state: dict,
            block_norms: torch.Tensor) -> dict:
    """Feed post-backward norms to the policy without selecting (gate
    mode)."""
    return get_policy(cfg.policy).observe(cfg, state, block_norms)


def predict_next(cfg: SelectConfig, state: dict, num_blocks: int,
                 draws: dict | None = None) -> torch.Tensor:
    """Predicted NEXT selection as a [k] indices vector (the contract of
    ``state["indices"]``: ascending block ids padded with ``num_blocks``),
    from the post-``select`` state alone. The draws default to
    ``make_draws`` at this state, which is the generator of the next
    ``select`` (its step is already advanced), so a policy that reads no
    norms is predicted exactly. Pure; reads nothing back to the host."""
    pol = get_policy(cfg.policy)
    k = cfg.num_selected(num_blocks)
    if draws is None:
        draws = make_draws(cfg, state, num_blocks)
    mask = pol.predict_next(cfg, state, draws, num_blocks, k)
    mask = selection.apply_always_include(mask, cfg.always_include)
    cap = state["indices"].shape[0] if "indices" in state else num_blocks
    return selected_indices(mask, cap)
