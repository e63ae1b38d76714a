"""Selection primitives: top-k masking, Dirichlet sampling, Gumbel-top-k
(port of the JAX package's ``core/selection.py``).

Every random function takes its draws from an explicit ``torch.Generator``,
so a run is reproducible from its seed, and the policies can also be handed
the draws themselves (``adagradselect.propose``), which is how the tests
feed both packages the same noise. Nothing here reads a tensor back to the
host.
"""
from __future__ import annotations

import torch


def topk_mask(scores: torch.Tensor, k: int) -> torch.Tensor:
    """Boolean mask of the k largest entries of ``scores`` [N] -> [N]. Ties
    go to the lower index, as ``lax.top_k`` breaks them in the reference
    (``torch.topk`` leaves their order unspecified)."""
    idx = torch.sort(scores, descending=True, stable=True).indices[:k]
    mask = torch.zeros(scores.shape, dtype=torch.bool, device=scores.device)
    return mask.index_fill_(0, idx, True)


def dirichlet_probs(generator: torch.Generator, freq: torch.Tensor,
                    delta: float) -> torch.Tensor:
    """p ~ Dirichlet(freq + delta) (paper §3.2), as normalised Gamma
    draws."""
    alpha = freq.float() + delta
    g = torch._standard_gamma(alpha, generator=generator)
    return g / g.sum()


def gumbel(generator: torch.Generator, n: int, device) -> torch.Tensor:
    """[n] standard Gumbel draws, -log(-log(u)) with u in (0, 1)."""
    u = torch.rand(n, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(min=tiny)))


def sample_without_replacement(probs: torch.Tensor, gumbels: torch.Tensor,
                               k: int) -> torch.Tensor:
    """k items without replacement with probability proportional to
    ``probs``, by the Gumbel-top-k trick (exact for Plackett-Luce sampling)
    over the given Gumbel draws [N]. Returns a boolean mask [N]."""
    return topk_mask(torch.log(probs + 1e-20) + gumbels, k)


def random_mask(uniforms: torch.Tensor, k: int) -> torch.Tensor:
    """A uniform k-subset from [N] uniform draws."""
    return topk_mask(uniforms, k)


def apply_always_include(mask: torch.Tensor,
                         always_include: tuple) -> torch.Tensor:
    if always_include:
        mask = mask.clone()
        mask[list(always_include)] = True
    return mask
