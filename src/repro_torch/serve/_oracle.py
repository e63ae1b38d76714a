"""Parity oracle: the static-batch decode loop (port of the JAX package's
``serve/_oracle.py``).

``generate_legacy`` is not part of the public serving surface — use
``ServeEngine`` (or the module-level ``serve.generate`` wrapper) for real
decoding. It stays importable here because it defines two contracts:

- **token parity**: the engine's continuous-batching output must match
  this loop token for token under greedy decoding (the paper's eval
  protocol), so the tests diff against it;
- **the batch-wide sampled stream**: sampled decoding draws one batch-wide
  categorical a step from one generator seeded by ``rng`` a call;
  ``generate``'s sampled path routes here, so one seed reproduces its
  tokens. (JAX's threefry stream is not reproduced: the port's seeds give
  the port's tokens.)
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import sampling


def generate_legacy(params, cfg: ModelConfig, batch: dict, *,
                    max_new_tokens: int, max_len: int | None = None,
                    temperature: float = 0.0, rng=None, mesh=None,
                    batch_axes=("data",), eos_id: int | None = None,
                    device="cuda"):
    """The static-batch loop: batched prefill + one decode_step (and one
    host sync) per token, full max_new_tokens always decoded, EOS masked
    post hoc. ``rng``: an int seed or a ``torch.Generator`` (its seed);
    None is seed 0."""
    if mesh is not None:
        raise NotImplementedError(
            "generate_legacy on a mesh is not ported yet (ROADMAP Queue A "
            "item 11, 'Distributed')")
    lm.check_supported(cfg)
    dev = resolve_device(device)
    tokens = torch.as_tensor(np.asarray(batch["tokens"]), device=dev)
    b, s = tokens.shape
    max_len = max_len or (s + max_new_tokens)
    gen = None
    if temperature > 0:
        gen = torch.Generator(device=dev).manual_seed(sampling.seed_of(rng))
    logits, cache = lm.prefill(params, cfg, {"tokens": tokens}, max_len)
    out = []
    for _ in range(max_new_tokens):
        if gen is not None:
            probs = torch.softmax(logits.float() / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=gen)[:, 0]
        else:
            tok = torch.argmax(logits, dim=-1)
        tok = tok.to(torch.int32)
        out.append(tok.cpu().numpy())
        logits, cache = lm.decode_step(params, cfg, tok[:, None], cache)
    gen_toks = np.stack(out, axis=1)
    if eos_id is not None:
        # zero out everything after the first EOS per row
        ended = np.cumsum(gen_toks == eos_id, axis=1) > 0
        ended = np.concatenate([np.zeros((b, 1), bool), ended[:, :-1]],
                               axis=1)
        gen_toks = np.where(ended, 0, gen_toks)
    return gen_toks
