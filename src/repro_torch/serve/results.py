"""Unified serve-engine result types.

A copy of the JAX package's ``serve/results.py``.

Every delivery surface of the engine hands back the same ``Completion``
record: ``step()`` returns a list of them, ``run()`` returns a
``RunResult`` (a ``{uid: tokens}`` dict view carrying the full records on
``.completions``), ``engine.generate`` returns a token array whose
``.completions`` attribute holds them, and ``on_complete`` callbacks
receive one per finished request. Before this, the three surfaces used
three conventions ((uid, tokens) tuples, a plain dict, a bare array) and
per-request metadata (finish reason, queueing delay, prefix reuse) was
unobservable without scraping engine internals.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True)
class Completion:
    """One finished request.

    ``tokens``: the emitted tokens ([n] i32, ends at EOS if hit).
    ``finish_reason``: ``"eos"`` (terminated on the EOS token) or
    ``"length"`` (exhausted ``max_new_tokens``).
    ``arrival``: the request's arrival step; ``first_token_step`` the
    engine step at which it was admitted (its first token sampled) — the
    difference is the queueing delay; ``done_step`` the step it finished.
    ``prefix_pages``: radix-cache pages aliased instead of prefilled
    across this request's admission(s) (0 with the prefix cache off).
    """

    uid: int
    tokens: np.ndarray
    finish_reason: str
    arrival: float
    first_token_step: int
    done_step: int
    prefix_pages: int = 0


class RunResult(dict):
    """``ServeEngine.run``'s return value: a ``{uid: tokens}`` mapping
    (the historical contract — existing callers index/iterate it
    unchanged) with the full per-request records on ``.completions``."""

    def __init__(self, completions: dict[int, Completion]):
        super().__init__({uid: c.tokens for uid, c in completions.items()})
        self.completions = completions


class TokenBatch(np.ndarray):
    """``engine.generate``'s return value: the historical
    ``[B, max_new_tokens]`` token array, with the per-request
    ``Completion`` records attached as ``.completions`` (uid == row)."""

    completions: dict[int, Completion] | None = None

    @classmethod
    def wrap(cls, tokens: np.ndarray,
             completions: dict[int, Completion]) -> "TokenBatch":
        out = np.asarray(tokens).view(cls)
        out.completions = completions
        return out

    def __array_finalize__(self, obj):
        if obj is not None:
            self.completions = getattr(obj, "completions", None)
