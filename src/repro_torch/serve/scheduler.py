"""Request queue for the continuous-batching engine (port of ``Request`` and
``FCFSScheduler`` from the JAX package's ``serve/scheduler.py``; the
``AdmissionPolicy`` seam and ``PrefixAwareAdmission`` come with the prefix
cache, ROADMAP Queue A 'Full serving stack').

FCFS with same-key grouping: ``next_group`` hands the engine the longest run
of *consecutive* head-of-queue requests that share a group key and have
arrived by ``now``, capped by the number of free slots, so admission stays
first-come-first-served while same-bucket prompts prefill together.
"""
from __future__ import annotations

from collections import deque
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Request:
    """One generation request.

    ``tokens``: the prompt, [S] int32 (no batch dim). ``extras`` carries
    per-request model inputs of other families (none for the dense family).
    ``arrival`` is the engine step at which the request becomes admissible
    (0 = immediately).
    """

    uid: int
    tokens: np.ndarray
    max_new_tokens: int
    arrival: float = 0.0
    extras: dict = field(default_factory=dict)

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.tokens.ndim != 1 or self.tokens.shape[0] < 1:
            raise ValueError(f"request {self.uid}: tokens must be non-empty "
                             f"[S], got {self.tokens.shape}")
        if self.max_new_tokens < 1:
            raise ValueError(f"request {self.uid}: max_new_tokens must be >= 1")

    @property
    def prompt_len(self) -> int:
        return int(self.tokens.shape[0])



class FCFSScheduler:
    """First-come-first-served queue with consecutive same-key grouping."""

    def __init__(self):
        self._q: deque[Request] = deque()

    @property
    def pending(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> None:
        self._q.append(req)

    def push_front(self, reqs) -> None:
        """Return ``reqs`` (in order) to the HEAD of the queue — admission
        backpressure puts un-admittable requests back without losing their
        FCFS position."""
        for r in reversed(list(reqs)):
            self._q.appendleft(r)

    def next_group(self, free_slots: int, now: float, key) -> list[Request]:
        """Pop up to ``free_slots`` consecutive head-of-queue requests that
        share one group key (``key``: Request -> hashable; the engine's is
        the prompt-length bucket), all with ``arrival <= now``."""
        if free_slots <= 0 or not self._q or self._q[0].arrival > now:
            return []
        sig = key(self._q[0])
        group: list[Request] = [self._q.popleft()]
        while self._q and len(group) < free_slots:
            r = self._q[0]
            if r.arrival > now or key(r) != sig:
                break
            group.append(self._q.popleft())
        return group
