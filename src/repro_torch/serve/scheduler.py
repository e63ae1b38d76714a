"""Request queue + slot admission policy for the continuous-batching engine
(port of the JAX package's ``serve/scheduler.py``; host code, no JAX).

FCFS with same-shape grouping: ``next_group`` hands the engine the longest
run of *consecutive* head-of-queue requests that share a group key (by
default the prompt signature) and have arrived by ``now``, capped by the
number of free slots, so admission stays first-come-first-served while
same-key prompts prefill together.

``AdmissionPolicy`` is the seam for admitting OUT of arrival order: the
policy picks which admissible request pivots the next group (default: the
head, i.e. strict FCFS). ``PrefixAwareAdmission`` uses it to rescue
requests whose cached prefix pages sit at the radix tree's LRU eviction
frontier — admitting them before their pages are evicted converts a
would-be full prefill into page aliasing. Reordering is bounded: each
waiting request can be bypassed at most ``max_skips`` times, after which
the policy is forced back to FCFS until that request drains — no
starvation. Because the engine keys each request's sampling stream by its
uid (not the slot or admission step), admission order never changes token
outputs.
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

    def signature(self) -> tuple:
        """Requests with equal signatures can share one prefill call."""
        ex = tuple(sorted((k, np.asarray(v).shape) for k, v in self.extras.items()))
        return (self.prompt_len, ex)


class AdmissionPolicy:
    """Chooses which admissible request pivots the next admission group.

    ``pick`` receives the window of queued requests whose ``arrival <=
    now`` (in queue order) and returns the index of the request the next
    group should form around; the scheduler pops that request plus the
    consecutive same-key run behind it. The base policy returns 0 —
    strict FCFS, bit-identical to a policy-less scheduler. ``on_admit``
    observes every admission (admitted group + the requests it jumped
    over) so stateful policies can enforce fairness bounds.
    """

    def pick(self, window: list[Request], now: float) -> int:
        return 0

    def on_admit(self, admitted: list[Request],
                 bypassed: list[Request]) -> None:
        pass


class PrefixAwareAdmission(AdmissionPolicy):
    """Admit a queued request early when its cached prefix is about to die.

    ``matched_pages(req)`` -> set of radix-cache page ids the request's
    prompt currently matches (a read-only lookup — no LRU touch);
    ``frontier_pages()`` -> the page ids at the tree's LRU eviction
    frontier (the next candidates to be evicted). A request whose match
    intersects the frontier is admitted ahead of FCFS order so its pages
    are re-pinned (aliased, refcounted) before eviction reclaims them.

    Fairness: every bypassed request's skip count is bumped; once any
    waiting request reaches ``max_skips`` the policy returns to strict
    FCFS until that request has been admitted. A bypassed request never
    moves backward in the queue and reordering only happens within the
    first ``max_window`` admissible requests, so each request is bypassed
    at most ``max_skips`` times before it drains — the starvation bound.
    """

    def __init__(self, matched_pages, frontier_pages, *,
                 max_skips: int = 4, max_window: int = 16):
        if max_skips < 1:
            raise ValueError(f"max_skips must be >= 1, got {max_skips}")
        self.matched_pages = matched_pages
        self.frontier_pages = frontier_pages
        self.max_skips = int(max_skips)
        self.max_window = int(max_window)
        self._skips: dict[int, int] = {}
        self.stats = {"bypass_admissions": 0, "bypassed": 0,
                      "aging_forced": 0}

    def pick(self, window: list[Request], now: float) -> int:
        if len(window) <= 1:
            return 0
        window = window[:self.max_window]
        # aging cap: once anyone has been skipped to the limit, fall back
        # to strict FCFS until the queue drains past them
        if any(self._skips.get(r.uid, 0) >= self.max_skips for r in window):
            self.stats["aging_forced"] += 1
            return 0
        frontier = self.frontier_pages()
        if not frontier:
            return 0
        for i, r in enumerate(window):
            if self.matched_pages(r) & frontier:
                return i
        return 0

    def on_admit(self, admitted: list[Request],
                 bypassed: list[Request]) -> None:
        if bypassed:
            self.stats["bypass_admissions"] += 1
            self.stats["bypassed"] += len(bypassed)
            for r in bypassed:
                self._skips[r.uid] = self._skips.get(r.uid, 0) + 1
        for r in admitted:
            self._skips.pop(r.uid, None)


class FCFSScheduler:
    """First-come-first-served queue with consecutive same-shape grouping.

    An optional ``AdmissionPolicy`` may pivot admission away from the
    head (see module docstring); with ``policy=None`` the scheduler is
    strict FCFS.
    """

    def __init__(self, policy: AdmissionPolicy | None = None):
        self._q: deque[Request] = deque()
        self.policy = policy

    def __len__(self) -> int:
        return len(self._q)

    @property
    def pending(self) -> int:
        return len(self._q)

    def submit(self, req: Request) -> None:
        self._q.append(req)

    def next_arrival(self) -> float | None:
        """Arrival step of the head request (None if the queue is empty)."""
        return self._q[0].arrival if self._q else None

    def push_front(self, reqs) -> None:
        """Return ``reqs`` (in order) to the HEAD of the queue — admission
        backpressure puts un-admittable requests back without losing their
        FCFS position."""
        for r in reversed(list(reqs)):
            self._q.appendleft(r)

    def next_group(self, free_slots: int, now: float = float("inf"),
                   key=None) -> list[Request]:
        """Pop up to ``free_slots`` consecutive requests sharing one group
        key, pivoted at the request the admission policy picks (the head
        under strict FCFS), all with ``arrival <= now``. ``key`` (Request
        -> hashable) defaults to ``Request.signature`` (exact prompt
        shape); the bucketed engine passes a coarser
        bucket-of-prompt-length key so mixed-length prompts batch into one
        prefill."""
        keyf = key if key is not None else (lambda r: r.signature())
        if free_slots <= 0 or not self._q or self._q[0].arrival > now:
            return []
        start = 0
        if self.policy is not None:
            window = []
            for r in self._q:
                if r.arrival > now:
                    break
                window.append(r)
            start = self.policy.pick(window, now)
            if not 0 <= start < len(window):
                start = 0
        sig = keyf(self._q[start])
        bypassed = list(self._q)[:start]
        group: list[Request] = [self._q[start]]
        del self._q[start]
        while len(self._q) > start and len(group) < free_slots:
            r = self._q[start]
            if r.arrival > now or keyf(r) != sig:
                break
            group.append(r)
            del self._q[start]
        if self.policy is not None:
            self.policy.on_admit(group, bypassed)
        return group
