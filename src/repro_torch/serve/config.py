"""``ServeConfig`` — the validated serving-side configuration.

A copy of the JAX package's ``serve/config.py``: the same fields and the
same validation. ``mesh`` alone raises ``NotImplementedError`` after
validation, naming the ROADMAP item that ports it (Queue A item 11,
'Distributed'). ``rng`` is the base seed of the sampling streams: an int,
a ``torch.Generator`` (its seed is used) or None (seed 0).

``ServeEngine(cfg, params, serve_cfg)`` consolidates what used to be ~18
loose keyword arguments into one dataclass, validated once at
construction (``__post_init__``) instead of failing piecemeal deep inside
the engine: power-of-two chunk/bucket shapes, layered features that
require the paged layout (prefix cache, preemption, prefix-aware
admission), and page/bucket divisibility for the prefix path. Model-
family-dependent checks (which families can page, bucket, or chunk) stay
in the engine where the family is known.

Only serving policy lives here — the model config (``ModelConfig``) and
params stay separate positional arguments: one ``ServeConfig`` is reused
across checkpoints and archs in eval sweeps.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable

_ADMISSION_POLICIES = ("fcfs", "prefix_aware")


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(eq=False)
class ServeConfig:
    """Serving configuration for ``ServeEngine`` (see module docstring).

    Capacity: ``max_len`` (cache positions per request), ``num_slots``
    (concurrent residents). Decoding: ``eos_id``/``pad_id``/
    ``decode_chunk``/``temperature``/``rng``. Placement: ``mesh``/
    ``batch_axes``. KV layout: ``kv_layout`` + ``page_size``/``num_pages``
    (paged pool sizing). Prefill: ``prefill_chunk`` (chunked),per-bucket
    ``min_bucket``, ``prefill_rows`` (rows per bucketed/grouped call).
    Layered features: ``prefix_cache``/``prefix_cache_pages`` (radix
    tree), ``preempt``, ``on_complete``/``stream_out`` (background
    stream-out of ``Completion`` records). Scheduling: ``admission``
    ("fcfs" keeps strict arrival order; "prefix_aware" may admit a queued
    request early when its cached prefix pages sit at the LRU eviction
    frontier, bounded by ``admission_max_skips`` bypasses per waiting
    request), ``admission_frontier_pages`` (frontier depth; default
    2x pages-per-request). Persistence: ``prefix_store`` (a server-level
    ``PrefixStore`` the engine adopts warm pages from and hands its radix
    tree to at ``close()``).
    """

    max_len: int
    num_slots: int
    eos_id: int | None = None
    pad_id: int = 0
    decode_chunk: int = 8
    temperature: float = 0.0
    rng: Any = None
    mesh: Any = None
    batch_axes: tuple = ("data",)
    kv_layout: str = "dense"
    page_size: int = 16
    num_pages: int | None = None
    prefill_chunk: int = 0
    min_bucket: int = 16
    prefill_rows: int = 1
    prefix_cache: bool = False
    prefix_cache_pages: int | None = None
    preempt: bool = False
    on_complete: Callable | None = None
    stream_out: bool = True
    admission: str = "fcfs"
    admission_max_skips: int = 4
    admission_frontier_pages: int | None = None
    prefix_store: Any = None
    extra: dict = field(default_factory=dict)

    def __post_init__(self):
        self.max_len = int(self.max_len)
        self.num_slots = int(self.num_slots)
        if self.max_len < 1:
            raise ValueError(f"max_len must be >= 1, got {self.max_len}")
        if self.num_slots < 1:
            raise ValueError(f"num_slots must be >= 1, got {self.num_slots}")
        if self.prefill_rows < 1:
            raise ValueError(
                f"prefill_rows must be >= 1, got {self.prefill_rows}")
        if self.decode_chunk < 1:
            raise ValueError(
                f"decode_chunk must be >= 1, got {self.decode_chunk}")
        if self.temperature < 0:
            raise ValueError(
                f"temperature must be >= 0, got {self.temperature}")
        if self.kv_layout not in ("dense", "paged"):
            raise ValueError(f"kv_layout must be 'dense' or 'paged', "
                             f"got {self.kv_layout!r}")
        if self.page_size < 1:
            raise ValueError(f"page_size must be >= 1, got {self.page_size}")
        if self.num_pages is not None and int(self.num_pages) < 1:
            raise ValueError(f"num_pages must be >= 1 (or None for full "
                             f"capacity), got {self.num_pages}")
        # pow2 shape checks: chunked prefill tiles pow2 buckets, and the
        # prefix path builds pow2 suffix chunks/scratches — non-pow2 values
        # would mint a compile key per odd shape
        if self.prefill_chunk and not _is_pow2(self.prefill_chunk):
            raise ValueError(f"prefill_chunk must be a power of two "
                             f"(got {self.prefill_chunk}) so chunk shapes "
                             f"tile the pow2 buckets")
        if not _is_pow2(self.min_bucket):
            raise ValueError(f"min_bucket must be a power of two, "
                             f"got {self.min_bucket}")
        # layered features require the paged pool
        if self.prefix_cache and self.kv_layout != "paged":
            raise ValueError(
                "prefix_cache=True requires kv_layout='paged': page "
                "aliasing needs the shared pool (dense rows cannot be "
                "shared between slots)")
        if self.preempt and self.kv_layout != "paged":
            raise ValueError(
                "preempt=True requires kv_layout='paged' with a page pool "
                "(preemption frees and re-acquires pages; the dense layout "
                "has nothing to reclaim)")
        if self.prefix_cache:
            if not _is_pow2(self.page_size):
                raise ValueError(
                    f"prefix_cache=True requires a power-of-two page_size "
                    f"(got {self.page_size}): suffix starts are page-"
                    f"aligned and must tile the pow2 prefill buckets")
            if (self.min_bucket % self.page_size
                    and self.page_size % self.min_bucket):
                raise ValueError(
                    f"prefix_cache=True requires min_bucket and page_size "
                    f"to divide one another (got min_bucket="
                    f"{self.min_bucket}, page_size={self.page_size}) so "
                    f"page-aligned suffix starts land on bucket-tileable "
                    f"boundaries")
        if self.admission not in _ADMISSION_POLICIES:
            raise ValueError(f"admission must be one of "
                             f"{_ADMISSION_POLICIES}, got {self.admission!r}")
        if self.admission == "prefix_aware" and not self.prefix_cache:
            raise ValueError(
                "admission='prefix_aware' requires prefix_cache=True: the "
                "policy schedules around the radix tree's LRU eviction "
                "frontier")
        if self.admission_max_skips < 1:
            raise ValueError(f"admission_max_skips must be >= 1, "
                             f"got {self.admission_max_skips}")
        if (self.admission_frontier_pages is not None
                and self.admission_frontier_pages < 1):
            raise ValueError(f"admission_frontier_pages must be >= 1 (or "
                             f"None for the default), got "
                             f"{self.admission_frontier_pages}")
        if self.prefix_store is not None and not self.prefix_cache:
            raise ValueError(
                "prefix_store requires prefix_cache=True: the store "
                "persists the radix tree (and its pages) across engines")
        self.batch_axes = tuple(self.batch_axes)
        _reject_unported(self)


def _reject_unported(c: ServeConfig) -> None:
    """A mesh (the reference's sharded serving) raises instead of running
    on one device."""
    if c.mesh is not None:
        raise NotImplementedError(
            "ServeConfig mesh is not ported to PyTorch yet (ROADMAP Queue A "
            "item 11, 'Distributed'); the port serves on one device")
