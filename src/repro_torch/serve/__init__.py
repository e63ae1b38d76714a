"""Serving: continuous-batching engine over a dense or paged KV cache.

The surface is ``ServeEngine(cfg, params, ServeConfig(...), device=...)``;
results come back as ``Completion`` records."""
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.pages import PageAllocator, PoolExhausted, pages_for
from repro_torch.serve.results import Completion, RunResult
from repro_torch.serve.scheduler import FCFSScheduler, Request

__all__ = ["ServeEngine", "ServeConfig", "Completion", "RunResult",
           "FCFSScheduler", "Request", "PageAllocator", "PoolExhausted",
           "pages_for"]
