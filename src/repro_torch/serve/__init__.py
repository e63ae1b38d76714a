"""Serving subsystem: continuous-batching engine + paged KV pool + scheduler
+ radix prefix cache + admission policies + cross-engine prefix persistence
+ background stream-out.

The surface is ``ServeEngine(cfg, params, ServeConfig(...), device=...)``;
results come back as ``Completion`` records. The static-batch loop
(``generate_legacy``) is a test/parity module — import it from
``repro_torch.serve._oracle`` if you need the oracle. The reference's
compiled-fn cache (``fn_cache_info``, ``set_fn_cache_limit``,
``clear_fn_cache``) has no counterpart: eager PyTorch compiles nothing."""
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.engine import ServeEngine, generate
from repro_torch.serve.pages import PageAllocator, PoolExhausted, pages_for
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.prefix_store import PrefixStore
from repro_torch.serve.results import Completion, RunResult
from repro_torch.serve.scheduler import (AdmissionPolicy, FCFSScheduler,
                                         PrefixAwareAdmission, Request)
from repro_torch.serve.streamout import StreamOut

__all__ = ["ServeEngine", "ServeConfig", "Completion", "RunResult",
           "FCFSScheduler", "AdmissionPolicy", "PrefixAwareAdmission",
           "Request", "generate", "PageAllocator", "PoolExhausted",
           "pages_for", "PrefixCache", "PrefixStore", "StreamOut"]
