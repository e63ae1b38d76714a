"""Continuous-batching serve engine: slot KV cache, paged pool, bucketed and
chunked prefill, greedy or sampled decoding, the radix prefix cache,
preemption and stream-out (port of the JAX package's ``serve/engine.py``
for dense GQA/MHA configs on one device).

The engine owns a persistent slot-based KV cache with per-slot position and
on-device finished state: requests with different prompt lengths are
admitted into free slots as others finish (continuous batching), EOS
terminates a slot on the device, and decode runs in fixed chunks of
``decode_chunk`` steps with one host sync per chunk.

Two KV layouts:

- ``kv_layout="dense"`` (default): every slot owns a ``max_len`` cache row.
- ``kv_layout="paged"``: K/V live in a shared page pool of ``num_pages``
  pages and each slot maps positions through a page table (``pages.py`` +
  ``lm.init_paged_cache``). Decode attention then goes through the
  hand-written CUDA paged-decode kernel. When the pool runs dry the engine
  admits what fits and pushes the rest back to the queue head (admission
  backpressure); a request that can never fit raises ``PoolExhausted`` at
  ``submit``.

Three optional layers ride on the paged pool:

- ``prefix_cache=True``: a host-side radix tree (``prefix_cache.py``) over
  page-granular token prefixes. Admission looks up the longest cached
  prefix, aliases those pages read-only into the new slot's table
  (refcounted, see ``pages.py``), and prefills ONLY the uncached suffix
  (``lm.prefill_chunk`` at offset ``start`` over a scratch that holds the
  aliased prefix, gathered from the pools). When the whole prompt is
  cached the last matched page is copied-on-write before the final-token
  recompute so a shared page is never written through. Completed requests
  insert their prompt pages back into the tree under an LRU cap with
  refcount-aware eviction.
- ``preempt=True``: when the pool is exhausted and the FCFS head cannot
  fit, the engine first evicts prefix-cache pages, then preempts the
  resident with the most remaining budget (strictly more than the
  admittee's) — its private pages free (shared prefix pages just decref),
  it requeues at the scheduler head carrying its already-generated tokens
  (original arrival preserved), and re-admits via the normal prefill path.
  Re-admission is token-exact against the never-preempted run: greedy
  decoding is deterministic in the context, and a sampled request's stream
  is counter-based (``sampling.py``), so its resume state is the index of
  its next token.
- ``on_complete=...``: finished sequences hand off to a background
  stream-out worker (``streamout.py``) so ``step()`` never blocks on the
  callback.

Prefill is prompt-length bucketed: prompts are right-padded to the smallest
bucket in {min_bucket, 2*min_bucket, ..., max_len} and admitted in fixed
``[prefill_rows, bucket]`` batches whose pad rows carry the out-of-range slot
``num_slots`` and drop (``lm.prefill`` gathers each row's logits at its true
``lengths - 1``). Long prefills can instead be CHUNKED (``prefill_chunk=N``):
the bucket is prefilled N tokens per engine step, interleaved between decode
chunks, so a long prompt never stalls resident decodes for its whole
prefill. With the prefix cache on, admission always takes the suffix path
(one ``[prefill_rows, chunk]`` call a group), as in the reference.

Sampling (``temperature > 0``) draws each request's tokens from its own
counter-based stream keyed by the engine's base seed (``ServeConfig.rng``)
and the request's ``uid``: a request's tokens do not depend on what shares
its batch or on preemption. At ``temperature == 0`` (the paper's eval
protocol) the decode chunk and admission issue the greedy path's device
work only; the branch is taken once, outside the step loop.

Writes the reference's JAX scatters drop (the copy-on-write of a pad row,
pad rows' slots, positions below ``start`` or at or past ``length``, table
sentinels) land on the pool's sink page (``lm.init_paged_cache``), never
through an out-of-range index.

Serving policy is one validated ``ServeConfig`` (``config.py``);
``ServeEngine(cfg, params, ServeConfig(...))`` is the surface, and the
historical ``ServeEngine(cfg, params, **kwargs)`` spelling still works
behind a ``DeprecationWarning``. Every delivery path
(``step``/``run``/``generate``/``on_complete``) hands back ``Completion``
records (``results.py``). Admission order is pluggable through
``scheduler.AdmissionPolicy`` — ``admission="prefix_aware"`` schedules
around the radix tree's LRU eviction frontier — and a server-level
``PrefixStore`` (``prefix_store.py``) carries the radix tree and the page
pools across engine instances (``close()`` hands them over; the next engine
over the same params adopts them warm).

``stats`` counts, with the reference's meanings: ``decode_chunks`` (chunk
dispatches), ``decode_steps`` (emitted decode positions, including a
terminal EOS — not ``chunks * decode_chunk``), ``prefills`` /
``prefill_chunks`` / ``prefill_tokens``, ``admitted`` / ``completed``,
``backpressure`` / ``preempted`` and ``prefix_hits`` /
``prefix_pages_shared``. The reference's LRU of compiled closures has no
counterpart: eager PyTorch compiles nothing. A mesh raises in
``ServeConfig`` (ROADMAP Queue A item 11).

Observability, as the reference's (``repro_torch.obs``): per-request
host-clock stamps at submit, admission, first token and completion, kept
across preemption (a preempted request's queue wait and TTFT are those of
its first admission; its e2e spans its whole life), feed four per-engine
histograms registered under subsystem ``serve`` (last engine wins):
``queue_wait_us``, ``ttft_us``, ``tpot_us`` (time a token after the first)
and ``e2e_us``; the gauge ``page_pool_live`` and ``engine`` (``stats``)
are registered there too. While tracing, each step emits the
``prefill_chunk``, ``admission`` and ``decode_chunk`` spans and each
completed request a lane of its own with its retroactive ``e2e`` and
``ttft`` complete events. ``stats_snapshot()`` gathers every stat surface
in one dict: ``engine``, ``latency_us``, ``pages``, ``scheduler``,
``prefix_cache`` and ``stream_out`` (the reference's keys but
``fn_cache``). None of it reads a device value: obs adds no host sync and
no launch.
"""
from __future__ import annotations

import time
import warnings

import numpy as np
import torch

from repro_torch import obs
from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve import sampling
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.pages import PageAllocator, PoolExhausted, pages_for
from repro_torch.serve.prefix_cache import PrefixCache
from repro_torch.serve.results import Completion, RunResult, TokenBatch
from repro_torch.serve.scheduler import (FCFSScheduler, PrefixAwareAdmission,
                                         Request)
from repro_torch.serve.streamout import StreamOut


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def _make_buckets(max_len: int, min_bucket: int = 16) -> tuple[int, ...]:
    """Prompt-length buckets: powers of two from ``min_bucket`` up, capped
    at ``max_len`` (the last bucket is exactly max_len)."""
    buckets, b = [], min_bucket
    while b < max_len:
        buckets.append(b)
        b *= 2
    buckets.append(max_len)
    return tuple(buckets)


def _tree_devices(tree: dict) -> set:
    out = set()
    for v in tree.values():
        out |= _tree_devices(v) if isinstance(v, dict) else {v.device}
    return out


class ServeEngine:
    """Slot-based continuous-batching engine (see the module docstring).

    ``submit`` then ``step`` drive it incrementally; ``run`` drains a whole
    request list. Arrivals are measured in engine steps (one ``step`` = one
    prefill chunk (if a job is active) + one admission pass + one decode
    chunk)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 serve_cfg: ServeConfig | None = None, *, device="cuda",
                 **kwargs):
        if serve_cfg is None:
            # deprecation shim: the historical loose-kwargs surface funnels
            # into ServeConfig (same validation, one warning); the legacy
            # on_complete contract was (uid, tokens), so wrap it
            warnings.warn(
                "ServeEngine(cfg, params, **kwargs) is deprecated; pass a "
                "ServeConfig: ServeEngine(cfg, params, ServeConfig(...)). "
                "The loose-kwargs surface will be removed next release.",
                DeprecationWarning, stacklevel=2)
            cb = kwargs.pop("on_complete", None)
            if cb is not None:
                kwargs["on_complete"] = lambda c: cb(c.uid, c.tokens)
            serve_cfg = ServeConfig(**kwargs)
        elif kwargs:
            raise TypeError(
                f"ServeEngine got both a ServeConfig and loose kwargs "
                f"{sorted(kwargs)}; fold everything into the ServeConfig")
        lm.check_supported(cfg)
        self.device = resolve_device(device)
        devs = _tree_devices(params)
        if any(d.type != self.device.type for d in devs):
            raise ValueError(f"params live on {sorted(map(str, devs))}, the "
                             f"engine runs on {self.device}")
        scfg = serve_cfg
        self.serve_cfg = scfg
        self.cfg, self.params = cfg, params
        self.max_len, self.num_slots = scfg.max_len, scfg.num_slots
        self.eos_id = scfg.eos_id
        self.pad_id = int(scfg.pad_id)
        self.decode_chunk = int(scfg.decode_chunk)
        self.temperature = float(scfg.temperature)
        self.prefill_buckets = _make_buckets(self.max_len, scfg.min_bucket)
        self.prefill_rows = min(int(scfg.prefill_rows), self.num_slots)

        self.kv_layout = scfg.kv_layout
        self.page_size = int(scfg.page_size)
        self._alloc: PageAllocator | None = None
        if scfg.kv_layout == "paged":
            pps = pages_for(self.max_len, self.page_size)
            self.num_pages = (int(scfg.num_pages)
                              if scfg.num_pages is not None
                              else self.num_slots * pps)
            self.cache = lm.init_paged_cache(
                cfg, self.num_slots, self.max_len, self.page_size,
                self.num_pages, device=self.device)
            self._alloc = PageAllocator(self.num_pages, self.num_slots, pps)
        else:
            self.cache = lm.init_cache(cfg, self.num_slots, self.max_len,
                                       device=self.device)

        self.preempt = bool(scfg.preempt)
        self._prefix: PrefixCache | None = None
        self._store = scfg.prefix_store
        self._store_key = None
        if scfg.prefix_cache:
            cap = (int(scfg.prefix_cache_pages)
                   if scfg.prefix_cache_pages is not None
                   else self.num_pages // 2)
            self._prefix = PrefixCache(self.page_size, cap,
                                       self._alloc.incref, self._alloc.decref)
            if self._store is not None:
                # adopt warm state from a previous engine over the same
                # params + pool geometry: the stored k/v pools replace the
                # freshly made ones, the stored allocator (carrying the
                # tree's page references) is re-shaped to this engine's
                # slot geometry, and the stored tree replaces the cold one
                self._store_key = self._store.key_for(
                    cfg, params, page_size=self.page_size,
                    num_pages=self.num_pages)
                state = self._store.take(self._store_key)
                if state is not None:
                    self.cache["k"], self.cache["v"] = state["k"], state["v"]
                    self._alloc = state["alloc"].resize_slots(self.num_slots,
                                                              pps)
                    tree = state["tree"]
                    # the tree's incref/decref are bound to the adopted
                    # allocator — the same object just resized
                    tree.capacity = cap
                    if len(tree) > cap:
                        tree.evict(len(tree) - cap)
                    self._prefix = tree
                    self._mirror_pages()

        self.admission_policy = None
        if scfg.admission == "prefix_aware":
            fp = (int(scfg.admission_frontier_pages)
                  if scfg.admission_frontier_pages is not None
                  else 2 * pages_for(self.max_len, self.page_size))
            self.admission_policy = PrefixAwareAdmission(
                lambda r: set(self._prefix.match(self._eff_tokens(r),
                                                 touch=False)),
                lambda: self._prefix.lru_pages(fp),
                max_skips=scfg.admission_max_skips)
        self.scheduler = FCFSScheduler(self.admission_policy)

        self._on_complete = scfg.on_complete
        self._stream: StreamOut | None = (
            StreamOut(scfg.on_complete)
            if scfg.on_complete is not None and scfg.stream_out else None)
        self.prefill_chunk = int(scfg.prefill_chunk)

        # idle slots are inert: finished, fed pad tokens
        self.finished = torch.ones((self.num_slots,), dtype=torch.bool,
                                   device=self.device)
        self.last_tok = torch.full((self.num_slots,), self.pad_id,
                                   dtype=torch.int32, device=self.device)
        # sampled decoding: each slot's stream key and the index of its
        # next token (sampling.py); none of it at temperature 0
        self._seed = sampling.seed_of(scfg.rng)
        if self.temperature > 0:
            self._skey = torch.zeros((self.num_slots,), dtype=torch.int64,
                                     device=self.device)
            self._ctr = torch.zeros_like(self._skey)

        self._slot_req: list[Request | None] = [None] * self.num_slots
        self._out: dict[int, list[int]] = {}      # uid -> emitted tokens
        self._left: dict[int, int] = {}           # uid -> remaining budget
        self._resume: dict[int, dict] = {}        # uid -> preempted state
        self._meta: dict[int, dict] = {}          # uid -> Completion fields
        self._no_preempt: set[int] = set()        # slots admitted this step
        self._job: dict | None = None             # in-flight chunked prefill
        self._closed = False
        self.clock = 0                            # admission step counter
        self.stats = {"decode_chunks": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_chunks": 0, "admitted": 0, "completed": 0,
                      "backpressure": 0, "preempted": 0, "prefix_hits": 0,
                      "prefix_pages_shared": 0, "prefill_tokens": 0}

        # per-request host-clock latency (always on: perf_counter stamps and
        # bounded histograms, no device reads), keyed by uid; the stamps
        # survive preemption so TTFT and e2e span the request's real life
        self._req_ns: dict[int, dict] = {}
        # per-ENGINE histograms (stats_snapshot() reports this instance),
        # registered last-engine-wins into the global registry
        self._h_queue_wait = obs.Histogram()
        self._h_ttft = obs.Histogram()
        self._h_tpot = obs.Histogram()
        self._h_e2e = obs.Histogram()
        for nm, h in (("queue_wait_us", self._h_queue_wait),
                      ("ttft_us", self._h_ttft), ("tpot_us", self._h_tpot),
                      ("e2e_us", self._h_e2e)):
            obs.metrics.register(nm, h, subsystem="serve")
        self._g_pages = obs.metrics.gauge("page_pool_live", subsystem="serve")
        # the stats dict alone, not the engine: the registry must not keep
        # a finished engine's KV cache alive
        stats = self.stats
        obs.metrics.register("engine", lambda: dict(stats),
                             subsystem="serve")

    # ----------------------------------------------------------- lifecycle

    def submit(self, req: Request) -> None:
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        if req.prompt_len == 0:
            raise ValueError(
                f"request {req.uid}: empty prompt — the engine needs at "
                f"least one prompt token to prefill. Prepend a BOS token "
                f"for unconditional generation.")
        if req.extras:
            raise ValueError(f"request {req.uid}: the dense family takes no "
                             f"extra inputs, got {sorted(req.extras)}")
        need = req.prompt_len + req.max_new_tokens
        if need > self.max_len:
            raise ValueError(
                f"request {req.uid} needs {need} cache positions "
                f"(prefix 0 + prompt {req.prompt_len} + "
                f"{req.max_new_tokens} new) but max_len={self.max_len}")
        if self._alloc is not None:
            np_need = pages_for(need, self.page_size)
            if np_need > self._alloc.num_pages:
                raise PoolExhausted(
                    f"request {req.uid} needs {np_need} pages "
                    f"({need} positions / page_size {self.page_size}) but "
                    f"the pool has {self._alloc.num_pages}; grow num_pages "
                    f"— waiting cannot free enough")
        # the first submit stamps the latency clock; a preempted request
        # re-entering the queue keeps its original stamps
        self._req_ns.setdefault(req.uid, {"submit": time.perf_counter_ns()})
        self.scheduler.submit(req)

    def _free_slots(self) -> list[int]:
        job = set(self._job["slot_ids"]) if self._job else ()
        return [i for i, r in enumerate(self._slot_req)
                if r is None and i not in job]

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.prefill_buckets[-1]} (max_len)")

    # Preempted requests requeue carrying their already-generated tokens:
    # the EFFECTIVE prompt at re-admission is prompt + emitted-so-far, and
    # the remaining budget is what was left at preemption. Every admission
    # site (grouping, page reservation, batching, prefill) goes through
    # these helpers so fresh and resumed requests share one code path.

    def _eff_tokens(self, req: Request) -> np.ndarray:
        res = self._resume.get(req.uid)
        return res["tokens"] if res is not None else req.tokens

    def _eff_len(self, req: Request) -> int:
        return int(self._eff_tokens(req).shape[0])

    def _budget_left(self, req: Request) -> int:
        res = self._resume.get(req.uid)
        return res["left"] if res is not None else req.max_new_tokens

    def _group_key(self, req: Request) -> int:
        return self._bucket_for(self._eff_len(req))

    def _mirror_pages(self) -> None:
        self.cache["pages"] = torch.as_tensor(self._alloc.table,
                                              device=self.device)

    def kv_cache_bytes(self) -> int:
        """Device bytes of the persistent serve cache (all leaves)."""
        return int(sum(t.numel() * t.element_size()
                       for t in self.cache.values()))

    def page_pool_stats(self) -> dict | None:
        """Allocator stats for the paged layout (None for dense)."""
        return self._alloc.stats() if self._alloc is not None else None

    def stats_snapshot(self) -> dict:
        """One nested dict of every serving stat surface (the reference's
        keys but ``fn_cache``, which has no counterpart here):

        - ``engine``: the per-engine counter dict (``self.stats``)
        - ``latency_us``: queue-wait / TTFT / time-per-output-token / e2e
          histogram summaries (count, mean, p50/p95/p99)
        - ``pages``: ``PageAllocator.stats()`` (None for the dense layout)
        - ``scheduler``: queue depth and the admission policy's counters
        - ``prefix_cache``: radix-tree occupancy (None when disabled)
        - ``stream_out``: the stream-out queue's depth (None when off)
        """
        return {
            "engine": dict(self.stats),
            "latency_us": {"queue_wait": self._h_queue_wait.summary(),
                           "ttft": self._h_ttft.summary(),
                           "tpot": self._h_tpot.summary(),
                           "e2e": self._h_e2e.summary()},
            "pages": self.page_pool_stats(),
            "scheduler": {
                "pending": int(self.scheduler.pending),
                "admission": (dict(self.admission_policy.stats)
                              if self.admission_policy is not None
                              else None),
            },
            "prefix_cache": ({"pages": len(self._prefix),
                              "capacity_pages": self._prefix.capacity}
                             if self._prefix is not None else None),
            "stream_out": ({"pending": self._stream.pending}
                           if self._stream is not None else None),
        }

    def _insert_prefix_pages(self, slot: int, tokens, covered: int) -> None:
        """Insert ``slot``'s pages for the fully-written full-page prefix of
        ``tokens`` (``covered`` positions hold valid KV) into the radix
        tree. Called BEFORE the slot's free so the pages are still live —
        the tree's incref keeps them across the decref."""
        nfull = min(int(covered), len(tokens)) // self.page_size
        if nfull:
            pages = [int(p) for p in self._alloc.table[slot, :nfull]]
            self._prefix.insert(tokens[:nfull * self.page_size], pages)

    def _complete(self, slot: int, completed: list) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self.stats["completed"] += 1
        toks = np.asarray(self._out.pop(req.uid), np.int32)
        self._left.pop(req.uid, None)
        meta = self._meta.pop(req.uid, {})
        eos_hit = (self.eos_id is not None and toks.size
                   and int(toks[-1]) == self.eos_id)
        comp = Completion(
            uid=req.uid, tokens=toks,
            finish_reason="eos" if eos_hit else "length",
            arrival=float(req.arrival),
            first_token_step=int(meta.get("first_step", self.clock)),
            done_step=int(self.clock),
            prefix_pages=int(meta.get("prefix_pages", 0)))
        completed.append(comp)
        rt = self._req_ns.pop(req.uid, None)
        if rt is not None:
            now_ns = time.perf_counter_ns()
            self._h_e2e.record((now_ns - rt["submit"]) / 1e3)
            first = rt.get("first", now_ns)
            self._h_tpot.record((now_ns - first) / 1e3
                                / max(1, len(toks) - 1))
            tr = obs.tracer()
            if tr is not None:
                # retroactive per-request spans, one lane per uid: e2e
                # (submit -> done) with the ttft head (submit -> first)
                track = f"request {req.uid}"
                tr.complete("e2e", rt["submit"], now_ns, track=track,
                            args={"uid": req.uid, "tokens": len(toks),
                                  "finish": comp.finish_reason})
                tr.complete("ttft", rt["submit"], first, track=track,
                            args={"uid": req.uid})
        if self._alloc is not None:
            if self._prefix is not None:
                self._insert_prefix_pages(slot, req.tokens, req.prompt_len)
            self._alloc.free(slot)
            self._mirror_pages()
        if self._on_complete is not None:
            if self._stream is not None:
                self._stream.put(comp)     # the worker runs the callback
            else:
                self._on_complete(comp)    # stream_out=False: inline

    # ----------------------------------------------------------- admission

    def _post_admit(self, group, slot_ids, tok0, completed) -> None:
        tok0 = np.asarray(tok0)[:len(group)]
        self.stats["admitted"] += len(group)
        now_ns = time.perf_counter_ns()
        for req, slot, t in zip(group, slot_ids, tok0):
            self._slot_req[slot] = req
            self._no_preempt.add(slot)  # just admitted: no KV written yet
            # first admission stamps first_token_step; a preempted request
            # keeps its original (its first token really was sampled then)
            self._meta.setdefault(req.uid, {"first_step": self.clock,
                                            "prefix_pages": 0})
            # first admission also takes the first token, so it stamps both
            # queue wait and TTFT (re-admission keeps the originals)
            rt = self._req_ns.setdefault(req.uid, {"submit": now_ns})
            if "first" not in rt:
                rt["first"] = now_ns
                admit = rt.setdefault("admit", now_ns)
                self._h_queue_wait.record((admit - rt["submit"]) / 1e3)
                self._h_ttft.record((now_ns - rt["submit"]) / 1e3)
            res = self._resume.pop(req.uid, None)
            if res is not None:
                self._out[req.uid] = res["emitted"] + [int(t)]
                self._left[req.uid] = res["left"] - 1
            else:
                self._out[req.uid] = [int(t)]
                self._left[req.uid] = req.max_new_tokens - 1
            if ((self.eos_id is not None and int(t) == self.eos_id)
                    or self._left[req.uid] == 0):
                self._complete(slot, completed)

    def _req_keys(self, group, rows: int) -> tuple[np.ndarray, np.ndarray]:
        """Each row's stream key and the index of its first token to draw
        here: 0 for a fresh request, the number of tokens it emitted before
        preemption for a resumed one (the stream continues exactly). Pad
        rows draw from key 0 and are discarded."""
        skey = np.zeros((rows,), np.int64)
        ctr = np.zeros((rows,), np.int64)
        for i, r in enumerate(group):
            skey[i] = sampling.stream_key(self._seed, r.uid)
            res = self._resume.get(r.uid)
            ctr[i] = len(res["emitted"]) if res is not None else 0
        return skey, ctr

    def _finish(self, slots: np.ndarray, logits, group) -> np.ndarray:
        """Shared tail of every admission: take each row's first token
        (greedy, or drawn from its stream), set the admitted slots' decode
        state, and return the tokens on the host. Pad rows carry slot
        ``num_slots`` and set nothing."""
        dev, ns = self.device, self.num_slots
        if self.temperature > 0:
            skey, ctr = self._req_keys(group, len(slots))
            tok0 = sampling.sample(logits, self.temperature,
                                   torch.as_tensor(skey, device=dev),
                                   torch.as_tensor(ctr, device=dev))
        else:
            tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        keep = torch.as_tensor(slots < ns, device=dev)
        idx = torch.as_tensor(slots[slots < ns], device=dev).long()
        self.last_tok[idx] = tok0[keep]
        fin0 = (tok0 == self.eos_id if self.eos_id is not None
                else torch.zeros_like(tok0, dtype=torch.bool))
        self.finished[idx] = fin0[keep]
        if self.temperature > 0:
            ok = slots < ns
            self._skey[idx] = torch.as_tensor(skey[ok], device=dev)
            self._ctr[idx] = torch.as_tensor(ctr[ok] + 1, device=dev)
        return tok0.cpu().numpy()

    def _bucket_batch(self, group, slot_ids, rows):
        """Pad an admission group to ``rows`` rows: [rows, bucket] tokens,
        [rows] lengths/slots (pad rows -> out-of-range slot, dropped)."""
        bucket = self._bucket_for(max(self._eff_len(r) for r in group))
        tokens = np.full((rows, bucket), self.pad_id, np.int32)
        lengths = np.zeros((rows,), np.int32)
        for i, r in enumerate(group):
            toks = self._eff_tokens(r)
            tokens[i, :len(toks)] = toks
            lengths[i] = len(toks)
        slots = np.asarray(list(slot_ids) + [self.num_slots]
                           * (rows - len(group)), np.int32)
        return bucket, tokens, lengths, slots

    def _admit_batch(self, group, bucket, tokens, lengths, slots):
        """Prefill one [rows, bucket] batch, insert it into the slots and
        take each row's first token (``_finish``)."""
        dev = self.device
        paged = self._alloc is not None
        # the paged pool takes a scratch of any length; dense slot rows are
        # max_len long
        prefill_len = bucket if paged else self.max_len
        lengths_t = torch.as_tensor(lengths, device=dev)
        logits, new_cache = lm.prefill(
            self.params, self.cfg, {"tokens": torch.as_tensor(tokens,
                                                              device=dev)},
            prefill_len, lengths=lengths_t)
        if paged:
            lm.insert_slots_paged(self.cache, new_cache, slots, lengths)
        else:
            lm.insert_slots(self.cache, new_cache, slots)
        return self._finish(slots, logits, group)

    def _admit_bucketed(self, group, slot_ids, completed) -> None:
        """Prefill the group in fixed [prefill_rows, bucket] batches."""
        rows = self.prefill_rows
        for i in range(0, len(group), rows):
            sub, sids = group[i:i + rows], slot_ids[i:i + rows]
            bucket, tokens, lengths, slots = self._bucket_batch(sub, sids,
                                                                rows)
            tok0 = self._admit_batch(sub, bucket, tokens, lengths, slots)
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += int(lengths.sum())
            self._post_admit(sub, sids, tok0, completed)

    # ------------------------------------------------- preempt-and-requeue

    def _preempt_one(self, head_left: int | None = None) -> bool:
        """Preempt the resident with the most remaining budget: free its
        private pages (shared prefix pages just decref), save its resume
        state, and requeue it at the scheduler head with its original
        arrival. Slots admitted this step are exempt — their token-0 KV is
        not written until the next decode chunk.

        Damping: when ``head_left`` (the remaining budget of the request
        being admitted) is given, only residents with STRICTLY more budget
        left are preemptible, so a requeued victim can never preempt its
        way straight back in — remaining work strictly decreases along any
        preemption chain."""
        best = None
        for slot, req in enumerate(self._slot_req):
            if req is None or slot in self._no_preempt:
                continue
            left = self._left[req.uid]
            if head_left is not None and left <= head_left:
                continue
            if best is None or left > best[0]:
                best = (left, slot)
        if best is None:
            return False
        _, slot = best
        req = self._slot_req[slot]
        emitted = self._out.pop(req.uid)
        left = self._left.pop(req.uid)
        ctx = np.concatenate([req.tokens, np.asarray(emitted, np.int32)])
        # sampled decoding resumes at token len(emitted): nothing to save
        # beyond the tokens, and nothing read back from the device
        self._resume[req.uid] = {"tokens": ctx, "emitted": emitted,
                                 "left": left}
        if self._prefix is not None:
            # positions [0, len(ctx)-1) hold valid KV (the newest emitted
            # token was sampled but not yet fed back/written) — its full
            # pages make the re-admission prefix-accelerated
            self._insert_prefix_pages(slot, ctx, len(ctx) - 1)
        self._slot_req[slot] = None
        self._alloc.free(slot)
        self._mirror_pages()
        # inert on the device (a fill, no index that syncs): no more
        # samples; its sentinel table row sends its writes to the sink
        self.finished[slot].fill_(True)
        self.scheduler.push_front([req])
        self.stats["preempted"] += 1
        return True

    def _reclaim(self, need: int, head_left: int | None = None) -> bool:
        """Make room for an admission that needs ``need`` fresh pages:
        first evict LRU prefix-cache pages (cheapest — cached KV is
        recomputable), then preempt one resident with more remaining work
        than the admittee (``_preempt_one``). Returns True if anything was
        reclaimed (the caller loops until the request fits or this gives
        up)."""
        freed = False
        if self._prefix is not None:
            short = need - self._alloc.free_pages
            if short > 0 and self._prefix.evict(short):
                freed = True
        if not self._alloc.can_allocate(need) and self.preempt:
            freed = self._preempt_one(head_left) or freed
        return freed

    def _reserve_pages(self, group, free) -> list[Request]:
        """Admission backpressure: allocate pages FCFS, reclaiming (prefix
        eviction, then preemption) when a request does not fit; the first
        request that still does not fit (and everything behind it) goes
        back to the queue head. Returns the admissible prefix."""
        if self._alloc is None:
            return group
        fit = 0
        for r, slot in zip(group, free):
            need = pages_for(self._eff_len(r) + self._budget_left(r),
                             self.page_size)
            while not self._alloc.can_allocate(need):
                if not self._reclaim(need, self._budget_left(r)):
                    break
            if not self._alloc.can_allocate(need):
                break
            self._alloc.allocate(slot, need)
            fit += 1
        if fit < len(group):
            self.scheduler.push_front(group[fit:])
            self.stats["backpressure"] += len(group) - fit
        if fit:
            self._mirror_pages()
        return group[:fit]

    # ------------------------------------------------ prefix-hit admission

    def _prefix_match_start(self, req: Request, touch: bool = True):
        """The request's radix match and its suffix start. A match is
        page-granular, so the start is page-aligned UNLESS the entire
        prompt is cached — then the final token's logits must be recomputed
        (start = len-1, mid-page) and the last matched page is duplicated
        first (copy-on-write) so the shared copy is never written."""
        eff = self._eff_tokens(req)
        length = len(eff)
        matched = self._prefix.match(eff, touch=touch)
        if matched and len(matched) * self.page_size >= length:
            return eff, length, matched, matched[:-1], int(matched[-1]), \
                length - 1
        return eff, length, matched, matched, None, \
            len(matched) * self.page_size

    def _prefix_group_key(self, req: Request) -> tuple:
        """Admission group key of the prefix path: requests sharing a
        suffix ``start`` and a prompt-length bucket prefill as ONE
        [rows, chunk] call. A pure probe — grouping must not touch the LRU
        stamps the prefix-aware policy schedules around."""
        *_, start = self._prefix_match_start(req, touch=False)
        return (start, self._bucket_for(self._eff_len(req)))

    def _admit_prefix_group(self, group, free, completed) -> bool:
        """Admit a same-start group through the radix prefix cache in one
        prefill call: alias each request's cached prefix into its slot's
        table and prefill only the uncached suffixes as a [rows, chunk]
        batch (``rows`` = prefill_rows; pad rows drop). Returns False if
        any member hit backpressure (it and everything behind it are back
        at the queue head — the caller stops admitting)."""
        ps = self.page_size
        infos = [self._prefix_match_start(r) for r in group]
        start = infos[0][-1]
        # pin every match before reclaim can evict it out from under us
        # (eviction of a tree-only page would free it for reuse); pinned
        # pages survive prefix eviction with their KV intact
        pinned = [p for (_, _, matched, *_) in infos for p in matched]
        for p in pinned:
            self._alloc.incref(p)
        admitted, slots = [], []
        try:
            for (eff, length, matched, aliased, cow_src, st), req, slot in \
                    zip(infos, group, free):
                assert st == start, "scheduler grouped mixed starts"
                budget = self._budget_left(req)
                need = pages_for(length + budget, ps)
                n_fresh = need - len(aliased)
                while not self._alloc.can_allocate(n_fresh):
                    if not self._reclaim(n_fresh, budget):
                        break
                if not self._alloc.can_allocate(n_fresh):
                    back = group[len(admitted):]
                    self.scheduler.push_front(back)
                    self.stats["backpressure"] += len(back)
                    break
                self._alloc.alias(slot, aliased, n_fresh)
                admitted.append((req, eff, length, matched, aliased,
                                 cow_src))
                slots.append(slot)
        finally:
            for p in pinned:
                self._alloc.decref(p)
        if not admitted:
            return False
        self._mirror_pages()

        rows = self.prefill_rows
        chunk = _next_pow2(max(length - start
                               for _, _, length, *_ in admitted))
        scratch_len = _next_pow2(max(max(length for _, _, length, *_
                                         in admitted), start + chunk))
        tokens = np.full((rows, chunk), self.pad_id, np.int32)
        lengths = np.zeros((rows,), np.int32)
        slot_arr = np.full((rows,), self.num_slots, np.int32)
        cow_src_arr = np.full((rows,), self.num_pages, np.int32)
        cow_dst_arr = np.full((rows,), self.num_pages, np.int32)
        suffix_total = 0
        for i, ((req, eff, length, matched, aliased, cow_src),
                slot) in enumerate(zip(admitted, slots)):
            suffix = length - start
            tokens[i, :suffix] = eff[start:]
            lengths[i] = length
            slot_arr[i] = slot
            suffix_total += suffix
            if cow_src is not None:
                cow_src_arr[i] = cow_src
                cow_dst_arr[i] = int(self._alloc.table[slot, len(aliased)])
            if matched:
                self.stats["prefix_hits"] += 1
                self.stats["prefix_pages_shared"] += len(aliased)
                meta = self._meta.setdefault(
                    req.uid, {"first_step": self.clock, "prefix_pages": 0})
                meta["prefix_pages"] += len(aliased)

        reqs = [a[0] for a in admitted]
        tok0 = self._admit_prefix_batch(scratch_len, start, tokens, slot_arr,
                                        lengths, cow_src_arr, cow_dst_arr,
                                        reqs)
        # suffix-only accounting: the aliased prefixes cost zero prefill
        # tokens, and the whole group is ONE prefill call
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += suffix_total
        self._post_admit(reqs, slots, tok0, completed)
        return len(admitted) == len(group)

    def _admit_prefix_batch(self, scratch_len, start, tokens, slots, lengths,
                            cow_src, cow_dst, group) -> np.ndarray:
        """The device half of a prefix admission, in this order: per row,
        copy-on-write the boundary page (``cow_dst == num_pages``, the
        pool's sink page, for rows without one), gather the aliased prefix
        [0, start) from the pools into a dense scratch, prefill only the
        uncached suffix chunk at offset ``start``, scatter positions
        [start, length) back through each slot's table (pages below
        ``start`` are never written), and take token 0. Pad rows carry
        slot ``num_slots``; every write of theirs lands on the sink page.
        A prefix MISS is the same call with start=0 over a zero scratch."""
        dev, cfg = self.device, self.cfg
        ps, num_pages, ns = self.page_size, self.num_pages, self.num_slots
        k_pool, v_pool = self.cache["k"], self.cache["v"]
        if (cow_dst < num_pages).any():
            src = torch.as_tensor(np.minimum(cow_src, num_pages - 1),
                                  device=dev).long()
            dst = torch.as_tensor(cow_dst, device=dev).long()
            k_pool[:, dst] = k_pool[:, src]
            v_pool[:, dst] = v_pool[:, src]
        rows = tokens.shape[0]
        shape = (cfg.num_layers, rows, scratch_len, cfg.num_kv_heads,
                 cfg.head_dim)
        scratch = {"k": torch.zeros(shape, dtype=k_pool.dtype, device=dev),
                   "v": torch.zeros(shape, dtype=v_pool.dtype, device=dev)}
        if start:
            # the table rows on the host (== the mirrored device table);
            # pad rows read slot num_slots - 1's pages, and drop below
            tbl = self._alloc.table[np.minimum(slots, ns - 1)]
            t = np.arange(start)
            page = np.clip(tbl[:, t // ps], 0, num_pages - 1)
            off = np.tile(t % ps, (len(slots), 1))
            page_t = torch.as_tensor(page, device=dev).long()
            off_t = torch.as_tensor(off, device=dev).long()
            scratch["k"][:, :, :start] = k_pool[:, page_t, off_t]
            scratch["v"][:, :, :start] = v_pool[:, page_t, off_t]
        last0 = torch.zeros((rows, cfg.padded_vocab_size),
                            dtype=torch.float32, device=dev)
        logits, scratch = lm.prefill_chunk(
            self.params, cfg, torch.as_tensor(tokens, device=dev), scratch,
            start, torch.as_tensor(lengths, device=dev), last0)
        lm.insert_slots_paged(self.cache, scratch, slots, lengths,
                              starts=start)
        return self._finish(slots, logits, group)

    # ---------------------------------------------------- chunked prefill

    def _start_job(self, group, slot_ids) -> None:
        # chunked prefill: admission starts now, the first token lands when
        # the job finalizes steps later: stamp queue wait's endpoint here
        now_ns = time.perf_counter_ns()
        for r in group:
            self._req_ns.setdefault(r.uid, {"submit": now_ns}).setdefault(
                "admit", now_ns)
        bucket, tokens, lengths, slots = self._bucket_batch(
            group, slot_ids, self.num_slots)
        scratch = lm.init_cache(self.cfg, self.num_slots, bucket,
                                device=self.device)
        self._job = {
            "group": group, "slot_ids": slot_ids, "slots": slots,
            "lengths": lengths, "tokens": tokens, "bucket": bucket,
            "scratch": {"k": scratch["k"], "v": scratch["v"]}, "start": 0,
            "last": torch.zeros((self.num_slots, self.cfg.padded_vocab_size),
                                dtype=torch.float32, device=self.device),
        }
        self.stats["prefills"] += 1
        self.stats["prefill_tokens"] += int(lengths.sum())

    def _job_step(self, completed) -> None:
        """Advance the in-flight chunked prefill by one chunk; finalize
        (insert + first token) when the bucket is fully prefilled."""
        j = self._job
        dev = self.device
        c = min(self.prefill_chunk, j["bucket"] - j["start"])
        chunk = torch.as_tensor(
            np.ascontiguousarray(j["tokens"][:, j["start"]:j["start"] + c]),
            device=dev)
        j["last"], j["scratch"] = lm.prefill_chunk(
            self.params, self.cfg, chunk, j["scratch"], j["start"],
            torch.as_tensor(j["lengths"], device=dev), j["last"])
        j["start"] += c
        self.stats["prefill_chunks"] += 1
        if j["start"] < j["bucket"]:
            return
        self._job = None
        tok0 = self._prefill_final(j)
        self._post_admit(j["group"], j["slot_ids"], tok0, completed)

    def _prefill_final(self, j) -> np.ndarray:
        """Insert a finished chunked-prefill scratch into the engine cache
        and take the first tokens."""
        lengths = torch.as_tensor(j["lengths"], device=self.device)
        scratch = {**j["scratch"], "pos": lengths.to(torch.int32)}
        if self._alloc is not None:
            lm.insert_slots_paged(self.cache, scratch, j["slots"],
                                  j["lengths"])
        else:
            pad = self.max_len - j["bucket"]
            if pad:
                widen = (0, 0, 0, 0, 0, pad)
                scratch["k"] = torch.nn.functional.pad(scratch["k"], widen)
                scratch["v"] = torch.nn.functional.pad(scratch["v"], widen)
            lm.insert_slots(self.cache, scratch, j["slots"])
        return self._finish(j["slots"], j["last"], j["group"])

    def _admission(self, completed) -> None:
        """Admit runnable groups into free slots until slots, pages or the
        queue run out. At most one chunked-prefill job is in flight; while
        one is active its slots are reserved and admission pauses. With the
        prefix cache on, groups are keyed by (suffix start, bucket) so a
        same-start group prefills as ONE [prefill_rows, chunk] call through
        the suffix path."""
        while self._job is None:
            free = self._free_slots()
            if not free:
                return
            if self._prefix is not None:
                key = self._prefix_group_key
                want = min(len(free), self.prefill_rows)
            else:
                key = self._group_key
                want = len(free)
            group = self.scheduler.next_group(want, now=self.clock, key=key)
            if not group:
                return
            if self._prefix is not None:
                if not self._admit_prefix_group(group, free, completed):
                    return  # pool pressure even after reclaim
                continue
            admitted = self._reserve_pages(group, free)
            if not admitted:
                return  # pool pressure: wait for residents to free pages
            slot_ids = free[:len(admitted)]
            bucket = self._bucket_for(max(self._eff_len(r)
                                          for r in admitted))
            if self.prefill_chunk and bucket > self.prefill_chunk:
                self._start_job(admitted, slot_ids)
            else:
                self._admit_bucketed(admitted, slot_ids, completed)
            if len(admitted) < len(group):
                return  # backpressured tail is back at the queue head

    # ---------------------------------------------------------------- step

    def _decode_chunk(self) -> np.ndarray:
        """``decode_chunk`` decode steps over every slot with the finished
        flags on the device; one host sync at the end. Returns the tokens
        [num_slots, decode_chunk]."""
        return self._decode_steps().cpu().numpy()

    def _decode_steps(self) -> torch.Tensor:
        """The device half of ``_decode_chunk``: enqueues the steps and
        returns the tokens on the device, reading nothing back."""
        if self.temperature > 0:
            return self._decode_steps_sampled()
        tok, fin = self.last_tok, self.finished
        toks = []
        for _ in range(self.decode_chunk):
            logits, self.cache = lm.decode_step(self.params, self.cfg,
                                                tok[:, None], self.cache)
            nxt = torch.argmax(logits, dim=-1).to(torch.int32)
            nxt = torch.where(fin, self.pad_id, nxt).to(torch.int32)
            if self.eos_id is not None:
                fin = fin | (nxt == self.eos_id)
            toks.append(nxt)
            tok = nxt
        self.last_tok, self.finished = tok, fin
        return torch.stack(toks, dim=1)

    def _decode_steps_sampled(self) -> torch.Tensor:
        """``_decode_steps`` drawing each slot's token from its stream at
        the slot's token index, which advances by one a step."""
        tok, fin, ctr = self.last_tok, self.finished, self._ctr
        toks = []
        for _ in range(self.decode_chunk):
            logits, self.cache = lm.decode_step(self.params, self.cfg,
                                                tok[:, None], self.cache)
            nxt = sampling.sample(logits, self.temperature, self._skey, ctr)
            ctr = ctr + 1
            nxt = torch.where(fin, self.pad_id, nxt).to(torch.int32)
            if self.eos_id is not None:
                fin = fin | (nxt == self.eos_id)
            toks.append(nxt)
            tok = nxt
        self.last_tok, self.finished, self._ctr = tok, fin, ctr
        return torch.stack(toks, dim=1)

    def step(self) -> list[Completion]:
        """One engine step: advance the chunked-prefill job (if any) by one
        chunk, admit every runnable group into free slots, then run one
        decode chunk (a single host sync). Returns a ``Completion`` per
        request finished this step."""
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        completed: list[Completion] = []
        self._no_preempt.clear()  # last step's admits have their KV by now
        if self._job is not None:
            with obs.span("prefill_chunk"):
                self._job_step(completed)
        with obs.span("admission"):
            self._admission(completed)
        if self.num_active:
            with obs.span("decode_chunk"):
                toks = self._decode_chunk()
            self.stats["decode_chunks"] += 1
            emitted = 0
            for slot in range(self.num_slots):
                req = self._slot_req[slot]
                if req is None:
                    continue
                for t in toks[slot]:
                    self._out[req.uid].append(int(t))
                    self._left[req.uid] -= 1
                    emitted += 1
                    if ((self.eos_id is not None and int(t) == self.eos_id)
                            or self._left[req.uid] == 0):
                        self._complete(slot, completed)
                        break
            self.stats["decode_steps"] += emitted
        if self._alloc is not None:
            self._g_pages.set(self._alloc.stats()["live_pages"])
        self.clock += 1
        return completed

    def run(self, requests=()) -> RunResult:
        """Submit ``requests`` and drive steps until queue and slots drain.
        Returns a ``RunResult``: {uid: generated tokens (ending at EOS if
        hit)} with the ``Completion`` records on ``.completions``."""
        for r in requests:
            self.submit(r)
        comps: dict[int, Completion] = {}
        while self.scheduler.pending or self.num_active or self._job:
            for c in self.step():
                comps[c.uid] = c
        if self._stream is not None:
            self._stream.drain()  # surface stream-out callback errors here
        return RunResult(comps)

    def generate(self, batch: dict, *, max_new_tokens: int) -> np.ndarray:
        """Static-batch convenience: decode ``batch["tokens"]`` ([B, S], B <=
        num_slots) and return [B, max_new_tokens] with ``pad_id`` after EOS;
        ``.completions`` holds the records (uid == row index)."""
        tokens = np.asarray(batch["tokens"])
        b = tokens.shape[0]
        if b > self.num_slots:
            raise ValueError(f"batch {b} > num_slots {self.num_slots}")
        res = self.run([Request(uid=i, tokens=tokens[i],
                                max_new_tokens=max_new_tokens)
                        for i in range(b)])
        out = np.full((b, max_new_tokens), self.pad_id, np.int32)
        for i in range(b):
            toks = res[i][:max_new_tokens]
            out[i, :len(toks)] = toks
        return TokenBatch.wrap(out, res.completions)

    def close(self) -> None:
        """Tear down the engine. Idempotent; the engine must be drained
        (no residents, no queue, no in-flight prefill job). With a
        ``PrefixStore`` configured, the radix tree, its page references and
        the k/v page pools are handed to the store under the existing
        refcount contract — every slot is free at this point, so the
        tree's one-ref-per-node references are exactly the pool's live
        pages — and the next engine over the same params and geometry
        adopts them warm. ``step``/``submit`` raise afterwards."""
        if self._closed:
            return
        if self.num_active or self.scheduler.pending or self._job:
            raise RuntimeError(
                f"close() on a busy engine: {self.num_active} residents, "
                f"{self.scheduler.pending} queued, job="
                f"{'yes' if self._job else 'no'} — drain with run()/step() "
                f"first")
        if self._stream is not None:
            self._stream.close()
            self._stream = None
        if self._store is not None and self._prefix is not None:
            self._store.put(self._store_key, self.params, {
                "k": self.cache["k"], "v": self.cache["v"],
                "alloc": self._alloc, "tree": self._prefix})
        self._closed = True


# ------------------------------------------------------------- public API


def generate(params, cfg: ModelConfig, batch: dict, *, max_new_tokens: int,
             max_len: int | None = None, temperature: float = 0.0, rng=None,
             mesh=None, batch_axes=("data",), eos_id: int | None = None,
             num_slots: int | None = None, decode_chunk: int = 8,
             device="cuda"):
    """Greedy (temperature=0, the paper's eval protocol) or sampled decoding.
    batch["tokens"]: [B, S_prompt]. Returns np.ndarray [B, max_new_tokens].

    Wrapper over ``ServeEngine`` — token for token identical to the static
    batch loop (``_oracle.generate_legacy``) under greedy decoding. Sampled
    decoding takes that loop, with one batch-wide generator seeded by
    ``rng`` (an int or a ``torch.Generator``'s seed) a call."""
    if temperature > 0:
        from repro_torch.serve._oracle import generate_legacy
        return generate_legacy(params, cfg, batch,
                               max_new_tokens=max_new_tokens, max_len=max_len,
                               temperature=temperature, rng=rng, mesh=mesh,
                               batch_axes=batch_axes, eos_id=eos_id,
                               device=device)
    b, s = np.asarray(batch["tokens"]).shape
    max_len = max_len or (s + max_new_tokens)
    engine = ServeEngine(cfg, params, ServeConfig(
        max_len=max_len, num_slots=num_slots or b, eos_id=eos_id,
        decode_chunk=decode_chunk, mesh=mesh, batch_axes=batch_axes),
        device=device)
    return engine.generate(batch, max_new_tokens=max_new_tokens)
