"""Continuous-batching serve engine: slot KV cache, paged pool, bucketed
prefill, greedy decoding (port of the JAX package's ``serve/engine.py`` for
dense GQA/MHA configs).

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

Prefill is prompt-length bucketed: prompts are right-padded to the smallest
bucket in {min_bucket, 2*min_bucket, ..., max_len} and admitted in fixed
``[prefill_rows, bucket]`` batches whose pad rows carry the out-of-range slot
``num_slots`` and drop (``lm.prefill`` gathers each row's logits at its true
``lengths - 1``).

``stats`` counts, with the reference's meanings: ``decode_chunks`` (chunk
dispatches), ``decode_steps`` (emitted decode positions, including a
terminal EOS — not ``chunks * decode_chunk``), ``prefills`` /
``prefill_tokens``, ``admitted`` / ``completed`` and ``backpressure``; the
prefix-cache, preemption and chunked-prefill counters stay 0 until those
features are ported. Sampling, the prefix cache, preemption, chunked
prefill, stream-out and meshes are not ported yet (``ServeConfig`` raises).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.device import resolve_device
from repro_torch.models import lm
from repro_torch.serve.config import ServeConfig
from repro_torch.serve.pages import PageAllocator, PoolExhausted, pages_for
from repro_torch.serve.results import Completion, RunResult, TokenBatch
from repro_torch.serve.scheduler import FCFSScheduler, Request


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
    admission pass + one decode chunk)."""

    def __init__(self, cfg: ModelConfig, params: dict,
                 serve_cfg: ServeConfig, *, device="cuda"):
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
        self.scheduler = FCFSScheduler()

        # idle slots are inert: finished, fed pad tokens
        self.finished = torch.ones((self.num_slots,), dtype=torch.bool,
                                   device=self.device)
        self.last_tok = torch.full((self.num_slots,), self.pad_id,
                                   dtype=torch.int32, device=self.device)
        self._slot_req: list[Request | None] = [None] * self.num_slots
        self._out: dict[int, list[int]] = {}      # uid -> emitted tokens
        self._left: dict[int, int] = {}           # uid -> remaining budget
        self._first_step: dict[int, int] = {}     # uid -> admission step
        self._closed = False
        self.clock = 0                            # admission step counter
        self.stats = {"decode_chunks": 0, "decode_steps": 0, "prefills": 0,
                      "prefill_chunks": 0, "admitted": 0, "completed": 0,
                      "backpressure": 0, "preempted": 0, "prefix_hits": 0,
                      "prefix_pages_shared": 0, "prefill_tokens": 0}

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
        self.scheduler.submit(req)

    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self._slot_req) if r is None]

    @property
    def num_active(self) -> int:
        return sum(r is not None for r in self._slot_req)

    def _bucket_for(self, n: int) -> int:
        for b in self.prefill_buckets:
            if n <= b:
                return b
        raise ValueError(f"prompt length {n} exceeds the largest bucket "
                         f"{self.prefill_buckets[-1]} (max_len)")

    def _group_key(self, req: Request) -> int:
        return self._bucket_for(req.prompt_len)

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

    def _complete(self, slot: int, completed: list) -> None:
        req = self._slot_req[slot]
        self._slot_req[slot] = None
        self.stats["completed"] += 1
        toks = np.asarray(self._out.pop(req.uid), np.int32)
        self._left.pop(req.uid, None)
        eos_hit = (self.eos_id is not None and toks.size
                   and int(toks[-1]) == self.eos_id)
        completed.append(Completion(
            uid=req.uid, tokens=toks,
            finish_reason="eos" if eos_hit else "length",
            arrival=float(req.arrival),
            first_token_step=int(self._first_step.pop(req.uid, self.clock)),
            done_step=int(self.clock)))
        if self._alloc is not None:
            self._alloc.free(slot)
            self._mirror_pages()

    # ----------------------------------------------------------- admission

    def _post_admit(self, group, slot_ids, tok0, completed) -> None:
        tok0 = np.asarray(tok0)[:len(group)]
        self.stats["admitted"] += len(group)
        for req, slot, t in zip(group, slot_ids, tok0):
            self._slot_req[slot] = req
            self._first_step.setdefault(req.uid, self.clock)
            self._out[req.uid] = [int(t)]
            self._left[req.uid] = req.max_new_tokens - 1
            if ((self.eos_id is not None and int(t) == self.eos_id)
                    or self._left[req.uid] == 0):
                self._complete(slot, completed)

    def _bucket_batch(self, group, slot_ids, rows):
        """Pad a bucketed admission group to ``rows`` rows: [rows, bucket]
        tokens, [rows] lengths/slots (pad rows -> out-of-range slot)."""
        bucket = self._bucket_for(max(r.prompt_len for r in group))
        tokens = np.full((rows, bucket), self.pad_id, np.int32)
        lengths = np.zeros((rows,), np.int32)
        for i, r in enumerate(group):
            tokens[i, :r.prompt_len] = r.tokens
            lengths[i] = r.prompt_len
        slots = np.asarray(list(slot_ids) + [self.num_slots]
                           * (rows - len(group)), np.int32)
        return bucket, tokens, lengths, slots

    def _reserve_pages(self, group, free) -> list[Request]:
        """Admission backpressure: allocate pages FCFS; the first request
        that does not fit (and everything behind it) goes back to the queue
        head. Returns the admissible prefix."""
        if self._alloc is None:
            return group
        fit = 0
        for r, slot in zip(group, free):
            need = pages_for(r.prompt_len + r.max_new_tokens, self.page_size)
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

    def _admit_batch(self, bucket, tokens, lengths, slots) -> np.ndarray:
        """Prefill one [rows, bucket] batch, insert it into the slots,
        take each row's first (greedy) token and set the slots' decode
        state. Pad rows carry slot ``num_slots`` and drop."""
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
        tok0 = torch.argmax(logits, dim=-1).to(torch.int32)
        keep = torch.as_tensor(slots < self.num_slots, device=dev)
        idx = torch.as_tensor(slots[slots < self.num_slots],
                              device=dev).long()
        self.last_tok[idx] = tok0[keep]
        fin0 = (tok0 == self.eos_id if self.eos_id is not None
                else torch.zeros_like(tok0, dtype=torch.bool))
        self.finished[idx] = fin0[keep]
        return tok0.cpu().numpy()

    def _admit_bucketed(self, group, slot_ids, completed) -> None:
        """Prefill the group in fixed [prefill_rows, bucket] batches."""
        rows = self.prefill_rows
        for i in range(0, len(group), rows):
            sub, sids = group[i:i + rows], slot_ids[i:i + rows]
            bucket, tokens, lengths, slots = self._bucket_batch(sub, sids,
                                                                rows)
            tok0 = self._admit_batch(bucket, tokens, lengths, slots)
            self.stats["prefills"] += 1
            self.stats["prefill_tokens"] += int(lengths.sum())
            self._post_admit(sub, sids, tok0, completed)

    def _admission(self, completed) -> None:
        """Admit runnable groups into free slots until slots, pages or the
        queue run out."""
        while True:
            free = self._free_slots()
            if not free:
                return
            group = self.scheduler.next_group(len(free), now=self.clock,
                                              key=self._group_key)
            if not group:
                return
            admitted = self._reserve_pages(group, free)
            if not admitted:
                return  # pool pressure: wait for residents to free pages
            self._admit_bucketed(admitted, free[:len(admitted)], completed)
            if len(admitted) < len(group):
                return  # backpressured tail is back at the queue head

    # ---------------------------------------------------------------- step

    def _decode_chunk(self) -> np.ndarray:
        """``decode_chunk`` greedy decode steps over every slot with the
        finished flags on the device; one host sync at the end. Returns the
        tokens [num_slots, decode_chunk]."""
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
        return torch.stack(toks, dim=1).cpu().numpy()

    def step(self) -> list[Completion]:
        """One engine step: admit every runnable group into free slots, then
        run one decode chunk (a single host sync). Returns a ``Completion``
        per request finished this step."""
        if self._closed:
            raise RuntimeError("ServeEngine is closed")
        completed: list[Completion] = []
        self._admission(completed)
        if self.num_active:
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
        self.clock += 1
        return completed

    def run(self, requests=()) -> RunResult:
        """Submit ``requests`` and drive steps until queue and slots drain.
        Returns a ``RunResult``: {uid: generated tokens (ending at EOS if
        hit)} with the ``Completion`` records on ``.completions``."""
        for r in requests:
            self.submit(r)
        comps: dict[int, Completion] = {}
        while self.scheduler.pending or self.num_active:
            for c in self.step():
                comps[c.uid] = c
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
        """Tear down the engine (idempotent; it must be drained).
        ``step``/``submit`` raise afterwards."""
        if self._closed:
            return
        if self.num_active or self.scheduler.pending:
            raise RuntimeError(
                f"close() on a busy engine: {self.num_active} residents, "
                f"{self.scheduler.pending} queued — drain with run()/step() "
                f"first")
        self._closed = True
