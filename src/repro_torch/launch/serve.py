"""Serving launcher of the PyTorch port: the continuous-batching engine over a
(smoke or full-width) model with random weights from a seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-0.5b \
      --kv-layout paged [--smoke] [--device cuda]

``--arch`` takes qwen2.5-0.5b, llama3.2-1b, phi4-mini-3.8b, chatglm3-6b,
yi-9b or qwen2.5-32b (on one H100 at full width too: ``chip_smoke.py``
phase 36 serves the last three). Mirrors the
flags of the JAX package's ``launch/serve.py``: ``--prefill-chunk`` (chunked
prefill width), ``--prefix-cache`` (the radix prefix cache; the demo batch
then shares row 0's first half so hits are observable), ``--preempt``
(preempt-and-requeue when the page pool is exhausted), ``--admission``
(``prefix_aware`` admits queued requests early when their cached prefix
pages sit at the LRU eviction frontier) and ``--persist-prefix`` (a
``PrefixStore`` keeps the radix tree across engine instances, so the timed
pass prefills suffix-only). ``--trace t.json`` writes a Chrome trace-event
file (ui.perfetto.dev) with the admission, prefill and decode spans and one
lane a request with its ``ttft`` and ``e2e``; ``--metrics-json m.json``
the obs registry's snapshot (``python -m repro_torch.launch.inspect
m.json`` renders it). ``--fn-cache-limit`` has no counterpart (eager
PyTorch compiles nothing). Reports the first (warmup) pass — which builds
the kernels — and the steady-state tok/s of a second pass separately,
then the engine's ``stats_snapshot()`` and the kernels' launch counts of
the timed pass.
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--new-tokens", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--decode-chunk", type=int, default=8)
    ap.add_argument("--kv-layout", choices=["dense", "paged"],
                    default="dense")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=0,
                    help="page-pool size (0 = full dense capacity)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill width (0 = single-shot)")
    ap.add_argument("--prefill-rows", type=int, default=1,
                    help="rows per bucketed prefill batch")
    ap.add_argument("--prefix-cache", action="store_true",
                    help="radix prefix cache over the page pool "
                         "(requires --kv-layout paged)")
    ap.add_argument("--preempt", action="store_true",
                    help="preempt-and-requeue when the page pool is "
                         "exhausted (requires --kv-layout paged)")
    ap.add_argument("--admission", choices=["fcfs", "prefix_aware"],
                    default="fcfs",
                    help="admission order: prefix_aware admits queued "
                         "requests early when their cached prefix pages "
                         "sit at the LRU eviction frontier")
    ap.add_argument("--persist-prefix", action="store_true",
                    help="keep the radix tree in a PrefixStore across "
                         "engine instances (the second launcher pass then "
                         "prefills suffix-only)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--trace", default="",
                    help="export a Chrome trace-event JSON (ui.perfetto.dev)"
                         " with admission/prefill/decode spans and "
                         "per-request ttft/e2e lanes")
    ap.add_argument("--metrics-json", default="",
                    help="write the obs registry snapshot to this path")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch import obs
    obs_on = bool(args.trace or args.metrics_json)
    if obs_on:
        obs.enable(selection=False)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import PrefixStore, ServeConfig, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init(cfg, gen, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len),
                                    dtype=np.int32)}
    if args.prefix_cache:
        # shared-prefix traffic so radix hits are observable: every row
        # reuses row 0's first half (page-aligned for typical page sizes)
        half = args.prompt_len // 2
        batch["tokens"][:, :half] = batch["tokens"][0, :half]
    store = PrefixStore() if args.persist_prefix else None
    serve_cfg = ServeConfig(
        max_len=args.prompt_len + args.new_tokens, num_slots=args.batch,
        temperature=args.temperature, rng=args.seed + 1,
        decode_chunk=args.decode_chunk,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_pages=args.num_pages or None,
        prefill_chunk=args.prefill_chunk, prefill_rows=args.prefill_rows,
        prefix_cache=args.prefix_cache, preempt=args.preempt,
        admission=args.admission, prefix_store=store)

    def one_pass(close=False):
        engine = ServeEngine(cfg, params, serve_cfg, device=dev)
        out = engine.generate(batch, max_new_tokens=args.new_tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        if close:
            # with --persist-prefix this hands the radix tree to the store,
            # so the next pass's engine adopts it warm
            engine.close()
        return out, engine

    # warmup: builds the kernels and warms the allocator at the same shapes
    t0 = time.perf_counter()
    one_pass(close=True)
    t_warm = time.perf_counter() - t0

    ops.reset_launches()
    t0 = time.perf_counter()
    out, engine = one_pass()
    dt = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    tps = args.batch * args.new_tokens / dt
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain PyTorch path)")
    print(f"device: {where}")
    print(f"warmup (first pass, kernel builds included): {t_warm:.2f}s")
    print(f"steady state: generated {out.shape} in {dt:.3f}s "
          f"({tps:.1f} tok/s)")
    if args.prefix_cache:
        # second wave on the SAME engine: the first wave populated the radix
        # tree, so every re-sent prompt aliases its cached pages and
        # prefills only the copy-on-write tail token
        t0 = time.perf_counter()
        engine.generate(batch, max_new_tokens=args.new_tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        dt2 = time.perf_counter() - t0
        print(f"  2nd wave (warm radix tree): "
              f"{args.batch * args.new_tokens / dt2:.1f} tok/s "
              f"({dt / max(dt2, 1e-9):.2f}x 1st wave)")
    if store is not None:
        print(f"  prefix store: {store.stats['adoptions']} adoptions")
    # one consolidated dump of every stat surface (serve/engine.py)
    print("engine stats_snapshot:")
    print(json.dumps(engine.stats_snapshot(), indent=2))
    print("kernel launches (timed pass):", json.dumps(launches))
    if args.trace:
        obs.export_trace(args.trace)
        print(f"trace written to {args.trace} (open in ui.perfetto.dev)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(obs.snapshot(), f, indent=2)
        print(f"metrics snapshot written to {args.metrics_json}")
    if obs_on:
        obs.disable()
    print("first row:", out[0][:24])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
