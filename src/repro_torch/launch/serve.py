"""Serving launcher of the PyTorch port: the continuous-batching engine over a
(smoke or full-width) model with random weights from a seed.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen2.5-0.5b \
      --kv-layout paged [--smoke] [--device cuda]

Mirrors the flags of the JAX package's ``launch/serve.py`` that the port
supports. Reports the first (warmup) pass — which builds the kernels — and
the steady-state tok/s of a second pass separately, then the engine's
``stats``, the page-pool stats and the kernels' launch counts of the timed
pass.
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
    ap.add_argument("--prefill-rows", type=int, default=1,
                    help="rows per bucketed prefill batch")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.models import lm
    from repro_torch.serve import ServeConfig, ServeEngine

    dev = resolve_device(args.device)
    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = lm.init(cfg, gen, device=dev)
    rng = np.random.default_rng(args.seed + 1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size,
                                    (args.batch, args.prompt_len),
                                    dtype=np.int32)}
    serve_cfg = ServeConfig(
        max_len=args.prompt_len + args.new_tokens, num_slots=args.batch,
        temperature=args.temperature, decode_chunk=args.decode_chunk,
        kv_layout=args.kv_layout, page_size=args.page_size,
        num_pages=args.num_pages or None, prefill_rows=args.prefill_rows)

    def one_pass():
        engine = ServeEngine(cfg, params, serve_cfg, device=dev)
        out = engine.generate(batch, max_new_tokens=args.new_tokens)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, engine

    # warmup: builds the kernels and warms the allocator at the same shapes
    t0 = time.perf_counter()
    one_pass()
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
    print("engine stats:", json.dumps(engine.stats))
    print("page pool:", json.dumps(engine.page_pool_stats()))
    print("kernel launches (timed pass):", json.dumps(launches))
    print("first row:", out[0][:24])
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
