#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which makes the run exit non-zero if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port with ``nvcc`` and time it;
3. each kernel against its plain PyTorch version on the card, on the same
   inputs: the paged decode attention kernel (CUDA) on scrambled page
   tables with sentinel entries and mixed ``valid_len``, with the
   qwen2.5-0.5b head map (H=16, KVH=2, D=64), at the serving shape (4 slots,
   max_len 512, page 16) and a larger one (32 rows, valid_len 2048); RMSNorm
   (Triton) on [N, 896]; bf16 and f32; max error against the tolerance,
   on inputs whose outputs are large beside it (a peaked softmax: the
   comparison fails a kernel that returns zeros or a flat average); times from CUDA events with L2 flushed before each launch, and each
   kernel's bound (bytes over 3.35 TB/s, operations over the peak rate of
   their type);
4. serving at full width: qwen2.5-0.5b in bf16 with random weights from a
   seeded generator, the paged engine (4 slots, page 16, decode chunk 8,
   max_len 512), 8 requests of prompt lengths 7..255 and 32 new tokens
   each; tok/s, the engine stats, the kernels' launch counts in that run,
   and where the device time went (``torch.profiler``) in a second run;
5. consistency at full width in f32: the engine's greedy tokens equal the
   argmax of one teacher-forced ``prefill`` (a path without the decode
   kernel) at every generated position, with the kernels' launch counts of
   that run checked as in phase 4.

Then it prints the kernel summary as one JSON line and, last, the device
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
PEAK_OPS = {"bfloat16": 989e12,    # dense tensor-core bf16
            "float32": 67e12}      # f32 outside the tensor cores
TOL = {"float32": 1e-5, "bfloat16": 2e-2}   # tests/test_kernels.py::_tol
ARCH = "qwen2.5-0.5b"
PROMPT_LENS = (7, 17, 33, 64, 100, 128, 200, 255)
NEW_TOKENS = 32
SERVE = dict(max_len=512, num_slots=4, kv_layout="paged", page_size=16,
             decode_chunk=8)


class PhaseFailed(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseFailed(msg)


# ------------------------------------------------------------------ timing


class Timer:
    """Device time of one call, from CUDA events, averaged over ``reps``
    launches. Before each launch the L2 cache is flushed (a 64 MiB write,
    more than the 50 MB L2) and the stream is held by a spin kernel, so the
    events see the device work only and not the host's enqueue time."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps=20) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(2_000_000)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize()
            total += start.elapsed_time(end)
        return total / reps


def bound_ms(nbytes: float, ops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS[dtype]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


# ------------------------------------------------------------------ phases


def phase_card() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    line = out.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build(_build) -> None:
    t0 = time.perf_counter()
    libs = [_build.build(name).name for name in _build.sources()]
    dt = time.perf_counter() - t0
    print(f"build: nvcc {dt:.2f} s for {libs} (sm_90a)")
    for name, log in _build.BUILD_LOG.items():
        for ln in log.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  {name}: {ln.strip()}")


def _paged_inputs(torch, dtype, b, vlens, ps=16, maxp=32, h=16, kvh=2, d=64,
                  seed=0):
    """Pool, scrambled tables (sentinels past each row's pages), q and the
    qwen2.5-0.5b head map (7 q heads on kv head 0, 9 on kv head 1: the two
    padded heads clamp onto the last kv head). q = 3 N(0, 1) against
    N(0, 1) keys gives scores of spread 3, so each row's softmax is peaked
    and its output stays near the size of a V row even at 2048 positions."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    num_pages = b * maxp + 7
    dt = getattr(torch, dtype)
    k = torch.randn(num_pages, ps, kvh, d, generator=g, device="cuda").to(dt)
    v = torch.randn(num_pages, ps, kvh, d, generator=g, device="cuda").to(dt)
    q = (3 * torch.randn(b, 1, h, d, generator=g, device="cuda")).to(dt)
    perm = torch.randperm(num_pages, generator=g, device="cuda").to(
        torch.int32)
    tbl = torch.full((b, maxp), num_pages, dtype=torch.int32, device="cuda")
    used = 0
    for i, n_pos in enumerate(vlens):
        n = -(-n_pos // ps)
        tbl[i, :n] = perm[used:used + n]
        used += n
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    hmap = torch.tensor([min(i // 7, kvh - 1) for i in range(h)],
                        dtype=torch.int32, device="cuda")
    return q, k, v, tbl, vl, hmap


def _check_close(torch, got, want, dtype: str, what: str) -> float:
    """Fails unless |got - want| <= tol + tol * |want| everywhere (the
    rtol = atol = tol of tests/test_kernels.py::_tol) and got is finite;
    returns the max absolute error. Also fails when the check would be weak:
    when a row of the plain output has an RMS below 10 tol, so that zeros
    there would pass."""
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    tol = TOL[dtype]
    row_rms = want.reshape(want.shape[0], -1).pow(2).mean(dim=1).sqrt()
    check(bool((row_rms >= 10 * tol).all()),
          f"{what} {dtype}: the inputs are too weak for the check (a row's "
          f"plain output has RMS {row_rms.min().item():.3g} < 10 tol)")
    check(bool(torch.isfinite(got).all())
          and bool((diff <= tol + tol * want.abs()).all()),
          f"{what} {dtype}: not within rtol = atol = {tol} of the plain "
          f"version (max |err| {diff.max().item()})")
    return diff.max().item()


def phase_kernels(torch, ops, ref, timer) -> dict:
    """Every kernel against its plain version; returns the summary entries
    at the main path's shapes (bf16)."""
    F = torch.nn.functional
    rows = []
    main = {}
    slice_vl = [1, 17, 300, 512]          # one position, partial page, full
    cases = [("serving", 4, slice_vl, 32), ("large", 32, [2048] * 32, 128)]
    for dtype in ("bfloat16", "float32"):
        for label, b, vlens, maxp in cases:
            q, k, v, tbl, vl, hmap = _paged_inputs(torch, dtype, b, vlens,
                                                   maxp=maxp)
            n0 = ops.LAUNCHES["paged_decode_attention"]
            out = ops.paged_decode_attention(q, k, v, tbl, vl, hmap)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["paged_decode_attention"] == n0 + 1,
                  "paged_decode_attention did not count its launch")
            plain = ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hmap)
            err = _check_close(torch, out[:, 0], plain, dtype,
                               f"paged_decode_attention {label}")
            h, d = q.shape[2], q.shape[3]
            es = out.element_size()
            kv_pos = sum(min(x, maxp * 16) for x in vlens)
            nbytes = (2 * b * h * d * es + 2 * kv_pos * k.shape[2] * d * es
                      + tbl.numel() * 4 + vl.numel() * 4 + hmap.numel() * 4)
            bms, by = bound_ms(nbytes, 4 * kv_pos * h * d, dtype)
            ms = timer.ms(lambda: ops.paged_decode_attention(q, k, v, tbl, vl,
                                                             hmap))
            pms = timer.ms(lambda: ref.paged_decode_attention(q[:, 0], k, v,
                                                              tbl, vl, hmap))
            row = dict(kernel="paged_decode_attention", case=label,
                       dtype=dtype, shape=f"B={b} H=16 KVH=2 D=64 page=16 "
                       f"max_pages={maxp} valid_len={vlens[:4]}...",
                       max_abs_err=err, tol=TOL[dtype], ms=ms, plain_ms=pms,
                       library_ms=None, bound_ms=bms, bound_by=by)
            rows.append(row)
            if label == "serving" and dtype == "bfloat16":
                main["paged_decode_attention"] = row
        for n in (4, 8192):
            g = torch.Generator(device="cuda").manual_seed(n)
            dt = getattr(torch, dtype)
            x = torch.randn(n, 896, generator=g, device="cuda").to(dt)
            s = (1 + 0.1 * torch.randn(896, generator=g, device="cuda")).to(dt)
            n0 = ops.LAUNCHES["rmsnorm"]
            out = ops.rmsnorm(x, s, 1e-6)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["rmsnorm"] == n0 + 1,
                  "rmsnorm did not count its launch")
            err = _check_close(torch, out, ref.rmsnorm(x, s, 1e-6), dtype,
                               f"rmsnorm [{n}, 896]")
            es = x.element_size()
            bms, by = bound_ms(2 * n * 896 * es + 896 * es, 4 * n * 896,
                               dtype)
            row = dict(kernel="rmsnorm", case=f"N={n}", dtype=dtype,
                       shape=f"[{n}, 896]", max_abs_err=err, tol=TOL[dtype],
                       ms=timer.ms(lambda: ops.rmsnorm(x, s, 1e-6)),
                       plain_ms=timer.ms(lambda: ref.rmsnorm(x, s, 1e-6)),
                       library_ms=timer.ms(lambda: F.rms_norm(
                           x, (896,), weight=s, eps=1e-6)),
                       bound_ms=bms, bound_by=by)
            rows.append(row)
            if n == 4 and dtype == "bfloat16":
                main["rmsnorm"] = row
    print("kernels vs plain versions (CUDA events, L2 flushed, ms per call):")
    for r in rows:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"  {r['kernel']:<23} {r['case']:<8} {r['dtype']:<9} "
              f"err {r['max_abs_err']:.2e} (rtol=atol {r['tol']:.0e})  "
              f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {lib}  bound {r['bound_ms']:.5f} ({r['bound_by']})"
              f"  {r['shape']}")
    print("  paged_decode_attention has no single-call PyTorch yardstick; "
          "rmsnorm's is torch.nn.functional.rms_norm (timed only)")
    return main


def _requests(Request, vocab):
    import numpy as np
    rng = np.random.default_rng(1)
    return [Request(uid=i, tokens=rng.integers(0, vocab, (n,),
                                               dtype=np.int32),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]


def _serve_once(torch, cfg, params, ServeEngine, ServeConfig, Request):
    eng = ServeEngine(cfg, params, ServeConfig(**SERVE), device="cuda")
    t0 = time.perf_counter()
    res = eng.run(_requests(Request, cfg.vocab_size))
    torch.cuda.synchronize()
    return eng, res, time.perf_counter() - t0


def phase_serving(torch, ops, lm, cfg, ServeEngine, ServeConfig,
                  Request) -> dict:
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.padded_heads} q heads / {cfg.num_kv_heads} "
          f"kv heads, vocab {cfg.padded_vocab_size}, {cfg.dtype}): "
          f"{n_params / 1e6:.1f} M params, init {time.perf_counter() - t0:.2f}"
          f" s; {len(PROMPT_LENS)} requests, prompts {PROMPT_LENS}, "
          f"{NEW_TOKENS} new tokens each; {SERVE}")
    _serve_once(torch, cfg, params, ServeEngine, ServeConfig, Request)
    ops.reset_launches()                     # the main path's run
    eng, res, dt = _serve_once(torch, cfg, params, ServeEngine, ServeConfig,
                               Request)
    launches = dict(ops.LAUNCHES)
    check(sorted(res) == list(range(len(PROMPT_LENS))),
          f"answered {sorted(res)} of {len(PROMPT_LENS)} requests")
    for uid, toks in res.items():
        check(len(toks) == NEW_TOKENS and (toks >= 0).all()
              and (toks < cfg.vocab_size).all(),
              f"request {uid}: {len(toks)} tokens, range "
              f"[{toks.min()}, {toks.max()}]")
    gen = sum(len(t) for t in res.values())
    st = eng.stats
    print(f"  run: {gen} tokens in {dt:.3f} s = {gen / dt:.1f} tok/s "
          f"(prefill included)")
    print(f"  engine stats: {json.dumps(st)}")
    print(f"  page pool: {json.dumps(eng.page_pool_stats())}")
    print(f"  kernel launches in this run: {json.dumps(launches)}")
    _check_launches(launches, cfg, st)
    print(f"  peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    _profile(torch, cfg, params, ServeEngine, ServeConfig, Request)
    return {"launches": launches, "tok_s": gen / dt}


def _check_launches(launches: dict, cfg, stats: dict) -> None:
    """Each kernel of the path ran, as often as the path calls it: one
    paged decode per layer and decode step, one RMSNorm per norm (two per
    block and the final one) and forward (prefill or decode step)."""
    steps = stats["decode_chunks"] * SERVE["decode_chunk"]
    want = {"paged_decode_attention": cfg.num_layers * steps,
            "rmsnorm": (2 * cfg.num_layers + 1) * (steps + stats["prefills"])}
    check(all(launches[k] > 0 for k in launches),
          f"a kernel of the path was not launched: {launches}")
    check(launches == want, f"launch counts {launches} != the path's "
          f"{want} ({steps} decode steps, {stats['prefills']} prefills)")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _profile(torch, cfg, params, ServeEngine, ServeConfig, Request):
    """Where the device time goes in one more serving run."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, wall = _serve_once(torch, cfg, params, ServeEngine,
                                 ServeConfig, Request)
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in events)
    if not events:
        print("  profile: the profiler saw no device time (not measured)")
        return
    print(f"  profile (one more run, profiler on): wall {wall * 1e3:.1f} ms,"
          f" device kernels {busy_us / 1e3:.1f} ms, device idle share "
          f"{max(0.0, 1 - busy_us / 1e6 / wall):.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")
    host = [e for e in prof.key_averages() if e.self_cpu_time_total > 0]
    print(f"  host ops by self time (profiler on, "
          f"{sum(e.count for e in host)} calls):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")


def phase_consistency(torch, ops, lm, cfg, ServeEngine, ServeConfig,
                      Request):
    """f32 engine tokens == argmax of one teacher-forced prefill per request
    (rows = the request's prompt + generated tokens, lengths = prompt + i)."""
    cfg = cfg.replace(dtype="float32")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    ops.reset_launches()
    eng, res, _ = _serve_once(torch, cfg, params, ServeEngine, ServeConfig,
                              Request)
    launches = dict(ops.LAUNCHES)
    _check_launches(launches, cfg, eng.stats)
    reqs = {r.uid: r for r in _requests(Request, cfg.vocab_size)}
    checked = 0
    for uid, toks in sorted(res.items()):
        prompt = reqs[uid].tokens
        full = torch.as_tensor(list(prompt) + list(toks), device="cuda")
        rows = full[None, :].expand(NEW_TOKENS, -1).contiguous()
        lengths = torch.arange(NEW_TOKENS, device="cuda") + len(prompt)
        logits, _ = lm.prefill(params, cfg, {"tokens": rows}, rows.shape[1],
                               lengths=lengths)
        check(tuple(logits.shape) == (NEW_TOKENS, cfg.padded_vocab_size)
              and torch.isfinite(logits[:, :cfg.vocab_size]).all().item(),
              f"request {uid}: prefill logits {tuple(logits.shape)} not "
              f"finite or misshapen")
        want = torch.argmax(logits, dim=-1).cpu().numpy()
        bad = (want != toks).nonzero()[0]
        if bad.size:
            i = int(bad[0])
            top = torch.topk(logits[i].float(), 2).values.tolist()
            raise PhaseFailed(
                f"request {uid} (prompt {len(prompt)}): first mismatch at "
                f"generated position {i}: engine {int(toks[i])}, "
                f"teacher-forced prefill {int(want[i])} (top-2 logits "
                f"{top})")
        checked += len(toks)
    print(f"consistency (f32, full width): {checked} greedy tokens of "
          f"{len(res)} requests equal the teacher-forced prefill argmax; "
          f"kernel launches in the f32 serving run: {json.dumps(launches)}")


# ------------------------------------------------------------------ main


def main() -> int:
    try:
        import torch
    except ImportError as e:
        print(f"chip_smoke: PyTorch is missing ({e})", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.configs import get_config
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.models import lm
        from repro_torch.serve import Request, ServeConfig, ServeEngine
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    phase = "start"
    try:
        phase = "card"
        phase_card()
        phase = "build"
        phase_build(_build)
        phase = "kernels"
        main_rows = phase_kernels(torch, ops, ref, Timer(torch))
        phase = "serving"
        cfg = get_config(ARCH)
        serving = phase_serving(torch, ops, lm, cfg, ServeEngine,
                                ServeConfig, Request)
        phase = "consistency"
        phase_consistency(torch, ops, lm, cfg, ServeEngine, ServeConfig,
                          Request)
    except Exception:   # the boundary: report the failed phase, exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase!r} FAILED", file=sys.stderr)
        return 1
    sources = {"paged_decode_attention": (
        "cuda", "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention.py:95"),
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:13")}
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = main_rows[name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=serving["launches"][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
