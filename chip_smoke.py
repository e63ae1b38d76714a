#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which makes the run exit non-zero if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port with ``nvcc``, one process per
   source, all started together, and time it;
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
   that run checked as in phase 4;
6. the training kernels against their plain versions, bf16 and f32, at the
   training path's shapes: the block gradient norms and the masked AdamW
   step (Triton) on the stacked leaves wg [24, 896*4864], wq [24, 896*1024]
   and ln1 [24, 896] with 5 of 24 rows selected, and the RMSNorm backward
   (Triton) on [8*512, 896]; rows with sel = 0 come back bit-identical, two
   launches of the norms give the same bits; times as in phase 3, beside
   each kernel's bytes bound and a library yardstick where one exists;
7. training at full width: the port's ``Trainer`` on qwen2.5-0.5b in bf16,
   adagradselect, dense residency, global batch 8 x 512 tokens, 10 steps;
   median step time after 2 warm-up steps, tokens/s, peak device memory,
   launches per step of every kernel (checked against the path's counts,
   the flash kernels 48 forward, 24 dq and 24 dk/dv: ``remat="full"``
   runs each layer's forward twice), k = 5 of 26 blocks selected at every
   step, finite losses, the AdamW counts equal to the summed masks, and a
   profiled repeat;
8. training consistency in f32 (TF32 off): topk_grad at full width with 2
   layers, global batch 2 x 64, 3 steps, on the card (kernels) and on the
   CPU (plain versions) from the same state: losses within 1e-4 relative,
   equal masks at every step, parameters within 2 lr steps;
9. the banked masked AdamW (Triton) against its plain version, bf16 and
   f32, on wg, wq and ln1 [24, R] with [5, R] moment banks whose slots hold
   4 leaf rows out of order and one free slot, one real slot unselected:
   free and unselected rows bit-identical in p and in the banks, and the
   same bits as the dense masked AdamW run on a dense copy whose m and v
   hold the bank rows at the slot positions; times as in phase 6;
10. banked training at full width (paper §3.3): the port's ``Trainer`` as
   in phase 7 but with ``moment_residency="banked"``, ``offload="host"``
   (a pinned host store) and the async swap planner; 2 warm-up steps, then
   8 steps in one log window (the only host sync per step is the selected
   indices' read); mean step time, tokens/s and peak device memory beside
   phase 7's, the optimizer state's device and host bytes (the banks' m and
   v equal to the bytes reckoned from the config), the swap statistics,
   launches per step (12 banked, 0 dense AdamW), counts summing to 5 a
   step, moments nonzero on exactly the blocks counted; then the same with
   ``async_swap=False``; then dense, banked async and banked sync step
   times in alternating rounds of 8-step windows;
11. banked consistency in f32 (TF32 off), 2 layers at full width, k = 50%,
   batch 2 x 64, 4 steps: (a) ``random`` on the card, banked async, banked
   sync and dense from one state, with a seed whose masks admit the
   embedding and later evict it: equal masks, losses within 1e-4 relative,
   each leaf of params, m and v within 1e-5 of its largest magnitude, no
   mispredict (every boundary but the unpredicted first hits); (b)
   ``topk_grad`` banked async on the card against banked on the CPU;
12. the flash attention kernels (CUDA; forward, dq, dk/dv) against their
   plain versions, f32 and bf16: causal and segmented at the training shape
   (B 8, S 512, 16 q heads on 2 kv heads through the qwen2.5-0.5b head map,
   D 64; the segment ids of a real ``pack_batch``), a ragged S of 300 and
   head dim 128, and segmented but not causal; o, lse, dq, dk and dv
   within the tolerance on inputs whose rows are large beside it, dk and
   dv bit-identical over two launches; in f32 with a peaked softmax (q = 3
   N(0, 1)), the kernels' outputs and the plain f32 versions' against the
   plain version in f64, the kernels' no further from it than the plain
   version's or within the f32 tolerance; times as in phase 3 beside each kernel's bound (operations
   over the dtype's peak, or bytes), the plain versions' and
   ``scaled_dot_product_attention``'s (causal, or with a boolean
   block-diagonal mask) forward and backward (timed only);
13. packed SFT training at full width: phase 7's run on the packed
   synthetic records (``make_source("packed_math")``, 8 x 512 tokens, ~12
   records a row), 10 steps; tokens/s, non-pad tokens and records a step,
   peak device memory, launches per step as in phase 7, k = 5 blocks a
   step, finite losses, and a profile of 2 steps with the flash kernels'
   share of device time and the idle share;
14. packed consistency in f32 (TF32 off), 2 layers at full width: (a) on
   the card, a packed 2 x 512 batch's loss and gradients equal the
   unpacked oracle's (the same records one a row), loss 1e-5 relative and
   each gradient leaf within 1e-5 of its largest magnitude; (b) 3 packed
   ``topk_grad`` steps on the card and on the CPU from one state: losses
   within 1e-4 relative, masks equal, each parameter leaf's card update
   within ``PACKED_UPDATE_RTOL`` of the largest entry of its CPU update.

Then it prints the kernel summary as one JSON line and, last, the device
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import statistics
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
TRAIN_LEAVES = {"wg": (24, 896 * 4864), "wq": (24, 896 * 1024),
                "ln1": (24, 896)}   # stacked leaves as the kernels see them
TRAIN_SEL_ROWS = (1, 6, 11, 16, 21)  # 5 of 24 rows selected
TRAIN = dict(global_batch=8, seq_len=512, steps=10, warmup=2)
BANK_SLOTS = (16, 3, 24, 9, 21)      # 4 rows out of order, a free slot (24)
BANK_SEL = (1.0, 1.0, 0.0, 0.0, 1.0)  # row 9 held but unselected
FLASH_NAMES = ("flash_fwd_kernel", "flash_dq_kernel", "flash_dkv_kernel")
PACKED_UPDATE_RTOL = 0.1  # phase 14(b): of each leaf's largest CPU update


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
    """One nvcc per CUDA source, all started together."""
    from concurrent.futures import ThreadPoolExecutor
    t0 = time.perf_counter()
    names = _build.sources()
    with ThreadPoolExecutor(len(names)) as pool:
        libs = [p.name for p in pool.map(_build.build, names)]
    dt = time.perf_counter() - t0
    print(f"build: nvcc {dt:.2f} s for {libs} (sm_90a, in parallel)")
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
    """Each kernel of the path ran, as often as the path calls it (and so
    at least once): one paged decode per layer and decode step, one RMSNorm
    per norm (two per block and the final one) and forward (prefill or
    decode step), and no training kernel."""
    steps = stats["decode_chunks"] * SERVE["decode_chunk"]
    want = {k: 0 for k in launches}   # the training kernels: off this path
    want.update({
        "paged_decode_attention": cfg.num_layers * steps,
        "rmsnorm": (2 * cfg.num_layers + 1) * (steps + stats["prefills"])})
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


# ------------------------------------------------------------ training


def _bits_equal(torch, a, b) -> bool:
    ib = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return a.shape == b.shape and torch.equal(a.view(ib), b.view(ib))


def phase_train_kernels(torch, ops, ref, timer) -> dict:
    """Rows 7, 8 and 2b against their plain versions; returns the summary
    entries of the main path's largest launch (wg, bf16; [4096, 896] bf16
    for the RMSNorm backward)."""
    F = torch.nn.functional
    rows, main = [], {}
    adam = dict(lr=0.3, b1=0.9, b2=0.999, eps=1e-8, wd=0.1)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for leaf, (nl, r) in TRAIN_LEAVES.items():
            g = torch.Generator(device="cuda").manual_seed(nl * r % 9973)

            def rnd(scale=1.0, shift=0.0):
                return shift + scale * torch.randn(nl, r, generator=g,
                                                   device="cuda")
            grad = rnd(1.0, 0.5).to(dt)      # nonzero mean
            # row 7: per-row sum of squares (f32 sums: f32 tolerance)
            n0 = ops.LAUNCHES["block_grad_sq_norms"]
            out = ops.block_grad_sq_norms(grad)
            again = ops.block_grad_sq_norms(grad)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["block_grad_sq_norms"] == n0 + 2,
                  "block_grad_sq_norms did not count its launches")
            check(_bits_equal(torch, out, again),
                  f"block_grad_sq_norms {leaf} {dtype}: two launches gave "
                  f"different bits")
            err = _check_close(torch, out[:, None],
                               ref.block_grad_sq_norms(grad)[:, None],
                               "float32", f"block_grad_sq_norms {leaf} {dtype}")
            bms, by = bound_ms(nl * r * es + nl * 4, 2 * nl * r, "float32")
            row = dict(kernel="block_grad_sq_norms", case=leaf, dtype=dtype,
                       shape=f"[{nl}, {r}]", max_abs_err=err, tol=TOL[
                           "float32"],
                       ms=timer.ms(lambda: ops.block_grad_sq_norms(grad)),
                       plain_ms=timer.ms(
                           lambda: ref.block_grad_sq_norms(grad)),
                       library_ms=timer.ms(lambda: torch.linalg.vector_norm(
                           grad, dim=1, dtype=torch.float32) ** 2),
                       bound_ms=bms, bound_by=by)
            rows.append(row)
            if leaf == "wg" and dtype == "bfloat16":
                main["block_grad_sq_norms"] = row
            # row 8: masked AdamW, in place
            p, m, v = rnd().to(dt), rnd(0.1, 0.05), rnd(0.01).abs() + 0.01
            sel = torch.zeros(nl, device="cuda")
            sel[list(TRAIN_SEL_ROWS)] = 1.0
            cnt = torch.arange(1, nl + 1, dtype=torch.float32, device="cuda")
            args = (sel, cnt, *adam.values())
            pk, mk, vk = p.clone(), m.clone(), v.clone()
            n0 = ops.LAUNCHES["masked_adamw"]
            ops.masked_adamw(pk, grad, mk, vk, *args)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["masked_adamw"] == n0 + 1,
                  "masked_adamw did not count its launch")
            pr, mr, vr = ref.masked_adamw(p, grad, m, v, *args)
            on = sel > 0
            err = _check_close(torch, pk[on], pr[on], dtype,
                               f"masked_adamw p {leaf}")
            for what, got, want in (("m", mk, mr), ("v", vk, vr)):
                _check_close(torch, got[on], want[on], "float32",
                             f"masked_adamw {what} {leaf} {dtype}")
            for what, new, old in (("p", pk, p), ("m", mk, m), ("v", vk, v)):
                check(_bits_equal(torch, new[~on], old[~on]),
                      f"masked_adamw {leaf} {dtype}: {what} of a row with "
                      f"sel = 0 changed")
            moved = (pk.float() - p.float())[on].abs().max().item()
            check(moved > 5 * TOL[dtype], f"masked_adamw {leaf} {dtype}: "
                  f"the step ({moved:.3g}) is too small for the check")
            n_sel = len(TRAIN_SEL_ROWS)
            bms, by = bound_ms(n_sel * r * (3 * es + 16) + 2 * nl * 4,
                               15 * n_sel * r, "float32")
            row = dict(kernel="masked_adamw", case=leaf, dtype=dtype,
                       shape=f"[{nl}, {r}], {n_sel} rows selected",
                       max_abs_err=err, tol=TOL[dtype],
                       ms=timer.ms(lambda: ops.masked_adamw(pk, grad, mk, vk,
                                                            *args)),
                       plain_ms=timer.ms(lambda: ref.masked_adamw(
                           p, grad, m, v, *args)),
                       library_ms=None, bound_ms=bms, bound_by=by)
            rows.append(row)
            if leaf == "wg" and dtype == "bfloat16":
                main["masked_adamw"] = row
            del grad, p, m, v, pk, mk, vk, pr, mr, vr
        # row 2b: RMSNorm backward at the training path's [8 * 512, 896]
        n, d = TRAIN["global_batch"] * TRAIN["seq_len"], 896
        g = torch.Generator(device="cuda").manual_seed(5)
        mu = 1 + 0.5 * torch.randn(d, generator=g, device="cuda")
        x = (mu + torch.randn(n, d, generator=g, device="cuda")).to(dt)
        s = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
        dy = (1 + torch.randn(n, d, generator=g, device="cuda")).to(dt)
        n0 = ops.LAUNCHES["rmsnorm_bwd"]
        dx, ds = ops.rmsnorm_bwd(dy, x, s, 1e-6)
        torch.cuda.synchronize()
        check(ops.LAUNCHES["rmsnorm_bwd"] == n0 + 1,
              "rmsnorm_bwd did not count its launch")
        pdx, pds = ref.rmsnorm_bwd(dy, x, s, 1e-6)
        err = _check_close(torch, dx, pdx, dtype, "rmsnorm_bwd dx")
        err = max(err, _check_close(torch, ds[None], pds[None], dtype,
                                    "rmsnorm_bwd dscale"))
        xl = x.clone().requires_grad_()
        sl = s.clone().requires_grad_()
        yl = F.rms_norm(xl, (d,), weight=sl, eps=1e-6)
        bms, by = bound_ms(3 * n * d * es + 2 * d * es, 10 * n * d,
                           "float32")
        row = dict(kernel="rmsnorm_bwd", case=f"N={n}", dtype=dtype,
                   shape=f"[{n}, {d}]", max_abs_err=err, tol=TOL[dtype],
                   ms=timer.ms(lambda: ops.rmsnorm_bwd(dy, x, s, 1e-6)),
                   plain_ms=timer.ms(lambda: ref.rmsnorm_bwd(dy, x, s,
                                                             1e-6)),
                   library_ms=timer.ms(lambda: torch.autograd.grad(
                       yl, (xl, sl), dy, retain_graph=True)),
                   bound_ms=bms, bound_by=by)
        rows.append(row)
        if dtype == "bfloat16":
            main["rmsnorm_bwd"] = row
    print("training kernels vs plain versions (CUDA events, L2 flushed, ms "
          "per call):")
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['kernel']:<20} {r['case']:<7} {r['dtype']:<9} "
              f"err {r['max_abs_err']:.2e} (rtol=atol {r['tol']:.0e})  "
              f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {lib}  bound {r['bound_ms']:.5f} ({r['bound_by']})"
              f"  {r['shape']}")
    print("  yardsticks: torch.linalg.vector_norm(g, dim=1, dtype=f32)**2 "
          "(row 7), the autograd of F.rms_norm (2b); masked_adamw has none "
          "(no single call takes per-row masks and counts)")
    return main


def _train_cfg(cfg, method, steps, global_batch, seq_len, log_every=1,
               seed=0, k_percent=20.0, **opt):
    from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                          TrainConfig)
    return TrainConfig(
        model=cfg, method=method,
        # as the launcher builds them (launch/train.py)
        select=SelectConfig(k_percent=k_percent,
                            steps_per_epoch=max(1, steps // 4)),
        optimizer=OptimizerConfig(**{"lr": 1e-3, "total_steps": steps,
                                     **opt}),
        seq_len=seq_len, global_batch=global_batch, steps=steps, seed=seed,
        log_every=log_every)


def _flash_per_step(nl: int) -> dict:
    """Flash launches of one training step: each layer's forward runs
    twice (``remat="full"`` recomputes it in the backward), its backward
    once."""
    return {"flash_attention_fwd": 2 * nl, "flash_attention_bwd_dq": nl,
            "flash_attention_bwd_dkv": nl}


def phase_training(torch, ops, cfg, Trainer) -> dict:
    steps, warm = TRAIN["steps"], TRAIN["warmup"]
    tcfg = _train_cfg(cfg, "adagradselect", steps, TRAIN["global_batch"],
                      TRAIN["seq_len"])
    t0 = time.perf_counter()
    tr = Trainer(tcfg, device="cuda")
    torch.cuda.synchronize()
    nb = cfg.num_blocks
    k = tr.sel_cfg.num_selected(nb)
    print(f"training {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}, "
          f"{nb} blocks, k = {k}): adagradselect, dense residency, batch "
          f"{TRAIN['global_batch']} x {TRAIN['seq_len']} tokens, {steps} "
          f"steps; init {time.perf_counter() - t0:.2f} s")
    torch.cuda.reset_peak_memory_stats()
    mask_sum = torch.zeros(nb, device="cuda")
    ops.reset_launches()                     # the main path's run
    for _ in range(steps):
        tr.train(1)
        mask_sum += tr.state["sel"]["mask"].float()
    launches = dict(ops.LAUNCHES)
    log = tr.log
    peak = torch.cuda.max_memory_allocated()
    check(len(log.losses) == steps and all(math.isfinite(x)
                                           for x in log.losses),
          f"losses {log.losses}")
    n_sel = [mt["num_selected"] for mt in log.metrics]
    check(n_sel == [k] * steps, f"num_selected per step {n_sel}, want {k}")
    check(torch.equal(tr.state["opt"]["counts"], mask_sum),
          f"opt counts {tr.state['opt']['counts'].tolist()} != summed masks "
          f"{mask_sum.tolist()}")
    per_step = {name: n / steps for name, n in launches.items()}
    nl = cfg.num_layers
    want = {"paged_decode_attention": 0, "block_grad_sq_norms": 12,
            "masked_adamw": 12, "banked_masked_adamw": 0,
            # forward, and the recompute of each layer's two norms
            # (remat="full"), then the backward of every norm
            "rmsnorm": 2 * nl + 1 + 2 * nl, "rmsnorm_bwd": 2 * nl + 1,
            **_flash_per_step(nl)}
    check(per_step == want, f"launches per step {per_step} != the path's "
          f"{want}")
    times = log.step_times[warm:]
    med = statistics.median(times)
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    print(f"  losses: {[round(x, 4) for x in log.losses]}")
    print(f"  step time (median of steps {warm}..{steps - 1}): "
          f"{med * 1e3:.2f} ms = {tokens / med:.0f} tokens/s; all steps "
          f"(ms): {[round(t * 1e3, 2) for t in log.step_times]}")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB")
    print(f"  selected per step: {n_sel}; counts = summed masks "
          f"{mask_sum.int().tolist()}")
    print(f"  launches per step: {json.dumps(per_step)}")
    _profile_training(torch, tr)
    return {"launches": launches, "step_ms": med * 1e3, "peak": peak,
            "tokens_s": tokens / med}


def _profile_training(torch, tr) -> None:
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train(2)
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    if not events:
        print("  profile: the profiler saw no device time (not measured)")
        return
    busy_us = sum(e.device_time_total for e in events)
    print(f"  profile (2 more steps, profiler on): wall {wall * 1e3:.1f} ms, "
          f"device kernels {busy_us / 1e3:.1f} ms in "
          f"{sum(e.count for e in events)} launches, device idle share "
          f"{max(0.0, 1 - busy_us / 1e6 / wall):.3f}")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:15]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")
    ours = {}
    for e in events:   # the port's kernels, by their function names
        for fn in ("_rmsnorm_fwd", "_rmsnorm_bwd", "_col_sums", "_partials",
                   "_row_sums", "_masked_adamw", "_banked_masked_adamw"):
            if e.key.startswith(fn):      # Triton: the name comes first
                ours[fn] = ours.get(fn, 0.0) + e.device_time_total / 1e3
        for fn in FLASH_NAMES:            # CUDA C++: inside the signature
            if fn in e.key:
                ours[fn] = ours.get(fn, 0.0) + e.device_time_total / 1e3
    flash = sum(ours.get(fn, 0.0) for fn in FLASH_NAMES)
    print(f"  the port's kernels in that profile (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in ours.items()})}, "
          f"{sum(ours.values()) / (busy_us / 1e3):.3f} of device time; the "
          f"flash kernels {flash:.3f} ms = {flash / (busy_us / 1e3):.3f}")


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if hasattr(tree, "to"):
        return tree.to(device).clone()
    return tree


def phase_train_consistency(torch, ops, cfg, Trainer) -> None:
    """The same 3 f32 topk_grad steps on the card and on the CPU."""
    steps, lr = 3, 1e-3
    cfg = cfg.replace(dtype="float32", num_layers=2)
    tcfg = _train_cfg(cfg, "topk_grad", steps, 2, 64, lr=lr,
                      schedule="constant", warmup_steps=0)
    card = Trainer(tcfg, device="cuda")
    cpu = Trainer(tcfg, device="cpu")
    cpu.state = _to(card.state, "cpu")
    ops.reset_launches()
    for i in range(steps):
        card.train(1)
        cpu.train(1)
        lc, lh = card.log.losses[-1], cpu.log.losses[-1]
        check(abs(lc - lh) <= 1e-4 * abs(lh),
              f"step {i}: loss card {lc} vs cpu {lh}")
        mc = card.state["sel"]["mask"].cpu()
        check(torch.equal(mc, cpu.state["sel"]["mask"]),
              f"step {i}: masks differ: card {mc.int().tolist()} cpu "
              f"{cpu.state['sel']['mask'].int().tolist()}")
    launches = dict(ops.LAUNCHES)
    check(all(launches[n] > 0 for n in ("rmsnorm", "rmsnorm_bwd",
                                        "block_grad_sq_norms",
                                        "masked_adamw",
                                        *_flash_per_step(1))),
          f"a training kernel did not run on the card: {launches}")
    worst = 0.0
    pc, ph = card.state["params"], cpu.state["params"]
    for a, b in zip(_leaves(pc), _leaves(ph)):
        worst = max(worst, (a.cpu() - b).abs().max().item())
    limit = 2 * lr * steps
    check(worst <= limit, f"params differ by {worst} > {limit}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.log.losses,
                                                   cpu.log.losses))
    print(f"training consistency (f32, TF32 off, {cfg.num_layers} layers at "
          f"full width, batch 2 x 64, {steps} topk_grad steps, card vs CPU): "
          f"losses {[round(x, 6) for x in card.log.losses]}, max rel err "
          f"{rel:.2e} (limit 1e-4); masks equal at every step; params max "
          f"|err| {worst:.3g} (limit {limit:g}); card launches "
          f"{json.dumps(launches)}")


# ------------------------------------------------------- banked residency


def phase_banked_kernel(torch, ops, ref, timer) -> dict:
    """Row 9 against its plain version and against row 8; returns the
    summary entry of the main path's largest launch (wg, bf16)."""
    rows, main = [], {}
    adam = (0.3, 0.9, 0.999, 1e-8, 0.1)
    cap = len(BANK_SLOTS)
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        es = torch.tensor([], dtype=dt).element_size()
        for leaf, (nl, r) in TRAIN_LEAVES.items():
            g = torch.Generator(device="cuda").manual_seed(nl * r % 7919)

            def rnd(n, scale=1.0, shift=0.0):
                return shift + scale * torch.randn(n, r, generator=g,
                                                   device="cuda")
            p, grad = rnd(nl).to(dt), rnd(nl, 1.0, 0.5).to(dt)
            m, v = rnd(cap, 0.1, 0.05), rnd(cap, 0.01).abs() + 0.01
            slots = torch.tensor(BANK_SLOTS, dtype=torch.int32,
                                 device="cuda")
            sel = torch.tensor(BANK_SEL, device="cuda")
            cnt = torch.arange(1, cap + 1, dtype=torch.float32,
                               device="cuda")
            args = (slots, sel, cnt, *adam)
            pk, mk, vk = p.clone(), m.clone(), v.clone()
            n0 = ops.LAUNCHES["banked_masked_adamw"]
            ops.banked_masked_adamw(pk, grad, mk, vk, *args)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["banked_masked_adamw"] == n0 + 1,
                  "banked_masked_adamw did not count its launch")
            pr, mr, vr = ref.banked_masked_adamw(p, grad, m, v, *args)
            on = (slots < nl) & (sel > 0)          # active bank rows
            touched = torch.zeros(nl, dtype=torch.bool, device="cuda")
            touched[slots[on].long()] = True        # their leaf rows
            err = _check_close(torch, pk[touched], pr[touched], dtype,
                               f"banked_masked_adamw p {leaf}")
            for what, got, want in (("m", mk, mr), ("v", vk, vr)):
                _check_close(torch, got[on], want[on], "float32",
                             f"banked_masked_adamw {what} {leaf} {dtype}")
            check(_bits_equal(torch, pk[~touched], p[~touched]),
                  f"banked_masked_adamw {leaf} {dtype}: a p row no active "
                  f"slot holds changed")
            for what, new, old in (("m", mk, m), ("v", vk, v)):
                check(_bits_equal(torch, new[~on], old[~on]),
                      f"banked_masked_adamw {leaf} {dtype}: {what} of a free "
                      f"or unselected bank row changed")
            moved = (pk.float() - p.float())[touched].abs().max().item()
            check(moved > 5 * TOL[dtype], f"banked_masked_adamw {leaf} "
                  f"{dtype}: the step ({moved:.3g}) is too small for the "
                  f"check")
            # row 8 on a dense copy holding the bank rows at their slots
            real = [i for i, s in enumerate(BANK_SLOTS) if s < nl]
            held = [BANK_SLOTS[i] for i in real]
            pd = p.clone()
            md = torch.zeros(nl, r, device="cuda")
            vd = torch.zeros(nl, r, device="cuda")
            md[held], vd[held] = m[real], v[real]
            seld = torch.zeros(nl, device="cuda")
            cntd = torch.zeros(nl, device="cuda")
            seld[held], cntd[held] = sel[real], cnt[real]
            ops.masked_adamw(pd, grad, md, vd, seld, cntd, *adam)
            torch.cuda.synchronize()
            check(_bits_equal(torch, pk, pd)
                  and _bits_equal(torch, mk[real], md[held])
                  and _bits_equal(torch, vk[real], vd[held]),
                  f"banked_masked_adamw {leaf} {dtype}: not the same bits "
                  f"as masked_adamw on the same rows")
            del md, vd, pd
            n_on = int(on.sum().item())
            bms, by = bound_ms(n_on * r * (3 * es + 16) + cap * 12,
                               15 * n_on * r, "float32")
            row = dict(kernel="banked_masked_adamw", case=leaf, dtype=dtype,
                       shape=f"p [{nl}, {r}], banks [{cap}, {r}], {n_on} "
                       f"active rows", max_abs_err=err, tol=TOL[dtype],
                       ms=timer.ms(lambda: ops.banked_masked_adamw(
                           pk, grad, mk, vk, *args)),
                       plain_ms=timer.ms(lambda: ref.banked_masked_adamw(
                           p, grad, m, v, *args)),
                       library_ms=None, bound_ms=bms, bound_by=by)
            rows.append(row)
            if leaf == "wg" and dtype == "bfloat16":
                main["banked_masked_adamw"] = row
            del p, grad, m, v, pk, mk, vk, pr, mr, vr
    print("banked masked AdamW vs plain version and vs masked_adamw (CUDA "
          "events, L2 flushed, ms per call):")
    for r in rows:
        print(f"  {r['kernel']:<20} {r['case']:<4} {r['dtype']:<9} "
              f"err {r['max_abs_err']:.2e} (rtol=atol {r['tol']:.0e})  "
              f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  library -"
              f"  bound {r['bound_ms']:.5f} ({r['bound_by']})  {r['shape']}")
    print("  row 9 = row 8 bit for bit on every case; no library yardstick "
          "(no single call takes slot indirection, masks and counts)")
    return main


def _record_masks(tr):
    """Wrap the trainer's step so that each step's mask is kept."""
    inner, masks = tr.step_fn, []

    def step_fn(state, batch):
        state, metrics = inner(state, batch)
        masks.append(metrics["mask"])
        return state, metrics
    step_fn.swap_planner = getattr(inner, "swap_planner", None)
    step_fn.swap_stats = getattr(inner, "swap_stats", None)
    tr.step_fn = step_fn
    return masks


def _block_nonzero(torch, partition, moments) -> list:
    """Per block: any nonzero moment entry in any of its leaves."""
    from repro_torch.core.partition import leaves
    out = [False] * partition.num_blocks
    for g in partition.groups:
        for leaf in leaves(moments[g.key]):
            if g.stacked:
                nz = leaf.reshape(g.length, -1).ne(0).any(dim=1).tolist()
                for i, f in enumerate(nz):
                    out[g.start + i] |= f
            else:
                out[g.start] |= bool(leaf.ne(0).any())
    return out


def phase_banked_training(torch, ops, cfg, Trainer, dense) -> dict:
    from repro_torch.core import masked_adamw
    from repro_torch.core import partition as part_mod
    from repro_torch.core.offload import resident_opt_bytes
    steps, warm = TRAIN["steps"], TRAIN["warmup"]
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    nl = cfg.num_layers
    out = {}
    for async_swap in (True, False):
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = _train_cfg(cfg, "adagradselect", steps, TRAIN["global_batch"],
                          TRAIN["seq_len"], log_every=steps + 1,
                          moment_residency="banked", offload="host",
                          async_swap=async_swap)
        t0 = time.perf_counter()
        tr = Trainer(tcfg, device="cuda")
        torch.cuda.synchronize()
        init_s = time.perf_counter() - t0
        pn = part_mod.build_partition(cfg)
        k = tr.sel_cfg.num_selected(pn.num_blocks)
        opt = tr.state["opt"]
        per_block = part_mod.params_per_block(pn, tr.state["params"])
        cap = opt["banks"]["layers"]["slots"].shape[0]
        reckoned = 8 * int(cap * per_block[1] + per_block[0]
                           + per_block[pn.num_blocks - 1])
        bank_mv = sum(t.numel() * t.element_size() for b in
                      opt["banks"].values() for mom in ("m", "v")
                      for t in part_mod.leaves(b[mom]))
        res = resident_opt_bytes(opt)
        small = sum(b["slots"].numel() * 4 for b in opt["banks"].values()) \
            + opt["counts"].numel() * 4
        check(bank_mv == reckoned and res["device"] == reckoned + small,
              f"device moment bytes {bank_mv} (state {res['device']}) != "
              f"reckoned {reckoned} (+ {small} of slots and counts)")
        check(all(t.is_pinned() for t in part_mod.leaves(opt["store"])),
              "the host store is not pinned")
        label = "async" if async_swap else "sync"
        print(f"banked training ({label} swap) {cfg.name}: adagradselect, "
              f"k = {k} of {pn.num_blocks} blocks, offload host (pinned), "
              f"bank capacity {cap}; batch {TRAIN['global_batch']} x "
              f"{TRAIN['seq_len']}; init {init_s:.2f} s")
        print(f"  optimizer state: device {res['device']:,} B (banks' m, v "
              f"{bank_mv:,} = reckoned {reckoned:,}), host {res['host']:,} B "
              f"(dense m, v would take {8 * int(per_block.sum()):,} B on the "
              f"card)")
        masks = _record_masks(tr)
        torch.cuda.reset_peak_memory_stats()
        tr.train(warm)
        ops.reset_launches()                 # the main path's run
        tr.train(steps - warm)               # one log window
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        log = tr.log
        check(len(log.losses) == steps
              and all(math.isfinite(x) for x in log.losses),
              f"losses {log.losses}")
        n = steps - warm
        per_step = {name: c / n for name, c in launches.items()}
        want = {"paged_decode_attention": 0, "block_grad_sq_norms": 12,
                "masked_adamw": 0, "banked_masked_adamw": 12,
                "rmsnorm": 2 * nl + 1 + 2 * nl, "rmsnorm_bwd": 2 * nl + 1,
                **_flash_per_step(nl)}
        check(per_step == want, f"launches per step {per_step} != the "
              f"banked path's {want}")
        counts = opt["counts"]
        check(int(counts.sum().item()) == k * steps
              and all(int(mk.sum()) == k for mk in masks),
              f"counts sum {counts.sum().item()} != {k} x {steps}")
        m_full, v_full = masked_adamw.materialize_moments(pn, opt)
        nz = [a or b for a, b in zip(_block_nonzero(torch, pn, m_full),
                                     _block_nonzero(torch, pn, v_full))]
        counted = (counts.cpu() > 0).tolist()
        check(nz == counted, f"moments nonzero on blocks "
              f"{[i for i, f in enumerate(nz) if f]}, counted "
              f"{[i for i, f in enumerate(counted) if f]}")
        del m_full, v_full
        step_s = log.step_times[-1]
        stats = tr.step_fn.swap_stats.as_dict()
        print(f"  losses: {[round(x, 4) for x in log.losses]}")
        print(f"  step time (mean of the {n}-step window): "
              f"{step_s * 1e3:.2f} ms = {tokens / step_s:.0f} tokens/s "
              f"(dense, phase 7: median {dense['step_ms']:.2f} ms = "
              f"{dense['tokens_s']:.0f} tokens/s)")
        print(f"  peak device memory: {peak / 2**30:.2f} GiB (dense, phase "
              f"7: {dense['peak'] / 2**30:.2f} GiB)")
        print(f"  swap stats: {json.dumps(stats)}")
        print(f"  launches per step: {json.dumps(per_step)}; counts "
              f"{counts.int().tolist()} (sum {int(counts.sum().item())}); "
              f"moments nonzero on exactly the counted blocks")
        check(peak < dense["peak"], f"banked peak {peak} is not below the "
              f"dense peak {dense['peak']}")
        if async_swap:
            _profile_training(torch, tr)
        out[label] = {"launches": launches, "step_ms": step_s * 1e3,
                      "peak": peak, "stats": stats}
        del tr, opt, counts, masks
    print(f"banked step time: async {out['async']['step_ms']:.2f} ms, sync "
          f"{out['sync']['step_ms']:.2f} ms, dense (phase 7) "
          f"{dense['step_ms']:.2f} ms")
    _timing_rounds(torch, cfg, Trainer)
    return out["async"]


def _timing_rounds(torch, cfg, Trainer, rounds=3) -> None:
    """Step time of dense, banked async and banked sync in the same mode
    (8-step windows, one sync at the window's end; the banked step adds
    its indices read), in alternating rounds so that drift of the shared
    host hits all three alike."""
    gc.collect()
    torch.cuda.empty_cache()
    steps, n = TRAIN["steps"], TRAIN["steps"] - TRAIN["warmup"]
    kinds = {"dense": {}, "async": dict(moment_residency="banked",
                                        offload="host", async_swap=True),
             "sync": dict(moment_residency="banked", offload="host",
                          async_swap=False)}
    trs = {}
    for name, opt in kinds.items():
        trs[name] = Trainer(_train_cfg(
            cfg, "adagradselect", steps * (rounds + 1), TRAIN["global_batch"],
            TRAIN["seq_len"], log_every=10 ** 6, **opt), device="cuda")
        trs[name].train(TRAIN["warmup"])
    times = {name: [] for name in kinds}
    for _ in range(rounds):
        for name, tr in trs.items():
            tr.train(n)
            times[name].append(tr.log.step_times[-1] * 1e3)
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    print(f"  step time in {rounds} alternating rounds of {n}-step windows "
          f"(ms): " + ", ".join(
              f"{name} {[round(t, 2) for t in ts]} (median "
              f"{statistics.median(ts):.2f} = "
              f"{tokens / statistics.median(ts) * 1e3:.0f} tokens/s)"
              for name, ts in times.items()))


def _embed_admitted_then_evicted(masks) -> bool:
    on = [bool(m[0]) for m in masks]
    return any(on[i] and not any(on[i + 1:j]) and not on[j]
               for i in range(len(on)) for j in range(i + 1, len(on)))


def _pick_seed(torch, cfg, scfg, steps) -> int:
    """The first seed whose ``random`` masks (which depend only on the seed
    and the step) admit the embedding and later evict it."""
    from repro_torch.core import adagradselect
    nb = cfg.num_blocks
    for seed in range(64):
        st = adagradselect.init_state(nb, seed, policy="random",
                                      k=scfg.num_selected(nb), device="cuda")
        masks = []
        for _ in range(steps):
            m, st = adagradselect.select(scfg, st, torch.zeros(
                nb, device="cuda"), nb)
            masks.append(m.cpu())
        if _embed_admitted_then_evicted(masks):
            return seed
    raise PhaseFailed("no seed below 64 admits and then evicts the embedding")


def _copy_state(torch, state, device):
    import numpy as np
    if isinstance(state, dict):
        return {k: _copy_state(torch, v, device) for k, v in state.items()}
    if isinstance(state, torch.Tensor):
        return state.to(device).clone()
    if isinstance(state, np.ndarray):
        return state.copy()
    return state


def phase_banked_consistency(torch, ops, cfg, Trainer) -> None:
    from repro_torch.core import masked_adamw
    from repro_torch.core import partition as part_mod
    steps, lr = 4, 1e-3
    cfg = cfg.replace(dtype="float32", num_layers=2)
    pn = part_mod.build_partition(cfg)
    limit = 2 * lr * steps
    base = dict(lr=lr, schedule="constant", warmup_steps=0)
    # (a) random on the card: banked async, banked sync, dense
    probe = _train_cfg(cfg, "random", steps, 2, 64, k_percent=50.0)
    seed = _pick_seed(torch, cfg, dataclasses.replace(probe.select,
                                                      policy="random"), steps)
    trainers = {name: Trainer(_train_cfg(cfg, "random", steps, 2, 64,
                                         seed=seed, k_percent=50.0, **base,
                                         **opt), device="cuda")
                for name, opt in (
                    ("dense", {}),
                    ("async", dict(moment_residency="banked",
                                   offload="host", async_swap=True)),
                    ("sync", dict(moment_residency="banked",
                                  offload="host", async_swap=False)))}
    runs = {}
    for name, tr in trainers.items():
        for a, b in zip(_leaves(tr.state["params"]),   # one initial state
                        _leaves(trainers["dense"].state["params"])):
            a.copy_(b)
    for name, tr in trainers.items():
        masks = _record_masks(tr)
        ops.reset_launches()
        tr.train(steps)
        runs[name] = (tr, [m.cpu() for m in masks], dict(ops.LAUNCHES))
    del trainers
    dense, dmasks, _ = runs["dense"]
    check(_embed_admitted_then_evicted(dmasks),
          f"seed {seed}: the masks do not admit and then evict the embedding")
    worst, bits, rtol = 0.0, True, 1e-5
    for name in ("async", "sync"):
        tr, masks, launches = runs[name]
        check(launches["banked_masked_adamw"] > 0
              and launches["masked_adamw"] == 0,
              f"banked {name}: launches {launches}")
        for i, (a, b) in enumerate(zip(masks, dmasks)):
            check(torch.equal(a, b), f"banked {name} step {i}: mask "
                  f"{a.int().tolist()} != dense {b.int().tolist()}")
        rel = max(abs(a - b) / abs(b) for a, b in zip(tr.log.losses,
                                                       dense.log.losses))
        check(rel <= 1e-4, f"banked {name}: loss rel err {rel}")
        m, v = masked_adamw.materialize_moments(pn, tr.state["opt"])
        # one card, one kernel order: each leaf of params, m and v within
        # 1e-5 of its own largest magnitude (bit-equal in practice; a wrong
        # update or moment row is off by its whole size)
        for what, got, want in (
                ("params", tr.state["params"], dense.state["params"]),
                ("m", m, dense.state["opt"]["m"]),
                ("v", v, dense.state["opt"]["v"])):
            for a, b in zip(part_mod.leaves(got), part_mod.leaves(want)):
                a, b = a.cpu(), b.cpu()
                err = (a - b).abs().max().item()
                scale = b.abs().max().item()
                worst = max(worst, err / scale if scale else err)
                bits &= torch.equal(a, b)
                check(err <= rtol * scale, f"banked {name}: {what} leaf "
                      f"{tuple(b.shape)} differs from dense by {err} > "
                      f"{rtol} x {scale}")
    stats = runs["async"][0].step_fn.swap_stats
    check(stats.boundaries >= 1 and stats.predicted_hits >= 1
          and stats.mispredicts == 0 and stats.dispatched_hit_rate == 1.0,
          f"async swap stats {stats.as_dict()}: want every boundary that "
          f"had a prediction in flight to hit")
    print(f"banked consistency (a) (f32, TF32 off, {cfg.num_layers} layers at "
          f"full width, k = 50%, batch 2 x 64, {steps} random steps, seed "
          f"{seed}): masks {[m.nonzero()[:, 0].tolist() for m in dmasks]} "
          f"equal for banked async, banked sync and dense (the embedding "
          f"admitted and later evicted); loss max rel err {rel:.2e} (limit "
          f"1e-4); params, m and v per leaf max |err| / max |dense| "
          f"{worst:.3g} (limit {rtol:g}), bit-equal: {bits}; async hit rate "
          f"{stats.predicted_hit_rate:.3f} of all boundaries (the first is "
          f"unpredicted), {stats.dispatched_hit_rate:.3f} of predicted "
          f"ones; async swap stats {json.dumps(stats.as_dict())}")
    del runs, dense
    # (b) topk_grad: banked async on the card against banked on the CPU
    tcfg = _train_cfg(cfg, "topk_grad", steps, 2, 64, k_percent=50.0,
                      moment_residency="banked", offload="host",
                      async_swap=True, **base)
    card = Trainer(tcfg, device="cuda")
    cpu = Trainer(tcfg, device="cpu")
    cpu.state = _copy_state(torch, card.state, "cpu")
    cmasks, hmasks = _record_masks(card), _record_masks(cpu)
    ops.reset_launches()
    card.train(steps)
    launches = dict(ops.LAUNCHES)
    cpu.train(steps)
    check(launches["banked_masked_adamw"] > 0,
          f"(b): the banked kernel did not run on the card: {launches}")
    for i, (a, b) in enumerate(zip(cmasks, hmasks)):
        check(torch.equal(a.cpu(), b), f"(b) step {i}: card mask "
              f"{a.int().tolist()} != cpu {b.int().tolist()}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.log.losses,
                                                   cpu.log.losses))
    check(rel <= 1e-4, f"(b): loss rel err {rel}")
    worst = max((a.cpu() - b).abs().max().item() for a, b in
                zip(_leaves(card.state["params"]),
                    _leaves(cpu.state["params"])))
    check(worst <= limit, f"(b): params differ by {worst} > {limit}")
    print(f"banked consistency (b) ({steps} topk_grad steps, banked async on "
          f"the card vs banked on the CPU): losses "
          f"{[round(x, 6) for x in card.log.losses]}, max rel err {rel:.2e} "
          f"(limit 1e-4); masks equal at every step; params max |err| "
          f"{worst:.3g} (limit {limit:g}); card swap stats "
          f"{json.dumps(card.step_fn.swap_stats.as_dict())}")


# ------------------------------------------------------ flash attention


def _packed_segments(b, s, seed=0):
    """The segment ids of a real packed batch of b x s tokens."""
    from repro_torch.data.pipeline import SyntheticMathRecords, packing
    from repro_torch.data.synthetic import MathTaskConfig
    src = SyntheticMathRecords(MathTaskConfig(seq_len=s, seed=seed))
    batch, _ = packing.pack_batch(src, 0, b, s)
    return batch["segment_ids"]


def _flash_case(torch, dtype, b, s, d, segmented, seed=0, q_scale=None):
    """qwen2.5-0.5b's head map (16 q heads, 7 on kv head 0, 9 on kv head
    1: the two padded ones clamp onto the last); N(0, 1) k, v and do; in
    bf16 q = 3 N(0, 1), a peaked softmax whose outputs stay large beside
    the 2e-2 tolerance, in f32 q = N(0, 1) unless ``q_scale`` says
    otherwise (the peaked f32 case is held against f64: ``_flash_f64``)."""
    h, kvh = 16, 2
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g,
                                    device="cuda")).to(dt)
    if q_scale is None:
        q_scale = 3.0 if dtype == "bfloat16" else 1.0
    q = rnd(b, s, h, d, scale=q_scale)
    k, v, do = rnd(b, s, kvh, d), rnd(b, s, kvh, d), rnd(b, s, h, d)
    hmap = torch.tensor([min(i // 7, kvh - 1) for i in range(h)],
                        dtype=torch.int32, device="cuda")
    seg = (torch.as_tensor(_packed_segments(b, s), device="cuda")
           if segmented else None)
    return q, k, v, do, hmap, seg


def _flash_work(torch, q, k, seg):
    """(pairs, bytes of q, of k): the (query, key) pairs that attend (causal,
    and within a segment), summed over the rows, and one operand's bytes."""
    b, s = q.shape[:2]
    pos = torch.arange(s, device="cuda")
    ok = (pos[:, None] >= pos[None, :])[None]
    if seg is not None:
        ok = ok & (seg[:, :, None] == seg[:, None, :])
    pairs = int(ok.expand(b, s, s).sum().item())
    return pairs, q.numel() * q.element_size(), k.numel() * k.element_size()


def phase_flash_kernels(torch, ops, ref, _fa, timer) -> dict:
    """Rows 4-6 against their plain versions; returns the summary entries
    at the packed training shape (bf16)."""
    F = torch.nn.functional
    cases = [("train causal", 8, 512, 64, False, True),
             ("train packed", 8, 512, 64, True, True),
             ("ragged S=300", 2, 300, 64, True, True),
             ("D=128", 2, 512, 128, True, True),
             ("non-causal", 2, 512, 64, True, False)]
    rows, main = [], {}
    for dtype in ("bfloat16", "float32"):
        for label, b, s, d, segmented, causal in cases:
            q, k, v, do, hm, seg = _flash_case(torch, dtype, b, s, d,
                                               segmented)
            mode = dict(causal=causal, segment_ids=seg)
            n0 = dict(ops.LAUNCHES)
            o, lse = ops.flash_attention_fwd(q, k, v, hm, **mode)
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                                 **mode)
            _, dk2, dv2 = ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                                  **mode)
            torch.cuda.synchronize()
            check(all(ops.LAUNCHES[n] - n0[n] == w for n, w in (
                ("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 2),
                ("flash_attention_bwd_dkv", 2))),
                "the flash wrappers did not count their launches")
            check(_bits_equal(torch, dk, dk2) and _bits_equal(torch, dv, dv2),
                  f"flash {label} {dtype}: dk/dv differ between two launches")
            po, plse = ref.flash_attention_fwd(q, k, v, hm, seg, causal)
            pq, pk, pv = ref.flash_attention_bwd(q, k, v, o, lse, do, hm, seg,
                                                 causal)
            what = f"flash {label}"
            errs = {"o": _check_close(torch, o, po, dtype, f"{what} o"),
                    "lse": _check_close(torch, lse, plse, "float32",
                                        f"{what} lse ({dtype} inputs)")}
            for name, got, want in (("dq", dq, pq), ("dk", dk, pk),
                                    ("dv", dv, pv)):
                errs[name] = _check_close(torch, got, want, dtype,
                                          f"{what} {name}")
            if label.startswith("train"):
                rows += _flash_times(torch, F, ref, _fa, timer, dtype, label,
                                     q, k, v, do, o, lse, hm, seg, errs)
                if label == "train packed" and dtype == "bfloat16":
                    main.update({r["kernel"]: r for r in rows[-3:]})
            print(f"  flash {label:<13} {dtype:<9} B={b} S={s} H=16 KVH=2 "
                  f"D={d}{' segmented' if segmented else ''}"
                  f"{' causal' if causal else ' non-causal'}: max "
                  f"|err| " + ", ".join(f"{n} {e:.2e}"
                                        for n, e in errs.items())
                  + f" (rtol=atol {TOL[dtype]:.0e}); dk/dv bit-identical "
                  f"over two launches")
            del q, k, v, do, o, lse, dq, dk, dv, dk2, dv2, po, pq, pk, pv
    for label, b, s, d in (("train packed", 8, 512, 64), ("D=128", 2, 512,
                                                          128)):
        _flash_f64(torch, ops, ref, label, b, s, d)
    print("flash kernels at the training shape (CUDA events, L2 flushed, ms "
          "per call):")
    for r in rows:
        print(f"  {r['kernel']:<24} {r['case']:<12} {r['dtype']:<9} "
              f"err {r['max_abs_err']:.2e}  kernel {r['ms']:.4f}  plain "
              f"{r['plain_ms']:.4f}  library {r['library_ms']:.4f}  bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']})  {r['shape']}")
    print("  plain ms of dq and dk/dv: the plain backward, which computes "
          "dq, dk and dv at once (delta included); library: "
          "F.scaled_dot_product_attention(is_causal=True, enable_gqa=True), "
          "with a boolean causal block-diagonal mask when segmented, and "
          "its autograd backward for both dq and dk/dv (timed only)")
    return main


def _flash_f64(torch, ops, ref, label, b, s, d) -> None:
    """f32 at q = 3 N(0, 1) (a peaked softmax), segmented and causal: the
    kernels' outputs and the plain f32 versions' both against the plain
    version evaluated in f64 on the same inputs, each as max |err| / (tol +
    tol |f64|) (at most 1 is within the f32 tolerance). Fails unless each
    output of the kernels is within the tolerance of f64 or no further
    from it than the plain f32 version."""
    q, k, v, do, hm, seg = _flash_case(torch, "float32", b, s, d, True,
                                       q_scale=3.0)
    o, lse = ops.flash_attention_fwd(q, k, v, hm, segment_ids=seg)
    kern = (o, lse, *ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                             segment_ids=seg))
    po, plse = ref.flash_attention_fwd(q, k, v, hm, seg)
    plain = (po, plse, *ref.flash_attention_bwd(q, k, v, po, plse, do, hm,
                                                seg))
    x64 = [t.double() for t in (q, k, v, do)]
    xo, xlse = ref.flash_attention_fwd(*x64[:3], hm, seg)
    exact = (xo, xlse, *ref.flash_attention_bwd(*x64[:3], xo, xlse, x64[3],
                                                hm, seg))
    tol = TOL["float32"]
    out, worse = [], []
    for name, got, pl, x in zip(("o", "lse", "dq", "dk", "dv"), kern, plain,
                                exact):
        check(x.dtype == torch.float64, f"flash f64 {name}: {x.dtype}")
        ek, ep = ((t.double() - x).abs().div(tol + tol * x.abs()).max()
                  .item() for t in (got, pl))
        out.append(f"{name} {ek:.3g}/{ep:.3g}")
        if ek > max(1.0, ep):
            worse.append(name)
    print(f"  flash {label:<13} f32 q=3N(0,1) B={b} S={s} H=16 KVH=2 D={d} "
          f"segmented causal, max |err| / (tol + tol |f64|) against the f64 "
          f"plain version, kernel/plain f32: " + ", ".join(out)
          + " (kernel must be <= max(1, plain))")
    check(not worse, f"flash {label} f32 peaked: the kernels' {worse} are "
          f"further from f64 than the plain version's and than the tolerance")
    del q, k, v, do, kern, plain, x64, exact


def _flash_times(torch, F, ref, _fa, timer, dtype, label, q, k, v, do, o,
                 lse, hm, seg, errs) -> list:
    pairs, q_bytes, kv_bytes = _flash_work(torch, q, k, seg)
    b, s, h, d = q.shape
    lse_b = b * h * s * 4                     # lse, and delta alike
    idx = (0 if seg is None else b * s * 4) + h * 4
    delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
    dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
    o2, lse2 = torch.empty_like(o), torch.empty_like(lse)
    # the library call: SDPA in its [B, H, S, D] layout (its GQA map is
    # h // 8, not the port's, which moves no work), timed only
    ql, kl, vl, dol = (t.transpose(1, 2).contiguous() for t in (q, k, v, do))
    mask = None
    if seg is not None:
        pos = torch.arange(s, device="cuda")
        mask = ((pos[:, None] >= pos[None, :])[None]
                & (seg[:, :, None] == seg[:, None, :]))[:, None]
    qg, kg, vg = (t.clone().requires_grad_() for t in (ql, kl, vl))

    def sdpa():
        return F.scaled_dot_product_attention(
            qg, kg, vg, attn_mask=mask, is_causal=mask is None,
            enable_gqa=True)
    out_l = sdpa()
    lib_fwd = timer.ms(lambda: sdpa().detach(), reps=10)
    lib_bwd = timer.ms(lambda: torch.autograd.grad(
        out_l, (qg, kg, vg), dol, retain_graph=True), reps=10)
    plain_fwd = timer.ms(lambda: ref.flash_attention_fwd(q, k, v, hm, seg),
                         reps=5)
    plain_bwd = timer.ms(lambda: ref.flash_attention_bwd(
        q, k, v, o, lse, do, hm, seg), reps=5)
    shape = (f"B={b} S={s} H={h} KVH={k.shape[2]} D={d}, {pairs} attending "
             f"pairs")
    out = []
    for kernel, fn, n_mm, nbytes, err, plain, lib in (
            ("flash_attention_fwd",
             lambda: _fa.launch_fwd(q, k, v, seg, hm, True, o2, lse2),
             2, 2 * q_bytes + 2 * kv_bytes + lse_b + idx,
             max(errs["o"], errs["lse"]), plain_fwd, lib_fwd),
            ("flash_attention_bwd_dq",
             lambda: _fa.launch_bwd_dq(q, k, v, do, lse, delta, seg, hm,
                                       True, dq),
             3, 3 * q_bytes + 2 * kv_bytes + 2 * lse_b + idx, errs["dq"],
             plain_bwd,
             lib_bwd),
            ("flash_attention_bwd_dkv",
             lambda: _fa.launch_bwd_dkv(q, k, v, do, lse, delta, seg, hm,
                                        True, dk, dv),
             4, 2 * q_bytes + 4 * kv_bytes + 2 * lse_b + idx,
             max(errs["dk"], errs["dv"]), plain_bwd, lib_bwd)):
        # each matrix product of the kernel: 2 D flops per attending pair
        # and q head
        bms, by = bound_ms(nbytes, n_mm * 2 * d * h * pairs, dtype)
        out.append(dict(kernel=kernel, case=label.split()[1], dtype=dtype,
                        shape=shape, max_abs_err=err, tol=TOL[dtype],
                        ms=timer.ms(fn), plain_ms=plain, library_ms=lib,
                        bound_ms=bms, bound_by=by))
    return out


def phase_packed_training(torch, ops, cfg, Trainer, loader, dense) -> dict:
    """Phase 7's run on the packed synthetic records."""
    steps, warm = TRAIN["steps"], TRAIN["warmup"]
    gb, sl = TRAIN["global_batch"], TRAIN["seq_len"]
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = _train_cfg(cfg, "adagradselect", steps, gb, sl)
    data = loader.make_source("packed_math", seq_len=sl, global_batch=gb,
                              seed=tcfg.seed)
    tr = Trainer(tcfg, data_source=data, device="cuda")
    k = tr.sel_cfg.num_selected(cfg.num_blocks)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # the main path's run
    for _ in range(steps):
        tr.train(1)
    launches = dict(ops.LAUNCHES)
    log = tr.log
    peak = torch.cuda.max_memory_allocated()
    check(len(log.losses) == steps and all(math.isfinite(x)
                                           for x in log.losses),
          f"losses {log.losses}")
    n_sel = [mt["num_selected"] for mt in log.metrics]
    check(n_sel == [k] * steps, f"num_selected per step {n_sel}, want {k}")
    per_step = {name: n / steps for name, n in launches.items()}
    nl = cfg.num_layers
    want = {"paged_decode_attention": 0, "block_grad_sq_norms": 12,
            "masked_adamw": 12, "banked_masked_adamw": 0,
            "rmsnorm": 4 * nl + 1, "rmsnorm_bwd": 2 * nl + 1,
            **_flash_per_step(nl)}
    check(per_step == want, f"launches per step {per_step} != the packed "
          f"path's {want}")
    check(data.cursor()["record"] == sum(log.records),
          f"cursor {data.cursor()} != {sum(log.records)} records trained")
    med = statistics.median(log.step_times[warm:])
    tokens = gb * sl
    real = statistics.mean(log.real_tokens)
    recs = statistics.mean(log.records)
    print(f"packed training {cfg.name} ({cfg.dtype}): adagradselect, k = "
          f"{k}, packed synthetic records, batch {gb} x {sl}, {steps} steps")
    print(f"  losses: {[round(x, 4) for x in log.losses]}")
    print(f"  step time (median of steps {warm}..{steps - 1}): "
          f"{med * 1e3:.2f} ms = {tokens / med:.0f} tokens/s, "
          f"{real / med:.0f} non-pad tokens/s; {real:.1f} non-pad tokens "
          f"({real / tokens:.3f}) and {recs:.1f} records a step (unpacked, "
          f"phase 7: {dense['step_ms']:.2f} ms for {gb} records); all steps "
          f"(ms): {[round(t * 1e3, 2) for t in log.step_times]}")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB (phase 7: "
          f"{dense['peak'] / 2**30:.2f} GiB)")
    print(f"  launches per step: {json.dumps(per_step)}")
    _profile_training(torch, tr)
    return {"launches": launches}


def phase_packed_consistency(torch, ops, cfg, Trainer, loader, lm,
                             step) -> None:
    from repro_torch.data.pipeline import SyntheticMathRecords, packing
    from repro_torch.data.synthetic import MathTaskConfig
    cfg = cfg.replace(dtype="float32", num_layers=2)
    # (a) packed = unpacked oracle on the card
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    src = SyntheticMathRecords(MathTaskConfig(seq_len=512))
    packed, n = packing.pack_batch(src, 0, 2, 512)
    unpacked, _ = packing.unpacked_batch(src, 0, n, 64)

    def run(batch):
        dev = {key: torch.as_tensor(a, device="cuda")
               for key, a in batch.items()}
        (loss, _), grads = step.value_and_grad(
            lambda p, mb: step.model_loss(cfg, p, mb), params, dev)
        return loss.item(), grads
    ops.reset_launches()
    lp, gp = run(packed)
    lu, gu = run(unpacked)
    launches = dict(ops.LAUNCHES)
    check(all(launches[name] > 0 for name in _flash_per_step(1)),
          f"(a): the flash kernels did not run: {launches}")
    check(abs(lp - lu) <= 1e-5 * abs(lu), f"(a): packed loss {lp} != "
          f"unpacked {lu}")
    worst = 0.0
    for a, b in zip(_leaves(gp), _leaves(gu)):
        err = (a - b).abs().max().item()
        scale = b.abs().max().item()
        worst = max(worst, err / scale if scale else err)
        check(err <= 1e-5 * scale, f"(a): gradient leaf {tuple(b.shape)} "
              f"differs by {err} > 1e-5 x {scale}")
    print(f"packed consistency (a) (f32, TF32 off, {cfg.num_layers} layers "
          f"at full width, on the card): a 2 x 512 packed batch of {n} "
          f"records against the same records one a row (x 64): loss "
          f"{lp:.6f} vs {lu:.6f} (rel err {abs(lp - lu) / abs(lu):.2e}, "
          f"limit 1e-5); gradients per leaf max |err| / max |unpacked| "
          f"{worst:.3g} (limit 1e-5)")
    del params, gp, gu
    # (b) packed topk_grad steps, card against CPU
    steps, lr = 3, 1e-3
    tcfg = _train_cfg(cfg, "topk_grad", steps, 2, 128, lr=lr,
                      schedule="constant", warmup_steps=0)

    def pipe():
        return loader.make_source("packed_math", seq_len=128, global_batch=2,
                                  seed=tcfg.seed)
    card = Trainer(tcfg, data_source=pipe(), device="cuda")
    cpu = Trainer(tcfg, data_source=pipe(), device="cpu")
    cpu.state = _to(card.state, "cpu")
    start = [t.clone() for t in _leaves(cpu.state["params"])]
    ops.reset_launches()
    for i in range(steps):
        card.train(1)
        cpu.train(1)
        lc, lh = card.log.losses[-1], cpu.log.losses[-1]
        check(abs(lc - lh) <= 1e-4 * abs(lh),
              f"(b) step {i}: loss card {lc} vs cpu {lh}")
        mc = card.state["sel"]["mask"].cpu()
        check(torch.equal(mc, cpu.state["sel"]["mask"]),
              f"(b) step {i}: masks differ: card {mc.int().tolist()} cpu "
              f"{cpu.state['sel']['mask'].int().tolist()}")
    launches = dict(ops.LAUNCHES)
    check(all(launches[name] > 0 for name in _flash_per_step(1)),
          f"(b): the flash kernels did not run on the card: {launches}")
    # each leaf's card update within PACKED_UPDATE_RTOL of the largest
    # entry of its CPU update (a leaf the CPU left alone stays bit-equal)
    ratios = []
    for a, b, b0 in zip(_leaves(card.state["params"]),
                        _leaves(cpu.state["params"]), start):
        err = (a.cpu() - b).abs().max().item()
        scale = (b - b0).abs().max().item()
        ratios.append((err / scale if scale else math.inf if err else 0.0,
                       tuple(b.shape)))
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.log.losses,
                                                   cpu.log.losses))
    print(f"packed consistency (b) ({steps} packed topk_grad steps, batch 2 "
          f"x 128 ({card.log.records} records), card vs CPU): losses "
          f"{[round(x, 6) for x in card.log.losses]}, max rel err "
          f"{rel:.2e} (limit 1e-4); masks equal at every step; params per "
          f"leaf max |card - cpu| / max |cpu update| {max(ratios)[0]:.3g} "
          f"at {max(ratios)[1]} (limit {PACKED_UPDATE_RTOL:g}), all leaves "
          f"{[f'{r:.2g}' for r, _ in ratios]}; card launches "
          f"{json.dumps(launches)}")
    check(max(ratios)[0] <= PACKED_UPDATE_RTOL, f"(b): params leaf "
          f"{max(ratios)[1]} differs by {max(ratios)[0]} of its CPU update's "
          f"largest entry > {PACKED_UPDATE_RTOL}")


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
        from repro_torch.data import loader
        from repro_torch.kernels import _build, ops, ref
        from repro_torch.kernels import flash_attention as _fa
        from repro_torch.models import lm
        from repro_torch.serve import Request, ServeConfig, ServeEngine
        from repro_torch.train import step
        from repro_torch.train.trainer import Trainer
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
        phase = "train kernels"
        main_rows.update(phase_train_kernels(torch, ops, ref, Timer(torch)))
        phase = "training"
        training = phase_training(torch, ops, cfg, Trainer)
        phase = "train consistency"
        phase_train_consistency(torch, ops, cfg, Trainer)
        phase = "banked kernel"
        main_rows.update(phase_banked_kernel(torch, ops, ref, Timer(torch)))
        phase = "banked training"
        banked = phase_banked_training(torch, ops, cfg, Trainer, training)
        phase = "banked consistency"
        phase_banked_consistency(torch, ops, cfg, Trainer)
        phase = "flash kernels"
        main_rows.update(phase_flash_kernels(torch, ops, ref, _fa,
                                             Timer(torch)))
        phase = "packed training"
        packed = phase_packed_training(torch, ops, cfg, Trainer, loader,
                                       training)
        phase = "packed consistency"
        phase_packed_consistency(torch, ops, cfg, Trainer, loader, lm, step)
    except Exception:   # the boundary: report the failed phase, exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase!r} FAILED", file=sys.stderr)
        return 1
    sources = {"paged_decode_attention": (
        "cuda", "src/repro_torch/csrc/paged_decode_attention.cu",
        "src/repro/kernels/decode_attention.py:95"),
        "rmsnorm": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                    "src/repro/kernels/rmsnorm.py:13"),
        # no TPU kernel: the JAX package differentiates norms.apply in XLA;
        # this is the TPU kernel whose forward it completes
        "rmsnorm_bwd": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                        "src/repro/kernels/rmsnorm.py:13"),
        "block_grad_sq_norms": (
            "triton", "src/repro_torch/kernels/block_grad_norm.py",
            "src/repro/kernels/block_grad_norm.py:21"),
        "masked_adamw": ("triton", "src/repro_torch/kernels/masked_adamw.py",
                         "src/repro/kernels/masked_adamw.py:34"),
        "banked_masked_adamw": (
            "triton", "src/repro_torch/kernels/masked_adamw.py",
            "src/repro/kernels/masked_adamw.py:80")}
    flash_src = "src/repro_torch/csrc/flash_attention.cu"
    sources.update({
        "flash_attention_fwd": ("cuda", flash_src,
                                "src/repro/kernels/flash_attention.py:33"),
        "flash_attention_bwd_dq": ("cuda", flash_src,
                                   "src/repro/kernels/flash_attention.py:117"),
        "flash_attention_bwd_dkv": (
            "cuda", flash_src, "src/repro/kernels/flash_attention.py:154")})
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = main_rows[name]
        # launches of the main-path runs: serving (phase 4) + training (7),
        # the banked training window (phase 10) for the banked kernel, and
        # training (7), banked training (10) and packed training (13) for
        # the flash kernels
        if name == "banked_masked_adamw":
            launches = banked["launches"][name]
        elif name.startswith("flash"):
            launches = (training["launches"][name]
                        + banked["launches"][name] + packed["launches"][name])
        else:
            launches = serving["launches"][name] + training["launches"][name]
        kernels.append(dict(
            name=name, route=route, source=source, replaces=replaces,
            launches=launches, max_abs_err=r["max_abs_err"],
            ms=r["ms"], plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r["library_ms"]))
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
