"""One phase of ``chip_smoke.py`` on other checkouts of the port and on this
one, alternated, so that their numbers come from the same card in one run.

    python3 tools/phase_ab.py --phase decode OTHER [OTHER ...] [--rounds 2]
        [--flush clean]

``--phase`` is ``kernels`` (phase 3: rows 1 and 2, then the host time an
``ops.rmsnorm`` call takes to enqueue at [4, 896]), ``arch_kernels``
(phase 33: rows 1, 3 and 2 at the other dense archs' shapes), ``packed``
(phase 14: f32 packed training, the card against the CPU), ``serve``
(phase 4, serving at full width on the paged layout), ``train_kernels``
(phase 6: rows 7, 8 and 2b), ``flash`` (phase 12), ``decode`` (phase 15)
or ``eval`` (phase 16, the greedy eval at full width). ``--flush clean``
has the timed phases' ``Timer`` read a 64 MiB buffer before each launch in
place of its 64 MiB write, so that L2 holds clean lines only and a timed
kernel's misses write nothing back (the default, ``write``, is the
``Timer``'s own). For ``eval`` this checkout's
phase 7 trains once first and its params, saved under ``build/phase_ab/``,
are the ones every checkout evaluates. Each round runs the phase of every
OTHER and then of this checkout, each in a process of its own that first
builds that checkout's kernels. Each run's output goes to a log under
``--logs`` (default ``build/phase_ab/``); one JSON line a run follows it on
stdout: the kernel rows of the phase's summary table (for ``decode`` also
a digest of row 3's output bits at the eval shape, bf16 and f32, from that
checkout's kernel on the same inputs; for ``flash`` one of rows 4-6's at
the packed training shape and causal at 16 x 2048), or, for ``eval``,
tok/s and the
seconds of its two eval calls and the device time and idle share of its
profiled engine steps.

``serve`` is paired instead, since the host's speed drifts between
processes: one process a checkout runs phase 4 (its checks and profile)
and then waits; each round then times one more serving run of each, in
turn (ABBA order), so that neighbouring runs of two checkouts see the same
host. At the end each measures the host time a call of
``ops.paged_decode_attention`` takes to enqueue. One JSON line a checkout
(phase 4's tok/s and kernel launches, the rounds' tok/s and their median,
that host time, and the wall time, device time, idle share and paged
decode device time of the profiled run) and one of this checkout's tok/s over each OTHER's, round by
round, follow. Needs one CUDA card; run it from the root of this checkout.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import re
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "phase_ab"
PHASES = {"kernels": "phase_kernels", "arch_kernels": "phase_arch_kernels",
          "packed": "phase_packed_consistency", "serve": "phase_serving",
          "train_kernels": "phase_train_kernels",
          "flash": "phase_flash_kernels", "decode": "phase_decode_kernel",
          "eval": "phase_eval"}
HOST_BATCHES, HOST_CALLS = 20, 200   # paged decode calls timed on the host


class _CleanFlush:
    """Stands in for a ``Timer``'s flush buffer under ``--flush clean``: its
    ``zero_`` reads 64 MiB (more than the 50 MB L2; the largest byte into
    one) instead of writing them, which evicts what L2 held, dirty lines
    included, and leaves it holding clean lines only."""

    def __init__(self, torch):
        self.torch = torch
        self.buf = torch.ones(64 << 20, dtype=torch.uint8, device="cuda")
        self.out = torch.empty((), dtype=torch.uint8, device="cuda")

    def zero_(self):
        self.torch.amax(self.buf, dim=0, out=self.out)


def _chip_smoke(checkout: Path):
    """That checkout's chip_smoke.py as a module (it puts its own src/ first
    on sys.path when imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", checkout / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _run_phase(checkout: Path, phase: str, params: Path,
               flush: str = "write") -> None:
    """In a worker process: build that checkout's kernels and run its
    phase; ``eval`` reads the params that ``train`` (phase 7) saved."""
    cs = _chip_smoke(checkout)
    import torch

    from repro_torch.configs import get_config
    from repro_torch.kernels import _build, ops, ref
    from repro_torch.kernels import decode_attention as _dec
    from repro_torch.kernels import flash_attention as _fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cs.phase_build(_build)
    cfg = get_config(cs.ARCH)
    if phase == "train":
        from repro_torch.train.trainer import Trainer
        training = cs.phase_training(torch, ops, cfg, Trainer)
        torch.save({"eval_params": training["eval_params"],
                    "task": training["task"]}, params)
    elif phase == "serve":
        _serve(cs, torch, ops, cfg)
    elif phase == "packed":
        from repro_torch.data import loader
        from repro_torch.models import lm
        from repro_torch.train import step
        from repro_torch.train.trainer import Trainer
        cs.phase_packed_consistency(torch, ops, cfg, Trainer, loader, lm,
                                    step)
    elif phase == "eval":
        from repro_torch.train import evaluate
        cs.phase_eval(torch, ops, cfg, evaluate,
                      torch.load(params, weights_only=False))
    else:   # an older checkout's phase may take fewer modules
        fn = getattr(cs, PHASES[phase])
        mods = {"_dec": _dec, "_fa": _fa}
        timer = cs.Timer(torch)
        if flush == "clean":
            timer.flush = _CleanFlush(torch)
        fn(torch, ops, ref, *(mods[p] for p in inspect.signature(fn)
                              .parameters if p in mods), timer)
        if phase == "kernels":
            _norm_host_us(torch, ops)
        if phase == "decode":
            _row3_bits(cs, torch, ops)
        if phase == "flash":
            _flash_bits(cs, torch, ops)


def _serve(cs, torch, ops, cfg) -> None:
    """Phase 4, then one more run of its requests on params made from the
    same seed for each line read from stdin, each timed as phase 4 times
    its run; at the end of stdin, the paged decode's host time a call."""
    from repro_torch.models import lm
    from repro_torch.serve import Request, ServeConfig, ServeEngine
    cs.phase_serving(torch, ops, lm, cfg, ServeEngine, ServeConfig, Request)
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    print("ready", flush=True)
    for i, _ in enumerate(sys.stdin):
        _, res, dt = cs._serve_once(torch, cfg, params, ServeEngine,
                                    ServeConfig, Request)
        gen = sum(len(t) for t in res.values())
        print(f"serve run {i}: {gen} tokens in {dt:.3f} s = "
              f"{gen / dt:.1f} tok/s", flush=True)
    _paged_host_us(cs, torch, ops)


def _host_us(torch, what: str, fn) -> None:
    """Prints the host microseconds that a call of fn takes to enqueue:
    ``HOST_BATCHES`` batches of ``HOST_CALLS`` calls, each made with no
    sync and followed by one; the least and the median batch."""
    per_call = []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    per_call.sort()
    print(f"{what} host time: least {per_call[0]:.2f} us, median "
          f"{per_call[len(per_call) // 2]:.2f} us a call ({HOST_BATCHES} x "
          f"{HOST_CALLS} calls)")


def _paged_host_us(cs, torch, ops) -> None:
    """The host time of ``ops.paged_decode_attention`` at phase 3's serving
    shape (bf16, B 4, valid_len 1/17/300/512). The serving path is
    host-bound, so this is the launcher's share of it."""
    args = cs._paged_inputs(torch, "bfloat16", 4, [1, 17, 300, 512])
    _host_us(torch, "paged decode",
             lambda: ops.paged_decode_attention(*args))


def _norm_host_us(torch, ops) -> None:
    """The host time of ``ops.rmsnorm`` at [4, 896] bf16, a decode step's
    row block."""
    x = torch.ones(4, 896, dtype=torch.bfloat16, device="cuda")
    s = torch.ones(896, dtype=torch.bfloat16, device="cuda")
    _host_us(torch, "rmsnorm", lambda: ops.rmsnorm(x, s, 1e-6))


def _row3_bits(cs, torch, ops) -> None:
    """A digest of row 3's output bits at the eval shape, bf16 and f32, on
    inputs that every checkout's ``_decode_case`` makes alike."""
    import hashlib
    bits = {}
    for dtype in ("bfloat16", "float32"):
        q, k, v, vl, hm = cs._decode_case(torch, dtype, 16, 512,
                                          cs.DECODE_EVAL_VL)
        out = ops.decode_attention(q, k, v, vl, hm)
        raw = out.view({"bfloat16": torch.int16,
                        "float32": torch.int32}[dtype]).cpu().numpy()
        bits[dtype] = hashlib.sha256(raw.tobytes()).hexdigest()[:16]
    print(f"row 3 bits: {json.dumps(bits)}")


def _flash_bits(cs, torch, ops) -> None:
    """A digest of rows 4-6's output bits (o, lse, dq, dk, dv) at the
    packed training shape (B 8, S 512, D 64) and causal at B 16 x S 2048,
    bf16 and f32, on inputs that every checkout's ``_flash_case`` makes
    alike."""
    import hashlib
    bits = {}
    for dtype in ("bfloat16", "float32"):
        for label, b, s, seg in (("packed", 8, 512, "packed"),
                                 ("causal", 16, 2048, None)):
            q, k, v, do, hm, sg = cs._flash_case(torch, dtype, b, s, 64, seg)
            o, lse = ops.flash_attention_fwd(q, k, v, hm, segment_ids=sg)
            outs = (o, lse, *ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                                    segment_ids=sg))
            h = hashlib.sha256()
            for t in outs:
                h.update(t.contiguous().view(torch.uint8).cpu().numpy()
                         .tobytes())
            bits[f"{dtype} {label}"] = h.hexdigest()[:16]
    print(f"flash bits: {json.dumps(bits)}")


def _worker(checkout: Path, phase: str, params: Path, log: Path,
            flush: str = "write") -> int:
    with open(log, "w") as f:
        return subprocess.run(
            [sys.executable, __file__, "--worker", str(checkout), phase,
             str(params), "--flush", flush], stdout=f,
            stderr=subprocess.STDOUT, cwd=ROOT).returncode


def _serve_summary(text: str) -> dict:
    run = re.search(r"^  run: .*= ([\d.]+) tok/s", text, re.M)
    prof = re.search(r"profile \(.*?profiler on\): wall ([\d.]+) "
                     r"ms, device kernels ([\d.]+) ms, device idle share "
                     r"([\d.]+)", text)
    # the profile's top kernels: the paged decode is the one named *decode*
    decode = [float(m) for m in re.findall(
        r"^ +([\d.]+) ms +\d+x +.*decode_kernel", text, re.M)]
    runs = [float(m) for m in re.findall(r"^serve run \d+: .*= ([\d.]+) "
                                         r"tok/s", text, re.M)]
    host = re.search(r"^paged decode host time: least ([\d.]+) us, median "
                     r"([\d.]+) us", text, re.M)
    launches = re.search(r"^  kernel launches in this run: (.*)$", text,
                         re.M)
    return {"tok_s": float(run[1]) if run else None, "runs_tok_s": runs,
            "median_tok_s": sorted(runs)[len(runs) // 2] if runs else None,
            "host_us": [float(host[1]), float(host[2])] if host else None,
            "launches": json.loads(launches[1]) if launches else None,
            "profile_wall_ms": float(prof[1]) if prof else None,
            "device_ms": float(prof[2]) if prof else None,
            "idle_share": float(prof[3]) if prof else None,
            "row1_ms": sum(decode) if decode else None}

def _serve_paired(checkouts: list, rounds: int, logs: Path) -> int:
    """``serve``: a waiting worker a checkout, one timed run of each a
    round in ABBA order; a JSON line a checkout and one of the ratios."""
    labels = ["this" if c == ROOT else c.name for c in checkouts]
    work = {}
    for label, c in zip(labels, checkouts):
        proc = subprocess.Popen(
            [sys.executable, __file__, "--worker", str(c), "serve", "-"],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True, cwd=ROOT)
        work[label] = (proc, open(logs / f"serve_{label}.log", "w"))

    def until(label: str, start: str):
        """Copies the worker's output to its log up to and including a
        line that starts with ``start`` and returns that line; None if the
        worker's output ended first."""
        proc, log = work[label]
        for line in proc.stdout:
            log.write(line)
            if line.startswith(start):
                return line
        return None

    ok = all([until(label, "ready") for label in labels])
    tok_s = {label: [] for label in labels}
    for i in range(rounds):
        for label in labels if i % 2 == 0 else labels[::-1]:
            if not ok:
                break
            proc = work[label][0]
            proc.stdin.write("run\n")
            proc.stdin.flush()
            line = until(label, "serve run")
            ok = line is not None
            if ok:
                tok_s[label].append(float(re.search(r"= ([\d.]+) tok/s",
                                                    line)[1]))
    rcs = []
    for label, (proc, log) in work.items():
        if ok:
            proc.stdin.close()
            until(label, "\0")   # the rest of its output, to the log
        else:
            proc.kill()
        rcs.append(proc.wait())
        log.close()
        text = (logs / f"serve_{label}.log").read_text()
        print(json.dumps({"checkout": label, "rc": rcs[-1],
                          **_serve_summary(text)}), flush=True)
    if ok:
        print(json.dumps({"this_over": {
            label: [round(a / b, 4) for a, b in zip(tok_s["this"], runs)]
            for label, runs in tok_s.items() if label != "this"}}),
              flush=True)
    return max(rcs) if ok else 1


def _summary(phase: str, text: str) -> dict:
    if phase != "eval":
        # the summary tables' kernel rows, phase 15's times by split and
        # row 1's by split
        bits = re.search(r"^row 3 bits: (.*)$", text, re.M)
        host = re.search(r"^rmsnorm host time: least ([\d.]+) us, median "
                         r"([\d.]+) us", text, re.M)
        fbits = re.search(r"^flash bits: (.*)$", text, re.M)
        return {"rows": [" ".join(m.split()) for m in re.findall(
            r"^ +(?:[a-z_]+ .*kernel [\d.]+ .*plain"
            r"|(?:bfloat16|float32) +\w+ +B=\d+ +S="
            r"|row 1 .*splits 1-4).*$", text, re.M)],
                "row3_bits": json.loads(bits[1]) if bits else None,
                "rmsnorm_host_us": ([float(host[1]), float(host[2])]
                                    if host else None),
                "flash_bits": json.loads(fbits[1]) if fbits else None}
    first = re.search(r"generated in ([\d.]+) s = ([\d.]+) tok/s", text)
    second = re.search(r"second call: .*?, ([\d.]+) s = ([\d.]+) tok/s",
                       text)
    prof = re.search(r"device kernels ([\d.]+) ms in \d+ launches, device "
                     r"idle share ([\d.]+); row 3 ([\d.]+) ms", text)
    return {"tok_s": float(first[2]) if first else None,
            "second_tok_s": float(second[2]) if second else None,
            "call_s": [float(m[1]) for m in (first, second) if m],
            "device_ms": float(prof[1]) if prof else None,
            "idle_share": float(prof[2]) if prof else None,
            "row3_ms": float(prof[3]) if prof else None}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("others", type=Path, nargs="*")
    ap.add_argument("--phase", choices=sorted(PHASES), default="decode")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--logs", type=Path, default=WORK)
    ap.add_argument("--flush", choices=("write", "clean"), default="write",
                    help="L2 before each timed launch: the Timer's 64 MiB "
                    "write, or a 64 MiB read that leaves it clean")
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        checkout, phase, params = a.worker
        try:
            _run_phase(Path(checkout), phase, Path(params), a.flush)
        except Exception:   # reported in the log; the caller goes on
            traceback.print_exc()
            return 1
        return 0
    if not a.others:
        ap.error("give at least one other checkout")
    WORK.mkdir(parents=True, exist_ok=True)
    a.logs.mkdir(parents=True, exist_ok=True)
    params = WORK / "params.pt"
    if a.phase == "eval":
        rc = _worker(ROOT, "train", params, a.logs / "train.log")
        print(json.dumps({"train": {"rc": rc}}), flush=True)
        if rc:
            return rc
    checkouts = [p.resolve() for p in a.others] + [ROOT]
    if a.phase == "serve":
        return _serve_paired(checkouts, a.rounds, a.logs)
    rcs = []
    for i in range(a.rounds):
        for checkout in checkouts:
            label = "this" if checkout == ROOT else checkout.name
            log = a.logs / f"{a.phase}_{i}_{label}.log"
            rcs.append(_worker(checkout, a.phase, params, log, a.flush))
            print(json.dumps({"round": i, "checkout": label, "rc": rcs[-1],
                              "flush": a.flush,
                              **_summary(a.phase, log.read_text())}),
                  flush=True)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
