"""One phase of ``chip_smoke.py`` on other checkouts of the port and on this
one, alternated, so that their numbers come from the same card in one run.

    python3 tools/phase_ab.py --phase decode OTHER [OTHER ...] [--rounds 2]

``--phase`` is ``flash`` (phase 12), ``decode`` (phase 15) or ``eval``
(phase 16, the greedy eval at full width). For ``eval`` this checkout's
phase 7 trains once first and its params, saved under ``build/phase_ab/``,
are the ones every checkout evaluates. Each round runs the phase of every
OTHER and then of this checkout, each in a process of its own that first
builds that checkout's kernels. Each run's output goes to a log under
``--logs`` (default ``build/phase_ab/``); one JSON line a run follows it on
stdout: the
kernel rows of the phase's summary table, or, for ``eval``, tok/s and the
seconds of its two eval calls and the device time and idle share of its
profiled engine steps. Needs one CUDA card; run it from the root of this
checkout.
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import re
import subprocess
import sys
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
WORK = ROOT / "build" / "phase_ab"
PHASES = {"flash": "phase_flash_kernels", "decode": "phase_decode_kernel",
          "eval": "phase_eval"}


def _chip_smoke(checkout: Path):
    """That checkout's chip_smoke.py as a module (it puts its own src/ first
    on sys.path when imported)."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", checkout / "chip_smoke.py")
    cs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(cs)
    return cs


def _run_phase(checkout: Path, phase: str, params: Path) -> None:
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
    elif phase == "eval":
        from repro_torch.train import evaluate
        cs.phase_eval(torch, ops, cfg, evaluate,
                      torch.load(params, weights_only=False))
    else:   # an older checkout's phase may take fewer modules
        fn = getattr(cs, PHASES[phase])
        mods = {"_dec": _dec, "_fa": _fa}
        fn(torch, ops, ref, *(mods[p] for p in inspect.signature(fn)
                              .parameters if p in mods), cs.Timer(torch))


def _worker(checkout: Path, phase: str, params: Path, log: Path) -> int:
    with open(log, "w") as f:
        return subprocess.run(
            [sys.executable, __file__, "--worker", str(checkout), phase,
             str(params)], stdout=f, stderr=subprocess.STDOUT,
            cwd=ROOT).returncode


def _summary(phase: str, text: str) -> dict:
    if phase != "eval":
        # the summary table's kernel rows, and phase 15's times by split
        return {"rows": [" ".join(m.split()) for m in re.findall(
            r"^ +(?:(?:decode|flash)_attention\w* .*kernel [\d.]+"
            r"|(?:bfloat16|float32) +\w+ +B=\d+ +S=).*$", text, re.M)]}
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
    ap.add_argument("--worker", nargs=3, help=argparse.SUPPRESS)
    a = ap.parse_args()
    if a.worker:
        checkout, phase, params = a.worker
        try:
            _run_phase(Path(checkout), phase, Path(params))
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
    rcs = []
    for i in range(a.rounds):
        for checkout in checkouts:
            label = "this" if checkout == ROOT else checkout.name
            log = a.logs / f"{a.phase}_{i}_{label}.log"
            rcs.append(_worker(checkout, a.phase, params, log))
            print(json.dumps({"round": i, "checkout": label, "rc": rcs[-1],
                              **_summary(a.phase, log.read_text())}),
                  flush=True)
    return max(rcs)


if __name__ == "__main__":
    sys.exit(main())
