"""Training launcher of the PyTorch port (the reference's
``launch/train.py`` flags; random weights from ``--seed``).

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --method adagradselect --steps 10 --seq-len 512 --global-batch 8

On the CPU, through the plain PyTorch versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --smoke --device cpu --steps 4 --seq-len 48 --global-batch 4

Banked moment residency (paper §3.3): ``--moment-residency banked`` with
``--offload host`` (the full store in pinned host RAM) or ``--offload
none`` (the store on the card), and ``--async-swap on|off`` (the predicted
boundary queued on a copy stream, or, the default, every boundary
synchronous). The run then prints the optimizer state's bytes on the card
and on the host, and the swap statistics; on the card also the peak
device memory.

Packed SFT training (``--pack``): the synthetic corpus as variable-length
records, greedily packed into the [B, L] rows with segment ids and
per-segment positions (attention through the segment-masked flash
kernels); ``--data jsonl_sft --data-path c.jsonl`` reads
``{"prompt", "completion"}`` lines instead, packed under ``--pack``.
``--data packed_math`` names the synthetic records explicitly (one record
a row without ``--pack``). The run prints tokens/s beside the non-pad
tokens and the records a step.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --pack --steps 10 --seq-len 512 --global-batch 8

Flags of the reference whose feature is not ported raise
``NotImplementedError`` naming its ROADMAP Queue A item: ``--method lora``
(4), ``--checkpoint-dir``/``--checkpoint-every`` (3), ``--eval-every`` (5),
``--data jsonl`` and ``--prefetch-depth`` (8),
``--trace``/``--metrics-json``/``--report`` (10), ``--mesh``, ``--offload
zero1`` and ``--offload`` under ``--moment-residency device`` (11).
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (CPU-runnable)")
    ap.add_argument("--method", default="adagradselect",
                    choices=["adagradselect", "all", "full", "grass", "lisa",
                             "lora", "random", "topk_grad"])
    ap.add_argument("--k", type=float, default=20.0, help="k%% blocks per step")
    ap.add_argument("--lora-rank", type=int, default=128)
    ap.add_argument("--lisa-interval", type=int, default=20,
                    help="lisa: steps between mask resamples")
    ap.add_argument("--grass-temperature", type=float, default=1.0,
                    help="grass: sampling ∝ cum_norms^T")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--data", default="synthetic_math",
                    choices=["synthetic_math", "packed_math", "jsonl",
                             "jsonl_sft"],
                    help="synthetic_math: pure-f(step) source; packed_math "
                         "/ jsonl_sft: streaming pipeline over synthetic "
                         "records / {'prompt','completion'} lines (packed "
                         "under --pack)")
    ap.add_argument("--data-path", default="",
                    help="corpus path for --data jsonl_sft")
    ap.add_argument("--pack", action="store_true",
                    help="segment-aware sequence packing (jsonl_sft, or "
                         "synthetic_math via its record form): multiple "
                         "examples per row with block-diagonal attention "
                         "+ per-segment positions")
    ap.add_argument("--prefetch-depth", type=int, default=0)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--offload", default="none",
                    choices=["none", "host", "zero1"])
    ap.add_argument("--moment-residency", default="device",
                    choices=["device", "banked"])
    ap.add_argument("--async-swap", default="off", choices=["on", "off"])
    ap.add_argument("--mesh", default=None,
                    choices=[None, "single", "multi", "tiny", "data"])
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--eval-every", type=int, default=0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--trace", default="")
    ap.add_argument("--metrics-json", default="")
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.trace or args.metrics_json or args.report:
        raise NotImplementedError(
            "--trace/--metrics-json/--report are not ported yet (ROADMAP "
            "Queue A item 10, 'Observability')")
    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (ROADMAP Queue A item 11, "
            "'Distributed')")
    if args.data == "jsonl" or args.prefetch_depth:
        raise NotImplementedError(
            "--data jsonl (the legacy ring source) and --prefetch-depth are "
            "not ported yet (ROADMAP Queue A item 8, 'Packed SFT pipeline')")

    from repro_torch.configs import get_config, get_smoke_config
    from repro_torch.configs.base import (OptimizerConfig, SelectConfig,
                                          TrainConfig)
    from repro_torch.core.offload import resident_opt_bytes
    from repro_torch.data import loader
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops
    from repro_torch.train.trainer import Trainer

    dev = resolve_device(args.device)
    mcfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    tcfg = TrainConfig(
        model=mcfg,
        method=args.method,
        select=SelectConfig(k_percent=args.k,
                            steps_per_epoch=max(1, args.steps // 4),
                            lisa_interval=args.lisa_interval,
                            grass_temperature=args.grass_temperature),
        optimizer=OptimizerConfig(lr=args.lr, total_steps=args.steps,
                                  offload=args.offload,
                                  moment_residency=args.moment_residency,
                                  async_swap=args.async_swap == "on",
                                  lora_rank=args.lora_rank),
        seq_len=args.seq_len, global_batch=args.global_batch,
        steps=args.steps, seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        eval_every=args.eval_every)

    data_source = None
    if args.data != "synthetic_math" or args.pack:
        kind = "packed_math" if args.data == "synthetic_math" else args.data
        data_source = loader.make_source(
            kind, seq_len=args.seq_len, global_batch=args.global_batch,
            seed=args.seed, path=args.data_path, pack=args.pack)

    trainer = Trainer(tcfg, data_source=data_source, device=dev)
    report = trainer.method.trainable_param_report(mcfg, trainer.state)
    where = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
             else "cpu (plain PyTorch path)")
    print(f"device: {where}")
    print(f"[{args.method}] trainable {report.num_params_trainable:,}/"
          f"{report.num_params_total:,} params "
          f"({report.trainable_fraction:.1%}), "
          f"opt-state {report.opt_bytes / (1 << 20):.1f} MiB (model), "
          f"resident {report.opt_bytes_resident / (1 << 20):.1f} MiB  "
          f"{report.detail}")
    if args.moment_residency == "banked":
        res = resident_opt_bytes(trainer.state["opt"])
        print(f"resident moment bytes: device {res['device']:,} "
              f"host {res['host']:,}")
    ops.reset_launches()
    log = trainer.train()
    step_s = np.mean(log.step_times[3:])
    tokens = args.global_batch * args.seq_len
    print(f"final loss: {log.losses[-1]:.4f}  "
          f"mean step time: {step_s:.3f}s")
    print(f"tokens/s: {tokens / step_s:.0f} ({tokens} tokens a step, "
          f"{np.mean(log.real_tokens):.1f} of them not padding = "
          f"{np.mean(log.real_tokens) / step_s:.0f} non-pad tokens/s; "
          f"{np.mean(log.records):.1f} records a step)")
    print("kernel launches:", json.dumps(ops.LAUNCHES))
    print("kernel launches per step:", json.dumps(
        {k: n / args.steps for k, n in ops.LAUNCHES.items()}))
    if dev.type == "cuda":
        print(f"peak device memory: "
              f"{torch.cuda.max_memory_allocated(dev) / (1 << 30):.2f} GiB")
    stats = getattr(trainer.step_fn, "swap_stats", None)
    if stats is not None:
        print("swap stats:", json.dumps(stats.as_dict()))
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"losses": log.losses, "step_times": log.step_times,
                       "metrics": log.metrics}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
