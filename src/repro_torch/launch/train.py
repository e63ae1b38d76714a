"""Training launcher of the PyTorch port (the reference's
``launch/train.py`` flags; random weights from ``--seed``).

On the card (the default):
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --method adagradselect --steps 10 --seq-len 512 --global-batch 8

On the CPU, through the plain PyTorch versions of the kernels:
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --smoke --device cpu --steps 4 --seq-len 48 --global-batch 4

``--arch`` takes the paper's three models: qwen2.5-0.5b, llama3.2-1b and
phi4-mini-3.8b (``chip_smoke.py`` phases 20 and 23 print the peak device
memory of their full-width training), and the reference's other three
dense archs: chatglm3-6b, yi-9b and qwen2.5-32b. At full width chatglm3-6b
and yi-9b train on one H100 only with banked moments in pinned host RAM
(``--moment-residency banked --offload host``; ``chip_smoke.py`` phases 34
and 35 also use bf16 moments); qwen2.5-32b's bf16 weights alone are 66.9
GB, so it only serves there.

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
a row without ``--pack``). ``--data jsonl --data-path d.jsonl`` is the
legacy source: ``{"text"}`` documents byte-tokenized into a ring of
fixed-length rows. ``--prefetch-depth N`` builds and uploads N batches
ahead on a background thread (on the card through pinned memory on a copy
stream); the trajectory is the same bit for bit. The run prints tokens/s
beside the non-pad tokens and the records a step.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --pack --prefetch-depth 2 --steps 10 --seq-len 512 --global-batch 8

Observability (``repro_torch.obs``): ``--trace t.json`` writes a Chrome
trace-event file (ui.perfetto.dev) of the run's spans — ``train_step``,
``log_sync``, the banked step's ``phase_a``/``swap``/``phase_b``, the swap
planner's dispatches on a lane of their own, the ``data-prefetch``
thread's name; ``--metrics-json m.json`` the registry's snapshot with the
selection telemetry, which ``python -m repro_torch.launch.inspect m.json``
renders; ``--report`` prints the selection heatmap. Each enables obs, which
reads each step's mask and block norms back (one host sync a step); the
trajectory stays bit-identical.

Checkpoints: ``--checkpoint-dir DIR --checkpoint-every N`` saves the
TrainState every N steps (the data cursor in ``meta.json``); run the same
command again and it prints "resumed from step N" and trains ``--steps``
more steps from there, as the reference's launcher does. Each save prints
its bytes on disk, the stall it added to the loop and the writer's seconds.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2.5-0.5b \
      --smoke --device cpu --steps 6 --seq-len 48 --global-batch 4 \
      --checkpoint-dir /tmp/ckpt --checkpoint-every 3

bf16 moments have no flag (the reference's launcher has none):
``OptimizerConfig(moment_dtype="bfloat16")`` in code.

The LoRA baseline (paper §4.2): ``--method lora --lora-rank 256`` trains
rank-256 adapters on the attention and MLP projections with plain AdamW,
the base frozen; the report line counts the adapters as trainable.

Flags of the reference whose feature is not ported raise
``NotImplementedError`` naming its ROADMAP Queue A item: ``--mesh``,
``--offload zero1`` and ``--offload`` under ``--moment-residency device``
(11).
``--eval-every`` raises as well: the reference trainer has no eval hook;
evaluate after training with ``repro_torch.train.evaluate.math_accuracy``.
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
                    help="synthetic_math / jsonl: pure-f(step) sources "
                         "(jsonl: {'text'} documents ring-packed); "
                         "packed_math / jsonl_sft: streaming pipeline over "
                         "synthetic records / {'prompt','completion'} "
                         "lines (packed under --pack)")
    ap.add_argument("--data-path", default="",
                    help="corpus path for --data jsonl / jsonl_sft")
    ap.add_argument("--pack", action="store_true",
                    help="segment-aware sequence packing (jsonl_sft, or "
                         "synthetic_math via its record form): multiple "
                         "examples per row with block-diagonal attention "
                         "+ per-segment positions")
    ap.add_argument("--prefetch-depth", type=int, default=0,
                    help="batches built and uploaded ahead on a background "
                         "thread (0 = synchronous)")
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
    ap.add_argument("--trace", default="",
                    help="export a Chrome trace-event JSON of the run "
                         "(ui.perfetto.dev): train_step spans, banked "
                         "phase_a/swap/phase_b, the swap dispatches on "
                         "their own lane. Enables obs (one host read a "
                         "step; the trajectory stays bit-identical)")
    ap.add_argument("--metrics-json", default="",
                    help="write the obs registry snapshot (counters, "
                         "gauges, histogram summaries, selection "
                         "telemetry) to this path; render it with "
                         "repro_torch.launch.inspect")
    ap.add_argument("--report", action="store_true",
                    help="print the selection-frequency heatmap "
                         "(exploration->exploitation view) after training")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain PyTorch path)")
    args = ap.parse_args(argv)

    if args.mesh:
        raise NotImplementedError(
            "--mesh is not ported yet (ROADMAP Queue A item 11, "
            "'Distributed')")
    if args.pack and args.data == "jsonl":
        raise SystemExit("--pack needs example boundaries; use --data "
                         "jsonl_sft ({'prompt','completion'} lines) — "
                         "plain jsonl documents are ring-packed already")

    from repro_torch import obs
    obs_on = bool(args.trace or args.metrics_json or args.report)
    if obs_on:
        obs.enable()

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

    trainer = Trainer(tcfg, data_source=data_source,
                      prefetch_depth=args.prefetch_depth, device=dev)
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
    start = trainer.maybe_restore()
    if start:
        print(f"resumed from step {start}")
    ops.reset_launches()
    log = trainer.train()
    if trainer.ckpt is not None and trainer.ckpt.last_save:
        ls = trainer.ckpt.last_save
        print(f"checkpoint: step {ls['step']} in {args.checkpoint_dir}, "
              f"{ls['bytes']:,} bytes; the save stalled the loop "
              f"{ls['stall_s']:.3f} s ({ls['wait_s']:.3f} s of it on the "
              f"previous save's writer), the writer took "
              f"{ls['write_s']:.3f} s")
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
    if args.trace:
        obs.export_trace(args.trace)
        print(f"trace written to {args.trace} (open in ui.perfetto.dev)")
    if args.metrics_json:
        with open(args.metrics_json, "w") as f:
            json.dump(obs.snapshot(), f, indent=2)
        print(f"metrics snapshot written to {args.metrics_json}")
    if args.report:
        from repro_torch.obs import report as obs_report
        print(obs_report.render_selection_trace(obs.selection_trace()))
    if obs_on:
        obs.disable()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
