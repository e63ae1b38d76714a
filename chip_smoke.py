#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each of which makes the run exit non-zero if it fails:

1. the card's name and power limit (``nvidia-smi``);
2. build every CUDA source of the port with ``nvcc``, one process per
   source, all started together, and time it;
3. each kernel against its plain PyTorch version on the card, on the same
   inputs: the paged decode attention kernel (CUDA, row 1) on scrambled page
   tables with sentinel entries and mixed ``valid_len``, with the
   qwen2.5-0.5b head map (H=16, KVH=2, D=64), at the serving shape (4 slots,
   max_len 512, page 16) and a larger one (32 rows, valid_len 2048), with
   32 q heads on 8 kv heads at head dim 64 and 128 and pages of 4 and 16,
   and forced to each split 1-4 at 32 x 2048 (bit-identical over two
   launches, timed); the RMSNorm forward (CUDA C++, ``csrc/rmsnorm.cu``)
   on [N, D] at the three models' widths (D 896, 2048 and 3072; N 4, and
   the training path's 8192 or 4096 rows), bit-identical over two
   launches, with each compiled instance's registers and spills as ptxas
   reports them (a spill fails) and the host microseconds that an
   ``ops.rmsnorm`` call takes to enqueue at [4, 896]; bf16 and f32; max
   error against the tolerance,
   on inputs whose outputs are large beside it (a peaked softmax: the
   comparison fails a kernel that returns zeros or a flat average); times from CUDA events with L2 flushed before each launch, and each
   kernel's bound (bytes over 3.35 TB/s, operations over the peak rate of
   their type);
4. serving at full width: qwen2.5-0.5b in bf16 with random weights from a
   seeded generator, the paged engine (4 slots, page 16, decode chunk 8,
   max_len 512), 8 requests of prompt lengths 7..255 and 32 new tokens
   each; tok/s, the engine stats, the kernels' launch counts in that run,
   and where the device and host time went (``torch.profiler``) in two
   engine steps of a further run (the second wave's admission and two
   decode chunks);
5. consistency at full width in f32: the engine's greedy tokens equal the
   argmax of one teacher-forced ``prefill`` (a path without the decode
   kernels) at every generated position, on the paged layout and on the
   dense one (the engine's default), with the kernels' launch counts of
   each run checked as in phase 4: the dense decode kernel (row 3) once per
   layer and decode step and the paged one never on the dense layout, and
   the other way round on the paged layout;
6. the training kernels against their plain versions, bf16 and f32, at the
   training path's shapes: the block gradient norms and the masked AdamW
   step (Triton) on the stacked leaves wg [24, 896*4864], wq [24, 896*1024]
   and ln1 [24, 896] with 5 of 24 rows selected, and on llama3.2-1b's and
   phi4-mini's wg [16, 2048*8192] and [32, 3072*8192] with 5 rows
   selected, and the RMSNorm backward (Triton) on [4, D] and [8*512, D] at
   D 896, 2048 and 3072, with the registers and spills Triton reports for
   its compiled kernels (a spill fails); rows with sel = 0 come back
   bit-identical, two launches of the norms and of the RMSNorm backward
   give the same bits; the RMSNorm backward's dx-only mode (a frozen
   layer's norm) at both shapes: one launch, dx within the tolerance of
   its plain version and the full mode's dx bit for bit; the masked AdamW
   with bf16 m and v (``moment_dtype="bfloat16"``) on the same bf16 leaves:
   m and v within one bf16 ulp of the plain version, p within the
   tolerance, unselected rows bit-identical, a tie rounded to even, and the
   compiled kernel's PTX converting with ``cvt.rn.bf16``; times as in
   phase 3, beside each kernel's bytes bound and a library yardstick where
   one exists;
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
   hold the bank rows at the slot positions; with bf16 params also with
   bf16 m and v banks (within one bf16 ulp of the plain version, row 8's
   bf16-moment bits); times as in phase 6;
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
   D 64; the segment ids of a real ``pack_batch``, and how many of its
   causal 64 x 64 tiles hold an attending pair), ragged S (17, 300, 1000),
   segment boundaries on the tile edges, head dim 128, and segmented but
   not causal, and the training shape at llama3.2-1b's head map (32 q on
   8 kv heads, D 64) and phi4-mini's (24 q heads padded to 32, 8 kv heads,
   the padded ones on kv head 7, D 128), causal and packed; o, lse, dq, dk
   and dv within the tolerance on inputs whose
   rows are large beside it, dq, dk and dv bit-identical over two launches; one
   segment over each row bit-identical to no segments; in f32 with a
   peaked softmax (q = 3
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
   within ``PACKED_UPDATE_RTOL`` of the largest entry of its CPU update;
15. the dense decode attention kernel (CUDA, row 3) against its plain
   version, bf16 and f32, on one layer's unexpanded [B, S, KVH, D] cache
   read through the qwen2.5-0.5b head map: the eval shape (16 rows, S 512,
   valid_len mixed over 1, 9, 300 and 512), the S and valid_len of
   ``tests/test_kernels.py::TestDecodeAttention`` (S 512/1024/2048, per-row
   vectors), ragged S (1, 300) and head dim 128; two launches give the same
   bits; in f32 with a peaked softmax the kernel's and the plain f32
   version's outputs against the plain version in f64; row 3 bit-equal to
   row 1 (the paged kernel) on the gathered view of one pool, at the
   serving shape and at 32 x 2048; the kernel forced
   to every split of a row's positions (1-32 chunks) at the eval shape
   and at S 300 with valid_len 0 and chunks past valid_len, each against
   the plain version and bit-identical over two launches, and timed by
   split at the eval shape and longer caches; times as in phase 3 beside
   the bytes bound, the plain version's and
   ``scaled_dot_product_attention``'s (``enable_gqa``, a boolean valid-
   length mask; timed only);
16. the paper's greedy eval at full width: ``train.evaluate`` (zero-shot,
   greedy, exact match; ``math_accuracy`` is its accuracy) in bf16 on the
   params of phase 7's adagradselect run (``method.eval_params``), on the
   task phase 7 trained on (seq_len 512), 32 held-out problems in chunks of
   16 slots on the engine's dense layout; accuracy, generated tokens,
   tokens/s, decode steps, launches (row 3 once per layer and decode step,
   nothing else but the RMSNorm forward), peak device memory; a second call
   gives the same accuracy and tokens; each call under 48 s; two engine
   steps (decode chunks) of the second call under the profiler, with the
   device's idle share;
17. gated weight gradients at full width (``gate_weight_grads=True``):
   phase 7's run, then phase 10's async banked run, with the gate; launches
   of every kernel in the counted steps equal to the counts reckoned from
   each step's mask (the RMSNorm backward's full mode once per norm of a
   selected layer and the final norm, its dx-only mode once per norm of a
   frozen layer), k = 5 blocks a step, finite losses, the AdamW counts
   equal to the summed masks, peak device memory beside the ungated run's;
   one more step whose gradients are seen by the AdamW: every leaf's rows
   of the frozen layers all zero, the selected layers' nonzero; for the
   dense run 2 profiled steps with device time, idle share and the
   matrix-product launches;
18. gated adagradselect, ungated adagradselect and full fine-tuning in 2
   alternating rounds of 8-step windows: median step times, the port's
   kernels a step, then 2 profiled steps of each (device time, launches,
   matrix products, idle share) and the gated/full step-time ratio;
19. gated consistency in f32 (TF32 off), 2 layers at full width, batch 2
   x 64, 3 steps: gated topk_grad (k = 2 of 4 blocks: layer 1 frozen) on
   the card against the CPU from one state, with equal masks, losses
   within 1e-4 relative, each parameter leaf's update within 1e-2 of the
   CPU's (relative L2; a leaf the CPU left unchanged stays so) and the
   launches of one selected and one frozen layer a step; gated full equal
   to ungated full on the card bit for bit;
20. llama3.2-1b at full width (16 layers, d_model 2048, 32 q / 8 kv heads,
   head dim 64, vocab 128256, 18 blocks; random weights from a seeded
   generator), bf16: phase 7's dense adagradselect run (k = 4 of 18
   blocks, 8 x 512 tokens, 10 steps) with its checks, launches a step
   counted for 9 stacked leaves (no QKV bias), the peak beside the one
   reckoned in PERF.md, and 2 profiled steps;
21. the greedy eval of phase 16 on phase 20's params, with its checks;
22. llama3.2-1b in f32 (TF32 off) at full width with 2 layers: phase 8's
   topk_grad run card vs CPU for 2 steps (not 3: the CPU's steps at these
   widths are most of the phase) at k = 2 of 4 blocks, each leaf's update
   within 1e-2 of the CPU's (relative L2), and phase 5's greedy tokens
   against a teacher-forced prefill on both layouts;
23. phi4-mini-3.8b at full width (32 layers, d_model 3072, 24 q heads
   padded to 32 on 8 kv heads, head dim 128, vocab 200064, 34 blocks),
   bf16: phase 7's run for 6 steps (k = 7 of 34 blocks), dense residency,
   the peak beside the one reckoned in PERF.md;
24. phase 4's paged serving run on phi4-mini (row 1 at head dim 128 over
   32 padded q heads, row 2 at D 3072);
25. phase 22's checks on phi4-mini, at 1 layer;
26. bf16 moments (``OptimizerConfig(moment_dtype="bfloat16")``) at full
   width: phase 7's dense run and phase 10's async banked run (one log
   window) on qwen2.5-0.5b with bf16 m and v: step time, tokens/s, device
   time, launches (rows 8 and 9 counted as ``*_bf16m``) and peak beside
   phases 7 and 10, the moments' device bytes half of the f32 ones;
27. phi4-mini-3.8b dense with bf16 moments, 4 steps: the peak beside
   phase 23's;
28. phase 8's card-vs-CPU check with bf16 moments (f32 params, 2 layers):
   each leaf's update within ``UPDATE_GAP`` of the CPU's;
29. checkpoint and resume at full width and 6 layers (``CKPT_LAYERS``:
   bit-equal resume does not depend on the depth) (qwen2.5-0.5b, bf16
   params), dense
   f32 moments, banked host f32 and dense bf16 moments: 6 steps straight,
   twice; 3 steps with ``checkpoint_every=3``; a new ``Trainer`` that
   restores and runs 3 more. Where the two straight runs agree bit for
   bit the resumed run must too (params, moments, counts, the selection
   state, the losses of steps 4-6), else it is held to their spread; the
   bytes on disk, the stall the save added to the loop (the wait on the
   previous writer and the snapshot), the writer's and the restore's
   seconds. Dense f32's second straight run saves every ``SAVE_EVERY``
   steps: its wall time and each save's stall beside the first run's, and
   it must still equal that run. The files go under ``build/`` and are
   removed;
30. the full serving stack at full width (qwen2.5-0.5b, bf16, paged, page
   16, 8 slots, ``prefill_rows`` 4): 4 groups of 4 requests sharing a
   384-token prefix (16-64 own tokens each) and one 1,536-token prompt,
   budgets 16-48 new tokens. Every feature off (an ample pool; its peak
   sizes the small pool at 60%), then every feature on (prefix cache,
   preemption, prefix-aware admission, stream-out, ``prefill_chunk`` 256
   (inert: the reference's prefix path takes every admission), a
   ``PrefixStore`` across engines A and B): tok/s beside the plain run,
   prefill tokens saved, the stats (hits and a preemption), the pool at the
   end (the tree's pages only; none after evicting it), every completion
   streamed, each kernel's launches as the path calls them (a prefill
   forward or chunk counts as a forward); then chunked prefill with
   preemption (paged) and with sampling (dense: row 3); the idle share of
   two profiled engine steps. In f32 at 2 layers: greedy tokens with every
   feature on and chunked with preemption equal the plain engine's and a
   teacher-forced prefill; sampled (T 0.8) tokens with preemption and the
   prefix cache equal those without, three requests alone draw what they
   draw in the batch and on the dense chunked path; the sampling noise on
   the card equals the CPU's bit for bit;
31. observability and the prefetcher at full width (qwen2.5-0.5b, bf16):
   (a) phase 13's packed source, dense adagradselect, ``OBS_STEPS`` steps,
   four runs from one seed (obs off / prefetch 0, obs on / prefetch 0,
   obs off / prefetch 2, obs on / prefetch 2): losses and every parameter
   leaf bit-equal, the launches a step equal and the path's, the committed
   cursor the records trained on; with obs on the selection trace's counts
   equal ``state["opt"]["counts"]``, the exported trace validates with a
   ``train_step`` span a step (and the ``data-prefetch`` thread's track at
   prefetch 2), the metrics snapshot renders through ``launch.inspect``;
   (d) the four runs' step times in ``OBS_ROUNDS`` round(s) of
   ``OBS_STEPS``-step windows, the runs in turn, their medians' ratios
   (obs on / off, prefetch 2 / 0) beside the card's name and power limit
   (recorded, not gated); 2 more steps under ``torch.profiler`` with
   ``obs.enable(torch_profiler=True)``: 2 ``train_step`` ranges; (b) phase
   10's async banked run with obs on: the ``phase_a``, ``swap`` and
   ``phase_b`` histograms count the steps, the ``swap_dispatch_job`` spans
   sit off the main thread's track, the ``mispredicts`` counter equals
   ``SwapStats.mispredicts``; (c) phase 4's workload, paged, obs off then
   on: the same tokens and launches, each latency histogram counts 8,
   ``ttft`` <= ``e2e`` in every request's lane, ``page_pool_live`` 0 at
   the end, ``stats_snapshot()["engine"]`` equal to ``stats``. The files go
   under ``build/`` and are removed;
32. the paper's LoRA baseline (``Trainer(method="lora")``): (a) rank 256
   (alpha 16, the config's default) on qwen2.5-0.5b at full width, bf16,
   phase 7's settings otherwise (8 x 512 tokens, 10 steps): the report's
   trainable parameters equal to those reckoned from the config
   (142,344,192) and its optimizer bytes (f32 m and v, the count), finite
   losses, every adapter's b moved, the count at 10, launches per step
   equal to the path's (the RMSNorm forward, its backward all in the
   dx-only mode, the flash kernels; no block norm, no masked AdamW), the
   median step, tokens/s, peak device memory and 2 profiled steps, beside
   phase 7's adagradselect and phase 18's full medians and their ratios
   (records, not claims); (b) in f32 (TF32 off) at full width with 2
   layers, batch 2 x 64, 3 steps on the card and on the CPU from one
   state: losses within 1e-4 relative, each adapter leaf's update within
   ``UPDATE_GAP`` of the CPU's (relative L2), the base unchanged;
33. the reference's other three dense archs' kernel shapes: rows 1 and 3
   at qwen2.5-32b's head map (40 q heads padded to 48 on 8 kv heads, 13 on
   kv head 7: three blocks a kv head) and chatglm3-6b's (32 q on 2 kv), D
   128, bf16 and f32, against their plain versions, bit-identical over two
   launches and row 3 on the gathered view bit-equal to row 1; row 2 at
   [4, 5120], [1024, 5120], [4, 8192] and [1024, 8192] against its plain
   version, bit-identical over two launches, with the plan's warps a row
   and the instance's registers (a spill fails); times as in phase 3 (row 1
   at B 4, row 3 at [16, 48 heads, 512] beside SDPA, row 2 beside
   ``F.rms_norm``);
34. chatglm3-6b at full width (28 layers, d_model 4096, 32 q / 2 kv heads,
   head dim 128, partial rotary 0.5, QKV bias, vocab 65024, 31 blocks),
   bf16: phase 7's adagradselect run (k = 6 of 31, 8 x 512 tokens,
   ``remat="full"``) with banked residency, the store pinned in host RAM
   and bf16 m and v, 4 steps; first the peak device memory at 7 and 14
   layers and its per-layer slope extrapolated to 28 (above 74 GiB the
   phase fails with that figure); the store's bytes beside the host's
   available memory (``free -g``); median step, tokens/s, peak beside the
   extrapolation, launches equal to the path's, counts equal to the summed
   masks, and 2 profiled steps (device activity only). The probes hold
   their store in pageable host memory (the device's allocations are the
   same); the full run's store is pinned (``offload.pinned_zeros``);
35. yi-9b at full width (48 layers, 32 q / 4 kv heads, head dim 128, vocab
   64000, 51 blocks): phase 34's run at k = 5 of 51 with
   ``gate_weight_grads`` (launches reckoned from each step's mask), its
   peak measured at 12 and 24 layers and extrapolated to 48; if that
   exceeds 74 GiB, or the host cannot hold the store (35.3 GB), the run is
   skipped with both figures printed, decided before it;
36. phase 4's paged serving run on the three archs at full width
   (qwen2.5-32b: 64 layers, d_model 5120, 48 padded q heads, vocab 152064,
   33.4 B params, 66.9 GB of bf16 weights from ``lm.init``'s slice-by-slice
   draws), the warm-up run's engine steps 4-5 profiled (device activity
   only); rows 1 and 2 at 48 q heads and D 5120 on the 32b; its peak beside
   the reckoned 63-65 GiB;
37. each arch's head-layout variant (its own heads, head dim, partial
   rotary, bias and ``pad_heads_to`` at d_model 256, d_ff 256, vocab 256,
   2 layers) in f32: phase 25's checks with losses within 1e-5; the key
   bias's unrotated dims (chatglm3-6b's partial rotary), whose exact
   gradient is 0, are held by the absolute bound alone, not the relative
   update gap; a greedy token where the teacher-forced prefill's top two
   logits are within 1e-5 (relative) of each other may be either of them
   (a tie at f32 rounding; printed), every later token still held.

Then it prints the kernel summary as one JSON line and, last, the device
line ``{"ok": true, "device": {...}}``. Without CUDA, or without the rest of
the repository beside it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import gc
import json
import math
import shutil
import statistics
import subprocess
import sys
import time
import traceback
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

HBM_BYTES_PER_S = 3.35e12          # H100 SXM device memory
SPIN_CYCLES = 2_000_000            # Timer: ~1 ms at the H100's clock
LONG_SPIN_CYCLES = 20_000_000      # ~10 ms, for an autograd backward
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
# the device kernels of each row (bf16 forward and dk/dv: the tensor-core
# bodies "..._tc", dk/dv's split sum included; each name a substring)
FLASH_PARTS = {"flash_fwd_kernel": ("flash_fwd_kernel",),
               "flash_dq_kernel": ("flash_dq_kernel",),
               "flash_dkv_kernel": ("flash_dkv_kernel",
                                    "flash_dkv_sum_kernel")}
PACKED_UPDATE_RTOL = 0.1  # phase 14(b): of each leaf's largest CPU update
UPDATE_GAP = 1e-2   # phases 8, 19, 22, 25: card vs CPU update, relative L2
MATMUL_WORDS = ("gemm", "nvjet", "xmma", "cutlass", "matmul")
DECODE_EVAL_VL = (1, 9, 300, 512) * 4  # phase 15's eval shape: 16 rows
EVAL = dict(num_problems=32, batch_size=16)   # phase 16
EVAL_CALL_S = 48.0        # phase 16: the most one eval call may take
EVAL_PROFILE = (8, 2)     # phase 16: engine steps of call 2 skipped, profiled
SERVE_PROFILE = (4, 2)    # phases 4, 24: engine steps skipped, profiled
# the paper's other two models (phases 20-25): llama3.2-1b trains and is
# evaluated as qwen2.5-0.5b is in phases 7 and 16, phi4-mini-3.8b trains
# for PHI4_STEPS steps and serves as in phase 4
LLAMA, PHI4 = "llama3.2-1b", "phi4-mini-3.8b"
PHI4_STEPS = 6
PHI4_BF16_STEPS = 4   # phase 27: phi4-mini with bf16 moments
MODEL_CONSISTENCY_STEPS = 2  # phases 22, 25: f32 card-vs-CPU training steps
PHI4_CONSISTENCY_LAYERS = 1  # phase 25's depth
CKPT_LAYERS = 6   # phase 29's depth: bit-equal resume does not depend on it
# rows 2 and 2b: qwen2.5-0.5b's d_model, then llama3.2-1b's and phi4-mini's
# (padded to 2048 and 4096 lanes), at one decode row block and at the
# training path's 8 x 512 rows
NORM_SHAPES = ((4, 896), (8192, 896), (4, 2048), (4, 3072), (4096, 2048),
               (4096, 3072))
NORM_BWD_SHAPES = ((4, 896), (4096, 896), (4, 2048), (4, 3072),
                   (4096, 2048), (4096, 3072))
NORM_MAIN = (4096, 3072)   # the summary line's rows 2 and 2b (phi4-mini)
NORM_HOST = (4, 896)   # row 2's decode row block, whose enqueue is timed
HOST_BATCHES, HOST_CALLS = 20, 200   # host-timed calls
NORM_DX_MAIN = (4096, 896)  # 2b's dx-only mode: its path is qwen2.5-0.5b's
# rows 7 and 8 on the new models' largest stacked leaves (mlp.wg)
WIDE_LEAVES = {"llama wg": (16, 2048 * 8192), "phi4 wg": (32, 3072 * 8192)}
# phase 32: the paper's LoRA baseline, rank 256, alpha the config's default
LORA_RANK = 256
LORA_STEPS = 3        # phase 32(b): f32 card-vs-CPU steps


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
    events see the device work only and not the host's enqueue time. The
    spin (``SPIN_CYCLES``, ~1 ms) outlasts the enqueue of one kernel's
    launch; an autograd backward's enqueue takes longer on a slow, shared
    host (with 1 ms, SDPA's backward read 0.10 to 1.38 ms in one run), so
    its timings pass ``spin=LONG_SPIN_CYCLES`` (~10 ms)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(64 << 20, dtype=torch.uint8, device="cuda")

    def ms(self, fn, reps=20, spin=SPIN_CYCLES) -> float:
        torch = self.torch
        fn()
        torch.cuda.synchronize()
        total = 0.0
        for _ in range(reps):
            self.flush.zero_()
            torch.cuda._sleep(spin)
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


def card_line() -> str:
    """The card's name and power limit, as ``nvidia-smi`` gives them."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0 and out.stdout.strip(),
          f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def phase_card() -> str:
    line = card_line()
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
        for u in _build.ptxas_usage(log):
            print(f"  {name}: {u.kernel}: {u.text}")


def _paged_inputs(torch, dtype, b, vlens, ps=16, maxp=32, h=16, kvh=2, d=64,
                  seed=0, hmap=None):
    """Pool, scrambled tables (sentinels past each row's pages), q and a
    head map, by default qwen2.5-0.5b's (7 q heads on kv head 0, 9 on kv
    head 1: the two padded heads clamp onto the last kv head). q = 3 N(0,
    1) against N(0, 1) keys gives scores of spread 3, so each row's softmax
    is peaked and its output stays near the size of a V row even at 2048
    positions."""
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
    if hmap is None:
        hmap = [min(i // 7, kvh - 1) for i in range(h)]
    hmap = torch.tensor(hmap, dtype=torch.int32, device="cuda")
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
        for n, d in NORM_SHAPES:
            g = torch.Generator(device="cuda").manual_seed(n)
            dt = getattr(torch, dtype)
            x = torch.randn(n, d, generator=g, device="cuda").to(dt)
            s = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
            err = _norm_fwd_check(torch, ops, ref, x, s, dtype)
            es = x.element_size()
            bms, by = bound_ms(2 * n * d * es + d * es, 4 * n * d, dtype)
            row = dict(kernel="rmsnorm", case=f"N={n}", dtype=dtype,
                       shape=f"[{n}, {d}]", max_abs_err=err, tol=TOL[dtype],
                       ms=timer.ms(lambda: ops.rmsnorm(x, s, 1e-6)),
                       plain_ms=timer.ms(lambda: ref.rmsnorm(x, s, 1e-6)),
                       library_ms=timer.ms(lambda: F.rms_norm(
                           x, (d,), weight=s, eps=1e-6)),
                       bound_ms=bms, bound_by=by)
            rows.append(row)
            if (n, d) == NORM_MAIN and dtype == "bfloat16":
                main["rmsnorm"] = row
    _paged_wide(torch, ops, ref)
    _paged_splits(torch, ref, timer)
    print("kernels vs plain versions (CUDA events, L2 flushed, ms per call):")
    for r in rows:
        lib = ("-" if r["library_ms"] is None
               else f"{r['library_ms']:.4f}")
        print(f"  {r['kernel']:<23} {r['case']:<8} {r['dtype']:<9} "
              f"err {r['max_abs_err']:.2e} (rtol=atol {r['tol']:.0e})  "
              f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {lib}  bound {r['bound_ms']:.4g} ({r['bound_by']})"
              f"  {r['shape']}")
    print("  paged_decode_attention has no single-call PyTorch yardstick; "
          "rmsnorm's is torch.nn.functional.rms_norm (timed only)")
    print(f"  rmsnorm forward instances: {_norm_fwd_usage()}")
    x = torch.ones(NORM_HOST, dtype=torch.bfloat16, device="cuda")
    s = torch.ones(NORM_HOST[1], dtype=torch.bfloat16, device="cuda")
    least, median = _host_us(torch, lambda: ops.rmsnorm(x, s, 1e-6))
    print(f"  rmsnorm host time: least {least:.2f} us, median {median:.2f} "
          f"us a call at {list(NORM_HOST)} bf16 ({HOST_BATCHES} x "
          f"{HOST_CALLS} calls, enqueue only)")
    return main


def _norm_fwd_check(torch, ops, ref, x, s, dtype: str) -> float:
    """Row 2 on x [N, D]: two counted launches with the same bits, within
    the tolerance of the plain version; returns the max error."""
    n, d = x.shape
    n0 = ops.LAUNCHES["rmsnorm"]
    out = ops.rmsnorm(x, s, 1e-6)
    again = ops.rmsnorm(x, s, 1e-6)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["rmsnorm"] == n0 + 2,
          "rmsnorm did not count its launches")
    check(_bits_equal(torch, out, again),
          f"rmsnorm [{n}, {d}] {dtype}: two launches gave different bits")
    return _check_close(torch, out, ref.rmsnorm(x, s, 1e-6), dtype,
                        f"rmsnorm [{n}, {d}]")


def _norm_fwd_usage() -> str:
    """Registers of each compiled instance of the RMSNorm forward
    (``csrc/rmsnorm.cu``: x, scale, vector width) as ptxas reports them;
    fails on a spill or unless all 8 instances are reported."""
    from repro_torch.kernels import _build
    fwd = [u for u in _build.usage("rmsnorm.cu")
           if "rmsnorm_fwd_kernel" in u.kernel]
    check(len(fwd) == 8, f"ptxas reported {len(fwd)} instances of the "
          f"RMSNorm forward, not 8")
    for u in fwd:
        check(u.spill_bytes == 0, f"{u.kernel}: {u.spill_bytes} bytes "
              f"spilled ({u.registers} registers)")
    return ", ".join(f"{u.kernel.removeprefix('rmsnorm_fwd_kernel')} "
                     f"{u.registers}" for u in fwd) + " registers, no spills"


def _host_us(torch, fn) -> tuple:
    """(least, median) host microseconds a call of fn takes to enqueue:
    ``HOST_BATCHES`` batches of ``HOST_CALLS`` calls, each made with no
    sync and followed by one."""
    per_call = []
    for _ in range(HOST_BATCHES):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(HOST_CALLS):
            fn()
        per_call.append((time.perf_counter() - t0) / HOST_CALLS * 1e6)
        torch.cuda.synchronize()
    per_call.sort()
    return per_call[0], per_call[len(per_call) // 2]


# 32 q heads on 8 kv heads (two blocks a kv head): llama3.2-1b's map at head
# dim 64, phi4-mini's (24 heads padded to 32 on kv head 7) at 128
WIDE_HMAPS = {64: [h // 4 for h in range(32)],
              128: [min(h // 3, 7) for h in range(32)]}


def _paged_wide(torch, ops, ref) -> None:
    """Row 1 at the 32-head layouts, head dim 64 and 128, page sizes 4 and
    16, bf16 and f32, against its plain version."""
    for dtype in ("bfloat16", "float32"):
        for d, hm in WIDE_HMAPS.items():
            for ps in (4, 16):
                q, k, v, tbl, vl, hmap = _paged_inputs(
                    torch, dtype, 4, [1, ps + 3, 300, 512], ps=ps,
                    maxp=512 // ps, h=32, kvh=8, d=d, hmap=hm)
                out = ops.paged_decode_attention(q, k, v, tbl, vl, hmap)
                err = _check_close(
                    torch, out[:, 0],
                    ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hmap),
                    dtype, f"paged_decode_attention H=32 D={d} page={ps}")
                print(f"  row 1 {dtype:<8} H=32 KVH=8 D={d:<3} page {ps:<2} "
                      f"valid_len [1, {ps + 3}, 300, 512]: max |err| "
                      f"{err:.2e} (rtol=atol {TOL[dtype]:.0e})")
                del q, k, v


def _paged_splits(torch, ref, timer) -> None:
    """Row 1 forced to each split 1-4 at 32 rows of 2048 positions: against
    the plain version, bit-identical over two launches, and timed (bf16 and
    f32; * = decode_splits' pick)."""
    from repro_torch.kernels import decode_attention as dec
    for dtype in ("bfloat16", "float32"):
        q, k, v, tbl, vl, hm = _paged_inputs(torch, dtype, 32, [2048] * 32,
                                             maxp=128)
        qv = q.view(32, 16, 64)
        plain = ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hm)
        pick = dec.decode_splits(q.dtype, 2048)
        times = {}
        for n in (1, 2, 3, 4):
            outs = []
            for _ in range(2):
                out = torch.full_like(qv, float("nan"))
                dec.launch_paged(qv, k, v, tbl, vl, hm, out, n_split=n)
                outs.append(out)
            torch.cuda.synchronize()
            check(_bits_equal(torch, outs[0], outs[1]), f"row 1 {dtype} "
                  f"split {n}: two launches differ")
            _check_close(torch, outs[0], plain, dtype, f"row 1 split {n}")
            times[n] = timer.ms(lambda n=n: dec.launch_paged(
                qv, k, v, tbl, vl, hm, out, n_split=n), reps=10)
        print(f"  row 1 {dtype:<8} B=32 valid_len 2048, splits 1-4 within "
              f"the tolerance and bit-identical over two launches; ms: "
              + "  ".join(f"{n}{'*' if n == pick else ''} {t:.4f}"
                          for n, t in times.items()))
        del q, k, v, plain


def _requests(Request, vocab):
    import numpy as np
    rng = np.random.default_rng(1)
    return [Request(uid=i, tokens=rng.integers(0, vocab, (n,),
                                               dtype=np.int32),
                    max_new_tokens=NEW_TOKENS)
            for i, n in enumerate(PROMPT_LENS)]


def _serve_once(torch, cfg, params, ServeEngine, ServeConfig, Request,
                layout="paged"):
    eng = ServeEngine(cfg, params, ServeConfig(**{**SERVE,
                                                  "kv_layout": layout}),
                      device="cuda")
    t0 = time.perf_counter()
    res = eng.run(_requests(Request, cfg.vocab_size))
    torch.cuda.synchronize()
    return eng, res, time.perf_counter() - t0


def phase_serving(torch, ops, lm, cfg, ServeEngine, ServeConfig,
                  Request, lean=False) -> dict:
    """Phase 4's serving run of ``cfg`` at full width: a warm-up run, the
    counted (timed) run, and engine steps of one more run under the
    profiler with the host's ops. ``lean`` (the larger models of phase 36):
    the warm-up run is the profiled one, the device's activity alone."""
    t0 = time.perf_counter()
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"serving {cfg.name} ({cfg.num_layers} layers, d_model "
          f"{cfg.d_model}, {cfg.padded_heads} q heads / {cfg.num_kv_heads} "
          f"kv heads, vocab {cfg.padded_vocab_size}, {cfg.dtype}): "
          f"{n_params / 1e6:.1f} M params, init {time.perf_counter() - t0:.2f}"
          f" s; {len(PROMPT_LENS)} requests, prompts {PROMPT_LENS}, "
          f"{NEW_TOKENS} new tokens each; {SERVE}")
    if lean:
        _profile(torch, cfg, params, ServeEngine, ServeConfig, Request,
                 host_ops=False)
    else:
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
    peak = torch.cuda.max_memory_allocated()
    print(f"  peak device memory: {peak / 2**30:.2f} GiB")
    if not lean:
        _profile(torch, cfg, params, ServeEngine, ServeConfig, Request)
    return {"launches": launches, "tok_s": gen / dt, "peak": peak}


def _check_launches(launches: dict, cfg, stats: dict,
                    layout="paged", jobs=0) -> None:
    """Each kernel of the path ran, as often as the path calls it (and so
    at least once): one decode attention per layer and decode step (the
    paged kernel on the paged layout, the dense one on the dense layout),
    one RMSNorm per norm (two per block and the final one) and forward,
    and no other kernel. A forward is a decode step, a single-shot or
    prefix-path prefill, or a chunk of a chunked prefill: ``jobs`` of the
    counted prefills were chunked, and their chunks are the forwards."""
    steps = stats["decode_chunks"] * SERVE["decode_chunk"]
    forwards = stats["prefills"] - jobs + stats["prefill_chunks"]
    want = {k: 0 for k in launches}   # the training kernels: off this path
    attn = {"paged": "paged_decode_attention",
            "dense": "decode_attention"}[layout]
    want.update({
        attn: cfg.num_layers * steps,
        "rmsnorm": (2 * cfg.num_layers + 1) * (steps + forwards)})
    check(launches == want, f"launch counts {launches} != the {layout} "
          f"path's {want} ({steps} decode steps, {forwards} prefill "
          f"forwards)")


def _leaves(tree):
    for v in tree.values():
        yield from (_leaves(v) if isinstance(v, dict) else (v,))


def _profile(torch, cfg, params, ServeEngine, ServeConfig, Request,
             host_ops=True):
    """Where the device time and the host time go in engine steps
    ``SERVE_PROFILE[0]`` onwards of one more serving run (``SERVE_PROFILE[1]``
    steps: the second wave's admission, its 4 prefills and 2 decode
    chunks), the host's ops recorded too unless ``host_ops`` is off."""
    from torch.profiler import ProfilerActivity
    _, _, prof, wall = _profiled_steps(
        torch, ServeEngine, SERVE_PROFILE,
        [ProfilerActivity.CPU, ProfilerActivity.CUDA] if host_ops
        else [ProfilerActivity.CUDA],
        lambda: _serve_once(torch, cfg, params, ServeEngine, ServeConfig,
                            Request))
    averages = prof.key_averages()
    events = [e for e in averages
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    busy_us = sum(e.device_time_total for e in events)
    if not events:
        print("  profile: the profiler saw no device time (not measured)")
        return
    row1 = [e for e in events if "decode_kernel" in e.key]
    print(f"  profile (engine steps {SERVE_PROFILE[0]} to "
          f"{sum(SERVE_PROFILE) - 1} of one more run, profiler on): wall "
          f"{wall * 1e3:.1f} ms,"
          f" device kernels {busy_us / 1e3:.1f} ms, device idle share "
          f"{max(0.0, 1 - busy_us / 1e6 / wall):.3f}; "
          f"{sum(e.count for e in events)} launches; row 1 "
          f"{sum(e.device_time_total for e in row1) / 1e3:.2f} ms in "
          f"{sum(e.count for e in row1)} launches")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:12]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")
    if not host_ops:
        return
    host = [e for e in averages if e.self_cpu_time_total > 0]
    print(f"  host ops by self time (profiler on, "
          f"{sum(e.count for e in host)} calls):")
    for e in sorted(host, key=lambda e: -e.self_cpu_time_total)[:8]:
        print(f"    {e.self_cpu_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")


def phase_consistency(torch, ops, lm, cfg, ServeEngine, ServeConfig,
                      Request, tie_rtol=0.0) -> dict:
    """f32 engine tokens == argmax of one teacher-forced prefill per request
    (rows = the request's prompt + generated tokens, lengths = prompt + i),
    on the paged layout and on the dense one. With ``tie_rtol`` > 0 a
    position where the engine took a token whose prefill logit is within
    ``tie_rtol`` (relative) of the prefill's top one is a tie at f32
    rounding, not a mismatch: it is printed, and every later position is
    still held exactly (the prefill reads the engine's own tokens). Returns
    the launches of the dense run."""
    cfg = cfg.replace(dtype="float32")
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    reqs = {r.uid: r for r in _requests(Request, cfg.vocab_size)}
    out = {}
    for layout in ("paged", "dense"):
        ties = []
        ops.reset_launches()
        eng, res, _ = _serve_once(torch, cfg, params, ServeEngine,
                                  ServeConfig, Request, layout)
        launches = dict(ops.LAUNCHES)
        _check_launches(launches, cfg, eng.stats, layout)
        checked = 0
        for uid, toks in sorted(res.items()):
            prompt = reqs[uid].tokens
            full = torch.as_tensor(list(prompt) + list(toks), device="cuda")
            rows = full[None, :].expand(NEW_TOKENS, -1).contiguous()
            lengths = torch.arange(NEW_TOKENS, device="cuda") + len(prompt)
            logits, _ = lm.prefill(params, cfg, {"tokens": rows},
                                   rows.shape[1], lengths=lengths)
            check(tuple(logits.shape) == (NEW_TOKENS, cfg.padded_vocab_size)
                  and torch.isfinite(logits[:, :cfg.vocab_size]).all()
                  .item(), f"{layout} request {uid}: prefill logits "
                  f"{tuple(logits.shape)} not finite or misshapen")
            want = torch.argmax(logits, dim=-1).cpu().numpy()
            bad = [int(i) for i in (want != toks).nonzero()[0]]
            lf = logits.float().cpu()
            for i in list(bad):
                best, took = lf[i, int(want[i])], lf[i, int(toks[i])]
                if best - took <= tie_rtol * max(1.0, abs(best.item())):
                    ties.append(f"{layout} request {uid} position {i}: "
                                f"{int(toks[i])} {took.item():.7g} against "
                                f"{int(want[i])} {best.item():.7g}")
                    bad.remove(i)
            if bad:
                i = bad[0]
                top = torch.topk(logits[i].float(), 2).values.tolist()
                raise PhaseFailed(
                    f"{layout} request {uid} (prompt {len(prompt)}): first "
                    f"mismatch at generated position {i}: engine "
                    f"{int(toks[i])}, teacher-forced prefill {int(want[i])} "
                    f"(top-2 logits {top})")
            checked += len(toks)
        print(f"consistency {cfg.name} (f32, {cfg.num_layers} layers, "
              f"d_model {cfg.d_model}, {layout} KV): {checked} greedy "
              f"tokens of {len(res)} requests equal the teacher-forced "
              f"prefill argmax{_ties(ties, tie_rtol)}; kernel launches in "
              f"that serving run "
              f"({eng.stats['decode_chunks'] * SERVE['decode_chunk']} decode "
              f"steps): {json.dumps(launches)}")
        out[layout] = launches
    return {"dense_launches": out["dense"]}


def _ties(ties: list, rtol: float) -> str:
    return (f", but for {len(ties)} tie(s) within {rtol:g} relative: "
            f"{'; '.join(ties)}" if ties else "")


# ------------------------------------------------------------ training


def _bits_equal(torch, a, b) -> bool:
    ib = {torch.float32: torch.int32, torch.bfloat16: torch.int16}[a.dtype]
    return a.shape == b.shape and torch.equal(a.view(ib), b.view(ib))


def _sel_rows(nl: int) -> tuple:
    """5 of nl stacked rows selected: qwen2.5-0.5b's TRAIN_SEL_ROWS, else
    every (nl // 5)-th row from row 1."""
    return TRAIN_SEL_ROWS if nl == 24 else tuple(range(1, nl, nl // 5))[:5]


def _leaf_rows(torch, ops, ref, timer, dtype, leaf, nl, r) -> list:
    """Rows 7 and 8 on one stacked leaf [nl, r] against their plain
    versions: the norms bit-identical over two launches, AdamW rows with
    sel = 0 bit-identical; returns their summary rows."""
    adam = dict(lr=0.3, b1=0.9, b2=0.999, eps=1e-8, wd=0.1)
    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
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
    rows = [dict(kernel="block_grad_sq_norms", case=leaf, dtype=dtype,
                 shape=f"[{nl}, {r}]", max_abs_err=err,
                 tol=TOL["float32"],
                 ms=timer.ms(lambda: ops.block_grad_sq_norms(grad)),
                 plain_ms=timer.ms(lambda: ref.block_grad_sq_norms(grad)),
                 library_ms=timer.ms(lambda: torch.linalg.vector_norm(
                     grad, dim=1, dtype=torch.float32) ** 2),
                 bound_ms=bms, bound_by=by)]
    del out, again
    # row 8: masked AdamW, in place
    p, m, v = rnd().to(dt), rnd(0.1, 0.05), rnd(0.01).abs() + 0.01
    sel_rows = _sel_rows(nl)
    sel = torch.zeros(nl, device="cuda")
    sel[list(sel_rows)] = 1.0
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
    del pr, mr, vr
    for what, new, old in (("p", pk, p), ("m", mk, m), ("v", vk, v)):
        check(_bits_equal(torch, new[~on], old[~on]),
              f"masked_adamw {leaf} {dtype}: {what} of a row with "
              f"sel = 0 changed")
    moved = (pk[on].float() - p[on].float()).abs().max().item()
    check(moved > 5 * TOL[dtype], f"masked_adamw {leaf} {dtype}: "
          f"the step ({moved:.3g}) is too small for the check")
    n_sel = len(sel_rows)
    bms, by = bound_ms(n_sel * r * (3 * es + 16) + 2 * nl * 4,
                       15 * n_sel * r, "float32")
    rows.append(dict(kernel="masked_adamw", case=leaf, dtype=dtype,
                     shape=f"[{nl}, {r}], {n_sel} rows selected",
                     max_abs_err=err, tol=TOL[dtype],
                     ms=timer.ms(lambda: ops.masked_adamw(pk, grad, mk, vk,
                                                          *args)),
                     plain_ms=timer.ms(lambda: ref.masked_adamw(
                         p, grad, m, v, *args)),
                     library_ms=None, bound_ms=bms, bound_by=by))
    if dtype == "bfloat16":   # bf16 moments train with bf16 params
        del pk, mk, vk
        rows.append(_adamw_bf16m_row(torch, ops, ref, timer, dtype, leaf, p,
                                     grad, m.bfloat16(), v.bfloat16(), sel,
                                     cnt, adam))
    return rows


def _bf16_gap(torch, got, want, terms) -> float:
    """How far bf16 moments from the kernel are from the plain version's,
    in units of one bf16 ulp at the larger of the two plus the f32
    rounding of the update's terms (``terms``: |b m| + |(1 - b) g|, or the
    same of v): the kernel may contract b m + (1 - b) g into an FMA, which
    moves the f32 sum by an f32 ulp of its terms, and where the sum cancels
    to near zero that is more than a bf16 ulp of the result. At most 1
    means within one bf16 ulp of the plain version (or of the f32
    rounding where the moment cancels)."""
    a, b = got.float(), want.float()
    big = torch.maximum(a.abs(), b.abs())
    ulp = torch.exp2(torch.floor(torch.log2(big.clamp(min=2.0 ** -126)))
                     - 7)
    return ((a - b).abs() / (ulp + 2.0 ** -22 * terms)).max().item()


def _bf16_terms(b1, b2, m, v, grad):
    """The magnitudes of the terms of m' and v' (``_bf16_gap``)."""
    g = grad.float()
    return (b1 * m.float().abs() + (1 - b1) * g.abs(),
            b2 * v.float().abs() + (1 - b2) * g * g)


def _adamw_bf16m_row(torch, ops, ref, timer, dtype, leaf, p, grad, m, v,
                     sel, cnt, adam) -> dict:
    """Row 8 with bf16 m and v against its plain version: m and v within
    one bf16 ulp (``_bf16_gap``), p within the tolerance, rows with sel = 0
    bit-identical; counted as ``masked_adamw_bf16m``."""
    nl, r = p.shape
    es, ems = p.element_size(), m.element_size()
    args = (sel, cnt, *adam.values())
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    n0 = ops.LAUNCHES["masked_adamw_bf16m"]
    ops.masked_adamw(pk, grad, mk, vk, *args)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["masked_adamw_bf16m"] == n0 + 1,
          "masked_adamw_bf16m did not count its launch")
    pr, mr, vr = ref.masked_adamw(p, grad, m, v, *args)
    on = sel > 0
    err = _check_close(torch, pk[on], pr[on], dtype,
                       f"masked_adamw_bf16m p {leaf}")
    tm, tv = _bf16_terms(adam["b1"], adam["b2"], m[on], v[on], grad[on])
    gap = max(_bf16_gap(torch, mk[on], mr[on], tm),
              _bf16_gap(torch, vk[on], vr[on], tv))
    check(gap <= 1, f"masked_adamw_bf16m {leaf} {dtype}: m or v {gap:.3g} "
          f"bf16 ulps from the plain version")
    del pr, mr, vr, tm, tv
    for what, new, old in (("p", pk, p), ("m", mk, m), ("v", vk, v)):
        check(_bits_equal(torch, new[~on], old[~on]),
              f"masked_adamw_bf16m {leaf} {dtype}: {what} of a row with "
              f"sel = 0 changed")
    moved = (pk[on].float() - p[on].float()).abs().max().item()
    check(moved > 5 * TOL[dtype], f"masked_adamw_bf16m {leaf} {dtype}: "
          f"the step ({moved:.3g}) is too small for the check")
    n_sel = int(on.sum().item())
    # p and g read, p written (3 es); m and v read and written (4 ems)
    bms, by = bound_ms(n_sel * r * (3 * es + 4 * ems) + 2 * nl * 4,
                       15 * n_sel * r, "float32")
    return dict(kernel="masked_adamw_bf16m", case=leaf, dtype=dtype,
                shape=f"[{nl}, {r}], {n_sel} rows selected, bf16 m/v "
                f"within {gap:.2f} ulp", max_abs_err=err, tol=TOL[dtype],
                ms=timer.ms(lambda: ops.masked_adamw(pk, grad, mk, vk,
                                                     *args)),
                plain_ms=timer.ms(lambda: ref.masked_adamw(p, grad, m, v,
                                                           *args)),
                library_ms=None, bound_ms=bms, bound_by=by)


def _bf16m_rounding(torch) -> str:
    """The bf16-moment store rounds to nearest even: b1 = b2 = 0 makes
    m' = g exactly (f32 params), and g on a tie between two bf16 values
    must be stored as the even one; the compiled kernel's PTX converts with
    ``cvt.rn`` (launched outside the counted wrapper)."""
    from repro_torch.kernels import masked_adamw as _ma
    step = 2.0 ** -8     # half a bf16 ulp at 1
    g = torch.tensor([[1 + step, 1 + 3 * step, -(1 + step), 1 + 5 * step]],
                     device="cuda")
    want = torch.tensor([[1.0, 1 + 2 ** -6, -1.0, 1 + 2 ** -6]],
                        dtype=torch.bfloat16, device="cuda")
    m = torch.zeros_like(g, dtype=torch.bfloat16)
    v = torch.zeros_like(m)
    one = torch.ones(1, device="cuda")
    kernel = _ma.launch(torch.ones_like(g), g, m, v, one, one, 1e-3, 0.0,
                        0.0, 1e-8, 0.0)
    torch.cuda.synchronize()
    check(_bits_equal(torch, m, want), f"bf16 moments: ties stored as "
          f"{m.float().tolist()}, want {want.float().tolist()}")
    ptx = kernel.asm["ptx"]
    rn, rz = ptx.count("cvt.rn.bf16"), ptx.count("cvt.rz.bf16")
    check(rn > 0 and rz == 0, f"bf16 moments: the PTX holds {rn} cvt.rn and "
          f"{rz} cvt.rz bf16 conversions")
    return (f"bf16-moment store: ties to even, as XLA's convert; PTX "
            f"{rn} cvt.rn.bf16 conversions, no cvt.rz")


def _norm_inputs(torch, dt, n, d, seed=5):
    """x with nonzero column means, scale near 1, dy = 1 + N(0, 1): the
    RMSNorm's outputs and gradients are large beside the tolerance."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    mu = 1 + 0.5 * torch.randn(d, generator=g, device="cuda")
    x = (mu + torch.randn(n, d, generator=g, device="cuda")).to(dt)
    s = (1 + 0.1 * torch.randn(d, generator=g, device="cuda")).to(dt)
    dy = (1 + torch.randn(n, d, generator=g, device="cuda")).to(dt)
    return x, s, dy


def _norm_usage(torch, x, s, dy) -> str:
    """Registers a thread and spills of the compiled row pass (full and
    dx-only) and column pass of row 2b at this shape, as Triton reports
    them (launched outside the counted wrappers); fails on a spill or when
    Triton reports neither. (Row 2's are ptxas's: ``_norm_fwd_usage``.)"""
    from repro_torch.kernels import rmsnorm as rn
    row, col = rn.launch_bwd(x, s, dy, 1e-6, torch.empty_like(x),
                             torch.empty_like(s))
    dx_only, _ = rn.launch_bwd(x, s, dy, 1e-6, torch.empty_like(x), None)
    kernels = [("row pass", row), ("col sums", col),
               ("row pass dx-only", dx_only)]
    out = []
    for name, k in kernels:
        regs = getattr(k, "n_regs", None)
        spills = getattr(k, "n_spills", None)
        check(spills == 0, f"rmsnorm {name} {tuple(x.shape)} {x.dtype}: "
              f"{spills} spills ({regs} registers)")
        out.append(f"{name} {regs} regs")
    return ", ".join(out) + ", no spills"


def _norm_bwd_rows(torch, ops, ref, timer, F, dtype, n, d) -> list:
    """Row 2b at [n, d] against its plain version: dx and dscale
    bit-identical over two launches, the dx-only mode in one launch with
    the full mode's dx bits, no register spills; timed (with the summary
    rows returned) at the training path's 8 x 512 rows."""
    dt = getattr(torch, dtype)
    es = torch.tensor([], dtype=dt).element_size()
    x, s, dy = _norm_inputs(torch, dt, n, d)
    n0 = ops.LAUNCHES["rmsnorm_bwd"]
    dx, ds = ops.rmsnorm_bwd(dy, x, s, 1e-6)
    dx2, ds2 = ops.rmsnorm_bwd(dy, x, s, 1e-6)
    torch.cuda.synchronize()
    check(ops.LAUNCHES["rmsnorm_bwd"] == n0 + 2,
          "rmsnorm_bwd did not count its launches")
    check(_bits_equal(torch, dx, dx2) and _bits_equal(torch, ds, ds2),
          f"rmsnorm_bwd [{n}, {d}] {dtype}: two launches gave different "
          f"bits")
    pdx, pds = ref.rmsnorm_bwd(dy, x, s, 1e-6)
    err = _check_close(torch, dx, pdx, dtype, f"rmsnorm_bwd dx [{n}, {d}]")
    err = max(err, _check_close(torch, ds[None], pds[None], dtype,
                                f"rmsnorm_bwd dscale [{n}, {d}]"))
    # the dx-only mode (a frozen layer's norm): one launch, the plain
    # dx-only version's dx within the tolerance, the full mode's dx bit for
    # bit
    before = dict(ops.LAUNCHES)
    dxo, dso = ops.rmsnorm_bwd(dy, x, s, 1e-6, with_dscale=False)
    torch.cuda.synchronize()
    check({k: ops.LAUNCHES[k] - before[k] for k in before} == {
        k: int(k == "rmsnorm_bwd_dx") for k in before},
        f"rmsnorm_bwd dx-only [{n}, {d}] {dtype}: not one rmsnorm_bwd_dx "
        f"launch")
    check(dso is None and _bits_equal(torch, dxo, dx),
          f"rmsnorm_bwd dx-only [{n}, {d}] {dtype}: dx differs from the "
          f"full mode's bits")
    pdxo, _ = ref.rmsnorm_bwd(dy, x, s, 1e-6, with_dscale=False)
    err_dx = _check_close(torch, dxo, pdxo, dtype,
                          f"rmsnorm_bwd dx-only [{n}, {d}]")
    usage = _norm_usage(torch, x, s, dy)
    print(f"  rmsnorm_bwd [{n}, {d}] {dtype}: dx and dscale within the "
          f"tolerance (max |err| {err:.2e}), bit-identical over two "
          f"launches; dx-only mode within the tolerance (max |err| "
          f"{err_dx:.2e}), one launch, the full mode's dx bits; {usage}")
    if n != TRAIN["global_batch"] * TRAIN["seq_len"]:
        return []
    xl = x.clone().requires_grad_()
    sl = s.clone().requires_grad_()
    yl = F.rms_norm(xl, (d,), weight=sl, eps=1e-6)
    bms, by = bound_ms(3 * n * d * es + 2 * d * es, 10 * n * d, "float32")
    row = dict(kernel="rmsnorm_bwd", case=f"N={n}", dtype=dtype,
               shape=f"[{n}, {d}]", max_abs_err=err, tol=TOL[dtype],
               ms=timer.ms(lambda: ops.rmsnorm_bwd(dy, x, s, 1e-6)),
               plain_ms=timer.ms(lambda: ref.rmsnorm_bwd(dy, x, s, 1e-6)),
               library_ms=timer.ms(lambda: torch.autograd.grad(
                   yl, (xl, sl), dy, retain_graph=True),
                   spin=LONG_SPIN_CYCLES),
               bound_ms=bms, bound_by=by)
    # dx-only: reads x and dy, writes dx (and the scale once)
    yo = F.rms_norm(xl, (d,), weight=s, eps=1e-6)
    bms, by = bound_ms(3 * n * d * es + d * es, 8 * n * d, "float32")
    row_dx = dict(kernel="rmsnorm_bwd_dx", case=f"N={n}", dtype=dtype,
                  shape=f"[{n}, {d}]", max_abs_err=err_dx, tol=TOL[dtype],
                  ms=timer.ms(lambda: ops.rmsnorm_bwd(
                      dy, x, s, 1e-6, with_dscale=False)),
                  plain_ms=timer.ms(lambda: ref.rmsnorm_bwd(
                      dy, x, s, 1e-6, with_dscale=False)),
                  library_ms=timer.ms(lambda: torch.autograd.grad(
                      yo, (xl,), dy, retain_graph=True),
                      spin=LONG_SPIN_CYCLES),
                  bound_ms=bms, bound_by=by)
    return [row, row_dx]


def phase_train_kernels(torch, ops, ref, timer) -> dict:
    """Rows 7, 8 and 2b against their plain versions; returns the summary
    entries of the main path's largest launch (qwen2.5-0.5b's wg, bf16, for
    rows 7 and 8; [4096, 3072] bf16, phi4-mini's, for the RMSNorm
    backward, and [4096, 896] for its dx-only mode, which only the gated
    qwen2.5-0.5b runs take)."""
    F = torch.nn.functional
    rows, main = [], {}
    for dtype in ("bfloat16", "float32"):
        for leaf, (nl, r) in {**TRAIN_LEAVES, **WIDE_LEAVES}.items():
            rows += _leaf_rows(torch, ops, ref, timer, dtype, leaf, nl, r)
            if leaf == "wg" and dtype == "bfloat16":
                main.update({r["kernel"]: r for r in rows[-3:]})
            gc.collect()
            torch.cuda.empty_cache()
        # row 2b: RMSNorm backward at a decode row block and at the
        # training path's [8 * 512, D] (timed), D of the three models
        for n, d in NORM_BWD_SHAPES:
            rows += _norm_bwd_rows(torch, ops, ref, timer, F, dtype, n, d)
            if dtype != "bfloat16":
                continue
            if (n, d) == NORM_MAIN:
                main["rmsnorm_bwd"] = rows[-2]
            if (n, d) == NORM_DX_MAIN:
                main["rmsnorm_bwd_dx"] = rows[-1]
    print("training kernels vs plain versions (CUDA events, L2 flushed, ms "
          "per call):")
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['kernel']:<20} {r['case']:<8} {r['dtype']:<9} "
              f"err {r['max_abs_err']:.2e} (rtol=atol {r['tol']:.0e})  "
              f"kernel {r['ms']:.4f}  plain {r['plain_ms']:.4f}  "
              f"library {lib}  bound {r['bound_ms']:.5f} ({r['bound_by']})"
              f"  {r['shape']}")
    print(f"  {_bf16m_rounding(torch)}")
    print("  yardsticks: torch.linalg.vector_norm(g, dim=1, dtype=f32)**2 "
          "(row 7), the autograd of F.rms_norm (2b; dx-only: with respect "
          "to x alone); masked_adamw has none (no single call takes "
          "per-row masks and counts)")
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


def _adamw_name(row: str, moment_dtype: str) -> str:
    """The launch count of row 8 or 9 (``ops.LAUNCHES``) under a moment
    dtype: bf16 moments count apart."""
    return row + ("_bf16m" if moment_dtype == "bfloat16" else "")


def _train_launches(nl: int, adamw: str = "masked_adamw",
                    sel_layers: int | None = None, leaves: int = 12) -> dict:
    """Kernel launches of one training step of nl layers: the forward's
    norms and, under ``remat="full"``, each layer's two norms again; the
    backward's norms, in the full mode once per norm of a layer that gets
    weight gradients (``sel_layers`` of them under the gate, else all) and
    the final norm, in the dx-only mode once per norm of a frozen layer;
    one block norm and one AdamW launch (``adamw``: dense or banked) a
    stacked [L, ...] leaf of the params' ``layers`` (``leaves``: 12 with
    QKV bias, 9 without); the flash kernels."""
    sel = nl if sel_layers is None else sel_layers
    want = {"paged_decode_attention": 0, "decode_attention": 0,
            "block_grad_sq_norms": leaves, "masked_adamw": 0,
            "masked_adamw_bf16m": 0, "banked_masked_adamw": 0,
            "banked_masked_adamw_bf16m": 0, "rmsnorm": 4 * nl + 1,
            "rmsnorm_bwd": 2 * sel + 1, "rmsnorm_bwd_dx": 2 * (nl - sel),
            **_flash_per_step(nl)}
    want[adamw] = leaves
    return want


def phase_training(torch, ops, cfg, Trainer, steps=TRAIN["steps"],
                   keep_eval=True, moment_dtype="float32") -> dict:
    """The dense adagradselect run at full width, its moments in
    ``moment_dtype``; with ``keep_eval`` the trained params' eval view, on
    the host, for the greedy eval."""
    warm = TRAIN["warmup"]
    tcfg = _train_cfg(cfg, "adagradselect", steps, TRAIN["global_batch"],
                      TRAIN["seq_len"], moment_dtype=moment_dtype)
    t0 = time.perf_counter()
    tr = Trainer(tcfg, device="cuda")
    torch.cuda.synchronize()
    nb = cfg.num_blocks
    k = tr.sel_cfg.num_selected(nb)
    print(f"training {cfg.name} ({cfg.num_layers} layers, {cfg.dtype}, "
          f"{nb} blocks, k = {k}): adagradselect, dense residency, "
          f"{moment_dtype} moments, batch "
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
    want = _train_launches(
        nl, _adamw_name("masked_adamw", moment_dtype),
        leaves=len(list(_leaves(tr.state["params"]["layers"]))))
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
    prof = _profile_training(torch, tr)
    # phase 16 evaluates these params; they wait on the host, so that the
    # peaks measured in between are those of the phases' own runs
    eval_params = (_to(tr.method.eval_params(cfg, tcfg.optimizer, tr.state),
                       "cpu") if keep_eval else None)
    return {"launches": launches, "step_ms": med * 1e3, "peak": peak,
            "tokens_s": tokens / med, "eval_params": eval_params,
            "task": tr.data.cfg, "profile": prof}


def _is_matmul(key: str) -> bool:
    """A library matrix-product kernel, by its name (cuBLAS / cuBLASLt /
    CUTLASS on Hopper)."""
    k = key.lower()
    return any(w in k for w in MATMUL_WORDS)


def _profile_training(torch, tr, steps=2, top=15, host_ops=True) -> dict:
    """Profiles ``steps`` more steps (the host's activity too unless
    ``host_ops`` is off); prints and returns their device time, launches,
    matrix-product launches and the device's idle share (an empty dict
    when the profiler saw no device time)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]
                 if host_ops else [ProfilerActivity.CUDA]) as prof:
        tr.train(steps)
    wall = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    if not events:
        print("  profile: the profiler saw no device time (not measured)")
        return {}
    busy_us = sum(e.device_time_total for e in events)
    mm = [e for e in events if _is_matmul(e.key)]
    out = {"wall_ms": wall * 1e3, "device_ms": busy_us / 1e3,
           "launches": sum(e.count for e in events),
           "matmul_launches": sum(e.count for e in mm),
           "matmul_ms": sum(e.device_time_total for e in mm) / 1e3,
           "idle": max(0.0, 1 - busy_us / 1e6 / wall)}
    print(f"  profile ({steps} more steps, profiler on): wall "
          f"{out['wall_ms']:.1f} ms, device kernels {out['device_ms']:.1f} ms "
          f"in {out['launches']} launches, device idle share "
          f"{out['idle']:.3f}; matrix products {out['matmul_ms']:.1f} ms in "
          f"{out['matmul_launches']} launches")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:top]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")
    ours = {}
    for e in events:   # the port's kernels, by their function names
        for fn in ("_rmsnorm_bwd", "_col_sums", "_partials",
                   "_row_sums", "_masked_adamw", "_banked_masked_adamw"):
            if e.key.startswith(fn):      # Triton: the name comes first
                ours[fn] = ours.get(fn, 0.0) + e.device_time_total / 1e3
        if "rmsnorm_fwd_kernel" in e.key:   # CUDA C++: inside the signature
            ours["rmsnorm_fwd_kernel"] = (ours.get("rmsnorm_fwd_kernel", 0.0)
                                          + e.device_time_total / 1e3)
        for fn in FLASH_NAMES:
            if any(name in e.key for name in FLASH_PARTS[fn]):
                ours[fn] = ours.get(fn, 0.0) + e.device_time_total / 1e3
    flash = sum(ours.get(fn, 0.0) for fn in FLASH_NAMES)
    print(f"  the port's kernels in that profile (ms): "
          f"{json.dumps({k: round(v, 3) for k, v in ours.items()})}, "
          f"{sum(ours.values()) / (busy_us / 1e3):.3f} of device time; the "
          f"flash kernels {flash:.3f} ms = {flash / (busy_us / 1e3):.3f}")
    return out


def _to(tree, device):
    if isinstance(tree, dict):
        return {k: _to(v, device) for k, v in tree.items()}
    if hasattr(tree, "to"):
        return tree.to(device).clone()
    return tree


def _update_gap(torch, card_params, cpu_params, before, limit,
                noise=None) -> float:
    """Each leaf's update (params after minus ``before``) on the card
    against the CPU's, as a relative L2 gap (a wrong or missing update is
    ~1); fails above ``limit`` or when a leaf the CPU left unchanged moved
    on the card. ``noise`` ({leaf name: index}, ``_zero_grad_entries``)
    names entries whose gradient is zero in exact arithmetic: their updates
    are left out of the gap (the caller holds every entry to an absolute
    bound). Returns the largest gap."""
    gap = 0.0
    noise = noise or {}
    for (name, a), b, a0 in zip(_named_leaves(card_params),
                                _leaves(cpu_params), before):
        dc, dh = a.cpu() - a0, b - a0
        if name in noise:
            dc[noise[name]] = 0.0
            dh[noise[name]] = 0.0
        scale = dh.norm().item()
        check(scale > 0 or not dc.any(), "a leaf the CPU left unchanged "
              "moved on the card")
        if scale > 0:
            gap = max(gap, (dc - dh).norm().item() / scale)
    check(gap <= limit, f"updates differ by {gap:.3g} of the CPU's "
          f"(relative L2, limit {limit:g})")
    return gap


def _zero_grad_entries(cfg) -> dict:
    """Parameter entries whose gradient is zero in exact arithmetic, by
    construction: with QKV bias and partial rotary (chatglm3-6b), the
    unrotated dims of the key bias, since q . b_k is the same for every key
    of a query and the softmax ignores it. In f32 their gradients are
    rounding noise (~1e-8, the size of AdamW's eps) on the card and on the
    CPU alike, so their first updates are noise too."""
    from repro_torch.models.layers.rope import rotary_dims
    rot = rotary_dims(cfg.head_dim, cfg.partial_rotary_factor)
    if not cfg.attn_bias or rot == cfg.head_dim:
        return {}
    return {"layers.attn.bk": (Ellipsis, slice(rot, None))}


def phase_train_consistency(torch, ops, cfg, Trainer, k_percent=20.0,
                            moment_dtype="float32", steps=3, layers=2,
                            loss_rtol=1e-4) -> None:
    """The same ``steps`` f32 topk_grad steps of ``layers`` layers on the
    card and on the CPU, losses within ``loss_rtol`` (relative), every
    parameter within 2 lr a step of the CPU's, each leaf's update held
    against the CPU's as in phase 19 (``_update_gap``; the entries of
    ``_zero_grad_entries`` by the absolute bound alone); the moments in
    ``moment_dtype``."""
    lr = 1e-3
    cfg = cfg.replace(dtype="float32", num_layers=layers)
    tcfg = _train_cfg(cfg, "topk_grad", steps, 2, 64, lr=lr,
                      schedule="constant", warmup_steps=0,
                      k_percent=k_percent, moment_dtype=moment_dtype)
    card = Trainer(tcfg, device="cuda")
    cpu = Trainer(tcfg, device="cpu")
    cpu.state = _to(card.state, "cpu")
    p0 = [t.clone() for t in _leaves(cpu.state["params"])]
    ops.reset_launches()
    for i in range(steps):
        card.train(1)
        cpu.train(1)
        lc, lh = card.log.losses[-1], cpu.log.losses[-1]
        check(abs(lc - lh) <= loss_rtol * abs(lh),
              f"step {i}: loss card {lc} vs cpu {lh}")
        mc = card.state["sel"]["mask"].cpu()
        check(torch.equal(mc, cpu.state["sel"]["mask"]),
              f"step {i}: masks differ: card {mc.int().tolist()} cpu "
              f"{cpu.state['sel']['mask'].int().tolist()}")
    launches = dict(ops.LAUNCHES)
    check(all(launches[n] > 0 for n in ("rmsnorm", "rmsnorm_bwd",
                                        "block_grad_sq_norms",
                                        _adamw_name("masked_adamw",
                                                    moment_dtype),
                                        *_flash_per_step(1))),
          f"a training kernel did not run on the card: {launches}")
    worst = 0.0
    pc, ph = card.state["params"], cpu.state["params"]
    for a, b in zip(_leaves(pc), _leaves(ph)):
        worst = max(worst, (a.cpu() - b).abs().max().item())
    limit = 2 * lr * steps
    check(worst <= limit, f"params differ by {worst} > {limit}")
    noise = _zero_grad_entries(cfg)
    gap = _update_gap(torch, pc, ph, p0, UPDATE_GAP, noise)
    left_out = "".join(f"; {n}'s dims past the rotary ones left out: their "
                       f"exact gradient is 0" for n in noise)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.log.losses,
                                                   cpu.log.losses))
    print(f"training consistency {cfg.name} (f32, TF32 off, "
          f"{moment_dtype} moments, "
          f"{cfg.num_layers} layers, d_model {cfg.d_model}, batch 2 x 64, "
          f"{steps} "
          f"topk_grad steps, k = {card.sel_cfg.num_selected(cfg.num_blocks)}"
          f" of {cfg.num_blocks} blocks, card vs CPU): losses "
          f"{[round(x, 6) for x in card.log.losses]}, max rel err "
          f"{rel:.2e} (limit {loss_rtol:g}); masks equal at every step; "
          f"params max "
          f"|err| {worst:.3g} (limit {limit:g}); each leaf's update within "
          f"{gap:.3g} of the CPU's (relative L2, limit {UPDATE_GAP:g}"
          f"{left_out}); card launches {json.dumps(launches)}")
    del card, cpu


# ------------------------------------------------------- banked residency


def _banked_case(torch, ops, ref, timer, dtype, leaf, nl, r,
                 moments="float32") -> dict:
    """Row 9 on one stacked leaf [nl, r] with [5, r] banks in ``moments``
    (f32, or bf16 as ``banked_masked_adamw_bf16m``) against its plain
    version and against row 8 on a dense copy; returns its summary row."""
    adam = (0.3, 0.9, 0.999, 1e-8, 0.1)
    cap = len(BANK_SLOTS)
    dt, mdt = getattr(torch, dtype), getattr(torch, moments)
    name = _adamw_name("banked_masked_adamw", moments)
    es = torch.tensor([], dtype=dt).element_size()
    ems = torch.tensor([], dtype=mdt).element_size()
    g = torch.Generator(device="cuda").manual_seed(nl * r % 7919)

    def rnd(n, scale=1.0, shift=0.0):
        return shift + scale * torch.randn(n, r, generator=g, device="cuda")
    p, grad = rnd(nl).to(dt), rnd(nl, 1.0, 0.5).to(dt)
    m, v = rnd(cap, 0.1, 0.05).to(mdt), (rnd(cap, 0.01).abs() + 0.01).to(mdt)
    slots = torch.tensor(BANK_SLOTS, dtype=torch.int32, device="cuda")
    sel = torch.tensor(BANK_SEL, device="cuda")
    cnt = torch.arange(1, cap + 1, dtype=torch.float32, device="cuda")
    args = (slots, sel, cnt, *adam)
    pk, mk, vk = p.clone(), m.clone(), v.clone()
    n0 = ops.LAUNCHES[name]
    ops.banked_masked_adamw(pk, grad, mk, vk, *args)
    torch.cuda.synchronize()
    check(ops.LAUNCHES[name] == n0 + 1, f"{name} did not count its launch")
    pr, mr, vr = ref.banked_masked_adamw(p, grad, m, v, *args)
    on = (slots < nl) & (sel > 0)          # active bank rows
    touched = torch.zeros(nl, dtype=torch.bool, device="cuda")
    touched[slots[on].long()] = True        # their leaf rows
    err = _check_close(torch, pk[touched], pr[touched], dtype,
                       f"{name} p {leaf}")
    note = ""
    if moments == "bfloat16":
        rows = slots[on].long()
        tm, tv = _bf16_terms(adam[1], adam[2], m[on], v[on], grad[rows])
        gap = max(_bf16_gap(torch, mk[on], mr[on], tm),
                  _bf16_gap(torch, vk[on], vr[on], tv))
        check(gap <= 1, f"{name} {leaf} {dtype}: m or v {gap:.3g} bf16 ulps "
              f"from the plain version")
        note = f", bf16 m/v within {gap:.2f} ulp"
    else:
        for what, got, want in (("m", mk, mr), ("v", vk, vr)):
            _check_close(torch, got[on], want[on], "float32",
                         f"{name} {what} {leaf} {dtype}")
    check(_bits_equal(torch, pk[~touched], p[~touched]),
          f"{name} {leaf} {dtype}: a p row no active slot holds changed")
    for what, new, old in (("m", mk, m), ("v", vk, v)):
        check(_bits_equal(torch, new[~on], old[~on]),
              f"{name} {leaf} {dtype}: {what} of a free or unselected bank "
              f"row changed")
    moved = (pk.float() - p.float())[touched].abs().max().item()
    check(moved > 5 * TOL[dtype], f"{name} {leaf} {dtype}: the step "
          f"({moved:.3g}) is too small for the check")
    # row 8 on a dense copy holding the bank rows at their slots
    real = [i for i, s in enumerate(BANK_SLOTS) if s < nl]
    held = [BANK_SLOTS[i] for i in real]
    pd = p.clone()
    md = torch.zeros(nl, r, dtype=mdt, device="cuda")
    vd = torch.zeros(nl, r, dtype=mdt, device="cuda")
    md[held], vd[held] = m[real], v[real]
    seld = torch.zeros(nl, device="cuda")
    cntd = torch.zeros(nl, device="cuda")
    seld[held], cntd[held] = sel[real], cnt[real]
    ops.masked_adamw(pd, grad, md, vd, seld, cntd, *adam)
    torch.cuda.synchronize()
    check(_bits_equal(torch, pk, pd)
          and _bits_equal(torch, mk[real], md[held])
          and _bits_equal(torch, vk[real], vd[held]),
          f"{name} {leaf} {dtype}: not the same bits as masked_adamw on the "
          f"same rows")
    del md, vd, pd, pr, mr, vr
    n_on = int(on.sum().item())
    bms, by = bound_ms(n_on * r * (3 * es + 4 * ems) + cap * 12,
                       15 * n_on * r, "float32")
    return dict(kernel=name, case=leaf, dtype=dtype,
                shape=f"p [{nl}, {r}], banks [{cap}, {r}], {n_on} active "
                f"rows{note}", max_abs_err=err, tol=TOL[dtype],
                ms=timer.ms(lambda: ops.banked_masked_adamw(
                    pk, grad, mk, vk, *args)),
                plain_ms=timer.ms(lambda: ref.banked_masked_adamw(
                    p, grad, m, v, *args)),
                library_ms=None, bound_ms=bms, bound_by=by)


def phase_banked_kernel(torch, ops, ref, timer) -> dict:
    """Row 9 against its plain version and against row 8, f32 moments, and
    bf16 moments under bf16 params; returns the summary entries of the
    main path's largest launch (wg, bf16)."""
    rows, main = [], {}
    for dtype in ("bfloat16", "float32"):
        # bf16 moments train with bf16 params
        kinds = ("float32", "bfloat16") if dtype == "bfloat16" else (
            "float32",)
        for leaf, (nl, r) in TRAIN_LEAVES.items():
            for moments in kinds:
                rows.append(_banked_case(torch, ops, ref, timer, dtype, leaf,
                                         nl, r, moments))
                if leaf == "wg" and dtype == "bfloat16":
                    main[rows[-1]["kernel"]] = rows[-1]
    print("banked masked AdamW vs plain version and vs masked_adamw (CUDA "
          "events, L2 flushed, ms per call):")
    for r in rows:
        print(f"  {r['kernel']:<25} {r['case']:<4} {r['dtype']:<9} "
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


def _banked_run(torch, ops, cfg, Trainer, dense, async_swap=True,
                moment_dtype="float32", profile=True) -> dict:
    """Phase 7's run with banked residency and a pinned host store, its
    moments in ``moment_dtype``: 2 warm-up steps, then one log window (the
    main path's run); its checks and prints beside the dense run
    ``dense``."""
    from repro_torch.core import masked_adamw
    from repro_torch.core import partition as part_mod
    from repro_torch.core.offload import resident_opt_bytes
    steps, warm = TRAIN["steps"], TRAIN["warmup"]
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    nl = cfg.num_layers
    gc.collect()
    torch.cuda.empty_cache()
    tcfg = _train_cfg(cfg, "adagradselect", steps, TRAIN["global_batch"],
                      TRAIN["seq_len"], log_every=steps + 1,
                      moment_residency="banked", offload="host",
                      async_swap=async_swap, moment_dtype=moment_dtype)
    t0 = time.perf_counter()
    tr = Trainer(tcfg, device="cuda")
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pn = part_mod.build_partition(cfg)
    k = tr.sel_cfg.num_selected(pn.num_blocks)
    opt = tr.state["opt"]
    per_block = part_mod.params_per_block(pn, tr.state["params"])
    cap = opt["banks"]["layers"]["slots"].shape[0]
    # m and v, bytes a parameter
    mv = 2 * torch.tensor([], dtype=getattr(torch, moment_dtype)).element_size()
    reckoned = mv * int(cap * per_block[1] + per_block[0]
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
    store = part_mod.leaves(opt["store"])
    check(all(t.is_pinned() and t.dtype == getattr(torch, moment_dtype)
              for t in store),
          f"the host store is not pinned {moment_dtype}")
    label = "async" if async_swap else "sync"
    print(f"banked training ({label} swap) {cfg.name}: adagradselect, "
          f"k = {k} of {pn.num_blocks} blocks, offload host (pinned), "
          f"{moment_dtype} moments, bank capacity {cap}; batch "
          f"{TRAIN['global_batch']} x {TRAIN['seq_len']}; init "
          f"{init_s:.2f} s")
    print(f"  optimizer state: device {res['device']:,} B (banks' m, v "
          f"{bank_mv:,} = reckoned {reckoned:,}), host {res['host']:,} B "
          f"(dense m, v would take {mv * int(per_block.sum()):,} B on the "
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
    want = _train_launches(nl, _adamw_name("banked_masked_adamw",
                                           moment_dtype))
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
    prof = _profile_training(torch, tr) if profile else {}
    return {"launches": launches, "step_ms": step_s * 1e3, "peak": peak,
            "stats": stats, "profile": prof}


def phase_banked_training(torch, ops, cfg, Trainer, dense) -> dict:
    out = {"async": _banked_run(torch, ops, cfg, Trainer, dense, True),
           "sync": _banked_run(torch, ops, cfg, Trainer, dense, False,
                               profile=False)}
    print(f"banked step time: async {out['async']['step_ms']:.2f} ms, sync "
          f"{out['sync']['step_ms']:.2f} ms, dense (phase 7) "
          f"{dense['step_ms']:.2f} ms")
    _timing_rounds(torch, cfg, Trainer)
    return out["async"]


def _timing_rounds(torch, cfg, Trainer, rounds=2) -> None:
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


def _segment_ids(torch, kind, b, s):
    """[B, S] int32 segment ids on the card: a real ``pack_batch``'s
    ("packed"), boundaries on the 64-wide tile edges ("edges"), thirds of
    the row ("thirds", for rows too short to pack), one segment ("single")
    or none (None)."""
    if kind is None:
        return None
    if kind == "packed":
        return torch.as_tensor(_packed_segments(b, s), device="cuda")
    pos = torch.arange(s, device="cuda", dtype=torch.int32)
    ids = {"edges": 1 + pos // 64, "thirds": 1 + pos * 3 // s,
           "single": torch.ones_like(pos)}[kind]
    return ids[None].repeat(b, 1).contiguous()


def _flash_case(torch, dtype, b, s, d, seg_kind, seed=0, q_scale=None,
                hmap=None):
    """qwen2.5-0.5b's head map (16 q heads, 7 on kv head 0, 9 on kv head
    1: the two padded ones clamp onto the last), or ``hmap`` (a list, one
    kv head a q head: ``WIDE_HMAPS``); N(0, 1) k, v and do; in
    bf16 q = 3 N(0, 1), a peaked softmax whose outputs stay large beside
    the 2e-2 tolerance, in f32 q = N(0, 1) unless ``q_scale`` says
    otherwise (the peaked f32 case is held against f64: ``_flash_f64``).
    ``seg_kind``: the segment ids' ``_segment_ids`` kind, or None."""
    if hmap is None:
        hmap = [min(i // 7, 1) for i in range(16)]
    h, kvh = len(hmap), max(hmap) + 1
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)

    def rnd(*shape, scale=1.0):
        return (scale * torch.randn(*shape, generator=g,
                                    device="cuda")).to(dt)
    if q_scale is None:
        q_scale = 3.0 if dtype == "bfloat16" else 1.0
    q = rnd(b, s, h, d, scale=q_scale)
    k, v, do = rnd(b, s, kvh, d), rnd(b, s, kvh, d), rnd(b, s, h, d)
    hmap = torch.tensor(hmap, dtype=torch.int32, device="cuda")
    return q, k, v, do, hmap, _segment_ids(torch, seg_kind, b, s)


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


def _flash_tiles(torch, seg, tile=64) -> tuple:
    """(causal tiles that hold an attending pair, causal tiles): the
    (q tile, k tile <= q tile) pairs of 64 x 64 positions, summed over the
    rows, that the kernels visit against all that a causal kernel would
    (the same for every head)."""
    b, s = seg.shape
    n = -(-s // tile)
    pos = torch.arange(n * tile, device="cuda")
    ids = torch.full((b, n * tile), -1, dtype=seg.dtype, device="cuda")
    ids[:, :s] = seg
    ok = ((pos[:, None] >= pos[None, :]) & (pos[:, None] < s))[None] & (
        ids[:, :, None] == ids[:, None, :])
    work = ok.view(b, n, tile, n, tile).any(dim=4).any(dim=2)
    return int(work.sum().item()), b * n * (n + 1) // 2


def _flash_single_segment(torch, ops, b, s, d) -> None:
    """One segment over each whole row gives the bits of no segments: o,
    lse, dq, dk and dv, bf16 and f32."""
    for dtype in ("bfloat16", "float32"):
        q, k, v, do, hm, _ = _flash_case(torch, dtype, b, s, d, None)
        outs = []
        for kind in (None, "single"):
            seg = _segment_ids(torch, kind, b, s)
            o, lse = ops.flash_attention_fwd(q, k, v, hm, segment_ids=seg)
            outs.append((o, lse, *ops.flash_attention_bwd(
                q, k, v, o, lse, do, hm, segment_ids=seg)))
        torch.cuda.synchronize()
        for name, a, c in zip(("o", "lse", "dq", "dk", "dv"), *outs):
            check(_bits_equal(torch, a, c), f"flash {dtype}: one segment "
                  f"over the row changes {name} from the causal result")
    print(f"  flash one segment  B={b} S={s} D={d} causal: o, lse, dq, dk, "
          f"dv bit-identical to no segments, bf16 and f32")


def _flash_dkv_splits(torch, ref, _fa, timer) -> None:
    """The bf16 dk/dv kernel at every split of a kv head's q work (1: dk, dv
    stored from the registers; 2-4: f32 partials and the sum kernel): each
    against the plain version and bit-identical over two launches, then
    timed at the training shapes and a large one, beside the split that
    ``dkv_splits`` picks."""
    def run(q, k, v, do, hm, seg, causal, n_split):
        o, lse = torch.empty_like(q), torch.empty(
            q.shape[0], q.shape[2], q.shape[1], device="cuda")
        _fa.launch_fwd(q, k, v, seg, hm, causal, o, lse)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2).contiguous()
        dk, dv = torch.empty_like(k), torch.empty_like(v)

        def launch():
            _fa.launch_bwd_dkv(q, k, v, do, lse, delta, seg, hm, causal, dk,
                               dv, n_split=n_split)
        return o, lse, dk, dv, launch

    for label, b, s, d, seg_kind, causal in (
            ("ragged S=300", 2, 300, 64, "packed", True),
            ("D=128 nc", 2, 512, 128, "packed", False)):
        q, k, v, do, hm, seg = _flash_case(torch, "bfloat16", b, s, d,
                                           seg_kind)
        errs = []
        for n_split in (1, 2, 3, 4):
            o, lse, dk, dv, launch = run(q, k, v, do, hm, seg, causal,
                                         n_split)
            launch()
            dk1, dv1 = dk.clone(), dv.clone()
            launch()
            torch.cuda.synchronize()
            check(_bits_equal(torch, dk, dk1) and _bits_equal(torch, dv, dv1),
                  f"flash dk/dv {label} split {n_split}: two launches differ")
            _, pk, pv = ref.flash_attention_bwd(q, k, v, o, lse, do, hm, seg,
                                                causal)
            errs.append(max(_check_close(torch, dk, pk, "bfloat16",
                                         f"flash {label} dk split {n_split}"),
                            _check_close(torch, dv, pv, "bfloat16",
                                         f"flash {label} dv split {n_split}")))
        print(f"  flash dk/dv {label:<12} bfloat16 split 1/2/3/4: max |err| "
              + "/".join(f"{e:.2e}" for e in errs) + f" (rtol=atol "
              f"{TOL['bfloat16']:.0e}); each bit-identical over two launches")
    print("  flash dk/dv bf16 by split (CUDA events, L2 flushed, ms per call;"
          " * = dkv_splits' pick):")
    for label, b, s, seg_kind in (("train causal", 8, 512, None),
                                  ("train packed", 8, 512, "packed"),
                                  ("large causal", 16, 2048, None)):
        q, k, v, do, hm, seg = _flash_case(torch, "bfloat16", b, s, 64,
                                           seg_kind)
        pick = _fa.dkv_splits(q.dtype, 16, 2)
        ms = [timer.ms(run(q, k, v, do, hm, seg, True, n)[-1], reps=10)
              for n in (1, 2, 3, 4)]
        print(f"    {label:<12} B={b} S={s} H=16 KVH=2 D=64, "
              f"{-(-s // 64) * b * 2} (k tile, kv head) pairs: " + "  ".join(
                  f"{n}{'*' if n == pick else ' '} {t:.4f}"
                  for n, t in zip((1, 2, 3, 4), ms)))
        del q, k, v, do


def phase_flash_kernels(torch, ops, ref, _fa, timer) -> dict:
    """Rows 4-6 against their plain versions; returns the summary entries
    at the packed training shape (bf16)."""
    F = torch.nn.functional
    cases = [("train causal", 8, 512, 64, None, True),
             ("train packed", 8, 512, 64, "packed", True),
             ("ragged S=300", 2, 300, 64, "packed", True),
             ("S=17", 2, 17, 64, "thirds", True),
             ("S=1000", 2, 1000, 64, "packed", True),
             ("tile edges", 2, 512, 64, "edges", True),
             ("D=128", 2, 512, 128, "packed", True),
             ("D=128 nc", 2, 512, 128, "packed", False),
             ("non-causal", 2, 512, 64, "packed", False),
             # the training shape at llama3.2-1b's and phi4-mini's heads
             ("llama causal", 8, 512, 64, None, True),
             ("llama packed", 8, 512, 64, "packed", True),
             ("phi4 causal", 8, 512, 128, None, True),
             ("phi4 packed", 8, 512, 128, "packed", True)]
    heads = {"llama": WIDE_HMAPS[64], "phi4": WIDE_HMAPS[128]}
    timed = ("train", "llama", "phi4")
    work, causal_tiles = _flash_tiles(
        torch, _segment_ids(torch, "packed", 8, 512))
    print(f"  packed training shape (B 8, S 512): {work} of the "
          f"{causal_tiles} causal 64 x 64 tiles of the rows hold an "
          f"attending pair ({work / causal_tiles:.3f}; the same for every "
          f"head): the bf16 forward, dq and dk/dv visit only those")
    rows, main = [], {}
    for dtype in ("bfloat16", "float32"):
        for label, b, s, d, seg_kind, causal in cases:
            q, k, v, do, hm, seg = _flash_case(
                torch, dtype, b, s, d, seg_kind,
                hmap=heads.get(label.split()[0]))
            mode = dict(causal=causal, segment_ids=seg)
            n0 = dict(ops.LAUNCHES)
            o, lse = ops.flash_attention_fwd(q, k, v, hm, **mode)
            dq, dk, dv = ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                                 **mode)
            dq2, dk2, dv2 = ops.flash_attention_bwd(q, k, v, o, lse, do, hm,
                                                    **mode)
            torch.cuda.synchronize()
            check(all(ops.LAUNCHES[n] - n0[n] == w for n, w in (
                ("flash_attention_fwd", 1), ("flash_attention_bwd_dq", 2),
                ("flash_attention_bwd_dkv", 2))),
                "the flash wrappers did not count their launches")
            check(_bits_equal(torch, dk, dk2) and _bits_equal(torch, dv, dv2),
                  f"flash {label} {dtype}: dk/dv differ between two launches")
            check(_bits_equal(torch, dq, dq2),
                  f"flash {label} {dtype}: dq differs between two launches")
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
            if label.startswith(timed):
                rows += _flash_times(torch, F, ref, _fa, timer, dtype, label,
                                     q, k, v, do, o, lse, hm, seg, errs)
                if label == "train packed" and dtype == "bfloat16":
                    main.update({r["kernel"]: r for r in rows[-3:]})
            print(f"  flash {label:<13} {dtype:<9} B={b} S={s} "
                  f"H={q.shape[2]} KVH={k.shape[2]} "
                  f"D={d}{f' segmented ({seg_kind})' if seg_kind else ''}"
                  f"{' causal' if causal else ' non-causal'}: max "
                  f"|err| " + ", ".join(f"{n} {e:.2e}"
                                        for n, e in errs.items())
                  + f" (rtol=atol {TOL[dtype]:.0e}); dq, dk, dv "
                  f"bit-identical over two launches")
            del q, k, v, do, o, lse, dq, dk, dv, dq2, dk2, dv2, po, pq, pk, pv
    _flash_single_segment(torch, ops, 8, 512, 64)
    _flash_dkv_splits(torch, ref, _fa, timer)
    for label, b, s, d in (("train packed", 8, 512, 64), ("D=128", 2, 512,
                                                          128)):
        _flash_f64(torch, ops, ref, label, b, s, d)
    print("flash kernels at the training shape (CUDA events, L2 flushed, ms "
          "per call):")
    for r in rows:
        print(f"  {r['kernel']:<24} {r['case']:<13} {r['dtype']:<9} "
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
    q, k, v, do, hm, seg = _flash_case(torch, "float32", b, s, d, "packed",
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
        out_l, (qg, kg, vg), dol, retain_graph=True), reps=10,
        spin=LONG_SPIN_CYCLES)
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
        out.append(dict(kernel=kernel, case=label, dtype=dtype,
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
    want = _train_launches(nl)
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


# ------------------------------------------------------- dense decode


def _decode_case(torch, dtype, b, s, vlens, d=64, seed=0, h=16, kvh=2,
                 hmap=None):
    """One layer's dense cache [B, S, KVH, D] and q [B, 1, H, D] through
    ``hmap``, by default qwen2.5-0.5b's (7 q heads on kv head 0, 9 on kv
    head 1: the two padded ones clamp onto the last); q = 3 N(0, 1) against
    N(0, 1) keys and values: a peaked softmax whose outputs stay large
    beside the tolerance."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    dt = getattr(torch, dtype)
    q = (3 * torch.randn(b, 1, h, d, generator=g, device="cuda")).to(dt)
    k = torch.randn(b, s, kvh, d, generator=g, device="cuda").to(dt)
    v = torch.randn(b, s, kvh, d, generator=g, device="cuda").to(dt)
    vl = torch.tensor(vlens, dtype=torch.int32, device="cuda")
    if hmap is None:
        hmap = [min(i // 7, kvh - 1) for i in range(h)]
    hmap = torch.tensor(hmap, dtype=torch.int32, device="cuda")
    return q, k, v, vl, hmap


def phase_decode_kernel(torch, ops, ref, _dec, timer) -> dict:
    """Row 3 against its plain version; returns the summary entry at the
    eval shape (bf16)."""
    cases = [("eval", 16, 512, 64, DECODE_EVAL_VL),
             ("S=512", 2, 512, 64, (100, 100)),
             ("S=1024", 2, 1024, 64, (1024, 1024)),
             ("S=2048", 2, 2048, 64, (7, 7)),
             ("vec S=512", 3, 512, 64, (1, 100, 512)),
             ("vec S=1024", 3, 1024, 64, (7, 1024, 333)),
             ("S=1", 2, 1, 64, (1, 1)),
             ("S=300", 2, 300, 64, (1, 300)),
             ("D=128", 2, 512, 128, (100, 512))]
    rows, main = [], {}
    print("dense decode attention (row 3) vs its plain version, 16 q heads "
          "on 2 kv heads (qwen2.5-0.5b map), q = 3 N(0, 1):")
    for dtype in ("bfloat16", "float32"):
        for label, b, s, d, vlens in cases:
            q, k, v, vl, hm = _decode_case(torch, dtype, b, s, vlens, d)
            n0 = ops.LAUNCHES["decode_attention"]
            out = ops.decode_attention(q, k, v, vl, hm)
            again = ops.decode_attention(q, k, v, vl, hm)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["decode_attention"] == n0 + 2,
                  "decode_attention did not count its launches")
            check(out.shape == q.shape and out.dtype == q.dtype,
                  f"decode_attention {label}: {tuple(out.shape)} "
                  f"{out.dtype}")
            check(_bits_equal(torch, out, again),
                  f"decode_attention {label} {dtype}: two launches differ")
            plain = ref.decode_attention_cache(q[:, 0], k, v, vl, hm)
            err = _check_close(torch, out[:, 0], plain, dtype,
                               f"decode_attention {label}")
            print(f"  {label:<11} {dtype:<9} B={b} S={s} D={d} valid_len "
                  f"{list(vlens[:4])}{'...' if len(vlens) > 4 else ''}: max "
                  f"|err| {err:.2e} (rtol=atol {TOL[dtype]:.0e}); "
                  f"bit-identical over two launches")
            if label == "eval":
                rows.append(_decode_times(torch, ops, ref, timer, dtype,
                                          q, k, v, vl, hm, err))
                if dtype == "bfloat16":
                    main["decode_attention"] = rows[-1]
            del q, k, v, out, again, plain
    for label, b, s, d, vlens in (cases[0], cases[-1]):
        _decode_f64(torch, ops, ref, label, b, s, d, vlens)
    for dtype in ("bfloat16", "float32"):
        _decode_vs_paged(torch, ops, dtype)
    _decode_splits(torch, ref, _dec, timer)
    print("dense decode at the eval shape (CUDA events, L2 flushed, ms per "
          "call):")
    for r in rows:
        print(f"  {r['kernel']:<17} {r['dtype']:<9} err "
              f"{r['max_abs_err']:.2e}  kernel {r['ms']:.4f}  plain "
              f"{r['plain_ms']:.4f}  library {r['library_ms']:.4f}  bound "
              f"{r['bound_ms']:.5f} ({r['bound_by']})  {r['shape']}")
    print("  library: F.scaled_dot_product_attention(enable_gqa=True) on "
          "[B, H, 1, D] and [B, KVH, S, D] with a boolean [B, 1, 1, S] "
          "valid-length mask (its GQA map is h // 8, which moves no work; "
          "timed only)")
    return main


def _decode_splits(torch, ref, _dec, timer) -> None:
    """Row 3 forced to every split of a row's positions (1 .. MAX_SPLIT
    chunks, one block each): at the eval shape and at S 300 (no chunk
    length divides it) with valid_len 0, 1, 150 and 300 and two q heads
    outside the head map, so that chunks lie wholly past valid_len or S.
    Each against the plain version on the mapped heads of the rows with
    valid_len >= 1, zeros elsewhere, and bit-identical over two launches;
    then timed at the eval shape and at longer caches, bf16 and f32,
    beside ``decode_splits``' pick."""
    splits = range(1, _dec.MAX_SPLIT + 1)
    for label, b, s, vlens, bad in (("eval", 16, 512, DECODE_EVAL_VL, False),
                                    ("S=300", 4, 300, (0, 1, 150, 300),
                                     True)):
        for dtype in ("bfloat16", "float32"):
            q, k, v, vl, hm = _decode_case(torch, dtype, b, s, vlens)
            hmap = hm.clone()
            if bad:
                hmap[3], hmap[12] = 2, -1
            keep = [h for h in range(16) if not (bad and h in (3, 12))]
            rows = [i for i, n in enumerate(vlens) if n > 0]
            plain = ref.decode_attention_cache(q[rows, 0][:, keep], k[rows],
                                               v[rows], vl[rows], hm[keep])
            errs = []
            for n in splits:
                outs = []
                for _ in range(2):
                    out = torch.full((b, 16, 64), float("nan"),
                                     dtype=q.dtype, device="cuda")
                    _dec.launch(q.view(b, 16, 64), k, v, vl, hmap, out,
                                n_split=n)
                    outs.append(out)
                torch.cuda.synchronize()
                check(_bits_equal(torch, outs[0], outs[1]),
                      f"decode {label} {dtype} split {n}: two launches "
                      f"differ")
                out = outs[0]
                zero = torch.ones(b, 16, dtype=torch.bool, device="cuda")
                zero[torch.tensor(rows, device="cuda")[:, None],
                     torch.tensor(keep, device="cuda")[None, :]] = False
                check(bool((out[zero] == 0).all()), f"decode {label} "
                      f"{dtype} split {n}: rows with valid_len 0 or heads "
                      f"outside the map are not zeros")
                errs.append(_check_close(torch, out[rows][:, keep], plain,
                                         dtype, f"decode {label} split {n}"))
            extra = " + 2 heads outside the map" if bad else ""
            print(f"  row 3 {label:<6} {dtype:<9} B={b} S={s} valid_len "
                  f"{list(vlens[:4])}{extra}, every split 1-{len(splits)}: "
                  f"max |err| "
                  f"{max(errs):.2e} (worst at split "
                  f"{1 + errs.index(max(errs))}; rtol=atol "
                  f"{TOL[dtype]:.0e}); each bit-identical over two launches")
    print("  row 3 by split, 16 q / 2 kv heads, D 64 (CUDA events, L2 "
          "flushed, ms per call; * = decode_splits' pick):")
    for dtype, label, b, s, vlens in (
            ("bfloat16", "eval", 16, 512, DECODE_EVAL_VL),
            ("bfloat16", "full", 16, 512, (512,) * 16),
            ("bfloat16", "full", 4, 512, (512,) * 4),
            ("bfloat16", "long", 16, 2048, (2048,) * 16),
            ("bfloat16", "long", 4, 2048, (2048,) * 4),
            ("bfloat16", "longer", 1, 8192, (8192,)),
            ("float32", "eval", 16, 512, DECODE_EVAL_VL),
            ("float32", "long", 16, 2048, (2048,) * 16)):
        q, k, v, vl, hm = _decode_case(torch, dtype, b, s, vlens)
        out = torch.empty(b, 16, 64, dtype=q.dtype, device="cuda")
        pick = _dec.decode_splits(q.dtype, s)
        ms = {n: timer.ms(lambda n=n: _dec.launch(q.view(b, 16, 64), k, v,
                                                  vl, hm, out, n_split=n),
                          reps=10)
              for n in sorted({1, 2, 4, 8, 16, 32, pick})}
        print(f"    {dtype:<8} {label:<6} B={b:<2} S={s:<4} valid_len "
              f"{list(vlens[:4])}: " + "  ".join(
                  f"{n}{'*' if n == pick else ''} {t:.4f}"
                  for n, t in ms.items()))
        del q, k, v


def _decode_times(torch, ops, ref, timer, dtype, q, k, v, vl, hm,
                  err) -> dict:
    F = torch.nn.functional
    b, _, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    es = q.element_size()
    kv_pos = sum(min(x, s) for x in vl.tolist())
    # the valid K/V rows, q and o, the lengths and the map
    nbytes = 2 * kv_pos * kvh * d * es + 2 * b * h * d * es + 4 * (b + h)
    bms, by = bound_ms(nbytes, 4 * kv_pos * h * d, dtype)
    ql = q.transpose(1, 2).contiguous()               # [B, H, 1, D]
    kl, vl_ = (t.transpose(1, 2).contiguous() for t in (k, v))
    mask = (torch.arange(s, device="cuda")[None, :]
            < vl[:, None])[:, None, None, :]          # [B, 1, 1, S]
    return dict(
        kernel="decode_attention", case="eval", dtype=dtype,
        shape=f"B={b} S={s} H={h} KVH={kvh} D={d}, {kv_pos} valid "
        f"positions", max_abs_err=err, tol=TOL[dtype],
        ms=timer.ms(lambda: ops.decode_attention(q, k, v, vl, hm)),
        plain_ms=timer.ms(lambda: ref.decode_attention_cache(q[:, 0], k, v,
                                                             vl, hm)),
        library_ms=timer.ms(lambda: F.scaled_dot_product_attention(
            ql, kl, vl_, attn_mask=mask, enable_gqa=True)),
        bound_ms=bms, bound_by=by)


def _decode_f64(torch, ops, ref, label, b, s, d, vlens) -> None:
    """f32 at q = 3 N(0, 1): the kernel's output and the plain f32
    version's against the plain version in f64 on the same inputs, each as
    max |err| / (tol + tol |f64|) (at most 1 is within the f32 tolerance).
    Fails unless the kernel is within the tolerance of f64 or no further
    from it than the plain f32 version."""
    q, k, v, vl, hm = _decode_case(torch, "float32", b, s, vlens, d, seed=1)
    got = ops.decode_attention(q, k, v, vl, hm)[:, 0]
    plain = ref.decode_attention_cache(q[:, 0], k, v, vl, hm)
    exact = ref.decode_attention_cache(q[:, 0].double(), k.double(),
                                       v.double(), vl, hm)
    check(exact.dtype == torch.float64, f"decode f64: {exact.dtype}")
    tol = TOL["float32"]
    ek, ep = ((t.double() - exact).abs().div(tol + tol * exact.abs()).max()
              .item() for t in (got, plain))
    print(f"  {label:<11} f32 B={b} S={s} D={d}: max |err| / (tol + tol "
          f"|f64|) against the f64 plain version, kernel {ek:.3g}, plain "
          f"f32 {ep:.3g} (kernel must be <= max(1, plain))")
    check(ek <= max(1.0, ep), f"decode {label} f32 peaked: the kernel is "
          f"further from f64 ({ek:.3g}) than the plain version ({ep:.3g}) "
          f"and than the tolerance")


def _decode_vs_paged(torch, ops, dtype) -> None:
    """Row 3 on the dense view gathered from a pool through its page
    tables gives the bits of row 1 on the pool (one body, the same split;
    tests/test_kernels.py::test_matches_dense_kernel_on_gathered_view holds
    them within 2e-5 in f32): at the serving shape and at 32 x 2048."""
    for b, vlens, maxp in ((4, [1, 17, 300, 512], 32),
                           (32, [2048] * 31 + [1000], 128)):
        q, kp, vp, tbl, vl, hm = _paged_inputs(torch, dtype, b, vlens,
                                               maxp=maxp)
        paged = ops.paged_decode_attention(q, kp, vp, tbl, vl, hm)
        rows = tbl.long().clamp(max=kp.shape[0] - 1)
        kd, vd = (p[rows].reshape(b, -1, *p.shape[2:]).contiguous()
                  for p in (kp, vp))
        dense = ops.decode_attention(q, kd, vd, vl, hm)
        torch.cuda.synchronize()
        diff = (dense.float() - paged.float()).abs().max().item()
        print(f"  row 3 on the gathered view vs row 1 on the pool, {dtype}, "
              f"B={b} page 16, valid_len {vlens[:4]}: bit-equal "
              f"{_bits_equal(torch, dense, paged)} (max |diff| {diff:.2e})")
        check(_bits_equal(torch, dense, paged), f"row 3 and row 1 differ on "
              f"one pool ({dtype}, B={b}): max |diff| {diff}")
        del q, kp, vp, kd, vd


# ------------------------------------------------------------ greedy eval


def phase_eval(torch, ops, cfg, evaluate, training) -> dict:
    """The paper's greedy eval on phase 7's trained params."""
    import numpy as np

    from repro_torch.data import synthetic
    t_phase = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    params = _to(training["eval_params"], "cuda")
    task = training["task"]
    nl = cfg.num_layers
    max_new = task.seq_len - synthetic.prompt_len(task)
    print(f"greedy eval of {cfg.name} ({cfg.dtype}) after its "
          f"adagradselect run: {EVAL['num_problems']} held-out problems of "
          f"the task it trained on ({task}), chunks of {EVAL['batch_size']} "
          f"slots on the dense KV layout, up to {max_new} new tokens each")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # the main path's run
    t0 = time.perf_counter()
    run = evaluate.greedy_eval(params, cfg, task, **EVAL, device="cuda")
    torch.cuda.synchronize()
    secs = [time.perf_counter() - t0]
    launches = dict(ops.LAUNCHES)
    again, sec, prof, wall = _eval_profiled(torch, evaluate, params, cfg,
                                            task)
    secs.append(sec)
    st = run.stats
    steps = st["decode_chunks"] * SERVE["decode_chunk"]
    _check_launches(launches, cfg, st, "dense")
    check(len(run.tokens) == EVAL["num_problems"]
          and all(1 <= len(t) <= max_new and (t >= 0).all()
                  and (t < cfg.vocab_size).all() for t in run.tokens),
          f"generated lengths {[len(t) for t in run.tokens]}")
    check(0.0 <= run.accuracy <= 1.0, f"accuracy {run.accuracy}")
    same = [bool(np.array_equal(a, b)) for a, b in zip(run.tokens,
                                                          again.tokens)]
    check(again.accuracy == run.accuracy and all(same),
          f"a second eval call differs: accuracy {again.accuracy} vs "
          f"{run.accuracy}, tokens equal per problem {same}")
    check(max(secs) <= EVAL_CALL_S, f"an eval call took {max(secs):.1f} s "
          f"(limit {EVAL_CALL_S} s)")
    gen = sum(len(t) for t in run.tokens)
    answered = sum(p is not None for p in run.predictions)
    print(f"  accuracy {run.accuracy} ({answered} of {len(run.tokens)} "
          f"generations carry an answer; problem 0 asks "
          f"{run.answers[0]} and begins {run.tokens[0][:12].tolist()}); "
          f"{gen} tokens generated in "
          f"{secs[0]:.3f} s = {gen / secs[0]:.1f} tok/s (prefill included); "
          f"{steps} decode steps in {st['decode_chunks']} chunks, "
          f"{st['prefills']} prefills")
    print(f"  kernel launches in that run: {json.dumps(launches)} (row 3 = "
          f"{nl} layers x {steps} decode steps; no plain decode attention)")
    print(f"  peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    print(f"  second call: same accuracy and the same tokens for all "
          f"{len(run.tokens)} problems, {secs[1]:.3f} s = "
          f"{gen / secs[1]:.1f} tok/s (engine steps {EVAL_PROFILE[0]} to "
          f"{sum(EVAL_PROFILE) - 1} under the profiler)")
    t0 = time.perf_counter()
    _print_eval_profile(prof, wall)
    print(f"  phase time {time.perf_counter() - t_phase:.1f} s (the eval "
          f"calls {secs[0]:.1f} + {secs[1]:.1f} s, reading the profile "
          f"{time.perf_counter() - t0:.1f} s)")
    return {"launches": launches, "accuracy": run.accuracy,
            "tok_s": gen / secs[0]}


def _eval_profiled(torch, evaluate, params, cfg, task):
    """The second eval call, with engine steps EVAL_PROFILE[0] onwards
    (EVAL_PROFILE[1] decode chunks of the first 16 problems) under the
    profiler, which records the device's activity only (the host's ops
    would take it longer to process than the run takes). Returns the run,
    its seconds, the profiler and the wall time of the profiled steps."""
    from torch.profiler import ProfilerActivity
    return _profiled_steps(
        torch, evaluate.ServeEngine, EVAL_PROFILE, [ProfilerActivity.CUDA],
        lambda: evaluate.greedy_eval(params, cfg, task, **EVAL,
                                     device="cuda"))


def _profiled_steps(torch, engine, steps, activities, run):
    """``run()`` with engine steps ``steps[0]`` .. ``steps[0] + steps[1] -
    1`` of its ``ServeEngine`` (``engine``, whose ``step`` is wrapped for
    this call only) under the profiler. Returns what ``run`` returned, its
    seconds, the profiler and the wall time of the profiled steps."""
    from torch.profiler import profile
    plain_step = engine.step
    skip, n = steps
    prof = profile(activities=activities)
    seen = {"steps": 0}

    def step(self):
        i = seen["steps"]
        seen["steps"] += 1
        if i == skip:
            torch.cuda.synchronize()
            prof.start()
            seen["t0"] = time.perf_counter()
        out = plain_step(self)
        if i == skip + n - 1:
            torch.cuda.synchronize()
            seen["wall"] = time.perf_counter() - seen["t0"]
            prof.stop()
        return out
    engine.step = step
    try:
        t0 = time.perf_counter()
        out = run()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
    finally:
        engine.step = plain_step
    check("wall" in seen, f"the run took {seen['steps']} engine steps, "
          f"fewer than the {skip + n} the profile needs")
    return out, sec, prof, seen["wall"]


def _print_eval_profile(prof, wall) -> None:
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    if not events:
        print("  profile: the profiler saw no device time (not measured)")
        return
    busy_us = sum(e.device_time_total for e in events)
    dec = sum(e.device_time_total for e in events
              if "decode_kernel" in e.key and "PagedRows" not in e.key) / 1e3
    print(f"  profile ({EVAL_PROFILE[1]} engine steps of the second call, "
          f"{EVAL_PROFILE[1] * SERVE['decode_chunk']} decode steps at "
          f"{EVAL['batch_size']} slots, profiler on): wall "
          f"{wall * 1e3:.1f} ms, device kernels {busy_us / 1e3:.1f} ms in "
          f"{sum(e.count for e in events)} launches, device idle share "
          f"{max(0.0, 1 - busy_us / 1e6 / wall):.3f}; row 3 {dec:.3f} ms = "
          f"{dec / (busy_us / 1e3):.3f} of device time")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")


# ------------------------------------------------- gated weight gradients


def _gated_expected(masks, nl, start, adamw, leaves=12) -> dict:
    """The launches reckoned from each step's mask: ``_train_launches``
    with that step's selected layers (``start``: the first layer's block
    id), summed over the steps."""
    total: dict = {}
    for m in masks:
        sel = int(m[start:start + nl].sum())
        for k, v in _train_launches(nl, adamw, sel, leaves).items():
            total[k] = total.get(k, 0) + v
    return total


def _check_gated_grads(torch, tr, layers, fn_name) -> str:
    """One more step with ``masked_adamw.<fn_name>`` wrapped to see the
    gradients it is given: every leaf of a frozen layer all zero, every
    selected layer's leaves nonzero somewhere, the embedding's too."""
    from repro_torch.core import masked_adamw
    seen = {}
    inner = getattr(masked_adamw, fn_name)

    def spy(opt_cfg, partition, params, grads, *rest):
        seen["grads"] = grads
        return inner(opt_cfg, partition, params, grads, *rest)
    setattr(masked_adamw, fn_name, spy)
    try:
        tr.train(1)
    finally:
        setattr(masked_adamw, fn_name, inner)
    mask = tr.state["sel"]["mask"][layers.start:layers.start
                                   + layers.length]
    grads = seen["grads"]
    frozen = int((~mask).sum())
    for name, leaf in _named_leaves(grads["layers"]):
        flat = leaf.reshape(leaf.shape[0], -1)
        check(not bool(flat[~mask].any()),
              f"gated step: frozen rows of the gradient of {name} are not "
              f"all zero")
        if mask.any():
            check(bool(flat[mask].any(dim=1).all()),
                  f"gated step: a selected layer's gradient of {name} is "
                  f"all zero")
    check(bool(grads["embed"]["tok"].any()),
          "gated step: the embedding's gradient is all zero")
    del seen
    return (f"{frozen} frozen layers' gradient rows all zero in every leaf, "
            f"{layers.length - frozen} selected layers' nonzero")


def _named_leaves(tree, prefix=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _named_leaves(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}", v


def phase_gated_training(torch, ops, cfg, Trainer, dense, banked) -> dict:
    """Phase 7's run and phase 10's async banked run with the gate."""
    from repro_torch.core import partition as part_mod
    gcfg = cfg.replace(gate_weight_grads=True)
    steps, warm = TRAIN["steps"], TRAIN["warmup"]
    gb, sl = TRAIN["global_batch"], TRAIN["seq_len"]
    nl = cfg.num_layers
    pn = part_mod.build_partition(cfg)
    layers = next(g for g in pn.groups if g.key == "layers")
    out = {"launches": {}}
    for label, opt, adamw, ref_run in (
            ("dense", {}, "masked_adamw", dense),
            ("banked", dict(moment_residency="banked", offload="host",
                            async_swap=True), "banked_masked_adamw",
             banked)):
        gc.collect()
        torch.cuda.empty_cache()
        tcfg = _train_cfg(gcfg, "adagradselect", steps, gb, sl,
                          log_every=1 if label == "dense" else steps + 1,
                          **opt)
        tr = Trainer(tcfg, device="cuda")
        k = tr.sel_cfg.num_selected(pn.num_blocks)
        masks = _record_masks(tr)
        torch.cuda.reset_peak_memory_stats()
        tr.train(warm)
        ops.reset_launches()                     # the main path's run
        tr.train(steps - warm)
        launches = dict(ops.LAUNCHES)
        peak = torch.cuda.max_memory_allocated()
        log = tr.log
        check(len(log.losses) == steps
              and all(math.isfinite(x) for x in log.losses),
              f"gated {label}: losses {log.losses}")
        host_masks = [m.cpu() for m in masks]
        check(all(int(m.sum()) == k for m in host_masks),
              f"gated {label}: selected per step "
              f"{[int(m.sum()) for m in host_masks]}, want {k}")
        want = _gated_expected(host_masks[warm:], nl, layers.start, adamw)
        check(launches == want, f"gated {label}: launches {launches} != "
              f"the counts reckoned from the masks {want}")
        counts = tr.state["opt"]["counts"].cpu()
        mask_sum = torch.stack(host_masks).float().sum(dim=0)
        check(torch.equal(counts, mask_sum),
              f"gated {label}: opt counts {counts.tolist()} != summed masks "
              f"{mask_sum.tolist()}")
        frozen = [nl - int(m[layers.start:layers.start + nl].sum())
                  for m in host_masks[warm:]]
        n = steps - warm
        if label == "dense":
            times = log.step_times[warm:]
            step_ms = statistics.median(times) * 1e3
            how = f"median of steps {warm}..{steps - 1}"
        else:
            step_ms = log.step_times[-1] * 1e3
            how = f"mean of the {n}-step window"
        print(f"gated training ({label}) {cfg.name}: adagradselect, "
              f"gate_weight_grads, k = {k} of {pn.num_blocks} blocks, batch "
              f"{gb} x {sl}, {steps} steps")
        print(f"  losses: {[round(x, 4) for x in log.losses]}")
        print(f"  step time ({how}): {step_ms:.2f} ms = "
              f"{gb * sl / step_ms * 1e3:.0f} tokens/s (ungated: "
              f"{ref_run['step_ms']:.2f} ms)")
        print(f"  peak device memory: {peak / 2**30:.2f} GiB (ungated: "
              f"{ref_run['peak'] / 2**30:.2f} GiB)")
        print(f"  frozen layers per step: {frozen}; counts = summed masks "
              f"{counts.int().tolist()}")
        print(f"  launches in the {n} steps = the counts reckoned from the "
              f"masks: {json.dumps(launches)}")
        if label == "banked":
            print(f"  swap stats: "
                  f"{json.dumps(tr.step_fn.swap_stats.as_dict())}")
        update = "update" if label == "dense" else "banked_update"
        said = _check_gated_grads(torch, tr, layers, update)
        print(f"  one more step: {said}")
        prof = _profile_training(torch, tr) if label == "dense" else {}
        for name, c in launches.items():
            out["launches"][name] = out["launches"].get(name, 0) + c
        out[label] = {"step_ms": step_ms, "peak": peak, "profile": prof}
        del tr, masks, host_masks
    return out


def phase_gated_rounds(torch, ops, cfg, Trainer, rounds=2) -> dict:
    """Gated adagradselect, ungated adagradselect and full fine-tuning in
    alternating rounds of 8-step windows (one sync at each window's end),
    then 2 profiled steps of each."""
    gc.collect()
    torch.cuda.empty_cache()
    steps, n = TRAIN["steps"], TRAIN["steps"] - TRAIN["warmup"]
    gb, sl = TRAIN["global_batch"], TRAIN["seq_len"]
    kinds = {"gated": (cfg.replace(gate_weight_grads=True), "adagradselect"),
             "ungated": (cfg, "adagradselect"), "full": (cfg, "full")}
    trs = {name: Trainer(_train_cfg(mcfg, method, steps * (rounds + 1), gb,
                                    sl, log_every=10 ** 6), device="cuda")
           for name, (mcfg, method) in kinds.items()}
    for tr in trs.values():
        tr.train(TRAIN["warmup"])
    times = {name: [] for name in kinds}
    ours = {}
    for _ in range(rounds):
        for name, tr in trs.items():
            ops.reset_launches()
            tr.train(n)
            ours[name] = {k: v / n for k, v in ops.LAUNCHES.items() if v}
            times[name].append(tr.log.step_times[-1] * 1e3)
    med = {name: statistics.median(ts) for name, ts in times.items()}
    print(f"step time in {rounds} alternating rounds of {n}-step windows "
          f"(ms), {cfg.name}, batch {gb} x {sl}: " + ", ".join(
              f"{name} {[round(t, 2) for t in ts]} (median {med[name]:.2f})"
              for name, ts in times.items()))
    prof = {}
    for name, tr in trs.items():
        print(f"  {name}: the port's kernels a step {json.dumps(ours[name])}")
        prof[name] = _profile_training(torch, tr, top=5)
    if all(prof.values()):
        print("  a step (2 profiled steps each): " + ", ".join(
            f"{name} device {p['device_ms'] / 2:.1f} ms in "
            f"{p['launches'] / 2:.0f} launches ({p['matmul_launches'] / 2:.0f}"
            f" matrix products), idle {p['idle']:.3f}"
            for name, p in prof.items()))
    print(f"  gated / full median step: {med['gated'] / med['full']:.3f}; "
          f"gated / ungated: {med['gated'] / med['ungated']:.3f}; ungated / "
          f"full: {med['ungated'] / med['full']:.3f}")
    del trs
    return {"median_ms": med, "profile": prof}


def phase_gated_consistency(torch, ops, cfg, Trainer) -> None:
    """f32, TF32 off, 2 layers at full width, batch 2 x 64, 3 steps: gated
    topk_grad on the card against the CPU from one state; gated full
    against ungated full on the card, bit for bit."""
    steps, lr = 3, 1e-3
    c32 = cfg.replace(dtype="float32", num_layers=2)
    g32 = c32.replace(gate_weight_grads=True)
    opt = dict(lr=lr, schedule="constant", warmup_steps=0)
    # k = 2 of 4 blocks: the gate's zero norms tie, so topk_grad takes the
    # embedding and layer 0 and layer 1 is frozen at every step
    tcfg = _train_cfg(g32, "topk_grad", steps, 2, 64, k_percent=50.0, **opt)
    card = Trainer(tcfg, device="cuda")
    cpu = Trainer(tcfg, device="cpu")
    cpu.state = _to(card.state, "cpu")
    p0 = list(_leaves(_to(card.state["params"], "cpu")))
    ops.reset_launches()
    for i in range(steps):
        card.train(1)
        cpu.train(1)
        lc, lh = card.log.losses[-1], cpu.log.losses[-1]
        check(abs(lc - lh) <= 1e-4 * abs(lh),
              f"gated step {i}: loss card {lc} vs cpu {lh}")
        mc = card.state["sel"]["mask"].cpu()
        check(torch.equal(mc, cpu.state["sel"]["mask"]),
              f"gated step {i}: masks differ: card {mc.int().tolist()} cpu "
              f"{cpu.state['sel']['mask'].int().tolist()}")
    launches = dict(ops.LAUNCHES)
    check(launches == {k: steps * v for k, v in _train_launches(
        2, sel_layers=1).items()},
          f"gated topk_grad: launches {launches} != 1 selected and 1 frozen "
          f"layer a step")
    # each leaf's update (params after minus before) on the card against
    # the CPU's, as a relative L2 gap: a wrong or missing update is ~1
    gap = _update_gap(torch, card.state["params"], cpu.state["params"], p0,
                      UPDATE_GAP)
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.log.losses,
                                                   cpu.log.losses))
    print(f"gated consistency (f32, TF32 off, 2 layers at full width, batch "
          f"2 x 64, {steps} gated topk_grad steps, k = 2 of 4 blocks, card "
          f"vs CPU): losses {[round(x, 6) for x in card.log.losses]}, max "
          f"rel err {rel:.2e} (limit 1e-4); masks equal at every step; "
          f"each leaf's update within {gap:.3g} of the CPU's (relative L2, "
          f"limit {UPDATE_GAP:g}); card launches {json.dumps(launches)}")
    del card, cpu
    fcfg = _train_cfg(c32, "full", steps, 2, 64, **opt)
    plain = Trainer(fcfg, device="cuda")
    gated = Trainer(dataclasses.replace(fcfg, model=g32), device="cuda")
    gated.state = _to(plain.state, "cuda")
    plain.train()
    gated.train()
    check(plain.log.losses == gated.log.losses
          and all(_bits_equal(torch, a, b) for a, b in zip(
              _leaves(plain.state["params"]), _leaves(gated.state["params"]))),
          f"gated full is not ungated full bit for bit: losses "
          f"{plain.log.losses} vs {gated.log.losses}")
    print(f"  gated full = ungated full bit for bit on the card ({steps} "
          f"steps: losses and every parameter)")


# ------------------------------------------ the paper's other two models


def phase_model_consistency(torch, ops, lm, cfg, Trainer, ServeEngine,
                            ServeConfig, Request, layers=2,
                            loss_rtol=1e-4, tie_rtol=0.0) -> None:
    """f32 (TF32 off) at full width with ``layers`` layers: phase 8's
    topk_grad run (``MODEL_CONSISTENCY_STEPS`` steps) on the card against
    the CPU (k = 50% of the blocks, losses within ``loss_rtol``, each
    leaf's update within ``UPDATE_GAP`` of the CPU's), then phase 5's
    greedy tokens against a teacher-forced prefill on the paged and the
    dense layout."""
    c2 = cfg.replace(num_layers=layers)
    t0 = time.perf_counter()
    phase_train_consistency(torch, ops, c2, Trainer, k_percent=50.0,
                            steps=MODEL_CONSISTENCY_STEPS, layers=layers,
                            loss_rtol=loss_rtol)
    gc.collect()
    t1 = time.perf_counter()
    phase_consistency(torch, ops, lm, c2, ServeEngine, ServeConfig, Request,
                      tie_rtol)
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  {cfg.name} consistency: training {t1 - t0:.1f} s, serving "
          f"{time.perf_counter() - t1:.1f} s")


# ------------------------------------------------------------ bf16 moments


def _device_ms(run: dict) -> str:
    prof = run.get("profile") or {}
    return (f"{prof['device_ms']:.1f} ms in {prof['launches']} launches "
            f"(2 steps), idle {prof['idle']:.3f}" if prof
            else "not measured")


def phase_bf16_moments(torch, ops, cfg, Trainer, dense, banked) -> dict:
    """Phase 7's dense run and phase 10's async banked run with bf16 m and
    v, beside the f32-moment runs ``dense`` and ``banked``."""
    gc.collect()
    torch.cuda.empty_cache()
    out = {"dense": phase_training(torch, ops, cfg, Trainer, keep_eval=False,
                                   moment_dtype="bfloat16")}
    out["banked"] = _banked_run(torch, ops, cfg, Trainer, out["dense"],
                                moment_dtype="bfloat16")
    for kind, f32 in (("dense", dense), ("banked", banked)):
        r = out[kind]
        ran = {k: v for k, v in r["launches"].items()
               if k.endswith("adamw_bf16m") and v}
        print(f"bf16 moments, {kind}: step {r['step_ms']:.2f} ms (f32 "
              f"moments {f32['step_ms']:.2f}), device {_device_ms(r)} (f32 "
              f"moments {_device_ms(f32)}), peak {r['peak'] / 2**30:.2f} "
              f"GiB (f32 moments {f32['peak'] / 2**30:.2f}); bf16-moment "
              f"launches {json.dumps(ran)}")
        check(r["peak"] < f32["peak"], f"bf16 moments, {kind}: peak "
              f"{r['peak']} not below the f32 moments' {f32['peak']}")
    return out


# ---------------------------------------------------- checkpoint and resume


CKPT_DIR = ROOT / "build" / "chip_smoke_ckpt"
# dense f32 also runs its second straight run with a save every
# ``SAVE_EVERY`` steps: the loop's cost of saves closer together than the
# writer takes, against the first run without
SAVE_EVERY_CASE, SAVE_EVERY = "dense f32", 3
CKPT_CASES = {"dense f32": {},
              "banked host f32": dict(moment_residency="banked",
                                      offload="host", async_swap=True),
              "dense bf16 moments": dict(moment_dtype="bfloat16")}


def _state_bytes(torch, state) -> int:
    return sum(x.numel() * x.element_size() for x in _leaves(state)
               if isinstance(x, torch.Tensor))


def _final(torch, tr) -> dict:
    """What a resumed run is held to: the state's tensors (moments
    materialised for the banked layout), its ints and slot_map, and the
    losses."""
    from repro_torch.checkpoint import manager
    from repro_torch.core import masked_adamw
    from repro_torch.core import partition as part_mod
    state = dict(tr.state)
    opt = state["opt"]
    if "store" in opt:
        m, v = masked_adamw.materialize_moments(
            part_mod.build_partition(tr.tcfg.model), opt)
        state["opt"] = {**{k: x for k, x in opt.items() if k != "store"},
                        "m": m, "v": v}
    flat = {path: (x.detach().clone() if isinstance(x, torch.Tensor)
                   else x.copy() if hasattr(x, "copy") else x)
            for path, x in manager.flatten(state)}
    return {"flat": flat, "losses": list(tr.log.losses)}


def _diff(torch, a: dict, b: dict) -> dict:
    """{path: max |a - b|} of the leaves whose bits differ (ints and arrays
    as inf); the losses under "losses"."""
    import numpy as np
    out = {}
    for path, x in a["flat"].items():
        y = b["flat"][path]
        if isinstance(x, torch.Tensor):
            if x.is_floating_point():
                ib = {4: torch.int32, 2: torch.int16}[x.element_size()]
                if not torch.equal(x.view(ib), y.to(x.device).view(ib)):
                    out[path] = (x.float() - y.to(x.device).float()
                                 ).abs().max().item()
            elif not torch.equal(x, y.to(x.device)):
                out[path] = math.inf
        elif not np.array_equal(np.asarray(x), np.asarray(y)):
            out[path] = math.inf
    la, lb = a["losses"], b["losses"]
    if la != lb:
        out["losses"] = max(abs(p - q) for p, q in zip(la, lb))
    return out


def phase_checkpoint(torch, Trainer, cfg) -> dict:
    """Checkpoint and resume at full width in the three configurations of
    ``CKPT_CASES``; the files go under ``CKPT_DIR``, which is removed."""
    out = {}
    try:
        for label, opt in CKPT_CASES.items():
            gc.collect()
            torch.cuda.empty_cache()
            out[label] = _checkpoint_case(torch, Trainer, cfg, label, opt)
    finally:
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
    return out


def _checkpoint_case(torch, Trainer, cfg, label, opt) -> dict:
    steps, every = 6, 3
    shutil.rmtree(CKPT_DIR, ignore_errors=True)

    def tcfg(ckdir="", save_every=every):
        t = _train_cfg(cfg, "adagradselect", steps, TRAIN["global_batch"],
                       TRAIN["seq_len"], **opt)
        return dataclasses.replace(t, checkpoint_dir=ckdir,
                                   checkpoint_every=save_every,
                                   checkpoint_keep=1)
    straight, walls, saves = [], [], []
    for run in range(2):
        ckdir = ""
        if run == 1 and label == SAVE_EVERY_CASE:
            ckdir = str(CKPT_DIR / "interval")
        tr = Trainer(tcfg(ckdir, SAVE_EVERY), device="cuda")
        if run == 0:
            CKPT_DIR.mkdir(parents=True, exist_ok=True)
            need = 2 * _state_bytes(torch, tr.state)
            free = shutil.disk_usage(CKPT_DIR).free
            check(free >= need, f"checkpoint {label}: {free:,} bytes free "
                  f"under {CKPT_DIR}, need twice the state's {need // 2:,}")
        if ckdir:
            def save_and_record(*a, _ckpt=tr.ckpt, _save=tr.ckpt.save, **k):
                _save(*a, **k)
                saves.append(dict(_ckpt.last_save))
            tr.ckpt.save = save_and_record
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.train(steps)   # waits for the last save's writer
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        straight.append(_final(torch, tr))
        del tr
    shutil.rmtree(CKPT_DIR / "interval", ignore_errors=True)
    first = Trainer(tcfg(str(CKPT_DIR)), device="cuda")
    first.train(every)
    save = dict(first.ckpt.last_save)
    del first
    gc.collect()
    torch.cuda.empty_cache()
    resumed = Trainer(tcfg(str(CKPT_DIR)), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    at = resumed.maybe_restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    check(at == every, f"checkpoint {label}: restored step {at}, want "
          f"{every}")
    resumed.train(steps - every)
    got = _final(torch, resumed)
    del resumed
    got["losses"] = straight[0]["losses"][:every] + got["losses"]
    spread = _diff(torch, straight[0], straight[1])
    off = _diff(torch, straight[0], got)
    if spread:
        print(f"  {label}: the two straight runs differ in "
              f"{json.dumps(spread)}")
    bad = {k: v for k, v in off.items() if v > spread.get(k, 0.0)}
    check(not bad, f"checkpoint {label}: the resumed run differs from the "
          f"straight one beyond their spread in {json.dumps(bad)}")
    print(f"checkpoint {label} ({cfg.name}, bf16 params, {steps} steps, "
          f"save at {every}): {save['bytes']:,} bytes on disk; save "
          f"stalled the loop {save['stall_s']:.3f} s (snapshot "
          f"{save['snapshot_s']:.3f} s), writer "
          f"{save['write_s']:.3f} s, restore {restore_s:.3f} s; resumed = "
          f"straight "
          f"{'bit for bit' if not off else 'within the straight runs spread'}"
          f" ({len(got['flat'])} leaves and the losses of steps "
          f"{every + 1}-{steps}: {[round(x, 5) for x in got['losses'][every:]]})")
    if saves:
        tok = steps * TRAIN["global_batch"] * TRAIN["seq_len"]
        print(f"checkpoint {label}: {steps} steps without saves "
              f"{walls[0]:.3f} s ({tok / walls[0]:,.0f} tok/s), with a save "
              f"every {SAVE_EVERY} steps {walls[1]:.3f} s "
              f"({tok / walls[1]:,.0f} tok/s, the last writer waited "
              f"for); each save's stall "
              f"{[round(x['stall_s'], 3) for x in saves]} s, of it the wait "
              f"on the previous writer "
              f"{[round(x['wait_s'], 3) for x in saves]} s; the saving run "
              f"= the first "
              f"{'bit for bit' if not spread else 'NOT bit for bit'}")
    return {**save, "restore_s": restore_s, "bit_equal": not off,
            "walls": walls, "saves": saves}


# ------------------------------------------------------- the serving stack

# phase 30: 4 groups of 4 requests, each group sharing a 384-token prefix
# (16-64 tokens of its own), and one 1,536-token prompt; budgets of 16-48
# new tokens (32 on average: the reference's preemption takes a resident
# only for a request with less budget left, so equal budgets never preempt)
STACK_GROUPS, STACK_PREFIX, STACK_LONG = 4, 384, 1536
STACK_BUDGETS = (48, 16, 40, 24)
STACK = dict(max_len=2048, num_slots=8, kv_layout="paged", page_size=16,
             decode_chunk=8, prefill_rows=4)
STACK_POOL = 0.6        # of the pages the plain run holds at once (peak)
STACK_TEMPERATURE = 0.8
STACK_PROFILE = (6, 2)  # engine steps of one more run skipped, profiled
STACK_SOLO = (0, 5, 16)  # requests served alone in the sampled check


def _stack_requests(Request, vocab):
    import numpy as np
    rng = np.random.default_rng(3)
    reqs = []
    for g in range(STACK_GROUPS):
        prefix = rng.integers(1, vocab, (STACK_PREFIX,))
        for j in range(4):
            own = rng.integers(1, vocab, (int(rng.integers(16, 65)),))
            reqs.append(Request(
                uid=len(reqs), tokens=np.concatenate([prefix, own]),
                max_new_tokens=STACK_BUDGETS[(g + j) % 4],
                arrival=g + 5 * j))
    reqs.append(Request(uid=len(reqs), tokens=rng.integers(
        1, vocab, (STACK_LONG,)), max_new_tokens=32, arrival=1))
    # submitted in arrival order: the queue admits only past a head that
    # has arrived
    return sorted(reqs, key=lambda r: r.arrival)


def _stack_configs(num_pages: int, store=None, on_complete=None) -> dict:
    """The runs of phase 30: every feature off (an ample pool), every
    feature on (the reference's prefix path takes every admission, so
    ``prefill_chunk`` is inert there), and the chunked runs: paged with
    preemption and dense with sampling (row 3)."""
    on = dict(num_pages=num_pages, prefix_cache=True, preempt=True,
              prefill_chunk=256, admission="prefix_aware",
              on_complete=on_complete, prefix_store=store)
    return {
        "off": dict(STACK),
        "on": {**STACK, **on},
        "chunked": {**STACK, "num_pages": num_pages, "preempt": True,
                    "prefill_chunk": 256, "on_complete": on_complete},
        "dense": {**STACK, "kv_layout": "dense", "prefill_chunk": 256,
                  "temperature": STACK_TEMPERATURE, "rng": 7,
                  "on_complete": on_complete}}


def _stack_run(torch, cfg, params, ServeEngine, ServeConfig, Request, kw,
               engine=None):
    """One run of the workload; returns the engine, its RunResult, the
    seconds and the chunked-prefill jobs it started (each job is one
    counted prefill whose chunks are the forwards)."""
    eng = engine or ServeEngine(cfg, params, ServeConfig(**kw),
                                device="cuda")
    jobs = {"n": 0}
    plain = eng._start_job

    def start_job(*args):
        jobs["n"] += 1
        return plain(*args)
    eng._start_job = start_job
    t0 = time.perf_counter()
    res = eng.run(_stack_requests(Request, cfg.vocab_size))
    torch.cuda.synchronize()
    return eng, res, time.perf_counter() - t0, jobs["n"]


def _stack_check_tokens(res, reqs, vocab) -> int:
    check(sorted(res) == sorted(r.uid for r in reqs),
          f"answered {sorted(res)} of {len(reqs)} requests")
    for r in reqs:
        toks = res[r.uid]
        check(len(toks) == r.max_new_tokens and (toks >= 0).all()
              and (toks < vocab).all(),
              f"request {r.uid}: {len(toks)} of {r.max_new_tokens} tokens, "
              f"range [{toks.min()}, {toks.max()}]")
    return sum(len(t) for t in res.values())


def phase_serving_stack(torch, ops, lm, cfg, serve) -> dict:
    """Phase 30: the full serving stack at full width (bf16), the f32
    exactness checks at 2 layers, and the idle share of two engine
    steps."""
    t_phase = time.perf_counter()
    ServeEngine, ServeConfig, Request = (serve.ServeEngine, serve.ServeConfig,
                                         serve.Request)
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    reqs = _stack_requests(Request, cfg.vocab_size)
    print(f"serving stack, {cfg.name} at full width ({cfg.dtype}): "
          f"{len(reqs)} requests ({STACK_GROUPS} groups of 4 sharing a "
          f"{STACK_PREFIX}-token prefix, 16-64 own tokens; one "
          f"{STACK_LONG}-token prompt), budgets {STACK_BUDGETS} (mean "
          f"{sum(STACK_BUDGETS) / 4:.0f}); {STACK}")
    # warm-up: the plain path's first prefills and decode steps at these
    # shapes (cuBLAS and Triton pick their kernels), on the first arrivals
    warm = ServeEngine(cfg, params, ServeConfig(**STACK), device="cuda")
    warm.run([Request(uid=r.uid, tokens=r.tokens, max_new_tokens=8)
              for r in reqs if r.arrival <= 1])
    del warm
    # the plain run: every feature off, the pool ample; its peak sizes
    # the small pool
    ops.reset_launches()
    eng, res, dt, _ = _stack_run(torch, cfg, params, ServeEngine,
                                 ServeConfig, Request, STACK)
    _check_launches(dict(ops.LAUNCHES), cfg, eng.stats)
    gen = _stack_check_tokens(res, reqs, cfg.vocab_size)
    peak = eng.page_pool_stats()["peak_live_pages"]
    num_pages = int(round(STACK_POOL * peak))
    off = {"tok_s": gen / dt, "stats": dict(eng.stats)}
    print(f"  features off: {gen} tokens in {dt:.3f} s = "
          f"{off['tok_s']:.1f} tok/s; peak {peak} pages; stats "
          f"{json.dumps(eng.stats)}")
    # every feature on, twice: engine A fills the store, engine B adopts
    streamed = {}
    store = serve.PrefixStore()
    runs = _stack_configs(num_pages, store,
                          lambda c: streamed.__setitem__(c.uid, c))
    out = {"launches": {}, "off": off}
    ops.reset_launches()                     # the main path's run
    t0 = time.perf_counter()
    eng_a, res_a, dt_a, _ = _stack_run(torch, cfg, params, ServeEngine,
                                       ServeConfig, Request, runs["on"])
    eng_a.close()
    eng_b, res_b, dt_b, _ = _stack_run(torch, cfg, params, ServeEngine,
                                       ServeConfig, Request, runs["on"])
    dt_on = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    out["launches"] = launches
    stats = {k: eng_a.stats[k] + eng_b.stats[k] for k in eng_a.stats}
    _check_launches(launches, cfg, stats)
    for r in (res_a, res_b):
        _stack_check_tokens(r, reqs, cfg.vocab_size)
    check(set(streamed) == set(res_b) and all(
        (streamed[u].tokens == res_b[u]).all() for u in res_b),
        "stream-out did not deliver every completion of engine B")
    check(store.stats["adoptions"] == 1, f"store {store.stats}")
    pool = eng_b.page_pool_stats()
    tree = eng_b._prefix.cached_pages
    check(pool["live_pages"] == tree and pool["high_water_pages"]
          <= num_pages, f"pool {pool}, tree {tree} pages")
    eng_b._prefix.evict(tree)
    live = eng_b.page_pool_stats()["live_pages"]
    check(live == 0, f"{live} pages live after the tree's eviction")
    for name, e in (("A", eng_a), ("B", eng_b)):
        st = e.stats
        check(st["prefix_hits"] > 0 and st["prefill_chunks"] == 0,
              f"engine {name}: {st}")
    check(eng_a.stats["preempted"] >= 1, f"engine A: {eng_a.stats}")
    gen_on = sum(len(t) for t in res_a.values()) + sum(
        len(t) for t in res_b.values())
    out["on"] = {"tok_s": gen_on / dt_on, "stats": stats}
    print(f"  every feature on ({num_pages}-page pool = {STACK_POOL} of "
          f"the peak; prefix cache, preemption, prefix-aware admission, "
          f"stream-out, prefill_rows {STACK['prefill_rows']}, a PrefixStore "
          f"across engines A and B): {gen_on} tokens in {dt_on:.3f} s = "
          f"{out['on']['tok_s']:.1f} tok/s (A {dt_a:.3f} s, B {dt_b:.3f} "
          f"s; off {off['tok_s']:.1f} tok/s)")
    for name, e in (("A", eng_a), ("B", eng_b)):
        print(f"    engine {name} stats {json.dumps(e.stats)}; prefill "
              f"tokens saved {off['stats']['prefill_tokens'] - e.stats['prefill_tokens']}"
              f" of {off['stats']['prefill_tokens']}; admission "
              f"{json.dumps(e.admission_policy.stats)}")
    print(f"    page pool at the end: {json.dumps(pool)} ({tree} tree "
          f"pages; after evicting the tree live_pages = {live}); store "
          f"{json.dumps(store.stats)}; {len(streamed)} completions streamed")
    print(f"    kernel launches (A and B): {json.dumps(launches)}")
    # chunked prefill (the path the prefix cache bypasses): paged with
    # preemption, then dense with sampling (row 3)
    for name in ("chunked", "dense"):
        streamed.clear()
        ops.reset_launches()
        e, r, dt, jobs = _stack_run(torch, cfg, params, ServeEngine,
                                    ServeConfig, Request, runs[name])
        lc = dict(ops.LAUNCHES)
        _check_launches(lc, cfg, e.stats, runs[name]["kv_layout"],
                        jobs=jobs)
        g = _stack_check_tokens(r, reqs, cfg.vocab_size)
        check(len(streamed) == len(reqs), f"{len(streamed)} streamed")
        check(e.stats["prefill_chunks"] > 0, f"{name}: {e.stats}")
        if name == "chunked":
            check(e.stats["preempted"] >= 1
                  and e.page_pool_stats()["live_pages"] == 0,
                  f"chunked: {e.stats}, {e.page_pool_stats()}")
        out[name] = {"tok_s": g / dt, "stats": dict(e.stats),
                     "launches": lc}
        print(f"  {name} ({'paged, preemption' if name == 'chunked' else 'dense, sampled T ' + str(STACK_TEMPERATURE)}, "
              f"prefill_chunk 256, stream-out): {g} tokens in {dt:.3f} s = "
              f"{g / dt:.1f} tok/s; {jobs} chunked jobs; stats "
              f"{json.dumps(e.stats)}; page pool "
              f"{json.dumps(e.page_pool_stats())}; launches {json.dumps(lc)}")
    del eng, eng_a, eng_b, e
    _stack_profile(torch, cfg, params, ServeEngine, ServeConfig, Request,
                   runs["on"] | {"prefix_store": None, "on_complete": None})
    del params
    gc.collect()
    torch.cuda.empty_cache()
    t_f32 = time.perf_counter()
    _stack_exact(torch, lm, cfg.replace(num_layers=2, dtype="float32"),
                 serve, num_pages)
    print(f"  phase time {time.perf_counter() - t_phase:.1f} s (f32 checks "
          f"{time.perf_counter() - t_f32:.1f} s)")
    return out


def _stack_profile(torch, cfg, params, ServeEngine, ServeConfig, Request,
                   kw) -> None:
    """Engine steps ``STACK_PROFILE`` of one more all-on run under the
    profiler (device activity only): device time, launches, idle share.
    The run stops after the profiled steps (its engine is dropped)."""
    from torch.profiler import ProfilerActivity, profile
    eng = ServeEngine(cfg, params, ServeConfig(**kw), device="cuda")
    for r in _stack_requests(Request, cfg.vocab_size):
        eng.submit(r)
    skip, n = STACK_PROFILE
    for _ in range(skip):
        eng.step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            eng.step()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    check(eng.num_active > 0, "the profiled steps decoded nothing")
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    if not events:
        print("  profile: the profiler saw no device time (not measured)")
        return
    busy_us = sum(e.device_time_total for e in events)
    row1 = [e for e in events if "decode_kernel" in e.key]
    print(f"  profile (engine steps {skip} to {skip + n - 1} of one more "
          f"all-on run, profiler on; {json.dumps(eng.stats)} by then): wall "
          f"{wall * 1e3:.1f} ms, device kernels {busy_us / 1e3:.1f} ms in "
          f"{sum(e.count for e in events)} launches, device idle share "
          f"{max(0.0, 1 - busy_us / 1e6 / wall):.3f}; row 1 "
          f"{sum(e.device_time_total for e in row1) / 1e3:.2f} ms in "
          f"{sum(e.count for e in row1)} launches")
    for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
        print(f"    {e.device_time_total / 1e3:9.2f} ms {e.count:7d}x  "
              f"{e.key[:90]}")


def _teacher_forced(torch, lm, cfg, params, prompt, toks, rows=16):
    """Argmax of teacher-forced prefills of ``prompt + toks`` at each
    generated position, in batches of ``rows`` rows padded to a multiple
    of 512 positions (``chunked_attention``'s query chunk)."""
    import numpy as np
    full = np.concatenate([prompt, toks]).astype(np.int32)
    width = -(-len(full) // 512) * 512
    out = []
    for i in range(0, len(toks), rows):
        n = min(rows, len(toks) - i)
        batch = np.zeros((n, width), np.int32)
        batch[:, :len(full)] = full
        lengths = torch.arange(n, device="cuda") + len(prompt) + i
        logits, _ = lm.prefill(params, cfg, {"tokens": torch.as_tensor(
            batch, device="cuda")}, width, lengths=lengths)
        check(bool(torch.isfinite(logits[:, :cfg.vocab_size]).all()),
              "teacher-forced logits not finite")
        out.append(torch.argmax(logits, dim=-1).cpu().numpy())
    return np.concatenate(out)


def _stack_exact(torch, lm, cfg, serve, num_pages) -> None:
    """f32 at 2 layers of the model's widths: greedy tokens of the all-on
    run and the chunked run equal the plain engine's (an ample pool) and a
    teacher-forced prefill; sampled tokens with preemption equal those
    without, and a request alone draws what it draws in the batch; the
    sampling noise on the card has the CPU's bits."""
    import numpy as np

    from repro_torch.serve import sampling
    ServeEngine, ServeConfig, Request = (serve.ServeEngine, serve.ServeConfig,
                                         serve.Request)
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    reqs = {r.uid: r for r in _stack_requests(Request, cfg.vocab_size)}
    runs = _stack_configs(num_pages)

    def run(kw):
        return _stack_run(torch, cfg, params, ServeEngine, ServeConfig,
                          Request, kw)

    def same(a, b, what):
        for uid in b:
            bad = np.nonzero(a[uid] != b[uid])[0]
            check(not bad.size, f"{what}: request {uid} differs first at "
                  f"token {bad[:1].tolist()}")

    plain_eng, plain, _, _ = run(runs["off"])
    on_eng, on, _, _ = run(runs["on"])
    chunk_eng, chunked, _, _ = run(runs["chunked"])
    same(on, plain, "greedy, every feature on vs plain")
    same(chunked, plain, "greedy, chunked with preemption vs plain")
    check(on_eng.stats["preempted"] >= 1 and on_eng.stats["prefix_hits"] > 0
          and chunk_eng.stats["preempted"] >= 1
          and chunk_eng.stats["prefill_chunks"] > 0,
          f"f32 runs did not exercise the stack: {on_eng.stats}, "
          f"{chunk_eng.stats}")
    checked = 0
    for uid, toks in sorted(plain.items()):
        want = _teacher_forced(torch, lm, cfg, params, reqs[uid].tokens,
                               toks)
        bad = np.nonzero(want != toks)[0]
        check(not bad.size, f"request {uid}: engine token differs from the "
              f"teacher-forced prefill first at {bad[:1].tolist()}")
        checked += len(toks)
    print(f"  f32 ({cfg.num_layers} layers at full width): greedy tokens "
          f"with every feature on ({json.dumps(on_eng.stats)}) and chunked "
          f"with preemption ({chunk_eng.stats['prefill_chunks']} chunks, "
          f"{chunk_eng.stats['preempted']} preempted) equal the plain "
          f"engine's; {checked} tokens equal the teacher-forced prefill")
    samp = {"temperature": STACK_TEMPERATURE, "rng": 7}
    s_plain = run(runs["off"] | samp)[1]
    s_on_eng, s_on, _, _ = run(runs["on"] | samp)
    same(s_on, s_plain, "sampled, preemption + prefix cache vs plain")
    check(s_on_eng.stats["preempted"] >= 1, f"{s_on_eng.stats}")
    d_on = run(runs["dense"])[1]
    for uid in STACK_SOLO:
        r = reqs[uid]
        solo = ServeEngine(cfg, params, ServeConfig(
            **{**STACK, "num_slots": 1, **samp}), device="cuda").run(
                [Request(uid=uid, tokens=r.tokens,
                         max_new_tokens=r.max_new_tokens)])
        same(solo, {uid: s_plain[uid]}, f"sampled request {uid} alone")
        same({uid: d_on[uid]}, {uid: s_plain[uid]},
             f"sampled request {uid} on the dense layout, chunked")
    keys = torch.tensor([sampling.stream_key(7, uid) for uid in reqs])
    ctr = torch.arange(len(reqs), dtype=torch.int64) * 5
    g_cpu = sampling.gumbel(keys, ctr, cfg.padded_vocab_size)
    g_card = sampling.gumbel(keys.cuda(), ctr.cuda(),
                             cfg.padded_vocab_size).cpu()
    check(torch.equal(g_cpu.view(torch.int32), g_card.view(torch.int32)),
          "sampling noise on the card differs from the CPU's")
    print(f"  f32 sampled (T {STACK_TEMPERATURE}): with preemption and the "
          f"prefix cache ({s_on_eng.stats['preempted']} preempted) = "
          f"without; requests {STACK_SOLO} alone = in the batch, and = on "
          f"the dense layout with chunked prefill; noise bits of "
          f"{len(reqs)} x {cfg.padded_vocab_size} draws card = CPU")


# ---------------------------------------------------------- observability

OBS_DIR = ROOT / "build" / "chip_smoke_obs"
OBS_STEPS = 6          # phase 31: steps of each run
OBS_ROUNDS = 1         # phase 31(d): rounds of OBS_STEPS windows, runs in turn
# phase 31's four training runs: (obs on, prefetch depth)
OBS_RUNS = ((False, 0), (True, 0), (False, 2), (True, 2))


def _obs_label(run) -> str:
    return f"obs {'on' if run[0] else 'off'} / prefetch {run[1]}"


def _obs_train(torch, ops, cfg, Trainer, loader, obs, run) -> dict:
    """One of phase 31(a)'s runs: phase 13's packed source, dense
    adagradselect, OBS_STEPS steps in one log window, obs and prefetch as
    ``run`` says; with obs on the trace and the snapshot are written."""
    on, depth = run
    gb, sl = TRAIN["global_batch"], TRAIN["seq_len"]
    steps = OBS_STEPS * (2 + OBS_ROUNDS)   # (a), then (d)'s windows
    tcfg = _train_cfg(cfg, "adagradselect", steps, gb, sl,
                      log_every=10 ** 6)
    data = loader.make_source("packed_math", seq_len=sl, global_batch=gb,
                              seed=tcfg.seed)
    tr = Trainer(tcfg, data_source=data, prefetch_depth=depth,
                 device="cuda")
    if on:
        obs.enable()
    ops.reset_launches()
    tr.train(OBS_STEPS)
    launches = dict(ops.LAUNCHES)
    out = {"tr": tr, "launches": launches}
    if on:
        sel = obs.selection_trace()
        tag = f"p{depth}"
        out["trace"] = obs.validate_trace_file(
            _obs_export(obs, f"train_{tag}.json"))
        out["snapshot"] = OBS_DIR / f"train_{tag}_metrics.json"
        out["snapshot"].write_text(json.dumps(obs.snapshot()))
        out["sel"] = sel
        obs.disable()
    return out


def _obs_export(obs, name: str) -> str:
    OBS_DIR.mkdir(parents=True, exist_ok=True)
    path = str(OBS_DIR / name)
    obs.export_trace(path)
    return path


def _obs_training(torch, ops, cfg, Trainer, loader, obs, inspect) -> dict:
    """Phase 31(a) and (d): the four runs bit for bit, then step times in
    ``OBS_ROUNDS`` round(s) of the runs in turn, then a torch.profiler
    capture with the bridge."""
    import contextlib
    import io
    import threading

    from repro_torch.obs import report
    runs = {run: _obs_train(torch, ops, cfg, Trainer, loader, obs, run)
            for run in OBS_RUNS}
    base = runs[OBS_RUNS[0]]
    nl = cfg.num_layers
    want = _train_launches(nl)
    for run, r in runs.items():
        tr = r["tr"]
        check(all(math.isfinite(x) for x in tr.log.losses),
              f"{_obs_label(run)}: losses {tr.log.losses}")
        check(tr.log.losses == base["tr"].log.losses,
              f"{_obs_label(run)}: losses {tr.log.losses} != "
              f"{base['tr'].log.losses}")
        a, b = _leaves(tr.state["params"]), _leaves(base["tr"].state["params"])
        check(all(_bits_equal(torch, x, y) for x, y in zip(a, b)),
              f"{_obs_label(run)}: params differ from obs off / prefetch 0")
        per_step = {k: n / OBS_STEPS for k, n in r["launches"].items()}
        check(per_step == want, f"{_obs_label(run)}: launches per step "
              f"{per_step} != {want}")
        check(tr.data.cursor()["record"] == sum(tr.log.records),
              f"{_obs_label(run)}: cursor {tr.data.cursor()} != "
              f"{sum(tr.log.records)} records trained")
        if not run[0]:
            continue
        counts = tr.state["opt"]["counts"].cpu().numpy()
        check((r["sel"].counts == counts).all(),
              f"{_obs_label(run)}: selection counts {r['sel'].counts} != "
              f"opt counts {counts}")
        events = r["trace"]
        steps = [e for e in events if e["ph"] == "B"
                 and e["name"] == "train_step"]
        check(len(steps) == OBS_STEPS, f"{len(steps)} train_step spans")
        threads = {e["args"]["name"] for e in events if e["ph"] == "M"}
        check(run[1] == 0 or "data-prefetch" in threads,
              f"no data-prefetch thread in the trace: {threads}")
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            inspect.main([str(r["snapshot"]), "--bins", "3"])
        shown = buf.getvalue()
        check(f"selection heatmap — {OBS_STEPS} steps" in shown
              and "[train]" in shown, f"inspect rendered {shown[:200]!r}")
    on2 = runs[(True, 2)]
    print(f"  (a) {len(OBS_RUNS)} runs of {OBS_STEPS} packed steps "
          f"({', '.join(map(_obs_label, OBS_RUNS))}): losses, every "
          f"parameter leaf and the launches a step bit-equal; selection "
          f"counts = opt counts {on2['sel'].counts.astype(int).tolist()}; "
          f"traces valid with {OBS_STEPS} train_step spans and the "
          f"data-prefetch thread; snapshots rendered by launch.inspect")
    print("  heatmap (obs on / prefetch 2):\n    " + "\n    ".join(
        report.render_selection_trace(on2["sel"], bins=3).splitlines()))
    # (d): step times, OBS_STEPS-step windows (one sync at each window's
    # end), the four runs in turn in each round
    times = {run: [] for run in OBS_RUNS}
    for _ in range(OBS_ROUNDS):
        for run in OBS_RUNS:
            if run[0]:
                obs.enable()
            runs[run]["tr"].train(OBS_STEPS)
            obs.disable()
            times[run].append(runs[run]["tr"].log.step_times[-1] * 1e3)
    med = {run: statistics.median(ts) for run, ts in times.items()}
    ratios = {"obs on / off, prefetch 0": med[(True, 0)] / med[(False, 0)],
              "obs on / off, prefetch 2": med[(True, 2)] / med[(False, 2)],
              "prefetch 2 / 0, obs off": med[(False, 2)] / med[(False, 0)],
              "prefetch 2 / 0, obs on": med[(True, 2)] / med[(True, 0)]}
    print(f"  (d) step time (ms) in {OBS_ROUNDS} round(s) of "
          f"{OBS_STEPS}-step windows, the runs in turn: " + "; ".join(
              f"{_obs_label(run)} {[round(t, 2) for t in ts]} (median "
              f"{med[run]:.2f})" for run, ts in times.items()))
    print(f"  (d) ratios of the medians: " + ", ".join(
        f"{k} {v:.4f}" for k, v in ratios.items()) + f"  [{card_line()}]")
    # the bridge: 2 profiled steps, each a train_step range
    from torch.profiler import ProfilerActivity, profile
    tr = runs[(True, 0)]["tr"]
    obs.enable(torch_profiler=True)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tr.train(2)
    obs.disable()
    spans = [e for e in prof.events() if e.name == "train_step"]
    # the host's ranges; the profiler may mirror each on the device's
    # timeline as a user annotation
    ranges = [e for e in spans if e.device_type.name == "CPU"]
    check(len(ranges) == 2, f"{len(ranges)} train_step ranges in the "
          f"profile, want 2")
    dev = sum(getattr(e, "device_time_total", 0) for e in ranges)
    print(f"  torch_profiler bridge: {len(ranges)} train_step ranges on "
          f"the host thread ({threading.current_thread().name}), "
          f"{len(spans) - len(ranges)} on the device's timeline, "
          f"{dev / 1e3:.1f} ms of device time under them")
    out = {"ratios": ratios, "median_ms": {_obs_label(r): m
                                           for r, m in med.items()}}
    runs.clear()
    return out


def _obs_banked(torch, ops, cfg, Trainer, obs) -> None:
    """Phase 31(b): phase 10's async banked run with obs on."""
    import threading
    tcfg = _train_cfg(cfg, "adagradselect", OBS_STEPS, TRAIN["global_batch"],
                      TRAIN["seq_len"], log_every=10 ** 6,
                      moment_residency="banked", offload="host",
                      async_swap=True)
    tr = Trainer(tcfg, device="cuda")
    obs.enable()
    tr.train(OBS_STEPS)
    events = obs.validate_trace_file(_obs_export(obs, "banked.json"))
    snap = obs.snapshot()["swap"]
    obs.disable()
    stats = tr.step_fn.swap_stats
    for name in ("phase_a", "swap", "phase_b"):
        h = getattr(stats, name)
        check(h.count == OBS_STEPS and snap[f"{name}_us"]["count"]
              == OBS_STEPS, f"{name}: {h.count} samples, want {OBS_STEPS}")
    main = threading.get_ident()
    jobs = [e for e in events if e["name"] == "swap_dispatch_job"]
    check(len(jobs) == stats.dispatches and jobs
          and all(e["tid"] != main for e in jobs),
          f"{len(jobs)} swap_dispatch_job spans ({stats.dispatches} "
          f"dispatches), tids {sorted({e['tid'] for e in jobs})}, main "
          f"{main}")
    check(snap["mispredicts"] == stats.mispredicts,
          f"mispredicts counter {snap['mispredicts']} != SwapStats "
          f"{stats.mispredicts}")
    print(f"  (b) banked async, obs on, {OBS_STEPS} steps: phase_a / swap / "
          f"phase_b {stats.phase_a.count} samples each, medians "
          f"{stats.phase_a.quantile(0.5):.0f} / {stats.swap.quantile(0.5):.0f}"
          f" / {stats.phase_b.quantile(0.5):.0f} µs; {len(jobs)} "
          f"swap_dispatch_job spans off the main thread; mispredicts "
          f"{stats.mispredicts} = the counter; {json.dumps(stats.as_dict())}")


def _obs_serving(torch, ops, lm, cfg, serve, obs) -> None:
    """Phase 31(c): phase 4's workload on the paged layout, obs off then
    on: the same tokens and launches, the histograms and lanes."""
    params = lm.init(cfg, torch.Generator(device="cuda").manual_seed(0),
                     device="cuda")
    runs = {}
    for on in (False, True):
        if on:
            obs.enable(selection=False)
        ops.reset_launches()
        eng, res, dt = _serve_once(torch, cfg, params, serve.ServeEngine,
                                   serve.ServeConfig, serve.Request)
        runs[on] = (eng, res, dict(ops.LAUNCHES), dt)
    events = obs.validate_trace_file(_obs_export(obs, "serve.json"))
    reg = obs.snapshot()["serve"]
    obs.disable()
    (_, off, l_off, dt_off), (eng, res, l_on, dt_on) = runs[False], runs[True]
    check(sorted(res) == sorted(off) and all(
        (res[u] == off[u]).all() for u in off), "obs on changed the tokens")
    check(l_on == l_off, f"launches obs on {l_on} != off {l_off}")
    snap = eng.stats_snapshot()
    n = len(PROMPT_LENS)
    for name, h in snap["latency_us"].items():
        check(h["count"] == n and reg[f"{name}_us"]["count"] == n,
              f"{name}: {h['count']} samples, want {n}")
    check(snap["engine"] == eng.stats and reg["engine"] == eng.stats,
          f"stats_snapshot engine {snap['engine']} != stats {eng.stats}")
    check(reg["page_pool_live"] == 0.0, f"page_pool_live "
          f"{reg['page_pool_live']} at the end")
    lanes = {}
    for e in events:
        if e["ph"] == "X":
            lanes.setdefault(e["tid"], {})[e["name"]] = e["dur"]
    check(len(lanes) == n and all(d["ttft"] <= d["e2e"]
                                  for d in lanes.values()),
          f"request lanes {lanes}")
    spans = {e["name"] for e in events if e["ph"] == "B"}
    check({"admission", "decode_chunk"} <= spans, f"spans {spans}")
    lat = snap["latency_us"]
    print(f"  (c) serving, obs on vs off: tokens and launches equal; "
          f"{n} lanes with ttft <= e2e; page_pool_live 0; p50 queue wait "
          f"{lat['queue_wait']['p50'] / 1e3:.1f} ms, ttft "
          f"{lat['ttft']['p50'] / 1e3:.1f} ms, tpot "
          f"{lat['tpot']['p50'] / 1e3:.2f} ms, e2e "
          f"{lat['e2e']['p50'] / 1e3:.1f} ms; tok/s off "
          f"{n * NEW_TOKENS / dt_off:.1f}, on {n * NEW_TOKENS / dt_on:.1f}")


def phase_observability(torch, ops, lm, cfg, Trainer, loader, serve, obs,
                        inspect) -> dict:
    """Phase 31: the obs layer and the prefetcher at full width."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    shutil.rmtree(OBS_DIR, ignore_errors=True)
    try:
        print(f"observability and prefetch, {cfg.name} ({cfg.dtype}), batch "
              f"{TRAIN['global_batch']} x {TRAIN['seq_len']}:")
        out = _obs_training(torch, ops, cfg, Trainer, loader, obs, inspect)
        t_train = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        _obs_banked(torch, ops, cfg, Trainer, obs)
        t_banked = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        _obs_serving(torch, ops, lm, cfg, serve, obs)
    finally:
        obs.disable()
        shutil.rmtree(OBS_DIR, ignore_errors=True)
    t1 = time.perf_counter()
    print(f"  phase 31: {t1 - t0:.1f} s ((a), (d) and the profile "
          f"{t_train - t0:.1f} s, (b) {t_banked - t_train:.1f} s, (c) "
          f"{t1 - t_banked:.1f} s)")
    return out


# ------------------------------------------------------- the LoRA baseline


def _lora_launches(nl: int) -> dict:
    """Kernel launches of one LoRA step of nl layers: the forward's norms
    and, under ``remat="full"``, each layer's two again; the backward's
    norms all in the dx-only mode (every scale is frozen), but for the first
    layer's first norm, whose input (the frozen embedding's rows) needs no
    gradient; the flash kernels; no selection kernel."""
    want = _train_launches(nl, leaves=0)
    want.update(rmsnorm_bwd=0, rmsnorm_bwd_dx=2 * nl)
    return want


# phase 32: the adapters of ARCH (qwen2.5-0.5b) at LORA_RANK (256), (1920 +
# 1024 + 1024 + 1920 + 3 * 5760) * 256 a layer over 24 layers, as the
# reference's ``init_lora`` gives them (tests/test_torch_lora.py traces it)
LORA_TRAINABLE = 142_344_192


def _lora_trainable(cfg, rank: int) -> int:
    """The adapters' parameters, reckoned from the config's leaf shapes."""
    from repro_torch.optim.lora import adapter_layout
    return sum(math.prod(a) + math.prod(b)
               for a, b, _ in adapter_layout(cfg, rank).values())


def _lora_run(torch, ops, cfg, Trainer, training, full_ms) -> dict:
    """Phase 32(a): the bf16 LoRA r256 run at full width, phase 7's
    settings otherwise."""
    warm, steps = TRAIN["warmup"], TRAIN["steps"]
    gb, sl = TRAIN["global_batch"], TRAIN["seq_len"]
    tcfg = _train_cfg(cfg, "lora", steps, gb, sl, lora_rank=LORA_RANK)
    t0 = time.perf_counter()
    tr = Trainer(tcfg, device="cuda")
    torch.cuda.synchronize()
    rep = tr.method.trainable_param_report(cfg, tr.state)
    n = _lora_trainable(cfg, LORA_RANK)
    check(n == LORA_TRAINABLE,
          f"{cfg.name} r{LORA_RANK}: {n:,} adapter parameters reckoned from "
          f"the config, the reference's count is {LORA_TRAINABLE:,}")
    print(f"LoRA r{LORA_RANK} (alpha {tcfg.optimizer.lora_alpha:g}) on "
          f"{cfg.name} ({cfg.num_layers} layers, {cfg.dtype}), batch {gb} x "
          f"{sl} tokens, {steps} steps; init "
          f"{time.perf_counter() - t0:.2f} s")
    check(rep.num_params_trainable == n,
          f"trainable {rep.num_params_trainable:,} != {n:,} reckoned from "
          f"the config")
    check(rep.opt_bytes == 8 * n and rep.opt_bytes_resident == 8 * n + 4,
          f"optimizer bytes: modelled {rep.opt_bytes:,}, resident "
          f"{rep.opt_bytes_resident:,}; want {8 * n:,} and {8 * n + 4:,} "
          f"(f32 m and v, the count)")
    print(f"  report: trainable {rep.num_params_trainable:,} of "
          f"{rep.num_params_total:,} ({rep.trainable_fraction:.2%}; "
          f"reckoned {n:,}), optimizer bytes modelled {rep.opt_bytes:,}, "
          f"resident {rep.opt_bytes_resident:,}; {rep.detail}")
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()                     # the main path's run
    for _ in range(steps):
        tr.train(1)
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    log = tr.log
    check(len(log.losses) == steps and all(math.isfinite(x)
                                           for x in log.losses),
          f"losses {log.losses}")
    check(tr.state["opt"]["count"].item() == steps,
          f"AdamW count {tr.state['opt']['count'].item()} after {steps} "
          f"steps")
    check(all(ab["b"].any().item() for ab in tr.state["lora"].values()),
          "an adapter's b did not move")
    per_step = {name: c / steps for name, c in launches.items()}
    want = _lora_launches(cfg.num_layers)
    check(per_step == want, f"launches per step {per_step} != the LoRA "
          f"path's {want}")
    med = statistics.median(log.step_times[warm:])
    tokens = gb * sl
    print(f"  losses: {[round(x, 4) for x in log.losses]}")
    print(f"  step time (median of steps {warm}..{steps - 1}): "
          f"{med * 1e3:.2f} ms = {tokens / med:.0f} tokens/s; all steps "
          f"(ms): {[round(t * 1e3, 2) for t in log.step_times]}")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB (adagradselect, "
          f"phase 7: {training['peak'] / 2**30:.2f} GiB)")
    print(f"  launches per step: {json.dumps(per_step)}")
    prof = _profile_training(torch, tr)
    print(f"  beside this call's others (records, not claims: windows "
          f"spread 10-20%; {card_line()}): adagradselect median (phase 7) "
          f"{training['step_ms']:.2f} ms, full (phase 18, 8-step windows) "
          f"{full_ms:.2f} ms; lora / adagradselect "
          f"{med * 1e3 / training['step_ms']:.3f}, lora / full "
          f"{med * 1e3 / full_ms:.3f}; peak lora / adagradselect "
          f"{peak / training['peak']:.3f}")
    del tr
    return {"launches": launches, "step_ms": med * 1e3, "peak": peak,
            "tokens_s": tokens / med, "profile": prof}


def _lora_consistency(torch, ops, cfg, Trainer) -> None:
    """Phase 32(b): ``LORA_STEPS`` f32 LoRA r256 steps (TF32 off) at full
    width with 2 layers, batch 2 x 64, on the card and on the CPU from one
    state: losses within 1e-4 relative, each adapter leaf's update within
    ``UPDATE_GAP`` of the CPU's (relative L2), as phase 8 holds them."""
    lr, steps = 1e-3, LORA_STEPS
    cfg = cfg.replace(dtype="float32", num_layers=2)
    tcfg = _train_cfg(cfg, "lora", steps, 2, 64, lr=lr, schedule="constant",
                      warmup_steps=0, lora_rank=LORA_RANK)
    card = Trainer(tcfg, device="cuda")
    cpu = Trainer(tcfg, device="cpu")
    cpu.state = _to(card.state, "cpu")
    a0 = [t.clone() for t in _leaves(cpu.state["lora"])]
    ops.reset_launches()
    for i in range(steps):
        card.train(1)
        cpu.train(1)
        lc, lh = card.log.losses[-1], cpu.log.losses[-1]
        check(abs(lc - lh) <= 1e-4 * abs(lh),
              f"step {i}: loss card {lc} vs cpu {lh}")
    launches = dict(ops.LAUNCHES)
    check(all(launches[n] > 0 for n in ("rmsnorm", "rmsnorm_bwd_dx",
                                        *_flash_per_step(1))),
          f"a kernel of the LoRA path did not run on the card: {launches}")
    worst = max((a.cpu() - b).abs().max().item() for a, b in zip(
        _leaves(card.state["lora"]), _leaves(cpu.state["lora"])))
    gap = _update_gap(torch, card.state["lora"], cpu.state["lora"], a0,
                      UPDATE_GAP)
    for a, b in zip(_leaves(card.state["base"]), _leaves(cpu.state["base"])):
        check(torch.equal(a.cpu(), b), "a base leaf changed")
    rel = max(abs(a - b) / abs(b) for a, b in zip(card.log.losses,
                                                   cpu.log.losses))
    print(f"LoRA consistency {cfg.name} (f32, TF32 off, r{LORA_RANK}, "
          f"{cfg.num_layers} layers at full width, batch 2 x 64, {steps} "
          f"steps, card vs CPU): losses "
          f"{[round(x, 6) for x in card.log.losses]}, max rel err {rel:.2e} "
          f"(limit 1e-4); adapters max |err| {worst:.3g} (a record); "
          f"each adapter leaf's update within {gap:.3g} of the CPU's "
          f"(relative L2, limit {UPDATE_GAP:g}); the base unchanged; card "
          f"launches {json.dumps(launches)}")
    del card, cpu


def phase_lora(torch, ops, cfg, Trainer, training, full_ms) -> dict:
    """Phase 32: the paper's LoRA baseline at full width, then in f32 card
    against the CPU."""
    t0 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    out = _lora_run(torch, ops, cfg, Trainer, training, full_ms)
    gc.collect()
    torch.cuda.empty_cache()
    t1 = time.perf_counter()
    _lora_consistency(torch, ops, cfg, Trainer)
    print(f"  phase 32: {time.perf_counter() - t0:.1f} s ((a) "
          f"{t1 - t0:.1f} s)")
    return out


# ------------------------------------------------------------------ main


# --------------------------------------- the reference's other dense archs

# phases 33-37 (ROADMAP Queue A item 12a): chatglm3-6b (partial rotary 0.5,
# QKV bias, 32 q / 2 kv heads, D 128) and yi-9b (32 q / 4 kv) train at full
# width with banked bf16 moments in pinned host RAM (paper §3.3); they and
# qwen2.5-32b (40 q heads padded to 48 on 8 kv heads, d_model 5120, QKV
# bias; 66.9 GB of bf16 weights, so it only serves) serve phase 4's cell
GLM, YI, QWEN32 = "chatglm3-6b", "yi-9b", "qwen2.5-32b"
# per trained arch: k in percent of the blocks, gate_weight_grads, and the
# two depths whose peaks are measured before the full-width run
ARCH_TRAIN = {GLM: (20.0, False, (7, 14)), YI: (10.0, True, (12, 24))}
ARCH_STEPS = 4          # a full-width run (and a peak probe): 2 warm-up
                        # steps, then 2 timed
PEAK_LIMIT_GIB = 74.0   # the most an extrapolated peak may reach
HOST_MARGIN_GIB = 8.0   # host memory kept free beside the pinned store
QWEN32_HMAP = [min(h // 5, 7) for h in range(48)]   # 13 heads on kv head 7
GLM_HMAP = [h // 16 for h in range(32)]
# row 2 at qwen2.5-32b's d_model, one decode row block and a prefill chunk,
# and at the forward's widest row
ARCH_NORM_SHAPES = ((4, 5120), (1024, 5120), (4, 8192), (1024, 8192))
QWEN32_PEAK_GIB = (63.0, 65.0)   # reckoned: 62.3 GiB of weights, the KV


def phase_arch_kernels(torch, ops, ref, timer) -> None:
    """Rows 1 and 3 at qwen2.5-32b's head map (48 q heads on 8 kv, three
    blocks a kv head) and chatglm3-6b's (32 on 2), D 128, bf16 and f32:
    against their plain versions, bit-identical over two launches, row 3 on
    the gathered view bit-equal to row 1 on the pool; row 2 at D 5120 and
    8192 against its plain version with its registers (a spill fails);
    times as in phase 3."""
    from repro_torch.kernels import rmsnorm as rn
    F = torch.nn.functional
    rows = []
    vlens = [1, 19, 300, 512]
    for dtype in ("bfloat16", "float32"):
        dt = getattr(torch, dtype)
        for arch, h, kvh, hm in ((QWEN32, 48, 8, QWEN32_HMAP),
                                 (GLM, 32, 2, GLM_HMAP)):
            q, k, v, tbl, vl, hmap = _paged_inputs(torch, dtype, 4, vlens,
                                                   h=h, kvh=kvh, d=128,
                                                   hmap=hm)
            n0 = ops.LAUNCHES["paged_decode_attention"]
            paged = ops.paged_decode_attention(q, k, v, tbl, vl, hmap)
            again = ops.paged_decode_attention(q, k, v, tbl, vl, hmap)
            torch.cuda.synchronize()
            check(ops.LAUNCHES["paged_decode_attention"] == n0 + 2,
                  "paged_decode_attention did not count its launches")
            check(_bits_equal(torch, paged, again),
                  f"row 1 {arch} {dtype}: two launches differ")
            err1 = _check_close(
                torch, paged[:, 0],
                ref.paged_decode_attention(q[:, 0], k, v, tbl, vl, hmap),
                dtype, f"row 1 {arch} map")
            rws = tbl.long().clamp(max=k.shape[0] - 1)
            kd, vd = (p[rws].reshape(4, -1, *p.shape[2:]).contiguous()
                      for p in (k, v))
            dense = ops.decode_attention(q, kd, vd, vl, hmap)
            err3 = _check_close(
                torch, dense[:, 0],
                ref.decode_attention_cache(q[:, 0], kd, vd, vl, hmap),
                dtype, f"row 3 {arch} map")
            check(_bits_equal(torch, dense, paged), f"rows 3 and 1 differ "
                  f"on one pool at {arch}'s map ({dtype})")
            print(f"  rows 1 and 3 {dtype:<8} {arch}'s map (H={h} KVH={kvh} "
                  f"D=128, page 16, valid_len {vlens}): max |err| "
                  f"{err1:.2e} / {err3:.2e} (rtol=atol {TOL[dtype]:.0e}); "
                  f"bit-identical over two launches; row 3 on the gathered "
                  f"view = row 1 bit for bit")
            if arch == QWEN32:
                es = q.element_size()
                kv_pos = sum(vlens)
                nbytes = (2 * 4 * h * 128 * es + 2 * kv_pos * kvh * 128 * es
                          + 4 * (tbl.numel() + 4 + h))
                bms, by = bound_ms(nbytes, 4 * kv_pos * h * 128, dtype)
                rows.append(dict(
                    kernel="paged_decode_attention", dtype=dtype,
                    shape=f"B=4 H=48 KVH=8 D=128 page=16 valid_len "
                    f"{vlens}", max_abs_err=err1,
                    ms=timer.ms(lambda: ops.paged_decode_attention(
                        q, k, v, tbl, vl, hmap)),
                    plain_ms=timer.ms(lambda: ref.paged_decode_attention(
                        q[:, 0], k, v, tbl, vl, hmap)),
                    library_ms=None, bound_ms=bms, bound_by=by))
            del q, k, v, kd, vd, paged, again, dense
        q, k, v, vl, hmap = _decode_case(torch, dtype, 16, 512,
                                         DECODE_EVAL_VL, d=128, h=48, kvh=8,
                                         hmap=QWEN32_HMAP)
        out = ops.decode_attention(q, k, v, vl, hmap)
        err = _check_close(torch, out[:, 0], ref.decode_attention_cache(
            q[:, 0], k, v, vl, hmap), dtype, "row 3 [16, 48 heads, 512]")
        rows.append(_decode_times(torch, ops, ref, timer, dtype, q, k, v, vl,
                                  hmap, err))
        del q, k, v, out
        for n, d in ARCH_NORM_SHAPES:
            x, s, _ = _norm_inputs(torch, dt, n, d, seed=n + d)
            err = _norm_fwd_check(torch, ops, ref, x, s, dtype)
            plan = rn.launch(x, s, 1e-6, torch.empty_like(x))
            es = x.element_size()
            bms, by = bound_ms(2 * n * d * es + d * es, 4 * n * d, dtype)
            rows.append(dict(
                kernel="rmsnorm", dtype=dtype,
                shape=f"[{n}, {d}], {plan.warps} warps a row, "
                f"{plan.rows} rows a block, {plan.stages} stages, "
                f"{plan.blocks} blocks", max_abs_err=err,
                ms=timer.ms(lambda: ops.rmsnorm(x, s, 1e-6)),
                plain_ms=timer.ms(lambda: ref.rmsnorm(x, s, 1e-6)),
                library_ms=timer.ms(lambda: F.rms_norm(x, (d,), weight=s,
                                                       eps=1e-6)),
                bound_ms=bms, bound_by=by))
    print(f"  rmsnorm forward instances: {_norm_fwd_usage()}")
    print("the widened rows at the new archs' shapes (CUDA events, L2 "
          "flushed, ms per call; row 1 has no single-call library "
          "yardstick, row 3's is SDPA with enable_gqa, row 2's "
          "F.rms_norm):")
    for r in rows:
        lib = "-" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        print(f"  {r['kernel']:<23} {r['dtype']:<9} err "
              f"{r['max_abs_err']:.2e}  kernel {r['ms']:.4f}  plain "
              f"{r['plain_ms']:.4f}  library {lib}  bound "
              f"{r['bound_ms']:.4g} ({r['bound_by']})  {r['shape']}")


def _host_available() -> tuple:
    """(MemAvailable in bytes from /proc/meminfo, ``free -g``'s Mem line)."""
    avail = 0
    with open("/proc/meminfo") as f:
        for ln in f:
            if ln.startswith("MemAvailable:"):
                avail = int(ln.split()[1]) * 1024
    out = subprocess.run(["free", "-g"], capture_output=True, text=True,
                         timeout=60).stdout
    mem = next((ln for ln in out.splitlines() if ln.startswith("Mem:")), "")
    return avail, " ".join(mem.split())


def _arch_trainer(torch, Trainer, cfg, steps):
    """Phase 7's adagradselect run of ``cfg`` (8 x 512, ``remat="full"``)
    with banked residency, the store pinned in host RAM, bf16 m and v, and
    the arch's k and gate (``ARCH_TRAIN``)."""
    k_percent, gate, _ = ARCH_TRAIN[cfg.name]
    return Trainer(_train_cfg(
        cfg.replace(gate_weight_grads=gate), "adagradselect", steps,
        TRAIN["global_batch"], TRAIN["seq_len"], k_percent=k_percent,
        moment_residency="banked", offload="host",
        moment_dtype="bfloat16"), device="cuda")


def _stepped_peaks(torch, tr, steps) -> list:
    """``steps`` steps of ``tr`` one at a time: each step's peak device
    memory (the state included)."""
    peaks = []
    for _ in range(steps):
        torch.cuda.reset_peak_memory_stats()
        tr.train(1)
        peaks.append(torch.cuda.max_memory_allocated())
    return peaks


def _lazy_zeros(shape, dtype):
    """A zero CPU tensor whose pages are mapped when first touched (numpy's
    zeros): the probes' store, which holds ~10-20 GB of which a run touches
    the rows it swaps."""
    import numpy as np
    import torch
    nbytes = math.prod(shape) * torch.empty((), dtype=dtype).element_size()
    return torch.from_numpy(np.zeros(max(nbytes, 1), np.uint8))[
        :nbytes].view(dtype).view(tuple(shape))


def _peak_probe(torch, Trainer, cfg, layers) -> int:
    """The peak device memory of the arch's run at ``layers`` layers,
    ``ARCH_STEPS`` steps as the full-width run takes. Its store is held in
    pageable host memory, which the device's allocations do not depend on
    (a swap from it is synchronous, where pinned it is asynchronous): the
    probes then pin nothing (``offload.pinned_zeros`` took ~0.26 s a GiB
    on the host of an NVIDIA H100 80GB HBM3, 700 W machine) and touch only
    the rows they swap."""
    from repro_torch.core import offload
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    pinned = offload.pinned_zeros
    offload.pinned_zeros = _lazy_zeros
    try:
        tr = _arch_trainer(torch, Trainer, cfg.replace(num_layers=layers),
                           ARCH_STEPS)
    finally:
        offload.pinned_zeros = pinned
    peaks = _stepped_peaks(torch, tr, ARCH_STEPS)
    check(all(math.isfinite(x) for x in tr.log.losses),
          f"{cfg.name} at {layers} layers: losses {tr.log.losses}")
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    print(f"  peak at {layers} layers: {max(peaks) / 2**30:.2f} GiB (steps "
          f"{[round(p / 2**30, 2) for p in peaks]}; "
          f"{time.perf_counter() - t0:.1f} s with the state's set-up)")
    return max(peaks)


def phase_arch_training(torch, ops, lm, cfg, Trainer) -> dict | None:
    """The arch at full width, banked host bf16 moments, ``ARCH_STEPS``
    steps: first the peaks at the two depths of ``ARCH_TRAIN`` and their
    per-layer slope extrapolated to the full depth, and the host store's
    bytes beside the host's available memory. An extrapolated peak above
    ``PEAK_LIMIT_GIB`` fails the phase, and so does a store the host cannot
    hold, except for yi-9b, whose run is then skipped with both figures
    printed (decided here, before the full-width run). Returns the run's
    launches, median step, peak and profile (None when skipped)."""
    from repro_torch.core import partition as part_mod
    from repro_torch.core.offload import resident_opt_bytes
    k_percent, gate, (l1, l2) = ARCH_TRAIN[cfg.name]
    nl = cfg.num_layers
    n_params = sum(math.prod(s) for s in _leaves(lm.param_shapes(cfg)))
    store = 4 * n_params               # bf16 m and v
    print(f"training {cfg.name} ({nl} layers, d_model {cfg.d_model}, "
          f"{cfg.padded_heads} q / {cfg.num_kv_heads} kv heads, head dim "
          f"{cfg.head_dim}, partial rotary {cfg.partial_rotary_factor}, QKV "
          f"bias {cfg.attn_bias}, {n_params:,} params, bf16): adagradselect "
          f"k {k_percent:g}%, gate_weight_grads {gate}, banked residency, "
          f"offload host (pinned), bf16 moments, batch "
          f"{TRAIN['global_batch']} x {TRAIN['seq_len']}, {ARCH_STEPS} steps")
    p1 = _peak_probe(torch, Trainer, cfg, l1)
    p2 = _peak_probe(torch, Trainer, cfg, l2)
    slope = (p2 - p1) / (l2 - l1)
    est = p2 + slope * (nl - l2)
    avail, mem = _host_available()
    print(f"  per-layer slope {slope / 2**30:.4f} GiB; extrapolated to {nl} "
          f"layers {est / 2**30:.2f} GiB (limit {PEAK_LIMIT_GIB:g} GiB); host "
          f"store {store:,} B = {store / 2**30:.2f} GiB of bf16 m and v "
          f"against {avail / 2**30:.2f} GiB available (free -g: {mem})")
    why = []
    if est > PEAK_LIMIT_GIB * 2**30:
        why.append(f"the extrapolated peak {est / 2**30:.2f} GiB exceeds "
                   f"{PEAK_LIMIT_GIB:g} GiB")
    if store > avail - HOST_MARGIN_GIB * 2**30:
        why.append(f"the host store {store / 2**30:.2f} GiB does not fit in "
                   f"the {avail / 2**30:.2f} GiB available less "
                   f"{HOST_MARGIN_GIB:g}")
    if why and cfg.name == YI:
        print(f"  {cfg.name} full-width training SKIPPED before its run: "
              f"{'; '.join(why)}")
        return None
    check(not why, f"{cfg.name}: {'; '.join(why)}")
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    tr = _arch_trainer(torch, Trainer, cfg, ARCH_STEPS)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    pn = part_mod.build_partition(cfg)
    layers = next(g for g in pn.groups if g.key == "layers")
    k = tr.sel_cfg.num_selected(pn.num_blocks)
    opt = tr.state["opt"]
    res = resident_opt_bytes(opt)
    stored = part_mod.leaves(opt["store"])
    check(all(t.is_pinned() and t.dtype == torch.bfloat16 for t in stored),
          f"{cfg.name}: the host store is not pinned bf16")
    check(sum(t.numel() * t.element_size() for t in stored) == store,
          f"{cfg.name}: host store bytes != {store}")
    avail_run, mem_run = _host_available()
    print(f"  init {init_s:.2f} s; optimizer state: device "
          f"{res['device']:,} B, host {res['host']:,} B; host available "
          f"{avail_run / 2**30:.2f} GiB with the store pinned (free -g: "
          f"{mem_run})")
    masks = _record_masks(tr)
    ops.reset_launches()                     # the main path's run
    peaks = _stepped_peaks(torch, tr, ARCH_STEPS)
    launches = dict(ops.LAUNCHES)
    peak = max(peaks)
    log = tr.log
    check(len(log.losses) == ARCH_STEPS
          and all(math.isfinite(x) for x in log.losses),
          f"{cfg.name}: losses {log.losses}")
    host_masks = [m.cpu() for m in masks]
    check(all(int(m.sum()) == k for m in host_masks),
          f"{cfg.name}: selected per step "
          f"{[int(m.sum()) for m in host_masks]}, want {k}")
    counts = opt["counts"].cpu()
    check(torch.equal(counts, torch.stack(host_masks).float().sum(dim=0)),
          f"{cfg.name}: opt counts {counts.tolist()} != summed masks")
    adamw = "banked_masked_adamw_bf16m"
    leaves = len(list(_leaves(tr.state["params"]["layers"])))
    if gate:
        want = _gated_expected(host_masks, nl, layers.start, adamw, leaves)
    else:
        want = {n: c * ARCH_STEPS for n, c in _train_launches(
            nl, adamw, leaves=leaves).items()}
    check(launches == want, f"{cfg.name}: launches {launches} != the "
          f"path's {want}")
    warm = TRAIN["warmup"]
    med = statistics.median(log.step_times[warm:])
    tokens = TRAIN["global_batch"] * TRAIN["seq_len"]
    frozen = [nl - int(m[layers.start:layers.start + nl].sum())
              for m in host_masks]
    print(f"  losses: {[round(x, 4) for x in log.losses]}")
    print(f"  step time (median of steps {warm}..{ARCH_STEPS - 1}): "
          f"{med * 1e3:.2f} ms = {tokens / med:.0f} tokens/s; all steps "
          f"(ms): {[round(t * 1e3, 2) for t in log.step_times]}")
    print(f"  peak device memory: {peak / 2**30:.2f} GiB (steps "
          f"{[round(p / 2**30, 2) for p in peaks]}; extrapolated "
          f"{est / 2**30:.2f}: {100 * (est - peak) / peak:+.1f}%)")
    print(f"  k = {k} of {pn.num_blocks} blocks a step; frozen layers a "
          f"step {frozen if gate else 'none (no gate)'}; counts = summed "
          f"masks {counts.int().tolist()}")
    print(f"  swap stats: {json.dumps(tr.step_fn.swap_stats.as_dict())}")
    print(f"  launches in the {ARCH_STEPS} steps = the path's: "
          f"{json.dumps(launches)}")
    prof = _profile_training(torch, tr, host_ops=False)
    del tr, masks, host_masks, opt, stored
    gc.collect()
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": med * 1e3, "peak": peak,
            "estimate": est, "profile": prof}


def phase_arch_serving(torch, ops, lm, ServeEngine, ServeConfig, Request,
                       get_config) -> list:
    """Phase 4's serving cell on each of the three archs at full width
    (lean: the warm-up run profiled, device activity only); qwen2.5-32b's
    peak beside the one reckoned."""
    runs = []
    for arch in (GLM, YI, QWEN32):
        gc.collect()
        torch.cuda.empty_cache()
        run = phase_serving(torch, ops, lm, get_config(arch), ServeEngine,
                            ServeConfig, Request, lean=True)
        if arch == QWEN32:
            lo, hi = QWEN32_PEAK_GIB
            print(f"  {arch} serving peak {run['peak'] / 2**30:.2f} GiB "
                  f"against the reckoned {lo:g}-{hi:g} GiB (62.3 GiB of "
                  f"bf16 weights, 0.54 GB of KV pool)")
        runs.append(run)
    gc.collect()
    torch.cuda.empty_cache()
    return runs


def phase_arch_consistency(torch, ops, lm, Trainer, ServeEngine,
                           ServeConfig, Request, get_config) -> None:
    """Each arch's head-layout variant (its own q/kv heads, head dim,
    partial rotary, bias and ``pad_heads_to`` at d_model 256, d_ff 256,
    vocab 256, 2 layers) in f32: phase 25's checks, losses within 1e-5; a
    greedy token where the teacher-forced prefill's top two logits are
    within ``TOL["float32"]`` (relative) of each other may be either (a tie
    at f32 rounding: at these widths the logits sit close together)."""
    for arch in (GLM, YI, QWEN32):
        full = get_config(arch)
        variant = full.replace(d_model=256, d_ff=256, vocab_size=256,
                               head_dim=full.head_dim)
        phase_model_consistency(torch, ops, lm, variant, Trainer,
                                ServeEngine, ServeConfig, Request,
                                loss_rtol=1e-5, tie_rtol=TOL["float32"])


class _Phases:
    """The running phase's name, and the seconds each finished phase took
    (host clock, from its start to the next phase's)."""

    def __init__(self):
        self.name, self.t0, self.seconds = "start", time.perf_counter(), {}

    def start(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[self.name] = round(now - self.t0, 1)
        print(f"[phase {self.name!r}: {self.seconds[self.name]} s]",
              flush=True)
        self.name, self.t0 = name, now


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
        from repro_torch.kernels import decode_attention as _dec
        from repro_torch.kernels import flash_attention as _fa
        from repro_torch import obs, serve
        from repro_torch.launch import inspect
        from repro_torch.models import lm
        from repro_torch.serve import Request, ServeConfig, ServeEngine
        from repro_torch.train import evaluate, step
        from repro_torch.train.trainer import Trainer
    except ImportError as e:
        print(f"chip_smoke: the repro_torch package is not beside this "
              f"script ({e})", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 products in f32
    torch.backends.cudnn.allow_tf32 = False
    phase = _Phases()
    try:
        phase.start("card")
        phase_card()
        phase.start("build")
        phase_build(_build)
        phase.start("kernels")
        main_rows = phase_kernels(torch, ops, ref, Timer(torch))
        phase.start("serving")
        cfg = get_config(ARCH)
        serving = phase_serving(torch, ops, lm, cfg, ServeEngine,
                                ServeConfig, Request)
        phase.start("consistency")
        consistency = phase_consistency(torch, ops, lm, cfg, ServeEngine,
                                        ServeConfig, Request)
        phase.start("train kernels")
        main_rows.update(phase_train_kernels(torch, ops, ref, Timer(torch)))
        phase.start("training")
        training = phase_training(torch, ops, cfg, Trainer)
        phase.start("train consistency")
        phase_train_consistency(torch, ops, cfg, Trainer)
        phase.start("banked kernel")
        main_rows.update(phase_banked_kernel(torch, ops, ref, Timer(torch)))
        phase.start("banked training")
        banked = phase_banked_training(torch, ops, cfg, Trainer, training)
        phase.start("banked consistency")
        phase_banked_consistency(torch, ops, cfg, Trainer)
        phase.start("flash kernels")
        main_rows.update(phase_flash_kernels(torch, ops, ref, _fa,
                                             Timer(torch)))
        phase.start("packed training")
        packed = phase_packed_training(torch, ops, cfg, Trainer, loader,
                                       training)
        phase.start("packed consistency")
        phase_packed_consistency(torch, ops, cfg, Trainer, loader, lm, step)
        phase.start("decode kernel")
        main_rows.update(phase_decode_kernel(torch, ops, ref, _dec,
                                             Timer(torch)))
        phase.start("eval")
        evaluation = phase_eval(torch, ops, cfg, evaluate, training)
        phase.start("gated training")
        gated = phase_gated_training(torch, ops, cfg, Trainer, training,
                                     banked)
        phase.start("gated rounds")
        rounds = phase_gated_rounds(torch, ops, cfg, Trainer)
        phase.start("gated consistency")
        phase_gated_consistency(torch, ops, cfg, Trainer)
        runs = []       # the new models' main-path runs, for the summary
        phase.start("llama training")
        llama_cfg = get_config(LLAMA)
        llama = phase_training(torch, ops, llama_cfg, Trainer)
        runs.append(llama)
        phase.start("llama eval")
        runs.append(phase_eval(torch, ops, llama_cfg, evaluate, llama))
        llama["eval_params"] = None
        phase.start("llama consistency")
        phase_model_consistency(torch, ops, lm, llama_cfg, Trainer,
                                ServeEngine, ServeConfig, Request)
        phase.start("phi4 training")
        phi4_cfg = get_config(PHI4)
        phi4 = phase_training(torch, ops, phi4_cfg, Trainer,
                              steps=PHI4_STEPS, keep_eval=False)
        runs.append(phi4)
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("phi4 serving")
        runs.append(phase_serving(torch, ops, lm, phi4_cfg, ServeEngine,
                                  ServeConfig, Request))
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("phi4 consistency")
        phase_model_consistency(torch, ops, lm, phi4_cfg, Trainer,
                                ServeEngine, ServeConfig, Request,
                                layers=PHI4_CONSISTENCY_LAYERS)
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("bf16 moments training")
        bf16m = phase_bf16_moments(torch, ops, cfg, Trainer, training,
                                   banked)
        runs += [bf16m["dense"], bf16m["banked"]]
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("phi4 bf16 moments")
        phi4_bf16 = phase_training(torch, ops, phi4_cfg, Trainer,
                                   steps=PHI4_BF16_STEPS, keep_eval=False,
                                   moment_dtype="bfloat16")
        runs.append(phi4_bf16)
        print(f"phi4-mini peak with bf16 moments: "
              f"{phi4_bf16['peak'] / 2**30:.2f} GiB (f32 moments, phase 23: "
              f"{phi4['peak'] / 2**30:.2f} GiB)")
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("bf16 moments consistency")
        phase_train_consistency(torch, ops, cfg, Trainer,
                                moment_dtype="bfloat16")
        phase.start("checkpoint")
        phase_checkpoint(torch, Trainer, cfg.replace(num_layers=CKPT_LAYERS))
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("serving stack")
        stack = phase_serving_stack(torch, ops, lm, cfg, serve)
        runs += [stack, stack["chunked"], stack["dense"]]
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("observability")
        phase_observability(torch, ops, lm, cfg, Trainer, loader, serve, obs,
                            inspect)
        phase.start("lora training")
        runs.append(phase_lora(torch, ops, cfg, Trainer, training,
                               rounds["median_ms"]["full"]))
        gc.collect()
        torch.cuda.empty_cache()
        phase.start("arch kernels")
        phase_arch_kernels(torch, ops, ref, Timer(torch))
        phase.start("chatglm training")
        runs.append(phase_arch_training(torch, ops, lm, get_config(GLM),
                                        Trainer))
        phase.start("yi training")
        yi = phase_arch_training(torch, ops, lm, get_config(YI), Trainer)
        if yi is not None:
            runs.append(yi)
        phase.start("arch serving")
        runs += phase_arch_serving(torch, ops, lm, ServeEngine, ServeConfig,
                                   Request, get_config)
        phase.start("arch consistency")
        phase_arch_consistency(torch, ops, lm, Trainer, ServeEngine,
                               ServeConfig, Request, get_config)
    except Exception:   # the boundary: report the failed phase, exit non-zero
        traceback.print_exc()
        print(f"chip_smoke: phase {phase.name!r} FAILED", file=sys.stderr)
        return 1
    sources = {"paged_decode_attention": (
        "cuda", "src/repro_torch/csrc/decode_attention.cu",
        "src/repro/kernels/decode_attention.py:95"),
        "decode_attention": (
            "cuda", "src/repro_torch/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:24"),
        "rmsnorm": ("cuda", "src/repro_torch/csrc/rmsnorm.cu",
                    "src/repro/kernels/rmsnorm.py:13"),
        # no TPU kernel: the JAX package differentiates norms.apply in XLA;
        # this is the TPU kernel whose forward it completes
        "rmsnorm_bwd": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                        "src/repro/kernels/rmsnorm.py:13"),
        # its dx-only mode: a frozen layer's norm under gated weight
        # gradients
        "rmsnorm_bwd_dx": ("triton", "src/repro_torch/kernels/rmsnorm.py",
                           "src/repro/kernels/rmsnorm.py:13"),
        "block_grad_sq_norms": (
            "triton", "src/repro_torch/kernels/block_grad_norm.py",
            "src/repro/kernels/block_grad_norm.py:21"),
        "masked_adamw": ("triton", "src/repro_torch/kernels/masked_adamw.py",
                         "src/repro/kernels/masked_adamw.py:34"),
        "banked_masked_adamw": (
            "triton", "src/repro_torch/kernels/masked_adamw.py",
            "src/repro/kernels/masked_adamw.py:80"),
        # rows 8 and 9 with bf16 moments: the same sources, counted apart
        "masked_adamw_bf16m": (
            "triton", "src/repro_torch/kernels/masked_adamw.py",
            "src/repro/kernels/masked_adamw.py:34"),
        "banked_masked_adamw_bf16m": (
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
    phase.start("summary")
    print(f"phase seconds: {json.dumps(phase.seconds)}")
    kernels = []
    for name, (route, source, replaces) in sources.items():
        r = main_rows[name]
        # launches of the main-path runs: serving (phase 4) + training (7),
        # the banked training window (phase 10) for the banked kernel, and
        # training (7), banked training (10) and packed training (13) for
        # the flash kernels, the dense serving run of phase 5 and the eval
        # (16) for the dense decode kernel, the gated runs (17) for the
        # RMSNorm backward's dx-only mode; and for every kernel the new
        # models' runs (phases 20, 21, 23 and 24), the bf16-moment runs
        # (phases 26 and 27), the serving stack's timed runs (phase 30:
        # engines A and B, the chunked paged run, the dense sampled run),
        # the LoRA run (phase 32) and the other dense archs' training runs
        # (phases 34, 35) and serving runs (36), zero where it is off their
        # path
        launches = sum(run["launches"][name] for run in runs)
        if name == "rmsnorm_bwd_dx":
            launches += gated["launches"][name]
        elif name == "decode_attention":
            launches += (consistency["dense_launches"][name]
                         + evaluation["launches"][name])
        elif name == "banked_masked_adamw":
            launches += banked["launches"][name]
        elif name.startswith("flash"):
            launches += (training["launches"][name]
                         + banked["launches"][name]
                         + packed["launches"][name])
        else:
            launches += (serving["launches"][name]
                         + training["launches"][name])
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
