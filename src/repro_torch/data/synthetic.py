"""Synthetic math-reasoning dataset — the offline proxy for MetaMathQA-40K
(a copy of the JAX package's ``data/synthetic.py``, with the answer parsers
``answer_of``/``decode_answer`` that the greedy eval reads).

Problems are multi-digit additions with a column-by-column chain-of-thought
and a final answer, emitted as token sequences with a loss mask covering only
the completion (CoT + answer). Everything is a pure numpy function of
(seed, index), so the port's batches are bit-equal to the reference's.

Token space (fits any vocab >= 32):
  0 PAD  1 BOS  2 EOS  3 '+'  4 '='  5 STEP  6 CARRY  7 ANS  8.. digits 0-9
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

PAD, BOS, EOS, PLUS, EQ, STEP, CARRY, ANS = range(8)
D0 = 8  # token id of digit 0


@dataclass(frozen=True)
class MathTaskConfig:
    digits: int = 3          # fixed-width operands (leading zeros)
    seq_len: int = 64
    seed: int = 1234
    eval_offset: int = 1 << 30  # index offset separating train/eval streams


def prompt_len(cfg: MathTaskConfig) -> int:
    # BOS a_digits + b_digits =
    return 1 + cfg.digits + 1 + cfg.digits + 1


def _digits_of(x: int, width: int) -> list[int]:
    return [D0 + int(c) for c in str(x).zfill(width)]


def sample_problem(cfg: MathTaskConfig, index: int) -> tuple[np.ndarray, np.ndarray]:
    """-> (tokens [seq_len], loss_mask [seq_len]). Deterministic in index."""
    rng = np.random.default_rng((cfg.seed, index))
    hi = 10 ** cfg.digits
    a, b = int(rng.integers(0, hi)), int(rng.integers(0, hi))
    toks = [BOS] + _digits_of(a, cfg.digits) + [PLUS] + _digits_of(b, cfg.digits) + [EQ]
    p_len = len(toks)
    # chain of thought: per-column sums with an ALWAYS-PRESENT carry digit,
    # least significant first — every sequence has the same length, which
    # keeps per-microbatch loss-mask counts equal (exact grad accumulation)
    carry = 0
    da, db = str(a).zfill(cfg.digits)[::-1], str(b).zfill(cfg.digits)[::-1]
    for i in range(cfg.digits):
        s = int(da[i]) + int(db[i]) + carry
        toks += [D0 + int(da[i]), PLUS, D0 + int(db[i]), CARRY, D0 + carry,
                 EQ, D0 + s // 10, D0 + s % 10, STEP]
        carry = s // 10
    toks += [ANS] + _digits_of(a + b, cfg.digits + 1) + [EOS]
    if len(toks) > cfg.seq_len:
        raise ValueError(f"seq_len {cfg.seq_len} too short for digits={cfg.digits} "
                         f"(need {len(toks)})")
    mask = np.zeros(cfg.seq_len, np.float32)
    mask[p_len:len(toks)] = 1.0
    out = np.full(cfg.seq_len, PAD, np.int32)
    out[:len(toks)] = toks
    return out, mask


def batch_at(cfg: MathTaskConfig, step: int, batch_size: int,
             eval_split: bool = False) -> dict:
    """Global batch for a step — a pure function, so data resume after
    restart/rescale is exact."""
    base = step * batch_size + (cfg.eval_offset if eval_split else 0)
    toks, masks = zip(*(sample_problem(cfg, base + i) for i in range(batch_size)))
    return {"tokens": np.stack(toks), "loss_mask": np.stack(masks)}


def answer_of(cfg: MathTaskConfig, index: int, eval_split: bool = True) -> int:
    rng = np.random.default_rng((cfg.seed, (cfg.eval_offset if eval_split else 0) + index))
    hi = 10 ** cfg.digits
    a, b = int(rng.integers(0, hi)), int(rng.integers(0, hi))
    return a + b


def decode_answer(tokens: np.ndarray) -> int | None:
    """Parse the digits following the ANS token of a generated sequence."""
    toks = list(np.asarray(tokens))
    if ANS not in toks:
        return None
    i = toks.index(ANS) + 1
    digits = []
    while i < len(toks) and D0 <= toks[i] <= D0 + 9:
        digits.append(toks[i] - D0)
        i += 1
    if not digits:
        return None
    return int("".join(map(str, digits)))
