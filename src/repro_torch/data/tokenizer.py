"""Byte-level tokenizer for the real-data (jsonl) path — no external deps
(a copy of the JAX package's ``data/tokenizer.py``).

ids: 0 PAD, 1 BOS, 2 EOS, 3..258 = bytes 0..255.
"""
from __future__ import annotations

import numpy as np

PAD, BOS, EOS = 0, 1, 2
OFFSET = 3
VOCAB_SIZE = 256 + OFFSET


def encode(text: str, add_bos: bool = True, add_eos: bool = True) -> np.ndarray:
    b = list(text.encode("utf-8"))
    ids = ([BOS] if add_bos else []) + [x + OFFSET for x in b] + ([EOS] if add_eos else [])
    return np.asarray(ids, np.int32)


def decode(ids) -> str:
    bs = bytes(int(i) - OFFSET for i in ids if int(i) >= OFFSET)
    return bs.decode("utf-8", errors="replace")
