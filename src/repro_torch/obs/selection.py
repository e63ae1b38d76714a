"""Selection telemetry: the paper-facing per-block time series (a copy of
the JAX package's ``obs/selection.py``).

``SelectionTrace`` accumulates, once per trainer step, the block-selection
mask and (optionally) the per-block gradient-norm snapshot the policy saw
at that selection boundary. The running ``counts`` vector is the sum of
recorded masks — by construction the same accumulation
``masked_adamw.update`` / ``banked_update`` perform on
``state["opt"]["counts"]`` (``counts + mask`` per step), so telemetry and
optimizer state must agree exactly at every boundary (pinned in
tests/test_torch_obs.py). Masks are integer-valued, so the float
accumulation is exact far beyond any realistic step count.

Recording happens in the trainer and only when obs is enabled: pulling the
mask off the card is a host sync, which the disabled-mode contract forbids
adding.
"""
from __future__ import annotations

import threading

import numpy as np


class SelectionTrace:
    def __init__(self):
        self._lock = threading.Lock()
        self._steps: list[int] = []
        self._masks: list[np.ndarray] = []
        self._norms: list[np.ndarray | None] = []
        self._counts: np.ndarray | None = None

    def record(self, step: int, mask, block_norms=None) -> None:
        mask = np.asarray(mask).astype(bool)
        norms = (None if block_norms is None
                 else np.asarray(block_norms, np.float64).copy())
        with self._lock:
            if self._counts is None:
                self._counts = np.zeros(mask.shape, np.float64)
            self._counts += mask
            self._steps.append(int(step))
            self._masks.append(mask.copy())
            self._norms.append(norms)

    def __len__(self) -> int:
        return len(self._steps)

    @property
    def num_blocks(self) -> int:
        return 0 if self._counts is None else int(self._counts.shape[0])

    @property
    def counts(self) -> np.ndarray:
        """Cumulative per-block selection counts over the recorded steps —
        must equal ``state["opt"]["counts"]`` when recording started at
        step 0."""
        with self._lock:
            return (np.zeros((0,)) if self._counts is None
                    else self._counts.copy())

    def masks(self) -> np.ndarray:
        """[T, num_blocks] bool: the per-step selection series."""
        with self._lock:
            return (np.zeros((0, 0), bool) if not self._masks
                    else np.stack(self._masks))

    def norms(self) -> np.ndarray | None:
        """[T, num_blocks] gradient-norm snapshots, or None if never
        provided."""
        with self._lock:
            if not self._norms or all(n is None for n in self._norms):
                return None
            nb = self._counts.shape[0]
            return np.stack([n if n is not None else np.full(nb, np.nan)
                             for n in self._norms])

    def snapshot(self) -> dict:
        """JSON-able document (embedded in ``obs.snapshot()`` under the
        ``"selection"`` key and consumed by ``launch/inspect.py``)."""
        with self._lock:
            norms = [None if n is None else n.tolist() for n in self._norms]
            return {
                "steps": list(self._steps),
                "counts": ([] if self._counts is None
                           else self._counts.tolist()),
                "masks": [m.astype(int).tolist() for m in self._masks],
                "block_norms": norms,
            }

    @staticmethod
    def from_snapshot(doc: dict) -> "SelectionTrace":
        tr = SelectionTrace()
        for i, step in enumerate(doc.get("steps", [])):
            norms = (doc.get("block_norms") or [None] * (i + 1))[i]
            tr.record(step, np.asarray(doc["masks"][i], bool), norms)
        return tr
