"""Checkpoints of the port's TrainState (port of the JAX package's
``checkpoint/manager.py``, one process).

The contract is the reference's:

  * atomic   — write ``<dir>/tmp.<step>.<pid>``, fsync ``meta.json``, rename
               to ``<dir>/step_<%08d>``
  * async    — the snapshot is taken on the caller's thread; serialisation
               runs on a writer thread, one save in flight, and the writer's
               exception is raised at the next ``wait()``
  * keep-k   — older steps are removed after a successful save
  * layout   — one ``proc_0.npz`` keyed by the reference's "/"-joined leaf
               paths (``utils/trees.path_str``), and ``meta.json`` with
               ``step``, ``time``, ``process_count`` and the caller's
               ``extra_meta`` (the trainer's ``data_cursor``). So one reader
               serves the files of either package.

The port's state differs from the reference's in four leaves, which are
written in the reference's form: the selection state's ``seed`` (a Python
int up to 2^64 - 1) as ``sel/key``, the reference's uint32 [2] PRNG key
(``key[0] << 32 | key[1]``, the inverse of ``convert.train_state_from_numpy``);
the host ints ``step`` and ``sel/step`` as 0-d int32; the int64 block ids
``sel/indices`` as int32. The converter's ``sel/jax_key`` is not written (it
is ``sel/key``). A bf16 tensor is written as its uint16 bits, so no
``ml_dtypes`` is needed; the reference's writer stores ``ml_dtypes.bfloat16``
as raw 2-byte void (``|V2``). On restore every 2-byte leaf is viewed by the
*target's* dtype, whichever of the two the file holds, and each leaf's shape
and dtype are checked against the target: a bf16 leaf restored into an f32
one, or the reverse, raises with the leaf's path instead of being cast.

The snapshot. Rows 8 and 9 update p, m and v in place, and the banked
boundary writes the pinned host store in place with asynchronous copies, so
a checkpoint must own a copy that later steps cannot change. ``save`` copies
every tensor leaf into a host buffer: device leaves with asynchronous
copies on the current stream into pinned buffers, then one
``torch.cuda.synchronize()`` (which also completes the boundary's pending
copies into the pinned store), then the host leaves (the store) with plain
copies. The buffers are kept for the next save, since pinning gigabytes
costs seconds; ``wait()`` before each save ensures the writer is done with
them. The caller quiesces the swap planner first. ``last_save`` records the
stall the save added to the caller's loop (the wait on the previous writer
and the snapshot, each also on its own), the writer's seconds and the bytes
on disk.

``restore`` returns the state on the host (CPU tensors, numpy arrays, ints)
in the structure of ``target``; the trainer places it
(``Trainer.maybe_restore``).
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

SEED, KEY, DROPPED = "sel/seed", "sel/key", ("sel/jax_key",)
_U32 = (1 << 32) - 1


def flatten(tree, prefix: str = "") -> list:
    """(path, leaf) pairs of a nested dict, paths "/"-joined."""
    if isinstance(tree, dict):
        out = []
        for k, v in tree.items():
            out += flatten(v, f"{prefix}/{k}" if prefix else str(k))
        return out
    return [(prefix, tree)]


def unflatten(flat: dict) -> dict:
    """A nested dict from "/"-joined paths (the inverse of ``flatten``)."""
    out: dict = {}
    for path, leaf in flat.items():
        *head, last = path.split("/")
        node = out
        for k in head:
            node = node.setdefault(k, {})
        node[last] = leaf
    return out


def _host_int(path: str, value: int) -> np.ndarray:
    if not -(1 << 31) <= value < (1 << 31):
        raise ValueError(f"checkpoint leaf {path!r}: {value} does not fit "
                         f"the int32 the reference keeps it in")
    return np.asarray(value, np.int32)


def seed_to_key(seed: int) -> np.ndarray:
    """The port's selection seed as the reference's uint32 [2] PRNG key."""
    return np.array([(seed >> 32) & _U32, seed & _U32], np.uint32)


def _to_numpy(leaf) -> np.ndarray:
    """One snapshot leaf in the file's layout (on the writer thread)."""
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16:
            return leaf.view(torch.uint16).numpy()
        if leaf.dtype == torch.int64:   # the block ids: int32 in the file
            return leaf.numpy().astype(np.int32)
        return leaf.numpy()
    return leaf


def _check(path: str, arr: np.ndarray, shape: tuple, want: str, ok: bool):
    if tuple(arr.shape) != tuple(shape):
        raise ValueError(f"checkpoint leaf {path!r}: shape "
                         f"{tuple(arr.shape)} != the target's {tuple(shape)}")
    if not ok:
        raise ValueError(f"checkpoint leaf {path!r}: dtype {arr.dtype} does "
                         f"not hold the target's {want} (no leaf is cast on "
                         f"restore)")


def _tensor_from(path: str, arr: np.ndarray, like: torch.Tensor):
    """A CPU tensor of ``like``'s dtype from a file leaf, checked."""
    dt = like.dtype
    if dt == torch.bfloat16:
        # uint16 bits (the port's writer) or |V2 (the reference's)
        _check(path, arr, like.shape, "bfloat16",
               arr.dtype.itemsize == 2 and arr.dtype.kind in "uV")
        return torch.from_numpy(_writable(arr).view(np.uint16)).view(dt)
    disk = {torch.int64: np.dtype(np.int32)}.get(
        dt, torch.empty((), dtype=dt).numpy().dtype)
    _check(path, arr, like.shape, str(dt), arr.dtype == disk)
    t = torch.from_numpy(_writable(arr))
    return t.to(dt) if t.dtype != dt else t


def _writable(arr: np.ndarray) -> np.ndarray:
    return arr if arr.flags.writeable else arr.copy()


def _restore_leaf(path: str, like, flat: dict):
    if path == SEED:
        key = _pick(KEY, flat)
        _check(KEY, key, (2,), "uint32", key.dtype == np.uint32)
        return (int(key[0]) << 32) | int(key[1])
    arr = _pick(path, flat)
    if isinstance(like, torch.Tensor):
        return _tensor_from(path, arr, like)
    if isinstance(like, np.ndarray):
        _check(path, arr, like.shape, str(like.dtype), arr.dtype == like.dtype)
        return np.array(arr)
    if isinstance(like, int):
        _check(path, arr, (), "an integer", arr.dtype.kind in "iu")
        return int(arr)
    raise TypeError(f"checkpoint leaf {path!r}: unsupported target "
                    f"{type(like).__name__}")


def _pick(path: str, flat: dict) -> np.ndarray:
    try:
        return flat[path]
    except KeyError:
        raise KeyError(
            f"checkpoint has no leaf {path!r}: the saved TrainState predates "
            f"the current state schema or another method wrote it") from None


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None
        self._buffers: dict[str, torch.Tensor] = {}
        self.last_save: dict = {}
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------- save
    def save(self, step: int, state: dict, extra_meta: dict | None = None):
        """Snapshot ``state`` to host buffers now; serialise on the writer
        thread. The caller's loop stalls for the wait on the previous
        save's writer (``wait_s``) plus the snapshot: ``stall_s`` is both."""
        t0 = time.perf_counter()
        self.wait()   # one save in flight; the writer is done with buffers
        t1 = time.perf_counter()
        snap = self._snapshot(state)
        meta = {"step": int(step), "time": time.time(), "process_count": 1,
                **(extra_meta or {})}
        t2 = time.perf_counter()
        self.last_save = {"step": int(step), "wait_s": t1 - t0,
                          "snapshot_s": t2 - t1, "stall_s": t2 - t0}
        self._thread = threading.Thread(
            target=self._write, args=(step, snap, meta), daemon=True)
        self._thread.start()

    def _buffer(self, path: str, leaf: torch.Tensor) -> torch.Tensor:
        buf = self._buffers.get(path)
        if buf is None or buf.shape != leaf.shape or buf.dtype != leaf.dtype:
            buf = torch.empty(leaf.shape, dtype=leaf.dtype,
                              pin_memory=leaf.is_cuda)
            self._buffers[path] = buf
        return buf

    def _snapshot(self, state: dict) -> dict:
        """{path: host buffer, numpy array or np int} owned by the
        checkpoint. Device leaves are copied in stream order, then one
        synchronisation, then the host leaves."""
        snap, host, sync = {}, [], False
        for path, leaf in flatten(state):
            if path in DROPPED:
                continue
            if path == SEED:
                snap[KEY] = seed_to_key(int(leaf))
            elif isinstance(leaf, torch.Tensor):
                buf = self._buffer(path, leaf)
                if leaf.is_cuda:
                    buf.copy_(leaf, non_blocking=True)
                    sync = True
                else:
                    sync |= leaf.is_pinned()
                    host.append((buf, leaf))
                snap[path] = buf
            elif isinstance(leaf, np.ndarray):
                snap[path] = leaf.copy()
            elif isinstance(leaf, int):
                snap[path] = _host_int(path, leaf)
            else:
                raise TypeError(f"checkpoint leaf {path!r}: unsupported "
                                f"{type(leaf).__name__}")
        if sync:
            # the device copies above, and any asynchronous copy queued
            # into a pinned host leaf, complete here
            torch.cuda.synchronize()
        for buf, leaf in host:
            buf.copy_(leaf)
        return snap

    def _write(self, step: int, snap: dict, meta: dict):
        try:
            t0 = time.perf_counter()
            tmp = os.path.join(self.dir, f"tmp.{step}.{os.getpid()}")
            final = os.path.join(self.dir, f"step_{step:08d}")
            os.makedirs(tmp, exist_ok=True)
            npz = os.path.join(tmp, "proc_0.npz")
            np.savez(npz, **{p: _to_numpy(x) for p, x in snap.items()})
            nbytes = os.path.getsize(npz)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)
            self._gc()
            self.last_save.update(write_s=time.perf_counter() - t0,
                                  bytes=nbytes)
        except Exception as e:  # raised at the next wait()
            self._error = e

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _gc(self):
        steps = self.all_steps()
        for s in steps[: max(0, len(steps) - self.keep)]:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:08d}"),
                          ignore_errors=True)

    # ------------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def _step_dir(self, step: int | None) -> tuple[str, int]:
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        return os.path.join(self.dir, f"step_{step:08d}"), step

    def load_meta(self, step: int | None = None) -> dict:
        """The ``meta.json`` of a step (``save``'s ``extra_meta`` lands
        here, e.g. the trainer's data cursor)."""
        path, _ = self._step_dir(step)
        with open(os.path.join(path, "meta.json")) as f:
            return json.load(f)

    def load_flat(self, step: int | None = None) -> tuple[dict, int]:
        """({path: numpy array} as the file holds them, step)."""
        path, step = self._step_dir(step)
        flat: dict[str, np.ndarray] = {}
        for name in sorted(os.listdir(path)):
            if name.endswith(".npz"):
                with np.load(os.path.join(path, name)) as z:
                    flat.update({k: z[k] for k in z.files})
        return flat, step

    def restore(self, target: dict, step: int | None = None):
        """-> (state, step): the checkpoint in the structure of ``target``
        (by default the latest step), on the host: CPU tensors of each
        target tensor's dtype, numpy arrays, ints. Raises on a missing
        leaf, or a leaf whose shape or dtype differs from the target's."""
        flat, step = self.load_flat(step)

        def walk(tree, prefix):
            if not isinstance(tree, dict):
                return _restore_leaf(prefix, tree, flat)
            out = {}
            for k, v in tree.items():
                path = f"{prefix}/{k}" if prefix else str(k)
                if path not in DROPPED:
                    out[k] = walk(v, path)
            return out
        return walk(target, ""), step
