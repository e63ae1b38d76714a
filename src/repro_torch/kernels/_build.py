"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``). The library's file name carries a
hash of the source and the flags, so an edited source is rebuilt and a stale
library is never loaded. A failed build raises ``KernelBuildFailure``;
nothing falls back.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # source name -> nvcc/ptxas output


class KernelBuildFailure(RuntimeError):
    """A kernel source did not compile or its library did not load."""


def sources() -> list[str]:
    return sorted(p.name for p in CSRC.glob("*.cu"))


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise KernelBuildFailure(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin, default "
        "/usr/local/cuda/bin): the CUDA kernels of repro_torch are built "
        "from csrc/ at first use and need the CUDA toolkit")


def _target(name: str) -> Path:
    h = hashlib.sha256((CSRC / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{Path(name).stem}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>`` unless its library is there; returns the
    library's path."""
    out = _target(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".tmp{os.getpid()}.so")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / name)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=BUILD_TIMEOUT_S)
        BUILD_LOG[name] = proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise KernelBuildFailure(f"nvcc failed on {name} (exit "
                                     f"{proc.returncode}):\n{BUILD_LOG[name]}")
        os.replace(tmp, out)
    except subprocess.TimeoutExpired as e:
        raise KernelBuildFailure(
            f"nvcc on {name} took more than {BUILD_TIMEOUT_S}s") from e
    finally:
        tmp.unlink(missing_ok=True)
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>``, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = build(name)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise KernelBuildFailure(f"could not load {path}: {e}") from e
        _LIBS[name] = lib
    return lib
