"""Build the port's CUDA sources at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by ``nvcc``
for ``sm_90a`` into its own shared library under ``build/kernels/`` at the
repository root (listed in ``.gitignore``). The library's file name carries a
hash of the source, of the shared headers (``csrc/*.cuh``) and of the flags,
so an edited source or header is rebuilt and a stale library is never
loaded. A failed build raises ``KernelBuildFailure``;
nothing falls back. ptxas's report (``-Xptxas -v``) is kept beside the
library; ``usage`` reads each kernel's registers and spills from it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_LIBS: dict[str, ctypes.CDLL] = {}
BUILD_LOG: dict[str, str] = {}   # source name -> nvcc/ptxas output


class KernelBuildFailure(RuntimeError):
    """A kernel source did not compile or its library did not load."""


class Usage(NamedTuple):
    kernel: str        # demangled where c++filt is on the PATH
    registers: int     # a thread
    spill_bytes: int   # spill stores + spill loads
    text: str          # ptxas's registers and spills lines


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
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
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
        out.with_suffix(".log").write_text(BUILD_LOG[name])
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


def ptxas_usage(log: str) -> list[Usage]:
    """Each entry function's registers and spills in ptxas's -v output,
    its name demangled where c++filt is on the PATH (templates and all,
    without the argument list)."""
    out, fn, spills = [], "?", ""
    for ln in log.splitlines():
        m = re.search(r"Function properties for (\S+)", ln)
        if m:
            fn = m.group(1)
        elif "spill" in ln:
            spills = ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = int(re.search(r"Used (\d+) registers", ln)[1])
            spilled = sum(int(b) for b in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", spills))
            out.append([fn, regs, spilled,
                        f"{ln.split(':', 1)[-1].strip()}; {spills}"])
            spills = ""
    if shutil.which("c++filt") and out:
        names = subprocess.run(["c++filt"], input="\n".join(
            row[0] for row in out), capture_output=True, text=True,
            timeout=60).stdout.splitlines()
        if len(names) == len(out):
            for row, nm in zip(out, names):
                row[0] = nm.replace("(anonymous namespace)::", "").split(
                    "(")[0].removeprefix("void ")
    return [Usage(*row) for row in out]


def usage(name: str) -> list[Usage]:
    """``ptxas_usage`` of ``csrc/<name>``'s build: this process's, or the
    report kept beside the library (built first if needed)."""
    log = BUILD_LOG.get(name)
    if log is None:
        kept = build(name).with_suffix(".log")
        log = kept.read_text() if kept.exists() else ""
    return ptxas_usage(log)
