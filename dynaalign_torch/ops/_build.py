"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled on its
own with ``nvcc`` for Hopper (``sm_90a``) into a shared library under
``build/kernels/`` at the repository root, named by the hash of its source,
of every header ``csrc/*.cuh`` and of the flags, so an edited source or
header is rebuilt and an unchanged one is reused.
:func:`build_all` starts one ``nvcc`` per source that needs it, all at
once.  The libraries are loaded with ``ctypes``.  A failed build raises:
there is no fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
import hashlib
import os
import shutil
import subprocess

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "kernels")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclasses.dataclass(frozen=True)
class Built:
    path: str
    log: str  # nvcc's output (ptxas registers/spills); "" when reused


def nvcc_path() -> str:
    """``$CUDA_HOME/bin/nvcc`` (default /usr/local/cuda), else PATH."""
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            f"nvcc not found (looked in {cand} and PATH); the CUDA kernels "
            "are built at first use and need the CUDA toolkit"
        )
    return found


def sources() -> list[str]:
    """The names of every ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def target(name: str) -> str:
    """The library path for ``csrc/<name>.cu`` at its current content and
    that of the headers ``csrc/*.cuh``, any of which it may include."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(f for f in os.listdir(CSRC) if f.endswith(".cuh"))
    for fname in [f"{name}.cu", *headers]:
        with open(os.path.join(CSRC, fname), "rb") as f:
            h.update(fname.encode() + b"\0" + f.read() + b"\0")
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def nvcc_command(name: str, out: str) -> list[str]:
    return [nvcc_path(), *NVCC_FLAGS, "-o", out,
            os.path.join(CSRC, f"{name}.cu")]


def build_all(names: list[str] | None = None) -> dict[str, Built]:
    """Build each of ``names`` (default: every source) whose library is not
    there yet, one ``nvcc`` process each, all started together; wait for
    all of them, then raise if any failed."""
    names = sources() if names is None else names
    done, running = {}, {}
    for name in names:
        out = target(name)
        if os.path.exists(out):
            done[name] = Built(out, "")
            continue
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{out}.{os.getpid()}.tmp"
        running[name] = (out, tmp, subprocess.Popen(
            nvcc_command(name, tmp), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    failed = []
    for name, (out, tmp, proc) in running.items():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"nvcc failed on {name}.cu:\n{log}")
            continue
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or none
        done[name] = Built(out, log)
    if failed:
        raise RuntimeError("\n".join(failed))
    return {name: done[name] for name in names}


def build(name: str) -> Built:
    """Build ``csrc/<name>.cu`` unless its library is already there."""
    return build_all([name])[name]


def load(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(name).path)
