"""Build-on-demand of the repository's C++ libraries (``cpp/*.cpp``).

The port binds three of them with ``ctypes``: the serial oracle
(:mod:`dynaalign_torch.oracle`), the greedy Louvain pass
(:mod:`dynaalign_torch.cluster._native`) and the MSA row DP
(:mod:`dynaalign_torch.consensus._native`).  Each is compiled with ``g++``
into ``build/<name>/`` at the repository root, named by the hash of its
sources and of the flags, so an edited source is rebuilt and an unchanged
one is reused.  A failed build raises: nothing falls back to another
implementation.

The flags are ``cpp/Makefile``'s without ``-fopenmp``, which a toolchain
without libgomp cannot link (the sources guard OpenMP with
``#ifdef _OPENMP``).  ``-std=c++17`` is strict ISO and so forbids
floating-point contraction, which the bit-compatibility of the Louvain
pass and the MSA row DP with their numpy twins rests on: no ``gnu++17``,
no ``-ffast-math``.
"""

from __future__ import annotations

import hashlib
import os
import subprocess

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
CPP_DIR = os.path.join(_ROOT, "cpp")
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-shared")


def build_library(name: str, sources: tuple[str, ...]) -> str:
    """Path of ``build/<name>/lib<name>-<hash>.so``, compiled from
    ``cpp/<sources[0]>`` if it is not there yet; the other ``sources`` are
    headers it includes, hashed with it."""
    paths = [os.path.join(CPP_DIR, f) for f in sources]
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for src in paths:
        with open(src, "rb") as f:
            h.update(f.read())
    build_dir = os.path.join(_ROOT, "build", name)
    so = os.path.join(build_dir, f"lib{name}-{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(build_dir, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run(["g++", *CXX_FLAGS, paths[0], "-o", tmp], check=True)
        os.replace(tmp, so)  # atomic: a concurrent loader sees all or none
    return so
