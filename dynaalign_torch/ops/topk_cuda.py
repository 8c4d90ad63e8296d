"""Wrapper of the CUDA top-k kernel ``csrc/minhash_topk.cu``.

For rows start:stop of a signature tensor on the card it returns, in one
launch, what the plain version, ``topk_graph._topk_plain``, returns: each
row's k columns with the most agreeing slots, the row itself left out,
equal counts lowest column first.  The kernel takes n_hash up to
``MAX_N_HASH``, k up to ``MAX_K`` and N up to ``MAX_N``, read from the
source (:func:`kernel_takes`); :func:`topk_rows` raises past them before
any launch.  Each launch is a span ``minhash_topk``, which counts it and
its ``rows``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import re

import torch

from ..utils.profiling import span
from . import _build


def _define(name: str) -> int:
    with open(os.path.join(_build.CSRC, "minhash_topk.cu")) as f:
        return int(re.search(rf"#define {name} (\d+)", f.read())[1])


MAX_K = _define("MH_KMAX")
MAX_N_HASH = _define("MH_HMAX")
MAX_N = _define("MH_NMAX")

_VP, _INT = ctypes.c_void_p, ctypes.c_int
# sig, N, H, start, stop, k, out_cnt, out_idx, stream
LAUNCH_ARGTYPES = (_VP, _INT, _INT, _INT, _INT, _INT, _VP, _VP, _VP)


@functools.cache
def _launch():
    fn = _build.load("minhash_topk").minhash_topk_launch
    fn.argtypes = list(LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn


def kernel_takes(n: int, n_hash: int, k: int) -> bool:
    """Whether the kernel serves a top-k of ``k`` over N = ``n`` signatures
    of ``n_hash`` slots."""
    return 1 <= k <= MAX_K and 1 <= n_hash <= MAX_N_HASH and n <= MAX_N


def topk_rows(sigs: torch.Tensor, start: int, stop: int, k: int):
    """(counts, neighbour indices), both int64 [stop - start, k] on the
    card, of rows start:stop of ``sigs``, an int32 [N, H] CUDA tensor with
    0 <= start <= stop <= N and k <= N, in one launch.  Raises ValueError
    past the kernel's limits; no other version runs on the card."""
    n, n_hash = sigs.shape
    if not kernel_takes(n, n_hash, k):
        raise ValueError(
            f"the top-k kernel takes k <= {MAX_K}, n_hash <= {MAX_N_HASH} "
            f"and N <= {MAX_N}, got k={k}, n_hash={n_hash}, N={n}; "
            "device='cpu' takes any")
    sigs = sigs.contiguous()
    dev = sigs.device
    cnt = torch.empty((stop - start, k), dtype=torch.int32, device=dev)
    idx = torch.empty_like(cnt)
    with torch.cuda.device(dev), span("minhash_topk", rows=stop - start):
        rc = _launch()(sigs.data_ptr(), n, n_hash, start, stop, k,
                       cnt.data_ptr(), idx.data_ptr(),
                       torch.cuda.current_stream(dev).cuda_stream)
        if rc != 0:
            raise RuntimeError(f"minhash_topk launch failed: CUDA error {rc}")
    return cnt.long(), idx.long()
