"""The port's tensor operations: the MinHash stages (plain PyTorch on an
explicit device) and the batched NW dispatch, where the width picks the
kernel and its wrapper sends CUDA tensors to the kernel and CPU tensors to
the plain PyTorch version."""

from __future__ import annotations

import torch

from .minhash import (  # noqa: F401
    minhash_signatures,
    signature_agreement_counts,
    signature_similarity,
    signatures_to_numpy,
)
from .murmur3 import murmur3_kmer_hashes  # noqa: F401
from .nw import NEG_SENTINEL, NWResult, nw_similarity_batch  # noqa: F401
from .nw_cuda import (
    MAX_MP1,
    SCRATCH_PLANES,
    XL_ITEM_BYTES,
    XL_PAIR_BYTES,
    XL_STRIP,
    nw_similarity_batch_cuda,
    nw_similarity_batch_cuda_xl,
)

# Padded max(m, n)+1 up to MAX_MP1 goes to nw_gotoh (a group of lanes per
# pair, boundary rows in shared memory).  Wider batches go to nw_gotoh_xl
# (a queue of strips, one warp a strip), the port of _kernel_xl, which has
# no upper limit.

def pick_nw_backend(device, m: int, n: int) -> str:
    """``"torch"`` (the plain version) on the CPU; on a card ``"cuda"``
    (``nw_gotoh``) for padded widths with max(m, n)+1 <= MAX_MP1, else
    ``"cuda_xl"`` (``nw_gotoh_xl``), at any width.  The wrappers raise on
    devices other than CPU and CUDA."""
    if torch.device(device).type == "cpu":
        return "torch"
    return "cuda" if max(m, n) + 1 <= MAX_MP1 else "cuda_xl"


def pair_bytes(m: int, n: int) -> int:
    """Device bytes one pair of padded widths (m, n) takes in a launch: its
    gathered int32 inputs, lengths and outputs, plus the scratch of the
    kernel that serves it; for nw_gotoh_xl also its share of the work table
    at the most strips a pair of width m has."""
    kernel = {"cuda": "nw_gotoh", "cuda_xl": "nw_gotoh_xl"}[
        pick_nw_backend("cuda", m, n)]
    scratch = 4 * SCRATCH_PLANES[kernel] * (n + 1)
    if kernel == "nw_gotoh_xl":
        scratch += XL_PAIR_BYTES + XL_ITEM_BYTES * -(-m // XL_STRIP)
    return 4 * (m + n + 4) + scratch


def nw_batch(
    a_idx, a_len, b_idx, b_len, sub, *, gap_open: int = 10, gap_ext: int = 4
) -> NWResult:
    """(matches, length) for [B, L] pair batches on their own device."""
    backend = pick_nw_backend(a_idx.device, a_idx.shape[1], b_idx.shape[1])
    # on the CPU ("torch") either wrapper runs the plain version
    wrapper = (nw_similarity_batch_cuda_xl if backend == "cuda_xl"
               else nw_similarity_batch_cuda)
    return wrapper(a_idx, a_len, b_idx, b_len, sub,
                   gap_open=gap_open, gap_ext=gap_ext)


def nw_batch_tiled(
    a_idx, a_len, b_idx, b_len, sub, *, gap_open: int = 10, gap_ext: int = 4
) -> NWResult:
    """``nw_batch`` over [T, B, L] tile stacks, as one batch of T*B pairs;
    the result is [T, B]."""
    t, bsz, m = a_idx.shape
    res = nw_batch(
        a_idx.reshape(t * bsz, m), a_len.reshape(t * bsz),
        b_idx.reshape(t * bsz, b_idx.shape[2]), b_len.reshape(t * bsz),
        sub, gap_open=gap_open, gap_ext=gap_ext,
    )
    return NWResult(res.matches.reshape(t, bsz), res.length.reshape(t, bsz))
