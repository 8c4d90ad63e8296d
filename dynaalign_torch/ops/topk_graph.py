"""Top-k similarity graph for large sequence sets (sparse path).

A dense [N, N] float64 similarity matrix stops being viable around
N = 30k (a 100k+ set would need 80 GB).  The large-scale path never
materialises it: each row block's agreement counts are computed on the
device, immediately reduced to the row's top-k neighbours, and only the
[N, k] neighbour lists leave the device.  Louvain then runs on the sparse
symmetrised k-NN graph, the standard construction for similarity-graph
clustering at scale.
"""

from __future__ import annotations

import time

import numpy as np
import torch
from scipy import sparse

from ..device import resolve_device
from ..encode import encode
from ..utils.profiling import span
from . import topk_cuda
from .minhash import (
    as_signatures,
    block_counts,
    minhash_signatures,
    row_block,
    signatures_to_numpy,
)


def _check(sigs: torch.Tensor, start: int, stop: int, k: int) -> None:
    """Raise unless ``sigs`` is an int32 [N, H] tensor, 0 <= start <= stop
    <= N and 1 <= k <= N: what either version takes."""
    if sigs.dtype != torch.int32 or sigs.dim() != 2:
        raise ValueError("signature tensors are int32 [N, H] bit patterns, "
                         f"got {sigs.dtype} {tuple(sigs.shape)}")
    n = sigs.shape[0]
    if not 0 <= start <= stop <= n:
        raise ValueError(f"rows {start}:{stop} out of range for N={n}")
    if not 1 <= k <= n:
        raise ValueError(f"k must lie in [1, N={n}], got {k}")


def _topk_block(sigs: torch.Tensor, start: int, stop: int, k: int,
                block: int | None = None):
    """(counts, neighbour indices), both int64 [stop - start, k], of rows
    start:stop; the row itself is masked to count -1.

    A CUDA tensor goes to the kernel ``csrc/minhash_topk.cu``, one launch
    for all the rows (``topk_cuda.topk_rows``, which raises past the
    kernel's limits); a CPU tensor to the plain version, :func:`_topk_plain`,
    in row blocks of ``block`` rows (None: what a [block, N, n_hash]
    compare within ``minhash.COMPARE_BYTES`` holds).  Each launch and each
    plain row block is a span ``topk.block``, which counts the rows it
    served as ``kernel_rows`` or ``plain_rows``.
    """
    _check(sigs, start, stop, k)
    if sigs.device.type == "cuda":
        with span("topk.block", kernel_rows=stop - start, plain_rows=0):
            return topk_cuda.topk_rows(sigs, start, stop, k)
    block = block or row_block(*sigs.shape)
    parts = []
    for s in range(start, max(stop, start + 1), block):  # start == stop: one empty block
        e = min(s + block, stop)
        with span("topk.block", kernel_rows=0, plain_rows=e - s):
            parts.append(_topk_plain(sigs, s, e, k))
    return (torch.cat([c for c, _ in parts]),
            torch.cat([i for _, i in parts]))


def _topk_plain(sigs: torch.Tensor, start: int, stop: int, k: int):
    """The plain version of :func:`_topk_block`, in torch ops, on any
    device: a [stop - start, N] count block and ``torch.topk`` over it.

    Equal counts come lowest index first, by construction: the top-k runs
    over the key (count + 1) * N + (N - 1 - column), which is distinct
    within a row, so it does not matter how ``torch.topk`` orders ties.
    The kernel keeps the same order.
    """
    n = sigs.shape[0]
    counts = block_counts(sigs, start, stop).to(torch.int64)  # [b, N]
    rows = torch.arange(stop - start, device=sigs.device)
    counts[rows, rows + start] = -1
    cols = torch.arange(n - 1, -1, -1, device=sigs.device)  # N-1-col
    key = (counts + 1) * n + cols[None, :]
    top = torch.topk(key, k, dim=1).values
    return top // n - 1, n - 1 - top % n


def minhash_topk(
    sigs: np.ndarray | torch.Tensor,
    k: int = 64,
    *,
    block: int | None = None,
    device=None,
) -> tuple[np.ndarray, np.ndarray]:
    """(similarities float64 [N, k], neighbour indices int32 [N, k]).

    Similarity = agreement_count / n_hash, like the dense path
    (src/minHash.cpp:174 semantics); self-pairs excluded; k is cut to
    N - 1; among equal counts the lower index comes first.  A set of one
    sequence has no neighbour: its single entry is index 0 at similarity 0.
    On a card one kernel launch serves every row, with k and n_hash up to
    ``topk_cuda.MAX_K`` and ``MAX_N_HASH`` (past them it raises); on the
    CPU ``block`` is the plain version's row block (None sizes it from
    ``minhash.COMPARE_BYTES``).
    """
    sigs = as_signatures(sigs, device)
    n, n_hash = sigs.shape
    k = min(k, max(n - 1, 1))
    counts, idx = _topk_block(sigs, 0, n, k, block)
    return _topk_lists(counts.cpu().numpy(), idx.cpu().numpy(), n_hash)


def _topk_lists(counts: np.ndarray, idx: np.ndarray, n_hash: int):
    """(similarities float64, indices int32) from ``_topk_block``'s counts
    and indices of every row."""
    own = counts < 0  # only at N = 1, where the row itself is all there is
    vals = np.where(own, 0, counts).astype(np.float64) / float(n_hash)
    return vals, np.where(own, 0, idx).astype(np.int32)


def _topk_neighbours(sigs: torch.Tensor, k: int, mesh=None):
    """``minhash_topk`` of ``sigs``, or with a mesh its sharded form,
    ``parallel.sharded_minhash_topk``, across the mesh's ranks."""
    if mesh is None:
        return minhash_topk(sigs, k=k)
    from ..parallel import sharded_minhash_topk

    out = sharded_minhash_topk(signatures_to_numpy(sigs), k=k, mesh=mesh)
    if out is None:
        raise ValueError(f"rank {mesh.rank} is not in the mesh")
    return out


def knn_graph(
    vals: np.ndarray,
    idx: np.ndarray,
    *,
    threshold: float = 0.0,
) -> sparse.csr_matrix:
    """Symmetric CSR adjacency from top-k neighbour lists.

    Edges with similarity < ``threshold`` (or 0) are dropped; mutual
    duplicates are merged by max.
    """
    n, k = vals.shape
    with span("knn_graph"):
        rows = np.repeat(np.arange(n, dtype=np.int64), k)
        cols = idx.ravel().astype(np.int64)
        w = vals.ravel()
        keep = (w > 0) & (w >= threshold) & (rows != cols)
        rows, cols, w = rows[keep], cols[keep], w[keep]
        adj = sparse.coo_matrix((w, (rows, cols)), shape=(n, n)).tocsr()
        sym = adj.maximum(adj.T)
        return sym.tocsr()


def cluster_large(
    sequences,
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    top_k: int = 64,
    thresh_p: float = 0.8,
    resolution: float = 1.05,
    louvain_seed: int = 0,
    chunk: int | None = None,
    mesh=None,
    device=None,
    timings: dict | None = None,
) -> np.ndarray:
    """Large-N MinHash clustering without a dense matrix.

    signatures → per-row top-k graph → quantile threshold over observed
    edge weights → Louvain.  Returns a 1-based membership vector,
    API-compatible with :func:`dynaalign_torch.cluster.netcluster`.

    Pass a :class:`dynaalign_torch.parallel.Mesh` as ``mesh`` to run the
    top-k reduction row-sharded across its ranks
    (``parallel.sharded_minhash_topk``, equal to the single-device path);
    every rank of the mesh calls this, and every rank gets the membership.

    Pass a dict as ``timings`` to receive per-stage wall-clock seconds
    (keys: ``signatures``, ``topk``, ``graph``, ``louvain``), split at the
    ends of the span ``mh.signatures`` (and a synchronise, made only for
    ``timings``), the top-k (the ``topk.block`` spans and the fetch of
    the lists), the graph (the threshold and ``knn_graph``) and the span
    ``louvain``.

    The call is the span ``cluster_large``: its gauges ``threshold`` (the
    float64 quantile of the positive top-k weights) and
    ``kept_weight_sum`` (the float64 sum of the kept edges' weights, each
    undirected edge once), and its count ``kept_edges`` (those edges).
    """
    from ..cluster.louvain import louvain

    dev = resolve_device(device)
    seqs = list(sequences)
    with span("cluster_large") as sp:
        enc = encode(seqs, validate=False)
        t0 = time.perf_counter()
        sigs = minhash_signatures(
            enc.ascii, enc.lengths, k=k, n_hash=n_hash, seed=seed,
            chunk=chunk, device=dev,
        )
        if timings is not None and dev.type == "cuda":
            torch.cuda.synchronize(dev)  # for the timing split
        t1 = time.perf_counter()
        vals, idx = _topk_neighbours(sigs, top_k, mesh)
        t2 = time.perf_counter()
        pos = vals[vals > 0]
        t = float(np.quantile(pos, thresh_p)) if pos.size else 0.0
        adj = knn_graph(vals, idx, threshold=t)
        # symmetric, no self-loop yet: every edge is stored twice
        sp.update(threshold=t, kept_edges=adj.nnz // 2,
                  kept_weight_sum=float(adj.data.sum()) / 2)
        # keep self-loops like the dense path (unit diagonal)
        adj = adj + sparse.eye(adj.shape[0], format="csr")
        t3 = time.perf_counter()
        membership = louvain(
            adj, resolution=resolution, seed=louvain_seed
        ).membership + 1
        t4 = time.perf_counter()
    if timings is not None:
        timings.update(
            signatures=t1 - t0, topk=t2 - t1, graph=t3 - t2,
            louvain=t4 - t3,
        )
    return membership
