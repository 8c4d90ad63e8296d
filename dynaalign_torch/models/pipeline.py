"""The end-to-end pipeline and the hybrid similarity engines.

:class:`Pipeline` is the framework's "model": the full peptide-clustering
flow the reference demonstrates in its README (README.md:33-64: similarity
matrix → clusterbreak → clusterconsensus), packaged behind one
configurable object, with the engines ``"mh"``, ``"nw"``,
``"nw_bucketed"`` and ``"hybrid"``.

The hybrid engines run a MinHash prefilter, then exact NW rescoring.
Cheap signatures prune the pair space, and only the pairs at or above the
MH threshold go through the exact DP (the viral-panel hybrid
configuration):

* :func:`nw_rescore_pairs`: exact NW percent identity of an explicit pair
  list, streamed through the same launches as ``similarity_nw``, so each
  batch goes to the kernel its padded width needs, at any length;
* :func:`similarity_hybrid`: dense, the threshold taken over all pairs;
* :func:`hybrid_topk_edges`, :func:`similarity_hybrid_sparse`,
  :func:`cluster_large_exact`: sparse, over the top-k graph, with no dense
  matrix anywhere.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np
import torch
from scipy import sparse

from .. import blosum
from ..api import (
    DEFAULT_CHUNK,
    _pairs_nw,
    _ratio,
    _resolve_device,
    similarity_mh,
    similarity_nw,
    similarity_nw_bucketed,
)
from ..cluster import ClusterBreakResult, clusterbreak
from ..cluster.louvain import louvain
from ..config import PipelineConfig
from ..consensus import cluster_consensus
from ..encode import encode
from ..ops.minhash import minhash_signatures
from ..ops.topk_graph import _topk_neighbours
from ..utils.profiling import span


def nw_rescore_pairs(
    sequences: Sequence[str],
    pair_i: np.ndarray,
    pair_j: np.ndarray,
    *,
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    device=None,
    chunk: int | None = None,
) -> np.ndarray:
    """Exact NW percent identity of each pair (sequences[pair_i[k]],
    sequences[pair_j[k]]), the first as the reference's sequence 1:
    float64 [len(pair_i)].  Runs on ``device`` as ``similarity_nw`` does.

    The work is the span ``hybrid.rescore`` (count ``pairs``), around the
    launches' own ``nw.launch``, ``nw.fetch`` and ``nw.ratio``.
    """
    pi = np.asarray(pair_i, dtype=np.int64).reshape(-1)
    pj = np.asarray(pair_j, dtype=np.int64).reshape(-1)
    if pi.shape != pj.shape:
        raise ValueError(
            f"pair_i and pair_j differ in length: {pi.size} and {pj.size}"
        )
    dev = _resolve_device(device)
    with span("hybrid.rescore", pairs=int(pi.size)):
        sub = blosum.get_matrix(matrix_name, device=dev)
        enc = encode(sequences)
        n = len(enc.lengths)
        if pi.size == 0:
            return np.zeros(0, dtype=np.float64)
        if min(pi.min(), pj.min()) < 0 or max(pi.max(), pj.max()) >= n:
            raise IndexError(f"pair indices must lie in [0, {n})")
        idx = torch.from_numpy(enc.indices).to(dev)
        lens = torch.from_numpy(enc.lengths).to(dev)
        mt, ln = _pairs_nw(idx, lens, idx, lens, torch.from_numpy(pi).to(dev),
                           torch.from_numpy(pj).to(dev), sub, gap_open,
                           gap_ext, chunk or DEFAULT_CHUNK)
        return _ratio(mt, ln)


def _select_pairs(mh: np.ndarray, quantile: float, threshold: float | None):
    """(pair_i, pair_j) of the strict upper triangle, row-major, whose MH
    similarity reaches the threshold: ``threshold`` verbatim when given,
    else the ``quantile`` of all off-diagonal values."""
    iu = np.triu_indices(mh.shape[0], k=1)
    vals = mh[iu]
    if threshold is not None:
        t = threshold
    else:
        t = np.quantile(vals, quantile) if vals.size else 0.0
    keep = vals >= t
    return iu[0][keep], iu[1][keep]


def _fill_pairs(n: int, pi, pj, sims) -> np.ndarray:
    """Symmetric [n, n] matrix with ``sims`` on the pairs, 0 elsewhere and
    a unit diagonal."""
    out = np.zeros((n, n), dtype=np.float64)
    out[pi, pj] = sims
    out[pj, pi] = sims
    np.fill_diagonal(out, 1.0)
    return out


def similarity_hybrid(
    sequences: Sequence[str],
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    prefilter_quantile: float = 0.8,
    prefilter_threshold: float | None = None,
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    device=None,
) -> np.ndarray:
    """MH prefilter + exact NW rescoring of the surviving pairs.

    Pairs below the MH threshold keep similarity 0; the rest are
    replaced with exact NW percent identity.  Diagonal is 1.0.  The
    threshold is the ``prefilter_quantile`` of all off-diagonal MH
    values, or ``prefilter_threshold`` verbatim when given (the knob
    the sparse path shares, see :func:`similarity_hybrid_sparse`).
    """
    sequences = list(sequences)
    n = len(sequences)
    dev = _resolve_device(device)
    mh = similarity_mh(sequences, k=k, n_hash=n_hash, seed=seed, device=dev)
    pi, pj = _select_pairs(mh, prefilter_quantile, prefilter_threshold)
    if not len(pi):
        return np.eye(n, dtype=np.float64)
    sims = nw_rescore_pairs(
        sequences, pi, pj, matrix_name=matrix_name, gap_open=gap_open,
        gap_ext=gap_ext, device=dev,
    )
    return _fill_pairs(n, pi, pj, sims)


def hybrid_topk_edges(
    sequences: Sequence[str],
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    top_k: int = 64,
    prefilter_quantile: float = 0.8,
    prefilter_threshold: float | None = None,
    chunk: int | None = None,
    mesh=None,
    device=None,
) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """MH top-k prefilter edge list for the sparse hybrid path.

    Builds seeded MinHash signatures, reduces each row to its ``top_k``
    strongest neighbours on the device (ops.topk_graph.minhash_topk, never
    materialising the dense [N, N] matrix), dedups to unique i < j
    edges, and keeps edges at or above the MH threshold.  The threshold is
    ``prefilter_threshold`` verbatim when given; otherwise the
    ``prefilter_quantile`` of the observed positive edge weights (with
    top_k < N-1 this population is biased toward strong edges relative
    to the dense path's all-pairs quantile, the inherent price of
    never scoring the sub-top-k mass; pass an absolute threshold for
    exact dense-path agreement).

    With a :class:`dynaalign_torch.parallel.Mesh` as ``mesh`` the top-k
    reduction runs row-sharded across its ranks
    (``parallel.sharded_minhash_topk``, equal to the single-device path),
    and every rank of the mesh calls this and gets the whole edge list.

    Returns (pair_i, pair_j, mh_weight) with pair_i < pair_j, sorted by
    pair_i * N + pair_j.  The top-k is the span ``hybrid.topk`` (it ends
    in the lists' fetch), the host's dedup, quantile and selection the
    span ``hybrid.edges``.
    """
    seqs = list(sequences)
    return _hybrid_edges(
        seqs, _resolve_device(device), k=k, n_hash=n_hash, seed=seed,
        top_k=top_k, prefilter_quantile=prefilter_quantile,
        prefilter_threshold=prefilter_threshold, chunk=chunk, mesh=mesh,
    )[:3]


def _hybrid_edges(seqs: list[str], dev, *, k, n_hash, seed, top_k,
                  prefilter_quantile, prefilter_threshold, chunk, mesh):
    """:func:`hybrid_topk_edges`'s three arrays and, fourth, the float64
    threshold its edges were kept at."""
    n = len(seqs)
    enc = encode(seqs)
    sigs = minhash_signatures(
        enc.ascii, enc.lengths, k=k, n_hash=n_hash, seed=seed, chunk=chunk,
        device=dev,
    )
    with span("hybrid.topk"):
        vals, idx = _topk_neighbours(sigs, top_k, mesh)
    with span("hybrid.edges"):
        kk = vals.shape[1]
        rows = np.repeat(np.arange(n, dtype=np.int64), kk)
        cols = idx.ravel().astype(np.int64)
        w = vals.ravel()
        keep = (w > 0) & (rows != cols)
        rows, cols, w = rows[keep], cols[keep], w[keep]
        lo = np.minimum(rows, cols)
        hi = np.maximum(rows, cols)
        key = lo * n + hi
        # both directions of an edge carry the same count; keep the first
        _, first = np.unique(key, return_index=True)
        lo, hi, w = lo[first], hi[first], w[first]
        if prefilter_threshold is not None:
            t = float(prefilter_threshold)
        else:
            t = float(np.quantile(w, prefilter_quantile)) if w.size else 0.0
        sel = w >= t
        return (
            lo[sel].astype(np.int32),
            hi[sel].astype(np.int32),
            w[sel],
            t,
        )


def similarity_hybrid_sparse(
    sequences: Sequence[str],
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    top_k: int = 64,
    prefilter_quantile: float = 0.8,
    prefilter_threshold: float | None = None,
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    chunk: int | None = None,
    mesh=None,
    device=None,
    timings: dict | None = None,
) -> sparse.csr_matrix:
    """Sparse hybrid similarity: MH top-k prefilter + exact NW edge
    rescoring, without ever materialising a dense [N, N] matrix.

    The dense :func:`similarity_hybrid` quantiles the full upper triangle,
    about 80 GB of float64 at N = 100k.  This path composes the device-side
    top-k graph with ``nw_rescore_pairs``, so the exact-NW flow reaches
    sets the dense one cannot.  With ``top_k >= N-1`` and an absolute
    ``prefilter_threshold``, the result equals the dense path exactly.  On
    a card the top-k kernel takes top_k and n_hash up to
    ``ops.topk_cuda.MAX_K`` (256) and ``MAX_N_HASH`` (255), and raises
    past them.

    ``mesh`` shards the top-k prefilter as in :func:`hybrid_topk_edges`;
    each rank rescores the kept edges on its own device.

    Returns a scipy.sparse CSR [N, N] with exact NW percent identity on
    the kept edges (symmetric) and a unit diagonal.

    Pass a dict as ``timings`` for per-stage seconds (keys: ``edges``
    = signatures + top-k + threshold, ``rescore``; plus ``n_edges``).
    """
    seqs = list(sequences)
    pi, pj, sims, _ = _rescored_edges(
        seqs, _resolve_device(device), timings, k=k, n_hash=n_hash,
        seed=seed, top_k=top_k, prefilter_quantile=prefilter_quantile,
        prefilter_threshold=prefilter_threshold, matrix_name=matrix_name,
        gap_open=gap_open, gap_ext=gap_ext, chunk=chunk, mesh=mesh,
    )
    return _symmetric_csr(len(seqs), pi, pj, sims)


def _rescored_edges(seqs: list[str], dev, timings: dict | None, *,
                    matrix_name, gap_open, gap_ext, **topk):
    """(pair_i, pair_j, exact NW weight, MH threshold) of the sparse
    hybrid path: :func:`_hybrid_edges` with ``topk``'s settings, then
    :func:`nw_rescore_pairs` of the kept edges; fills ``timings`` as
    :func:`similarity_hybrid_sparse` documents."""
    t0 = time.perf_counter()
    pi, pj, _, t = _hybrid_edges(seqs, dev, **topk)
    t1 = time.perf_counter()
    if len(pi):
        sims = nw_rescore_pairs(
            seqs, pi, pj, matrix_name=matrix_name, gap_open=gap_open,
            gap_ext=gap_ext, device=dev,
        )
    else:
        sims = np.zeros(0, dtype=np.float64)
    t2 = time.perf_counter()
    if timings is not None:
        timings.update(
            edges=t1 - t0, rescore=t2 - t1, n_edges=int(len(pi))
        )
    return pi, pj, sims, t


def _symmetric_csr(n: int, pi, pj, sims) -> sparse.csr_matrix:
    """CSR [n, n] with ``sims`` on the pairs in both orientations and a
    unit diagonal."""
    return sparse.coo_matrix(
        (
            np.concatenate([sims, sims, np.ones(n)]),
            (
                np.concatenate([pi, pj, np.arange(n)]),
                np.concatenate([pj, pi, np.arange(n)]),
            ),
        ),
        shape=(n, n),
    ).tocsr()


def cluster_large_exact(
    sequences,
    *,
    k: int = 4,
    n_hash: int = 50,
    seed: int = 0,
    top_k: int = 64,
    thresh_p: float = 0.8,
    prefilter_threshold: float | None = None,
    matrix_name: str = "BLOSUM62",
    gap_open: int = 10,
    gap_ext: int = 4,
    resolution: float = 1.05,
    louvain_seed: int = 0,
    chunk: int | None = None,
    mesh=None,
    device=None,
    timings: dict | None = None,
    graph: dict | None = None,
) -> np.ndarray:
    """Large-N clustering on exact NW edge weights: MH top-k prefilter →
    NW rescoring of the surviving edges → Louvain.

    The exact-rescored sibling of ops.topk_graph.cluster_large: same
    sparse scaling (no dense matrix anywhere), but the graph Louvain
    sees carries exact percent-identity weights instead of Jaccard
    estimates.  Returns a 1-based membership vector.  ``mesh`` shards the
    top-k prefilter across its ranks (:func:`hybrid_topk_edges`).

    Pass a dict as ``timings`` for per-stage seconds (``edges``,
    ``rescore``, ``louvain``; plus ``n_edges``).

    Pass a dict as ``graph`` to have it filled (the return value stays
    the membership) with the graph Louvain clustered: ``pair_i`` and
    ``pair_j`` (int32, pair_i < pair_j, sorted by pair_i * N + pair_j),
    ``weight`` (float64 exact NW percent identity of each kept edge),
    ``threshold`` (the float64 MH prefilter threshold) and ``modularity``
    (Louvain's float64 Q of the membership on that graph, its unit
    diagonal as self-loops, at ``resolution``).

    The call is the span ``cluster_large_exact``: its gauges
    ``threshold``, ``rescored_weight_sum`` (the float64 sum of the kept
    edges' weights) and ``modularity``, and its count ``rescored_edges``.
    """
    seqs = list(sequences)
    with span("cluster_large_exact") as sp:
        pi, pj, sims, t = _rescored_edges(
            seqs, _resolve_device(device), timings, k=k, n_hash=n_hash,
            seed=seed, top_k=top_k, prefilter_quantile=thresh_p,
            prefilter_threshold=prefilter_threshold,
            matrix_name=matrix_name, gap_open=gap_open, gap_ext=gap_ext,
            chunk=chunk, mesh=mesh,
        )
        t0 = time.perf_counter()
        result = louvain(_symmetric_csr(len(seqs), pi, pj, sims),
                         resolution=resolution, seed=louvain_seed)
        if timings is not None:
            timings["louvain"] = time.perf_counter() - t0
        q = float(result.modularity)
        sp.update(threshold=t, rescored_edges=int(len(pi)),
                  rescored_weight_sum=float(sims.sum()), modularity=q)
    if graph is not None:
        graph.update(pair_i=pi, pair_j=pj, weight=sims, threshold=t,
                     modularity=q)
    return result.membership + 1


@dataclasses.dataclass
class PipelineResult:
    similarity: np.ndarray | None
    clusters: ClusterBreakResult
    consensus: np.ndarray


class Pipeline:
    """similarity → clusterbreak → cluster_consensus, configured once.

    The injectable ``sim_fn`` / ``cluster_fn`` extension point of the
    reference (R/clusterbreak.R:185-188) is preserved: pass callables to
    override either stage.  The built-in engines run on ``device`` (None
    means the card, as for every entry point; ``"cpu"`` runs the plain
    versions on the host); the MSA and consensus run on the host.
    """

    def __init__(
        self,
        config: PipelineConfig | None = None,
        *,
        sim_fn=None,
        cluster_fn=None,
        device=None,
    ):
        self.config = config or PipelineConfig()
        self._sim_fn = sim_fn
        self._cluster_fn = cluster_fn
        self.device = device

    def similarity(self, sequences: Sequence[str]) -> np.ndarray:
        cfg = self.config
        if self._sim_fn is not None:
            return np.asarray(self._sim_fn(list(sequences)))
        dev = self.device
        if cfg.similarity == "mh":
            return similarity_mh(
                sequences, k=cfg.minhash.k, n_hash=cfg.minhash.n_hash,
                seed=cfg.minhash.seed, device=dev,
            )
        if cfg.similarity == "nw":
            return similarity_nw(
                sequences, cfg.nw.matrix_name, cfg.nw.gap_open,
                cfg.nw.gap_ext, device=dev,
            )
        if cfg.similarity == "nw_bucketed":
            return similarity_nw_bucketed(
                sequences, cfg.nw.matrix_name, cfg.nw.gap_open,
                cfg.nw.gap_ext, device=dev,
            )
        if cfg.similarity == "hybrid":
            return similarity_hybrid(
                sequences, k=cfg.minhash.k, n_hash=cfg.minhash.n_hash,
                seed=cfg.minhash.seed,
                prefilter_quantile=cfg.hybrid.prefilter_quantile,
                prefilter_threshold=cfg.hybrid.prefilter_threshold,
                matrix_name=cfg.nw.matrix_name,
                gap_open=cfg.nw.gap_open, gap_ext=cfg.nw.gap_ext,
                device=dev,
            )
        raise ValueError(f"unknown similarity engine {cfg.similarity!r}")

    def cluster(
        self, sequences: Sequence[str], **overrides
    ) -> ClusterBreakResult:
        cfg = self.config.clusterbreak
        kwargs = dict(
            thresh_p=cfg.thresh_p, size_max=cfg.size_max,
            size_min=cfg.size_min, max_itr=cfg.max_itr,
            resolution=cfg.resolution, seed=cfg.seed, verbose=False,
            device=self.device,
        )
        kwargs.update(overrides)
        return clusterbreak(
            sequences,
            sim_fn=self._sim_fn or self.similarity,
            cluster_fn=self._cluster_fn,
            **kwargs,
        )

    def consensus(self, clusters: ClusterBreakResult) -> np.ndarray:
        cfg = self.config.consensus
        return cluster_consensus(
            clusters.clustered_seq,
            matrix_name=cfg.matrix_name, threshold=cfg.threshold,
        )

    def run(
        self, sequences: Sequence[str], **cluster_overrides
    ) -> PipelineResult:
        clusters = self.cluster(sequences, **cluster_overrides)
        consensus = (
            self.consensus(clusters)
            if len(clusters.clustered_seq)
            else np.empty((0, 2), dtype=object)
        )
        return PipelineResult(
            similarity=None, clusters=clusters, consensus=consensus
        )
