"""The port's hybrid pipelines on the CPU against the JAX package: the
dense hybrid, the top-k edge list, the sparse hybrid (equal to the dense
one at top_k >= N - 1 with an absolute threshold) and cluster_large_exact.
Tolerance 0."""

import numpy as np
import pytest
from scipy import sparse

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as dj  # noqa: E402
from dynaalign_tpu import models as jmodels  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import models, oracle  # noqa: E402
from dynaalign_torch.cluster import louvain  # noqa: E402
from dynaalign_torch.encode import InvalidSequenceError  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")
THRESH = 0.25  # absolute MH similarity threshold shared by both paths


def _peptides(n_motifs=12, per=10, seed=11):
    """Clustered 12-mers: motifs with 0-2 point mutations each, so the MH
    threshold keeps a meaningful edge set."""
    rng = np.random.default_rng(seed)
    seqs = []
    for m in ["".join(rng.choice(AAS, size=12)) for _ in range(n_motifs)]:
        for _ in range(per):
            s = list(m)
            for _ in range(rng.integers(0, 3)):
                s[rng.integers(12)] = rng.choice(AAS)
            seqs.append("".join(s))
    return seqs


def _ragged(seed=5, n=40):
    rng = np.random.default_rng(seed)
    base = "".join(rng.choice(AAS, size=90))
    out = []
    for _ in range(n):
        lo, hi = sorted(rng.integers(0, 90, size=2))
        s = list(base[lo : max(hi, lo + 3)])
        s[rng.integers(len(s))] = rng.choice(AAS)
        out.append("".join(s))
    return out


@pytest.mark.parametrize("kw", [
    {"k": 2},
    {"k": 2, "prefilter_quantile": 0.5, "seed": 3},
    {"k": 2, "prefilter_threshold": THRESH},
    {"k": 3, "n_hash": 20, "matrix_name": "BLOSUM45", "gap_open": 5,
     "gap_ext": 1},
])
def test_dense_hybrid_equals_jax(kw):
    seqs = _peptides()
    got = dt.similarity_hybrid(seqs, device="cpu", **kw)
    np.testing.assert_array_equal(got, dj.similarity_hybrid(seqs, **kw))
    assert got.dtype == np.float64 and (np.diag(got) == 1.0).all()
    np.testing.assert_array_equal(got, got.T)


def test_dense_hybrid_kept_entries_are_exact_nw():
    """Every kept pair carries the oracle's NW value with the lower index
    as sequence 1; every other off-diagonal entry is 0."""
    seqs = _ragged()
    got = dt.similarity_hybrid(seqs, k=2, device="cpu")
    np.testing.assert_array_equal(got, dj.similarity_hybrid(seqs, k=2))
    mh = dt.similarity_mh(seqs, 2, 50, device="cpu")
    iu = np.triu_indices(len(seqs), k=1)
    t = np.quantile(mh[iu], 0.8)
    kept = 0
    for i, j in zip(*iu):
        if mh[i, j] >= t:
            kept += 1
            assert got[i, j] == got[j, i] == oracle.nw_pair(seqs[i], seqs[j])
        else:
            assert got[i, j] == got[j, i] == 0.0
    assert 0 < kept < len(iu[0])


def test_dense_hybrid_edges():
    np.testing.assert_array_equal(
        dt.similarity_hybrid(["ARNDCQ"], device="cpu"), [[1.0]])
    two = dt.similarity_hybrid(["ARNDCQ", "ARNDCE"], k=2, device="cpu")
    np.testing.assert_array_equal(two, dj.similarity_hybrid(
        ["ARNDCQ", "ARNDCE"], k=2))
    none = dt.similarity_hybrid(_peptides()[:20], k=2, device="cpu",
                                prefilter_threshold=2.0)
    np.testing.assert_array_equal(none, np.eye(20))


@pytest.mark.parametrize("kw", [
    {},
    {"top_k": 5},
    {"top_k": 8, "prefilter_threshold": THRESH},
    {"top_k": 119, "prefilter_threshold": THRESH},
    {"top_k": 16, "prefilter_quantile": 0.3, "seed": 2, "n_hash": 30},
    {"top_k": 16, "chunk": 7},
])
def test_topk_edges_equal_jax(kw):
    seqs = _peptides()
    got = models.hybrid_topk_edges(seqs, k=2, device="cpu", **kw)
    want = jmodels.hybrid_topk_edges(seqs, k=2, **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype
    pi, pj, w = got
    assert np.all(pi < pj) and pi.dtype == np.int32
    key = pi.astype(np.int64) * len(seqs) + pj
    assert np.all(np.diff(key) > 0)  # sorted by key, each edge once
    if "prefilter_threshold" in kw:
        assert np.all(w >= THRESH)


def test_topk_truncation_keeps_a_subset_of_the_full_edges():
    seqs = _peptides()
    pi, pj, _ = models.hybrid_topk_edges(
        seqs, k=2, top_k=8, prefilter_threshold=THRESH, device="cpu")
    fi, fj, _ = models.hybrid_topk_edges(
        seqs, k=2, top_k=len(seqs) - 1, prefilter_threshold=THRESH,
        device="cpu")
    assert set(zip(pi.tolist(), pj.tolist())) <= set(
        zip(fi.tolist(), fj.tolist()))


def test_encode_validation_differs_by_path_as_in_jax():
    """The dense MH stage hashes raw bytes; the NW rescoring and the
    top-k edge list validate.  The same inputs raise in both packages."""
    bad = ["ARNDCQ", "ARNDJQ", "ARNDCE"]
    for fn, jfn in ((models.hybrid_topk_edges, jmodels.hybrid_topk_edges),
                    (dt.similarity_hybrid_sparse,
                     dj.similarity_hybrid_sparse),
                    (dt.similarity_hybrid, dj.similarity_hybrid)):
        with pytest.raises(InvalidSequenceError, match="'J'"):
            fn(bad, k=2, device="cpu")
        with pytest.raises(ValueError, match="'J'"):
            jfn(bad, k=2)
    # cluster_large never aligns, so it takes any characters
    np.testing.assert_array_equal(
        dt.cluster_large(bad, k=2, device="cpu"), dj.cluster_large(bad, k=2))


@pytest.mark.parametrize("top_k", [119, 500])
def test_sparse_equals_dense_at_full_top_k(top_k):
    seqs = _peptides()
    dense = dt.similarity_hybrid(seqs, k=2, prefilter_threshold=THRESH,
                                 device="cpu")
    timings = {}
    sp = dt.similarity_hybrid_sparse(
        seqs, k=2, top_k=top_k, prefilter_threshold=THRESH, device="cpu",
        timings=timings)
    assert sparse.issparse(sp) and sp.format == "csr"
    np.testing.assert_array_equal(sp.toarray(), dense)
    assert set(timings) == {"edges", "rescore", "n_edges"}
    assert timings["n_edges"] == (np.count_nonzero(dense) - len(seqs)) // 2
    jsp = dj.similarity_hybrid_sparse(seqs, k=2, top_k=top_k,
                                      prefilter_threshold=THRESH)
    assert (sp != jsp).nnz == 0


@pytest.mark.parametrize("kw", [
    {"top_k": 16},
    {"top_k": 6, "prefilter_quantile": 0.5, "matrix_name": "BLOSUM80"},
    {"top_k": 16, "prefilter_threshold": 2.0},
])
def test_sparse_hybrid_equals_jax(kw):
    seqs = _peptides()
    got = dt.similarity_hybrid_sparse(seqs, k=2, device="cpu", **kw)
    want = dj.similarity_hybrid_sparse(seqs, k=2, **kw)
    np.testing.assert_array_equal(got.toarray(), want.toarray())
    np.testing.assert_array_equal(got.diagonal(), np.ones(len(seqs)))


def test_sparse_equals_dense_clustering():
    seqs = _peptides()
    dense = dt.similarity_hybrid(seqs, k=2, prefilter_threshold=THRESH,
                                 device="cpu")
    mem_dense = louvain(dense, resolution=1.05, seed=0).membership
    mem_sparse = dt.cluster_large_exact(
        seqs, k=2, top_k=len(seqs) - 1, prefilter_threshold=THRESH,
        resolution=1.05, louvain_seed=0, device="cpu")
    np.testing.assert_array_equal(mem_sparse, mem_dense + 1)


@pytest.mark.parametrize("kw", [
    {"top_k": 16},
    {"top_k": 8, "thresh_p": 0.5, "resolution": 1.0, "louvain_seed": 4,
     "seed": 1},
    {"top_k": 300, "prefilter_threshold": THRESH},
])
def test_cluster_large_exact_equals_jax(kw):
    seqs = _peptides(n_motifs=20, per=12)
    timings = {}
    got = dt.cluster_large_exact(seqs, k=2, device="cpu", timings=timings,
                                 **kw)
    np.testing.assert_array_equal(
        got, dj.cluster_large_exact(seqs, k=2, **kw))
    assert got.shape == (240,) and got.min() == 1
    assert {"edges", "rescore", "louvain", "n_edges"} == set(timings)
    assert timings["n_edges"] > 0


def test_nw_rescore_pairs_on_the_edge_list_equals_jax():
    seqs = _ragged()
    pi, pj, _ = models.hybrid_topk_edges(seqs, k=2, top_k=6, device="cpu")
    got = dt.nw_rescore_pairs(seqs, pi, pj, device="cpu")
    np.testing.assert_array_equal(got, jmodels.nw_rescore_pairs(seqs, pi, pj))
    np.testing.assert_array_equal(
        got, [oracle.nw_pair(seqs[i], seqs[j]) for i, j in zip(pi, pj)])


@pytest.mark.parametrize("fn", [
    dt.similarity_hybrid, models.hybrid_topk_edges,
    dt.similarity_hybrid_sparse, dt.cluster_large_exact,
], ids=lambda f: f.__name__)
def test_default_device_without_card_raises(fn, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    seqs = ["ARNDCQ", "ARNDCE", "WWYYPP"]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(seqs, k=2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fn(seqs, k=2, device="cuda")


def test_package_exports_follow_the_jax_package():
    for name in ("MinHashEngine", "similarity_mh", "similarity_nw",
                 "similarity_nw_bucketed", "ClusterBreakResult",
                 "clusterbreak", "louvain", "louvain_mod", "netcluster",
                 "cluster_large_exact", "similarity_hybrid",
                 "similarity_hybrid_sparse", "cluster_large"):
        assert callable(getattr(dt, name)) and hasattr(dj, name), name
    for name in ("cluster_large_exact", "hybrid_topk_edges",
                 "nw_rescore_pairs", "similarity_hybrid",
                 "similarity_hybrid_sparse"):
        assert hasattr(models, name) and hasattr(jmodels, name), name
