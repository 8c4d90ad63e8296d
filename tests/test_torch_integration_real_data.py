"""The real-data acceptance studies of tests/test_integration_real_data.py
through the port, on the CPU: the same inputs, seeds and thresholds (the
reference's workspace studies, workspace/troyWspc.Rmd:41-189), and every
similarity matrix the port computes equal, byte for byte, to the JAX
package's or the oracle's on the same input."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as jt  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402

from dynaalign_torch import oracle, similarity_mh, similarity_nw  # noqa: E402
from dynaalign_torch.cluster import clusterbreak  # noqa: E402
from dynaalign_torch.io.datasets import (  # noqa: E402
    load_dataset,
    load_sequences,
)


def _ari(a, b):
    a = np.asarray(a)
    b = np.asarray(b)
    n = len(a)
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    ct = np.zeros((ia.max() + 1, ib.max() + 1), dtype=np.int64)
    np.add.at(ct, (ia, ib), 1)
    comb = lambda x: x * (x - 1) / 2  # noqa: E731
    sum_ij = comb(ct).sum()
    sum_a = comb(ct.sum(1)).sum()
    sum_b = comb(ct.sum(0)).sum()
    exp = sum_a * sum_b / comb(n)
    mx = (sum_a + sum_b) / 2
    return (sum_ij - exp) / (mx - exp) if mx != exp else 1.0


def _same_bytes(got, want):
    assert got.dtype == want.dtype and got.shape == want.shape
    assert got.tobytes() == want.tobytes()


def test_nw_bit_exact_on_h3n2_subset():
    # the BASELINE bit-exactness target, on a CI-sized subset
    seqs = load_sequences("h3n2sample", limit=12)
    got = similarity_nw(seqs, device="cpu")
    want = oracle.nw_similarity(seqs)
    np.testing.assert_array_equal(got, want)
    _same_bytes(got, want)
    _same_bytes(want, joracle.nw_similarity(seqs))


def test_mh_bit_exact_on_peparray():
    seqs = load_sequences("evp_peparray", limit=200)
    got = similarity_mh(seqs, k=2, n_hash=50, seed=0, device="cpu")
    want = oracle.minhash_similarity(seqs, k=2, n_hash=50, seed=0)
    np.testing.assert_array_equal(got, want)
    _same_bytes(got, want)
    _same_bytes(got, jt.similarity_mh(seqs, k=2, n_hash=50, seed=0))


@pytest.mark.parametrize(
    "dataset,limit,k,n_hash,r_med,r_min",
    [
        # long regime: ~566 aa H3N2 HA proteins (troyWspc.Rmd:106-133)
        ("h3n2sample", 30, 4, 200, 0.60, 0.50),
        # short regime: 12-mer peptide-array probes (troyWspc.Rmd:41-95),
        # the JAX file's regime-appropriate thresholds
        ("evp_peparray", 120, 4, 200, 0.30, 0.20),
        # the reference's clusterbreak default, similarityMH(k=2,
        # n_hash=50) (R/clusterbreak.R:185)
        ("evp_peparray", 120, 2, 50, 0.55, 0.45),
    ],
)
def test_mh_nw_correlation_two_regimes(
    dataset, limit, k, n_hash, r_med, r_min
):
    """MH similarity must correlate with exact NW in BOTH length regimes
    across >= 10 hash-family seeds (the reference's 50-replicate accuracy
    protocol, workspace/troyWspc.Rmd:41-133)."""
    seqs = load_sequences(dataset, limit=limit)
    nw = oracle.nw_similarity(seqs)
    _same_bytes(nw, joracle.nw_similarity(seqs, n_threads=0))
    iu = np.triu_indices(len(seqs), k=1)
    rs = []
    for seed in range(10):
        mh = similarity_mh(seqs, k=k, n_hash=n_hash, seed=seed,
                           device="cpu")
        if seed == 0:
            _same_bytes(mh, jt.similarity_mh(seqs, k=k, n_hash=n_hash,
                                             seed=seed))
        rs.append(float(np.corrcoef(mh[iu], nw[iu])[0, 1]))
    rs = np.asarray(rs)
    assert np.median(rs) > r_med, f"median Pearson {np.median(rs):.3f}"
    assert rs.min() > r_min, f"worst-seed Pearson {rs.min():.3f}"


def test_mh_nw_mantel_long_sequences():
    """Mantel permutation test (troyWspc.Rmd:273-289): the MH/NW matrix
    correlation must be significant against the null of permuted sequence
    identities (joint row+column permutation)."""
    seqs = load_sequences("h3n2sample", limit=30)
    n = len(seqs)
    mh = similarity_mh(seqs, k=4, n_hash=200, seed=0, device="cpu")
    _same_bytes(mh, jt.similarity_mh(seqs, k=4, n_hash=200, seed=0))
    nw = oracle.nw_similarity(seqs)
    iu = np.triu_indices(n, k=1)
    r_obs = np.corrcoef(mh[iu], nw[iu])[0, 1]
    rng = np.random.default_rng(0)
    n_perm = 499
    hits = 0
    for _ in range(n_perm):
        p = rng.permutation(n)
        r_p = np.corrcoef(mh[np.ix_(p, p)][iu], nw[iu])[0, 1]
        hits += r_p >= r_obs
    p_val = (hits + 1) / (n_perm + 1)
    assert p_val <= 0.01, f"Mantel p-value {p_val:.4f} (r_obs={r_obs:.3f})"


def test_consensus_column_agreement_h3n2():
    """Per-cluster consensi must agree per-column with the column-majority
    of the same MSA, and identical-sequence clusters must return the exact
    sequence (DECIPHER::ConsensusSequence behavior,
    R/clusterbreak.R:315-316); the port's MSA and consensus equal the JAX
    package's."""
    from dynaalign_tpu.consensus import progressive_msa as jmsa

    from dynaalign_torch.consensus import (
        cluster_consensus,
        consensus_sequence,
        progressive_msa,
    )

    seqs = load_sequences("h3n2sample", limit=24)
    # identical-sequence cluster -> exact sequence
    same = [(seqs[0], "1")] * 5
    out = cluster_consensus(np.array(same, dtype=object))
    assert out[0, 1] == seqs[0]

    # real mixed cluster: consensus vs column-majority agreement
    aligned = progressive_msa(seqs[:12])
    assert list(aligned) == list(jmsa(seqs[:12]))
    cons = consensus_sequence(aligned)
    cols = np.array([list(s) for s in aligned])
    agree = 0
    informative = 0
    for c in range(cols.shape[1]):
        vals, counts = np.unique(cols[:, c], return_counts=True)
        maj = vals[np.argmax(counts)]
        informative += 1
        # ambiguity codes subsume their members; '+' counts as miss
        ok = cons[c] == maj or (
            cons[c] in "BZJX" and maj in "ARNDCQEGHILKMFPSTWYV"
        )
        agree += bool(ok)
    assert informative > 500  # HA proteins are ~566 aa
    frac = agree / informative
    assert frac >= 0.95, f"column agreement too low: {frac:.3f}"


def test_louvain_cross_validation_networkx():
    """Cross-validate the port's Louvain against networkx's independent
    implementation on a thresholded real similarity matrix: median ARI >=
    0.8 over seeds and modularity within 2% of the better of the two."""
    nx = pytest.importorskip("networkx")
    from networkx.algorithms.community import louvain_communities
    from scipy import sparse

    from dynaalign_torch.cluster import louvain
    from dynaalign_torch.cluster.louvain import modularity as our_q

    seqs = load_sequences("evp_peparray", limit=150)
    sim = similarity_mh(seqs, k=2, n_hash=100, seed=0, device="cpu")
    _same_bytes(sim, jt.similarity_mh(seqs, k=2, n_hash=100, seed=0))
    thr = np.quantile(sim[np.triu_indices(len(seqs), k=1)], 0.8)
    adj = np.where(sim >= thr, sim, 0.0)
    np.fill_diagonal(adj, 0.0)

    g = nx.from_numpy_array(adj)
    aris = []
    q_ours_best = -1.0
    q_nx_best = -1.0
    for seed in range(5):
        ours = louvain(sparse.csr_matrix(adj), seed=seed).membership
        nx_comms = louvain_communities(g, weight="weight", seed=seed)
        nx_mem = np.zeros(len(seqs), dtype=np.int64)
        for cid, members in enumerate(nx_comms):
            for v in members:
                nx_mem[v] = cid
        aris.append(_ari(ours, nx_mem))
        q_ours_best = max(q_ours_best, our_q(sparse.csr_matrix(adj), ours))
        q_nx_best = max(
            q_nx_best, our_q(sparse.csr_matrix(adj), nx_mem)
        )
    med = float(np.median(aris))
    assert med >= 0.8, f"median ARI vs networkx too low: {med:.3f}"
    best = max(q_ours_best, q_nx_best)
    assert q_ours_best >= best - abs(best) * 0.02, (
        f"our modularity {q_ours_best:.4f} lags networkx {q_nx_best:.4f}"
    )


def test_clusterbreak_ari_vs_clades():
    """clusterbreak clusters must align with H3N2 clade labels (the
    reference's clustering-quality protocol,
    workspace/troyWspc.Rmd:134-189); every similarity matrix the recursion
    asks for equals the JAX package's, and so do the labels."""
    cols = load_dataset("h3n2sample")
    rng = np.random.default_rng(0)
    # stratified sample over clades for a fast but non-trivial instance
    clades = np.asarray(cols["clade"])
    seqs_all = np.asarray(cols["sequence"])
    keep_idx = []
    for clade in np.unique(clades):
        idx = np.nonzero(clades == clade)[0]
        take = min(len(idx), 25)
        keep_idx.extend(rng.choice(idx, size=take, replace=False))
    keep_idx = np.array(sorted(keep_idx))
    seqs = [str(s) for s in seqs_all[keep_idx]]
    labels = clades[keep_idx]
    # dedupe (clusterbreak assumes distinct membership rows)
    seen = {}
    for s, lab in zip(seqs, labels):
        seen.setdefault(s, lab)
    seqs = list(seen)
    labels = np.array([seen[s] for s in seqs])

    def sim_fn(x):
        mh = similarity_mh(x, k=4, n_hash=300, seed=0, device="cpu")
        _same_bytes(mh, jt.similarity_mh(x, k=4, n_hash=300, seed=0))
        return mh

    result = clusterbreak(
        seqs, thresh_p=0.8, size_max=len(seqs), size_min=1,
        sim_fn=sim_fn, verbose=False,
    )
    want = jt.clusterbreak(
        seqs, thresh_p=0.8, size_max=len(seqs), size_min=1,
        sim_fn=lambda x: jt.similarity_mh(x, k=4, n_hash=300, seed=0),
        verbose=False,
    )
    assert result.clustered_seq.tolist() == want.clustered_seq.tolist()
    assign = dict(zip(result.clustered_seq[:, 0], result.clustered_seq[:, 1]))
    got = np.array([assign.get(s, "none") for s in seqs])
    score = _ari(got, labels)
    assert score > 0.3, f"ARI vs clades too low: {score:.3f}"
