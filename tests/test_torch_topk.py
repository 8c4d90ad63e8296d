"""The port's top-k graph on the CPU against the JAX package and a stable
host sort: minhash_topk (tie order, edges of n and k), knn_graph and
cluster_large.  Tolerance 0."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from dynaalign_tpu.ops import topk_graph as jtopk  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch.encode import encode  # noqa: E402
from dynaalign_torch.ops import minhash, topk_graph  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")


def _stable_topk(sigs, k):
    """(vals, idx) by a stable descending sort of host-computed counts:
    equal counts keep index order, lowest first."""
    n, h = sigs.shape
    counts = (sigs[:, None, :] == sigs[None, :, :]).sum(-1).astype(np.int64)
    np.fill_diagonal(counts, -1)
    idx = np.stack([np.argsort(-counts[i], kind="stable")[:k]
                    for i in range(n)])
    vals = np.take_along_axis(counts, idx, axis=1)
    return np.maximum(vals, 0) / float(h), idx


def _tie_heavy(seed, n, h):
    return np.random.default_rng(seed).integers(
        0, 3, size=(n, h)).astype(np.uint32)


def _family_seqs(seed, n_fam, per, length=16, muts=2):
    rng = np.random.default_rng(seed)
    seqs = []
    for b in ["".join(rng.choice(AAS, size=length)) for _ in range(n_fam)]:
        for _ in range(per):
            s = list(b)
            for _ in range(muts):
                s[rng.integers(length)] = rng.choice(AAS)
            seqs.append("".join(s))
    return seqs


@pytest.mark.parametrize("block", [None, 1, 32, 95, 96, 1000])
@pytest.mark.parametrize("n, h, k", [(96, 8, 7), (61, 5, 60), (40, 300, 9)])
def test_topk_tie_order_is_lowest_index_first(n, h, k, block):
    """Many equal counts around the k-th slot: the neighbour lists equal a
    stable host sort's and the JAX package's, whatever the row block."""
    sigs = _tie_heavy(n + h, n, h)
    vals, idx = topk_graph.minhash_topk(sigs, k=k, block=block, device="cpu")
    want_vals, want_idx = _stable_topk(sigs, k)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(vals, want_vals)
    jvals, jidx = jtopk.minhash_topk(sigs, k=k)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)
    assert idx.dtype == np.int32 == jidx.dtype and idx.flags.writeable
    assert vals.dtype == np.float64 == jvals.dtype


def test_topk_on_real_signatures_equals_jax():
    seqs = _family_seqs(1, 6, 10, length=30)
    enc = encode(seqs)
    sigs = minhash.minhash_signatures(enc.ascii, enc.lengths, k=2, n_hash=32,
                                      seed=1, device="cpu")
    vals, idx = topk_graph.minhash_topk(sigs, k=5)  # a tensor: its device
    jvals, jidx = jtopk.minhash_topk(minhash.signatures_to_numpy(sigs), k=5)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)


@pytest.mark.parametrize("n, k", [(1, 1), (1, 64), (2, 1), (2, 64), (3, 2),
                                  (5, 5), (5, 64)])
def test_topk_small_n_and_k_at_least_n(n, k):
    """k is cut to max(n - 1, 1); a lone sequence gets index 0 at 0.0."""
    sigs = _tie_heavy(n, n, 6)
    vals, idx = topk_graph.minhash_topk(sigs, k=k, device="cpu")
    jvals, jidx = jtopk.minhash_topk(sigs, k=k)
    assert vals.shape == idx.shape == (n, min(k, max(n - 1, 1)))
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(vals, jvals)
    if n == 1:
        assert idx.tolist() == [[0]] and vals.tolist() == [[0.0]]
    else:
        assert (idx != np.arange(n)[:, None]).all()  # never the row itself


def test_topk_signatures_across_the_sign_bit():
    """Equality of bit patterns: values at and above 2**31 compare like
    any other."""
    sigs = _tie_heavy(9, 30, 6) + np.uint32(0x7FFFFFFF)
    vals, idx = topk_graph.minhash_topk(sigs, k=4, device="cpu")
    want_vals, want_idx = _stable_topk(sigs, 4)
    np.testing.assert_array_equal(idx, want_idx)
    np.testing.assert_array_equal(vals, want_vals)


def test_knn_graph_equals_jax():
    vals = np.array([[0.5, 0.2], [0.5, 0.0], [0.9, 0.0]])
    idx = np.array([[1, 2], [0, 0], [0, 0]])
    adj = topk_graph.knn_graph(vals, idx)
    assert (adj != adj.T).nnz == 0
    assert adj[0, 1] == 0.5 and adj[1, 0] == 0.5
    assert adj[2, 0] == 0.9 and adj[0, 2] == 0.9  # one direction, mirrored
    sigs = _tie_heavy(4, 50, 10)
    v, i = topk_graph.minhash_topk(sigs, k=6, device="cpu")
    for threshold in (0.0, 0.3, 0.6):
        got = topk_graph.knn_graph(v, i, threshold=threshold)
        want = jtopk.knn_graph(v, i, threshold=threshold)
        assert (got != want).nnz == 0
        np.testing.assert_array_equal(got.toarray(), want.toarray())


@pytest.mark.parametrize("kw", [
    {"k": 2, "top_k": 16},
    {"k": 4, "n_hash": 30, "seed": 5, "top_k": 8, "thresh_p": 0.5,
     "resolution": 1.0, "louvain_seed": 3},
    {"k": 2, "top_k": 400, "chunk": 37},
])
def test_cluster_large_equals_jax(kw):
    seqs = _family_seqs(7, 12, 25)
    timings = {}
    got = dt.cluster_large(seqs, device="cpu", timings=timings, **kw)
    np.testing.assert_array_equal(got, jtopk.cluster_large(seqs, **kw))
    assert got.shape == (300,) and got.min() == 1
    assert set(timings) == {"signatures", "topk", "graph", "louvain"}
    assert all(v >= 0 for v in timings.values())


def test_cluster_large_recovers_families():
    seqs = _family_seqs(2, 4, 25)
    mem = dt.cluster_large(seqs, k=2, n_hash=64, top_k=30, thresh_p=0.5,
                           device="cpu")
    labels = np.repeat(np.arange(4), 25)
    # most family pairs co-cluster: a simple purity check
    purity = sum(np.bincount(labels[mem == c]).max() for c in np.unique(mem))
    assert purity / len(seqs) > 0.8


@pytest.mark.parametrize("call", [
    lambda **kw: dt.cluster_large(["ARNDCQ", "ARNDCE", "WWYYPP"], **kw),
    lambda **kw: topk_graph.minhash_topk(
        np.zeros((3, 4), dtype=np.uint32), **kw),
], ids=["cluster_large", "minhash_topk"])
def test_default_device_without_card_raises(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(device="cuda")
