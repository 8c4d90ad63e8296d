"""The port's MinHash modules on the CPU against the JAX package and the
seeded C++ oracle: hashes, signatures, agreement counts, similarity_mh and
MinHashEngine.  Tolerance 0 throughout: the values are integers, or
float64 quotients of equal integers."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as dj  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402
from dynaalign_tpu.ops import minhash as jminhash  # noqa: E402
from dynaalign_tpu.ops.murmur3 import (  # noqa: E402
    murmur3_kmer_hashes as jhashes,
)
from dynaalign_tpu.utils import hash_family_seeds as jseeds  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import oracle  # noqa: E402
from dynaalign_torch.encode import encode  # noqa: E402
from dynaalign_torch.ops import minhash  # noqa: E402
from dynaalign_torch.ops.murmur3 import (  # noqa: E402
    murmur3_kmer_hashes,
    seeds_tensor,
)
from dynaalign_torch.utils import MT19937, hash_family_seeds  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")
# murmur seeds on both sides of 2**31, and the corners
SEEDS = np.array([0, 1, 0x7FFFFFFF, 0x80000000, 0x80000001, 0xDEADBEEF,
                  0xFFFFFFFF, 12345], dtype=np.uint32)


def _seqs(seed, n, lo, hi):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(AAS, size=k))
            for k in rng.integers(lo, hi + 1, size=n)]


def _sigs(seqs, **kw):
    enc = encode(seqs, validate=False)
    return minhash.signatures_to_numpy(minhash.minhash_signatures(
        enc.ascii, enc.lengths, device="cpu", **kw))


@pytest.mark.parametrize("seed", [0, 1, 12345, 2**31, 2**32 - 1])
def test_hash_family_equals_jax_and_oracle(seed):
    got = hash_family_seeds(64, seed)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, jseeds(64, seed))
    np.testing.assert_array_equal(got, oracle.hash_family(64, seed))
    np.testing.assert_array_equal(got, joracle.hash_family(64, seed))
    assert (got >= 2**31).any() and (got < 2**31).any()
    assert MT19937(seed).next_u32() == got[0]


def test_seeds_keep_their_bits_on_the_way_to_a_tensor():
    t = seeds_tensor(SEEDS, "cpu")
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), SEEDS)


@pytest.mark.parametrize("k", range(1, 10))
def test_kmer_hashes_equal_jax_and_oracle(k):
    """The block loop (k // 4) and the tail (k & 3) are separate code."""
    seqs = _seqs(k, 12, k, 30)
    enc = encode(seqs)
    got = murmur3_kmer_hashes(torch.from_numpy(enc.ascii), k,
                              seeds_tensor(SEEDS, "cpu"))
    assert got.dtype == torch.int32
    got = got.numpy().view(np.uint32)
    np.testing.assert_array_equal(got, np.asarray(jhashes(enc.ascii, k, SEEDS)))
    for i, s in enumerate(seqs[:4]):
        for p in range(len(s) - k + 1):
            for hi, seed in enumerate(SEEDS):
                assert got[i, p, hi] == oracle.murmur3_32(
                    s[p : p + k].encode(), int(seed)), (i, p, hi)


def test_kmer_hashes_errors():
    tok = torch.zeros((2, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="'k' must be a positive integer"):
        murmur3_kmer_hashes(tok, 0, seeds_tensor(SEEDS, "cpu"))
    with pytest.raises(ValueError, match="padded length 3 < k=4"):
        murmur3_kmer_hashes(tok, 4, seeds_tensor(SEEDS, "cpu"))


def test_port_oracle_minhash_equals_jax_oracle():
    seqs = _seqs(3, 20, 0, 25)
    assert oracle.murmur3_32(b"", 7) == joracle.murmur3_32(b"", 7)
    assert oracle.murmur3_32(b"ARNDC", 2**31) == joracle.murmur3_32(
        b"ARNDC", 2**31)
    np.testing.assert_array_equal(oracle.minhash_signatures(seqs, 3, 20, 9),
                                  joracle.minhash_signatures(seqs, 3, 20, 9))
    np.testing.assert_array_equal(oracle.minhash_similarity(seqs, 3, 20, 9),
                                  joracle.minhash_similarity(seqs, 3, 20, 9))


@pytest.mark.parametrize("k, n_hash, seed", [
    (2, 50, 7), (4, 50, 7), (5, 17, 0), (1, 8, 3), (9, 300, 2**31 + 5),
])
def test_signatures_equal_jax_and_oracle(k, n_hash, seed):
    """Lengths from 0 up, so some sequences are shorter than k and keep
    the all-UINT32_MAX signature."""
    seqs = _seqs(k + n_hash, 50, 0, 60)
    assert min(map(len, seqs)) < k
    got = _sigs(seqs, k=k, n_hash=n_hash, seed=seed)
    assert got.dtype == np.uint32 and got.shape == (50, n_hash)
    enc = encode(seqs, validate=False)
    np.testing.assert_array_equal(got, np.asarray(jminhash.minhash_signatures(
        enc.ascii, enc.lengths, k=k, n_hash=n_hash, seed=seed)))
    np.testing.assert_array_equal(
        got, oracle.minhash_signatures(seqs, k, n_hash, seed))
    short = [i for i, s in enumerate(seqs) if len(s) < k]
    assert (got[short] == 0xFFFFFFFF).all()


@pytest.mark.parametrize("chunk", [1, 16, 69, 70, 512])
def test_signatures_chunk_boundaries(chunk):
    seqs = _seqs(5, 70, 8, 30)
    np.testing.assert_array_equal(
        _sigs(seqs, k=3, n_hash=16, chunk=chunk),
        oracle.minhash_signatures(seqs, 3, 16, 0))


def test_signatures_default_chunk_follows_the_byte_budget(monkeypatch):
    seqs = _seqs(6, 40, 8, 30)
    want = oracle.minhash_signatures(seqs, 3, 16, 0)
    calls = []
    real = minhash._signatures_chunk

    def counted(*args):
        calls.append(args[0].shape[0])
        return real(*args)

    monkeypatch.setattr(minhash, "_signatures_chunk", counted)
    # room for 3 sequences of P = 28 windows x 16 hashes x 4 bytes
    monkeypatch.setattr(minhash, "HASH_BYTES", 3 * 28 * 16 * 4)
    np.testing.assert_array_equal(_sigs(seqs, k=3, n_hash=16), want)
    assert calls == [3] * 13 + [1]


def test_padded_length_below_k_is_all_max_without_hashing():
    seqs = ["AR", "N", ""]
    got = _sigs(seqs, k=4, n_hash=6)
    assert (got == 0xFFFFFFFF).all()
    np.testing.assert_array_equal(got, oracle.minhash_signatures(seqs, 4, 6, 0))
    sims = dt.similarity_mh(seqs, 4, 6, device="cpu")
    np.testing.assert_array_equal(sims, np.ones((3, 3)))
    np.testing.assert_array_equal(sims, dj.similarity_mh(seqs, 4, 6))


def test_too_short_sequences_score_one_against_each_other():
    seqs = ["ARNDCQEGHI", "AR", "NDC", "ARNDCQEGHI"]
    sims = dt.similarity_mh(seqs, 4, 20, device="cpu")
    assert sims[1, 2] == 1.0 and sims[0, 1] == 0.0 and sims[0, 3] == 1.0
    np.testing.assert_array_equal(sims, oracle.minhash_similarity(seqs, 4, 20))


@pytest.mark.parametrize("n_hash", [50, 300])
@pytest.mark.parametrize("block", [None, 7, 64])
def test_agreement_counts_are_int32_and_equal_jax(n_hash, block):
    """Public count dtype: int32 whatever n_hash is (the JAX package hands
    out uint8 up to 255)."""
    rng = np.random.default_rng(n_hash)
    sigs = rng.integers(0, 4, size=(45, n_hash)).astype(np.uint32)
    sigs[::5] |= 0x80000000  # values on both sides of 2**31
    got = minhash.signature_agreement_counts(sigs, block=block, device="cpu")
    assert got.dtype == torch.int32 and got.shape == (45, 45)
    want = (sigs[:, None, :] == sigs[None, :, :]).sum(-1)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jminhash.signature_agreement_counts(sigs)))
    sims = minhash.signature_similarity(sigs, block=block, device="cpu")
    assert sims.dtype == np.float64 and (np.diag(sims) == 1.0).all()
    np.testing.assert_array_equal(sims, jminhash.signature_similarity(sigs))


@pytest.mark.parametrize("n_hash, dtype", [
    (1, np.uint8), (50, np.uint8), (255, np.uint8), (256, np.int16),
    (32767, np.int16), (32768, np.int32), (40000, np.int32)])
def test_fetch_counts_picks_the_width_from_n_hash(n_hash, dtype):
    counts = torch.from_numpy(np.random.default_rng(n_hash).integers(
        0, n_hash + 1, size=(40, 40), dtype=np.int32))
    counts[0, 1] = n_hash
    got = minhash.fetch_counts(counts, n_hash)
    assert got.dtype == dtype and counts.dtype == torch.int32
    np.testing.assert_array_equal(got, counts.numpy())


# 256 rows run on the calling thread; 1,100 (9.7 MB of float64) in row
# blocks on the pool wherever torch has more than one intra-op thread
@pytest.mark.parametrize("n", [256, 1100])
@pytest.mark.parametrize("n_hash", [1, 50, 255, 256, 300, 40000])
def test_counts_to_similarity_is_the_float64_quotient(n_hash, n):
    """Every count 0..n_hash through fetch_counts and counts_to_similarity
    gives Python's float(c) / n_hash, bit for bit; the diagonal is 1.0; and
    each call returns an array of its own."""
    assert (n * n * 8 < 2 * minhash.SIMILARITY_BLOCK_BYTES) == (n == 256)
    rng = np.random.default_rng(n_hash)
    counts = rng.integers(0, n_hash + 1, size=(n, n), dtype=np.int32)
    off = ~np.eye(n, dtype=bool)  # every count off the diagonal
    counts[off] = rng.permutation(np.arange(off.sum()) % (n_hash + 1))
    fetched = minhash.fetch_counts(torch.from_numpy(counts), n_hash)
    got = minhash.counts_to_similarity(fetched, n_hash)
    quotient = np.array([float(c) / n_hash for c in range(n_hash + 1)])
    want = quotient[counts]
    np.fill_diagonal(want, 1.0)
    assert got.dtype == np.float64 and got.shape == (n, n)
    np.testing.assert_array_equal(got.view(np.int64), want.view(np.int64))
    again = minhash.counts_to_similarity(fetched, n_hash)
    assert not np.shares_memory(got, again)
    assert not np.shares_memory(got, fetched)
    np.testing.assert_array_equal(again.view(np.int64), want.view(np.int64))


def test_signature_tensors_are_checked():
    with pytest.raises(ValueError, match="int32"):
        minhash.signature_agreement_counts(torch.zeros((3, 4)))
    with pytest.raises(ValueError, match=r"\[N, H\]"):
        minhash.signature_agreement_counts(np.zeros(4, dtype=np.uint32),
                                           device="cpu")


@pytest.mark.parametrize("k, n_hash, seed", [(4, 50, 0), (2, 50, 3),
                                             (3, 300, 2**31)])
def test_similarity_mh_equals_jax_and_oracle(k, n_hash, seed):
    seqs = _seqs(11, 80, 0, 40) + ["x?J", "ARND", "ARND"]
    got = dt.similarity_mh(seqs, k, n_hash, seed=seed, device="cpu")
    assert got.dtype == np.float64 and got.shape == (83, 83)
    np.testing.assert_array_equal(got, dj.similarity_mh(seqs, k, n_hash,
                                                        seed=seed))
    np.testing.assert_array_equal(
        got, oracle.minhash_similarity(seqs, k, n_hash, seed))
    np.testing.assert_array_equal(
        got, dt.similarity_mh(seqs, k, n_hash, seed=seed, device="cpu",
                              chunk=9, block=5))


def test_similarity_mh_evp_equals_oracle():
    from dynaalign_torch.io.datasets import load_sequences

    seqs = load_sequences("evp_peparray", 200)
    np.testing.assert_array_equal(dt.similarity_mh(seqs, 2, 50, device="cpu"),
                                  oracle.minhash_similarity(seqs, 2, 50, 0))


@pytest.mark.parametrize("args, match", [
    (([],), "Input sequences vector cannot be empty"),
    ((["ARND"], 0), "'k' must be a positive integer"),
    ((["ARND"], -2), "'k' must be a positive integer"),
    ((["ARND"], 2, 0), "Number of hash functions must be positive"),
])
def test_similarity_mh_value_errors(args, match):
    with pytest.raises(ValueError, match=match):
        dt.similarity_mh(*args, device="cpu")
    with pytest.raises(ValueError, match=match):
        dj.similarity_mh(*args)
    with pytest.raises(ValueError, match=match):
        dt.MinHashEngine(*args, device="cpu")


def _motif_set():
    rng = np.random.default_rng(3)
    seqs = []
    for m in ["".join(rng.choice(AAS, size=12)) for _ in range(12)]:
        for _ in range(8):
            s = list(m)
            s[rng.integers(12)] = rng.choice(AAS)
            seqs.append("".join(s))
    return seqs + [seqs[0]]  # a duplicate shares its signature row


@pytest.mark.parametrize("cache_counts", [None, True, False])
def test_minhash_engine_serves_subsets(cache_counts):
    seqs = _motif_set()
    eng = dt.MinHashEngine(seqs, k=2, n_hash=50, seed=0, device="cpu",
                           cache_counts=cache_counts)
    jeng = dj.MinHashEngine(seqs, k=2, n_hash=50, seed=0)
    for sub in (seqs, seqs[:7], [seqs[90], seqs[3], seqs[3]], [seqs[-1]]):
        got = eng(sub)
        np.testing.assert_array_equal(got, jeng(sub))
        np.testing.assert_array_equal(
            got, dt.similarity_mh(sub, 2, 50, device="cpu"))
    with pytest.raises(KeyError, match="WWWWWWWWWWWW"):
        eng(["WWWWWWWWWWWW"])
    with pytest.raises(ValueError, match="cannot be empty"):
        eng([])


def test_minhash_engine_returns_a_fresh_array_each_call():
    """clusterbreak zeroes its sim_fn's matrix in place."""
    seqs = _motif_set()[:20]
    eng = dt.MinHashEngine(seqs, k=2, n_hash=50, device="cpu")
    first = eng(seqs)
    want = first.copy()
    first[:] = -1.0
    np.testing.assert_array_equal(eng(seqs), want)
    assert eng(seqs[:5]).flags.writeable


@pytest.mark.parametrize("cache_counts", [True, False])
def test_minhash_engine_from_the_jax_signatures(cache_counts):
    """The JAX engine's state, its uint32 signatures, carried into the
    port's engine: every subset matrix is equal."""
    seqs = _motif_set()
    enc = encode(seqs, validate=False)
    jsigs = np.asarray(jminhash.minhash_signatures(
        enc.ascii, enc.lengths, k=2, n_hash=50, seed=4))
    assert jsigs.dtype == np.uint32
    eng = dt.MinHashEngine.from_signatures(
        seqs, jsigs, k=2, n_hash=50, seed=4, device="cpu",
        cache_counts=cache_counts)
    jeng = dj.MinHashEngine(seqs, k=2, n_hash=50, seed=4)
    assert (eng.k, eng.n_hash, eng.seed) == (2, 50, 4)
    for sub in (seqs, seqs[10:31], [seqs[96], seqs[0]]):
        np.testing.assert_array_equal(eng(sub), jeng(sub))
    with pytest.raises(ValueError, match="signatures of shape"):
        dt.MinHashEngine.from_signatures(seqs, jsigs[:5], k=2, n_hash=50,
                                         seed=4, device="cpu")


def test_labels_1n():
    from dynaalign_tpu.api import labels_1n as jlabels

    from dynaalign_torch.api import labels_1n

    assert labels_1n(3) == ["1", "2", "3"] == jlabels(3)


def _engine_from_signatures(seqs, device=None):
    return dt.MinHashEngine.from_signatures(
        seqs, np.zeros((len(seqs), 50), dtype=np.uint32), k=2, n_hash=50,
        seed=0, device=device)


@pytest.mark.parametrize("call", [
    lambda s, **kw: dt.similarity_mh(s, **kw),
    lambda s, **kw: dt.MinHashEngine(s, **kw),
    _engine_from_signatures,
    lambda s, **kw: minhash.minhash_signatures(
        encode(s).ascii, encode(s).lengths, **kw),
    lambda s, **kw: minhash.signature_agreement_counts(
        np.zeros((2, 4), dtype=np.uint32), **kw),
    lambda s, **kw: minhash.signature_similarity(
        np.zeros((2, 4), dtype=np.uint32), **kw),
], ids=["similarity_mh", "MinHashEngine", "from_signatures",
        "minhash_signatures", "signature_agreement_counts",
        "signature_similarity"])
def test_default_device_without_card_raises(call, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(["ARND", "ARNE"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call(["ARND", "ARNE"], device="cuda")
