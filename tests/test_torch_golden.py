"""Golden values of tests/test_golden.py, with the same constants, through
the port: its mt19937 hash family, its murmur3 (the tensor hash and the
oracle binding), its oracle, and similarity_mh / similarity_nw on the CPU.
They pin the port's absolute values, not only its agreement with the JAX
package."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from dynaalign_torch import oracle, similarity_mh, similarity_nw  # noqa: E402
from dynaalign_torch.ops.murmur3 import (  # noqa: E402
    murmur3_kmer_hashes,
    seeds_tensor,
)
from dynaalign_torch.utils import hash_family_seeds  # noqa: E402


def test_hash_family_golden():
    # first outputs of std::mt19937(0) — known constants
    want = np.array([2357136044, 2546248239, 3071714933], dtype=np.uint32)
    np.testing.assert_array_equal(hash_family_seeds(3, 0), want)
    np.testing.assert_array_equal(oracle.hash_family(3, 0), want)


def _tensor_murmur(key: bytes, seed: int) -> int:
    """murmur3_32 of the whole key as the one window of length len(key)."""
    tok = torch.tensor([list(key)], dtype=torch.uint8)
    seeds = seeds_tensor(np.array([seed], dtype=np.uint32), "cpu")
    bits = murmur3_kmer_hashes(tok, len(key), seeds)
    assert bits.shape == (1, 1, 1)
    return int(bits.numpy().view(np.uint32)[0, 0, 0])


def test_murmur_golden():
    # public murmur3_32 test vectors
    assert oracle.murmur3_32(b"", 0) == 0
    assert oracle.murmur3_32(b"", 1) == 0x514E28B7
    assert oracle.murmur3_32(b"abcd", 0) == 0x43ED676A
    assert oracle.murmur3_32(b"Hello, world!", 1234) == 0xFAF6CDB3
    # the tensor hash takes windows of k >= 1 bytes: the non-empty vectors
    assert _tensor_murmur(b"abcd", 0) == 0x43ED676A
    assert _tensor_murmur(b"Hello, world!", 1234) == 0xFAF6CDB3


def test_minhash_similarity_golden():
    seqs = ["ARNDCQEG", "ARNDCQEG", "ARNDCEGQ", "WWWWYYYY"]
    sim = similarity_mh(seqs, k=2, n_hash=20, seed=42, device="cpu")
    np.testing.assert_array_equal(sim[0], sim[1])
    assert sim[0, 1] == 1.0
    # identical 2-mers except boundary effects: high but not 1
    assert 0.3 < sim[0, 2] < 1.0
    assert sim[0, 3] == 0.0
    # exact value pinned (matches/20 is a multiple of 0.05)
    assert (sim * 20 == np.round(sim * 20)).all()
    np.testing.assert_array_equal(
        sim, oracle.minhash_similarity(seqs, k=2, n_hash=20, seed=42))


def test_nw_similarity_golden():
    # hand-checkable cases under BLOSUM62, gapOpen=10, gapExt=4
    sims = similarity_nw(["AAAA", "AAAA", "AAGA", "AAAAAA"], device="cpu")
    assert sims[0, 1] == 1.0
    assert sims[0, 2] == 0.75  # one mismatch over 4 aligned columns
    # AAAA vs AAAAAA: 4 matches over alignment length 6
    np.testing.assert_allclose(sims[0, 3], 4 / 6)


def test_nw_gap_asymmetry_golden():
    """Border gaps cost gapOpen + (len-1)*gapExt while interior openings
    cost gapOpen + gapExt (the reference's off-by-one asymmetry,
    src/pairwiseSeqAlign.cpp:226 vs :255) — this pins that behavior."""
    # oracle and the port agree on a case that exercises interior gaps
    a, b = "WAAAW", "WAW"
    got = similarity_nw([a, b], device="cpu")[0, 1]
    assert got == oracle.nw_pair(a, b)
