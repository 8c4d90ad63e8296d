"""The references equal the C++ oracle and the port's plain versions at a
small size, on the CPU."""

import numpy as np
import pytest
import torch

from portbench import generate
from portbench.reference import minhash, nw

CPU = torch.device("cpu")
NW = {"matrix_name": "BLOSUM62", "gap_open": 10, "gap_ext": 4}


def _h3n2(n):
    return generate.dataset("h3n2sample", "sequence")[:n]


def test_blosum62_equals_the_port_and_the_upstream_letters():
    from dynaalign_torch import blosum

    got = nw.substitution_table("BLOSUM62")
    assert np.array_equal(got, blosum.get_matrix("BLOSUM62").numpy())
    assert nw.ALPHABET == "ARNDCQEGHILKMFPSTWYVBZX*"


@pytest.mark.parametrize("gaps", [(10, 4), (5, 1)])
def test_nw_equals_the_oracle(gaps):
    from dynaalign_torch import oracle

    seqs = _h3n2(10) + ["", "W", "ARND", _h3n2(11)[10][:37]]
    n = len(seqs)
    pairs = np.stack(np.triu_indices(n), axis=1)
    settings = {**NW, "gap_open": gaps[0], "gap_ext": gaps[1]}
    mt, ln = nw.pair_counts(seqs, pairs, settings, CPU)
    got = nw.ratio(mt, ln)
    want = oracle.nw_similarity(seqs, "BLOSUM62", *gaps)
    assert np.array_equal(got, want[pairs[:, 0], pairs[:, 1]],
                          equal_nan=True)
    assert np.isnan(got[(pairs[:, 0] == 10) & (pairs[:, 1] == 10)]).all()


def test_nw_batches_by_length_without_changing_answers(monkeypatch):
    seqs = [s[:n] for s, n in zip(_h3n2(8), (300, 41, 566, 7, 120, 0, 566,
                                              250))]
    pairs = np.stack(np.triu_indices(len(seqs)), axis=1)
    whole = nw.pair_counts(seqs, pairs, NW, CPU)
    monkeypatch.setattr(nw, "BATCH_ELEMENTS", 2000)
    assert all(np.array_equal(a, b) for a, b in zip(
        whole, nw.pair_counts(seqs, pairs, NW, CPU)))


def test_float32_ratio_differs():
    mt = np.array([501, 377, 1, 0])
    ln = np.array([566, 569, 3, 0])
    lo = nw.ratio(mt, ln, np.float32)
    hi = nw.ratio(mt, ln)
    assert (lo[:3] != hi[:3]).all() and np.isnan(lo[3]) and np.isnan(hi[3])


def test_hash_family_and_signatures_equal_the_oracle():
    from dynaalign_torch import oracle

    assert minhash.mt19937_outputs(2**31 + 9, 60) == list(
        oracle.hash_family(60, 2**31 + 9))
    seqs = _h3n2(6) + generate.dataset("allunique", "peptides")[:20] + [
        "", "AR", "ARN", "ARNDC"]
    for k, h, seed in [(4, 50, 0), (2, 17, 5), (5, 8, 2**32 - 1),
                       (9, 4, 3)]:
        got = minhash.signatures(seqs, k, h, seed, CPU).numpy()
        assert np.array_equal(got, oracle.minhash_signatures(
            seqs, k, h, seed).astype(np.int64))


def test_similarity_equals_the_oracle():
    from dynaalign_torch import oracle

    seqs = generate.dataset("h3n2ha1415", "sequence")[:30] + ["", "AB"]
    n = len(seqs)
    pairs = np.stack(np.triu_indices(n), axis=1)
    sigs = minhash.signatures(seqs, 4, 50, 0, CPU)
    got = minhash.similarity(minhash.pair_agreements(sigs, pairs), pairs,
                             50)
    want = oracle.minhash_similarity(seqs, 4, 50, 0)
    assert np.array_equal(got, want[pairs[:, 0], pairs[:, 1]])
