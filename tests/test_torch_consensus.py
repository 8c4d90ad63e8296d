"""The port's MSA and consensus layer on the CPU against the JAX package:
nw_align_pair, the profile and guide-tree helpers, progressive_msa,
consensus_sequence (the cases of tests/test_consensus.py and the DECIPHER
goldens of tests/test_consensus_decipher_goldens.py) and cluster_consensus,
plus a hypothesis fuzz with the IUPAC letters outside the alphabet; the
native row DP against its numpy plain version; and no quiet fallback when
cpp/msa_dp.cpp cannot be built.  Tolerance 0."""

import os
import subprocess

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401
from hypothesis import HealthCheck, given, settings  # noqa: E402
from hypothesis import strategies as st  # noqa: E402

from dynaalign_tpu import consensus as jcons  # noqa: E402
from dynaalign_tpu.consensus import msa as jmsa  # noqa: E402
from dynaalign_tpu import oracle as joracle  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import consensus as cons  # noqa: E402
from dynaalign_torch.consensus import _native  # noqa: E402
from dynaalign_torch.consensus import msa  # noqa: E402
from dynaalign_torch.encode import InvalidSequenceError  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402
from dynaalign_torch.utils import native  # noqa: E402

AA20 = "ARNDCQEGHILKMFPSTWYV"


def _jax_numpy_row_dp(sr, go, ge, monkeypatch):
    """The JAX package's numpy row DP (its native form switched off)."""
    monkeypatch.setenv("DYNAALIGN_MSA_NATIVE", "0")
    try:
        return jmsa._row_dp(sr, go, ge)
    finally:
        monkeypatch.delenv("DYNAALIGN_MSA_NATIVE")


def _random_pairs(seed, count, lo, hi, letters=AA20):
    rng = np.random.default_rng(seed)

    def one():
        return "".join(rng.choice(list(letters), size=int(rng.integers(lo, hi))))

    return [(one(), one()) for _ in range(count)]


PAIRS = [("ARNDCQ", "ARNDCQ"), ("ARNDCQEG", "ARNDEG"),
         ("ARNDCQEG", "ARNYCQEG"), ("YTM", "HLQIG"), ("A", "W"),
         ("AJUOX", "ALCKX"), ("BZX*", "NQXA")]


@pytest.mark.parametrize("gaps", [(10, 4), (12, 2), (5, 1)])
@pytest.mark.parametrize("matrix", ["BLOSUM62", "BLOSUM45", "BLOSUM80"])
def test_nw_align_pair_equals_jax(matrix, gaps):
    go, ge = gaps
    for s1, s2 in PAIRS + _random_pairs(go * 7 + ge, 25, 1, 60):
        got = cons.nw_align_pair(s1, s2, matrix, go, ge)
        assert got == jcons.nw_align_pair(s1, s2, matrix, go, ge), (s1, s2)
        a, b = got
        assert a.replace("-", "") == s1 and b.replace("-", "") == s2


def test_nw_align_pair_identity_equals_oracle():
    """Percent identity recomputed from the gapped strings equals the
    serial oracle's (the reference's greedy traceback)."""
    for s1, s2 in _random_pairs(3, 40, 1, 60):
        a, b = cons.nw_align_pair(s1, s2)
        matches = sum(x == y != "-" for x, y in zip(a, b))
        assert matches / len(a) == joracle.nw_pair(s1, s2, "BLOSUM62", 10, 4)


MSA_CASES = [
    ["ARNDCQEG"] * 4,
    ["ARNDCQEG", "ARNDCEG", "ARNDCQEG", "ARNCQEG"],
    ["ARND"],
    [],
    ["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ", "MKTAYIAKQRISFVKSHFSRQLEERLGLIEVQ",
     "MKTAYIAKQRQISFVKSHFSRQLEERLG", "KTAYIAKQRQISFVKSHFSRQLEERLGLIEVQW"],
    ["AJUO", "ALCK", "AJJO", "XBZ*"],
]


@pytest.mark.parametrize("gaps", [(10, 2), (10, 4)])
@pytest.mark.parametrize("case", range(len(MSA_CASES)))
def test_progressive_msa_equals_jax(case, gaps):
    seqs = MSA_CASES[case]
    got = cons.progressive_msa(seqs, gap_open=gaps[0], gap_ext=gaps[1])
    assert got == jcons.progressive_msa(seqs, gap_open=gaps[0],
                                        gap_ext=gaps[1])
    assert len({len(s) for s in got}) <= 1
    assert [s.replace("-", "") for s in got] == seqs


def test_msa_helpers_equal_jax():
    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list(AA20), size=int(k)))
            for k in rng.integers(3, 40, size=25)]
    dist = msa._kmer_distance(seqs)
    np.testing.assert_array_equal(dist, jmsa._kmer_distance(seqs))
    assert msa._upgma_order(dist) == jmsa._upgma_order(dist)
    p1 = rng.random((30, msa.N_CHANNELS))
    p2 = rng.random((17, msa.N_CHANNELS))
    sub = msa._sub_f64("BLOSUM62")
    np.testing.assert_array_equal(msa._profile_scores(p1, p2, sub),
                                  jmsa._profile_scores(p1, p2, sub))
    for got, want in zip(msa._merge_profiles(p1, p2, sub, 10, 2),
                         jmsa._merge_profiles(p1, p2, sub, 10, 2)):
        np.testing.assert_array_equal(got, want)
    idx = rng.integers(0, 24, size=12)
    np.testing.assert_array_equal(msa._seq_profile(idx),
                                  jmsa._seq_profile(idx))


# (aligned, kwargs, expected): tests/test_consensus.py and the DECIPHER
# goldens, whose expected strings both packages must give
CONSENSUS_CASES = [
    (["ARND", "ARND", "ARNE"], {}, "ARNX"),
    (["ARND", "ARND", "ARNE"], {"threshold": 0.4}, "ARND"),
    (["AN", "AD"], {}, "AB"),
    (["AQ", "AE"], {}, "AZ"),
    (["AI", "AL"], {}, "AJ"),
    (["A-ND", "A-ND", "ARND"], {}, "A-ND"),
    (["MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"] * 7, {},
     "MKTAYIAKQRQISFVKSHFSRQLEERLGLIEVQ"),
    (["AN", "AB"], {}, "AB"),
    (["AQ", "AZ"], {}, "AZ"),
    (["AI", "AJ", "AL"], {}, "AJ"),
    (["AN", "AB"], {"ambiguity": False}, "A+"),
    (["D"] * 19 + ["E"], {}, "D"),
    (["D"] * 18 + ["E"] * 2, {}, "X"),
    (["D"] * 18 + ["E"] * 2, {"threshold": 0.2}, "D"),
    (["D"] * 6 + ["-"] * 4, {"include_terminal_gaps": True}, "+"),
    (["D"] * 6 + ["-"] * 4,
     {"include_terminal_gaps": True, "min_information": 0.5}, "D"),
    (["ARNDE", "ARND-", "ARND-"], {}, "ARNDE"),
    (["ARNDE", "ARND-", "ARND-"], {"include_terminal_gaps": True}, "ARND-"),
    (["AR--", "AR--"], {}, "AR--"),
    (["A"] * 9 + ["X"], {}, "X"),
    (["A"] * 9 + ["X"], {"threshold": 0.12}, "A"),
    (["D"] * 10, {}, "D"),
    (["N" * 3, "D" * 3], {}, "BBB"),
    (["Q", "E"], {}, "Z"),
    (["I", "L"], {}, "J"),
    (["N", "B"], {}, "B"),
    (["N", "B"], {"ambiguity": False}, "+"),
    (["A", "V"], {}, "X"),
    (["ADC", "A-C", "A-C", "A-C"], {}, "A-C"),
    (["A" + c + "C" for c in ["D"] * 6 + ["-"] * 4], {}, "A+C"),
    (["A" + c + "C" for c in ["D"] * 6 + ["-"] * 4],
     {"min_information": 0.5}, "ADC"),
    (["A" + c + "C" for c in ["D"] * 6 + ["-"] * 4], {"threshold": 0.45},
     "ADC"),
    (["A" + c + "C" for c in ["D"] * 6 + ["-"] * 4],
     {"no_consensus_char": "?"}, "A?C"),
    (["MKTAYIAKQR", "MKTAYIAKQR", "MKTAYLAKQR", "MKTAYIAKQR", "MKSAYIAKQR"],
     {}, "MKXAYJAKQR"),
    ([], {}, ""),
]


@pytest.mark.parametrize("case", range(len(CONSENSUS_CASES)))
def test_consensus_sequence_equals_jax(case):
    aligned, kw, expected = CONSENSUS_CASES[case]
    got = cons.consensus_sequence(aligned, **kw)
    assert got == jcons.consensus_sequence(aligned, **kw) == expected
    assert cons.consensus_sequence(list(np.array(aligned, dtype=str)),
                                   **kw) == got


def test_consensus_sequence_rejects_unequal_lengths():
    for mod in (cons, jcons):
        with pytest.raises(ValueError, match="equal length"):
            mod.consensus_sequence(["AB", "ABC"])


def _reference_example():
    # the mock clustered matrix of the reference docs
    # (R/clusterbreak.R:295-305)
    return np.array(
        [["AAAA", "1"], ["AAAB", "1"], ["AAAC", "1"], ["BBBB", "2"],
         ["BBBC", "2"], ["BBBB", "2"], ["CCCC", "3"], ["CCCD", "3"]],
        dtype=object)


def _evp_clusters():
    seqs = load_sequences("evp_peparray", 90)
    return np.array([(s, f"{1 + i % 4}.{i % 3}") for i, s in enumerate(seqs)],
                    dtype=object)


@pytest.mark.parametrize("kw", [{}, {"threshold": 0.2},
                                {"matrix_name": "BLOSUM45"},
                                {"ambiguity": False,
                                 "include_terminal_gaps": True}])
@pytest.mark.parametrize("df", [_reference_example, _evp_clusters,
                                lambda: [("ARND", "a"), ("ARNE", "b"),
                                         ("ARNE", "a")]],
                         ids=["reference_example", "evp", "list"])
def test_cluster_consensus_equals_jax(df, kw):
    data = df()
    got = cons.cluster_consensus(data, **kw)
    want = jcons.cluster_consensus(data, **kw)
    assert got.dtype == object and got.shape == want.shape
    assert got.tolist() == want.tolist()
    # first-seen cluster order
    seen = list(dict.fromkeys(np.asarray(data, dtype=object)[:, 1]))
    assert list(got[:, 0]) == seen


def test_cluster_consensus_validation():
    for mod in (cons, jcons):
        with pytest.raises(ValueError, match=r"\[n, 2\]"):
            mod.cluster_consensus(np.array(["AAAA", "BBBB"], dtype=object))
    with pytest.raises(ValueError, match="Invalid substitution matrix"):
        cons.cluster_consensus(_reference_example(), matrix_name="PAM250")
    with pytest.raises(InvalidSequenceError):
        cons.progressive_msa(["ARND", "AR1D"])


_LETTERS = AA20 + "JUOXBZ"


@settings(max_examples=40, deadline=None,
          suppress_health_check=[HealthCheck.too_slow])
@given(st.lists(st.text(alphabet=_LETTERS, min_size=4, max_size=20),
                min_size=2, max_size=6),
       st.sampled_from([0.05, 0.2]))
def test_fuzz_msa_and_consensus_equal_jax(seqs, threshold):
    aligned = cons.progressive_msa(seqs)
    assert aligned == jcons.progressive_msa(seqs)
    assert cons.consensus_sequence(aligned, threshold) == (
        jcons.consensus_sequence(aligned, threshold))
    df = np.array([(s, str(i % 2)) for i, s in enumerate(seqs)],
                  dtype=object)
    assert cons.cluster_consensus(df).tolist() == (
        jcons.cluster_consensus(df).tolist())


def test_native_row_dp_bit_identical_to_numpy(monkeypatch):
    """cpp/msa_dp.cpp gives the numpy traceback bit for bit, on smooth
    scores and on tie-prone integer ones; so does the JAX package's numpy
    row DP."""
    assert msa._row_dp is _native.native_row_dp
    rng = np.random.default_rng(11)
    for m, n in [(1, 1), (5, 3), (40, 40), (64, 57), (200, 180), (0, 4),
                 (3, 0)]:
        for go, ge in [(10.0, 4.0), (12.0, 0.5), (10, 2)]:
            sr = rng.integers(-8, 12, size=(m, n)).astype(np.float64)
            if rng.random() < 0.5:
                sr += rng.normal(0, 0.25, size=(m, n)).round(2)
            got = _native.native_row_dp(sr, go, ge)
            assert got.dtype == np.uint8 and got.shape == (m + 1, n + 1)
            np.testing.assert_array_equal(got, msa._numpy_row_dp(sr, go, ge))
            np.testing.assert_array_equal(
                got, _jax_numpy_row_dp(sr, go, ge, monkeypatch))


def test_swapping_in_the_plain_row_dp_gives_the_same_consensus(monkeypatch):
    data = _evp_clusters()
    native_out = cons.cluster_consensus(data)
    monkeypatch.setattr(msa, "_row_dp", msa._numpy_row_dp)
    assert cons.cluster_consensus(data).tolist() == native_out.tolist()


def test_no_environment_switch(monkeypatch):
    """The JAX package's DYNAALIGN_MSA_NATIVE=0 does not reach the port:
    the native row DP runs (the plain version, made to fail, is never
    called)."""
    monkeypatch.setenv("DYNAALIGN_MSA_NATIVE", "0")

    def refuse(*args):
        raise AssertionError("the plain row DP ran")

    monkeypatch.setattr(msa, "_numpy_row_dp", refuse)
    assert cons.nw_align_pair("ARNDCQEG", "ARNDEG") == ("ARNDCQEG",
                                                        "ARND--EG")


def test_native_row_dp_checks_its_input():
    with pytest.raises(ValueError, match="2-D"):
        _native.native_row_dp(np.zeros(3), 10.0, 4.0)


def test_failed_msa_build_raises(monkeypatch, tmp_path):
    """No quiet fallback: a msa_dp.cpp the compiler refuses raises, and so
    does the aligner when its library cannot be built."""
    (tmp_path / "msa_dp.cpp").write_text("this is not C++\n")
    monkeypatch.setattr(native, "CPP_DIR", str(tmp_path))
    with pytest.raises(subprocess.CalledProcessError):
        native.build_library("msadp_broken", ("msa_dp.cpp",))
    _native._lib.cache_clear()
    try:
        with pytest.raises(subprocess.CalledProcessError):
            cons.nw_align_pair("ARND", "ARNE")
        with pytest.raises(subprocess.CalledProcessError):
            dt.cluster_consensus(_reference_example())
    finally:
        _native._lib.cache_clear()


def test_msa_library_builds_into_its_own_directory():
    so = native.build_library("msadp", ("msa_dp.cpp",))
    assert os.path.basename(os.path.dirname(so)) == "msadp"
    assert os.path.basename(so).startswith("libmsadp-")
    assert "-std=c++17" in native.CXX_FLAGS
    assert not any("fast-math" in f or "gnu++" in f for f in native.CXX_FLAGS)
