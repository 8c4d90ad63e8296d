"""The port's host layers on the CPU against the JAX package: sequence
files (FASTA, text, CSV, dataset names), the R .rds/.rda reader on files
written here and the dataset fallback to it, the similarity statistics,
the pure-R MinHash twin, the plots, and the profiler's trace (the span
recorder: ``test_torch_profiling.py``)."""

import gzip
import os
import struct

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from dynaalign_tpu.analysis import stats as jstats  # noqa: E402
from dynaalign_tpu.io import rda as jrda  # noqa: E402
from dynaalign_tpu.io import seqio as jseqio  # noqa: E402
from dynaalign_tpu.models import reference_r as jref  # noqa: E402

from dynaalign_torch import analysis  # noqa: E402
from dynaalign_torch.analysis import stats  # noqa: E402
from dynaalign_torch.io import datasets, rda, seqio  # noqa: E402
from dynaalign_torch.models import reference_r as ref  # noqa: E402
from dynaalign_torch.utils import profiling  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")


def _seqs(seed, n, lo=4, hi=30):
    rng = np.random.default_rng(seed)
    return ["".join(rng.choice(AAS, size=int(k)))
            for k in rng.integers(lo, hi, size=n)]


# -- sequence files --------------------------------------------------------


def test_fasta_round_trip_equals_jax(tmp_path):
    seqs = _seqs(0, 7)
    names = [f"p{i} description {i}" for i in range(7)]
    seqio.write_fasta(str(tmp_path / "a.fasta"), names, seqs)
    jseqio.write_fasta(str(tmp_path / "b.fasta"), names, seqs)
    assert (tmp_path / "a.fasta").read_bytes() == (
        tmp_path / "b.fasta").read_bytes()
    got = seqio.read_fasta(str(tmp_path / "a.fasta"))
    assert got == jseqio.read_fasta(str(tmp_path / "a.fasta"))
    assert got == ([f"p{i}" for i in range(7)], seqs)
    # wrapped lines, blank lines and a nameless record
    (tmp_path / "w.fa").write_text(">x\nARN\nDC\n\n>\nQEG\n")
    assert seqio.read_fasta(str(tmp_path / "w.fa")) == (
        jseqio.read_fasta(str(tmp_path / "w.fa"))) == (["x", ""],
                                                       ["ARNDC", "QEG"])


def test_malformed_fasta_raises(tmp_path):
    (tmp_path / "bad.fasta").write_text("ARND\n")
    assert seqio.read_fasta(str(tmp_path / "bad.fasta")) == ([], [])
    assert seqio.read_sequences(str(tmp_path / "bad.fasta")) == []


@pytest.fixture
def sources(tmp_path):
    seqs = _seqs(1, 12)
    out = {}
    for ext in (".fasta", ".fa", ".faa"):
        p = tmp_path / f"in{ext}"
        seqio.write_fasta(str(p), [f"s{i}" for i in range(12)], seqs)
        out[ext] = str(p)
    (tmp_path / "in.txt").write_text("\n".join(seqs) + "\n\n")
    (tmp_path / "in.csv").write_text(
        "id,Probe_Sequence,other\n"
        + "".join(f"{i},{s},x{i}\n" for i, s in enumerate(seqs)))
    (tmp_path / "plain.csv").write_text(
        "id,aa\n" + "".join(f"{i},{s}\n" for i, s in enumerate(seqs)))
    out.update({"txt": str(tmp_path / "in.txt"),
                "csv": str(tmp_path / "in.csv"),
                "plain": str(tmp_path / "plain.csv")})
    return seqs, out


@pytest.mark.parametrize("key, kw", [
    (".fasta", {}), (".fa", {"limit": 5}), (".faa", {}), ("txt", {}),
    ("csv", {}), ("csv", {"column": "other", "limit": 3}),
    ("plain", {"column": "aa"}),
])
def test_read_sequences_equals_jax(sources, key, kw):
    seqs, paths = sources
    got = seqio.read_sequences(paths[key], **kw)
    assert got == jseqio.read_sequences(paths[key], **kw)
    if kw.get("column") != "other":
        assert got == seqs[: kw.get("limit")]


@pytest.mark.parametrize("name", ["evp_peparray", "allunique"])
def test_read_sequences_dataset_equals_jax(name):
    got = seqio.read_sequences(name, limit=30)
    assert got == jseqio.read_sequences(name, limit=30)
    assert got == datasets.load_sequences(name, 30) and len(got) == 30


def test_csv_without_sequence_column_raises(sources):
    _, paths = sources
    with pytest.raises(ValueError, match="pass --column"):
        seqio.read_sequences(paths["plain"])


# -- the R reader -----------------------------------------------------------


def _i4(v):
    return struct.pack(">i", v)


def _charsxp(s):
    if s is None:
        return _i4(9) + _i4(-1)
    b = s.encode()
    return _i4(9) + _i4(len(b)) + b


def _strsxp(vals, attrs=b""):
    body = _i4(len(vals)) + b"".join(_charsxp(v) for v in vals)
    return _i4(16 | (0x200 if attrs else 0)) + body + attrs


def _intsxp(vals, attrs=b""):
    return (_i4(13 | (0x200 if attrs else 0)) + _i4(len(vals))
            + b"".join(_i4(v) for v in vals) + attrs)


def _realsxp(vals):
    return _i4(14) + _i4(len(vals)) + b"".join(struct.pack(">d", v)
                                                 for v in vals)


def _pairlist(items):
    """A tagged pairlist (attributes, or an .rda's objects); symbols are
    written once and referenced after (REFSXP), as R does."""
    out, seen = b"", []
    for tag, value in items:
        if tag in seen:
            sym = _i4(255 | ((seen.index(tag) + 1) << 8))
        else:
            seen.append(tag)
            sym = _i4(1) + _charsxp(tag)
        out += _i4(2 | 0x400) + sym + value
    return out + _i4(254)


def _data_frame(n=4):
    seqs = ["ARND", "CQEG", None, "HILK"][:n]
    clade = [1, 2, 1, -2147483648][:n]  # a factor with one NA
    factor = _intsxp(clade, _pairlist([
        ("levels", _strsxp(["3C.2a", "3C.3a"])),
        ("class", _strsxp(["factor"]))]))
    # ALTREP compact 1:n: info (class, package, type), state, attributes
    info = (_i4(2) + _i4(1) + _charsxp("compact_intseq")
            + _i4(2) + _i4(1) + _charsxp("base")
            + _i4(2) + _intsxp([13]) + _i4(254))
    row_names = _i4(238) + info + _realsxp([n, 1, 1]) + _i4(254)
    attrs = _pairlist([("names", _strsxp(["sequence", "clade", "score"])),
                       ("class", _strsxp(["data.frame"])),
                       ("row.names", row_names)])
    return (_i4(19 | 0x200) + _i4(3) + _strsxp(seqs) + factor
            + _realsxp([0.5, 1.5, 2.5, 3.5][:n]) + attrs)


def _header(version=3):
    h = _i4(version) + _i4(0x40300) + _i4(0x30500)
    if version >= 3:
        h += _i4(5) + b"UTF-8"
    return h


@pytest.mark.parametrize("version", [2, 3])
@pytest.mark.parametrize("compress", [False, True])
def test_rds_reader_equals_jax(tmp_path, version, compress):
    data = b"X\n" + _header(version) + _data_frame()
    path = tmp_path / "df.rds"
    path.write_bytes(gzip.compress(data) if compress else data)
    got = rda.to_columns(rda.load_rds(str(path)))
    want = jrda.to_columns(jrda.load_rds(str(path)))
    assert list(got) == list(want) == ["sequence", "clade", "score"]
    for k in got:
        np.testing.assert_array_equal(got[k], want[k])
    assert got["sequence"].tolist() == ["ARND", "CQEG", None, "HILK"]
    assert got["clade"].tolist() == ["3C.2a", "3C.3a", "3C.2a", None]
    assert got["score"].tolist() == [0.5, 1.5, 2.5, 3.5]


def _write_rda(path, name, n=4):
    path.write_bytes(gzip.compress(
        b"RDX3\nX\n" + _header() + _pairlist([(name, _data_frame(n))])))


def test_rda_reader_equals_jax(tmp_path):
    _write_rda(tmp_path / "x.rda", "h3n2sample")
    got, want = rda.load_rda(str(tmp_path / "x.rda")), jrda.load_rda(
        str(tmp_path / "x.rda"))
    assert list(got) == list(want) == ["h3n2sample"]
    assert isinstance(got["h3n2sample"], rda.RObject)
    assert rda.to_columns(got["h3n2sample"])["sequence"].tolist() == [
        "ARND", "CQEG", None, "HILK"]
    (tmp_path / "bad.rds").write_bytes(b"PK\x03\x04 not R")
    with pytest.raises(ValueError, match="not an XDR"):
        rda.load_rds(str(tmp_path / "bad.rds"))
    with pytest.raises(ValueError, match="data.frame"):
        rda.to_columns(rda.RObject(np.arange(3)))


def test_dataset_falls_back_to_the_reference_rda(tmp_path, monkeypatch):
    """Without data/<name>.npz the loader parses the reference package's
    data/<name>.rda, as the JAX package's does."""
    _write_rda(tmp_path / "h3n2sample.rda", "h3n2sample", n=3)
    monkeypatch.setattr(datasets, "_REPO_DATA", str(tmp_path / "none"))
    monkeypatch.setattr(datasets, "_REFERENCE_DATA", str(tmp_path))
    cols = datasets.load_dataset("h3n2sample")
    assert cols["sequence"].tolist() == ["ARND", "CQEG", None]
    assert datasets.load_sequences("h3n2sample") == ["ARND", "CQEG"]
    assert seqio.read_sequences("h3n2sample") == ["ARND", "CQEG"]


def test_reference_rda_when_present(tmp_path, monkeypatch):
    """The fallback reads only inside the repository; with neither file
    present the loader raises and names the reader for a user's .rda."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert os.path.commonpath([datasets._REFERENCE_DATA, root]) == root
    assert datasets._REFERENCE_DATA == os.path.join(root, "reference", "data")
    monkeypatch.setattr(datasets, "_REPO_DATA", str(tmp_path / "none"))
    monkeypatch.setattr(datasets, "_REFERENCE_DATA", str(tmp_path / "ref"))
    with pytest.raises(FileNotFoundError, match="io.rda.load_rda"):
        datasets.load_dataset("evp_peparray")
    _write_rda(tmp_path / "evp.rda", "evp_peparray", n=2)
    (obj,) = rda.load_rda(str(tmp_path / "evp.rda")).values()
    assert rda.to_columns(obj)["sequence"].tolist() == ["ARND", "CQEG"]


# -- analysis ---------------------------------------------------------------


def _sample():
    return np.array([[1.0, 0.8, 0.1], [0.8, 1.0, 0.3], [0.1, 0.3, 1.0]])


def _random_sym(seed, n):
    x = np.random.default_rng(seed).random((n, n)).round(2)
    x = (x + x.T) / 2
    np.fill_diagonal(x, 1.0)
    return x


@pytest.mark.parametrize("make", [_sample, lambda: _random_sym(3, 9),
                                  lambda: np.ones((4, 4))])
def test_similarity_stats_equal_jax(make):
    x = make()
    got, want = stats.compute_similarity_stats(x), (
        jstats.compute_similarity_stats(x))
    assert got.as_dict() == want.as_dict()
    assert str(got) == str(want)
    assert analysis.compute_similarity_stats is stats.compute_similarity_stats


def test_similarity_stats_values_and_validation():
    s = stats.compute_similarity_stats(_sample())
    assert s.most_similar_pair == (2, 1) and s.least_similar_pair == (3, 1)
    assert s.median_similarity == 0.3 and s.max_similarity == 0.8
    with pytest.raises(ValueError, match="matrix"):
        stats.compute_similarity_stats(np.zeros(3))
    with pytest.warns(UserWarning, match="not symmetric"):
        stats.compute_similarity_stats(np.array([[1.0, 0.2], [0.3, 1.0]]))


# -- the pure-R MinHash twin -------------------------------------------------


@pytest.mark.parametrize("k, n_hash, seed", [(2, 20, 0), (3, 100, 7),
                                             (1, 5, 123)])
def test_reference_r_minhash_equals_jax(k, n_hash, seed):
    seqs = _seqs(4, 10, lo=6, hi=25)
    got = ref.minhash(seqs, k, n_hash, seed=seed)
    want = jref.minhash(seqs, k, n_hash, seed=seed)
    assert got["vocabulary"] == want["vocabulary"]
    for key in ("char_matrix", "sig_matrix", "dist_matrix"):
        np.testing.assert_array_equal(got[key], want[key])
    d = got["dist_matrix"]
    np.testing.assert_array_equal(d, d.T)
    assert (np.diag(d) == 0).all()


def test_reference_r_helpers_equal_jax():
    assert ref.shingle("ARNDC", 2) == jref.shingle("ARNDC", 2)
    for bad in (("ARN", 0), ("ARN", 4), (5, 1)):
        with pytest.raises(ValueError):
            ref.shingle(*bad)
    p, jp = (mod.create_hash_parameters(6, 40, seed=2) for mod in (ref, jref))
    np.testing.assert_array_equal(p["a"], jp["a"])
    np.testing.assert_array_equal(p["b"], jp["b"])
    assert ref.apply_hash(3, 5, 7, 11) == jref.apply_hash(3, 5, 7, 11) == 0
    with pytest.raises(ValueError, match="positive"):
        ref.create_hash_parameters(0, 10)
    with pytest.raises(ValueError, match="at least 2"):
        ref.create_hash_parameters(3, 1)


# -- plots --------------------------------------------------------------------


def test_heatmap_renders_like_jax(tmp_path):
    pytest.importorskip("matplotlib")
    import matplotlib.pyplot as plt

    from dynaalign_tpu.analysis import plot_similarity_matrix as jplot

    x = _random_sym(5, 8)
    for cluster in (True, False):
        ax, ro, co = analysis.plot_similarity_matrix(x, cluster=cluster)
        _, jro, jco = jplot(x, cluster=cluster)
        np.testing.assert_array_equal(ro, jro)
        np.testing.assert_array_equal(co, jco)
        ax.figure.savefig(tmp_path / f"heat{cluster}.png")
        plt.close("all")
    assert sorted(ro.tolist()) == list(range(8))
    with pytest.raises(ValueError, match="matrix"):
        analysis.plot_similarity_matrix(np.zeros(3))


def test_consensus_plot_renders_like_jax(tmp_path):
    pytest.importorskip("matplotlib")
    pytest.importorskip("networkx")
    import matplotlib.pyplot as plt

    from dynaalign_tpu.analysis import consensus_plot as jplot

    seqs = _seqs(6, 10, lo=8, hi=16)
    df = np.array([(f"{i}.1", s) for i, s in enumerate(seqs)], dtype=object)
    for quirk in (False, True):
        ax, member = analysis.consensus_plot(df, quirk_compat=quirk)
        _, jmember = jplot(df, quirk_compat=quirk)
        np.testing.assert_array_equal(member, jmember)
        ax.figure.savefig(tmp_path / f"net{quirk}.png")
        plt.close("all")
    assert member.shape == (10,)


# -- profiling -----------------------------------------------------------------


def test_trace_writes_a_chrome_trace(tmp_path):
    import json

    with profiling.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert prof is not None
    with open(tmp_path / "tr" / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    assert any("matmul" in e.get("name", "") or "mm" in e.get("name", "")
               for e in events)
