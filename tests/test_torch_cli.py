"""The port's command line on the CPU against the JAX package's: every
subcommand, run by both on the same inputs, writes byte-equal files and
prints equal lines; and the CLI's modules import neither JAX nor
matplotlib."""

import csv
import json
import os
import re
import subprocess
import sys
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

from dynaalign_tpu import cli as jcli  # noqa: E402

import dynaalign_torch as dt  # noqa: E402
from dynaalign_torch import cli  # noqa: E402
from dynaalign_torch.io.seqio import write_fasta  # noqa: E402

AAS = list("ARNDCQEGHILKMFPSTWYV")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(dt.__file__)))


@pytest.fixture
def inputs(tmp_path):
    """A FASTA of three planted families of 14-mers (8 each) and a CSV of
    the same sequences."""
    rng = np.random.default_rng(0)
    seqs = []
    for b in ["".join(rng.choice(AAS, size=14)) for _ in range(3)]:
        for _ in range(8):
            s = list(b)
            s[rng.integers(14)] = AAS[rng.integers(20)]
            seqs.append("".join(s))
    fa = tmp_path / "input.fasta"
    write_fasta(str(fa), [f"s{i}" for i in range(len(seqs))], seqs)
    with open(tmp_path / "input.csv", "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["name", "peptide"])
        w.writerows([(f"s{i}", s) for i, s in enumerate(seqs)])
    return tmp_path


def _both(argv, inputs, monkeypatch, capsys, device=True):
    """Run the JAX CLI and the port's (``--device cpu``) on ``argv`` in
    sibling directories; returns (jax dir, port dir, jax out, port out)."""
    outs = []
    for name, main, extra in (("jax", jcli.main, []),
                              ("torch", cli.main,
                               ["--device", "cpu"] if device else [])):
        d = inputs / name
        d.mkdir(exist_ok=True)
        monkeypatch.chdir(d)
        assert main(argv + extra) == 0
        outs.append(capsys.readouterr().out)
    return inputs / "jax", inputs / "torch", outs[0], outs[1]


def _npz_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in z.namelist()}


def _same_files(jdir, tdir, names):
    for name in names:
        if name.endswith(".npz"):
            assert _npz_members(jdir / name) == _npz_members(tdir / name)
        else:
            assert (jdir / name).read_bytes() == (tdir / name).read_bytes()


@pytest.mark.parametrize("argv", [
    ["--engine", "mh", "--k", "2", "--n-hash", "32"],
    ["--engine", "nw"],
    ["--engine", "nw", "--bucketed", "--gap-open", "12", "--gap-ext", "2"],
    ["--engine", "hybrid", "--k", "2", "--prefilter-quantile", "0.6"],
    ["--engine", "nw", "--matrix", "BLOSUM45", "--limit", "10"],
], ids=["mh", "nw", "nw-bucketed", "hybrid", "nw-blosum45-limit"])
def test_similarity_and_stats_equal_jax(argv, inputs, monkeypatch, capsys):
    jdir, tdir, jout, tout = _both(
        ["similarity", "--input", str(inputs / "input.fasta"), *argv,
         "--output", "sim.npz"], inputs, monkeypatch, capsys)
    assert tout == jout and tout.startswith("wrote sim.npz: ")
    _same_files(jdir, tdir, ["sim.npz"])
    jdir, tdir, jout, tout = _both(
        ["stats", "--similarity", str(tdir / "sim.npz")], inputs,
        monkeypatch, capsys, device=False)
    assert tout == jout and "mean_similarity" in json.loads(tout)


@pytest.mark.parametrize("source", [
    ["--input", "evp_peparray", "--limit", "40"],
    ["--input", "CSV"],
    ["--input", "CSV", "--column", "peptide", "--limit", "12"],
], ids=["dataset", "csv", "csv-column"])
def test_similarity_sources_equal_jax(source, inputs, monkeypatch, capsys):
    source = [str(inputs / "input.csv") if a == "CSV" else a for a in source]
    jdir, tdir, jout, tout = _both(
        ["similarity", *source, "--k", "3", "--output", "sim.npz"], inputs,
        monkeypatch, capsys)
    assert tout == jout
    _same_files(jdir, tdir, ["sim.npz"])


CLUSTER_ARGS = ["--k", "2", "--n-hash", "64", "--thresh-p", "0.6",
                "--size-max", "15", "--size-min", "2"]


@pytest.mark.parametrize("engine", ["mh", "nw", "hybrid"])
def test_cluster_and_consensus_equal_jax(engine, inputs, monkeypatch,
                                         capsys):
    jdir, tdir, jout, tout = _both(
        ["cluster", "--input", str(inputs / "input.fasta"), "--engine",
         engine, *CLUSTER_ARGS, "--output", "clusters.csv"], inputs,
        monkeypatch, capsys)
    assert tout == jout and "converged=True" in tout
    _same_files(jdir, tdir, ["clusters.csv"])
    for extra in ([], ["--matrix", "BLOSUM80", "--threshold", "0.2"]):
        jdir, tdir, jout, tout = _both(
            ["consensus", "--clusters", str(tdir / "clusters.csv"), *extra,
             "--output", "consensus.csv"], inputs, monkeypatch, capsys,
            device=False)
        assert tout == jout and "consensus sequences" in tout
        _same_files(jdir, tdir, ["consensus.csv"])


@pytest.mark.parametrize("engine", ["topk", "hybrid-sparse"])
def test_cluster_sparse_engines_equal_jax(engine, inputs, monkeypatch,
                                          capsys):
    jdir, tdir, jout, tout = _both(
        ["cluster", "--input", str(inputs / "input.fasta"), "--engine",
         engine, "--k", "2", "--top-k", "8", "--output", "clusters.csv"],
        inputs, monkeypatch, capsys)

    def untimed(out):  # the line carries the run's wall time
        return re.sub(r"\(\d+\.\d s, ", "(T s, ", out)

    assert untimed(tout) == untimed(jout) and f"s, {engine})" in tout
    _same_files(jdir, tdir, ["clusters.csv"])


@pytest.mark.parametrize("argv", [
    ["--input", "FASTA", "--engine", "mh", *CLUSTER_ARGS],
    ["--input", "FASTA", "--engine", "nw", *CLUSTER_ARGS],
    ["--input", "evp_peparray", "--limit", "100", "--engine", "nw",
     "--size-max", "30"],
], ids=["mh", "nw", "evp-nw"])
def test_pipeline_equals_jax(argv, inputs, monkeypatch, capsys):
    argv = [str(inputs / "input.fasta") if a == "FASTA" else a for a in argv]
    jdir, tdir, jout, tout = _both(["pipeline", *argv, "--output-dir", "out"],
                                   inputs, monkeypatch, capsys)
    assert tout == jout and tout.startswith("pipeline done: ")
    _same_files(jdir, tdir, ["out/clusters.csv", "out/consensus.csv"])


def test_datasets_equal_jax(inputs, monkeypatch, capsys):
    _, _, jout, tout = _both(["datasets"], inputs, monkeypatch, capsys,
                             device=False)
    assert tout == jout
    assert "h3n2sample: 8103 rows (sequences in sequence)" in tout
    assert len(tout.splitlines()) == 9


def test_warm_equals_jax(inputs, monkeypatch, capsys):
    _, _, jout, tout = _both(
        ["warm", "--input", str(inputs / "input.fasta"), "--engines",
         "mh,nw,hybrid", "--n", "8"], inputs, monkeypatch, capsys)
    got, want = json.loads(tout), json.loads(jout)
    assert len(tout.splitlines()) == 1
    assert set(got) == set(want) == {"warmed", "n_seqs", "max_len",
                                     "stage_seconds", "total_seconds"}
    for key in ("warmed", "n_seqs", "max_len"):
        assert got[key] == want[key]
    assert got["warmed"] == ["mh", "nw", "hybrid"] and got["n_seqs"] == 8
    assert set(got["stage_seconds"]) == set(want["stage_seconds"])


def test_errors_equal_jax(inputs, monkeypatch, capsys):
    fa = str(inputs / "input.fasta")
    for main, extra in ((jcli.main, []), (cli.main, ["--device", "cpu"])):
        with pytest.raises(SystemExit, match="use it with the 'cluster'"):
            main(["similarity", "--input", fa, "--engine", "topk",
                  "--output", str(inputs / "x.npz"), *extra])
        assert main(["warm", "--input", fa, "--engines", "sw", *extra]) == 1
        assert "unknown engine 'sw'" in capsys.readouterr().err
    with pytest.raises(SystemExit):
        cli.main(["consensus", "--clusters", "c.csv", "--output", "o.csv",
                  "--device", "cpu"])  # consensus runs on the host only


def test_default_device_without_card_raises(inputs, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli.main(["similarity", "--input", str(inputs / "input.fasta"),
                  "--output", str(inputs / "x.npz")])


def test_cli_path_imports_neither_jax_nor_matplotlib(inputs):
    """The CLI's modules, and a whole pipeline run through the CLI, load
    neither JAX nor matplotlib (the card's machine has neither)."""
    code = (
        "import sys\n"
        "import dynaalign_torch.cli, dynaalign_torch.consensus, "
        "dynaalign_torch.analysis, dynaalign_torch.models.reference_r, "
        "dynaalign_torch.utils.profiling\n"
        "from dynaalign_torch.cli import main\n"
        f"assert main(['pipeline', '--input', {str(inputs / 'input.fasta')!r},"
        f" '--output-dir', {str(inputs / 'sub')!r}, '--device', 'cpu']) == 0\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'matplotlib', 'networkx', 'dynaalign_tpu')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    subprocess.run([sys.executable, "-c", code], check=True, env=env,
                   cwd=ROOT)
    assert (inputs / "sub" / "consensus.csv").exists()


def test_module_entry_point(inputs):
    out = subprocess.run(
        [sys.executable, "-m", "dynaalign_torch", "similarity", "--input",
         str(inputs / "input.fasta"), "--engine", "nw", "--output",
         str(inputs / "m.npz"), "--device", "cpu"],
        check=True, capture_output=True, text=True, cwd=ROOT).stdout
    assert out == f"wrote {inputs / 'm.npz'}: 24x24 matrix\n"
    with np.load(inputs / "m.npz") as z:
        np.testing.assert_array_equal(
            z["similarity"],
            dt.similarity_nw(dt.io.seqio.read_sequences(
                str(inputs / "input.fasta")), device="cpu"))
    usage = subprocess.run([sys.executable, "-m", "dynaalign_torch"],
                           capture_output=True, text=True, cwd=ROOT)
    assert usage.returncode == 2 and "dynaalign_torch" in usage.stderr
