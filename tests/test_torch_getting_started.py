"""The port's getting-started example (examples/getting_started_torch.py)
against the same calls through the JAX package, on the CPU at limit 40:
equal matrices byte for byte, equal stats field for field, equal cluster
labels and consensus rows, the same printed lines as the JAX script; and
the example's process loads no JAX module."""

import dataclasses
import importlib.util
import os
import re
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402,F401

import dynaalign_tpu as jt  # noqa: E402
from dynaalign_tpu.io.datasets import load_sequences  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LIMIT = 40


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def example():
    return _load("getting_started_torch")


@pytest.fixture(scope="module")
def jax_flows():
    """The calls of examples/getting_started.py, in order, through
    dynaalign_tpu (the plots left out)."""
    probes = load_sequences("evp_peparray", limit=LIMIT)
    sim = jt.similarity_mh(probes, k=2, n_hash=50, seed=0)
    seqs = list(dict.fromkeys(load_sequences("h3n2sample", limit=LIMIT)))
    result = jt.clusterbreak(
        seqs, thresh_p=0.8, size_max=100, size_min=3,
        sim_fn=lambda x: jt.similarity_mh(x, k=4, n_hash=500, seed=0),
    )
    return {"sim": sim, "stats": jt.compute_similarity_stats(sim),
            "nw_small": jt.similarity_nw(seqs[:20]),
            "clustered_seq": result.clustered_seq,
            "filtered_seq": result.filtered_seq,
            "consensus": jt.cluster_consensus(result.clustered_seq)}


def _same_array(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == object:
        assert got.tolist() == want.tolist()
    else:
        assert got.tobytes() == want.tobytes()


def test_run_equals_the_jax_calls(example, jax_flows):
    got = example.run(limit=LIMIT, device="cpu", plots=False)
    assert got["heatmap"] is None and got["network"] is None
    for key in ("sim", "nw_small", "clustered_seq", "filtered_seq",
                "consensus"):
        _same_array(got[key], jax_flows[key])
    assert len(got["clustered_seq"]) > 0 and len(got["consensus"]) > 0
    ours = dataclasses.asdict(got["stats"])
    theirs = dataclasses.asdict(jax_flows["stats"])
    assert ours == theirs
    for field, value in ours.items():  # the printed repr depends on types
        assert type(value) is type(theirs[field]), field
        if isinstance(value, tuple):
            assert [type(v) for v in value] == [type(v) for v in
                                                theirs[field]], field
    assert str(got["stats"]) == str(jax_flows["stats"])


def _lines(text, outdir):
    """Printed lines with the output directory and the clock taken out."""
    text = text.replace(str(outdir), "<outdir>")
    return [re.sub(r"^\[\d\d:\d\d:\d\d\] ", "[time] ", ln)
            for ln in text.splitlines()]


def test_plots_and_printed_lines_equal_the_jax_script(example, tmp_path,
                                                      capsys, monkeypatch):
    """With plots, into tmp_path: both PNGs exist, and main() of both
    scripts prints the same lines."""
    jax_example = _load("getting_started")
    monkeypatch.setattr(sys, "argv", [
        "getting_started.py", "--limit", str(LIMIT), "--outdir",
        str(tmp_path / "jax")])
    assert jax_example.main() == 0
    want = _lines(capsys.readouterr().out, tmp_path / "jax")
    monkeypatch.setattr(sys, "argv", [
        "getting_started_torch.py", "--limit", str(LIMIT), "--outdir",
        str(tmp_path / "torch"), "--device", "cpu"])
    assert example.main() == 0
    got = _lines(capsys.readouterr().out, tmp_path / "torch")
    assert got == want
    for name in ("peparray_heatmap.png", "consensus_network.png"):
        path = tmp_path / "torch" / name
        assert path.stat().st_size > 0
        with open(path, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_script_loads_no_jax(tmp_path):
    """The script as a user runs it, with --device cpu --no-plots: exit 0,
    the same lines as run(), and no jax, jaxlib, dynaalign_tpu or
    matplotlib module loaded."""
    script = os.path.join(ROOT, "examples", "getting_started_torch.py")
    code = (
        "import runpy, sys\n"
        f"sys.argv = [{script!r}, '--limit', '{LIMIT}', '--device', 'cpu',"
        " '--no-plots']\n"
        "try:\n"
        f"    runpy.run_path({script!r}, run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    assert e.code == 0, e.code\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'dynaalign_tpu', 'matplotlib')]\n"
        "assert not bad, bad\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], check=True,
                         capture_output=True, text=True, env=env,
                         cwd=tmp_path).stdout
    assert out.startswith(f"loaded {LIMIT} peptide-array probes (12-mers)\n")
    assert "clusterbreak: " in out and "wrote" not in out
    assert not (tmp_path / "examples").exists()  # no plots, no directory


def test_default_device_is_the_card(example, monkeypatch):
    """Without a card the default device raises; nothing runs on the
    host."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        example.run(limit=LIMIT, plots=False)
