"""BENCHMARK.json keeps to the contract's shape, and nothing the
benchmark runs loads JAX or the JAX package."""

import json
import os
import re
import subprocess
import sys

import pytest

from portbench import run

BENCH = run.load_json(run.ROOT, "BENCHMARK.json")
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}\Z")
UNIT = re.compile(r"[A-Za-z0-9_/%.-]{1,16}\Z")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_keys_names_and_units():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    for item in BENCH["configs"] + BENCH["workloads"] + METRICS:
        assert NAME.match(item["name"]), item["name"]
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"]
    for m in METRICS:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    names = [x["name"] for x in METRICS]
    assert len(set(names)) == len(names)
    assert os.path.getsize(os.path.join(run.ROOT, "BENCHMARK.json")) < 65536


def test_cells_configs_and_files():
    configs = {c["name"]: c for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert w["config"] in configs
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        assert os.path.exists(os.path.join(
            run.HERE, "traffic", f"{w['traffic']}.json"))
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used and c["reduced"] == []
        assert c["file"].startswith("portbench/")
        assert run.load_json(run.ROOT, c["file"])["name"] == c["name"]
    assert BENCH["paths"] == ["portbench"]
    assert all(not a.startswith("/") and ".." not in a
               for a in BENCH["command"])


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {"setup_s"} <= {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert "bound" not in m and m["layer"].strip()


def _reports(metric, cell):
    return "workloads" not in metric or cell in metric["workloads"]


def test_moves_names_a_metric_each_of_its_cells_reports():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = [w["name"] for w in BENCH["workloads"]]
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", cells):
            assert cell in cells and _reports(e2e[m["moves"]], cell)
    for cell in cells:
        assert sum(_reports(m, cell) for m in BENCH["end_to_end"]) >= 2
        assert any(_reports(m, cell) for m in BENCH["per_layer"])


LOAD_ALL = """
import glob, importlib, importlib.util, json, os, sys
sys.path.insert(0, {root!r})
import portbench.run as run, portbench.control, portbench.generate
from dynaalign_torch import similarity_mh, similarity_nw
for f in sorted(glob.glob(os.path.join(run.HERE, "**", "*.py"),
                          recursive=True)):
    rel = os.path.relpath(f, run.ROOT)
    if "/tests/" in rel or "/metrics/" in rel:
        continue
    importlib.import_module(rel[:-3].replace(os.sep, "."))
bench = run.load_json(run.ROOT, "BENCHMARK.json")
for m in bench["end_to_end"] + bench["per_layer"]:
    run.reader(m["name"])
for c in bench["configs"]:
    run.load_json(run.ROOT, c["file"])
for w in bench["workloads"]:
    portbench.generate.load_traffic(w["traffic"])
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""

LOAD_REFERENCE = """
import json, sys
sys.path.insert(0, {root!r})
import portbench.reference.nw, portbench.reference.minhash
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""


@pytest.mark.parametrize("script,banned", [
    (LOAD_ALL, {"jax", "jaxlib", "flax", "dynaalign_tpu"}),
    (LOAD_REFERENCE, {"jax", "jaxlib", "flax", "dynaalign_tpu",
                      "dynaalign_torch"}),
])
def test_no_jax_and_a_reference_apart_from_the_port(script, banned):
    out = subprocess.run(
        [sys.executable, "-c", script.format(root=run.ROOT)],
        capture_output=True, text=True, timeout=300, cwd=run.ROOT,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr
    top = set(json.loads(out.stdout.splitlines()[-1]))
    assert not top & banned
    assert "portbench" in top
