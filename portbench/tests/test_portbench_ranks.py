"""The ranks of a cell of more than one chip (``portbench/ranks.py``), on
the CPU: the runner's own launcher starts gloo worlds of 2 and 4 ranks, a
process each, as it starts NCCL ranks on the cards.

Each run is a leader process of its own (``SCRIPT``), since a failing run
ends its process, and so is every torch computation here: in a pytest
process that has waited on many such runs, torch's CPU thread pool was
seen to run a parallel op some 350 times slower.  The followers run the
same script, so that a fault planted in it holds on every rank.

Checked: rank 0's judged matrix against ``similarity_nw`` and the
reference; the faults a four-chip cell can have, the exchange between
chips left out among them, and the control; a follower that dies, dies
mid-run or never joins ends the run within the limit with no process
left; a cell of one chip starts none of it.
"""

import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import pytest

from portbench import ranks, run

CELL = "nw_blosum62.h3n2_all_4chip"
SEED = 2**31 + 77
LIMIT = 120  # seconds in which a run whose follower fails must end

# ``{patch}`` runs first on every rank; ``{leader}`` on rank 0 only
SCRIPT = """
import json, os, sys
sys.path.insert(0, {root!r})
import numpy as np
from portbench import control, ranks, run
{patch}
if sys.argv[1:2] == ["follower"]:
    sys.exit(ranks.follower_main(sys.argv[2:]))
ranks.follower_command = lambda: [sys.executable, __file__, "follower"]
bench = run.load_json(run.ROOT, "BENCHMARK.json")
cell, config, traffic = run.find_cell(bench, {cell!r})
cell = {{**cell, "chips": {chips}}}
traffic = {{**traffic, "limit": {limit}}}
{leader}
"""

MEASURE = """
from portbench.entries import sharded_nw
seen = []
real_read = sharded_nw.Entry.read
def read(self, out, call):
    seen.append(out.copy())
    return real_read(self, out, call)
sharded_nw.Entry.read = read
result, r, judged = run.measure(cell, config, traffic, {seed}, 0.0, False,
                                "cpu")
np.save({out!r}, seen[0])
print(json.dumps({{"result": result, "judged": judged}}))
"""

# the matrix of one process on one device, on the inputs the run built
SINGLE = """
from dynaalign_torch import similarity_nw
from portbench import generate
np.save({out!r}, similarity_nw(generate.build(traffic, {seed}),
                               device="cpu"))
"""

ONE_CHIP = """
import torch.distributed as dist
def no_rank(*a, **k):
    raise AssertionError("a one-chip cell started a rank")
ranks.follower_command = ranks.free_port = no_rank
result, r, judged = run.measure(cell, config, traffic, {seed}, 0.0, False,
                                "cpu")
print(json.dumps({{"result": result, "judged": judged,
                  "bounds": sorted(r.bounds),
                  "process_group": dist.is_initialized()}}))
"""

# a run without --trace 1 traced for an end-to-end metric read from the
# device trace
PROFILED = """
result, r, judged = run.measure(cell, config, traffic, {seed}, 0.0, False,
                                "cpu", profile=True)
print(json.dumps({{"result": result, "window_s": r.trace.window_s}}))
"""

CONTROL = """
mod, entry, got, _ = control.readings(config, traffic, {seed}, 2, "cpu",
                                      cell)
prog, _ = entry.judge(got)
ctrl = {{c: entry.judge(got, c)[0] for c in mod.CONTROLS}}
print(json.dumps({{"program": prog, "controls": ctrl}}))
"""


def _launch(tmp_path, leader, patch="", chips=2, limit=20, timeout=300,
            cell=CELL):
    """(exit code, the last line of standard output, standard error,
    seconds) of a leader process."""
    path = tmp_path / "rank.py"
    path.write_text(SCRIPT.format(root=run.ROOT, patch=patch, cell=cell,
                                  chips=chips, limit=limit, leader=leader))
    t0 = time.monotonic()
    out = subprocess.run(
        [sys.executable, str(path), "leader"], capture_output=True,
        text=True, timeout=timeout, cwd=run.ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "2"})
    lines = out.stdout.strip().splitlines()
    return (out.returncode, lines[-1] if lines else "", out.stderr,
            time.monotonic() - t0)


def _followers_gone(err):
    pids = [int(p) for p in re.findall(r"rank \d+ pid (\d+)", err)]
    assert pids, err
    for pid in pids:
        with pytest.raises(ProcessLookupError):
            os.kill(pid, 0)


def _measured(tmp_path, patch="", chips=2, limit=20, then=""):
    out = str(tmp_path / "matrix.npy")
    rc, line, err, _ = _launch(
        tmp_path, MEASURE.format(seed=SEED, out=out) + then, patch, chips,
        limit)
    assert rc == 0, err[-4000:]
    _followers_gone(err)
    return json.loads(line), np.load(out), err


@pytest.mark.parametrize("chips", [2, 4])
def test_ranks_give_rank_0_the_single_device_matrix(tmp_path, chips):
    single = str(tmp_path / "single.npy")
    got, matrix, err = _measured(tmp_path, chips=chips, limit=40,
                                 then=SINGLE.format(seed=SEED, out=single))
    result, judged = got["result"], got["judged"]
    assert result["correct"] and result["failed"] == 0, judged
    assert result["device"] == {"platform": "cpu", "count": chips}
    assert judged["followers_hold"] == []
    # at 40 rows every entry is read, both ways round, and equals the
    # reference
    assert judged["compared"] == {"entries_compared": 2 * 820,
                                  "pairs_aligned": 820}
    assert judged["checks"]["mismatched_entries"] == [0, 0]
    want = np.load(single)
    assert matrix.dtype == want.dtype and matrix.tobytes() == want.tobytes()
    assert len(re.findall(r"rank \d of \d+ joined through gloo", err)) \
        == chips


WRAP = """
def _wrap(mod, name, change):
    real = getattr(mod, name)
    setattr(mod, name, lambda *a, **k: change(real(*a, **k)))
import dynaalign_torch.parallel.allpairs as allpairs
"""

FAULTS = {
    "answer altered": WRAP + """
def _alter(vals):
    vals = vals.copy()
    vals.flat[len(vals.flat) // 2] += 0.125
    return vals
_wrap(allpairs, "_ratio", _alter)
""",
    "half left out": WRAP + """
def _half(out):
    mt, ln = (x.copy() for x in out)
    mt[len(mt) // 2:] = 0
    ln[len(ln) // 2:] = 0
    return mt, ln
_wrap(allpairs, "_pairs_nw", _half)
""",
    "state unchanged": WRAP + """
allpairs._fill = lambda n, vals: np.zeros((n, n))
""",
    "exchange left out": WRAP + """
allpairs._sum_shares = lambda mesh, full: full.cpu().numpy()
""",
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_on_every_rank_makes_correct_false(tmp_path, fault):
    got, _, _ = _measured(tmp_path, FAULTS[fault])
    assert not got["result"]["correct"]
    value, limit = got["judged"]["checks"]["mismatched_entries"]
    assert value > limit


def test_control_is_not_correct_on_the_ranks(tmp_path):
    rc, line, err, _ = _launch(tmp_path, CONTROL.format(seed=SEED))
    assert rc == 0, err[-4000:]
    _followers_gone(err)
    got = json.loads(line)
    assert all(v <= lim for v, lim in got["program"].values())
    for c, checks in got["controls"].items():
        assert any(v > lim for v, lim in checks.values()), c


DIES_MID_RUN = """
if sys.argv[1:2] == ["follower"]:
    from portbench.entries import sharded_nw
    real_call = sharded_nw.Entry.call
    made = []
    def call(self, seqs):
        made.append(1)
        if len(made) == 2:  # the window's first call
            os._exit(9)
        return real_call(self, seqs)
    sharded_nw.Entry.call = call
"""

FOLLOWERS = {
    "exits at once": (
        'ranks.follower_command = lambda: [sys.executable, "-c", '
        '"import sys; sys.exit(7)"]', "exited with code 7"),
    "never joins": (
        "ranks.JOIN_S = 20.0\n"
        'ranks.follower_command = lambda: [sys.executable, "-c", '
        '"import time; time.sleep(600)"]', "did not join within 20 s"),
    "dies mid-run": ("", "exited with code 9"),
}


@pytest.mark.parametrize("case", sorted(FOLLOWERS))
def test_failed_follower_ends_the_run(tmp_path, case):
    leader, said = FOLLOWERS[case]
    # the fake followers replace the script's own after it set them
    leader += "\n" + MEASURE.format(seed=SEED, out=str(tmp_path / "m.npy"))
    rc, line, err, took = _launch(
        tmp_path, leader, DIES_MID_RUN if case == "dies mid-run" else "",
        timeout=LIMIT + 60)
    assert rc == ranks.FAILED, err[-4000:]
    assert said in err and not line
    assert took < LIMIT
    _followers_gone(err)


def test_join_limit_fits_the_limit():
    assert ranks.JOIN_S + 10 < LIMIT


def test_one_chip_cell_starts_no_rank(tmp_path):
    rc, line, err, _ = _launch(tmp_path, ONE_CHIP.format(seed=SEED),
                               chips=1, limit=14,
                               cell="nw_blosum62.h3n2_all")
    assert rc == 0, err[-4000:]
    got = json.loads(line)
    result, judged = got["result"], got["judged"]
    assert not got["process_group"]
    assert set(result) == {"correct", "attempted", "failed", "device"}
    assert result["device"] == {"platform": "cpu", "count": 1}
    assert set(judged) == {"checks", "compared"}
    assert result["correct"] and got["bounds"] == ["nw_dp"]


def test_rendezvous_port_is_free_and_no_connection_takes_it():
    import socket

    with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
        low = int(f.read().split()[0])
    ports = {ranks.free_port() for _ in range(20)}
    assert all(1024 <= p < low for p in ports) and len(ports) > 1
    with socket.socket() as s:
        s.bind((ranks.HOST, ports.pop()))


def test_profiled_run_keeps_the_result_line_of_an_untraced_one(tmp_path):
    rc, line, err, _ = _launch(tmp_path, PROFILED.format(seed=SEED))
    assert rc == 0, err[-4000:]
    _followers_gone(err)
    got = json.loads(line)
    assert got["window_s"] > 0 and got["result"]["correct"]
    # the trace's own numbers come with --trace 1 only
    assert "breakdown" not in got["result"]
    assert not {"busy_s", "window_s"} & set(got["result"]["device"])
