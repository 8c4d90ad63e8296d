"""The port's failure handling (tests/test_failures.py's cases, on the CPU),
distributed_init's backend and environment rules, and a real 2-rank gloo
group in which rank 1 raises inside clean_abort while rank 0 waits in a
collective: both must exit non-zero within the timeout, with no hang.

The ranks are this file run as a script; they meet through a ``file://``
store under the test's temporary directory."""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist  # noqa: E402

TIMEOUT = 120


def test_devices_healthy():
    from dynaalign_torch.parallel.failures import check_devices_healthy

    assert check_devices_healthy(device="cpu") == []


def test_devices_healthy_default_needs_a_card(monkeypatch):
    from dynaalign_torch.parallel.failures import check_devices_healthy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        check_devices_healthy()


def test_clean_abort_reraises_single_process():
    from dynaalign_torch.parallel.failures import clean_abort

    with pytest.raises(RuntimeError, match="boom"):
        with clean_abort():
            raise RuntimeError("boom")


def test_clean_abort_passthrough():
    from dynaalign_torch.parallel.failures import clean_abort

    with clean_abort():
        x = 1 + 1
    assert x == 2


def test_clean_abort_keyboard_interrupt():
    from dynaalign_torch.parallel.failures import clean_abort

    with pytest.raises(KeyboardInterrupt):
        with clean_abort():
            raise KeyboardInterrupt


def _recorded_init(monkeypatch):
    calls = []
    monkeypatch.setattr(dist, "init_process_group",
                        lambda backend, **kw: calls.append((backend, kw)))
    return calls


def test_distributed_init_is_a_noop_without_environment(monkeypatch):
    from dynaalign_torch.parallel import distributed_init

    calls = _recorded_init(monkeypatch)
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(var, raising=False)
    assert distributed_init() is None
    assert distributed_init(device="cpu") is None
    assert calls == []


def test_distributed_init_reads_torchrun_environment(monkeypatch):
    from dynaalign_torch.parallel import distributed_init

    calls = _recorded_init(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29511")
    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setenv("RANK", "3")
    assert distributed_init(device="cpu") == torch.device("cpu")
    assert distributed_init("h:1", 2, 1, device="cpu") == torch.device("cpu")
    assert distributed_init("file:///tmp/x", device="cpu")
    assert calls == [
        ("gloo", dict(init_method="tcp://10.0.0.7:29511", world_size=4,
                      rank=3)),
        ("gloo", dict(init_method="tcp://h:1", world_size=2, rank=1)),
        ("gloo", dict(init_method="file:///tmp/x", world_size=4, rank=3)),
    ]


def test_distributed_init_cuda_takes_nccl_or_raises(monkeypatch):
    """The device decides the backend; nothing is picked from what the
    machine has: no card raises, a card without NCCL raises."""
    from dynaalign_torch.parallel import distributed_init

    calls = _recorded_init(monkeypatch)
    monkeypatch.setenv("MASTER_ADDR", "h")
    monkeypatch.setenv("MASTER_PORT", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        distributed_init()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(dist, "is_nccl_available", lambda: False)
    with pytest.raises(RuntimeError, match="NCCL"):
        distributed_init(device="cuda")
    monkeypatch.setattr(dist, "is_nccl_available", lambda: True)
    monkeypatch.setenv("LOCAL_RANK", "1")
    chosen = []
    monkeypatch.setattr(torch.cuda, "set_device", chosen.append)
    assert distributed_init() == torch.device("cuda", 1)
    assert chosen == [torch.device("cuda", 1)]
    assert [c[0] for c in calls] == ["nccl"]


def _worker(rank, store):
    """Rank 1 raises inside clean_abort; rank 0 waits in an all_reduce
    that rank 1 never joins."""
    from dynaalign_torch.parallel import distributed_init
    from dynaalign_torch.parallel.failures import clean_abort

    with clean_abort(exit_code=3):
        distributed_init(f"file://{store}", 2, rank, device="cpu")
        dist.barrier()
        if rank == 1:
            raise RuntimeError("rank 1 fails")
        dist.all_reduce(torch.ones(4))
    print(f"rank {rank} finished", flush=True)


def test_clean_abort_ends_both_ranks(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    procs = [subprocess.Popen(
        [sys.executable, __file__, str(r), str(tmp_path / "store")],
        env=env, cwd=tmp_path, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT)[0])
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
            p.communicate()
        pytest.fail(f"clean_abort left a rank hanging past {TIMEOUT} s")
    assert procs[1].returncode == 3, outs[1]
    assert "Fatal error on rank 1: rank 1 fails" in outs[1]
    assert procs[0].returncode != 0, outs[0]
    assert "finished" not in outs[0] + outs[1]


if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    _worker(int(sys.argv[1]), sys.argv[2])
