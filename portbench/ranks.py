"""The ranks of a cell that asks for more than one chip.

The ``python3 -m portbench.run`` process is the leader, rank 0 on card 0.
It starts ``chips - 1`` followers of the same checkout,

    python3 -m portbench.ranks --workload <name> --seed <n> ...

one a card, with torchrun's environment (``RANK``, ``LOCAL_RANK``,
``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``) and the checkout's
bytecode cache.  Every rank joins through the port's own
``parallel.distributed_init`` (NCCL on a card, gloo for ``device="cpu"``
in the tests; never gloo on a card), builds the same inputs from the seed
and makes the same calls of the entry point, which builds
``parallel.make_mesh``.

The leader announces each call (the warm rows, all rows, or stop) through
a ``TCPStore`` of its own, on the host, so that no collective of the
harness runs on a card: the leader's device trace holds only the
program's work.  The leader alone times the window, traces it and judges
what it read; a cell's device trace is rank 0's.  After stop each
follower puts its device memory peak, and any module of JAX it holds,
into the store, leaves the process group and exits.

A follower that exits before stop, or a rank that has not joined within
``JOIN_S`` seconds of the start, ends the run: the leader names it on
standard error, kills every follower and exits ``FAILED`` with no
result.  A follower ends itself when the leader's process is gone.

A cell of one chip starts nothing: no process group, no follower.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import random
import socket
import subprocess
import sys
import threading
import time

WARM, ALL, STOP = "warm", "all", "stop"
JOIN_S = 90.0  # from the followers' start to the leader's join
REPORT_S = 60.0  # from stop to each follower's report and exit
FOLLOWER_WAIT_S = 900.0  # a follower's longest wait for the next call
FAILED = 5
HOST = "127.0.0.1"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "dynaalign_tpu")


def free_port() -> int:
    """A port free now, for the rendezvous the leader listens on only once
    it joins, seconds later.  It lies below the range from which the
    system hands ports to connecting sockets, so that no rank's
    connection (the followers' retries to reach this very port among
    them) can take it meanwhile."""
    try:
        with open("/proc/sys/net/ipv4/ip_local_port_range") as f:
            low = int(f.read().split()[0])
    except (OSError, ValueError, IndexError):
        low = 32768
    ports = range(max(low - 8192, 1024), low)
    for port in random.SystemRandom().sample(ports, min(256, len(ports))):
        with socket.socket() as s:
            try:
                s.bind((HOST, port))
            except OSError:
                continue
            return port
    raise RuntimeError(f"no free port below {low} for the rendezvous")


def follower_command() -> list[str]:
    """The command of a follower, before its arguments."""
    return [sys.executable, "-m", "portbench.ranks"]


def forbidden_modules() -> list[str]:
    """The top-level names of JAX and the JAX package that the process
    holds, compared whole."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _say(text: str) -> None:
    # one write, so that the lines of several ranks do not interleave
    sys.stderr.write(f"portbench: {text}\n")
    sys.stderr.flush()


class World:
    """The followers and the process group of one run, as a context: on
    entry the followers start; :meth:`join` joins the leader;
    :meth:`announce` tells every follower the next call; :meth:`stop`
    ends the calls and gathers the followers' reports; on exit the leader
    leaves the group and every follower has ended.  With one chip each
    of these does nothing."""

    def __init__(self, chips: int, workload: str, traffic: dict, seed: int,
                 device):
        self.chips = chips
        self.workload = workload
        self.traffic = traffic
        self.seed = seed
        self.device = device
        self.procs: list[subprocess.Popen] = []
        self.calls = 0
        self._joined = threading.Event()
        self._stopping = threading.Event()
        self._done = threading.Event()

    def __enter__(self) -> "World":
        if self.chips == 1:
            return self
        import torch
        import torch.distributed as dist

        self.store = dist.TCPStore(
            HOST, 0, self.chips, True,
            datetime.timedelta(seconds=REPORT_S), wait_for_workers=False)
        self.port = free_port()
        env = {k: v for k, v in os.environ.items()
               if k != "PYTHONDONTWRITEBYTECODE"}
        env.update(MASTER_ADDR=HOST, MASTER_PORT=str(self.port),
                   WORLD_SIZE=str(self.chips),
                   PYTHONPYCACHEPREFIX=sys.pycache_prefix
                   or os.path.join(ROOT, "build", "pycache"))
        device = "cpu" if torch.device(self.device).type == "cpu" else "cuda"
        self._deadline = time.monotonic() + JOIN_S
        try:
            for r in range(1, self.chips):
                self.procs.append(subprocess.Popen(
                    [*follower_command(), "--workload", self.workload,
                     "--seed", str(self.seed), "--device", device,
                     "--traffic", json.dumps(self.traffic),
                     "--store-port", str(self.store.port),
                     "--leader", str(os.getpid())],
                    cwd=ROOT, stdout=2,
                    env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}))
            _say("followers " + ", ".join(
                f"rank {r} pid {p.pid}" for r, p in enumerate(self.procs, 1)))
        except BaseException:
            self._end_followers()
            raise
        threading.Thread(target=self._watch, daemon=True).start()
        return self

    def join(self):
        """Join rank 0 to the process group; returns the device."""
        if self.chips == 1:
            return self.device
        import torch.distributed as dist

        from dynaalign_torch import parallel

        dev = parallel.distributed_init(f"{HOST}:{self.port}", self.chips, 0,
                                        device=self.device)
        self._joined.set()
        _say(f"rank 0 of {self.chips} joined through "
             f"{dist.get_backend()} on {dev}")
        return dev

    def announce(self, what: str) -> None:
        if self.chips == 1:
            return
        self.store.set(f"call/{self.calls}", what)
        self.calls += 1

    def stop(self) -> list[dict]:
        """Ends the followers' calls; their reports, by rank from 1:
        ``memory_peak_bytes`` on a card and ``forbidden`` modules."""
        if self.chips == 1:
            return []
        self._stopping.set()
        self.announce(STOP)
        return [json.loads(self.store.get(f"report/{r}"))
                for r in range(1, self.chips)]

    def __exit__(self, *exc):
        if self.chips == 1:
            return False
        import torch.distributed as dist

        self._stopping.set()
        if exc[0] is not None:
            self._done.set()  # the run fails already: no watch from here
        try:
            if dist.is_initialized():
                dist.destroy_process_group()
        finally:
            self._end_followers(REPORT_S if exc[0] is None else 0.0)
            self._done.set()
        bad = [(r, p.returncode) for r, p in enumerate(self.procs, 1)
               if p.returncode != 0]
        if bad and exc[0] is None:
            raise RuntimeError(f"followers ended with (rank, code) {bad}")
        return False

    def _end_followers(self, grace: float = 0.0) -> None:
        """Wait up to ``grace`` seconds for each follower, then kill it
        and wait for it to end."""
        end = time.monotonic() + grace
        for p in self.procs:
            try:
                p.wait(max(end - time.monotonic(), 0.0))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()

    def _watch(self) -> None:
        """Ends the run when a follower exits before stop or a rank has
        not joined in time: the leader may be waiting in a rendezvous or
        a collective that cannot finish."""
        while not self._done.wait(0.2):
            for r, p in enumerate(self.procs, 1):
                code = p.poll()
                if code is not None and not (
                        code == 0 and self._stopping.is_set()):
                    self._fail(f"rank {r} (pid {p.pid}) exited with code "
                               f"{code} before the run's end")
            if (not self._joined.is_set()
                    and time.monotonic() > self._deadline):
                self._fail(f"the ranks did not join within {JOIN_S:.0f} s")

    def _fail(self, why: str) -> None:
        _say(f"{why}: no result")
        for p in self.procs:
            if p.poll() is None:
                p.kill()
        for p in self.procs:
            p.wait()
        sys.stdout.flush()
        os._exit(FAILED)


def _watch_leader(leader: int) -> None:
    while os.getppid() == leader:
        time.sleep(0.5)
    os._exit(FAILED)


def follower_main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.ranks")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--device", choices=("cuda", "cpu"), required=True)
    p.add_argument("--traffic", required=True)
    p.add_argument("--store-port", type=int, required=True)
    p.add_argument("--leader", type=int, required=True)
    args = p.parse_args(argv)
    threading.Thread(target=_watch_leader, args=(args.leader,),
                     daemon=True).start()

    import torch
    import torch.distributed as dist

    from dynaalign_torch import parallel
    from portbench import generate, run

    rank = int(os.environ["RANK"])
    store = dist.TCPStore(HOST, args.store_port, None, False,
                          datetime.timedelta(seconds=FOLLOWER_WAIT_S))
    dev = parallel.distributed_init(
        device="cpu" if args.device == "cpu" else None)
    on_card = dev.type == "cuda"
    _say(f"rank {rank} of {dist.get_world_size()} joined through "
         f"{dist.get_backend()} on {dev}")
    _, config, _ = run.find_cell(run.load_json(run.ROOT, "BENCHMARK.json"),
                                 args.workload)
    traffic = json.loads(args.traffic)
    _, entry = run.prepare(config, traffic, args.seed, dev)
    calls = 0
    while True:
        what = store.get(f"call/{calls}").decode()
        calls += 1
        if what == STOP:
            break
        out = entry.call(generate.warm_rows(traffic, entry.seqs)
                         if what == WARM else entry.seqs)
        del out
        if what == WARM and on_card:
            torch.cuda.synchronize(dev)
            torch.cuda.reset_peak_memory_stats(dev)
    report = {"forbidden": forbidden_modules()}
    if on_card:
        report["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            dev))
    del entry
    store.set(f"report/{rank}", json.dumps(report))
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(follower_main())
