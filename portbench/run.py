"""Run one cell of the benchmark once, on the card:

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout.  The cell, its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``), the
entry point (``entries/<entry>.py``) and each metric's reader
(``metrics/<metric>.py``) are found by the names in ``BENCHMARK.json``.

Python bytecode is cached under the checkout's ``build/pycache``, the
port's kernels under its ``build/``: only the first run in a checkout
compiles.

One process: set-up (imports, CUDA context, the inputs from ``--seed``,
one warm call of the entry point on the rows that give the set's padded
width and kernel instance), then the window: calls back to back until
``--seconds`` have passed, the call in flight finished, one result held at
a time and a sample of it read before it is freed.  Then the reference
judges what was read, and the last line of standard output is one JSON
object: ``correct``, ``attempted``, ``failed``, ``metrics`` (``end_to_end``
with ``--trace 0``, ``per_layer`` with ``--trace 1``), ``device``, with
``--trace 1`` ``breakdown``, and last ``checks``: each number compared
with its limit, also printed as the last lines of standard error.

Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits 3.  If the process holds a module of ``jax``, ``jaxlib``,
``flax`` or ``dynaalign_tpu`` once the window has closed, it names them,
prints no result and exits 4.
"""

from __future__ import annotations

import time

_T_IMPORT = time.monotonic()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "dynaalign_tpu")


def process_age() -> float:
    """Seconds since this process started (the kernel's start time, in
    clock ticks since boot); since this module was imported where that
    cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        return (time.clock_gettime(time.CLOCK_BOOTTIME)
                - start / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError, AttributeError):
        return time.monotonic() - _T_IMPORT


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def find_cell(bench: dict, name: str) -> tuple[dict, dict, dict]:
    """(the workload entry, its configuration file, its traffic file)."""
    from portbench import generate

    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: "
                         f"{sorted(cells)}")
    cell = cells[name]
    (cfg,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    return (cell, load_json(ROOT, cfg["file"]),
            generate.load_traffic(cell["traffic"]))


def reader(metric: str):
    path = os.path.join(HERE, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + metric.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclasses.dataclass
class Run:
    """What the metric readers read."""

    unit: str  # the entry point's unit of work
    work: int  # units of work one call does
    bounds: dict  # least seconds of one call's work, by name (counts.py)
    calls: list  # (start, end) of each call, host clock
    window_s: float  # window start to the last call's end
    setup_s: float
    trace: object = None  # trace.Trace of the window with --trace 1


@contextlib.contextmanager
def span(name: str, on: bool):
    if not on:
        yield
        return
    from torch.profiler import record_function

    with record_function(name):
        yield


def prepare(config: dict, traffic: dict, seed: int, device):
    """(the entry point's module, its Entry on the inputs of ``seed``)."""
    from portbench import generate

    seed %= 1 << 64
    seqs = generate.build(traffic, seed)
    name = traffic.get("entry", config["entry"])
    mod = importlib.import_module(f"portbench.entries.{name}")
    settings = {**config["settings"], **traffic.get("args", {})}
    return mod, mod.Entry(seqs, settings, traffic, seed, device)


def measure(cell: dict, config: dict, traffic: dict, seed: int,
            seconds: float, trace: bool, device) -> tuple[dict, Run, dict]:
    """(the result object but ``metrics``, the Run, the checks) of one
    run of ``cell`` on ``device``."""
    import torch

    from portbench import generate
    from portbench import trace as tracing

    import dynaalign_torch  # noqa: F401  (its import is set-up)

    on_card = torch.device(device).type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(device)

    marks = [("imports", process_age())]
    if on_card:
        torch.empty(1, device=device)  # the CUDA context
    marks.append(("card", process_age()))
    mod, entry = prepare(config, traffic, seed, device)
    seqs = entry.seqs
    marks.append(("inputs", process_age()))
    entry.call(generate.warm_rows(traffic, seqs))
    sync()
    marks.append(("warm call", process_age()))
    if on_card:
        torch.cuda.reset_peak_memory_stats(device)

    prof = None
    if trace:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if on_card:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()
    setup_s = process_age()
    readings, calls, failed = [], [], 0
    try:
        with span(tracing.WINDOW, trace):
            w0 = time.perf_counter()
            while True:
                t0 = time.perf_counter()
                out = None
                try:
                    with span(tracing.CALL, trace):
                        out = entry.call(seqs)
                        sync()
                except Exception:  # a failed call is counted, not fatal
                    traceback.print_exc()
                t1 = time.perf_counter()
                got = None if out is None else entry.read(out, len(calls))
                del out
                if got is None:
                    failed += 1
                else:
                    readings.append(got)
                calls.append((t0, t1))
                if t1 - w0 >= seconds:
                    break
    finally:
        t_read = time.perf_counter()
        if prof is not None:
            prof.__exit__(None, None, None)
    run = Run(mod.UNIT, entry.work(), entry.bounds(), calls,
              calls[-1][1] - w0, setup_s)
    dev = {"platform": "gpu" if on_card else "cpu", "count": 1}
    if on_card:
        dev["kind"] = torch.cuda.get_device_name(device)
        dev["memory_peak_bytes"] = int(torch.cuda.max_memory_allocated(
            device))
        dev["power_limit"] = power_limit()
    if prof is not None:
        run.trace = tracing.from_profiler(prof)
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        del prof
    if on_card:
        torch.cuda.empty_cache()
    t_judge = time.perf_counter()
    checks, compared = entry.judge(readings)
    checks["failed_calls"] = (failed, 0)
    print("portbench: set-up s: " + ", ".join(
        f"{k} {t - marks[i - 1][1] if i else t:.3f}"
        for i, (k, t) in enumerate(marks)), file=sys.stderr)
    print("portbench: call s: " + " ".join(
        f"{t1 - t0:.4f}" for t0, t1 in calls[:50]), file=sys.stderr)
    print(f"portbench: {len(calls)} calls in {run.window_s:.3f} s; trace "
          f"read in {t_judge - t_read:.1f} s; reference in "
          f"{time.perf_counter() - t_judge:.1f} s", file=sys.stderr)
    result = {"correct": bool(readings) and all(
                  v <= lim for v, lim in checks.values()),
              "attempted": len(calls), "failed": failed, "device": dev}
    if run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    return result, run, {"checks": checks, "compared": compared}


def power_limit() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def metrics(bench: dict, workload: str, run: Run, trace: bool) -> dict:
    out = {}
    for m in bench["per_layer" if trace else "end_to_end"]:
        if "workloads" in m and workload not in m["workloads"]:
            continue
        value = reader(m["name"])(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # Python bytecode of every module imported from here on (numpy, torch,
    # the program) is cached in the checkout, even where the environment
    # says not to write it, so that only the first run in a checkout
    # compiles Python sources: without it every run compiled torch anew
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    sys.dont_write_bytecode = False
    os.environ.setdefault("TRITON_CACHE_DIR",
                          os.path.join(ROOT, "build", "triton"))
    bench = load_json(ROOT, "BENCHMARK.json")
    cell, config, traffic = find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"portbench: the cell asks for {cell['chips']} CUDA card(s); "
              f"this machine has {torch.cuda.device_count()}: no run",
              file=sys.stderr)
        return 3
    result, run, judged = measure(cell, config, traffic, args.seed,
                                  args.seconds, bool(args.trace),
                                  torch.device("cuda", 0))
    result["metrics"] = metrics(bench, args.workload, run, bool(args.trace))
    found = sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))
    if found:
        print(f"portbench: the process holds {found}: no result",
              file=sys.stderr)
        return 4
    checks = {k: {"value": v, "limit": lim}
              for k, (v, lim) in judged["checks"].items()}
    print("compared: " + ", ".join(
        f"{k} {v}" for k, v in judged["compared"].items()), file=sys.stderr)
    for k, c in checks.items():
        print(f"check {k}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    order = ("correct", "attempted", "failed", "metrics", "device",
             "breakdown")
    line = {k: result[k] for k in order if k in result}
    line["checks"] = checks
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
