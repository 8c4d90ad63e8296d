"""The readings that a cell's limits are set from, on the card:

    python3 -m portbench.control --workload <name> --calls <c> \\
        --seeds <n> [<n> ...]

For each seed, in one process: the cell's inputs, one call of the program
at the cell's size, and ``c`` readings of its result, as a run of ``c``
calls reads them; then each number that a run compares, for the program
(the lower reading) and for each of the entry point's controls (the
upper reading): the reference itself in the program's place, in float32,
the precision below the float64 that the configurations state.  One JSON
line per seed.

The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(config: dict, traffic: dict, seed: int, calls: int, device):
    """(the entry point's module, its Entry, ``calls`` readings of one
    call's result, the call's seconds)."""
    from portbench import run

    mod, entry = run.prepare(config, traffic, seed, device)
    t0 = time.perf_counter()
    out = entry.call(entry.seqs)
    wall = time.perf_counter() - t0
    got = [entry.read(out, c) for c in range(calls)]
    if any(g is None for g in got):
        raise ValueError("the program's result is malformed")
    return mod, entry, got, wall


def main(argv=None) -> int:
    from portbench import run

    p = argparse.ArgumentParser(prog="python3 -m portbench.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--calls", type=int, default=1)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    bench = run.load_json(run.ROOT, "BENCHMARK.json")
    _, config, traffic = run.find_cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA card", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    for seed in args.seeds:
        mod, entry, got, wall = readings(config, traffic, seed, args.calls,
                                         dev)
        t0 = time.perf_counter()
        prog, compared = entry.judge(got)
        ctrl = {c: entry.judge(got, c)[0] for c in mod.CONTROLS}
        print(json.dumps({
            "workload": args.workload, "seed": seed, "call_s": wall,
            "program": {k: v for k, (v, _) in prog.items()},
            "controls": {c: {k: v for k, (v, _) in r.items()}
                         for c, r in ctrl.items()},
            "compared": compared,
            "judge_s": time.perf_counter() - t0}), flush=True)
        del entry, got
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
