"""Time an NW kernel built with other compile-time settings.

    python -m dynaalign_torch.tools.nw_variants NW_BLOCKS_PER_SM=4 ...
    python -m dynaalign_torch.tools.nw_variants --kernel nw_gotoh_xl XL_R=16

Each argument is one variant: ``-D`` definitions joined by commas
(``nw_gotoh``: NW_BLOCKS_PER_SM, NW_THREADS; ``nw_gotoh_xl``: XL_R,
XL_WARPS).  The source as it stands is always the first variant.  Every variant is built with the flags of
:mod:`dynaalign_torch.ops._build` plus its definitions, run on the first
launch of ``similarity_nw`` on h3n2sample[:1000] (131,072 pairs of up to
566 aa) and on all pairs of the evp_peparray 12-mers (``nw_gotoh``) or of
96 joins of h3n2sample proteins (``nw_gotoh_xl``), held equal to the first
variant, and timed with CUDA events, the variants in turns, best of
``--repeat``.  Prints each variant's ptxas lines.  Needs one NVIDIA card
and nvcc.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import subprocess

import torch

from .. import blosum
from ..encode import encode
from ..io.datasets import joined_h3n2, load_sequences
from ..ops import _build, nw_cuda


def start_variant(kernel: str, defines: str):
    """Start nvcc on ``kernel``.cu with ``defines`` ("A=1,B=2"); returns a
    function that waits for it and returns (library, nvcc log), and raises
    if the build failed.  Several may build at once."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    tag = "".join(c if c.isalnum() else "_" for c in defines) or "as_is"
    out = os.path.join(out_dir, f"{kernel}-{tag}.so")
    cmd = _build.nvcc_command(kernel, out)
    cmd += [f"-D{d}" for d in defines.split(",") if d]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)

    def wait():
        log = proc.communicate()[0]
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on variant {defines!r}:\n{log}")
        return ctypes.CDLL(out), log

    return wait


def all_pairs(seqs, dev, limit):
    """The first ``limit`` pairs of the upper triangle of ``seqs`` as a
    batch (a_idx, a_len, b_idx, b_len) on ``dev``."""
    enc = encode(seqs)
    idx = torch.from_numpy(enc.indices).to(dev)
    ln = torch.from_numpy(enc.lengths).to(dev)
    iu = torch.triu_indices(len(seqs), len(seqs), device=dev)[:, :limit]
    return [idx[iu[0]], ln[iu[0]], idx[iu[1]], ln[iu[1]]]


def launch(kernel, lib, batch, sub):
    """(matches, length) of ``batch`` through ``lib``'s ``kernel``, at gaps
    (10, 4)."""
    if kernel == "nw_gotoh_xl":
        return tuple(nw_cuda.launch_xl(lib, *batch, sub, 10, 4))
    a, la, b, lb = batch
    bsz, m = a.shape
    mt = torch.empty(bsz, dtype=torch.int32, device=a.device)
    ln = torch.empty_like(mt)
    a_max = int(la.max())
    sub_t = sub.t().contiguous()  # the kernels read the table as [b][a]
    rc = nw_cuda.bind(lib, kernel)(
        a.data_ptr(), la.data_ptr(), b.data_ptr(), lb.data_ptr(),
        sub_t.data_ptr(), bsz, m, b.shape[1], 10, 4,
        nw_cuda.pick_instance(a_max), a_max, mt.data_ptr(), ln.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch failed: CUDA error {rc}")
    return mt, ln


def event_ms(fn) -> float:
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("variants", nargs="*", help="-D definitions, A=1,B=2")
    ap.add_argument("--kernel", default="nw_gotoh",
                    choices=["nw_gotoh", "nw_gotoh_xl"])
    ap.add_argument("--repeat", type=int, default=3)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available")
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    sub = blosum.get_matrix(device=dev)
    batches = {"h3n2sample[:1000], first 131,072 pairs": all_pairs(
        load_sequences("h3n2sample", limit=1000), dev, 1 << 17)}
    if args.kernel == "nw_gotoh":
        batches["evp_peparray, all pairs"] = all_pairs(
            load_sequences("evp_peparray"), dev, None)
    else:
        batches["96 joins of h3n2sample proteins, all pairs"] = all_pairs(
            joined_h3n2(), dev, None)
    built, waits = {}, {d or "as it stands": start_variant(args.kernel, d)
                        for d in ["", *args.variants]}
    for name, wait in waits.items():
        built[name], log = wait()
        lines = log.splitlines()
        for k, line in enumerate(lines):
            if "Compiling entry" in line:
                entry = line.split("'")[1]
                print(f"{name}: {entry}: {lines[k + 2].strip()}; "
                      + lines[k + 3].split(":", 1)[1].strip())
    for label, batch in batches.items():
        ref = None
        best = dict.fromkeys(built, float("inf"))
        for _ in range(args.repeat):
            for name, lib in built.items():
                got = None

                def run():
                    nonlocal got
                    got = launch(args.kernel, lib, batch, sub)

                best[name] = min(best[name], event_ms(run))
                ref = ref or got
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(f"variant {name} differs on {label}")
        for name, ms in best.items():
            print(f"{label} (B={batch[0].shape[0]}): {name}: {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
