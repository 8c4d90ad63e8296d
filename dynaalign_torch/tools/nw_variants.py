"""Time an NW kernel built with other compile-time settings.

    python -m dynaalign_torch.tools.nw_variants NW_BLOCKS_PER_SM=4 ...
    python -m dynaalign_torch.tools.nw_variants --kernel nw_gotoh_xl XL_R=16

Each argument is one variant: ``-D`` definitions joined by commas
(``nw_gotoh``: NW_BLOCKS_PER_SM, NW_THREADS;
``nw_gotoh_xl``: XL_R, XL_WARPS).  The source as it stands is always the
first variant.  Every variant is built with the flags of
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


def build_variant(kernel: str, defines: str):
    """(launcher, nvcc log) of ``kernel``.cu with ``defines`` ("A=1,B=2")."""
    out_dir = os.path.join(_build.BUILD_DIR, "variants")
    os.makedirs(out_dir, exist_ok=True)
    tag = "".join(c if c.isalnum() else "_" for c in defines) or "as_is"
    out = os.path.join(out_dir, f"{kernel}-{tag}.so")
    cmd = _build.nvcc_command(kernel, out)
    cmd += [f"-D{d}" for d in defines.split(",") if d]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on variant {defines!r}:\n"
                           f"{proc.stdout}{proc.stderr}")
    fn = getattr(ctypes.CDLL(out), f"{kernel}_launch")
    fn.argtypes = list(nw_cuda.LAUNCH_ARGTYPES_NW if kernel == "nw_gotoh"
                       else nw_cuda.LAUNCH_ARGTYPES)
    fn.restype = ctypes.c_int
    return fn, proc.stdout + proc.stderr


def all_pairs(seqs, dev, limit):
    """The first ``limit`` pairs of the upper triangle of ``seqs`` as a
    batch (a_idx, a_len, b_idx, b_len) on ``dev``."""
    enc = encode(seqs)
    idx = torch.from_numpy(enc.indices).to(dev)
    ln = torch.from_numpy(enc.lengths).to(dev)
    iu = torch.triu_indices(len(seqs), len(seqs), device=dev)[:, :limit]
    return [idx[iu[0]], ln[iu[0]], idx[iu[1]], ln[iu[1]]]


def launch(kernel, fn, batch, sub):
    a, la, b, lb = batch
    bsz, m = a.shape
    n = b.shape[1]
    mt = torch.empty(bsz, dtype=torch.int32, device=a.device)
    ln = torch.empty_like(mt)
    if kernel == "nw_gotoh":
        a_max = int(la.max())
        mid = (nw_cuda.pick_instance(a_max), a_max)
    else:
        scratch = torch.empty(3 * (n + 1) * bsz, dtype=torch.int32,
                              device=a.device)
        mid = (1, scratch.data_ptr())  # MT and LN in one word
    sub_t = sub.t().contiguous()  # the kernels read the table as [b][a]
    rc = fn(a.data_ptr(), la.data_ptr(), b.data_ptr(), lb.data_ptr(),
            sub_t.data_ptr(), bsz, m, n, 10, 4, *mid, mt.data_ptr(),
            ln.data_ptr(), torch.cuda.current_stream().cuda_stream)
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
    built = {}
    for defines in ["", *args.variants]:
        name = defines or "as it stands"
        built[name], log = build_variant(args.kernel, defines)
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
            for name, fn in built.items():
                got = None

                def run():
                    nonlocal got
                    got = launch(args.kernel, fn, batch, sub)

                best[name] = min(best[name], event_ms(run))
                ref = ref or got
                if not all(torch.equal(x, y) for x, y in zip(got, ref)):
                    raise AssertionError(f"variant {name} differs on {label}")
        for name, ms in best.items():
            print(f"{label} (B={batch[0].shape[0]}): {name}: {ms:.3f} ms")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
