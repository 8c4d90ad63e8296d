#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one NVIDIA card and check it.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises; the exit code is then non-zero):
  1. the card: its name, and name/power limit from nvidia-smi;
  2. build every CUDA source in dynaalign_torch/csrc (one nvcc each),
     printing the ptxas register/shared-memory/spill lines;
  3. every kernel against its plain PyTorch version on the card, on seeded
     fuzz (all BLOSUM tables and gap settings, short, ~566 aa, m != n and
     the largest padded width), exactly;
  4. the main path at full size: similarity_nw on h3n2sample[:1000]
     (500,500 pairs) through the kernel, bit-exact against the serial C++
     oracle on the [:24, :24] and [-24:, -24:] blocks (the first and the
     last chunk), and on evp_peparray[:160] in full;
  5. timing: similarity_nw end to end (best of 3); every main-path chunk
     through the kernel and the plain version, each held equal to the other
     and to the main path's result; the kernel on one chunk beside its
     bound; the serial oracle's rate;
  6. padded widths past the ported kernel's range raise NotImplementedError.

Prints one {"kernels": [...]} line, then {"ok": true, "device": {...}} as
the last line.  Without a card it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).  The int32
# rate is not tabulated: 64 INT32 lanes per SM (half of the 128 FP32 lanes
# behind the 67 TFLOP/s float32 figure) x 132 SMs x 1.98 GHz.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9
# int32 operations per DP cell in the kernel's inner loop, counted from
# csrc/nw_gotoh.cu: Ix 3, Iy 3, diagonal 3, D>U>L decision 4, selects 6,
# match 1.
OPS_PER_CELL = 20
GAPS = [(10, 4), (5, 1), (12, 2)]


def _smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def _random_batch(dev, seed, n, a_range, b_range, pad=None):
    """Seeded pair batch (a_idx, a_len, b_idx, b_len) on ``dev``."""
    from dynaalign_torch.encode import ALPHABET, encode

    rng = np.random.default_rng(seed)
    out = []
    for lo, hi in (a_range, b_range):
        seqs = ["".join(rng.choice(list(ALPHABET), size=k))
                for k in rng.integers(lo, hi + 1, size=n)]
        e = encode(seqs, pad_to=pad)
        out += [torch.from_numpy(e.indices).to(dev),
                torch.from_numpy(e.lengths).to(dev)]
    return out


def _max_err(got, ref) -> int:
    return max(int((got.matches - ref.matches).abs().max()),
               int((got.length - ref.length).abs().max()))


def kernel_vs_plain(dev, n_fuzz=2048, n_long=1024, n_xl=128) -> int:
    """Phase 3: the kernel equals its plain version on every batch."""
    from dynaalign_torch import blosum
    from dynaalign_torch.ops.nw import nw_similarity_batch
    from dynaalign_torch.ops.nw_cuda import nw_similarity_batch_cuda

    cases = []
    for t, name in enumerate(blosum.MATRIX_NAMES):
        for g, gaps in enumerate(GAPS):
            cases.append((f"{name} gaps {gaps} len 1-80", name, gaps,
                          (100 + 3 * t + g, n_fuzz, (1, 80), (1, 80), None)))
    cases += [
        ("len 520-566", "BLOSUM62", (10, 4),
         (1, n_long, (520, 566), (520, 566), 566)),
        ("m != n: 1-80 x 400-566", "BLOSUM62", (10, 4),
         (2, n_long, (1, 80), (400, 566), None)),
        ("padded m+1 = 1120", "BLOSUM62", (10, 4),
         (3, n_xl, (1000, 1119), (1000, 1119), 1119)),
    ]
    worst = 0
    for label, name, (go, ge), batch in cases:
        args = _random_batch(dev, *batch)
        sub = blosum.get_matrix(name, device=dev)
        got = nw_similarity_batch_cuda(*args, sub, gap_open=go, gap_ext=ge)
        if dev.type == "cuda":
            torch.cuda.synchronize()
        ref = nw_similarity_batch(*args, sub, gap_open=go, gap_ext=ge)
        err = _max_err(got, ref)
        same = (torch.equal(got.matches, ref.matches)
                and torch.equal(got.length, ref.length))
        print(f"  kernel vs plain, {label}: B={args[0].shape[0]} "
              f"M={args[0].shape[1]} N={args[2].shape[1]} "
              f"max_abs_err={err} {'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"kernel != plain version on {label}")
        worst = max(worst, err)
    return worst


def check_main_path(sims, seqs, oracle_n=24):
    """Phase 4 checks on one similarity_nw result."""
    from dynaalign_torch import oracle

    n = len(seqs)
    if sims.shape != (n, n) or sims.dtype != np.float64:
        raise AssertionError(f"bad result {sims.shape} {sims.dtype}")
    if not np.isfinite(sims).all() or not (sims == sims.T).all():
        raise AssertionError("result not finite and symmetric")
    if not ((sims >= 0) & (sims <= 1)).all():
        raise AssertionError("result outside [0, 1]")
    k = min(oracle_n, n)
    for block in (slice(None, k), slice(n - k, None)):
        if not np.array_equal(sims[block, block],
                              oracle.nw_similarity(seqs[block])):
            raise AssertionError(f"result != oracle on the {block} block")


def inner_loop_mix(sass: str) -> tuple[int, dict[str, int]]:
    """SASS instruction count and opcode mix of the innermost loop that
    reads shared memory (the DP cell loop), from ``cuobjdump -sass``."""
    import re
    from collections import Counter

    ins = [(int(a, 16), op, tgt) for a, op, tgt in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
        r"(?:\s+(0x[0-9a-f]+))?", sass)]
    best = None
    for a, op, tgt in ins:
        if op != "BRA" or not tgt or int(tgt, 16) >= a:
            continue
        body = [o for x, o, _ in ins if int(tgt, 16) <= x <= a]
        if any(o.startswith("LDS") for o in body) and (
            best is None or len(body) < len(best)
        ):
            best = body
    if best is None:
        raise AssertionError("no shared-memory loop found in the SASS")
    return len(best), dict(Counter(o.split(".")[0] for o in best))


def _event_ms(fn, repeat=1):
    """(ms per call, the last call's result)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(repeat):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / repeat, out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from dynaalign_torch import api, blosum, oracle, similarity_nw
    from dynaalign_torch.io.datasets import load_sequences
    from dynaalign_torch.ops import MAX_MP1, _build, nw_batch, nw_cuda
    from dynaalign_torch.ops.nw import nw_similarity_batch

    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1] device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {smi}")

    names = sorted(p[:-3] for p in os.listdir(_build.CSRC) if p.endswith(".cu"))
    t0 = time.perf_counter()
    built = {name: _build.build(name) for name in names}
    print(f"[2] built {names} in {time.perf_counter() - t0:.2f} s")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    sass = subprocess.run([cuobjdump, "-sass", built["nw_gotoh"].path],
                          capture_output=True, text=True, check=True).stdout
    n_ins, mix = inner_loop_mix(sass)
    cells_per_iter = mix.get("STG", 0) / 5  # five planes stored per cell
    print(f"  nw_gotoh DP loop: {n_ins} SASS instructions for "
          f"{cells_per_iter:g} cells = {n_ins / cells_per_iter:.1f} per cell; "
          f"mix {sorted(mix.items(), key=lambda kv: -kv[1])}")

    print("[3] kernel vs plain version on the card")
    worst = kernel_vs_plain(dev)

    print("[4] main path: similarity_nw on h3n2sample[:1000]")
    h3n2 = load_sequences("h3n2sample", limit=1000)
    nw_cuda.LAUNCHES = 0
    t0 = time.perf_counter()
    sims = similarity_nw(h3n2)
    first_s = time.perf_counter() - t0
    launches = nw_cuda.LAUNCHES
    if launches == 0:
        raise AssertionError("the main path never launched the kernel")
    check_main_path(sims, h3n2)
    print(f"  n=1000: {launches} kernel launches, first call {first_s:.3f} s,"
          " bit-exact vs the oracle on [:24, :24] and [-24:, -24:]")
    evp = load_sequences("evp_peparray", limit=160)
    nw_cuda.LAUNCHES = 0
    sims_e = similarity_nw(evp)
    evp_launches = nw_cuda.LAUNCHES
    if evp_launches == 0 or not np.array_equal(
        sims_e, oracle.nw_similarity(evp)
    ):
        raise AssertionError("evp_peparray[:160] != oracle or no launch")
    print(f"  evp_peparray[:160]: {evp_launches} launch(es), equal to the "
          "oracle in full")

    print("[5] timing")
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    lens = np.array([len(s) for s in h3n2], dtype=np.float64)
    n = len(h3n2)
    pairs = n * (n + 1) // 2
    cells = (lens.sum() ** 2 + (lens ** 2).sum()) / 2  # upper tri + diagonal
    walls = []
    for _ in range(3):
        t0 = time.perf_counter()
        similarity_nw(h3n2)
        walls.append(time.perf_counter() - t0)
    best = min(walls)
    print(f"  similarity_nw n=1000 wall s: {walls}; best {best:.4f} s = "
          f"{pairs / best:.1f} pairs/s, {cells / best:.4e} cell updates/s "
          f"({cells:.4e} cells)")

    # the main path's chunks, rebuilt as api.similarity_nw builds them; each
    # through the kernel and the plain version, held equal to each other and
    # to the main path's result for those pairs
    from dynaalign_torch.encode import encode

    enc = encode(h3n2)
    idx = torch.from_numpy(enc.indices).to(dev)
    ln = torch.from_numpy(enc.lengths).to(dev)
    iu = torch.triu_indices(n, n, device=dev)
    iu_np = np.triu_indices(n)
    sub = blosum.get_matrix(device=dev)
    chunk_ms, plain_chunk_ms = [], []
    for s in range(0, pairs, api.DEFAULT_CHUNK):
        e = min(s + api.DEFAULT_CHUNK, pairs)
        r, c = iu[:, s:e]
        args = [idx[r], ln[r], idx[c], ln[c]]
        k_ms, got = _event_ms(
            lambda: nw_cuda.nw_similarity_batch_cuda(*args, sub))
        p_ms, ref = _event_ms(lambda: nw_similarity_batch(*args, sub))
        chunk_ms.append(k_ms)
        plain_chunk_ms.append(p_ms)
        worst = max(worst, _max_err(got, ref))
        if not (torch.equal(got.matches, ref.matches)
                and torch.equal(got.length, ref.length)):
            raise AssertionError(f"kernel != plain on main-path pairs {s}:{e}")
        if not np.array_equal(sims[iu_np[0][s:e], iu_np[1][s:e]],
                              ref.similarity()):
            raise AssertionError(f"similarity_nw != plain on pairs {s}:{e}")
        print(f"  main-path chunk {s}:{e} (B={e - s}, M=N={args[0].shape[1]}):"
              f" kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms; kernel == plain"
              " == similarity_nw")
    print(f"  kernel time of each main-path chunk, ms: {chunk_ms}; sum "
          f"{sum(chunk_ms):.3f} ms = {sum(chunk_ms) / 1e3 / best:.4f} of the "
          "best wall time (the rest: host work, gathers, copies)")
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    for c in (1 << 16, 1 << 18, pairs):
        t0 = time.perf_counter()
        similarity_nw(h3n2, chunk=c)
        print(f"  similarity_nw n=1000 with chunk={c}: "
              f"{time.perf_counter() - t0:.4f} s")

    r, c = iu[:, : api.DEFAULT_CHUNK]
    chunk = [idx[r], ln[r], idx[c], ln[c]]
    bsz, m = chunk[0].shape
    la, lb = chunk[1].double(), chunk[3].double()
    chunk_cells = float((la * lb).sum())
    ops = OPS_PER_CELL * chunk_cells
    nbytes = 4 * (2 * bsz * m + 2 * bsz + 32 * 32 + 2 * bsz)
    bound_ops_ms = ops / INT32_OPS_PER_S * 1e3
    bound_bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    bound_ms = max(bound_ops_ms, bound_bytes_ms)
    bound_by = "operations" if bound_ops_ms >= bound_bytes_ms else "bytes"
    kernel_ms, _ = _event_ms(
        lambda: nw_cuda.nw_similarity_batch_cuda(*chunk, sub), repeat=3
    )
    print(f"  kernel, one chunk (B={bsz}, M=N={m}, {chunk_cells:.4e} cells):"
          f" {kernel_ms:.3f} ms; bound {bound_ms:.3f} ms by {bound_by} "
          f"({ops:.4e} int32 ops at {INT32_OPS_PER_S:.4e}/s; {nbytes} bytes "
          f"at {HBM_BYTES_PER_S:.3e} B/s) = {bound_ms / kernel_ms:.4f} of "
          f"the bound; {chunk_cells / kernel_ms * 1e3:.4e} cell updates/s")
    plain_ms = plain_chunk_ms[0]
    print(f"  plain version (correctness twin, not a yardstick), same chunk:"
          f" {plain_ms:.3f} ms")
    print("  library_ms: none (no single PyTorch call computes NW)")
    t0 = time.perf_counter()
    oracle.nw_similarity(h3n2[:24])
    oracle_s = time.perf_counter() - t0
    oracle_rate = 300 / oracle_s
    print(f"  serial C++ oracle, h3n2sample[:24] (300 pairs): {oracle_s:.4f}"
          f" s = {oracle_rate:.2f} pairs/s; similarity_nw / oracle = "
          f"{pairs / best / oracle_rate:.2f}x")

    print("[6] padded m+1 > 1120 (the _kernel_xl range, not yet ported)")
    wide = _random_batch(dev, 4, 4, (5, 10), (5, 10), pad=MAX_MP1)
    try:
        nw_batch(*wide, sub)
    except NotImplementedError as e:
        print(f"  raises NotImplementedError: {e}")
    else:
        raise AssertionError("padded m+1 > 1120 did not raise")

    print(f"nvidia-smi name, power.limit: {_smi()}")
    print(json.dumps({"kernels": [{
        "name": "nw_gotoh",
        "route": "cuda",
        "source": "dynaalign_torch/csrc/nw_gotoh.cu",
        "replaces": "dynaalign_tpu/ops/nw_pallas.py::_kernel",
        "replaces_line": "dynaalign_tpu/ops/nw_pallas.py:302",
        "launches": launches,
        "equal_to_plain": True,
        "max_abs_err": worst,
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
