#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths on one NVIDIA card and check them.

    python3 chip_smoke.py        # from the repository root; needs one card

Phases (any failure raises; the exit code is then non-zero):
  1. the card: its name, and name/power limit from nvidia-smi;
  2. build every CUDA source in dynaalign_torch/csrc (one nvcc each, all
     started together) and the three C++ libraries (g++),
     printing the ptxas register/shared-memory/spill lines and, for the
     step loop of both NW kernels, the SASS instructions per DP cell and
     whether the DPX opcodes are in its mix;
  3. nw_gotoh against its plain PyTorch version on the card, exactly, on
     seeded fuzz of every instantiation (all BLOSUM tables and gap
     settings, lengths at each strip capacity, 1-4 columns, tie-heavy
     low-complexity batches, m != n, ~566 aa, the largest padded width, and
     a table that is not symmetric);
  4. nw_gotoh_xl against the plain version likewise (the 18 table x gap
     batches at 1-80 aa, 1,121-2,000 aa, m != n, lengths on strip edges,
     and a batch of M + N >= 65,536 through its two-word instantiation);
  5. the main path at full size: similarity_nw on h3n2sample[:1000]
     (500,500 pairs) through nw_gotoh, bit-exact against the serial C++
     oracle on the [:24, :24] and [-24:, -24:] blocks; on
     evp_peparray[:160] in full; and timed on all 641 evp_peparray 12-mers;
  6. timing of that path: end to end (best of 3) and stage by stage (the
     entry point's own steps, timed in place); every chunk through the
     kernel, held equal to the main path's result, and the first chunk
     through the plain version too; the kernel on that chunk beside its
     bound, and nw_gotoh_xl on the same chunk (its wrapper call by call,
     its work table, and the launch alone);
     the serial oracle's rate;
  7. the long path: similarity_nw on 96 joins of h3n2sample proteins
     (624-5,094 aa, 4,656 pairs) through nw_gotoh_xl alone, against the
     oracle on two 16x16 blocks, the kernel on every pair and the plain
     version on every fourth, timed beside its bound and the oracle's rate;
     nw_gotoh_xl's launch alone (table prebuilt) on the whole set, on every
     fourth pair and on the longest pair alone (the critical path), with
     each launch's pairs and items;
  8. similarity_nw_bucketed on a mixed set (12-mers, HA, 2-3 HA joined)
     launching both NW kernels, equal to similarity_nw and the oracle;
  9. nw_rescore_pairs past every TPU ceiling (13,000 x 13,000 and
     12,300 x 17,000 aa, and 300 x 40,000 aa through nw_gotoh_xl's two-word
     instantiation) against the oracle, and the launch alone on each batch
     (table prebuilt) by CUDA events;
 10. the shift probe: every kind against its plain version, ns per step
     and the marginals of the shuffle and the shifted load;
 11. MinHash: similarity_mh on the 641 evp_peparray 12-mers (k=2,
     n_hash=50) equal to the seeded oracle in full; signatures of
     h3n2sample[:1000] (k=4, n_hash=500) equal to the oracle's bit for bit;
     k = 1, 3, 5, 8 on a mixed set; card equal to CPU; timed on all 8,103
     h3n2sample proteins (k=4, n_hash=500) stage by stage, each stage
     beside its bound, with the peak device memory;
 12. top-k: the tie canary (96 x 8 signatures over {0, 1, 2}, k=7) and
     minhash_topk on the 65,339 allunique 12-mers (top_k=64) against a
     stable host sort of host-computed counts on the first and last 256
     rows, timed;
 13. hybrid: similarity_hybrid on h3n2sample[:1000] (kept entries equal
     to phase 5's NW matrix, the rest 0, through nw_gotoh) and on the long
     set (through nw_gotoh_xl, against phase 7's matrix);
     similarity_hybrid_sparse at top_k = N - 1 equal to the dense result;
     the viral-panel configuration at full size (herv, 5,701 12-mers)
     timed by stage, a 256-pair sample against the oracle;
 14. clustering: clusterbreak on the 641 evp_peparray 12-mers, card equal
     to CPU; cluster_large and cluster_large_exact on allunique with their
     stage timings; Louvain's native pass equal to its numpy pass on
     allunique[:4096];
 15. pipeline and CLI: BASELINE config 3 (Pipeline, MH k=4 n_hash=500,
     clusterbreak size_max=800 thresh_p=0.8, consensus) on all 8,103
     h3n2sample rows, each stage timed, its clusters.csv and consensus.csv
     held to sha256 digests pinned from the JAX package; the MSA's native
     row DP against its numpy plain version on the three largest clusters;
     then `python -m dynaalign_torch` as a user runs it (similarity on the
     long set and on h3n2sample[:1000], pipeline on evp_peparray, cluster
     --engine hybrid-sparse on allunique, consensus on the evp run's
     clusters.csv, stats, datasets, warm), each output held to phases 5, 7
     and 14, pinned digests or the in-process result;
 16. parallel/: this script again, in a worker mode, as the ranks of two
     process groups: (a) world size 1 on NCCL under `python -m
     torch.distributed.run --standalone --nproc_per_node=1`, so that
     distributed_init reads torchrun's environment, running at full size
     sharded_nw_allpairs on h3n2sample[:1000] (nw_gotoh) and on the long
     set (nw_gotoh_xl), sharded_nw_allpairs_bucketed on the mixed set (both
     kernels), sharded_minhash_similarity on all 8,103 h3n2sample rows
     (k=4, n_hash=500), sharded_minhash_topk and cluster_large(mesh=) on
     the 65,339 allunique 12-mers; (b) 2 ranks on gloo through a file://
     store, both computing on cuda:0 (the machine has one card, and NCCL
     refuses two ranks on one card): sharded_nw_allpairs on
     h3n2sample[:1000], sharded_minhash_similarity on the 641 evp_peparray
     12-mers (k=2, n_hash=50), sharded_minhash_topk on allunique[:8192].
     Every result of every rank must equal the single-device result of
     phases 5, 7, 8, 11, 12 and 14 byte for byte; each run prints its wall
     and gather seconds, the planners' per-rank split, the NW pairs and the
     launches of each NW kernel per rank.  A rank that exits non-zero or a
     world that outlives its timeout fails the phase;
 17. acceptance: tests/test_golden.py's values (mt19937, murmur3, MinHash,
     NW) and tests/test_integration_real_data.py's studies on the card, at
     their sizes and thresholds: NW on h3n2sample[:12] and MH on
     evp_peparray[:200] bit-exact against the oracle, MH/NW correlation in
     three regimes over 10 seeds, the Mantel test, consensus column
     agreement, clusterbreak's ARI against the H3N2 clades (card equal to
     CPU); the Louvain/networkx study is left out (no networkx there); the
     Pearson r of MH against phase 5's NW matrices (printed only); then
     examples/getting_started_torch.py --no-plots on the card and with
     --device cpu, each timed, their printed lines equal.

Prints one {"kernels": [...]} line, then {"ok": true, "device": {...}} as
the last line.  Without a card it exits non-zero and prints no result.
`python3 chip_smoke.py --parallel-worker MODE OUT_DIR [STORE RANK]` is one
rank of phase 16, which the script starts itself.
"""

from __future__ import annotations

import contextlib
import csv
import importlib.util
import io
import json
import os
import re
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet; dense, at the 700 W limit).  Integer
# rates are not tabulated.  An SM issues one warp-instruction a clock from
# each of its four schedulers, 128 thread-instructions a clock, and has 64
# INT32 ALU lanes (half of the 128 FP32 lanes behind the 67 TFLOP/s float32
# figure); integer adds, multiply-adds and dp4a can also go down the FMA
# pipe, so only what the ALU alone takes is held to the 64 lanes.
HBM_BYTES_PER_S = 3.35e12
ALU_OPS_PER_S = 64 * 132 * 1.98e9
SCHED_OPS_PER_S = 128 * 132 * 1.98e9
# Integer operations per DP cell that both NW kernels' bound counts, read
# from csrc/nw_cell.cuh, where they are derived: NW_OPS_PER_CELL (with
# Hopper's fused add-max, max-with-predicate and dp4a: Ix 2, Iy 2, diagonal
# 1, the two maxima 2, the path word 5) at the issue rate, and
# NW_ALU_OPS_PER_CELL of them (add-max, maxima, compare, selects) at the
# ALU rate; the bound is the larger time.  The first versions of the
# kernels were held to 20 at the ALU rate (Ix 3, Iy 3, diagonal 3, D>U>L
# decision 4, selects 6, match 1); shares of that older bound are printed
# beside the new ones.
OPS_PER_CELL = ALU_OPS_PER_CELL = None  # read when the script starts
OLD_OPS_PER_CELL = 20
DPX_OPCODES = ("VIADDMNMX", "VIMNMX", "IDP")
GAPS = [(10, 4), (5, 1), (12, 2)]
CLOCKS = "clocks.sm,clocks.max.sm,power.draw,temperature.gpu"


def _smi(query="name,power.limit") -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def _ops_per_cell() -> tuple[int, int]:
    """(NW_OPS_PER_CELL, NW_ALU_OPS_PER_CELL) of csrc/nw_cell.cuh."""
    import re

    from dynaalign_torch.ops import _build

    with open(os.path.join(_build.CSRC, "nw_cell.cuh")) as f:
        text = f.read()
    return tuple(int(re.search(rf"#define {name} (\d+)", text)[1])
                 for name in ("NW_OPS_PER_CELL", "NW_ALU_OPS_PER_CELL"))


def _random_batch(dev, seed, n, a_range, b_range, pad=None, pad_b=None,
                  alphabets=None):
    """Seeded pair batch (a_idx, a_len, b_idx, b_len) on ``dev``: lengths
    drawn from a (lo, hi) range or cycled from a list; ``pad`` pads both
    sides unless ``pad_b`` is given; ``alphabets`` = (a's, b's) letters."""
    from dynaalign_torch.encode import ALPHABET, encode

    alphabets = alphabets or (ALPHABET, ALPHABET)

    rng = np.random.default_rng(seed)
    out = []
    for lens, to, letters in ((a_range, pad, alphabets[0]),
                              (b_range, pad if pad_b is None else pad_b,
                               alphabets[1])):
        if isinstance(lens, list):
            lens = np.resize(lens, n)
        else:
            lens = rng.integers(lens[0], lens[1] + 1, size=n)
        seqs = ["".join(rng.choice(list(letters), size=k)) for k in lens]
        e = encode(seqs, pad_to=to)
        out += [torch.from_numpy(e.indices).to(dev),
                torch.from_numpy(e.lengths).to(dev)]
    return out


def _max_err(got, ref) -> int:
    return max(int((got.matches - ref.matches).abs().max()),
               int((got.length - ref.length).abs().max()))


def _equal(got, ref) -> bool:
    return (torch.equal(got.matches, ref.matches)
            and torch.equal(got.length, ref.length))


def _fuzz_cases(seed0, n_fuzz):
    """The 18 BLOSUM table x gap setting batches at 1-80 aa."""
    from dynaalign_torch import blosum

    return [(f"{name} gaps {gaps} len 1-80", name, gaps,
             (seed0 + 3 * t + g, n_fuzz, (1, 80), (1, 80)))
            for t, name in enumerate(blosum.MATRIX_NAMES)
            for g, gaps in enumerate(GAPS)]


def kernel_vs_plain(dev, wrapper, cases) -> int:
    """The kernel behind ``wrapper`` equals its plain version on every
    batch; returns the largest absolute difference (0).  A case's batch is
    _random_batch's arguments, the last one optionally a dict of its keyword
    arguments; a fifth entry names the nw_gotoh instantiation that must
    have run."""
    from dynaalign_torch import blosum
    from dynaalign_torch.ops import nw_cuda
    from dynaalign_torch.ops.nw import nw_similarity_batch

    worst = 0
    for label, name, (go, ge), batch, *inst in cases:
        kw = batch[-1] if isinstance(batch[-1], dict) else {}
        args = _random_batch(dev, *batch[: len(batch) - bool(kw)], **kw)
        sub = blosum.get_matrix(name, device=dev)
        got = wrapper(*args, sub, gap_open=go, gap_ext=ge)
        torch.cuda.synchronize()
        ran = ""
        if inst:
            ran = f" instance {nw_cuda.LAST_INSTANCE}"
            if nw_cuda.LAST_INSTANCE != inst[0]:
                raise AssertionError(f"{label}: ran{ran}, not {inst[0]}")
        ref = nw_similarity_batch(*args, sub, gap_open=go, gap_ext=ge)
        err = _max_err(got, ref)
        same = _equal(got, ref)
        print(f"  {wrapper.__name__}{ran} vs plain, {label}: "
              f"B={args[0].shape[0]} M={args[0].shape[1]} "
              f"N={args[2].shape[1]} max_abs_err={err} "
              f"{'equal' if same else 'DIFFERENT'}")
        if not same:
            raise AssertionError(f"{wrapper.__name__} != plain on {label}")
        worst = max(worst, err)
    return worst


def instance_cases(instances):
    """Fuzz of every nw_gotoh instantiation (G lanes x R rows): the six
    tables x three gap settings on the first, and on each one lengths at
    its strip's capacity and next to it, 1-4 columns, and a tie-heavy
    low-complexity batch (BLOSUM45, gaps (5, 1))."""
    from dynaalign_torch import blosum

    cases = []
    for t, name in enumerate(blosum.MATRIX_NAMES):
        for g, gaps in enumerate(GAPS):
            cases.append((f"{name} gaps {gaps} a 1-12 x b 1-40", name, gaps,
                          (300 + 3 * t + g, 2048, (1, 12), (1, 40)), 0))
    prev_cap = 0
    for k, (g, r) in enumerate(instances):
        cap = g * r
        tag = f"G={g} R={r}"
        cases += [
            (f"{tag}: a_len {prev_cap + 1}, {cap - 1}, {cap} x b 1-90",
             "BLOSUM62", (10, 4),
             (400 + k, 512, [prev_cap + 1, cap - 1, cap, max(1, cap // 2)],
              (1, 90)), k),
            (f"{tag}: 1-4 columns", "BLOSUM80", (5, 1),
             (420 + k, 512, (prev_cap + 1, cap), (1, 4)), k),
            (f"{tag}: tie-heavy", "BLOSUM45", (5, 1),
             (440 + k, 512, (prev_cap + 1, cap), (1, min(cap + 20, 300)),
              {"alphabets": ("AAG", "AGG")}), k),
        ]
        prev_cap = cap
    last = len(instances) - 1
    cap = prev_cap
    cases += [
        (f"two strips: a_len {cap + 1}-1119 x b 1-1119, N = 1119",
         "BLOSUM62", (12, 2),
         (460, 128, [cap + 1, cap + 2, 1119, 1000, 800], (1, 1119),
          1119), last),
        ("two strips: tie-heavy, 1-4 columns", "BLOSUM45", (5, 1),
         (461, 128, (cap + 1, 1119), (1, 4), {"alphabets": ("AAG", "AGG")}),
         last),
    ]
    return cases


def check_result(sims, seqs, blocks):
    """A similarity matrix is float64, finite, symmetric, in [0, 1], and
    equals the serial oracle on each index block in ``blocks``."""
    from dynaalign_torch import oracle

    n = len(seqs)
    if sims.shape != (n, n) or sims.dtype != np.float64:
        raise AssertionError(f"bad result {sims.shape} {sims.dtype}")
    if not np.isfinite(sims).all() or not (sims == sims.T).all():
        raise AssertionError("result not finite and symmetric")
    if not ((sims >= 0) & (sims <= 1)).all():
        raise AssertionError("result outside [0, 1]")
    for idx in blocks:
        idx = np.asarray(idx)
        if not np.array_equal(sims[np.ix_(idx, idx)],
                              oracle.nw_similarity([seqs[i] for i in idx])):
            raise AssertionError(f"result != oracle on block {idx.tolist()}")


def inner_loop_mix(sass: str, kernel: str) -> tuple[int, dict[str, int]]:
    """SASS instruction count and opcode mix of the innermost loop that
    reads shared memory (the steady step loop of the DP) in the function
    whose mangled name holds ``kernel``, from ``cuobjdump -sass``."""
    import re
    from collections import Counter

    body = [f for f in sass.split("Function : ")[1:]
            if kernel in f.split("\n", 1)[0]]
    if not body:
        raise AssertionError(f"no function {kernel} in the SASS")
    ins = [(int(a, 16), op, tgt) for a, op, tgt in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)"
        r"(?:\s+(0x[0-9a-f]+))?", body[0])]
    best = None
    for a, op, tgt in ins:
        if op != "BRA" or not tgt or int(tgt, 16) >= a:
            continue
        loop = [o for x, o, _ in ins if int(tgt, 16) <= x <= a]
        if any(o.startswith("LDS") for o in loop) and (
            best is None or len(loop) < len(best)
        ):
            best = loop
    if best is None:
        raise AssertionError(f"no shared-memory loop in {kernel}'s SASS")
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


def _best_ms(fn, calls=4):
    """(best ms, the last result) of ``calls`` calls of ``fn``, each timed
    alone by CUDA events."""
    times = []
    for _ in range(calls):
        ms, out = _event_ms(fn)
        times.append(ms)
    return min(times), out


def _xl_table_text(a_len, b_len) -> str:
    """Pairs, queue items (strips) and the most strips of a pair of the
    nw_gotoh_xl launch just made on the batch with these lengths; raises
    unless the wrapper's table had that many items."""
    from dynaalign_torch.ops import nw_cuda

    strips = nw_cuda.xl_strips(a_len, b_len, nw_cuda.XL_STRIP)
    items = int(strips.sum())
    if nw_cuda.LAST_XL_ITEMS != items:
        raise AssertionError(f"nw_gotoh_xl's table had "
                             f"{nw_cuda.LAST_XL_ITEMS} items, not {items}")
    return (f"{a_len.shape[0]} pairs, {items} queue items (strips of "
            f"{nw_cuda.XL_STRIP} rows; {int((strips > 1).sum())} pairs of "
            f"more than one, at most {int(strips.max())})")


def _bound(cells, nbytes):
    """(bound ms, bound_by, the older bound's ms) of an NW launch: its
    operations (the larger of ALU_OPS_PER_CELL per cell at the ALU rate and
    OPS_PER_CELL at the issue rate) against its bytes at the HBM rate; the
    older bound held OLD_OPS_PER_CELL per cell to the ALU rate."""
    ops_ms = max(ALU_OPS_PER_CELL * cells / ALU_OPS_PER_S,
                 OPS_PER_CELL * cells / SCHED_OPS_PER_S) * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    old_ms = max(OLD_OPS_PER_CELL * cells / ALU_OPS_PER_S * 1e3, bytes_ms)
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", old_ms)


def stage_times(stages, call):
    """(seconds by label, what ``call`` returned): ``call()`` runs as it
    is, with each function named in ``stages`` ({(module, name): label})
    wrapped in a timer that synchronises the card before it stops.  What no
    stage covers (copies to the card, indices, loops) is "the rest"."""
    out = dict.fromkeys(stages.values(), 0.0)
    real = {key: getattr(*key) for key in stages}

    def timed(key):
        def wrapped(*args, **kw):
            t0 = time.perf_counter()
            res = real[key](*args, **kw)
            torch.cuda.synchronize()
            out[stages[key]] += time.perf_counter() - t0
            return res
        return wrapped

    try:
        for key in stages:
            setattr(*key, timed(key))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = call()
        total = time.perf_counter() - t0
    finally:
        for key, fn in real.items():
            setattr(*key, fn)
    out["the rest"] = total - sum(out.values())
    return out, res


def _stage_text(stages: dict[str, float]) -> str:
    total = sum(stages.values())
    return (f"wall {total:.4f}: " + ", ".join(
        f"{k} {v:.4f} ({v / total:.3f})" for k, v in stages.items()))


def host_stages(seqs) -> dict[str, float]:
    """Seconds similarity_nw spends in each of its own steps on ``seqs``,
    by the function of dynaalign_torch.api that does each."""
    from dynaalign_torch import api

    return stage_times({
        (api, "encode"): "encode", (api, "_gather"): "the idx[r] gathers",
        (api, "nw_batch"): "kernels with their checks",
        (api, "_fetch"): "fetch", (api, "_ratio"): "ratio",
        (api, "_fill"): "symmetric fill",
    }, lambda: api.similarity_nw(seqs))[0]


def _pair_batch(idx, ln, rows, cols):
    return [idx[rows], ln[rows], idx[cols], ln[cols]]


def long_set():
    """96 sequences of 2-9 consecutive h3n2sample proteins joined."""
    from dynaalign_torch.io.datasets import joined_h3n2

    return joined_h3n2(96, 2, 9, seed=0)


def mixed_set():
    """evp_peparray[:64] + h3n2sample[:64] + 64 joins of 2-3 full-length
    HA proteins (1,132-1,698 aa) from h3n2sample[64:]."""
    from dynaalign_torch.io.datasets import load_sequences

    ha = load_sequences("h3n2sample")
    full = [s for s in ha[64:] if len(s) >= 566]
    joins, pos = [], 0
    for k in np.random.default_rng(1).integers(2, 4, size=64):
        joins.append("".join(full[pos : pos + k]))
        pos += k
    return load_sequences("evp_peparray", 64) + ha[:64] + joins


def _best_of(fn, repeat=3):
    """(wall seconds of each call, the last result), each call ending in a
    synchronise."""
    walls = []
    for _ in range(repeat):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return walls, out


def _ops_per_hash(k: int) -> int:
    """Integer operations ops/murmur3.py spends on one hash of the
    [n, P, H] tensor, with a rotate counted as shift, shift, or: each
    4-byte block xor 1 + rotate 3 + multiply 1 + add 1; the tail's xor 1;
    the finaliser's xor with k 1, three shift-and-xor 6 and two multiplies
    2; and the unsigned min over positions 1."""
    return 6 * (k // 4) + (1 if k & 3 else 0) + 9 + 1


def _pair_ops_bound(n_rows: int, n: int, n_hash: int, out_bytes: int):
    """(bound ms, bound_by, ops ms, bytes ms) of comparing ``n_rows`` rows'
    signatures with all ``n`` rows': one compare and one add per slot at
    the ALU rate; the signatures read once and the result written once."""
    ops_ms = 2.0 * n_rows * n * n_hash / ALU_OPS_PER_S * 1e3
    bytes_ms = (4.0 * n * n_hash + out_bytes) / HBM_BYTES_PER_S * 1e3
    return (max(ops_ms, bytes_ms),
            "operations" if ops_ms >= bytes_ms else "bytes", ops_ms, bytes_ms)


def _stable_topk(sigs: np.ndarray, rows, k: int, step: int = 64):
    """(counts, indices) [len(rows), k] by a stable descending host sort of
    host-computed agreement counts: equal counts lowest index first."""
    vals, idx = [], []
    for s in range(0, len(rows), step):
        r = np.asarray(rows[s : s + step])
        counts = (sigs[r][:, None, :] == sigs[None, :, :]).sum(
            -1, dtype=np.int64)
        counts[np.arange(len(r)), r] = -1
        order = np.stack([np.argsort(-c, kind="stable")[:k] for c in counts])
        idx.append(order)
        vals.append(np.take_along_axis(counts, order, axis=1))
    return np.concatenate(vals), np.concatenate(idx)


def phase_minhash(dev, evp_all, h3n2_all, refs):
    """[11] MinHash against the seeded oracle, and its stage times; the
    digests of the evp and full h3n2 matrices go into ``refs``."""
    from dynaalign_torch import api, oracle, similarity_mh
    from dynaalign_torch.encode import encode
    from dynaalign_torch.ops import minhash

    print("[11] MinHash against the seeded oracle")
    got = similarity_mh(evp_all, 2, 50)
    if not np.array_equal(got, oracle.minhash_similarity(evp_all, 2, 50, 0)):
        raise AssertionError("similarity_mh != oracle on evp_peparray")
    if not np.array_equal(got, similarity_mh(evp_all, 2, 50, device="cpu")):
        raise AssertionError("similarity_mh: card != cpu on evp_peparray")
    refs["mh evp"] = _digest(got)
    walls, _ = _best_of(lambda: similarity_mh(evp_all, 2, 50))
    print(f"  similarity_mh, all {len(evp_all)} evp_peparray 12-mers, k=2 "
          "n_hash=50: equal to the oracle in full and to device='cpu'; wall "
          f"s {walls}; best {min(walls):.4f} s")

    sub = h3n2_all[:1000]
    enc = encode(sub, validate=False)
    sigs = minhash.signatures_to_numpy(minhash.minhash_signatures(
        enc.ascii, enc.lengths, k=4, n_hash=500))
    t0 = time.perf_counter()
    ref = oracle.minhash_signatures(sub, 4, 500, 0)
    oracle_s = time.perf_counter() - t0
    if sigs.dtype != np.uint32 or not np.array_equal(sigs, ref):
        raise AssertionError("minhash_signatures != oracle on h3n2[:1000]")
    print("  minhash_signatures, h3n2sample[:1000], k=4 n_hash=500: equal to "
          f"the oracle bit for bit (the serial oracle took {oracle_s:.3f} s)")

    rng = np.random.default_rng(11)
    mixed = (evp_all[:40] + [s[:int(c)] for s, c in zip(
        h3n2_all[:40], rng.integers(0, 200, size=40))] + ["", "A", "AR"])
    for k in (1, 3, 5, 8):
        got = similarity_mh(mixed, k, 64, seed=2**31 + k)
        if not np.array_equal(
            got, oracle.minhash_similarity(mixed, k, 64, 2**31 + k)
        ) or not np.array_equal(
            got, similarity_mh(mixed, k, 64, seed=2**31 + k, device="cpu")
        ):
            raise AssertionError(f"similarity_mh != oracle or cpu at k={k}")
    print(f"  similarity_mh, {len(mixed)} sequences of 0-199 aa, k = 1, 3, "
          "5, 8, n_hash=64: equal to the oracle and to device='cpu'")

    # full width: the similarity of the clusterbreak configuration on h3n2
    k, n_hash = 4, 500
    n = len(h3n2_all)
    lens = np.array([len(s) for s in h3n2_all])
    p = int(lens.max()) - k + 1
    hashes = int(np.maximum(lens - k + 1, 0).sum()) * n_hash
    torch.cuda.reset_peak_memory_stats()
    walls, sims = _best_of(lambda: similarity_mh(h3n2_all, k, n_hash))
    peak = torch.cuda.max_memory_allocated()
    if sims.shape != (n, n) or not (sims == sims.T).all() or not (
        np.diag(sims) == 1.0).all() or sims.min() < 0 or sims.max() > 1:
        raise AssertionError("similarity_mh on h3n2sample: bad matrix")
    pick = np.r_[0:24, n - 24 : n]
    if not np.array_equal(sims[np.ix_(pick, pick)], oracle.minhash_similarity(
            [h3n2_all[i] for i in pick], k, n_hash, 0)):
        raise AssertionError("similarity_mh != oracle on h3n2sample block")
    refs["mh h3n2"] = _digest(sims)
    best = min(walls)
    print(f"  similarity_mh, all {n} h3n2sample proteins, k={k} n_hash="
          f"{n_hash} ({hashes:.4e} hashes of real windows, {n * p * n_hash:.4e}"
          f" with padding; {n * n * n_hash:.4e} slot compares): wall s "
          f"{walls}; best {best:.4f} s = {n / best:.1f} sequences/s, "
          f"{n * n / best:.4e} pairs/s; peak device memory {peak} bytes; "
          "equal to the oracle on the first and last 24 sequences")
    del sims
    stages, _ = stage_times({
        (api, "encode"): "encode",
        (api, "minhash_signatures"): "signatures",
        (minhash, "signature_agreement_counts"): "agreement",
        (minhash, "fetch_counts"): "fetch",
        (minhash, "counts_to_similarity"): "divide and fill",
    }, lambda: similarity_mh(h3n2_all, k, n_hash).shape)
    print("  step by step, s (its own functions timed in place), "
          + _stage_text(stages))

    enc = encode(h3n2_all, validate=False)
    tok = torch.from_numpy(enc.ascii).to(dev)
    ln = torch.from_numpy(enc.lengths).to(dev)
    sig_ms, sigs = _event_ms(lambda: minhash.minhash_signatures(
        tok, ln, k=k, n_hash=n_hash), repeat=2)
    agree_ms, _ = _event_ms(
        lambda: minhash.signature_agreement_counts(sigs), repeat=2)
    ops = _ops_per_hash(k)
    sig_ops_ms = hashes * ops / ALU_OPS_PER_S * 1e3
    sig_bytes_ms = (tok.numel() + 4 * n + 4 * n * n_hash) / HBM_BYTES_PER_S
    sig_bound = max(sig_ops_ms, sig_bytes_ms * 1e3)
    a_bound, a_by, a_ops_ms, a_bytes_ms = _pair_ops_bound(
        n, n, n_hash, 4 * n * n)
    moved = 2.0 * n * n * n_hash + 4.0 * n * n  # the booleans, out and back
    print(f"  signatures alone (CUDA events): {sig_ms:.3f} ms; bound "
          f"{sig_bound:.3f} ms by operations ({ops} integer operations per "
          f"hash at {ALU_OPS_PER_S:.4e}/s; bytes {sig_bytes_ms * 1e3:.4f} "
          f"ms) = {sig_bound / sig_ms:.4f} of the bound; "
          f"{n / sig_ms * 1e3:.1f} sequences/s, {hashes / sig_ms * 1e3:.4e}"
          " hashes/s")
    print(f"  agreement alone (CUDA events): {agree_ms:.3f} ms; bound "
          f"{a_bound:.3f} ms by {a_by} (operations {a_ops_ms:.3f} ms, bytes "
          f"{a_bytes_ms:.4f} ms) = {a_bound / agree_ms:.4f} of the bound; "
          f"the [block, N, H] booleans it writes and reads back, {moved:.4e} "
          f"bytes, take {moved / HBM_BYTES_PER_S * 1e3:.3f} ms at the HBM "
          f"rate = {moved / HBM_BYTES_PER_S * 1e3 / agree_ms:.4f} of its "
          f"time; {n * n / agree_ms * 1e3:.4e} pairs/s")
    return {"signatures": (sig_ms, sig_bound), "agreement": (agree_ms, a_bound)}


def phase_topk(dev, allunique, refs):
    """[12] The top-k graph: tie order, and allunique at full size (its
    lists' digest into ``refs``)."""
    from dynaalign_torch import oracle
    from dynaalign_torch.encode import encode
    from dynaalign_torch.ops import minhash
    from dynaalign_torch.ops.topk_graph import minhash_topk

    print("[12] top-k graph")
    tsigs = np.random.default_rng(7).integers(0, 3, size=(96, 8)).astype(
        np.uint32)
    want_c, want_i = _stable_topk(tsigs, np.arange(96), 7)
    for where in (None, "cpu"):
        vals, idx = minhash_topk(tsigs, k=7, block=32, device=where)
        if not np.array_equal(idx, want_i) or not np.array_equal(
                vals, np.maximum(want_c, 0) / 8.0):
            raise AssertionError(f"tie canary failed on {where or 'the card'}")
    print("  tie canary (96 x 8 signatures over {0, 1, 2}, k=7, block=32): "
          "equal to a stable host sort, on the card and on the CPU")

    n, k, n_hash, top_k = len(allunique), 4, 50, 64
    enc = encode(allunique, validate=False)
    sig_walls, sigs = _best_of(lambda: minhash.minhash_signatures(
        enc.ascii, enc.lengths, k=k, n_hash=n_hash))
    sigs_np = minhash.signatures_to_numpy(sigs)
    if not np.array_equal(sigs_np[:2000], oracle.minhash_signatures(
            allunique[:2000], k, n_hash, 0)):
        raise AssertionError("allunique signatures != oracle on [:2000]")
    torch.cuda.reset_peak_memory_stats()
    walls, (vals, idx) = _best_of(lambda: minhash_topk(sigs, k=top_k),
                                  repeat=2)
    peak = torch.cuda.max_memory_allocated()
    if vals.shape != (n, top_k) or idx.dtype != np.int32 or (
            idx == np.arange(n)[:, None]).any():
        raise AssertionError("minhash_topk on allunique: bad lists")
    rows = np.r_[0:256, n - 256 : n]
    want_c, want_i = _stable_topk(sigs_np, rows, top_k)
    if not np.array_equal(idx[rows], want_i) or not np.array_equal(
            vals[rows], want_c / float(n_hash)):
        raise AssertionError("minhash_topk != stable host sort on allunique")
    refs["topk allunique"] = _digest(vals, idx)
    best = min(walls)
    bound, by, ops_ms, bytes_ms = _pair_ops_bound(n, n, n_hash, 12 * n * top_k)
    print(f"  allunique, {n} 12-mers, k={k} n_hash={n_hash}: signatures wall "
          f"s {sig_walls} (best {n / min(sig_walls):.1f} sequences/s), equal "
          f"to the oracle on [:2000]; minhash_topk top_k={top_k} wall s "
          f"{walls}; best {best:.4f} s = {n * n / best:.4e} pairs/s; bound "
          f"{bound:.3f} ms by {by} (operations {ops_ms:.3f} ms, bytes "
          f"{bytes_ms:.4f} ms) = {bound / best / 1e3:.4f} of the bound; peak "
          f"device memory {peak} bytes; rows [:256] and [-256:] equal to a "
          "stable host sort of host-computed counts")
    return {"top-k": (best * 1e3, bound)}


def _check_hybrid(out, mh, nw, quantile=0.8, threshold=None):
    """A dense hybrid matrix holds ``nw`` where the MH similarity reaches
    its threshold, 0 elsewhere and a unit diagonal; returns (threshold,
    kept pairs)."""
    n = len(mh)
    iu = np.triu_indices(n, k=1)
    t = np.quantile(mh[iu], quantile) if threshold is None else threshold
    want = np.where(mh >= t, nw, 0.0)
    np.fill_diagonal(want, 1.0)
    if not np.array_equal(out, want):
        raise AssertionError("similarity_hybrid != NW on the kept pairs, 0 "
                             "elsewhere")
    return float(t), int((mh[iu] >= t).sum())


def phase_hybrid(h3n2, sims, long, lsims, herv):
    """[13] The hybrid pipelines on both NW kernels, and herv at full
    size."""
    from dynaalign_torch import (
        oracle, similarity_hybrid, similarity_hybrid_sparse, similarity_mh,
    )
    from dynaalign_torch.models import pipeline
    from dynaalign_torch.ops import nw_cuda

    print("[13] hybrid: MinHash prefilter, exact NW rescoring")
    n = len(h3n2)
    mh = similarity_mh(h3n2)
    if not np.array_equal(mh, oracle.minhash_similarity(h3n2, 4, 50, 0)):
        raise AssertionError("similarity_mh != oracle on h3n2sample[:1000]")
    nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
    walls, dense = _best_of(lambda: similarity_hybrid(h3n2), repeat=2)
    launches = (nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL)
    if launches[0] == 0 or launches[1]:
        raise AssertionError(f"hybrid launches {launches}: not nw_gotoh alone")
    t, kept = _check_hybrid(dense, mh, sims)
    print(f"  similarity_hybrid, h3n2sample[:1000]: threshold {t} keeps "
          f"{kept} of {n * (n - 1) // 2} pairs; LAUNCHES rose by "
          f"{launches[0] // 2} a call, LAUNCHES_XL by 0; kept entries equal "
          f"to similarity_nw's, the rest 0, diagonal 1; wall s {walls}")
    if t <= 0:
        raise AssertionError("the sparse path drops pairs at MH 0: needs a "
                             "positive threshold to compare")
    dense_t = similarity_hybrid(h3n2, prefilter_threshold=t)
    _check_hybrid(dense_t, mh, sims, threshold=t)
    timings = {}
    sp = similarity_hybrid_sparse(h3n2, top_k=n - 1, prefilter_threshold=t,
                                  timings=timings)
    if not np.array_equal(sp.toarray(), dense_t):
        raise AssertionError("similarity_hybrid_sparse != dense at top_k=N-1")
    print(f"  similarity_hybrid_sparse, top_k={n - 1}, prefilter_threshold="
          f"{t}: equal to the dense result elementwise; timings {timings}")

    nl = len(long)
    lmh = similarity_mh(long)
    nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
    ldense = similarity_hybrid(long)
    launches = (nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL)
    if launches[1] == 0 or launches[0]:
        raise AssertionError(f"hybrid launches {launches} on the long set: "
                             "not nw_gotoh_xl alone")
    t, kept = _check_hybrid(ldense, lmh, lsims)
    print(f"  similarity_hybrid, long set: threshold {t} keeps {kept} of "
          f"{nl * (nl - 1) // 2} pairs; LAUNCHES_XL rose by {launches[1]}, "
          "LAUNCHES by 0; kept entries equal to similarity_nw's")

    # the viral-panel configuration at full size
    nh = len(herv)
    walls, hdense = _best_of(lambda: similarity_hybrid(herv), repeat=2)
    hpairs = (np.count_nonzero(hdense) - nh) // 2
    if not (hdense == hdense.T).all() or not (np.diag(hdense) == 1.0).all():
        raise AssertionError("herv hybrid: not symmetric with unit diagonal")
    hmh = similarity_mh(herv)
    iu = np.triu_indices(nh, k=1)
    t = np.quantile(hmh[iu], 0.8)
    keep = np.nonzero(hmh[iu] >= t)[0]
    for p in np.random.default_rng(13).choice(keep, size=256, replace=False):
        i, j = iu[0][p], iu[1][p]
        if hdense[i, j] != oracle.nw_pair(herv[i], herv[j]):
            raise AssertionError(f"herv hybrid != oracle on pair ({i}, {j})")
    if np.count_nonzero(hdense[iu][hmh[iu] < t]):
        raise AssertionError("herv hybrid: an entry under the threshold")
    del hmh
    stages, _ = stage_times({
        (pipeline, "similarity_mh"): "MH",
        (pipeline, "_select_pairs"): "quantile and pair selection",
        (pipeline, "nw_rescore_pairs"): "rescore",
        (pipeline, "_fill_pairs"): "fill",
    }, lambda: similarity_hybrid(herv).shape)
    print(f"  similarity_hybrid, all {nh} herv 12-mers: threshold {t} keeps "
          f"{len(keep)} of {len(iu[0])} pairs ({hpairs} of them score above "
          f"0); a 256-pair sample equal to the oracle; wall s {walls}; step "
          "by step, s, " + _stage_text(stages))


def phase_clustering(evp_all, allunique, refs):
    """[14] clusterbreak, the large-set paths and the Louvain passes; the
    digest of cluster_large's membership goes into ``refs``."""
    import importlib

    from dynaalign_torch import (
        cluster_large, cluster_large_exact, clusterbreak,
    )

    louvain_mod = importlib.import_module("dynaalign_torch.cluster.louvain")

    print("[14] clustering")
    t0 = time.perf_counter()
    got = clusterbreak(evp_all, verbose=False)
    card_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = clusterbreak(evp_all, verbose=False, device="cpu")
    cpu_s = time.perf_counter() - t0
    if not np.array_equal(got.clustered_seq, ref.clustered_seq) or (
        got.filtered_seq != ref.filtered_seq or got.n_calls != ref.n_calls
    ) or not got.converged:
        raise AssertionError("clusterbreak: card != cpu on evp_peparray")
    print(f"  clusterbreak, all {len(evp_all)} evp_peparray 12-mers, default "
          f"engine: {got.n_calls} calls, {len(got.clustered_seq)} clustered, "
          f"{len(got.filtered_seq)} filtered; card {card_s:.3f} s, "
          f"device='cpu' {cpu_s:.3f} s; equal")

    n = len(allunique)
    for fn in (cluster_large, cluster_large_exact):  # the last mem is kept
        timings = {}
        t0 = time.perf_counter()
        mem = fn(allunique, timings=timings)
        wall = time.perf_counter() - t0
        if mem.shape != (n,) or mem.min() != 1:
            raise AssertionError(f"{fn.__name__}: bad membership")
        refs[f"{fn.__name__} allunique"] = _digest(mem)
        print(f"  {fn.__name__}, all {n} allunique 12-mers: "
              f"{len(np.unique(mem))} clusters, wall {wall:.3f} s "
              f"({n / wall:.1f} sequences/s), timings {timings}")

    small = allunique[:4096]
    real = louvain_mod._greedy_pass
    native = [fn(small) for fn in (cluster_large, cluster_large_exact)]
    try:
        louvain_mod._greedy_pass = louvain_mod._numpy_pass
        plain = [fn(small) for fn in (cluster_large, cluster_large_exact)]
    finally:
        louvain_mod._greedy_pass = real
    if not all(np.array_equal(a, b) for a, b in zip(native, plain)):
        raise AssertionError("Louvain: native pass != numpy pass")
    print("  allunique[:4096], cluster_large and cluster_large_exact: "
          "membership equal between Louvain's native pass and its numpy "
          "pass")
    return mem  # cluster_large_exact's on all of allunique

# sha256 of the files the JAX package's CLI writes for BASELINE config 3,
# pinned from its run on the CPU:
#   JAX_PLATFORMS=cpu python -m dynaalign_tpu pipeline --input h3n2sample \
#       --engine mh --k 4 --n-hash 500 --size-max 800 --thresh-p 0.8 \
#       --output-dir c3
# (6,046 clustered into 103 clusters, 2,057 filtered; the port's own
# `--device cpu` run of the same command writes the same two files)
C3_DIGESTS = {
    "clusters.csv":
        "1d26f37e08d2ae6f0479c50a18a87d30c1f313e3aac621112dfc9daaad04c934",
    "consensus.csv":
        "7f257ea80f3fa56779ca9ee60b167f6fe9091bafd9140c840578e92e24babaec",
}
C3_COUNTS = {"consensus rows": 103, "filtered": 2057, "converged": True}
# likewise from `python -m dynaalign_tpu pipeline --engine nw --input
# evp_peparray --size-max 30 --output-dir evp`
EVP_NW_DIGESTS = {
    "clusters.csv":
        "437bf1a79fe7b9ba516defa6791f6fcf4b57a4274be88d5001693813f7219461",
    "consensus.csv":
        "177da6e4ab783515d351ef2a4a8ed0cedbb63deb05100b96b7c0a3075dd2bc6d",
}
# what the JAX package's `datasets` subcommand prints
DATASETS_OUT = """\
adenovirus: 4207 rows (sequences in PROBE_SEQUENCE)
allunique: 65339 rows (sequences in peptides)
evp_peparray: 641 rows (sequences in PROBE_SEQUENCE)
h3n2ha1415: 11517 rows (sequences in sequence)
h3n2sample: 8103 rows (sequences in sequence)
herv: 5701 rows (sequences in PROBE_SEQUENCE)
mitochondria: 383 rows (sequences in PROBE_SEQUENCE)
parvovirus: 752 rows (sequences in PROBE_SEQUENCE)
polyomavirus: 663 rows (sequences in PROBE_SEQUENCE)
"""
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


def _sha256(path: str) -> str:
    import hashlib

    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _check_digests(out_dir: str, want: dict[str, str], what: str) -> None:
    for name, digest in want.items():
        got = _sha256(os.path.join(out_dir, name))
        if got != digest:
            raise AssertionError(f"{what}: {name} sha256 {got} != {digest}")


def _cli(*argv) -> tuple[float, str]:
    """(wall seconds, stdout) of ``python -m dynaalign_torch *argv`` from
    the repository root on the default device; a failure raises."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "-m", "dynaalign_torch", *argv],
                         cwd=ROOT, check=True, capture_output=True,
                         text=True).stdout
    wall = time.perf_counter() - t0
    print(f"  $ python -m dynaalign_torch {' '.join(argv)}: {wall:.3f} s")
    for line in out.splitlines():
        print(f"    {line}")
    return wall, out


def _built_files() -> dict[str, float]:
    """Every built library under build/ and its modification time."""
    out = {}
    for sub in ("kernels", "oracle", "louvain", "msadp"):
        d = os.path.join(ROOT, "build", sub)
        for f in sorted(os.listdir(d)):
            out[f"{sub}/{f}"] = os.path.getmtime(os.path.join(d, f))
    return out


def phase_pipeline(h3n2_all, sims, long, lsims, exact_mem):
    """[15] BASELINE config 3 in process through Pipeline, the MSA's
    native row DP against its plain version, and the CLI as a user runs
    it, each output held to one that already stands."""
    import importlib
    import shutil

    from dynaalign_torch import Pipeline, cluster_consensus, cli
    from dynaalign_torch.analysis import compute_similarity_stats
    from dynaalign_torch.config import (
        ClusterBreakConfig, MinHashConfig, PipelineConfig,
    )
    from dynaalign_torch.consensus import msa
    from dynaalign_torch.io.seqio import write_fasta
    from dynaalign_torch.models import pipeline as pmod
    from dynaalign_torch.utils.profiling import Timings

    cb_mod = importlib.import_module("dynaalign_torch.cluster.clusterbreak")

    print("[15] pipeline and CLI")
    shutil.rmtree(WORK, ignore_errors=True)
    os.makedirs(WORK)
    n = len(h3n2_all)
    pipe = Pipeline(PipelineConfig(
        similarity="mh", minhash=MinHashConfig(k=4, n_hash=500, seed=0),
        clusterbreak=ClusterBreakConfig(thresh_p=0.8, size_max=800,
                                        size_min=3)))
    t = Timings()
    with t.section("cluster", items=n):
        c_stages, clusters = stage_times({
            (pmod, "similarity_mh"): "similarity_mh",
            (cb_mod, "quantile_threshold"): "quantile threshold",
            (cb_mod, "netcluster"): "netcluster (Louvain)",
        }, lambda: pipe.cluster(h3n2_all))
    with t.section("consensus", items=len(clusters.clustered_seq)):
        n_stages, consensus = stage_times({
            (msa, "_kmer_distance"): "k-mer distance",
            (msa, "_upgma_order"): "UPGMA",
            (msa, "_profile_scores"): "profile scores (BLAS)",
            (msa, "_row_dp"): "row DP (native)",
            (msa, "_traceback_path"): "traceback",
        }, lambda: pipe.consensus(clusters))
    c3_dir = os.path.join(WORK, "c3")
    os.makedirs(c3_dir)
    cli._write_clusters_csv(os.path.join(c3_dir, "clusters.csv"),
                            clusters.clustered_seq, clusters.filtered_seq)
    cli._write_consensus_csv(os.path.join(c3_dir, "consensus.csv"),
                             consensus)
    counts = {"consensus rows": len(consensus),
              "filtered": len(clusters.filtered_seq),
              "converged": clusters.converged}
    print(f"  BASELINE config 3 (clusterbreak size_max=800 thresh_p=0.8 + "
          f"consensus, MH k=4 n_hash=500), all {n} h3n2sample rows with "
          f"duplicates: {clusters.n_calls} calls, "
          f"{len(clusters.clustered_seq)} clustered into {len(consensus)} "
          f"clusters, {len(clusters.filtered_seq)} filtered, converged="
          f"{clusters.converged}; cluster {t.total('cluster'):.3f} s, "
          f"consensus {t.total('consensus'):.3f} s, together "
          f"{t.total('cluster') + t.total('consensus'):.3f} s = "
          f"{n / (t.total('cluster') + t.total('consensus')):.1f} "
          "sequences/s")
    print("  cluster step by step, s, " + _stage_text(c_stages))
    print("  consensus step by step, s, " + _stage_text(n_stages))
    if counts != C3_COUNTS:
        raise AssertionError(f"config 3 counts {counts} != {C3_COUNTS}")
    _check_digests(c3_dir, C3_DIGESTS, "config 3")
    print("  clusters.csv and consensus.csv equal to the JAX package's "
          "(sha256); counts equal to its record (103 / 2,057 / converged)")

    # the native row DP against its plain version on the largest clusters
    cl = clusters.clustered_seq
    ids, sizes = np.unique(cl[:, 1], return_counts=True)
    top = ids[np.argsort(-sizes, kind="stable")[:3]]
    want = [row for row in consensus.tolist() if row[0] in set(top)]
    real = msa._row_dp
    msa._row_dp = msa._numpy_row_dp
    try:
        t0 = time.perf_counter()
        plain = cluster_consensus(cl[np.isin(cl[:, 1], top)])
        plain_s = time.perf_counter() - t0
    finally:
        msa._row_dp = real
    if plain.tolist() != want:
        raise AssertionError("MSA: native row DP != numpy row DP")
    print(f"  the three largest config-3 clusters ({sorted(sizes.tolist())[-3:]} "
          f"rows): consensus with the numpy row DP swapped in "
          f"({plain_s:.3f} s) equal to the native one's")

    # the CLI, as a user runs it, on the card
    clis = {}
    long_fa = os.path.join(WORK, "long.fasta")
    write_fasta(long_fa, [f"long{i}" for i in range(len(long))], long)
    out = os.path.join(WORK, "long.npz")
    clis["similarity nw, long set"], _ = _cli(
        "similarity", "--engine", "nw", "--input", long_fa, "--output", out)
    with np.load(out) as z:
        if not np.array_equal(z["similarity"], lsims):
            raise AssertionError("CLI similarity on the long set != phase 7")
    out = os.path.join(WORK, "h3n2.npz")
    clis["similarity nw, h3n2sample[:1000]"], _ = _cli(
        "similarity", "--engine", "nw", "--input", "h3n2sample", "--limit",
        "1000", "--output", out)
    with np.load(out) as z:
        if not np.array_equal(z["similarity"], sims):
            raise AssertionError("CLI similarity on h3n2[:1000] != phase 5")
    print("  both similarity runs equal to phases 7 and 5")
    evp_dir = os.path.join(WORK, "evp")
    clis["pipeline nw, evp_peparray"], _ = _cli(
        "pipeline", "--engine", "nw", "--input", "evp_peparray",
        "--size-max", "30", "--output-dir", evp_dir)
    _check_digests(evp_dir, EVP_NW_DIGESTS, "evp_peparray nw pipeline")
    print("  pipeline files equal to the JAX package's (sha256)")
    out = os.path.join(WORK, "allunique.csv")
    clis["cluster hybrid-sparse, allunique"], _ = _cli(
        "cluster", "--engine", "hybrid-sparse", "--input", "allunique",
        "--output", out)
    with open(out) as f:
        got = [row["cluster"] for row in csv.DictReader(f)]
    if got != [str(int(c)) for c in exact_mem]:
        raise AssertionError("CLI hybrid-sparse != phase 14's "
                             "cluster_large_exact")
    print("  memberships equal to phase 14's cluster_large_exact")
    out = os.path.join(WORK, "consensus.csv")
    clis["consensus, evp_peparray clusters"], _ = _cli(
        "consensus", "--clusters", os.path.join(evp_dir, "clusters.csv"),
        "--output", out)
    if _sha256(out) != EVP_NW_DIGESTS["consensus.csv"]:
        raise AssertionError("CLI consensus != the evp pipeline's "
                             "consensus.csv")
    print("  consensus equal to the evp_peparray pipeline's consensus.csv")
    clis["stats"], text = _cli("stats", "--similarity",
                               os.path.join(WORK, "h3n2.npz"))
    if text != json.dumps(compute_similarity_stats(sims).as_dict(),
                          default=list, indent=2) + "\n":
        raise AssertionError("CLI stats != compute_similarity_stats")
    clis["datasets"], text = _cli("datasets")
    if text != DATASETS_OUT:
        raise AssertionError("CLI datasets != the JAX CLI's listing")
    before = _built_files()
    clis["warm mh,nw"], text = _cli("warm", "--input", "h3n2sample",
                                    "--engines", "mh,nw")
    warm = json.loads(text)
    if list(warm) != ["warmed", "n_seqs", "max_len", "stage_seconds",
                      "total_seconds"] or warm["warmed"] != ["mh", "nw"] or (
            warm["n_seqs"] != 128
            or warm["max_len"] != max(len(s) for s in h3n2_all)):
        raise AssertionError(f"CLI warm printed {warm}")
    if _built_files() != before:
        raise AssertionError("warm built something: the kernels and "
                             "libraries were not all in place")
    print(f"  stats, datasets and warm as the JAX CLI prints them; warm "
          f"found all {len(before)} built libraries in place")
    print("  CLI wall s: " + ", ".join(f"{k} {v:.3f}"
                                       for k, v in clis.items()))
    return t


def _digest(*arrays) -> str:
    """sha256 over each array's dtype, shape and bytes: equal digests are
    equal arrays, byte for byte."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        a = np.ascontiguousarray(a)
        h.update(f"{a.dtype.str}{a.shape}".encode())
        h.update(a.tobytes())
    return h.hexdigest()


# seconds each world of phase 16 may take, start-up included
PARALLEL_TIMEOUT = {"nccl": 240, "gloo": 180}


def _run_ranks(cmds, timeout: float) -> list[str]:
    """Run the commands (one per rank) together; returns their outputs.
    A rank that exits non-zero, or a world that outlives ``timeout``
    seconds, raises, after every process of every rank is killed."""
    import signal

    procs = [subprocess.Popen(c, cwd=ROOT, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True,
                              start_new_session=True) for c in cmds]
    deadline = time.monotonic() + timeout
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(
                timeout=max(deadline - time.monotonic(), 1))[0])
    except subprocess.TimeoutExpired:
        raise AssertionError(f"phase 16: a world hung past {timeout} s")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.communicate()
    for r, (p, out) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise AssertionError(f"phase 16: rank {r} exited "
                                 f"{p.returncode}:\n{out[-4000:]}")
    return outs


def parallel_worker(mode: str, out_dir: str, store=None, rank=None) -> int:
    """One rank of phase 16.  ``nccl``: under torchrun, distributed_init()
    from its environment (NCCL, the card LOCAL_RANK), the sharded
    functions at full size.  ``gloo``: rank ``rank`` of 2 through a file:// store, gloo, both
    ranks computing on cuda:0.  Writes each result's digest, the launches
    of each NW kernel, wall and gather seconds and the pairs launched to
    ``out_dir/rank<r>.json``."""
    import torch.distributed as dist

    from dynaalign_torch import blosum, cluster_large
    from dynaalign_torch.encode import encode
    from dynaalign_torch.io.datasets import load_sequences
    from dynaalign_torch.ops import minhash, nw_cuda
    from dynaalign_torch.parallel import (
        allpairs as ap, distributed_init, make_mesh,
        sharded_minhash_similarity, sharded_minhash_topk,
        sharded_nw_allpairs, sharded_nw_allpairs_bucketed,
    )
    from dynaalign_torch.parallel.failures import clean_abort

    if not torch.cuda.is_available():
        print("chip_smoke worker: no CUDA device", file=sys.stderr)
        return 2
    with clean_abort():
        if mode == "nccl":
            distributed_init()
            mesh = make_mesh()
        else:
            distributed_init(f"file://{store}", 2, int(rank), device="cpu")
            mesh = make_mesh(device="cuda:0")
        me, ndev = mesh.rank, mesh.size
        backend = dist.get_backend(mesh.group)
        if mesh.device.type != "cuda" or backend != mode:
            raise AssertionError(f"rank {me}: {backend} on {mesh.device}")
        seen = {"wait": 0.0, "gather": 0.0, "pairs": 0}
        real_sum, real_launch = ap._sum_shares, ap._launch_into

        def timed_sum(m, full):
            # the wait for the slowest rank, then the sum and the copy out
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            dist.barrier(group=m.group)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            out = real_sum(m, full)
            torch.cuda.synchronize()
            seen["wait"] += t1 - t0
            seen["gather"] += time.perf_counter() - t1
            return out

        def counted_launch(full, p, *args):
            seen["pairs"] += len(p)
            return real_launch(full, p, *args)

        ap._sum_shares, ap._launch_into = timed_sum, counted_launch
        report = {"rank": me, "world": ndev, "backend": backend,
                  "results": {}, "launches": {}, "lines": []}

        def run(name, fn):
            # twice: the first call of a fresh process loads the kernels;
            # the second call's gather, launches and pairs are reported
            walls, digests = [], set()
            for _ in range(2):
                seen.update(wait=0.0, gather=0.0, pairs=0)
                nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
                dist.barrier(group=mesh.group)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
                digests.add(_digest(
                    *(out if isinstance(out, tuple) else (out,))))
            if len(digests) != 1:
                raise AssertionError(f"rank {me}: {name} differs between "
                                     "two calls")
            report["results"][name] = digests.pop()
            launches = (nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL)
            report["launches"][name] = launches
            wall = walls[1]
            report["lines"].append(
                f"rank {me}/{ndev} {backend} {name}: wall {walls[0]:.4f} s, "
                f"again {wall:.4f} s; gather {seen['gather']:.4f} s "
                f"({seen['gather'] / wall:.4f} of the wall) after waiting "
                f"{seen['wait']:.4f} s for the other ranks; nw_gotoh "
                f"launches {launches[0]}, nw_gotoh_xl {launches[1]}; "
                f"{seen['pairs']} NW pairs launched here")

        sub = blosum.get_matrix().numpy()
        h3n2 = load_sequences("h3n2sample", limit=1000)
        enc = encode(h3n2)
        report["lines"].append(
            f"plan, h3n2sample[:1000] at tile 16: "
            f"{ap.nw_allpairs_schedule_stats(len(h3n2), 16, ndev)}")
        run("nw h3n2", lambda: sharded_nw_allpairs(
            enc.indices, enc.lengths, sub, mesh=mesh))
        allunique = load_sequences("allunique")
        if mode == "nccl":
            long = long_set()
            lenc = encode(long)
            report["lines"].append(
                f"plan, long set at tile 16: "
                f"{ap.nw_allpairs_schedule_stats(len(long), 16, ndev)}")
            run("nw long", lambda: sharded_nw_allpairs(
                lenc.indices, lenc.lengths, sub, mesh=mesh))
            mixed = mixed_set()
            report["lines"].append(
                "plan, mixed set: "
                f"{ap.bucketed_schedule_stats(mixed, ndev=ndev)}")
            run("bucketed mixed", lambda: sharded_nw_allpairs_bucketed(
                mixed, sub, mesh=mesh))
            menc = encode(load_sequences("h3n2sample"), validate=False)
            run("mh h3n2", lambda: sharded_minhash_similarity(
                menc.ascii, menc.lengths, k=4, n_hash=500, mesh=mesh))
            top_name, top_set = "topk allunique", allunique
        else:
            eenc = encode(load_sequences("evp_peparray"), validate=False)
            run("mh evp", lambda: sharded_minhash_similarity(
                eenc.ascii, eenc.lengths, k=2, n_hash=50, mesh=mesh))
            top_name, top_set = "topk allunique[:8192]", allunique[:8192]
        tenc = encode(top_set, validate=False)
        tsigs = minhash.signatures_to_numpy(minhash.minhash_signatures(
            tenc.ascii, tenc.lengths, k=4, n_hash=50, device=mesh.device))
        run(top_name, lambda: sharded_minhash_topk(tsigs, 64, mesh=mesh))
        if mode == "nccl":
            run("cluster_large allunique",
                lambda: cluster_large(allunique, mesh=mesh))
        with open(os.path.join(out_dir, f"rank{me}.json"), "w") as f:
            json.dump(report, f)
        for line in report["lines"]:
            print(line, flush=True)
        dist.destroy_process_group()
    return 0


def phase_parallel(refs, allunique) -> dict[str, list]:
    """[16] parallel/: (a) world size 1 on NCCL under torchrun, at full
    size; (b) 2 ranks on gloo, both on cuda:0.  Every rank's every result
    must equal the single-device result of an earlier phase byte for byte.
    Returns the NW launches of each run by kernel."""
    import shutil

    from dynaalign_torch.encode import encode
    from dynaalign_torch.ops import minhash
    from dynaalign_torch.ops.topk_graph import minhash_topk

    print("[16] parallel: the sharded functions, (a) world size 1 on NCCL "
          "(torchrun), (b) 2 ranks on gloo, both on cuda:0")
    work = os.path.join(WORK, "parallel")
    shutil.rmtree(work, ignore_errors=True)
    enc = encode(allunique[:8192], validate=False)
    refs["topk allunique[:8192]"] = _digest(*minhash_topk(
        minhash.minhash_signatures(enc.ascii, enc.lengths, k=4, n_hash=50),
        k=64))
    want = {
        "nccl": ["nw h3n2", "nw long", "bucketed mixed", "mh h3n2",
                 "topk allunique", "cluster_large allunique"],
        "gloo": ["nw h3n2", "mh evp", "topk allunique[:8192]"],
    }
    kernels = {"nw h3n2": (True, False), "nw long": (False, True),
               "bucketed mixed": (True, True)}
    launches = {"nw_gotoh": [], "nw_gotoh_xl": []}
    for mode, ranks in (("nccl", 1), ("gloo", 2)):
        out_dir = os.path.join(work, mode)
        os.makedirs(out_dir)
        me = [__file__, "--parallel-worker", mode, out_dir]
        if mode == "nccl":
            cmds = [[sys.executable, "-m", "torch.distributed.run",
                     "--standalone", "--nproc_per_node=1", *me]]
        else:
            cmds = [[sys.executable, *me, os.path.join(work, "store"),
                     str(r)] for r in range(ranks)]
        t0 = time.perf_counter()
        _run_ranks(cmds, PARALLEL_TIMEOUT[mode])
        print(f"  ({chr(97 + (mode == 'gloo'))}) {mode}, {ranks} rank(s): "
              f"{time.perf_counter() - t0:.3f} s, start-up included")
        for r in range(ranks):
            with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                report = json.load(f)
            for line in report["lines"]:
                print(f"    {line}")
            if sorted(report["results"]) != sorted(want[mode]):
                raise AssertionError(f"{mode} rank {r}: ran "
                                     f"{sorted(report['results'])}")
            for name, digest in report["results"].items():
                if digest != refs[name]:
                    raise AssertionError(f"{mode} rank {r}: {name} != the "
                                         "single-device result")
                if name in kernels:
                    got = report["launches"][name]
                    if [n > 0 for n in got] != list(kernels[name]):
                        raise AssertionError(f"{mode} rank {r}: {name} "
                                             f"launched {got}")
                    launches["nw_gotoh"].append([mode, r, name, got[0]])
                    launches["nw_gotoh_xl"].append([mode, r, name, got[1]])
        print(f"  {mode}: every result of every rank equal, byte for byte, "
              "to the single-device result of phases 5, 7, 8, 11, 12, 14 "
              "(top-k of allunique[:8192]: minhash_topk here)")
    return launches

# the regimes of tests/test_integration_real_data.py's correlation study:
# (dataset, limit, k, n_hash, median r above, every seed's r above)
CORRELATION_REGIMES = [
    ("h3n2sample", 30, 4, 200, 0.60, 0.50),
    ("evp_peparray", 120, 4, 200, 0.30, 0.20),
    ("evp_peparray", 120, 2, 50, 0.55, 0.45),
]
EXAMPLE = os.path.join(ROOT, "examples", "getting_started_torch.py")


def _ari(a, b) -> float:
    """Adjusted Rand index of two labelings."""
    a, b = np.asarray(a), np.asarray(b)
    _, ia = np.unique(a, return_inverse=True)
    _, ib = np.unique(b, return_inverse=True)
    ct = np.zeros((ia.max() + 1, ib.max() + 1), dtype=np.int64)
    np.add.at(ct, (ia, ib), 1)

    def comb(x):
        return x * (x - 1) / 2

    sum_ij = comb(ct).sum()
    sum_a = comb(ct.sum(1)).sum()
    sum_b = comb(ct.sum(0)).sum()
    exp = sum_a * sum_b / comb(len(a))
    mx = (sum_a + sum_b) / 2
    return (sum_ij - exp) / (mx - exp) if mx != exp else 1.0


def _pearson(mh, nw) -> float:
    """Pearson r of two similarity matrices over the strict upper
    triangle."""
    iu = np.triu_indices(len(mh), k=1)
    return float(np.corrcoef(mh[iu], nw[iu])[0, 1])


def _unclocked(text: str) -> list[str]:
    """Printed lines with clusterbreak's [HH:MM:SS] stamps taken out."""
    return [re.sub(r"^\[\d\d:\d\d:\d\d\] ", "[time] ", line)
            for line in text.splitlines()]


def _run_example(*argv) -> tuple[float, list[str]]:
    """(wall seconds, printed lines) of examples/getting_started_torch.py
    run from the repository root."""
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, EXAMPLE, *argv], cwd=ROOT,
                          capture_output=True, text=True, timeout=180)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{' '.join(argv)}: exit {proc.returncode}\n"
                             f"{proc.stderr[-4000:]}")
    return wall, _unclocked(proc.stdout)


def _goldens() -> None:
    """tests/test_golden.py's values, on the card."""
    from dynaalign_torch import oracle, similarity_mh, similarity_nw
    from dynaalign_torch.ops.murmur3 import murmur3_kmer_hashes, seeds_tensor
    from dynaalign_torch.utils import hash_family_seeds

    if hash_family_seeds(3, 0).tolist() != [2357136044, 2546248239,
                                            3071714933]:
        raise AssertionError("mt19937(0) golden")
    for key, seed, want in ((b"abcd", 0, 0x43ED676A),
                            (b"Hello, world!", 1234, 0xFAF6CDB3)):
        bits = murmur3_kmer_hashes(
            torch.tensor([list(key)], dtype=torch.uint8, device="cuda"),
            len(key), seeds_tensor(np.array([seed], np.uint32), "cuda"))
        if int(bits.cpu().numpy().view(np.uint32)[0, 0, 0]) != want:
            raise AssertionError(f"murmur3 golden {key!r} on the card")
    seqs = ["ARNDCQEG", "ARNDCQEG", "ARNDCEGQ", "WWWWYYYY"]
    mh = similarity_mh(seqs, k=2, n_hash=20, seed=42)
    if not (np.array_equal(mh[0], mh[1]) and mh[0, 1] == 1.0
            and 0.3 < mh[0, 2] < 1.0 and mh[0, 3] == 0.0
            and (mh * 20 == np.round(mh * 20)).all()
            and np.array_equal(mh, oracle.minhash_similarity(seqs, 2, 20,
                                                             42))):
        raise AssertionError(f"MinHash golden on the card: {mh}")
    nw = similarity_nw(["AAAA", "AAAA", "AAGA", "AAAAAA"])
    if not (nw[0, 1] == 1.0 and nw[0, 2] == 0.75
            and np.isclose(nw[0, 3], 4 / 6, rtol=1e-7, atol=0)):
        raise AssertionError(f"NW golden on the card: {nw}")
    if similarity_nw(["WAAAW", "WAW"])[0, 1] != oracle.nw_pair("WAAAW",
                                                               "WAW"):
        raise AssertionError("NW gap-asymmetry golden on the card")
    print("  goldens of tests/test_golden.py on the card: mt19937(0) seeds, "
          "murmur3 vectors (tensor hash), MinHash (k=2, n_hash=20, seed "
          f"42: {mh[0].tolist()}), NW (1.0, 0.75, 4/6) and the gap "
          "asymmetry: held")


def phase_studies(h3n2, sims, evp_all, evp_nw) -> None:
    """[17] tests/test_integration_real_data.py's studies on the card at
    their sizes and thresholds, and tests/test_golden.py's values; the
    Pearson r of MH against exact NW at sizes only the card reaches
    (printed, not held); examples/getting_started_torch.py on the card and
    with --device cpu, their printed lines equal."""
    from dynaalign_torch import (
        cluster_consensus, clusterbreak, consensus_sequence, oracle,
        progressive_msa, similarity_mh, similarity_nw,
    )
    from dynaalign_torch.io.datasets import load_dataset, load_sequences
    from dynaalign_torch.ops import nw_cuda

    print("[17] acceptance studies on real data, goldens and the "
          "getting-started example")
    t_phase = time.perf_counter()
    _goldens()

    seqs = h3n2[:12]
    nw_cuda.LAUNCHES = 0
    got = similarity_nw(seqs)
    if nw_cuda.LAUNCHES == 0 or not np.array_equal(
            got, oracle.nw_similarity(seqs)):
        raise AssertionError("NW on h3n2sample[:12] != oracle")
    print(f"  similarity_nw, h3n2sample[:12]: {nw_cuda.LAUNCHES} nw_gotoh "
          "launch(es), bit-exact vs the oracle")
    seqs = evp_all[:200]
    if not np.array_equal(similarity_mh(seqs, k=2, n_hash=50, seed=0),
                          oracle.minhash_similarity(seqs, 2, 50, 0)):
        raise AssertionError("MH on evp_peparray[:200] != oracle")
    print("  similarity_mh, evp_peparray[:200], k=2 n_hash=50 seed 0: "
          "bit-exact vs the oracle")

    nw_h30 = None
    for dataset, limit, k, n_hash, r_med, r_min in CORRELATION_REGIMES:
        seqs = load_sequences(dataset, limit=limit)
        nw = oracle.nw_similarity(seqs)
        if not np.array_equal(similarity_nw(seqs), nw):
            raise AssertionError(f"NW on {dataset}[:{limit}] != oracle")
        rs = []
        for seed in range(10):
            mh = similarity_mh(seqs, k=k, n_hash=n_hash, seed=seed)
            if seed == 0 and not np.array_equal(
                    mh, oracle.minhash_similarity(seqs, k, n_hash, 0)):
                raise AssertionError(f"MH on {dataset}[:{limit}] != oracle")
            rs.append(_pearson(mh, nw))
        med, worst = float(np.median(rs)), min(rs)
        if not (med > r_med and worst > r_min):
            raise AssertionError(f"{dataset}[:{limit}] k={k} n_hash="
                                 f"{n_hash}: median r {med}, worst {worst}")
        print(f"  MH/NW correlation, {dataset}[:{limit}], k={k} n_hash="
              f"{n_hash}, seeds 0-9 (NW on the card == oracle, MH seed 0 "
              f"== oracle): median r {med:.4f} > {r_med}, worst "
              f"{worst:.4f} > {r_min}; r {[round(r, 4) for r in rs]}")
        if dataset == "h3n2sample":
            nw_h30 = nw

    seqs = load_sequences("h3n2sample", limit=30)
    n = len(seqs)
    mh = similarity_mh(seqs, k=4, n_hash=200, seed=0)
    iu = np.triu_indices(n, k=1)
    r_obs = _pearson(mh, nw_h30)
    rng = np.random.default_rng(0)
    hits = 0
    for _ in range(499):
        p = rng.permutation(n)
        hits += np.corrcoef(mh[np.ix_(p, p)][iu], nw_h30[iu])[0, 1] >= r_obs
    p_val = (hits + 1) / 500
    if p_val > 0.01:
        raise AssertionError(f"Mantel p-value {p_val} (r {r_obs})")
    print(f"  Mantel test, h3n2sample[:30], 499 joint permutations: r "
          f"{r_obs:.4f}, p {p_val:.4f} <= 0.01")

    seqs = load_sequences("h3n2sample", limit=24)
    same = cluster_consensus(np.array([(seqs[0], "1")] * 5, dtype=object))
    aligned = progressive_msa(seqs[:12])
    cons = consensus_sequence(aligned)
    cols = np.array([list(s) for s in aligned])
    agree = 0
    for c in range(cols.shape[1]):
        vals, counts = np.unique(cols[:, c], return_counts=True)
        maj = vals[np.argmax(counts)]
        agree += bool(cons[c] == maj or (
            cons[c] in "BZJX" and maj in "ARNDCQEGHILKMFPSTWYV"))
    frac = agree / cols.shape[1]
    if same[0, 1] != seqs[0] or cols.shape[1] <= 500 or frac < 0.95:
        raise AssertionError(f"consensus: {cols.shape[1]} columns, "
                             f"agreement {frac}")
    print(f"  consensus, h3n2sample[:12]: {agree} of {cols.shape[1]} "
          f"columns agree with the column majority ({frac:.4f} >= 0.95); "
          "a cluster of 5 identical rows gives the row")
    print("  Louvain against networkx: left out (networkx is no dependency "
          "of the port and the card's machine has none; Louvain is host "
          "code, held to networkx on the CPU by "
          "tests/test_torch_integration_real_data.py)")

    cols = load_dataset("h3n2sample")
    clades = np.asarray(cols["clade"])
    seqs_all = np.asarray(cols["sequence"])
    rng = np.random.default_rng(0)
    keep = []
    for clade in np.unique(clades):
        idx = np.nonzero(clades == clade)[0]
        keep.extend(rng.choice(idx, size=min(len(idx), 25), replace=False))
    keep = np.array(sorted(keep))
    seen = {}
    for s, lab in zip(seqs_all[keep], clades[keep]):
        seen.setdefault(str(s), lab)
    seqs = list(seen)
    labels = np.array([seen[s] for s in seqs])
    runs = {}
    for dev in ("cuda", "cpu"):
        runs[dev] = clusterbreak(
            seqs, thresh_p=0.8, size_max=len(seqs), size_min=1,
            sim_fn=lambda x, d=dev: similarity_mh(x, k=4, n_hash=300,
                                                  seed=0, device=d),
            verbose=False)
    got = runs["cuda"].clustered_seq
    if not np.array_equal(got, runs["cpu"].clustered_seq):
        raise AssertionError("clusterbreak on the clade sample: card != cpu")
    assign = dict(zip(got[:, 0], got[:, 1]))
    score = _ari([assign.get(s, "none") for s in seqs], labels)
    if score <= 0.3:
        raise AssertionError(f"ARI vs clades {score}")
    print(f"  clusterbreak on {len(seqs)} unique h3n2sample rows (up to 25 "
          f"of each of {len(np.unique(clades))} clades), MH k=4 n_hash=300: "
          f"{len(np.unique(got[:, 1]))} clusters, equal to device='cpu'; "
          f"ARI vs clades {score:.4f} > 0.3")

    for name, seqs, nw in (("h3n2sample[:1000]", h3n2, sims),
                           (f"all {len(evp_all)} evp_peparray 12-mers",
                            evp_all, evp_nw)):
        r = _pearson(similarity_mh(seqs, k=4, n_hash=200, seed=0), nw)
        print(f"  Pearson r of MH (k=4, n_hash=200, seed 0) against exact "
              f"NW (phase 5's matrix), {name}: {r:.6f} (printed, not held)")

    walls, lines = {}, {}
    for label, argv in (("card", ["--no-plots"]),
                        ("cpu", ["--no-plots", "--device", "cpu"])):
        walls[label], lines[label] = _run_example(*argv)
    # its flows alone: run() in this process, where everything is loaded
    spec = importlib.util.spec_from_file_location("getting_started_torch",
                                                  EXAMPLE)
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        t0 = time.perf_counter()
        example.run(plots=False)
        flows_s = time.perf_counter() - t0
    in_process = _unclocked(buf.getvalue())
    if not lines["card"] or not (lines["card"] == lines["cpu"]
                                 == in_process):
        raise AssertionError(f"example: card and CPU lines differ\n"
                             f"{lines['card']}\n{lines['cpu']}")
    print(f"  python {os.path.relpath(EXAMPLE, ROOT)} --no-plots (limit "
          f"300): on the card {walls['card']:.3f} s, with --device cpu "
          f"{walls['cpu']:.3f} s (wall, start-up included); run() on the "
          f"card in this process {flows_s:.3f} s; the "
          f"{len(lines['card'])} printed lines equal:")
    for line in lines["card"]:
        print(f"    {line}")
    print(f"  phase 17: {time.perf_counter() - t_phase:.1f} s")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing was run", file=sys.stderr)
        return 2
    from dynaalign_torch import (
        api, blosum, nw_rescore_pairs, oracle, similarity_nw,
        similarity_nw_bucketed,
    )
    from dynaalign_torch.encode import encode
    from dynaalign_torch.io.datasets import load_sequences
    from dynaalign_torch.ops import _build, nw_cuda
    from dynaalign_torch.ops.nw import nw_similarity_batch
    from dynaalign_torch.tools import probe_misalign as probe

    t_start = time.perf_counter()
    global OPS_PER_CELL, ALU_OPS_PER_CELL
    OPS_PER_CELL, ALU_OPS_PER_CELL = _ops_per_cell()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = _smi()
    print(f"[1] device: {kind}; torch {torch.__version__} cuda "
          f"{torch.version.cuda}")
    print(f"nvidia-smi name, power.limit: {smi}")

    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"[2] built {sorted(built)} in {time.perf_counter() - t0:.2f} s "
          "(one nvcc each, in parallel)")
    for name, b in built.items():
        for line in b.log.splitlines():
            if "ptxas" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    def xl_launch(batch):
        """nw_gotoh_xl's queue of strips on a batch (a_idx, a_len, b_idx,
        b_len) under BLOSUM62 and gaps (10, 4): the launch alone (work
        table, scratch and outputs built before; the zeroing of the counter
        and the kernel between the events), best of 4.  Returns (best ms,
        result)."""
        go, out = nw_cuda.prepare_xl(_build.load("nw_gotoh_xl"), *batch,
                                     blosum.get_matrix(device=dev), 10, 4)
        return _best_ms(go)[0], out
    from dynaalign_torch.cluster import _native as louvain_native
    from dynaalign_torch.consensus import _native as msa_native

    t0 = time.perf_counter()
    oracle._lib()
    louvain_native._lib()
    msa_native._lib()
    print(f"  built the C++ oracle, the Louvain pass and the MSA row DP "
          f"(g++) in {time.perf_counter() - t0:.2f} s")
    cuobjdump = os.path.join(os.path.dirname(_build.nvcc_path()), "cuobjdump")
    g_main, r_main = nw_cuda.INSTANCES[-1]
    for name, fn, rows in (
        ("nw_gotoh", f"nw_gotoh_kernelILi{g_main}ELi{r_main}E", r_main),
        ("nw_gotoh_xl", "nw_gotoh_xl_kernelILi1E", nw_cuda.XL_STRIP // 32),
        ("nw_gotoh_xl", "nw_gotoh_xl_kernelILi2E", nw_cuda.XL_STRIP // 32),
    ):
        sass = subprocess.run([cuobjdump, "-sass", built[name].path],
                              capture_output=True, text=True,
                              check=True).stdout
        n_ins, mix = inner_loop_mix(sass, fn)
        # the steady step loop works one column of the lane's rows
        dpx = {op: mix.get(op, 0) for op in DPX_OPCODES}
        print(f"  {fn} step loop: {n_ins} SASS instructions for {rows} "
              f"cells = {n_ins / rows:.1f} per cell; DPX and dp4a opcodes "
              f"in it: {dpx}; mix "
              f"{sorted(mix.items(), key=lambda kv: -kv[1])}")

    print("[3] nw_gotoh vs plain version on the card, every instantiation "
          f"{nw_cuda.INSTANCES}")
    worst = kernel_vs_plain(dev, nw_cuda.nw_similarity_batch_cuda, [
        *instance_cases(nw_cuda.INSTANCES),
        *_fuzz_cases(100, 2048),
        ("len 520-566", "BLOSUM62", (10, 4), (1, 1024, (520, 566),
                                              (520, 566), 566), 4),
        ("m != n: 1-80 x 400-566", "BLOSUM62", (10, 4),
         (2, 1024, (1, 80), (400, 566)), 2),
        ("m != n: 400-566 x 1-80", "BLOSUM62", (10, 4),
         (7, 1024, (400, 566), (1, 80)), 4),
        ("padded m+1 = 1120", "BLOSUM62", (10, 4),
         (3, 128, (1000, 1119), (1000, 1119), 1119), 4),
    ])

    # a table that is not symmetric: sub[a][b] is read, never sub[b][a]
    skew = blosum.get_matrix(device=dev).clone()
    skew[:24, :24] += torch.from_numpy(np.random.default_rng(470).integers(
        -3, 4, size=(24, 24), dtype=np.int32)).to(dev)
    for wrapper, a_range in ((nw_cuda.nw_similarity_batch_cuda, (1, 12)),
                             (nw_cuda.nw_similarity_batch_cuda, (500, 566)),
                             (nw_cuda.nw_similarity_batch_cuda_xl, (1, 700))):
        args = _random_batch(dev, 471, 256, a_range, (1, 300))
        got = wrapper(*args, skew)
        ref = nw_similarity_batch(*args, skew)
        if torch.equal(skew, skew.T) or not _equal(got, ref):
            raise AssertionError(f"{wrapper.__name__} != plain on a table "
                                 "that is not symmetric")
        print(f"  {wrapper.__name__} vs plain, asymmetric table, a "
              f"{a_range}: equal")

    print("[4] nw_gotoh_xl vs plain version on the card, both instantiations")
    strip = nw_cuda.XL_STRIP
    xl_cases = [
        *_fuzz_cases(200, 2048),
        ("len 1121-2000", "BLOSUM62", (10, 4),
         (4, 256, (1121, 2000), (1121, 2000))),
        ("m != n: 40-200 x 3000-5000", "BLOSUM80", (12, 2),
         (5, 64, (40, 200), (3000, 5000))),
        (f"a_len on and next to strip edges ({strip}, {2 * strip} rows)",
         "BLOSUM45", (5, 1),
         (6, 256, [0, 1, strip - 1, strip, strip + 1, 2 * strip - 1,
                   2 * strip, 2 * strip + 1], (0, 1121), 2 * strip + 1,
          1121)),
        ("tie-heavy over one to three strips", "BLOSUM45", (5, 1),
         (8, 64, (1, 2 * strip + 100), (1, 300),
          {"alphabets": ("AAG", "AGG")})),
    ]
    worst_xl = kernel_vs_plain(dev, nw_cuda.nw_similarity_batch_cuda_xl,
                               xl_cases)
    # MT and LN as two words: the launcher takes that instantiation from
    # padded M + N = 65,536 on, where the plain version would walk 65,536
    # diagonals; asked for by name, it runs the same batches here (phase 9
    # runs it at its real widths, against the oracle)
    def nw_gotoh_xl_two_words(*args, gap_open, gap_ext):
        return nw_cuda._run("nw_gotoh_xl", *args, gap_open, gap_ext,
                            xl_words=2)[0]

    worst_xl = max(worst_xl, kernel_vs_plain(
        dev, nw_gotoh_xl_two_words,
        [("two words: " + c[0], *c[1:])
         for c in xl_cases[:18:3] + xl_cases[18:]]))

    print("[5] main path: similarity_nw on h3n2sample[:1000]")
    h3n2 = load_sequences("h3n2sample", limit=1000)
    n = len(h3n2)
    nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
    t0 = time.perf_counter()
    sims = similarity_nw(h3n2)
    first_s = time.perf_counter() - t0
    launches = nw_cuda.LAUNCHES
    if launches == 0 or nw_cuda.LAUNCHES_XL:
        raise AssertionError("the main path did not run on nw_gotoh alone")
    check_result(sims, h3n2, [range(24), range(n - 24, n)])
    print(f"  n=1000: {launches} nw_gotoh launches, first call "
          f"{first_s:.3f} s, bit-exact vs the oracle on [:24, :24] and "
          "[-24:, -24:]")
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
    evp_all = load_sequences("evp_peparray")
    ne = len(evp_all)
    elens = np.array([len(s) for s in evp_all], dtype=np.float64)
    ecells = (elens.sum() ** 2 + (elens ** 2).sum()) / 2
    nw_cuda.LAUNCHES = 0
    ewalls = []
    for _ in range(3):
        t0 = time.perf_counter()
        sims_e = similarity_nw(evp_all)
        ewalls.append(time.perf_counter() - t0)
    check_result(sims_e, evp_all, [range(24), range(ne - 24, ne)])
    print(f"  evp_peparray, all {ne} sequences of {elens.min():.0f}-"
          f"{elens.max():.0f} aa ({ne * (ne + 1) // 2} pairs, {ecells:.4e} "
          f"cells): {nw_cuda.LAUNCHES // 3} launch(es) a call of nw_gotoh "
          f"instance {nw_cuda.LAST_INSTANCE} "
          f"{nw_cuda.INSTANCES[nw_cuda.LAST_INSTANCE]}; similarity_nw wall s"
          f": {ewalls}; best {min(ewalls):.4f} s; equal to the oracle on "
          "[:24, :24] and [-24:, -24:]")

    print("[6] timing of the main path")
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    lens = np.array([len(s) for s in h3n2], dtype=np.float64)
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
    # through the kernel, held equal to the main path's result for those
    # pairs; the first one through the plain version as well
    enc = encode(h3n2)
    idx = torch.from_numpy(enc.indices).to(dev)
    ln = torch.from_numpy(enc.lengths).to(dev)
    iu = torch.triu_indices(n, n, device=dev)
    iu_np = np.triu_indices(n)
    sub = blosum.get_matrix(device=dev)
    chunk_ms = []
    for s in range(0, pairs, api.DEFAULT_CHUNK):
        e = min(s + api.DEFAULT_CHUNK, pairs)
        args = _pair_batch(idx, ln, *iu[:, s:e])
        k_ms, got = _event_ms(
            lambda: nw_cuda.nw_similarity_batch_cuda(*args, sub))
        chunk_ms.append(k_ms)
        if not np.array_equal(sims[iu_np[0][s:e], iu_np[1][s:e]],
                              got.similarity()):
            raise AssertionError(f"similarity_nw != kernel on pairs {s}:{e}")
        text = f"kernel {k_ms:.3f} ms; kernel == similarity_nw"
        if s == 0:
            plain_ms, first_ref = _event_ms(
                lambda: nw_similarity_batch(*args, sub))
            worst = max(worst, _max_err(got, first_ref))
            if not _equal(got, first_ref):
                raise AssertionError("kernel != plain on the first chunk")
            text = (f"kernel {k_ms:.3f} ms, plain {plain_ms:.3f} ms; kernel "
                    "== plain == similarity_nw")
        print(f"  main-path chunk {s}:{e} (B={e - s}, M=N={args[0].shape[1]}):"
              f" {text}")
    print(f"  kernel time of each main-path chunk, ms: {chunk_ms}; sum "
          f"{sum(chunk_ms):.3f} ms = {sum(chunk_ms) / 1e3 / best:.4f} of the "
          f"best wall time; wall - sum = {best - sum(chunk_ms) / 1e3:.4f} s "
          "(host work, gathers, copies)")
    print("  similarity_nw n=1000 step by step, s (its own functions timed "
          "in place, a synchronise after each), "
          + _stage_text(host_stages(h3n2)))
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    for c in (1 << 16, 1 << 18, pairs):
        t0 = time.perf_counter()
        similarity_nw(h3n2, chunk=c)
        print(f"  similarity_nw n=1000 with chunk={c}: "
              f"{time.perf_counter() - t0:.4f} s")

    chunk = _pair_batch(idx, ln, *iu[:, : api.DEFAULT_CHUNK])
    bsz, m = chunk[0].shape
    chunk_cells = float((chunk[1].double() * chunk[3].double()).sum())
    nbytes = 4 * (2 * bsz * m + 2 * bsz + 32 * 32 + 2 * bsz)
    bound_ms, bound_by, old_ms = _bound(chunk_cells, nbytes)
    kernel_ms, _ = _event_ms(
        lambda: nw_cuda.nw_similarity_batch_cuda(*chunk, sub), repeat=3
    )
    bound_text = (f"{ALU_OPS_PER_CELL} ALU-only ops per cell at "
                  f"{ALU_OPS_PER_S:.4e}/s against {OPS_PER_CELL} at the "
                  f"issue rate {SCHED_OPS_PER_S:.4e}/s")
    print(f"  nw_gotoh instance {nw_cuda.LAST_INSTANCE}, one chunk (B={bsz}, "
          f"M=N={m}, {chunk_cells:.4e} cells): {kernel_ms:.3f} ms; bound "
          f"{bound_ms:.3f} ms by {bound_by} ({bound_text}; {nbytes} bytes at "
          f"{HBM_BYTES_PER_S:.3e} B/s) = {bound_ms / kernel_ms:.4f} of the "
          f"bound ({old_ms / kernel_ms:.4f} of the older bound of "
          f"{OLD_OPS_PER_CELL} ops per cell at the ALU rate, {old_ms:.3f} "
          f"ms); {chunk_cells / kernel_ms * 1e3:.4e} cell updates/s")
    print(f"  plain version (correctness twin, not a yardstick), same chunk:"
          f" {plain_ms:.3f} ms")
    # the long-pair kernel on the same chunk, for comparison only: the main
    # path routes these widths to nw_gotoh.  Its wrapper, three calls one
    # after another, each by CUDA events (their mean is the reading of
    # earlier runs); the wrapper's work table alone; then the launch alone
    xl_calls = []
    for _ in range(3):
        ms, xl_got = _event_ms(
            lambda: nw_cuda.nw_similarity_batch_cuda_xl(*chunk, sub))
        xl_calls.append(ms)
    xl_chunk_ms = sum(xl_calls) / 3
    if not _equal(xl_got, first_ref):
        raise AssertionError("nw_gotoh_xl != plain on the first chunk")
    print(f"  nw_gotoh_xl on the same chunk (comparison, not the main path),"
          f" its wrapper by CUDA events, 3 calls: {xl_calls} ms, mean "
          f"{xl_chunk_ms:.3f} ms = {bound_ms / xl_chunk_ms:.4f} of the "
          f"bound ({old_ms / xl_chunk_ms:.4f} of the older), "
          f"{xl_chunk_ms / kernel_ms:.2f}x nw_gotoh's time; equal to plain; "
          + _xl_table_text(chunk[1], chunk[3]))
    table_ms, _ = _event_ms(lambda: nw_cuda.xl_work_table(
        chunk[1], chunk[3], nw_cuda.XL_STRIP, nw_cuda.LAST_XL_ITEMS),
        repeat=3)
    chunk_launch_ms, chunk_out = xl_launch(chunk)
    if not _equal(chunk_out, first_ref):
        raise AssertionError("nw_gotoh_xl launched alone != plain, first "
                             "chunk")
    print(f"  its work table alone: {table_ms:.3f} ms; the launch alone, "
          f"best of 4: {chunk_launch_ms:.3f} ms; equal to plain")
    print("  library_ms: none (no single PyTorch call computes NW)")
    t0 = time.perf_counter()
    oracle.nw_similarity(h3n2[:24])
    oracle_s = time.perf_counter() - t0
    oracle_rate = 300 / oracle_s
    print(f"  serial C++ oracle, h3n2sample[:24] (300 pairs): {oracle_s:.4f}"
          f" s = {oracle_rate:.2f} pairs/s; similarity_nw / oracle = "
          f"{pairs / best / oracle_rate:.2f}x")

    print("[7] long path: similarity_nw on 96 joins of h3n2sample proteins")
    long = long_set()
    nl = len(long)
    llens = np.array([len(s) for s in long], dtype=np.float64)
    lpairs = nl * (nl + 1) // 2
    lcells = (llens.sum() ** 2 + (llens ** 2).sum()) / 2
    print(f"  {nl} sequences of {llens.min():.0f}-{llens.max():.0f} aa "
          f"(mean {llens.mean():.2f}), {lpairs} pairs, {lcells:.4e} cells")
    nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
    t0 = time.perf_counter()
    lsims = similarity_nw(long)
    lfirst_s = time.perf_counter() - t0
    launches_xl = nw_cuda.LAUNCHES_XL
    if launches_xl == 0 or nw_cuda.LAUNCHES:
        raise AssertionError("the long path did not run on nw_gotoh_xl alone"
                             f" ({nw_cuda.LAUNCHES}, {launches_xl})")
    t0 = time.perf_counter()
    check_result(lsims, long, [range(16)])
    lor_s = time.perf_counter() - t0
    check_result(lsims, long, [range(nl - 16, nl)])
    lor_rate = 136 / lor_s
    print(f"  {launches_xl} nw_gotoh_xl launch(es), 0 nw_gotoh; first call "
          f"{lfirst_s:.3f} s; bit-exact vs the oracle on [:16, :16] and "
          "[-16:, -16:]")
    lwalls = []
    for _ in range(3):
        t0 = time.perf_counter()
        similarity_nw(long)
        lwalls.append(time.perf_counter() - t0)
    lbest = min(lwalls)
    print(f"  similarity_nw long set wall s: {lwalls}; best {lbest:.4f} s = "
          f"{lpairs / lbest:.1f} pairs/s, {lcells / lbest:.4e} cell "
          "updates/s")
    lenc = encode(long)
    lidx = torch.from_numpy(lenc.indices).to(dev)
    lln = torch.from_numpy(lenc.lengths).to(dev)
    liu = torch.triu_indices(nl, nl, device=dev)
    largs = _pair_batch(lidx, lln, *liu)
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    xl_all_ms, lgot = _event_ms(
        lambda: nw_cuda.nw_similarity_batch_cuda_xl(*largs, sub), repeat=3)
    liu_np = np.triu_indices(nl)
    if not np.array_equal(lsims[liu_np], lgot.similarity()):
        raise AssertionError("long set: kernel and similarity_nw differ")
    lb, lm = largs[0].shape

    def xl_bound(batch):
        n_cells = float((batch[1].double() * batch[3].double()).sum())
        b = batch[0].shape[0]
        nbytes = 4 * (2 * b * lm + 2 * b + 32 * 32 + 2 * b)
        return n_cells, nbytes, *_bound(n_cells, nbytes)

    _, lbytes, all_bound_ms, all_bound_by, all_old_ms = xl_bound(largs)
    print(f"  nw_gotoh_xl, all {lb} pairs in one launch (M=N={lm}): "
          f"{xl_all_ms:.3f} ms; bound {all_bound_ms:.3f} ms by "
          f"{all_bound_by} ({lbytes} bytes) = {all_bound_ms / xl_all_ms:.4f} "
          f"of the bound ({all_old_ms / xl_all_ms:.4f} of the older bound, "
          f"{all_old_ms:.3f} ms); {lcells / xl_all_ms * 1e3:.4e} cell "
          f"updates/s; kernel / best wall = {xl_all_ms / 1e3 / lbest:.4f}; "
          "kernel == similarity_nw on every pair; "
          + _xl_table_text(largs[1], largs[3]))
    # the plain version walks every fourth pair only (all of them took it
    # 42 s); the kernel is timed on the same pairs beside it
    qargs = _pair_batch(lidx, lln, *liu[:, ::4])
    xl_quarter_ms, qgot = _event_ms(
        lambda: nw_cuda.nw_similarity_batch_cuda_xl(*qargs, sub), repeat=3)
    xl_plain_ms, qref = _event_ms(lambda: nw_similarity_batch(*qargs, sub))
    worst_xl = max(worst_xl, _max_err(qgot, qref))
    if not _equal(qgot, qref) or not np.array_equal(
        lsims[liu_np[0][::4], liu_np[1][::4]], qref.similarity()
    ):
        raise AssertionError("long set: kernel, plain and similarity_nw "
                             "differ on every fourth pair")
    qcells, _, q_bound_ms, q_bound_by, _ = xl_bound(qargs)
    print(f"  every fourth pair ({qargs[0].shape[0]} pairs, {qcells:.4e} "
          f"cells): nw_gotoh_xl {xl_quarter_ms:.3f} ms; bound "
          f"{q_bound_ms:.3f} ms by {q_bound_by} = "
          f"{q_bound_ms / xl_quarter_ms:.4f} of the bound; plain "
          f"version on the card {xl_plain_ms:.3f} ms; kernel == plain == "
          "similarity_nw")
    # the launch alone on the whole set, every fourth pair and the longest
    # pair alone (the critical path)
    top = int(torch.argmax(largs[1].long() * largs[3].long()))
    one = [x[top : top + 1] for x in largs]
    one_cells = float(one[1].double() * one[3].double())
    sched = {}
    for label, batch, ref in (("all pairs", largs, lgot),
                              ("every fourth pair", qargs, qref),
                              ("the longest pair", one, None)):
        ms, out = xl_launch(batch)
        if ref is None:  # the longest pair: against similarity_nw's value
            if out.similarity()[0] != lsims[liu_np[0][top], liu_np[1][top]]:
                raise AssertionError("the longest pair != similarity_nw")
        elif not _equal(out, ref):
            raise AssertionError(f"long set, {label}: the launch alone "
                                 "differs")
        sched[label] = ms
        print(f"  {label}, the launch alone, best of 4: {ms:.3f} ms; "
              "equal; " + _xl_table_text(batch[1], batch[3]))
    top_bound_ms = _bound(one_cells, 0)[0]
    print(f"  the longest pair alone ({int(one[1])} x {int(one[3])} aa, "
          f"{one_cells:.4e} cells): its operations bound on the whole card "
          f"{top_bound_ms:.4f} ms; {-(-int(one[1]) // nw_cuda.XL_STRIP)} "
          f"strips of {int(one[3]) + 31} steps")
    print(f"  serial C++ oracle, long set [:16, :16] (136 pairs): "
          f"{lor_s:.4f} s = {lor_rate:.4f} pairs/s; similarity_nw / oracle "
          f"= {lpairs / lbest / lor_rate:.2f}x (pairs/s; the block's pairs "
          "are of the same set)")
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")

    print("[8] similarity_nw_bucketed on a mixed set")
    mixed = mixed_set()
    nm = len(mixed)
    mlens = [len(s) for s in mixed]
    nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
    t0 = time.perf_counter()
    msims = similarity_nw_bucketed(mixed)
    m_s = time.perf_counter() - t0
    mixed_launches = (nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL)
    if min(mixed_launches) == 0:
        raise AssertionError(f"bucketed launches {mixed_launches}: not both")
    t0 = time.perf_counter()
    m_ref = similarity_nw(mixed)
    m_flat_s = time.perf_counter() - t0
    if not np.array_equal(msims, m_ref):
        raise AssertionError("similarity_nw_bucketed != similarity_nw")
    check_result(msims, mixed, [
        [*range(0, 5), *range(64, 69), *range(128, 134)],
        [*range(59, 64), *range(123, 128), *range(186, 192)],
    ])
    print(f"  {nm} sequences of {min(mlens)}-{max(mlens)} aa: "
          f"{mixed_launches[0]} nw_gotoh + {mixed_launches[1]} nw_gotoh_xl "
          f"launches, {m_s:.3f} s (similarity_nw {m_flat_s:.3f} s); equal to"
          " similarity_nw and to the oracle on two 16x16 blocks across the "
          "buckets")

    print("[9] nw_rescore_pairs past every TPU ceiling")
    rng = np.random.default_rng(9)
    rescore_ms = {}
    # the last: padded M + N = 80,000, MT and LN as two words
    for la, lb_ in ((13000, 13000), (12300, 17000), (300, 40000)):
        seqs = ["".join(rng.choice(list("ARNDCQEGHILKMFPSTWYV"), size=k))
                for k in [la, lb_] * 4]
        pi, pj = np.arange(0, 8, 2), np.arange(1, 8, 2)
        nw_cuda.LAUNCHES, nw_cuda.LAUNCHES_XL = 0, 0
        t0 = time.perf_counter()
        got = nw_rescore_pairs(seqs, pi, pj)
        r_s = time.perf_counter() - t0
        ref = [oracle.nw_pair(seqs[i], seqs[j]) for i, j in zip(pi, pj)]
        if not np.array_equal(got, ref) or nw_cuda.LAUNCHES_XL == 0:
            raise AssertionError(f"nw_rescore_pairs {la} x {lb_} != oracle")
        words = _build.load("nw_gotoh_xl").nw_gotoh_xl_words(
            max(la, lb_), max(la, lb_))  # both sides padded to the longest
        print(f"  4 pairs of {la} x {lb_} aa (m+n = {la + lb_}, MT/LN in "
              f"{words} word(s)): "
              f"{nw_cuda.LAUNCHES_XL} nw_gotoh_xl launch(es), {r_s:.3f} s; "
              f"equal to the oracle pair by pair: {got.tolist()}")
        # the kernel alone on the batch nw_rescore_pairs launched: all
        # sequences padded to the longest, pairs (pi, pj)
        renc = encode(seqs)
        ridx = torch.from_numpy(renc.indices).to(dev)
        rln = torch.from_numpy(renc.lengths).to(dev)
        rargs = _pair_batch(ridx, rln, torch.from_numpy(pi).to(dev),
                            torch.from_numpy(pj).to(dev))
        ms, out = xl_launch(rargs)
        if not np.array_equal(out.similarity(), got):
            raise AssertionError(f"{la} x {lb_}: kernel alone != "
                                 "nw_rescore_pairs")
        rescore_ms[f"{la}x{lb_}"] = ms
        rcells = 4.0 * la * lb_
        print(f"    the launch alone, best of 4: {ms:.3f} ms; bound "
              f"{_bound(rcells, 0)[0]:.4f} ms ({rcells:.4e} cells); "
              + _xl_table_text(rargs[1], rargs[3]))

    print("[10] shift probe (probe_shift)")
    clock_hz = float(_smi("clocks.max.sm").split()[0]) * 1e6
    seed = probe.seed_plane(dev)
    probe.LAUNCHES = 0
    per_kind, probe_err = {}, 0
    for k in probe.KINDS:
        got = probe.probe_shift(seed, k, 64)
        ref = probe.probe_plain(seed, k, 64)
        probe_err = max(probe_err, int((got - ref).abs().max()))
        if not torch.equal(got, ref):
            raise AssertionError(f"probe_shift != plain ({k})")
        per_kind[k] = probe.run(k)
        print(f"  {k}: equal to the plain version after 64 steps; "
              f"{per_kind[k]:.3f} ns/step marginal; shared-memory bound "
              f"{probe.bound_ns_per_step(k, clock_hz):.3f} ns/step "
              f"({probe.smem_bytes_per_step(k)} B per block per step at 128 "
              f"B/clock, {clock_hz / 1e9:.3f} GHz)")
    probe_launches = probe.LAUNCHES
    for k in ("shfl", "mis"):
        print(f"  {k} - base: {per_kind[k] - per_kind['base']:.3f} ns/step")
    steps = 20000
    probe_ms, _ = _event_ms(lambda: probe.probe_shift(seed, "shfl", steps),
                            repeat=3)
    probe_plain_ms, _ = _event_ms(
        lambda: probe.probe_plain(seed, "shfl", steps))
    xors = probe.W * probe.B * steps
    pbytes = 2 * probe.MP1 * probe.B * 4
    probe_bound_ms = max(xors / ALU_OPS_PER_S, pbytes / HBM_BYTES_PER_S)
    probe_bound_ms *= 1e3
    probe_bound_by = ("operations" if xors / ALU_OPS_PER_S
                      >= pbytes / HBM_BYTES_PER_S else "bytes")
    smem_ms = probe.bound_ns_per_step("shfl", clock_hz) * steps / 1e6
    print(f"  shfl, one launch of {steps} steps: {probe_ms:.3f} ms; bound "
          f"{probe_bound_ms:.4f} ms by {probe_bound_by} ({xors} xors at the "
          f"ALU rate), {smem_ms:.3f} ms by shared memory on its 8 SMs; "
          f"plain version on the card {probe_plain_ms:.3f} ms")

    h3n2_all = load_sequences("h3n2sample")
    allunique = load_sequences("allunique")
    print(f"nvidia-smi name, power.limit: {_smi()}")
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    refs = {"nw h3n2": _digest(sims), "nw long": _digest(lsims),
            "bucketed mixed": _digest(msims)}
    torch_stages = phase_minhash(dev, evp_all, h3n2_all, refs)
    torch_stages.update(phase_topk(dev, allunique, refs))
    print(f"  nvidia-smi {CLOCKS}: {_smi(CLOCKS)}")
    phase_hybrid(h3n2, sims, long, lsims, load_sequences("herv"))
    exact_mem = phase_clustering(evp_all, allunique, refs)
    phase_pipeline(h3n2_all, sims, long, lsims, exact_mem)
    sharded = phase_parallel(refs, allunique)
    phase_studies(h3n2, sims, evp_all, sims_e)
    print("torch stages (no hand-written kernel), ms / bound ms / share: "
          + "; ".join(f"{k} {ms:.3f} / {b:.3f} / {b / ms:.4f}"
                      for k, (ms, b) in torch_stages.items()))

    print(f"nvidia-smi name, power.limit: {_smi()}")
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [{
        "name": "nw_gotoh",
        "route": "cuda",
        "source": "dynaalign_torch/csrc/nw_gotoh.cu",
        "replaces": "dynaalign_tpu/ops/nw_pallas.py:302",
        "launches": launches,
        "launches_sharded": sharded["nw_gotoh"],
        "equal_to_plain": True,
        "max_abs_err": worst,
        "timed_on": "the first chunk of h3n2sample n=1000",
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": None,
    }, {
        "name": "nw_gotoh_xl",
        "route": "cuda",
        "source": "dynaalign_torch/csrc/nw_gotoh_xl.cu",
        "replaces": "dynaalign_tpu/ops/nw_pallas.py:1093",
        "launches": launches_xl,
        "launches_sharded": sharded["nw_gotoh_xl"],
        "equal_to_plain": True,
        "max_abs_err": worst_xl,
        "timed_on": "the long set's one launch; the plain version and "
                    "quarter_ms on every fourth pair of it; schedule_ms: "
                    "the launch alone (table prebuilt), best of 4, on the "
                    "long set, every fourth pair and the longest pair; "
                    "rescore_ms: phase 9's batches, likewise; h3n2_chunk_ms: "
                    "phase 6's chunk, likewise; h3n2_chunk_wrapper_ms: its "
                    "wrapper, 3 calls",
        "ms": xl_all_ms,
        "quarter_ms": xl_quarter_ms,
        "schedule_ms": sched,
        "rescore_ms": rescore_ms,
        "h3n2_chunk_ms": chunk_launch_ms,
        "h3n2_chunk_wrapper_ms": xl_calls,
        "plain_ms": xl_plain_ms,
        "bound_ms": all_bound_ms,
        "bound_by": all_bound_by,
        "library_ms": None,
    }, {
        "name": "probe_shift",
        "route": "cuda",
        "source": "dynaalign_torch/csrc/probe_shift.cu",
        "replaces": "tools/probe_misalign.py:41",
        "launches": probe_launches,
        "equal_to_plain": True,
        "max_abs_err": probe_err,
        "ms": probe_ms,
        "plain_ms": probe_plain_ms,
        "bound_ms": probe_bound_ms,
        "bound_by": probe_bound_by,
        "library_ms": None,
        "ns_per_step": per_kind,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--parallel-worker"]:
        sys.exit(parallel_worker(*sys.argv[2:]))
    sys.exit(main())
