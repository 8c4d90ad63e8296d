"""Command-line interface.

The reference is library-only (no CLI).  The port offers the JAX package's
command line, with the same subcommands, flags, defaults, output files and
printed summaries, and one more flag, ``--device``, on the subcommands
that compute (default: the card; ``cpu`` runs the plain versions on the
host):

    python -m dynaalign_torch similarity --input h3n2sample --limit 200 \
        --engine nw --output sim.npz
    python -m dynaalign_torch cluster --input evp_peparray --size-max 30 \
        --output clusters.csv
    python -m dynaalign_torch consensus --clusters clusters.csv \
        --output consensus.csv
    python -m dynaalign_torch pipeline --input h3n2sample --limit 500 \
        --engine hybrid --size-max 100 --output-dir out/
    python -m dynaalign_torch datasets
    python -m dynaalign_torch stats --similarity sim.npz
    python -m dynaalign_torch warm --input h3n2sample --engines mh,nw
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

import numpy as np


def _add_input_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--input", required=True,
        help="FASTA/.txt/.csv path or bundled dataset name",
    )
    p.add_argument("--column", help="CSV column holding sequences")
    p.add_argument("--limit", type=int, help="use only the first N sequences")


def _add_device_arg(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device",
        help="torch device to compute on (default: the CUDA card; 'cpu' "
        "runs the plain PyTorch versions on the host)",
    )


def _add_engine_args(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--engine",
        choices=("mh", "nw", "hybrid", "topk", "hybrid-sparse"),
        default="mh",
        help="mh/nw/hybrid build a dense matrix; topk (MH top-k graph) "
        "and hybrid-sparse (top-k + exact NW edge rescoring) are flat "
        "large-N cluster engines that never materialize [N, N]",
    )
    p.add_argument("--k", type=int, default=4, help="MinHash k-mer size")
    p.add_argument("--n-hash", type=int, default=50)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--matrix", default="BLOSUM62")
    p.add_argument("--gap-open", type=int, default=10)
    p.add_argument("--gap-ext", type=int, default=4)
    p.add_argument("--prefilter-quantile", type=float, default=0.8)
    p.add_argument(
        "--top-k", type=int, default=64,
        help="neighbors per row for the sparse engines",
    )
    p.add_argument(
        "--bucketed", action="store_true",
        help="length-bucketed NW (mixed-length workloads)",
    )


def _similarity(seqs: list[str], args) -> np.ndarray:
    from .api import similarity_mh, similarity_nw, similarity_nw_bucketed
    from .models import similarity_hybrid

    if args.engine in ("topk", "hybrid-sparse"):
        raise SystemExit(
            f"--engine {args.engine} is a flat large-N cluster engine "
            "(no dense matrix exists); use it with the 'cluster' "
            "subcommand"
        )
    if args.engine == "mh":
        return similarity_mh(
            seqs, k=args.k, n_hash=args.n_hash, seed=args.seed,
            device=args.device,
        )
    if args.engine == "nw":
        fn = (
            similarity_nw_bucketed
            if getattr(args, "bucketed", False)
            else similarity_nw
        )
        return fn(seqs, args.matrix, args.gap_open, args.gap_ext,
                  device=args.device)
    return similarity_hybrid(
        seqs, k=args.k, n_hash=args.n_hash, seed=args.seed,
        prefilter_quantile=args.prefilter_quantile,
        matrix_name=args.matrix, gap_open=args.gap_open,
        gap_ext=args.gap_ext, device=args.device,
    )


def _write_clusters_csv(path: str, clustered: np.ndarray, filtered) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["sequence", "cluster"])
        for seq, cid in clustered:
            w.writerow([seq, cid])
        for seq in filtered:
            w.writerow([seq, "FILTERED"])


def _write_consensus_csv(path: str, consensus) -> None:
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["cluster", "consensus"])
        for cid, cons in consensus:
            w.writerow([cid, cons])


def cmd_similarity(args) -> int:
    from .io.seqio import read_sequences

    seqs = read_sequences(args.input, args.column, args.limit)
    sim = _similarity(seqs, args)
    np.savez_compressed(args.output, similarity=sim)
    print(f"wrote {args.output}: {sim.shape[0]}x{sim.shape[1]} matrix")
    return 0


def cmd_cluster(args) -> int:
    from .cluster import clusterbreak
    from .io.seqio import read_sequences

    seqs = read_sequences(args.input, args.column, args.limit)
    if args.engine in ("topk", "hybrid-sparse"):
        # flat large-N clustering: one Louvain over the sparse top-k
        # graph (MH weights, or exact NW edge weights for
        # hybrid-sparse), with no [N, N] matrix and no size-capped
        # recursion
        import time

        t0 = time.perf_counter()
        if args.engine == "topk":
            from .ops.topk_graph import cluster_large

            mem = cluster_large(
                seqs, k=args.k, n_hash=args.n_hash, seed=args.seed,
                top_k=args.top_k, thresh_p=args.thresh_p,
                resolution=args.resolution, louvain_seed=args.seed,
                device=args.device,
            )
        else:
            from .models import cluster_large_exact

            mem = cluster_large_exact(
                seqs, k=args.k, n_hash=args.n_hash, seed=args.seed,
                top_k=args.top_k, thresh_p=args.thresh_p,
                matrix_name=args.matrix, gap_open=args.gap_open,
                gap_ext=args.gap_ext, resolution=args.resolution,
                louvain_seed=args.seed, device=args.device,
            )
        clustered = np.array(
            [(s, str(int(c))) for s, c in zip(seqs, mem)], dtype=object
        )
        _write_clusters_csv(args.output, clustered, [])
        print(
            f"wrote {args.output}: {len(seqs)} sequences in "
            f"{len(np.unique(mem))} clusters "
            f"({time.perf_counter() - t0:.1f} s, {args.engine})"
        )
        return 0
    if args.engine == "mh":
        # signature-caching engine: bit-identical to per-subset
        # similarity_mh but one signature build for the whole recursion
        from .api import MinHashEngine

        sim_fn = MinHashEngine(
            seqs, k=args.k, n_hash=args.n_hash, seed=args.seed,
            device=args.device,
        )
    else:
        sim_fn = lambda x: _similarity(x, args)  # noqa: E731
    result = clusterbreak(
        seqs,
        thresh_p=args.thresh_p, size_max=args.size_max,
        size_min=args.size_min, max_itr=args.max_itr,
        sim_fn=sim_fn,
        resolution=args.resolution, seed=args.seed,
        device=args.device, checkpoint_path=args.checkpoint,
    )
    _write_clusters_csv(
        args.output, result.clustered_seq, result.filtered_seq
    )
    print(
        f"wrote {args.output}: {len(result.clustered_seq)} clustered, "
        f"{len(result.filtered_seq)} filtered, "
        f"converged={result.converged}"
    )
    return 0


def cmd_consensus(args) -> int:
    from .consensus import cluster_consensus

    rows = []
    with open(args.clusters) as f:
        for row in csv.DictReader(f):
            if row["cluster"] != "FILTERED":
                rows.append((row["sequence"], row["cluster"]))
    out = cluster_consensus(
        np.array(rows, dtype=object), matrix_name=args.matrix,
        threshold=args.threshold,
    )
    _write_consensus_csv(args.output, out)
    print(f"wrote {args.output}: {len(out)} consensus sequences")
    return 0


def cmd_pipeline(args) -> int:
    from .config import (
        ClusterBreakConfig, HybridConfig, MinHashConfig, NWConfig,
        PipelineConfig,
    )
    from .io.seqio import read_sequences
    from .models import Pipeline

    seqs = read_sequences(args.input, args.column, args.limit)
    cfg = PipelineConfig(
        similarity=args.engine,
        minhash=MinHashConfig(k=args.k, n_hash=args.n_hash, seed=args.seed),
        nw=NWConfig(args.matrix, args.gap_open, args.gap_ext),
        clusterbreak=ClusterBreakConfig(
            thresh_p=args.thresh_p, size_max=args.size_max,
            size_min=args.size_min, max_itr=args.max_itr,
            resolution=args.resolution, seed=args.seed,
        ),
        hybrid=HybridConfig(args.prefilter_quantile),
    )
    result = Pipeline(cfg, device=args.device).run(seqs)
    os.makedirs(args.output_dir, exist_ok=True)
    _write_clusters_csv(
        os.path.join(args.output_dir, "clusters.csv"),
        result.clusters.clustered_seq, result.clusters.filtered_seq,
    )
    _write_consensus_csv(
        os.path.join(args.output_dir, "consensus.csv"), result.consensus
    )
    print(
        f"pipeline done: {len(result.clusters.clustered_seq)} clustered "
        f"into {len(result.consensus)} clusters "
        f"({len(result.clusters.filtered_seq)} filtered) -> "
        f"{args.output_dir}/"
    )
    return 0


def cmd_datasets(args) -> int:
    from .io.datasets import DATASETS, SEQUENCE_COLUMN, load_dataset

    for name in DATASETS:
        cols = load_dataset(name)
        nrows = len(next(iter(cols.values())))
        print(f"{name}: {nrows} rows (sequences in {SEQUENCE_COLUMN[name]})")
    return 0


def cmd_stats(args) -> int:
    from .analysis import compute_similarity_stats

    with np.load(args.similarity) as z:
        sim = z["similarity"]
    stats = compute_similarity_stats(sim)
    print(json.dumps(stats.as_dict(), default=list, indent=2))
    return 0


def cmd_warm(args) -> int:
    """Build every kernel and native library, then run each requested
    engine once on the ``--n`` longest sequences of the input, so that a
    later run pays neither a build nor a first launch (the CUDA context,
    the allocator's first blocks).

    The builds are keyed by the content of their sources, so a second
    ``warm`` finds them all in place; its stage times are then the engines'
    own.  Reports per-stage seconds.
    """
    import time

    import torch

    from .cluster import _native as louvain_native
    from .consensus import _native as msa_native
    from .device import resolve_device
    from .io.seqio import read_sequences

    seqs = list(read_sequences(args.input, column=args.column))
    if args.limit:
        seqs = seqs[: args.limit]
    if not seqs:
        print("no sequences", file=sys.stderr)
        return 1
    # longest-first, so that the padded widths (and hence the NW kernel
    # instantiations) are those of a full-set run over the same input
    warm_set = sorted(seqs, key=len, reverse=True)[: args.n]
    engines = [e.strip() for e in args.engines.split(",") if e.strip()]
    dev = resolve_device(args.device)
    total0 = time.perf_counter()
    timings = {}
    # every CUDA source on a card (one nvcc each, all started together) and
    # the two C++ libraries a request runs (the Louvain pass, the MSA row
    # DP), each where it is not built yet
    if dev.type == "cuda":
        from .ops import _build

        _build.build_all()
    for lib in (louvain_native._lib, msa_native._lib):
        lib()
    # absorb the device's first use so stage times are the engines' own
    (torch.zeros(4, device=dev) + 1).cpu()
    for eng in engines:
        t0 = time.perf_counter()
        if eng == "mh":
            from .api import similarity_mh

            similarity_mh(
                warm_set, k=args.k, n_hash=args.n_hash, seed=args.seed,
                device=dev,
            )
        elif eng == "nw":
            from .api import similarity_nw

            similarity_nw(
                warm_set, args.matrix, args.gap_open, args.gap_ext,
                device=dev,
            )
        elif eng == "hybrid":
            from .models import similarity_hybrid

            similarity_hybrid(
                warm_set, k=args.k, n_hash=args.n_hash,
                seed=args.seed, matrix_name=args.matrix,
                gap_open=args.gap_open, gap_ext=args.gap_ext, device=dev,
            )
        else:
            print(f"unknown engine {eng!r}", file=sys.stderr)
            return 1
        timings[eng] = round(time.perf_counter() - t0, 2)
    print(json.dumps({
        "warmed": engines,
        "n_seqs": len(warm_set),
        "max_len": max(len(s) for s in warm_set),
        "stage_seconds": timings,
        "total_seconds": round(time.perf_counter() - total0, 2),
    }))
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="dynaalign_torch",
        description="Peptide similarity & clustering on an NVIDIA card "
        "(PyTorch and hand-written CUDA kernels)",
    )
    sub = p.add_subparsers(dest="command", required=True)

    ps = sub.add_parser("similarity", help="all-pairs similarity matrix")
    _add_input_args(ps)
    _add_engine_args(ps)
    _add_device_arg(ps)
    ps.add_argument("--output", required=True, help="output .npz path")
    ps.set_defaults(fn=cmd_similarity)

    def _add_cluster_args(pc):
        pc.add_argument("--thresh-p", type=float, default=0.8)
        pc.add_argument("--size-max", type=int, default=10)
        pc.add_argument("--size-min", type=int, default=3)
        pc.add_argument("--max-itr", type=int, default=10000)
        pc.add_argument("--resolution", type=float, default=1.05)
        pc.add_argument("--checkpoint", help="checkpoint/resume path")

    pc = sub.add_parser("cluster", help="clusterbreak recursive clustering")
    _add_input_args(pc)
    _add_engine_args(pc)
    _add_cluster_args(pc)
    _add_device_arg(pc)
    pc.add_argument("--output", required=True, help="output .csv path")
    pc.set_defaults(fn=cmd_cluster)

    pn = sub.add_parser("consensus", help="per-cluster consensus sequences")
    pn.add_argument("--clusters", required=True, help="cluster .csv path")
    pn.add_argument("--matrix", default="BLOSUM62")
    pn.add_argument("--threshold", type=float, default=0.05)
    pn.add_argument("--output", required=True)
    pn.set_defaults(fn=cmd_consensus)

    pp = sub.add_parser("pipeline", help="similarity -> cluster -> consensus")
    _add_input_args(pp)
    _add_engine_args(pp)
    _add_cluster_args(pp)
    _add_device_arg(pp)
    pp.add_argument("--output-dir", required=True)
    pp.set_defaults(fn=cmd_pipeline)

    pd = sub.add_parser("datasets", help="list bundled datasets")
    pd.set_defaults(fn=cmd_datasets)

    pt = sub.add_parser("stats", help="similarity matrix statistics")
    pt.add_argument("--similarity", required=True, help=".npz path")
    pt.set_defaults(fn=cmd_stats)

    pw = sub.add_parser(
        "warm",
        help="build every kernel and native library, then run each "
        "engine once",
    )
    _add_input_args(pw)
    pw.add_argument(
        "--engines", default="mh,nw",
        help="comma list of engines to warm (mh,nw,hybrid)",
    )
    pw.add_argument(
        "--n", type=int, default=128,
        help="warm with the N longest sequences (the NW kernel "
        "instantiation follows the padded max length)",
    )
    pw.add_argument("--k", type=int, default=4)
    pw.add_argument("--n-hash", type=int, default=50)
    pw.add_argument("--seed", type=int, default=0)
    pw.add_argument("--matrix", default="BLOSUM62")
    pw.add_argument("--gap-open", type=int, default=10)
    pw.add_argument("--gap-ext", type=int, default=4)
    _add_device_arg(pw)
    pw.set_defaults(fn=cmd_warm)
    return p


def main(argv=None) -> int:
    # No persistent compile cache to enable: the CUDA libraries are built
    # at first use into build/kernels/, keyed by the content of their
    # sources, which is that cache already.
    args = build_parser().parse_args(argv)
    # multi-process runs (torchrun): join this process to the process
    # group before any work; a no-op without torchrun's environment
    from .parallel import distributed_init

    distributed_init(device=getattr(args, "device", None))
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
