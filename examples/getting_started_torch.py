"""Getting started with dynaalign_torch, the PyTorch/CUDA port.

The counterpart of examples/getting_started.py: the same two flows from the
reference's README (README.md:33-64), the same calls in the same order and
with the same arguments, through the port's root names.  It prints the same
lines as that script.  The work runs on the card unless ``--device cpu`` is
given; without a card the default raises.  ``--no-plots`` skips the two
plots (and nothing else), for a machine without matplotlib.

Run:  python examples/getting_started_torch.py [--limit 300]
          [--device cpu] [--no-plots] [--outdir examples/out]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

from dynaalign_torch import (  # noqa: E402
    cluster_consensus,
    clusterbreak,
    compute_similarity_stats,
    consensus_plot,
    plot_similarity_matrix,
    similarity_mh,
    similarity_nw,
)
from dynaalign_torch.device import resolve_device  # noqa: E402
from dynaalign_torch.io.datasets import load_sequences  # noqa: E402


def run(limit: int = 300, device=None, outdir: str = "examples/out",
        plots: bool = True) -> dict:
    """Both flows; returns what they print: ``sim``, ``stats``,
    ``nw_small``, ``clustered_seq``, ``filtered_seq``, ``consensus`` and
    the plots' paths (``heatmap``, ``network``; None without plots)."""
    device = resolve_device(device)
    heat = net = None
    if plots:
        os.makedirs(outdir, exist_ok=True)

    # --- Flow 1: peptide-array probes, MinHash similarity ------------------
    probes = load_sequences("evp_peparray", limit=limit)
    print(f"loaded {len(probes)} peptide-array probes (12-mers)")
    sim = similarity_mh(probes, k=2, n_hash=50, seed=0, device=device)
    stats = compute_similarity_stats(sim)
    print(f"MinHash similarity: {stats}")
    if plots:
        ax, *_ = plot_similarity_matrix(sim, cluster=True)
        heat = os.path.join(outdir, "peparray_heatmap.png")
        ax.figure.savefig(heat, dpi=120)
        print(f"wrote {heat}")

    # --- Flow 2: H3N2 HA proteins, clusterbreak + consensus ----------------
    seqs = list(dict.fromkeys(load_sequences("h3n2sample", limit=limit)))
    print(f"\nloaded {len(seqs)} unique H3N2 HA sequences (~566 aa)")
    nw_small = similarity_nw(seqs[:20], device=device)
    print(f"exact NW on 20 seqs: mean={np.triu(nw_small, 1).mean():.3f}")

    result = clusterbreak(
        seqs, thresh_p=0.8, size_max=100, size_min=3,
        sim_fn=lambda x: similarity_mh(x, k=4, n_hash=500, seed=0,
                                       device=device),
        device=device,
    )
    labeled = result.clustered_seq
    print(
        f"clusterbreak: {len(labeled)} sequences in "
        f"{len(set(labeled[:, 1]))} clusters, "
        f"{len(result.filtered_seq)} filtered"
    )

    consensus = cluster_consensus(labeled)
    print(f"consensus sequences: {len(consensus)}")
    for cid, cons in consensus[:3]:
        print(f"  cluster {cid}: {cons[:60]}...")

    if plots:
        ax, member = consensus_plot(consensus, k_size=2, hash_size=50)
        net = os.path.join(outdir, "consensus_network.png")
        ax.figure.savefig(net, dpi=120)
        print(f"wrote {net}")
    return {"sim": sim, "stats": stats, "nw_small": nw_small,
            "clustered_seq": labeled, "filtered_seq": result.filtered_seq,
            "consensus": consensus, "heatmap": heat, "network": net}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--limit", type=int, default=300)
    ap.add_argument("--outdir", default="examples/out")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; raises without "
                         "one); 'cpu' runs the plain versions on the host")
    ap.add_argument("--no-plots", action="store_true",
                    help="skip the two plots (for a machine without "
                         "matplotlib)")
    args = ap.parse_args()
    run(args.limit, args.device, args.outdir, plots=not args.no_plots)
    return 0


if __name__ == "__main__":
    sys.exit(main())
