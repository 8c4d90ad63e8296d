"""Bundled datasets, read from the repository's ``data/*.npz``.

The reference lazy-loads nine .rda datasets (reference: data/*.rda); the
repository carries them converted to .npz.  Where a conversion is missing,
the dataset is parsed from the reference package's own .rda
(:mod:`dynaalign_torch.io.rda`), looked for in ``reference/data/`` inside
this repository; nothing outside the repository is read.  A user's .rda
elsewhere is read with ``io.rda.load_rda(path)``.

Dataset roles:
  evp_peparray   641 peptide-array rows, PROBE_SEQUENCE 12-mers (quick start)
  h3n2sample     8,103 H3N2 HA proteins (~566 aa) with clade labels
  h3n2ha1415     11,517 H3N2 HA sequences (benchmark input)
  allunique      65,339 unique 12-mer peptides (large MH stress set)
  adenovirus/parvovirus/polyomavirus/mitochondria/herv  peparray panels
"""

from __future__ import annotations

import os

import numpy as np

DATASETS = (
    "adenovirus",
    "allunique",
    "evp_peparray",
    "h3n2ha1415",
    "h3n2sample",
    "herv",
    "mitochondria",
    "parvovirus",
    "polyomavirus",
)

# canonical column holding the AA sequences per dataset
SEQUENCE_COLUMN = {
    "adenovirus": "PROBE_SEQUENCE",
    "allunique": "peptides",
    "evp_peparray": "PROBE_SEQUENCE",
    "h3n2ha1415": "sequence",
    "h3n2sample": "sequence",
    "herv": "PROBE_SEQUENCE",
    "mitochondria": "PROBE_SEQUENCE",
    "parvovirus": "PROBE_SEQUENCE",
    "polyomavirus": "PROBE_SEQUENCE",
}

_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
_REPO_DATA = os.path.join(_ROOT, "data")
_REFERENCE_DATA = os.path.join(_ROOT, "reference", "data")


def load_dataset(name: str) -> dict[str, np.ndarray]:
    """Load a bundled dataset as {column: array}."""
    if name not in DATASETS:
        raise ValueError(f"unknown dataset {name!r}; available: {DATASETS}")
    npz_path = os.path.join(_REPO_DATA, f"{name}.npz")
    if os.path.exists(npz_path):
        with np.load(npz_path, allow_pickle=False) as z:
            return {k: z[k] for k in z.files}
    rda_path = os.path.join(_REFERENCE_DATA, f"{name}.rda")
    if not os.path.exists(rda_path):
        raise FileNotFoundError(
            f"dataset {name!r}: neither {npz_path} nor {rda_path} exists; "
            "read an .rda elsewhere with dynaalign_torch.io.rda.load_rda(path)"
        )
    from .rda import load_rda, to_columns

    (obj,) = load_rda(rda_path).values()
    return to_columns(obj)


def load_sequences(name: str, limit: int | None = None) -> list[str]:
    """The dataset's AA sequence column as a list of python strings."""
    seqs = load_dataset(name)[SEQUENCE_COLUMN[name]]
    return [str(s) for s in seqs[:limit] if s is not None]


def joined_h3n2(count: int = 96, lo: int = 2, hi: int = 9,
                seed: int = 0) -> list[str]:
    """``count`` long sequences: h3n2sample in file order, empty entries
    skipped, cut into runs of k consecutive proteins joined end to end, k
    drawn by ``np.random.default_rng(seed).integers(lo, hi + 1)``.  Stands
    in for multi-kilobase proteins, of which the bundled data hold none."""
    ha = [s for s in load_sequences("h3n2sample") if s]
    out, pos = [], 0
    for k in np.random.default_rng(seed).integers(lo, hi + 1, size=count):
        out.append("".join(ha[pos : pos + k]))
        pos += k
    return out
