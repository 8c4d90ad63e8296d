"""Sequence file input/output: FASTA, plain text, CSV."""

from __future__ import annotations

import csv
import os


def read_fasta(path: str) -> tuple[list[str], list[str]]:
    """(names, sequences) from a FASTA file."""
    names: list[str] = []
    seqs: list[str] = []
    cur: list[str] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if line.startswith(">"):
                if names:
                    seqs.append("".join(cur))
                names.append(line[1:].split()[0] if len(line) > 1 else "")
                cur = []
            else:
                cur.append(line)
    if names:
        seqs.append("".join(cur))
    if len(names) != len(seqs):
        raise ValueError(f"malformed FASTA: {path}")
    return names, seqs


def write_fasta(path: str, names: list[str], seqs: list[str]) -> None:
    with open(path, "w") as f:
        for name, seq in zip(names, seqs):
            f.write(f">{name}\n{seq}\n")


def read_sequences(
    path_or_dataset: str, column: str | None = None,
    limit: int | None = None,
) -> list[str]:
    """Sequences from a FASTA/.txt/.csv file or a bundled dataset name."""
    from .datasets import DATASETS, load_sequences

    if path_or_dataset in DATASETS:
        return load_sequences(path_or_dataset, limit=limit)
    ext = os.path.splitext(path_or_dataset)[1].lower()
    if ext in (".fa", ".fasta", ".faa"):
        _, seqs = read_fasta(path_or_dataset)
    elif ext == ".csv":
        with open(path_or_dataset) as f:
            reader = csv.DictReader(f)
            if column is None:
                candidates = [
                    c for c in (reader.fieldnames or [])
                    if c.lower() in ("sequence", "seq", "peptide",
                                     "probe_sequence")
                ]
                if not candidates:
                    raise ValueError(
                        "pass --column for CSV inputs without a "
                        "sequence-like column name"
                    )
                column = candidates[0]
            seqs = [row[column] for row in reader]
    else:  # plain text, one sequence per line
        with open(path_or_dataset) as f:
            seqs = [ln.strip() for ln in f if ln.strip()]
    return seqs[:limit] if limit else seqs
