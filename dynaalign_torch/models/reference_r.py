"""Pure "R-pipeline" MinHash twin (numpy).

The reference ships a second, fully independent MinHash implementation in
pure R (R/minHash.R: shingle → create_vocab → create_char_matrix →
create_hash_parameters → apply_hash → compute_signature_matrix →
compute_distance_matrix → minhash) as a readable validation twin of its
C++ kernel.  This module plays the same role here: a
slow-path, vocabulary-indexed universal-hash `(a·x + b) mod |vocab|`
pipeline, returning a **distance** matrix (1 − similarity,
R/minHash.R:175) — deliberately different machinery from the
murmur3-based MinHash of :mod:`dynaalign_torch.ops.minhash`, used to
cross-validate it.

API parity with the 8 exported R functions, with an explicit ``seed``
replacing R's global RNG (set.seed equivalent).  Hash values use R's
1-based vocabulary row indices so distances are comparable
distribution-for-distribution with the reference.
"""

from __future__ import annotations

import numpy as np


def shingle(x: str, k: int) -> list[str]:
    """All k-shingles of one string (R/minHash.R:12-23)."""
    if not isinstance(x, str):
        raise ValueError("Input 'x' must be a single character string")
    if not isinstance(k, (int, np.integer)) or k < 1 or k > len(x):
        raise ValueError(
            f"'k' must be a positive integer between 1 and {len(x)}"
        )
    return [x[i : i + k] for i in range(len(x) - k + 1)]


def create_vocab(sequences: list[str], k: int) -> list[str]:
    """Sorted unique shingles across all sequences (R/minHash.R:38-41)."""
    all_shingles: set[str] = set()
    for s in sequences:
        all_shingles.update(shingle(s, k))
    return sorted(all_shingles)


def create_char_matrix(
    sequences: list[str], vocab: list[str], k: int
) -> np.ndarray:
    """Binary |vocab| x n membership matrix (R/minHash.R:60-66)."""
    index = {v: i for i, v in enumerate(vocab)}
    out = np.zeros((len(vocab), len(sequences)), dtype=np.int64)
    for j, s in enumerate(sequences):
        for sh in shingle(s, k):
            if sh in index:
                out[index[sh], j] = 1
    return out


def create_hash_parameters(
    n_hash: int, max_val: int, *, seed: int | None = None
) -> dict[str, np.ndarray]:
    """Random (a, b) for the `(ax + b) mod m` family (R/minHash.R:81-88);
    a ∈ 1..max_val, b ∈ 0..max_val."""
    if n_hash < 1:
        raise ValueError("Number of hash functions must be positive")
    if max_val < 2:
        raise ValueError("Maximum value must be at least 2")
    rng = np.random.default_rng(seed)
    return {
        "a": rng.integers(1, max_val + 1, size=n_hash),
        "b": rng.integers(0, max_val + 1, size=n_hash),
    }


def apply_hash(x, a, b, m):
    """(a*x + b) mod m (R/minHash.R:104-106)."""
    return (a * x + b) % m


def compute_signature_matrix(
    char_matrix: np.ndarray, hash_params: dict, max_val: int
) -> np.ndarray:
    """MinHash signatures [n_hash, n_docs] via row-wise pmin updates
    (R/minHash.R:126-143; rows hashed with 1-based indices)."""
    a = np.asarray(hash_params["a"])[:, None]  # [H, 1]
    b = np.asarray(hash_params["b"])[:, None]
    n_rows = char_matrix.shape[0]
    rows = np.arange(1, n_rows + 1)[None, :]  # 1-based, like R's i
    hash_values = (a * rows + b) % max_val  # [H, rows]
    sig = np.where(
        char_matrix[None, :, :] == 1,  # [1, rows, docs]
        hash_values[:, :, None].astype(np.float64),
        np.inf,
    ).min(axis=1)
    return sig


def compute_distance_matrix(sig_matrix: np.ndarray) -> np.ndarray:
    """Pairwise 1 - mean(sig_i == sig_j), zero diagonal
    (R/minHash.R:166-182)."""
    sig = np.asarray(sig_matrix)
    n = sig.shape[1]
    eq = (sig[:, :, None] == sig[:, None, :]).mean(axis=0)
    dist = 1.0 - eq
    np.fill_diagonal(dist, 0.0)
    return dist


def minhash(
    sequences: list[str], k: int, n_hash: int, *, seed: int | None = None
) -> dict:
    """Full pure pipeline (R/minHash.R:206-221): returns
    {vocabulary, char_matrix, sig_matrix, dist_matrix}."""
    vocab = create_vocab(sequences, k)
    char_matrix = create_char_matrix(sequences, vocab, k)
    max_val = len(vocab)
    hash_params = create_hash_parameters(n_hash, max_val, seed=seed)
    sig_matrix = compute_signature_matrix(char_matrix, hash_params, max_val)
    dist_matrix = compute_distance_matrix(sig_matrix)
    return {
        "vocabulary": vocab,
        "char_matrix": char_matrix,
        "sig_matrix": sig_matrix,
        "dist_matrix": dist_matrix,
    }
