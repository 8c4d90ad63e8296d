"""The one generator of the benchmark's inputs, driven by a traffic file.

A traffic file (``traffic/<name>.json``) is data only.  Its keys, applied
in this order:

``dataset``, ``column``
    the sequences: the column of ``data/<dataset>.npz`` in the checkout,
    in file order.
``limit``
    keep the first ``limit`` (small copies of a cell in the tests).
``replace``
    {letter: letter}: map letters the alphabet lacks (J, Xle, to L).
``order``
    ``"seeded_permutation"``: the rows in an order drawn from ``--seed``,
    so that every seed does the same work.

And for the runner: ``entry`` and ``args`` (the call, when it is not the
configuration's), ``warm`` ({"longest": n} or {"first": n}: the rows the
set-up calls the entry on) and ``check`` ({"pool", "per_call"}: for a
matrix, how many pairs a run may read and how many after each call;
``portbench/matrix.py``).
"""

from __future__ import annotations

import json
import os

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def load_traffic(name: str) -> dict:
    with open(os.path.join(HERE, "traffic", f"{name}.json")) as f:
        return json.load(f)


def dataset(name: str, column: str) -> list[str]:
    with np.load(os.path.join(ROOT, "data", f"{name}.npz"),
                 allow_pickle=False) as z:
        return [str(s) for s in z[column]]


def build(traffic: dict, seed: int) -> list[str]:
    """The sequences of one run of ``traffic`` under ``seed``."""
    seqs = dataset(traffic["dataset"], traffic["column"])
    if "limit" in traffic:
        seqs = seqs[: traffic["limit"]]
    for a, b in traffic.get("replace", {}).items():
        seqs = [s.replace(a, b) for s in seqs]
    order = traffic.get("order")
    if order == "seeded_permutation":
        perm = np.random.default_rng([seed, 0]).permutation(len(seqs))
        seqs = [seqs[i] for i in perm]
    elif order is not None:
        raise ValueError(f"unknown order {order!r}")
    return seqs


def warm_rows(traffic: dict, seqs: list[str]) -> list[str]:
    """The rows the set-up calls the entry on: the longest ``n`` (in row
    order), which give the padded width and kernel instance of the whole
    set, or the first ``n``."""
    warm = traffic.get("warm", {"first": 64})
    if "longest" in warm:
        lens = np.array([len(s) for s in seqs])
        keep = np.sort(np.argsort(-lens, kind="stable")[: warm["longest"]])
        return [seqs[i] for i in keep]
    return seqs[: warm["first"]]
