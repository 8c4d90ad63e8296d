"""Pairs of ``similarity_nw``'s upper triangle (diagonal included) that
the window's completed calls aligned, per second of the window."""
from portbench.readers import rate


def read(run):
    return rate(run, "pairs")
