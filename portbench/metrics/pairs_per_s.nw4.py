"""Pairs of ``sharded_nw_allpairs``' upper triangle (diagonal included)
that the traced window's completed calls aligned over all ranks, per
second of rank 0's window: the whole call's rate, the host's ratio and
fill of every rank included."""
from portbench.readers import rate


def read(run):
    return rate(run, "pairs")
