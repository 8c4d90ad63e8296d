"""Pairs of ``sharded_nw_allpairs``' upper triangle (diagonal included)
that the window's completed calls aligned over all ranks, per second in
which rank 0's card worked: its NW kernels, the segments' copies, and the
all-reduce with its wait for the other ranks, from the device trace."""
from portbench.readers import busy_rate


def read(run):
    return busy_rate(run, "pairs")
