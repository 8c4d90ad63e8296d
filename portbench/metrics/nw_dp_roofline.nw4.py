"""Share of one rank's NW DP bound (the window's DP cells and bytes over
the ranks, ``nw_dp_per_chip``) over rank 0's kernel time less its NCCL
kernels: the kernels' efficiency apart from the wait for other ranks."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "nw_dp_per_chip", leave_out="nccl")
