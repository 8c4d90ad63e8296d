"""Percent of rank 0's traced window in NCCL kernels (names starting with
``nccl``): the all-reduce of the shares and rank 0's wait in it for the
slowest rank."""
from portbench.readers import kernel_share


def read(run):
    return kernel_share(run, "nccl")
