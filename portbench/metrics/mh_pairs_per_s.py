"""MinHash pairs, n(n-1)/2 a call, of the window's completed calls, per
second of the window."""
from portbench.readers import rate


def read(run):
    return rate(run, "pairs")
