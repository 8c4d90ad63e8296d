"""Percent of the traced window in Louvain on the host (self time of the
spans ``louvain``)."""
from portbench.spans import share


def read(run):
    return share(run, ["louvain"])
