"""Percent of the traced window in the hybrid path's host edge list: the
dedup to i < j, the MinHash quantile and the selection (self time of the
spans ``hybrid.edges``)."""
from portbench.spans import share


def read(run):
    return share(run, ["hybrid.edges"])
