"""Percent of the traced window in MinHash's host float64 divide and fill
(self time of the spans ``mh.similarity``)."""
from portbench.spans import share


def read(run):
    return share(run, ["mh.similarity"])
