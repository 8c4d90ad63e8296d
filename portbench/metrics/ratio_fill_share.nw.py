"""Percent of the traced window in ``similarity_nw``'s host ratio and fill
(self time of the spans ``nw.ratio`` and ``nw.fill``)."""
from portbench.spans import share


def read(run):
    return share(run, ["nw.ratio", "nw.fill"])
