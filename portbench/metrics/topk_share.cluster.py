"""Percent of the traced window in the hybrid path's MinHash top-k (self
time of the spans ``hybrid.topk`` and the ``topk.block`` inside it: the
row blocks' compare and top-k, and the fetch of the lists)."""
from portbench.spans import share


def read(run):
    return share(run, ["hybrid.topk", "topk.block"])
