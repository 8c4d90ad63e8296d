"""Percent of the traced window in the exact NW rescoring of the kept
edges: the spans ``hybrid.rescore`` and the NW spans inside them (the
launches, the kernel wrapper's checks, the fetch and the ratio), self
time each.  None where no ``hybrid.rescore`` span was recorded."""
from portbench.spans import recorder, share

INSIDE = ["nw.launch", "nw_gotoh", "nw_gotoh.check", "nw_gotoh_xl",
          "nw.fetch", "nw.ratio"]


def read(run):
    prof = recorder()
    if prof is None or not any(s.name == "hybrid.rescore"
                               for s in prof.spans()):
        return None
    return share(run, ["hybrid.rescore", *INSIDE])
