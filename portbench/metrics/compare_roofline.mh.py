"""Share of the MinHash bound (signatures plus the all-pairs
compare-and-count) over all device kernel time of the window."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "compare")
