"""Share of the NW DP bound: the window's DP cells at 8 ALU operations
a cell (or their bytes), over all device kernel time of the window."""
from portbench.readers import roofline


def read(run):
    return roofline(run, "nw_dp")
