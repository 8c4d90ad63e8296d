"""GB/s of NW's fetch of (matches, length) to the host: the bytes of the
window's ``nw.fetch`` spans over the device time of its DtoH copies."""
from portbench.spans import fetch_gb_per_s


def read(run):
    return fetch_gb_per_s(run, "nw.fetch")
