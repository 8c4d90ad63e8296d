"""GB/s of MinHash's fetch of the int32 counts to the host: the bytes of
the window's ``mh.fetch`` spans over the device time of its DtoH copies."""
from portbench.spans import fetch_gb_per_s


def read(run):
    return fetch_gb_per_s(run, "mh.fetch")
