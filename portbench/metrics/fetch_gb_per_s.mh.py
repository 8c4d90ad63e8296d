"""GB/s of MinHash's fetch of the counts to the host, in the narrowest type
that holds n_hash (``ops.minhash.count_dtype``): the bytes of the window's
``mh.fetch`` spans over the device time of its DtoH copies."""
from portbench.spans import fetch_gb_per_s


def read(run):
    return fetch_gb_per_s(run, "mh.fetch")
