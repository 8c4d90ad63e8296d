"""Readers of what the program records of itself in a traced window: the
spans of ``dynaalign_torch.utils.profiling``, which it records only while
a profiler runs, so that with ``--trace 1`` they are the window's own
(the warm call ran before the profiler started).

A program without that recorder, or a window in which no span of the
asked names was recorded, gives None: the runner then leaves the metric
out of the result line.
"""

from __future__ import annotations

import re

# the device's copies to the host, whatever memory they land in
DTOH = re.compile(r"Memcpy[ _]DtoH")


def recorder():
    """The program's span recorder, or None where it has none."""
    try:
        from dynaalign_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "spans") else None


def share(run, names):
    """Percent of the traced window that the self time of the spans named
    in ``names`` (their time less their child spans') takes."""
    prof = recorder()
    if prof is None or run.trace is None or run.trace.window_s <= 0:
        return None
    if not any(s.name in names for s in prof.spans()):
        return None
    return 100.0 * prof.self_seconds(names) / run.trace.window_s


def fetch_gb_per_s(run, name: str):
    """GB/s of the fetches to the host: the ``bytes`` of the window's
    spans ``name``, over the device seconds of every copy from the device
    to the host in the traced window."""
    prof = recorder()
    if prof is None or run.trace is None:
        return None
    nbytes = sum(s.entries.get("bytes", 0) for s in prof.spans()
                 if s.name == name)
    copy_s = sum(t for op, t in run.trace.device_ops.items()
                 if DTOH.match(op))
    if nbytes <= 0 or copy_s <= 0:
        return None
    return nbytes / copy_s / 1e9
