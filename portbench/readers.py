"""Arithmetic shared by the metric readers in ``metrics/``.

Each reader takes the finished run (``run.Run``) and returns a number, or
None where it finds nothing to read: the runner then leaves the metric out
of the result line.
"""

from __future__ import annotations


def rate(run, unit: str):
    """Work of every completed call over the window, in ``unit``/s: the
    window runs from its start to the last call's end."""
    if run.unit != unit or not run.calls or run.window_s <= 0:
        return None
    return run.work * len(run.calls) / run.window_s


def busy_rate(run, unit: str):
    """Work of every completed call over the seconds in which the device
    worked in the traced window (kernels, copies and sets, merged), in
    ``unit``/s; None without a trace or a device operation."""
    if run.unit != unit or not run.calls or run.trace is None:
        return None
    busy_s = run.trace.busy_s
    if busy_s <= 0:
        return None
    return run.work * len(run.calls) / busy_s


def roofline(run, bound: str, leave_out: str | None = None):
    """Percent: the least time the window's work could take by the
    ``bound`` of ``counts.py``, over the device's kernel time in the
    traced window: every kernel, or every kernel but those whose names
    start with ``leave_out``."""
    if run.trace is None or bound not in run.bounds or not run.calls:
        return None
    kernel_s = (run.trace.kernel_s if leave_out is None
                else run.trace.kernel_s_named(leave_out, matching=False))
    if kernel_s <= 0:
        return None
    return 100.0 * run.bounds[bound] * len(run.calls) / kernel_s


def idle_share(run):
    """Percent of the traced window in which no kernel, copy or set ran
    on the device."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def kernel_share(run, prefix: str):
    """Percent of the traced window covered by kernels whose names start
    with ``prefix``; None where there is none."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    named_s = run.trace.kernel_s_named(prefix)
    if named_s <= 0:
        return None
    return 100.0 * named_s / run.trace.window_s
