"""Profiling and tracing of the port.

The reference has no tracing subsystem: its benchmarks are ad-hoc
``bench::mark``/``system.time`` calls in workspace notebooks
(workspace/yulinWspc.Rmd:791-821).  Here:

* :class:`span`: a named region at a layer boundary of the port.  Its
  counts add to process counters and its gauges are kept, always; while a
  ``torch.profiler`` profile runs it is also a ``record_function`` range
  in the profiler's trace and a recorded :class:`Span` stamped on the
  trace's clock.  With no profile running it reads no clock and records
  no span: whoever runs a profiler turns tracing on.
* :func:`counters`, :func:`gauges`, :func:`spans`, :func:`self_seconds`
  and :func:`reset`: what the spans of this process recorded.
* :func:`trace`: context manager capturing a ``torch.profiler`` trace of
  the host and, where a card is present, of the card, written as a Chrome
  trace (viewable in Perfetto or ``chrome://tracing``).
"""

from __future__ import annotations

import contextlib
import itertools
import os
import threading
import time
from typing import Iterable, NamedTuple

import numpy as np
import torch


class Span(NamedTuple):
    """A span recorded under a profiler.  ``parent`` is the id of the
    span it ran in (None at the top), ``call`` the id of the outermost
    span around it, shared by the spans of one API call.  ``start_ns`` and
    ``end_ns`` are ``time.time_ns()`` taken inside its ``record_function``
    range: the exported Chrome trace's clock (``ts`` * 1000 +
    ``baseTimeNanoseconds``).  ``entries`` are its counts and gauges as
    they stood at its end."""

    id: int
    parent: int | None
    call: int
    name: str
    start_ns: int
    end_ns: int
    entries: dict


_lock = threading.Lock()
_counters: dict[str, int] = {}
_gauges: dict[str, float] = {}
_spans: list[Span] = []
_ids = itertools.count(1)
_open = threading.local()  # .stack: ids of this thread's recorded spans


def _settle(name: str, entries: dict) -> None:
    """Count a span's end: ``name`` +1, each integer entry added to
    ``name.key``, each float entry kept as the gauge ``name.key``."""
    with _lock:
        _counters[name] = _counters.get(name, 0) + 1
        for key, value in entries.items():
            if isinstance(value, (int, np.integer)):
                k = f"{name}.{key}"
                _counters[k] = _counters.get(k, 0) + int(value)
            elif isinstance(value, (float, np.floating)):
                _gauges[f"{name}.{key}"] = float(value)


class span:
    """``with span(name, **counts) as entries:`` a region named ``name``.
    ``entries`` is a dict of ``counts``, on which the region may set more.
    On a normal exit each integer entry is added to the counter
    ``name.key`` and ``name`` itself counts one; each float entry is kept
    as the gauge ``name.key``.  While a profiler runs, the region is also a
    ``record_function(name)`` range and a recorded :class:`Span`.

    The recorded spans of every profile add to one list of the process
    until :func:`reset`: a reader that wants one profile's spans resets
    before it starts (as :func:`trace` does)."""

    __slots__ = ("name", "entries", "_range", "_id", "_parent", "_call",
                 "_start")

    def __init__(self, name: str, **counts):
        self.name = name
        self.entries = counts
        self._range = None

    def __enter__(self) -> dict:
        if torch.autograd._profiler_enabled():
            stack = getattr(_open, "stack", None)
            if stack is None:
                stack = _open.stack = []
            self._id = next(_ids)
            self._parent = stack[-1] if stack else None
            self._call = stack[0] if stack else self._id
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
            stack.append(self._id)
            self._start = time.time_ns()
        return self.entries

    def __exit__(self, exc_type, exc, tb) -> None:
        if self._range is not None:
            end = time.time_ns()
            _open.stack.pop()
            self._range.__exit__(exc_type, exc, tb)
        if exc_type is not None:
            return
        _settle(self.name, self.entries)
        if self._range is not None:
            with _lock:
                _spans.append(Span(self._id, self._parent, self._call,
                                   self.name, self._start, end,
                                   dict(self.entries)))


def counters() -> dict[str, int]:
    """Every counter since the last :func:`reset`: span name to its ends,
    ``name.key`` to the sum of its integer entries."""
    with _lock:
        return dict(_counters)


def gauges() -> dict[str, float]:
    """The last value of every gauge (``name.key``) since the last
    :func:`reset`."""
    with _lock:
        return dict(_gauges)


def spans() -> list[Span]:
    """The spans recorded since the last :func:`reset`, in the order they
    ended."""
    with _lock:
        return list(_spans)


def reset() -> None:
    """Forget every counter, gauge and recorded span."""
    with _lock:
        _counters.clear()
        _gauges.clear()
        _spans.clear()


def self_seconds(names: Iterable[str]) -> float:
    """Seconds of the recorded spans named in ``names``, each less the
    part its child spans cover."""
    names = set(names)
    recorded = spans()
    child_ns: dict[int, int] = {}
    for s in recorded:
        if s.parent is not None:
            child_ns[s.parent] = (child_ns.get(s.parent, 0)
                                  + s.end_ns - s.start_ns)
    return 1e-9 * sum(s.end_ns - s.start_ns - child_ns.get(s.id, 0)
                      for s in recorded if s.name in names)


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a torch.profiler trace of the enclosed block into
    ``logdir/trace.json``, after a :func:`reset`, so that :func:`spans`
    then holds the block's spans; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    reset()
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
