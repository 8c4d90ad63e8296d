"""Reading a traced window: the device timeline from ``torch.profiler``
(CUDA activity, CUPTI), with the benchmark's own spans and the profiler's
CPU ops to say what the host was doing while the device idled.

The runner wraps the window in a ``portbench.window`` span and each call
of the entry point in a ``portbench.call`` span (``record_function``).
Times are in seconds; the trace's microseconds are converted on reading.
"""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile

import numpy as np

WINDOW = "portbench.window"
CALL = "portbench.call"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
BETWEEN_CALLS = "portbench, between calls"
NO_OP = "host code outside torch ops"


def _union(iv: np.ndarray) -> np.ndarray:
    """Disjoint sorted intervals [K, 2] covering the intervals ``iv``."""
    if len(iv) == 0:
        return np.zeros((0, 2))
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    out = [list(iv[0])]
    for s, e in iv[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.array(out)


def _clip(iv: np.ndarray, lo: float, hi: float) -> np.ndarray:
    iv = np.clip(iv, lo, hi)
    return iv[iv[:, 1] > iv[:, 0]]


def _length(iv: np.ndarray) -> float:
    return float((iv[:, 1] - iv[:, 0]).sum()) if len(iv) else 0.0


def _overlaps(a: np.ndarray, b: np.ndarray):
    """Yield (index into a, index into b, overlap) of two lists of disjoint
    sorted intervals."""
    i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])
        if hi > lo:
            yield i, j, hi - lo
        if a[i, 1] < b[j, 1]:
            i += 1
        else:
            j += 1


def _intersect(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """The intersection of two lists of disjoint sorted intervals."""
    out = []
    for i, j, _ in _overlaps(a, b):
        out.append([max(a[i, 0], b[j, 0]), min(a[i, 1], b[j, 1])])
    return np.array(out).reshape(-1, 2)


def _named(name: str, prefix: str) -> bool:
    return name.removeprefix("void ").startswith(prefix)


def _top_level(iv: np.ndarray, names: list[str]):
    """The intervals that no earlier one contains (ops called by no other
    op), sorted, with their names."""
    order = np.argsort(iv[:, 0], kind="stable")
    keep, end = [], -np.inf
    for k in order:
        if iv[k, 0] >= end:
            keep.append(k)
            end = iv[k, 1]
    return iv[keep], [names[k] for k in keep]


@dataclasses.dataclass
class Trace:
    window: tuple[float, float]
    busy: np.ndarray  # disjoint device intervals (kernels, copies, sets)
    kernels: np.ndarray  # disjoint kernel intervals
    device_ops: dict[str, float]  # seconds by device op name
    idle_by_host: dict[str, float]  # idle seconds by host activity
    # each kernel's interval within the window, unmerged, and its name
    kernel_iv: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2)))
    kernel_names: tuple[str, ...] = ()

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return _length(self.busy)

    @property
    def kernel_s(self) -> float:
        return _length(self.kernels)

    def kernel_s_named(self, prefix: str, matching: bool = True) -> float:
        """Seconds of the window covered by the kernels whose names start
        with ``prefix`` (after a leading return type ``void``), or, with
        ``matching`` False, by every other kernel."""
        keep = np.array([_named(n, prefix) == matching
                         for n in self.kernel_names], dtype=bool)
        return _length(_union(self.kernel_iv[keep]))

    def breakdown(self) -> dict:
        top = sorted(self.device_ops.items(), key=lambda kv: -kv[1])[:10]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:10]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def from_events(events: list[dict]) -> Trace:
    """A Trace from chrome-trace events ("X" events with ``ts`` and
    ``dur`` in microseconds)."""
    x = [e for e in events if e.get("ph") == "X" and "dur" in e]
    win = [e for e in x if e.get("name") == WINDOW
           and e.get("cat") == "user_annotation"]
    if len(win) != 1:
        raise ValueError(f"{len(win)} {WINDOW} spans in the trace")
    lo = win[0]["ts"] * 1e-6
    hi = lo + win[0]["dur"] * 1e-6

    def spans(pick):
        sel = [e for e in x if pick(e)]
        iv = np.array([[e["ts"] * 1e-6, (e["ts"] + e["dur"]) * 1e-6]
                       for e in sel]).reshape(-1, 2)
        return sel, iv

    dev, dev_iv = spans(lambda e: e.get("cat") in DEVICE_CATS)
    busy = _union(_clip(dev_iv, lo, hi))
    is_kernel = np.array([e["cat"] == "kernel" for e in dev], dtype=bool)
    kern_iv = np.clip(dev_iv[is_kernel], lo, hi)
    keep = kern_iv[:, 1] > kern_iv[:, 0]
    kern_names = tuple(e["name"] for e, k in zip(
        (e for e in dev if e["cat"] == "kernel"), keep) if k)
    kern_iv = kern_iv[keep]
    kern = _union(kern_iv)
    ops: dict[str, float] = {}
    for e, (s, t) in zip(dev, np.clip(dev_iv, lo, hi)):
        if t > s:
            ops[e["name"]] = ops.get(e["name"], 0.0) + (t - s)

    # idle gaps: the window less the busy intervals
    edges = np.concatenate([[lo], busy.ravel(), [hi]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    _, call_iv = spans(lambda e: e.get("name") == CALL
                       and e.get("cat") == "user_annotation")
    in_calls = _intersect(gaps, _union(call_iv))
    idle = {BETWEEN_CALLS: _length(gaps) - _length(in_calls),
            NO_OP: _length(in_calls)}
    cpu, cpu_iv = spans(lambda e: e.get("cat") == "cpu_op")
    if len(cpu_iv):
        tops, names = _top_level(cpu_iv, [e["name"] for e in cpu])
        for _, k, ov in _overlaps(in_calls, tops):
            idle[names[k]] = idle.get(names[k], 0.0) + ov
            idle[NO_OP] -= ov
    return Trace((lo, hi), busy, kern, ops, idle, kern_iv, kern_names)


def from_profiler(prof) -> Trace:
    """A Trace of a finished ``torch.profiler.profile``, through its
    chrome-trace export to a file under ``$TMPDIR``, deleted after."""
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return from_events(json.load(f)["traceEvents"])
    finally:
        os.remove(path)
