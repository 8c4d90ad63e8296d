"""Probe: what handing a row's value to the next row costs on the card.

    python -m dynaalign_torch.tools.probe_misalign     # needs one card

The port of the JAX package's ``tools/probe_misalign.py``.  The NW
wavefront's ancestor shift (shifted[i] = x[i-1]) is a roll on the TPU; on
the card it is a register shuffle between lanes that hold neighbouring rows
(``csrc/nw_cell.cuh``'s hand-off) or a shared-memory load one row lower.
The kernel ``csrc/probe_shift.cu`` runs one synthetic step loop at the TPU
probe's shape (a [336, 256] int32 window of a [584, 256] plane) in the NW
kernels' layout: a group of ``GROUP`` lanes per column, lane t holding
``ROWS_PER_LANE`` consecutive window rows in registers, one warp (two
columns) a block, ``BLOCKS`` blocks each alone on its SM.  Three kinds:

  base:  b = a                        (no shift)
  shfl:  b = a rolled down one row    (the shuffle; the TPU probe's roll)
  mis:   b = the window one row lower (the shifted load)

and stores ``a ^ b`` into the window.  :func:`probe_shift` returns the
whole plane after ``n_steps`` steps: through the kernel for a CUDA tensor,
through :func:`probe_plain` for a CPU tensor.  :func:`run` times the
marginal ns per step on the card by differencing two step counts;
:func:`geometry` reads the launch's blocks and how many an SM holds.
Each launch is the span ``probe_shift`` of :mod:`..utils.profiling`, whose
counter counts the launches.
"""

from __future__ import annotations

import ctypes
import functools
import subprocess
import sys

import torch

from ..ops import _build
from ..utils.profiling import span

MP1, B, W = 584, 256, 336
GROUP = 16  # lanes a column (PROBE_G)
ROWS_PER_LANE = W // GROUP  # 21 (PROBE_R)
BLOCK_COLS = 32 // GROUP  # columns a block of one warp: 2 (PROBE_BCOLS)
BLOCKS = B // BLOCK_COLS  # 128 blocks, one an SM (PROBE_BLOCKS)
KINDS = ("base", "shfl", "mis")
SMEM_BYTES_PER_CLOCK = 128  # shared memory per SM per clock


def _window_offset(g: int) -> int:
    return 16 + (g % 8) * 16


def probe_plain(seed: torch.Tensor, kind: str, n_steps: int) -> torch.Tensor:
    """The plain PyTorch version: the plane after ``n_steps`` steps."""
    st = seed.clone()
    for g in range(n_steps):
        o = _window_offset(g)
        a = st[o : o + W]
        if kind == "base":
            b = a
        elif kind == "shfl":
            b = torch.roll(a, 1, 0)
        else:
            b = st[o - 1 : o - 1 + W]
        st[o : o + W] = a ^ b
    return st


@functools.cache
def _launcher():
    fn = _build.load("probe_shift").probe_shift_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def probe_shift(seed: torch.Tensor, kind: str, n_steps: int) -> torch.Tensor:
    """The plane after ``n_steps`` steps of ``kind``: the kernel for a CUDA
    tensor, the plain version for a CPU tensor."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    if not isinstance(seed, torch.Tensor) or seed.dtype != torch.int32:
        raise TypeError("seed must be an int32 torch.Tensor")
    if tuple(seed.shape) != (MP1, B) or not seed.is_contiguous():
        raise ValueError(f"seed must be a contiguous [{MP1}, {B}] tensor")
    if n_steps < 0:
        raise ValueError("n_steps must be >= 0")
    dev = seed.device
    if dev.type == "cpu":
        return probe_plain(seed, kind, n_steps)
    if dev.type != "cuda":
        raise ValueError(f"no probe kernel for device {dev}")
    out = torch.empty_like(seed)
    with torch.cuda.device(dev), span("probe_shift"):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = _launcher()(seed.data_ptr(), out.data_ptr(), KINDS.index(kind),
                         n_steps, stream)
    if rc != 0:
        raise RuntimeError(f"probe_shift launch failed: CUDA error {rc}")
    return out


def smem_bytes_per_step(kind: str) -> int:
    """Shared-memory bytes of one step over the whole plane: the window
    read and written, plus one 4-byte load a lane (mis: row 0 of each
    lane's rows, one row lower); the shuffle (shfl) moves none."""
    window = W * B * 4
    lanes = BLOCKS * 32
    return 2 * window + {"base": 0, "shfl": 0, "mis": 4 * lanes}[kind]


def bound_ns_per_step(kind: str, clock_hz: float,
                      sms: int = BLOCKS) -> float:
    """Least time of one step: its shared-memory bytes at
    SMEM_BYTES_PER_CLOCK on each of the ``sms`` SMs the grid covers (one
    block an SM, so ``BLOCKS``)."""
    return (smem_bytes_per_step(kind) / (SMEM_BYTES_PER_CLOCK * sms)
            / clock_hz * 1e9)


def geometry(kind: str = "shfl") -> dict[str, int]:
    """The launch geometry of ``kind`` on the current card: blocks, threads
    a block, dynamic shared memory a block, the most blocks an SM holds at
    once (from ``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), the
    card's SMs, and ``sms_covered``: the fewest SMs the grid can run on
    (all of its blocks are resident at once)."""
    if not torch.cuda.is_available():
        raise RuntimeError("the launch geometry is the card's; no CUDA device")
    fn = _build.load("probe_shift").probe_shift_geometry
    fn.argtypes = [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * 15)()
    rc = fn(ctypes.addressof(out))
    if rc != 0:
        raise RuntimeError(f"probe_shift geometry failed: CUDA error {rc}")
    i = 5 * KINDS.index(kind)
    keys = ("blocks", "threads", "smem_bytes", "blocks_per_sm", "sms")
    g = dict(zip(keys, out[i:i + 5]))
    if g["blocks_per_sm"] < 1 or g["blocks"] > g["blocks_per_sm"] * g["sms"]:
        raise RuntimeError(f"the probe's blocks are not all resident: {g}")
    g["sms_covered"] = -(-g["blocks"] // g["blocks_per_sm"])
    return g


def seed_plane(device, seed: int = 0) -> torch.Tensor:
    """The probe's state at step 0: random int32 in [0, 2^30), as the TPU
    probe draws it."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 30, (MP1, B), generator=g,
                         dtype=torch.int32).to(device)


def run(kind: str, n_steps=(2000, 20000), device="cuda") -> float:
    """Marginal ns per step of ``kind`` on the card: (t(n_steps[1]) -
    t(n_steps[0])) / (n_steps[1] - n_steps[0]), each t the least of 5
    launches timed by CUDA events: a host stall only adds time, so the
    least of each count is its clean time."""
    dev = torch.device(device)
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError("the probe times the card; no CUDA device given")
    seed = seed_plane(dev)
    probe_shift(seed, kind, n_steps[0])  # build, load and warm up

    def ms(n):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        probe_shift(seed, kind, n)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop)

    lo, hi = n_steps
    t_lo, t_hi = [], []
    for _ in range(5):
        t_lo.append(ms(lo))
        t_hi.append(ms(hi))
    return (min(t_hi) - min(t_lo)) * 1e6 / (hi - lo)


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_misalign: no CUDA device", file=sys.stderr)
        return 2
    clock = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,"
         "nounits"], capture_output=True, text=True, check=True,
    ).stdout.split()[0]) * 1e6
    dev = torch.device("cuda")
    seed = seed_plane(dev)
    ns = {}
    for kind in KINDS:
        for n in (64, 2001):
            got = probe_shift(seed, kind, n)
            if not torch.equal(got.cpu(), probe_plain(seed.cpu(), kind, n)):
                raise AssertionError(f"probe kernel != plain version ({kind}, "
                                     f"{n} steps)")
        g = geometry(kind)
        ns[kind] = run(kind)
        print(f"{kind}: {ns[kind]:.2f} ns/step, bound "
              f"{bound_ns_per_step(kind, clock, g['sms_covered']):.2f} "
              f"ns/step; grid {g['blocks']} x {g['threads']}, "
              f"{g['sms_covered']} SMs")
    for kind in ("shfl", "mis"):
        print(f"{kind} - base: {ns[kind] - ns['base']:.2f} ns/step")
    return 0


if __name__ == "__main__":
    sys.exit(main())
