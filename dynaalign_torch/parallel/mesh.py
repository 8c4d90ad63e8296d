"""The process grid of a multi-process run, and its start-up.

The JAX package shards its all-pairs work over a ``jax.sharding.Mesh`` of
devices.  Here one process runs per card (``torchrun``), the processes are
joined by ``torch.distributed``, and a :class:`Mesh` says which ranks take
part, how they stand in a rows x cols grid, on which device this rank
computes and through which process group the ranks share results.  The
placements (:func:`replicated`, :func:`row_sharded`, :func:`block_sharded`)
say which rows, or which block, of an array this rank owns; the sharded
functions of :mod:`.allpairs` compute that part and sum the parts, so
every rank ends with the whole result.

Importing this module starts nothing: no process group, no device.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device

ROWS, COLS = "rows", "cols"


def distributed_init(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    *,
    device=None,
) -> torch.device | None:
    """Join this process to the process group of a multi-process run.

    ``coordinator`` is the rendezvous: ``host:port`` (TCP) or a
    ``torch.distributed`` init URL (``tcp://...``, ``file://...``).  What is
    left out comes from torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK``.  With
    neither, it does nothing and returns None, as the JAX package's does
    without ``JAX_COORDINATOR``.

    The device decides the backend: NCCL for a CUDA device (``None`` means
    the card ``LOCAL_RANK``, made the current device), gloo for ``"cpu"``;
    a CUDA device without NCCL raises.  Returns this rank's device.
    """
    env = os.environ
    if coordinator is None and "MASTER_ADDR" in env:
        coordinator = f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}"
    if coordinator is None:
        return None
    if "://" not in coordinator:
        coordinator = f"tcp://{coordinator}"
    dev = resolve_device(device)
    if dev.type == "cuda":
        if not dist.is_nccl_available():
            raise RuntimeError("this torch build has no NCCL, which a "
                               "process group on CUDA devices needs")
        if dev.index is None:
            dev = torch.device("cuda", int(env.get("LOCAL_RANK", "0")))
        torch.cuda.set_device(dev)
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=coordinator,
        world_size=(num_processes if num_processes is not None
                    else int(env.get("WORLD_SIZE", "1"))),
        rank=(process_id if process_id is not None
              else int(env.get("RANK", "0"))),
    )
    return dev


def _near_square_factors(n: int) -> tuple[int, int]:
    r = int(np.floor(np.sqrt(n)))
    while n % r:
        r -= 1
    return r, n // r


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """Global ranks in a rows x cols grid (``ranks``, row-major), this
    process's global ``rank``, the ``device`` it computes on, and the
    process ``group`` of the grid's ranks: None for the mesh of one process
    with no process group, which runs no collective."""

    ranks: np.ndarray
    rank: int
    device: torch.device
    group: object = None

    @property
    def shape(self) -> dict[str, int]:
        r, c = self.ranks.shape
        return {ROWS: r, COLS: c}

    @property
    def size(self) -> int:
        return self.ranks.size

    @property
    def index(self) -> int | None:
        """This rank's place in the row-major order; None outside."""
        hit = np.flatnonzero(self.ranks.reshape(-1) == self.rank)
        return int(hit[0]) if hit.size else None

    @property
    def coords(self) -> tuple[int, int] | None:
        """(row, column) of this rank; None outside the mesh."""
        i = self.index
        return None if i is None else divmod(i, self.ranks.shape[1])

    def flat(self) -> "Mesh":
        """The same ranks as one column: a row split over it gives every
        rank a share (the JAX package's flattened mesh)."""
        return dataclasses.replace(self, ranks=self.ranks.reshape(-1, 1))


def make_mesh(
    devices=None, n_devices: int | None = None, *, device=None
) -> Mesh:
    """2-D (rows x cols) mesh over the given global ranks (``devices``,
    default all ranks of the process group), the first ``n_devices`` of
    them when given.

    The factorization is as near-square as the rank count allows: 8 -> 2x4,
    4 -> 2x2, 2 -> 1x2, 1 -> 1x1.  A mesh of only some of the ranks gets
    its own process group, which every rank of the world must create
    together, so every rank calls this; ranks outside the mesh then run
    none of its work.  Without a process group the mesh is this process
    alone.  ``device`` is where this rank computes (None: the current
    card).
    """
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        if (devices is not None and len(devices) != 1) or (
                n_devices or 1) != 1:
            raise ValueError("a mesh of more than one rank needs a process "
                             "group: call distributed_init first")
        return Mesh(np.zeros((1, 1), dtype=np.int64), 0, dev)
    world = dist.get_world_size()
    ranks = (list(range(world)) if devices is None
             else [int(r) for r in devices])
    if n_devices is not None:
        ranks = ranks[:n_devices]
    group = (dist.group.WORLD if ranks == list(range(world))
             else dist.new_group(ranks))
    grid = np.asarray(ranks, dtype=np.int64).reshape(
        _near_square_factors(len(ranks)))
    return Mesh(grid, dist.get_rank(), dev, group)


def _share(n: int, parts: int, i: int) -> slice:
    """The i-th of ``parts`` contiguous shares of ceil(n / parts) rows."""
    s = -(-n // parts)
    return slice(min(i * s, n), min((i + 1) * s, n))


@dataclasses.dataclass(frozen=True)
class Placement:
    """Which part of an array each rank of ``mesh`` owns: the first
    dimension split over the mesh's rows when ``rows``, the second over
    its columns when ``cols``, in contiguous shares of ceil(n / parts)."""

    mesh: Mesh
    rows: bool = False
    cols: bool = False

    def local(self, n_rows: int, n_cols: int | None = None):
        """(rows, columns), as slices, that this rank owns of an
        [n_rows, n_cols] array (``n_cols`` defaults to ``n_rows``); None
        outside the mesh."""
        where = self.mesh.coords
        if where is None:
            return None
        n_cols = n_rows if n_cols is None else n_cols
        pr, pc = self.mesh.ranks.shape
        return (_share(n_rows, pr, where[0]) if self.rows
                else slice(0, n_rows),
                _share(n_cols, pc, where[1]) if self.cols
                else slice(0, n_cols))


def replicated(mesh: Mesh) -> Placement:
    return Placement(mesh)


def row_sharded(mesh: Mesh) -> Placement:
    return Placement(mesh, rows=True)


def block_sharded(mesh: Mesh) -> Placement:
    return Placement(mesh, rows=True, cols=True)
