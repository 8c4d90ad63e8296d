"""Failure detection and a clean abort of a multi-process run.

A rank that raises while the others wait in a collective would leave them
blocked until the process group's timeout; :func:`clean_abort` turns an
uncaught exception on any rank into a logged shutdown of the process group
and a non-zero exit, so the launcher (``torchrun``) tears the whole job
down promptly instead of hanging.

Elastic recovery is out of scope (batch workloads); resumability is
provided one level up by clusterbreak checkpoints.
"""

from __future__ import annotations

import contextlib
import sys

import torch
import torch.distributed as dist

from ..device import resolve_device
from ..utils.logging import get_logger


@contextlib.contextmanager
def clean_abort(exit_code: int = 1):
    """Abort the process group cleanly on any uncaught exception.

    Usage:
        distributed_init()
        with clean_abort():
            run_job()

    With more than one rank the process exits with ``exit_code``; alone it
    re-raises.  ``KeyboardInterrupt`` re-raises after the shutdown.
    """
    logger = get_logger()
    try:
        yield
    except KeyboardInterrupt:
        logger.warning("Interrupted; shutting down the process group")
        _shutdown()
        raise
    except Exception as exc:  # noqa: BLE001 — this is the crash barrier
        multi = dist.is_initialized() and dist.get_world_size() > 1
        logger.error("Fatal error on rank %s: %s",
                     dist.get_rank() if dist.is_initialized() else 0, exc)
        _shutdown()
        if multi:
            # the other ranks are (or will be) stuck in collectives;
            # exiting non-zero lets the launcher tear the job down
            sys.exit(exit_code)
        raise


def _shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


def check_devices_healthy(device=None) -> list[str]:
    """Lightweight device health probe: a tiny sum on every local CUDA
    device (``device=None``, which raises without a card, as every entry
    point does) or on ``device``; returns a list of failure descriptions
    (empty = healthy)."""
    if device is None:
        resolve_device(None)
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    else:
        devices = [resolve_device(device)]
    failures = []
    for dev in devices:
        try:
            if float(torch.ones((8, 128), device=dev).sum()) != 8 * 128:
                failures.append(f"{dev}: wrong result")
        except RuntimeError as exc:
            failures.append(f"{dev}: {exc}")
    return failures
