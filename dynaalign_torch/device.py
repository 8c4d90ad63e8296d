"""The port's device rule, shared by every entry point."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA device needs a card present."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch version on the host"
        )
    return dev
