"""Device resolution for the port's entry points.

``device=None`` means the card. There is no silent CPU fallback: a caller
that wants the CPU (the parity tests do) says ``device="cpu"``.
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raises if CUDA was asked for and is missing."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available: the port runs on the GPU unless the "
            "caller passes device='cpu'"
        )
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for queued device work (``block_until_ready``'s counterpart)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
