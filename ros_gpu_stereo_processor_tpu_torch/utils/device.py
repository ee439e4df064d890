"""The port's device check, shared by every entry point that defaults to
the card (pipeline, VO, SLAM, ingest, serve)."""

from __future__ import annotations

import torch


def require_device(device) -> torch.device:
    """``device`` as a torch.device (the card when None); raises when it is
    a CUDA device and PyTorch has no CUDA."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} asked for, but PyTorch has no CUDA device here; pass "
            "device='cpu' to run on the CPU")
    return dev
