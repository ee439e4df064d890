"""The port's device check, shared by every entry point that defaults to
the card (pipeline, VO, SLAM, ingest, serve, bench), and the card's name
and power limit for a measurement's record."""

from __future__ import annotations

import subprocess

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


def card_line() -> str:
    """The first card's name and power limit, as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them (e.g.
    ``NVIDIA H100 80GB HBM3, 700.00 W``): a card set below its maximum
    runs slower under load, so every time on the card is kept beside it."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]
