"""Division by a Python number, as the JAX package's compiled code does it.

Inside ``jax.jit``, XLA replaces ``x / c`` for a constant c by ``x · (1/c)``
with the reciprocal rounded to float32, which differs from the true
quotient in the last bit for about a third of the inputs.  PyTorch gives
neither consistently: its CPU kernels divide, its CUDA kernels multiply by
the reciprocal, and ``c / tensor`` is ``reciprocal(tensor) · c`` on every
device.  These helpers give the JAX result on every device, without a
device allocation per call.
"""

from __future__ import annotations

import numpy as np
import torch

_CONSTANTS: dict = {}


def _const(c: float, like: torch.Tensor) -> torch.Tensor:
    """A 0-dim tensor holding ``c`` on ``like``'s device and dtype, made once
    per (value, dtype, device)."""
    key = (float(c), like.dtype, like.device)
    t = _CONSTANTS.get(key)
    if t is None:
        t = _CONSTANTS[key] = torch.full((), c, dtype=like.dtype, device=like.device)
    return t


def div_const(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as XLA compiles it: ``x`` times the float32 reciprocal of
    float32 ``c`` (a float32 number, so multiplying by it as a Python scalar
    rounds the same on every device)."""
    return x * float(np.float32(1.0) / np.float32(c))


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """``c / x`` as a true quotient (XLA keeps a division of a constant by
    a tensor)."""
    return _const(c, x) / x
