"""Disparity visualization — rainbow color mapping on the device.

The port of ``ros_gpu_stereo_processor_tpu/ops/colormap.py``, the
reference's cv::cuda::drawColorDisp (src/GPUStereoProcessor.cpp:323-330):
hue sweeps 240°→0° (blue = far/0 … red = near/ndisp), full saturation and
value; invalid pixels render black.  Output is RGB8.
"""

from __future__ import annotations

import torch


def _select(conds, choices, default):
    """``jnp.select``: the choice of the first true condition."""
    out = default
    for c, v in reversed(list(zip(conds, choices))):
        out = torch.where(c, v, out)
    return out


def colorize_disparity(
    disp: torch.Tensor,
    num_disparities: int,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(H, W) float disparity → (H, W, 3) uint8 rainbow RGB."""
    d = torch.clamp(disp.float(), 0.0, float(num_disparities))
    if valid is None:
        valid = disp > 0
    # hue in degrees: 240 (blue) at d=0 → 0 (red) at d=ndisp.  The divisors
    # are tensors on the device: PyTorch's CUDA division by a Python number
    # multiplies by its rounded reciprocal, which is not the true quotient
    # the CPU and the JAX twin compute (1/60 is inexact)
    def div(x, y: float):
        return x / torch.full((), y, device=x.device)

    h = (1.0 - div(d, float(num_disparities))) * 240.0
    hp = div(h, 60.0)
    i = torch.floor(hp)
    f = hp - i
    q = 1.0 - f
    one = torch.ones_like(f)
    zero = torch.zeros_like(f)
    conds = [i == 0, i == 1, i == 2, i == 3, i == 4]
    # V=S=1 HSV→RGB with t = f
    r = _select(conds, [one, q, zero, zero, f], one)
    g = _select(conds, [f, one, one, q, zero], zero)
    b = _select(conds, [zero, zero, f, one, one], q)
    rgb = torch.stack([r, g, b], dim=-1)
    rgb = torch.where(valid[..., None], rgb, zero[..., None])
    return torch.clamp(rgb * 255.0 + 0.5, 0, 255).to(torch.uint8)
