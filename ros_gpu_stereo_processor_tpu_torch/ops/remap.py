"""Bilinear remap (stereo rectification sampling) — the plain PyTorch version.

The port of ``ros_gpu_stereo_processor_tpu/ops/remap.py``: the reference's
forked ``rectifyImageGPU`` → cv::cuda::remap chain
(src/GPUStereoProcessor.cpp:236-262).  The (undistort ∘ rectify)
source-coordinate maps are precomputed on the host (utils/calib.py).

:func:`remap_bilinear` is the plain version of the remap kernel
(ops/remap_kernel.py, csrc/remap.cu) and runs every float32 operation of
the JAX twin in the same order, so uint8 output agrees exactly.
Out-of-range taps contribute 0 (OpenCV BORDER_CONSTANT).
"""

from __future__ import annotations

import torch


def _int_range(dtype: torch.dtype):
    info = torch.iinfo(dtype)
    return info.min, info.max


def remap_bilinear(img: torch.Tensor, src_map: torch.Tensor) -> torch.Tensor:
    """Sample ``img`` at real-valued source coordinates.

    Args:
      img: (H, W) or (H, W, C) tensor, any real dtype.
      src_map: (H', W', 2) float32 of (x_src, y_src) per destination pixel.

    Returns:
      (H', W'[, C]) tensor of ``img.dtype`` (rounded half to even, then
      clipped, if integral).
    """
    H, W = img.shape[0], img.shape[1]
    chan = img.dim() == 3

    x = src_map[..., 0].float()
    y = src_map[..., 1].float()

    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = x - x0
    fy = y - y0
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)

    flat = img.reshape((H * W,) + tuple(img.shape[2:]))

    def sample(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        idx = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        v = flat[idx].float()
        mask = valid[..., None] if chan else valid
        return torch.where(mask, v, torch.zeros((), device=v.device))

    v00 = sample(y0i, x0i)
    v01 = sample(y0i, x0i + 1)
    v10 = sample(y0i + 1, x0i)
    v11 = sample(y0i + 1, x0i + 1)

    if chan:
        fx = fx[..., None]
        fy = fy[..., None]
    w00 = (1 - fx) * (1 - fy)
    w01 = fx * (1 - fy)
    w10 = (1 - fx) * fy
    w11 = fx * fy
    out = v00 * w00 + v01 * w01 + v10 * w10 + v11 * w11

    if not img.dtype.is_floating_point:
        lo, hi = _int_range(img.dtype)
        out = torch.clamp(torch.round(out), lo, hi)
    return out.to(img.dtype)


def rectify_pair(images: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """Rectify a batched stack: images (S, H, W[, C]) with maps
    (S, H, W, 2) → (S, H, W[, C]), one side at a time."""
    return torch.stack([remap_bilinear(img, m) for img, m in zip(images, maps)])
