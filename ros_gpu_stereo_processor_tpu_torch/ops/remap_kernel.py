"""Rectification remap on the card: the wrapper of ``csrc/remap.cu``.

The port of ``ros_gpu_stereo_processor_tpu/ops/remap_pallas.py`` (TPU kernel
``_kernel``).  :func:`rectify` is the op's one dispatch point: a CUDA tensor
launches the kernel, every side and channel of the stack in one launch (32-bit
indices, so every tensor stays under 2^31 elements); a CPU tensor runs the
plain version, ``ops/remap.py::rectify_pair``.  There is no fallback between
the two.
"""

from __future__ import annotations

import ctypes

import torch

from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import remap as remap_plain

_ARGS = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6
KERNELS = {
    torch.uint8: _build.Kernel("remap_bilinear_u8", _ARGS),
    torch.float32: _build.Kernel("remap_bilinear_f32", _ARGS),
}


def rectify(images: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    """Bilinear remap of a stack: images (S, H_src, W_src[, C]) uint8 or
    float32 with maps (S, H, W, 2) float32 → (S, H, W[, C]) of the input
    dtype (integer output rounded half to even, then clipped)."""
    if images.dim() not in (3, 4) or maps.dim() != 4 or maps.shape[-1] != 2:
        raise ValueError(
            f"rectify wants images (S, H, W[, C]) and maps (S, H, W, 2); got "
            f"{tuple(images.shape)} and {tuple(maps.shape)}")
    if images.shape[0] != maps.shape[0]:
        raise ValueError("images and maps differ in their number of sides")
    if not images.is_cuda:
        return remap_plain.rectify_pair(images, maps)
    return _launch(images, maps)


def _launch(images: torch.Tensor, maps: torch.Tensor) -> torch.Tensor:
    kernel = KERNELS.get(images.dtype)
    if kernel is None:
        raise TypeError(f"remap kernel takes uint8 or float32, not {images.dtype}")
    if not maps.is_cuda or maps.device != images.device:
        raise ValueError("images and maps must be on the same CUDA device")
    if maps.dtype != torch.float32:
        raise TypeError(f"maps must be float32, not {maps.dtype}")
    images = images.contiguous()
    maps = maps.contiguous()
    S, Hs, Ws = images.shape[:3]
    C = images.shape[3] if images.dim() == 4 else 1
    H, W = maps.shape[1:3]
    if max(images.numel(), maps.numel(), S * H * W * C) >= 2**31:
        raise ValueError("the remap kernel takes tensors under 2^31 elements")
    out = torch.empty((S, H, W) + tuple(images.shape[3:]), dtype=images.dtype,
                      device=images.device)
    with torch.cuda.device(images.device):
        kernel(_build.ptr(images), _build.ptr(maps), _build.ptr(out),
               S, Hs, Ws, H, W, C)
    return out
