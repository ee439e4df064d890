"""Speckle labels on the card: the wrapper of ``csrc/speckle.cu``.

The port of ``ros_gpu_stereo_processor_tpu/ops/speckle_pallas.py`` (TPU
kernel ``_propagation_kernel``, launched by ``labels_pallas``).  Component
sizing stays in ops/speckle.py.

:func:`labels` is the op's one dispatch point: a CUDA tensor launches the
kernel, a CPU tensor runs ``ops/speckle.py::_labels_scan``.  The kernel's
labels are bit-identical to the plain version's at the same ``iters``.
"""

from __future__ import annotations

import ctypes

import torch

from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as speckle_plain

KERNEL = _build.Kernel(
    "speckle_labels",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int],
)


def labels(
    disp: torch.Tensor, valid: torch.Tensor, max_diff: float, iters: int
) -> torch.Tensor:
    """(H, W) float32 disparity + bool validity → (H, W) int32 labels: the
    minimum raster index of the pixel's component after ``iters``
    row/column propagation rounds, H·W for invalid pixels."""
    if disp.dim() != 2 or valid.shape != disp.shape:
        raise ValueError(f"labels wants (H, W) disp and valid; got "
                         f"{tuple(disp.shape)} and {tuple(valid.shape)}")
    if not disp.is_cuda:
        return speckle_plain._labels_scan(disp, valid, max_diff, iters)
    return _launch(disp, valid, max_diff, iters)


def _launch(disp: torch.Tensor, valid: torch.Tensor, max_diff: float,
            iters: int) -> torch.Tensor:
    if disp.dtype != torch.float32 or valid.dtype != torch.bool:
        raise TypeError("the label kernel takes float32 disp and bool valid")
    if not valid.is_cuda or valid.device != disp.device:
        raise ValueError("disp and valid must be on the same CUDA device")
    H, W = disp.shape
    if H * W >= 2**31:
        raise ValueError("the label kernel takes images under 2^31 pixels")
    disp = disp.contiguous()
    valid = valid.contiguous()
    lab = torch.empty((H, W), dtype=torch.int32, device=disp.device)
    conn = torch.empty((2, H, W), dtype=torch.uint8, device=disp.device)
    changed = torch.empty(max(int(iters), 1), dtype=torch.int32,
                          device=disp.device)
    with torch.cuda.device(disp.device):
        KERNEL(_build.ptr(disp), _build.ptr(valid), _build.ptr(lab),
               _build.ptr(conn[0]), _build.ptr(conn[1]), _build.ptr(changed),
               H, W, float(max_diff), int(iters))
    return lab
