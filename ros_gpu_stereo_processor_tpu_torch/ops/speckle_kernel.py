"""Speckle labels, sizing and size propagation on the card: the wrappers of
``csrc/speckle.cu``.

The port of ``ros_gpu_stereo_processor_tpu/ops/speckle_pallas.py`` and its
two TPU kernels:

  * K3 :func:`labels` (``_propagation_kernel``, launched by
    ``labels_pallas``): component labels from disparity and validity;
  * K7 :func:`max_propagate` (``_maxprop_kernel``, launched by
    ``max_propagate_pallas``): max-propagation of an int32 field over given
    link masks, the row-sharded speckle filter's size broadcast.

:func:`band_labels` runs K7's rounds in min mode on a given label field: the
band-local label rounds of the row-sharded filter (parallel/frontend.py),
gated by the merge loop's device-side ``done`` flag.  It has its own C
entry and launch counter, so K7's launches are counted apart; a gated
launch counts as a launch.

:func:`sizing` (SZ, no TPU kernel: the JAX package sizes components with
jnp sorts) takes K3's labels to the filtered disparity and validity of the
single-device speckle filter: warp-aggregated int32 counts, then one pass
that keeps and fills.  The row-band filter sizes components its own way
(``parallel/frontend.py::_band_counts``).

Each function is its op's one dispatch point: a CUDA tensor launches the
kernel, a CPU tensor runs the plain version of ops/speckle.py
(``_labels_scan``, ``_max_propagate``, ``_label_rounds``, ``_sizing``).
Kernels and plain versions agree bit for bit (the walks at the same round
count).  On the card each walk is one memset and one cooperative launch
that runs every round, the sizing one memset and two launches; a refused
launch raises.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as speckle_plain

KERNEL = _build.Kernel(
    "speckle_labels",
    [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int, ctypes.c_float,
                             ctypes.c_int],
)
MAXPROP = _build.Kernel("speckle_maxprop", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3)
BAND_LABELS = _build.Kernel("speckle_band_labels", [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3)
SIZING = _build.Kernel("speckle_sizing", [ctypes.c_void_p] * 6 + [ctypes.c_int, ctypes.c_int,
                                                                  ctypes.c_float])


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


def sizing(disp: torch.Tensor, valid: torch.Tensor, lab: torch.Tensor,
           max_speckle_size: int, fill_value: float) -> tuple[torch.Tensor, torch.Tensor]:
    """SZ: (H, W) float32 disparity, bool validity and K3's int32 labels
    (H·W where invalid, and never where valid) → (the disparity with every
    pixel of a component of at most ``max_speckle_size`` pixels, and every
    invalid one, set to ``fill_value``; the bool validity of what is kept).
    A component's size counts every pixel that carries its label."""
    if disp.dim() != 2 or valid.shape != disp.shape or lab.shape != disp.shape:
        raise ValueError(f"sizing wants (H, W) disp, valid and labels; got "
                         f"{tuple(disp.shape)}, {tuple(valid.shape)} and {tuple(lab.shape)}")
    if not disp.is_cuda:
        return speckle_plain._sizing(disp, valid, lab, max_speckle_size, fill_value)
    if disp.dtype != torch.float32 or valid.dtype != torch.bool or lab.dtype != torch.int32:
        raise TypeError("the sizing kernel takes float32 disp, bool valid and int32 labels")
    if not (valid.is_cuda and lab.is_cuda and valid.device == disp.device == lab.device):
        raise ValueError("disp, valid and labels must be on the same CUDA device")
    n = disp.numel()
    if n >= 2**31:
        raise ValueError("the sizing kernel takes images under 2^31 pixels")
    disp, valid, lab = disp.contiguous(), valid.contiguous(), lab.contiguous()
    counts = torch.empty(n, dtype=torch.int32, device=disp.device)
    out = torch.empty_like(disp)
    keep = torch.empty_like(valid)
    # a count lies in [1, n]: any T past that range decides as its end does
    T = min(max(int(max_speckle_size), -1), n)
    with torch.cuda.device(disp.device):
        SIZING(_build.ptr(disp), _build.ptr(valid), _build.ptr(lab), _build.ptr(counts),
               _build.ptr(out), _build.ptr(keep), n, T, float(fill_value))
    return out, keep


def max_propagate(field: torch.Tensor, conn_x: torch.Tensor, conn_y: torch.Tensor,
                  iters: int) -> torch.Tensor:
    """K7: (H, W) int32 ``field`` with bool ``conn_x``/``conn_y`` (pixel
    linked to its left / upper neighbour) → (H, W) int32, every run of
    linked pixels given its maximum by up to ``iters`` row/column rounds,
    stopping once a round changes nothing."""
    _check_propagate(field, conn_x, conn_y)
    if not field.is_cuda:
        return speckle_plain._max_propagate(field, conn_x, conn_y, iters)
    return _launch_propagate(MAXPROP, field, conn_x, conn_y, iters)


def band_labels(lab: torch.Tensor, conn_x: torch.Tensor, conn_y: torch.Tensor,
                rounds: int, done: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``rounds`` row/column min-propagation rounds of a given (H, W) int32
    label field over bool link masks.  ``done``: None, or a 0-d int32 flag on
    the field's device; where it is nonzero the result is a copy of ``lab``
    and no round runs.  The kernel reads the flag on the device (no host
    read, so the call captures into a CUDA graph); the plain version reads
    it in Python."""
    _check_propagate(lab, conn_x, conn_y)
    if done is not None and (done.dtype != torch.int32 or done.numel() != 1
                             or done.device != lab.device):
        raise ValueError(f"done must be one int32 on {lab.device}; got {done.dtype} "
                         f"{tuple(done.shape)} on {done.device}")
    if not lab.is_cuda:
        return speckle_plain._label_rounds(lab, conn_x, conn_y, rounds, done)
    return _launch_propagate(BAND_LABELS, lab, conn_x, conn_y, rounds,
                             None if done is None else _build.ptr(done))


def _check_propagate(field, conn_x, conn_y) -> None:
    if field.dim() != 2 or conn_x.shape != field.shape or conn_y.shape != field.shape:
        raise ValueError(f"propagation wants (H, W) field and masks; got "
                         f"{tuple(field.shape)}, {tuple(conn_x.shape)}, "
                         f"{tuple(conn_y.shape)}")
    if field.dtype != torch.int32 or conn_x.dtype != torch.bool or conn_y.dtype != torch.bool:
        raise TypeError("propagation takes an int32 field and bool masks")


def _launch_propagate(kernel: _build.Kernel, field: torch.Tensor, conn_x: torch.Tensor,
                      conn_y: torch.Tensor, iters: int, *gate) -> torch.Tensor:
    """One call of K7 or the band label rounds; ``gate``: the band label
    rounds' ``done`` pointer (None for no gate)."""
    if not (conn_x.is_cuda and conn_y.is_cuda
            and conn_x.device == field.device == conn_y.device):
        raise ValueError("field and masks must be on the same CUDA device")
    H, W = field.shape
    if H * W >= 2**31:
        raise ValueError("the propagation kernel takes fields under 2^31 pixels")
    field, conn_x, conn_y = field.contiguous(), conn_x.contiguous(), conn_y.contiguous()
    out = torch.empty_like(field)
    changed = torch.empty(max(int(iters), 1), dtype=torch.int32, device=field.device)
    with torch.cuda.device(field.device):
        kernel(_build.ptr(field), _build.ptr(out), _build.ptr(conn_x), _build.ptr(conn_y),
               _build.ptr(changed), *gate, H, W, int(iters))
    return out
