"""Fused block matcher on the card: the wrapper of ``csrc/stereobm.cu``.

The port of ``ros_gpu_stereo_processor_tpu/ops/stereobm_pallas.py`` (TPU
kernel ``_make_kernel``, launched by ``fused_raw``).  The kernel turns the
prefiltered images into ``(disp_raw, best_cost, excl)`` without storing the
cost volume; :func:`fused_gates` then applies the border, texture and
uniqueness gates in plain PyTorch, as on the TPU.

:func:`fused_raw` is the op's one dispatch point: a CUDA tensor launches the
kernel, a CPU tensor runs :func:`fused_raw_plain` (the cost volume of
ops/stereobm.py and its argmin).  Both give the same floats (see
ops/stereobm.py on exactness).

With ``lr_check`` the right image's disparity is a second matcher run on
the mirrored, swapped pair, flipped back — the JAX fused path's definition
(not the oracle's shared cost volume), so the port equals the JAX Pallas
path here on either device.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as bm_ops

KERNEL = _build.Kernel("bm_fused", [ctypes.c_void_p] * 5 + [ctypes.c_int] * 8)


def compute_disparity_fused(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoBMConfig = StereoBMConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Prefilter → fused cost/WTA → gates.  Same contract as
    :func:`ops.stereobm.compute_disparity`: (H, W) mono uint8/float images →
    (disparity float32, valid bool)."""
    if cfg.lr_check:
        # the right disparity is a second matcher run on the mirrored,
        # swapped pair (the definition of stereobm_pallas.py's lr_check)
        base = cfg.replace(lr_check=False)
        disp, valid = compute_disparity_fused(left, right, base)
        disp_rm, _ = compute_disparity_fused(right.flip(1), left.flip(1), base)
        return bm_ops.apply_lr_check(disp, valid, disp_rm.flip(1), cfg)
    lf = bm_ops.prefilter(left, cfg)
    rf = bm_ops.prefilter(right, cfg)
    disp_raw, best_cost, excl = fused_raw(lf, rf, cfg)
    tex = bm_ops.texture_sum(lf, cfg) if cfg.texture_threshold > 0 else None
    return fused_gates(disp_raw, best_cost, excl, cfg, tex)


def fused_raw(
    lf: torch.Tensor, rf: torch.Tensor, cfg: StereoBMConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw ``(disp_raw, best_cost, excl)`` maps of PREFILTERED images,
    before the validity gates.  ``excl`` is 1e9 everywhere unless
    ``cfg.uniqueness_ratio > 0``.  The kernel takes every block size and
    disparity range of :class:`StereoBMConfig` (it reads the images from
    device memory and sizes its shared memory to the block); a launch the
    card refuses raises ``RuntimeError`` (CUDA error 1 for shared memory)."""
    if lf.shape != rf.shape or lf.dim() != 2:
        raise ValueError(f"fused_raw wants two (H, W) images; got "
                         f"{tuple(lf.shape)} and {tuple(rf.shape)}")
    if not lf.is_cuda:
        return fused_raw_plain(lf, rf, cfg)
    return _launch(lf, rf, cfg)


def fused_raw_plain(
    lf: torch.Tensor, rf: torch.Tensor, cfg: StereoBMConfig
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain version of the kernel: the whole cost volume, then its argmin
    (first minimum), the costs next to it and the best cost outside it."""
    nd = cfg.num_disparities
    cost = bm_ops.sad_cost_volume(lf, rf, cfg)
    best_cost, best = torch.min(cost, dim=0)
    disp = (best + cfg.min_disparity).float()
    if cfg.refine_disparity:
        cm = cost.gather(0, (best - 1).clamp(0, nd - 1)[None])[0]
        cp = cost.gather(0, (best + 1).clamp(0, nd - 1)[None])[0]
        disp = disp + bm_ops._subpixel_delta(best, best_cost, cm, cp, nd)
    big = torch.full((), bm_ops.BIG, device=cost.device)
    if cfg.uniqueness_ratio > 0:
        didx = torch.arange(nd, device=cost.device)[:, None, None]
        far = (didx - best[None]).abs() > 1
        excl = torch.where(far, cost, big).amin(dim=0)
    else:
        excl = big.expand_as(best_cost).clone()
    return disp, best_cost, excl


def _launch(lf: torch.Tensor, rf: torch.Tensor, cfg: StereoBMConfig, tile_rows: int = 0):
    """Launch K2.  ``tile_rows``: image rows per block (0: the tallest strip
    that still gives every SM enough warps; other values are for timing
    the choice, scripts/torch_match_kernels.py)."""
    if lf.dtype != torch.float32 or rf.dtype != torch.float32:
        raise TypeError("the block-matching kernel takes float32 images")
    if tile_rows < 0:
        raise ValueError(f"tile_rows={tile_rows} must be >= 0")
    if not rf.is_cuda or rf.device != lf.device:
        raise ValueError("left and right must be on the same CUDA device")
    lf = lf.contiguous()
    rf = rf.contiguous()
    H, W = lf.shape
    disp_raw = torch.empty_like(lf)
    best_cost = torch.empty_like(lf)
    excl = torch.empty_like(lf)
    with torch.cuda.device(lf.device):
        KERNEL(_build.ptr(lf), _build.ptr(rf), _build.ptr(disp_raw),
               _build.ptr(best_cost), _build.ptr(excl), H, W,
               cfg.num_disparities, cfg.min_disparity, cfg.block_radius,
               int(cfg.refine_disparity), int(cfg.uniqueness_ratio > 0), tile_rows)
    return disp_raw, best_cost, excl


def fused_gates(
    disp_raw: torch.Tensor,
    best_cost: torch.Tensor,
    excl: torch.Tensor,
    cfg: StereoBMConfig,
    tex: torch.Tensor | None,
    row_offset: int = 0,
    total_rows: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Validity gates on the raw maps (border, texture, uniqueness).  A row
    band gives its first row's image row and the image's height, so that
    its border rows are judged against the whole image."""
    H, W = disp_raw.shape
    valid = best_cost < bm_ops.BIG
    valid &= bm_ops.border_mask(H, W, cfg.block_radius, disp_raw.device,
                                row_offset, total_rows)
    if cfg.texture_threshold > 0:
        valid &= tex >= cfg.texture_threshold
    if cfg.uniqueness_ratio > 0:
        # a contender outside best±1 within the ratio margin kills the match
        thresh = best_cost * (1.0 + cfg.uniqueness_ratio / 100.0)
        valid &= ~(excl <= thresh)
    fill = torch.full((), float(cfg.min_disparity - 1), device=disp_raw.device)
    return torch.where(valid, disp_raw, fill), valid
