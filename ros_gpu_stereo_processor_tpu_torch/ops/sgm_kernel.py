"""Fused 4-path SGM on the card: the wrappers of ``csrc/sgm.cu``.

The port of ``ros_gpu_stereo_processor_tpu/ops/sgm_pallas.py`` and its
three TPU kernels:

  * K4 :func:`cost_and_down` (``_cost_and_down``): the clamped SAD cost
    volume and the down path's excess ``L − C`` in one call;
  * K5 :func:`aggregate` (``_aggregate``): one path direction, forward or
    reverse; given the opposite direction's excess it writes the pair sum;
  * K6 :func:`wta` (``_wta``): winner-take-all, subpixel step and the
    uniqueness sweep over ``total = (4·cost + exc_v) + exc_h``.

:func:`sgm_fused_raw` chains them: K4, K5 up (pair sum with the down
excess), K5 left→right, K5 right→left (pair sum), K6.

Each of the three is the op's one dispatch point: a CUDA tensor launches
the kernel, a CPU tensor runs the ``*_plain`` version beside it.  The
volumes are ``(H, W, nd)``, disparity innermost, for the kernels and the
plain versions alike: a walk in any direction then reads nd contiguous
values per pixel, and no transpose is needed (the TPU version transposes
the cost volume for the horizontal pair).  :func:`sgm_fused_raw` with
``return_volumes`` permutes them to the JAX layout ``(nd, H, W)``.

Storage (:func:`storage_dtypes`) is exact, not approximate: with integer
images and integer P1/P2 every cost and excess is an integer, held as
uint16 cost and uint8 (or int16) excess; otherwise everything is float32.
Kernels and plain versions do the same float32 operations in the same
order, so they agree exactly in every storage mode, and on integer input
they equal the JAX oracle (ops/sgm.py, 4 paths) bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import sgm as sgm_ops
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as bm_ops
from ros_gpu_stereo_processor_tpu_torch.ops.stereobm_kernel import fused_gates

BIG = bm_ops.BIG
_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
COST_DOWN = _build.Kernel("sgm_cost_down", [_P] * 4 + [_I] * 5 + [_F] * 3 + [_I] * 2)
AGGREGATE = _build.Kernel("sgm_aggregate", [_P] * 3 + [_I] * 3 + [_F] * 2 + [_I] * 3)
WTA = _build.Kernel("sgm_wta", [_P] * 6 + [_I] * 8)

# storage mode of the C entry points: (cost dtype, excess dtype) → mode
_MODES = {
    (torch.uint16, torch.uint8): 0,
    (torch.uint16, torch.int16): 1,
    (torch.float32, torch.float32): 2,
}


def storage_dtypes(cfg: StereoBMConfig, p1: float, p2: float,
                   integer_input: bool) -> Tuple[torch.dtype, torch.dtype]:
    """(cost dtype, excess dtype) of the stored volumes.

    uint16 cost when the images are integer, P1 and P2 non-negative
    integers and the clamp value ≤ 65535; then uint8 excess when a pair sum
    (≤ 2·P2) fits 255, int16 when it fits 32767.  Otherwise float32 for
    both.  (The TPU version stores the same ranges biased into signed
    types, because its compiler lowers only signed casts.)"""
    if (integer_input
            and float(p1).is_integer() and float(p2).is_integer()
            and p1 >= 0 and p2 >= 0
            and sgm_ops.clamp_value(cfg, p2) <= 65535.0):
        if 2.0 * p2 <= 255.0:
            return torch.uint16, torch.uint8
        if 2.0 * p2 <= 32767.0:
            return torch.uint16, torch.int16
    return torch.float32, torch.float32


def _check_volume(name: str, v: torch.Tensor, like: torch.Tensor) -> None:
    if v.shape != like.shape or v.device != like.device:
        raise ValueError(f"{name}: a {tuple(like.shape)} volume on {like.device} "
                         f"is needed, not {tuple(v.shape)} on {v.device}")


# ---------------------------------------------------------------------------
# K4: cost volume + down path
# ---------------------------------------------------------------------------


def cost_and_down(
    lf: torch.Tensor,
    rf: torch.Tensor,
    cfg: StereoBMConfig,
    p1: float,
    p2: float,
    cost_dtype: torch.dtype,
    exc_dtype: torch.dtype,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """PREFILTERED (H, W) images → the clamped cost volume and the down
    path's excess, both (H, W, nd) in the given storage dtypes.  uint16
    cost is for integer images only (:func:`storage_dtypes`): the kernel's
    cost stage then slides its window sums, exact for integers; float32
    storage sums in the plain version's order."""
    if lf.shape != rf.shape or lf.dim() != 2:
        raise ValueError(f"cost_and_down wants two (H, W) images; got "
                         f"{tuple(lf.shape)} and {tuple(rf.shape)}")
    if not lf.is_cuda:
        return cost_and_down_plain(lf, rf, cfg, p1, p2, cost_dtype, exc_dtype)
    return _launch_cost_down(lf, rf, cfg, p1, p2, cost_dtype, exc_dtype)


def _launch_cost_down(lf, rf, cfg, p1, p2, cost_dtype, exc_dtype, tile_rows: int = 0):
    """Launch K4.  ``tile_rows``: rows per warp strip of the integer-storage
    cost stage (0: automatic; other values are for timing the choice,
    scripts/torch_match_kernels.py)."""
    mode = _MODES[(cost_dtype, exc_dtype)]
    if tile_rows < 0:
        raise ValueError(f"tile_rows={tile_rows} must be >= 0")
    if lf.dtype != torch.float32 or rf.dtype != torch.float32:
        raise TypeError("the SGM cost kernel takes float32 images")
    if not rf.is_cuda or rf.device != lf.device:
        raise ValueError("left and right must be on the same CUDA device")
    lf, rf = lf.contiguous(), rf.contiguous()
    H, W = lf.shape
    nd = cfg.num_disparities
    cost = torch.empty((H, W, nd), dtype=cost_dtype, device=lf.device)
    exc = torch.empty((H, W, nd), dtype=exc_dtype, device=lf.device)
    with torch.cuda.device(lf.device):
        COST_DOWN(_build.ptr(lf), _build.ptr(rf), _build.ptr(cost), _build.ptr(exc),
                  H, W, nd, cfg.min_disparity, cfg.block_radius,
                  sgm_ops.clamp_value(cfg, p2), float(p1), float(p2), mode, tile_rows)
    return cost, exc


def cost_and_down_plain(lf, rf, cfg, p1, p2, cost_dtype, exc_dtype):
    """Plain version of K4: the block matcher's cost volume with the clamp,
    disparity moved innermost, then the down walk."""
    cost = bm_ops.sad_cost_volume(lf, rf, cfg)
    clampv = torch.full((), sgm_ops.clamp_value(cfg, p2), device=cost.device)
    cost = torch.where(cost >= BIG, clampv, cost).permute(1, 2, 0).contiguous()
    exc = sgm_ops.path_excess(cost, None, p1, p2, vertical=True, reverse=False)
    return cost.to(cost_dtype), exc.to(exc_dtype)


# ---------------------------------------------------------------------------
# K5: one path direction
# ---------------------------------------------------------------------------


def aggregate(
    cost: torch.Tensor,
    exc_in: Optional[torch.Tensor],
    p1: float,
    p2: float,
    vertical: bool,
    reverse: bool,
    exc_dtype: torch.dtype,
) -> torch.Tensor:
    """One path direction over a stored (H, W, nd) cost volume: down the
    columns (``vertical``) or along the rows, towards lower indices when
    ``reverse``.  Returns the excess ``L − C`` in ``exc_dtype``, plus
    ``exc_in`` when given (the pair sum of two opposite directions)."""
    if cost.dim() != 3:
        raise ValueError(f"aggregate wants an (H, W, nd) volume; got {tuple(cost.shape)}")
    if exc_in is not None:
        _check_volume("exc_in", exc_in, cost)
        if exc_in.dtype != exc_dtype:
            raise TypeError(f"exc_in is {exc_in.dtype}, not {exc_dtype}")
    if not cost.is_cuda:
        return aggregate_plain(cost, exc_in, p1, p2, vertical, reverse, exc_dtype)
    mode = _MODES[(cost.dtype, exc_dtype)]
    H, W, nd = cost.shape
    if nd % 16:
        raise ValueError(f"the walk kernel takes a multiple of 16 disparities, not {nd}")
    cost = walk_operand(cost)
    out = torch.empty((H, W, nd), dtype=exc_dtype, device=cost.device)
    if exc_in is not None:
        exc_in = walk_operand(exc_in)
    exc_ptr = _P(None) if exc_in is None else _build.ptr(exc_in)
    with torch.cuda.device(cost.device):
        AGGREGATE(_build.ptr(cost), exc_ptr, _build.ptr(out), H, W, nd,
                  float(p1), float(p2), int(vertical), int(reverse), mode)
    return out


def walk_operand(t: torch.Tensor) -> torch.Tensor:
    """``t`` contiguous and starting on a 16-byte boundary, as the walk
    kernel's 16-byte copies need: a view that starts off one is copied."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def aggregate_plain(cost, exc_in, p1, p2, vertical, reverse, exc_dtype):
    """Plain version of K5."""
    exc_in = None if exc_in is None else exc_in.float()
    return sgm_ops.path_excess(cost.float(), exc_in, p1, p2, vertical, reverse).to(exc_dtype)


# ---------------------------------------------------------------------------
# K6: winner-take-all
# ---------------------------------------------------------------------------


def wta(
    cost: torch.Tensor,
    exc_v: torch.Tensor,
    exc_h: torch.Tensor,
    cfg: StereoBMConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw ``(disp_raw, best_cost, excl)`` maps of the aggregated total
    ``(4·cost + exc_v) + exc_h`` (1e9 where the right window leaves the
    image): the first minimum's disparity (min_disparity − 2 where every
    candidate is masked, as on the TPU), plus the clipped parabolic step
    when ``refine_disparity``; its cost; and the smallest cost outside
    best ± 1 when ``uniqueness_ratio > 0`` (1e9 otherwise)."""
    if cost.dim() != 3:
        raise ValueError(f"wta wants (H, W, nd) volumes; got {tuple(cost.shape)}")
    _check_volume("exc_v", exc_v, cost)
    _check_volume("exc_h", exc_h, cost)
    if not cost.is_cuda:
        return wta_plain(cost, exc_v, exc_h, cfg)
    if exc_h.dtype != exc_v.dtype:
        raise TypeError("exc_v and exc_h differ in dtype")
    mode = _MODES[(cost.dtype, exc_v.dtype)]
    cost, exc_v, exc_h = cost.contiguous(), exc_v.contiguous(), exc_h.contiguous()
    H, W, nd = cost.shape
    disp_raw = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    best_cost = torch.empty_like(disp_raw)
    excl = torch.empty_like(disp_raw)
    with torch.cuda.device(cost.device):
        WTA(_build.ptr(cost), _build.ptr(exc_v), _build.ptr(exc_h),
            _build.ptr(disp_raw), _build.ptr(best_cost), _build.ptr(excl),
            H, W, nd, cfg.min_disparity, cfg.block_radius,
            int(cfg.refine_disparity), int(cfg.uniqueness_ratio > 0), mode)
    return disp_raw, best_cost, excl


def wta_plain(cost, exc_v, exc_h, cfg):
    """Plain version of K6."""
    nd = cost.shape[-1]
    total = _masked_total(cost, exc_v, exc_h, cfg)
    best_cost, best = torch.min(total, dim=-1)
    none = torch.full((), -2, dtype=best.dtype, device=best.device)
    best = torch.where(best_cost < BIG, best, none)
    disp = (best + cfg.min_disparity).float()
    if cfg.refine_disparity:
        cm = total.gather(-1, (best - 1).clamp(0, nd - 1)[..., None])[..., 0]
        cp = total.gather(-1, (best + 1).clamp(0, nd - 1)[..., None])[..., 0]
        disp = disp + bm_ops._subpixel_delta(best, best_cost, cm, cp, nd)
    big = torch.full((), BIG, device=cost.device)
    if cfg.uniqueness_ratio > 0:
        far = (torch.arange(nd, device=cost.device) - best[..., None]).abs() > 1
        excl = torch.where(far, total, big).amin(dim=-1)
    else:
        excl = big.expand_as(best_cost).clone()
    return disp, best_cost, excl


def _masked_total(cost, exc_v, exc_h, cfg) -> torch.Tensor:
    """(H, W, nd) float32 ``(4·cost + exc_v) + exc_h``, 1e9 where the right
    window leaves the image."""
    W, nd = cost.shape[1:]
    r = cfg.block_radius
    total = (4.0 * cost.float() + exc_v.float()) + exc_h.float()
    d = torch.arange(nd, device=cost.device)[None, :] + cfg.min_disparity
    col = torch.arange(W, device=cost.device)[:, None]
    ok = (col - d >= r) & (col - d <= W - 1 - r)                  # (W, nd)
    return torch.where(ok, total, torch.full((), BIG, device=cost.device))


# ---------------------------------------------------------------------------
# The fused path
# ---------------------------------------------------------------------------


def sgm_fused_raw(
    lf: torch.Tensor,
    rf: torch.Tensor,
    cfg: StereoBMConfig,
    p1: float,
    p2: float,
    integer_input: bool = True,
    return_volumes: bool = False,
):
    """The fused 4-path SGM on PREFILTERED images: the raw
    ``(disp_raw, best_cost, excl)`` maps before the validity gates, or with
    ``return_volumes`` the ``(cost, exc_v, exc_h)`` volumes as (nd, H, W)
    views in their storage dtypes (stored unbiased)."""
    cost_dt, exc_dt = storage_dtypes(cfg, p1, p2, integer_input)
    cost, exc_down = cost_and_down(lf, rf, cfg, p1, p2, cost_dt, exc_dt)
    exc_v = aggregate(cost, exc_down, p1, p2, True, True, exc_dt)      # up + down
    exc_lr = aggregate(cost, None, p1, p2, False, False, exc_dt)
    exc_h = aggregate(cost, exc_lr, p1, p2, False, True, exc_dt)       # rl + lr
    if return_volumes:
        return tuple(v.permute(2, 0, 1) for v in (cost, exc_v, exc_h))
    return wta(cost, exc_v, exc_h, cfg)


def compute_disparity_sgm_fused(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoBMConfig = StereoBMConfig(),
    p1: float = 10.0,
    p2: float = 120.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused 4-path SGM.  Same contract and numerics as
    :func:`ops.sgm.compute_disparity_sgm` with ``num_paths=4``: (H, W) mono
    uint8/float images → (disparity float32, valid bool)."""
    integer_input = not (left.is_floating_point() or right.is_floating_point())
    lf = bm_ops.prefilter(left, cfg)
    rf = bm_ops.prefilter(right, cfg)
    if cfg.lr_check:
        # the consistency check needs the whole aggregated volume: the
        # oracle's WTA tail on the assembled total, in plain PyTorch
        cost, exc_v, exc_h = sgm_fused_raw(lf, rf, cfg, p1, p2, integer_input,
                                           return_volumes=True)
        total = _masked_total(*(v.permute(1, 2, 0) for v in (cost, exc_v, exc_h)),
                              cfg).permute(2, 0, 1)
        disp, valid = bm_ops.wta_disparity(total, lf, cfg)
        disp_r = bm_ops.right_disparity_from_cost(total, cfg)
        return bm_ops.apply_lr_check(disp, valid, disp_r, cfg)
    disp_raw, best_cost, excl = sgm_fused_raw(lf, rf, cfg, p1, p2, integer_input)
    tex = bm_ops.texture_sum(lf, cfg) if cfg.texture_threshold > 0 else None
    return fused_gates(disp_raw, best_cost, excl, cfg, tex)
