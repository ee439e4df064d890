"""SGM over 2, 4 or 8 paths on the card: the wrappers of ``csrc/sgm.cu``
(K4, K5), ``csrc/sgm_diagonal.cu`` (DG) and ``csrc/sgm_wta.cu`` (K6).

The port of ``ros_gpu_stereo_processor_tpu/ops/sgm_pallas.py`` and its
three TPU kernels, and of the jnp diagonal scans of ``ops/sgm.py``:

  * K4 :func:`cost_and_down` (``_cost_and_down``): the clamped SAD cost
    volume and the down path's excess ``L − C`` in one call; its cost stage
    alone is :func:`cost_volume` (2 paths walk no vertical path);
  * K5 :func:`aggregate` (``_aggregate``): one path direction, forward or
    reverse; given the opposite direction's excess it writes the pair sum;
  * DG :func:`aggregate_diagonal` (``ops/sgm.py::_aggregate_diagonal``, no
    TPU kernel): one diagonal line pair, both directions in one launch,
    written as the pair sum: up to 256 disparities both directions at once,
    half a warp each, beyond that one warp down and back up (the longest
    chain :func:`diagonal_steps`);
  * K6 :func:`wta` (``_wta``): winner-take-all, subpixel step and the
    uniqueness sweep over the total of 2, 4 or 8 paths, ``n·cost`` plus the
    pair sums in order: ``2·cost + exc_h``, ``(4·cost + exc_v) + exc_h``,
    ``(((8·cost + exc_v) + exc_h) + exc_d1) + exc_d2``.

:func:`sgm_fused_raw` chains them: with 4 paths K4, K5 up (pair sum with the
down excess), K5 left→right, K5 right→left (pair sum), K6; with 8 paths the
same and DG twice (dx +1 down with dx −1 up, dx −1 down with dx +1 up)
before K6; with 2 paths K4's cost stage, the two K5 row calls and K6.

Each is the op's one dispatch point: a CUDA tensor launches the kernel, a
CPU tensor runs the ``*_plain`` version beside it.  The volumes are
``(H, W, nd)``, disparity innermost, for the kernels and the plain versions
alike: a walk in any direction then reads nd contiguous values per pixel,
and no transpose is needed (the TPU version transposes the cost volume for
the horizontal pair).  :func:`sgm_fused_raw` with ``return_volumes``
permutes them to the JAX layout ``(nd, H, W)``.

Storage (:func:`storage_dtypes`) is exact, not approximate: with integer
images and integer P1/P2 every cost and excess is an integer, held as
uint16 cost and uint8 (or int16) excess; otherwise everything is float32.
Kernels and plain versions do the same float32 operations in the same
order, so they agree exactly in every storage mode, and on integer input
they equal the JAX oracle (ops/sgm.py, 2, 4 or 8 paths) bit for bit: every
total, at most 8 × 65535 + 8·P2, is an integer below 2^24.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

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
COST = _build.Kernel("sgm_cost", [_P] * 3 + [_I] * 5 + [_F] + [_I] * 2)
AGGREGATE = _build.Kernel("sgm_aggregate", [_P] * 3 + [_I] * 3 + [_F] * 2 + [_I] * 3)
DIAGONAL = _build.Kernel("sgm_aggregate_diagonal", [_P] * 2 + [_I] * 3 + [_F] * 2 + [_I] * 2)
WTA = _build.Kernel("sgm_wta", [_P] * 8 + [_I] * 9)
PATHS = (2, 4, 8)

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


def _images(lf, rf):
    """The cost kernels' image operands: float32, contiguous, one device."""
    if lf.dtype != torch.float32 or rf.dtype != torch.float32:
        raise TypeError("the SGM cost kernel takes float32 images")
    if not rf.is_cuda or rf.device != lf.device:
        raise ValueError("left and right must be on the same CUDA device")
    return lf.contiguous(), rf.contiguous()


def _launch_cost_down(lf, rf, cfg, p1, p2, cost_dtype, exc_dtype, tile_rows: int = 0):
    """Launch K4.  ``tile_rows``: rows per warp strip of the integer-storage
    cost stage (0: automatic; other values are for timing the choice,
    scripts/torch_match_kernels.py)."""
    mode = _MODES[(cost_dtype, exc_dtype)]
    if tile_rows < 0:
        raise ValueError(f"tile_rows={tile_rows} must be >= 0")
    lf, rf = _images(lf, rf)
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
    """Plain version of K4: the cost volume (:func:`cost_volume_plain`), then
    the down walk."""
    cost = _clamped_cost(lf, rf, cfg, p2)
    exc = sgm_ops.path_excess(cost, None, p1, p2, vertical=True, reverse=False)
    return cost.to(cost_dtype), exc.to(exc_dtype)


def cost_volume(
    lf: torch.Tensor,
    rf: torch.Tensor,
    cfg: StereoBMConfig,
    p2: float,
    cost_dtype: torch.dtype,
) -> torch.Tensor:
    """K4's cost stage alone (the 2-path route walks no vertical path):
    PREFILTERED (H, W) images → the clamped (H, W, nd) cost volume in
    ``cost_dtype`` (uint16 for integer images only, as :func:`cost_and_down`),
    the same volume :func:`cost_and_down` returns."""
    if lf.shape != rf.shape or lf.dim() != 2:
        raise ValueError(f"cost_volume wants two (H, W) images; got "
                         f"{tuple(lf.shape)} and {tuple(rf.shape)}")
    if not lf.is_cuda:
        return cost_volume_plain(lf, rf, cfg, p2, cost_dtype)
    if cost_dtype not in (torch.uint16, torch.float32):
        raise TypeError(f"the SGM cost volume is uint16 or float32, not {cost_dtype}")
    lf, rf = _images(lf, rf)
    H, W = lf.shape
    nd = cfg.num_disparities
    cost = torch.empty((H, W, nd), dtype=cost_dtype, device=lf.device)
    with torch.cuda.device(lf.device):
        COST(_build.ptr(lf), _build.ptr(rf), _build.ptr(cost), H, W, nd, cfg.min_disparity,
             cfg.block_radius, sgm_ops.clamp_value(cfg, p2),
             0 if cost_dtype == torch.uint16 else 2, 0)
    return cost


def cost_volume_plain(lf, rf, cfg, p2, cost_dtype):
    """Plain version of K4's cost stage: the cost half of
    :func:`cost_and_down_plain`."""
    return _clamped_cost(lf, rf, cfg, p2).to(cost_dtype)


def _clamped_cost(lf, rf, cfg, p2):
    """The block matcher's cost volume with the clamp, disparity moved
    innermost: (H, W, nd) float32."""
    cost = bm_ops.sad_cost_volume(lf, rf, cfg)
    clampv = torch.full((), sgm_ops.clamp_value(cfg, p2), device=cost.device)
    return torch.where(cost >= BIG, clampv, cost).permute(1, 2, 0).contiguous()


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
# DG: one diagonal line pair
# ---------------------------------------------------------------------------


def aggregate_diagonal(
    cost: torch.Tensor,
    p1: float,
    p2: float,
    dx: int,
    exc_dtype: torch.dtype,
) -> torch.Tensor:
    """The pair sum of two opposite 45° directions over a stored (H, W, nd)
    cost volume, in ``exc_dtype``: the excess ``L − C`` of the diagonal
    ``(dx, forward)`` of ops/sgm.py (rows top to bottom, the carry shifted
    ``dx`` columns a row) plus that of ``(−dx, reverse)``, the same lines
    walked bottom to top.  ``dx`` +1 pairs ↘ with ↖, −1 ↙ with ↗."""
    if cost.dim() != 3:
        raise ValueError(f"aggregate_diagonal wants an (H, W, nd) volume; got "
                         f"{tuple(cost.shape)}")
    if dx not in (1, -1):
        raise ValueError(f"dx={dx} must be 1 or -1")
    if not cost.is_cuda:
        return aggregate_diagonal_plain(cost, p1, p2, dx, exc_dtype)
    mode = _MODES[(cost.dtype, exc_dtype)]
    H, W, nd = cost.shape
    if nd % 16:
        raise ValueError(f"the walk kernel takes a multiple of 16 disparities, not {nd}")
    cost = walk_operand(cost)
    out = torch.empty((H, W, nd), dtype=exc_dtype, device=cost.device)
    with torch.cuda.device(cost.device):
        DIAGONAL(_build.ptr(cost), _build.ptr(out), H, W, nd, float(p1), float(p2), int(dx),
                 mode)
    return out


def diagonal_steps(H: int, W: int, nd: int, cost_dtype: torch.dtype,
                   exc_dtype: torch.dtype) -> int:
    """The longest chain of walk steps in one DG call on an (H, W, nd)
    volume in this storage: min(H, W) where both directions walk at once,
    2·min(H, W) where one warp walks its line down and back up (the walk
    :func:`diagonal_depth` reports as 0).  Asks the built library."""
    return (1 if diagonal_depth(nd, cost_dtype, exc_dtype) else 2) * min(H, W)


def diagonal_depth(nd: int, cost_dtype: torch.dtype, exc_dtype: torch.dtype) -> int:
    """Pixels each half of DG's pair walk stages ahead at ``nd`` disparities
    in this storage: its ring's depth D, and the second visits nearest the
    crossing that its shared-memory handoff serves (0 where nd takes the
    two-pass walk).  Asks the built library (``nvcc`` needed)."""
    fn = _build.library().sgm_diagonal_depth
    fn.argtypes, fn.restype = [_I, _I], _I
    depth = fn(nd, _MODES[(cost_dtype, exc_dtype)])
    if depth < 0:
        raise ValueError(f"no diagonal walk takes {nd} disparities")
    return depth


def aggregate_diagonal_plain(cost, p1, p2, dx, exc_dtype):
    """Plain version of DG: the first direction's excess stored in
    ``exc_dtype``, then the second direction's added to it, as the kernel's
    two passes do."""
    c = cost.float()
    first = sgm_ops.diagonal_excess(c, None, p1, p2, dx, False).to(exc_dtype)
    return sgm_ops.diagonal_excess(c, first.float(), p1, p2, -dx, True).to(exc_dtype)


# ---------------------------------------------------------------------------
# K6: winner-take-all
# ---------------------------------------------------------------------------


def wta(
    cost: torch.Tensor,
    pairs: Sequence[torch.Tensor],
    cfg: StereoBMConfig,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The raw ``(disp_raw, best_cost, excl)`` maps of the aggregated total
    over ``2·len(pairs)`` paths, ``n·cost`` plus the pair sums in order (1e9
    where the right window leaves the image): ``pairs`` is ``(exc_h,)`` for
    2 paths, ``(exc_v, exc_h)`` for 4, ``(exc_v, exc_h, exc_d1, exc_d2)``
    for 8.  The first minimum's disparity (min_disparity − 2 where every
    candidate is masked, as on the TPU), plus the clipped parabolic step
    when ``refine_disparity``; its cost; and the smallest cost outside best
    ± 1 when ``uniqueness_ratio > 0`` (1e9 otherwise)."""
    if cost.dim() != 3:
        raise ValueError(f"wta wants (H, W, nd) volumes; got {tuple(cost.shape)}")
    paths = 2 * len(pairs)
    if paths not in PATHS:
        raise ValueError(f"{len(pairs)} pair volumes: 1, 2 or 4 are needed (2, 4 or 8 paths)")
    for i, e in enumerate(pairs):
        _check_volume(f"pair volume {i}", e, cost)
    if not cost.is_cuda:
        return wta_plain(cost, pairs, cfg)
    if len({e.dtype for e in pairs}) != 1:
        raise TypeError("the pair volumes differ in dtype")
    mode = _MODES[(cost.dtype, pairs[0].dtype)]
    cost = cost.contiguous()
    pairs = [e.contiguous() for e in pairs]
    # the C entry's (exc_v, exc_h, exc_d1, exc_d2), null where a path count has none
    ev, eh, ed1, ed2 = [None, *pairs, None, None] if paths == 2 else [*pairs, None, None][:4]
    H, W, nd = cost.shape
    disp_raw = torch.empty((H, W), dtype=torch.float32, device=cost.device)
    best_cost = torch.empty_like(disp_raw)
    excl = torch.empty_like(disp_raw)
    with torch.cuda.device(cost.device):
        WTA(_build.ptr(cost), *(_P(None) if e is None else _build.ptr(e)
                                for e in (ev, eh, ed1, ed2)),
            _build.ptr(disp_raw), _build.ptr(best_cost), _build.ptr(excl),
            H, W, nd, cfg.min_disparity, cfg.block_radius,
            int(cfg.refine_disparity), int(cfg.uniqueness_ratio > 0), paths, mode)
    return disp_raw, best_cost, excl


def wta_plain(cost, pairs, cfg):
    """Plain version of K6."""
    nd = cost.shape[-1]
    total = _masked_total(cost, pairs, cfg)
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


def _masked_total(cost, pairs, cfg) -> torch.Tensor:
    """(H, W, nd) float32 total over ``2·len(pairs)`` paths, ``n·cost`` plus
    each pair sum in order, 1e9 where the right window leaves the image."""
    W, nd = cost.shape[1:]
    r = cfg.block_radius
    total = float(2 * len(pairs)) * cost.float()
    for e in pairs:
        total = total + e.float()
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
    num_paths: int = 4,
):
    """SGM over ``num_paths`` (2, 4 or 8) on PREFILTERED images: the raw
    ``(disp_raw, best_cost, excl)`` maps before the validity gates, or with
    ``return_volumes`` the cost and the pair volumes (:func:`wta`'s
    ``pairs``) as (nd, H, W) views in their storage dtypes."""
    if num_paths not in PATHS:
        raise ValueError(f"num_paths={num_paths} must be 2, 4 or 8")
    cost_dt, exc_dt = storage_dtypes(cfg, p1, p2, integer_input)
    if num_paths == 2:
        cost, pairs = cost_volume(lf, rf, cfg, p2, cost_dt), []
    else:
        cost, exc_down = cost_and_down(lf, rf, cfg, p1, p2, cost_dt, exc_dt)
        pairs = [aggregate(cost, exc_down, p1, p2, True, True, exc_dt)]   # up + down
    exc_lr = aggregate(cost, None, p1, p2, False, False, exc_dt)
    pairs.append(aggregate(cost, exc_lr, p1, p2, False, True, exc_dt))   # rl + lr
    if num_paths == 8:
        pairs += [aggregate_diagonal(cost, p1, p2, dx, exc_dt) for dx in (1, -1)]
    if return_volumes:
        return tuple(v.permute(2, 0, 1) for v in (cost, *pairs))
    return wta(cost, pairs, cfg)


def compute_disparity_sgm_fused(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoBMConfig = StereoBMConfig(),
    p1: float = 10.0,
    p2: float = 120.0,
    num_paths: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SGM over 2, 4 or 8 paths through the kernels.  Same contract and
    numerics as :func:`ops.sgm.compute_disparity_sgm`: (H, W) mono
    uint8/float images → (disparity float32, valid bool)."""
    integer_input = not (left.is_floating_point() or right.is_floating_point())
    lf = bm_ops.prefilter(left, cfg)
    rf = bm_ops.prefilter(right, cfg)
    if cfg.lr_check:
        # the consistency check needs the whole aggregated volume: the
        # oracle's WTA tail on the assembled total, in plain PyTorch
        vols = [v.permute(1, 2, 0) for v in sgm_fused_raw(
            lf, rf, cfg, p1, p2, integer_input, return_volumes=True, num_paths=num_paths)]
        total = _masked_total(vols[0], vols[1:], cfg).permute(2, 0, 1)
        disp, valid = bm_ops.wta_disparity(total, lf, cfg)
        disp_r = bm_ops.right_disparity_from_cost(total, cfg)
        return bm_ops.apply_lr_check(disp, valid, disp_r, cfg)
    disp_raw, best_cost, excl = sgm_fused_raw(lf, rf, cfg, p1, p2, integer_input,
                                              num_paths=num_paths)
    tex = bm_ops.texture_sum(lf, cfg) if cfg.texture_threshold > 0 else None
    return fused_gates(disp_raw, best_cost, excl, cfg, tex)
