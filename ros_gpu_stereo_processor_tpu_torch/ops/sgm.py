"""Semi-global matching (SGM) — the plain PyTorch version.

The port of ``ros_gpu_stereo_processor_tpu/ops/sgm.py`` (the jnp oracle of
the fused SGM kernels): prefilter → SAD cost volume → path aggregation with
small/large jump penalties P1/P2 → winner-take-all, with the block
matcher's gates and optional left-right check.  Each direction's recurrence

    L(p, d) = C(p, d) + min( L(p−r, d),
                             L(p−r, d±1) + P1,
                             min_{d'} L(p−r, d') + P2 ) − min_{d'} L(p−r, d')

is a Python loop along the path axis over (perpendicular slice, nd) planes,
in the JAX function's operation order, so on uint8 input (every cost,
excess and total an integer below 2^24) it equals the JAX oracle bit for
bit.  The pipeline runs this module for 2 and 8 paths on either device, as
the JAX pipeline runs its jnp scans; 4 paths go through the fused kernels
of ops/sgm_kernel.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as bm_ops

BIG = bm_ops.BIG
# carry value that makes the recurrence restart a path exactly:
# min(F, F+P1, F+P2) = F and −min = −F cancel ⇒ L = c
_RESTART = 1e6


def clamp_value(cfg: StereoBMConfig, p2: float) -> float:
    """The cost given to candidates whose right window leaves the image:
    large enough to lose every path minimum, finite so it poisons none."""
    return 2.0 * float(p2) + 255.0 * cfg.block_size**2


def step_excess(prev: torch.Tensor, p1: float, p2: float) -> torch.Tensor:
    """The excess ``best − m`` of one recurrence step.  prev: (..., nd)."""
    m = prev.amin(dim=-1, keepdim=True)
    guard = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([prev[..., 1:], guard], dim=-1)
    dn = torch.cat([guard, prev[..., :-1]], dim=-1)
    best = torch.minimum(torch.minimum(prev, m + p2),
                         torch.minimum(up + p1, dn + p1))
    return best - m


def _step_update(prev: torch.Tensor, cost_slice: torch.Tensor,
                 p1: float, p2: float) -> torch.Tensor:
    # c + (best − m): best − m ≤ P2 is small, so the sum stays precise
    return cost_slice + step_excess(prev, p1, p2)


def path_excess(cost: torch.Tensor, exc_in: Optional[torch.Tensor], p1: float,
                p2: float, vertical: bool, reverse: bool) -> torch.Tensor:
    """The excess ``L − C`` of one path direction over a float32 (H, W, nd)
    volume: down the columns (``vertical``) or along the rows, towards lower
    indices when ``reverse``; plus ``exc_in`` when given.  The carry starts
    at 0 (L₀ = C₀) and each step carries ``c + (best − m)``."""
    axis = 0 if vertical else 1
    seq = cost.movedim(axis, 0)
    ein = None if exc_in is None else exc_in.movedim(axis, 0)
    out = torch.empty_like(seq)
    prev = torch.zeros_like(seq[0])
    order = range(seq.shape[0] - 1, -1, -1) if reverse else range(seq.shape[0])
    for t in order:
        e = step_excess(prev, p1, p2)
        prev = seq[t] + e
        out[t] = e if ein is None else e + ein[t]
    return out.movedim(0, axis)


def _aggregate_diagonal(cost: torch.Tensor, dx: int, reverse: bool,
                        p1: float, p2: float) -> torch.Tensor:
    """Aggregate along a 45° diagonal: walk rows, shifting the carry by
    ``dx`` columns per row.  Vacated carry columns get the path-restart
    value, so image borders behave exactly like path starts (no wrap)."""
    fill = torch.full_like(cost[0, :1], _RESTART)

    def shift_cols(a):
        if dx == 1:
            return torch.cat([fill, a[:-1]], dim=0)
        return torch.cat([a[1:], fill], dim=0)

    H = cost.shape[0]
    order = range(H - 1, -1, -1) if reverse else range(H)
    out = torch.empty_like(cost)
    prev = torch.full_like(cost[0], _RESTART)
    for t in order:
        prev = _step_update(shift_cols(prev), cost[t], p1, p2)
        out[t] = prev
    return out


def compute_disparity_sgm(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoBMConfig = StereoBMConfig(),
    p1: float = 10.0,
    p2: float = 120.0,
    num_paths: int = 4,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """SGM disparity: prefilter → SAD cost volume → 2/4/8-path aggregation →
    WTA (+ texture/border gating, optional subpixel and left-right check,
    as the block matcher).  Same output contract as
    :func:`ops.stereobm.compute_disparity`."""
    if num_paths not in (2, 4, 8):
        raise ValueError("num_paths must be 2, 4 or 8")
    lf = bm_ops.prefilter(left, cfg)
    rf = bm_ops.prefilter(right, cfg)
    cost = bm_ops.sad_cost_volume(lf, rf, cfg)          # (nd, H, W), BIG=invalid
    # invalid candidates would poison the mins along paths: clamp to a large
    # finite penalty, track validity separately
    invalid = cost >= BIG
    clampv = torch.full((), clamp_value(cfg, p2), device=cost.device)
    chw = torch.where(invalid, clampv, cost).movedim(0, -1).contiguous()

    def along(vertical, reverse):       # L = C + excess, one direction
        return chw + path_excess(chw, None, p1, p2, vertical, reverse)

    agg = along(False, False)                   # left→right
    agg = agg + along(False, True)              # right→left
    if num_paths >= 4:
        agg = agg + along(True, False)          # top→bottom
        agg = agg + along(True, True)           # bottom→top
    if num_paths == 8:
        agg = (agg
               + _aggregate_diagonal(chw, 1, False, p1, p2)    # ↘
               + _aggregate_diagonal(chw, -1, False, p1, p2)   # ↙
               + _aggregate_diagonal(chw, 1, True, p1, p2)     # ↗
               + _aggregate_diagonal(chw, -1, True, p1, p2))   # ↖

    big = torch.full((), BIG, device=cost.device)
    cost_agg = torch.where(invalid, big, agg.movedim(-1, 0))   # (nd, H, W)
    disp, valid = bm_ops.wta_disparity(cost_agg, lf, cfg)
    if cfg.lr_check:
        disp_r = bm_ops.right_disparity_from_cost(cost_agg, cfg)
        return bm_ops.apply_lr_check(disp, valid, disp_r, cfg)
    return disp, valid
