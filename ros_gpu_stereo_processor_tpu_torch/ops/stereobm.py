"""SAD block-matching stereo disparity — the plain PyTorch version.

The port of ``ros_gpu_stereo_processor_tpu/ops/stereobm.py``, the
reference's ``cv::cuda::StereoBM`` disparity engine
(src/GPUStereoProcessor.cpp:12-39,264-321) from its published semantics:

  1. XSobel (or normalized-response) prefilter clamped to ±prefilter_cap,
  2. SAD cost volume over a block_size² window for num_disparities candidates,
  3. winner-take-all argmin with texture & uniqueness validity checks,
  4. optional parabolic sub-pixel refinement,

producing true float disparity (invalid = min_disparity − 1).

Window sums are separable shifted adds (:func:`_box_sum`), never a
convolution: on CUDA ``F.conv2d`` runs through cuDNN in TF32 by default,
which is not exact for these sums.  The prefiltered values of an integer
image are small integers held in float32 (a block-15 SAD is at most
62·225 < 2^24), so every summation order gives the same float, and this
module agrees with the JAX oracle and with the fused kernel
(ops/stereobm_kernel.py) bit for bit.

The left-right check (``lr_check``) takes the right image's disparity from
the same left-indexed cost volume (:func:`right_disparity_from_cost`, a
gather where the JAX function scans with a rolled frame) and keeps the
pixels that :func:`left_right_check` confirms; both equal the JAX functions
bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig

BIG = 1e9


# ---------------------------------------------------------------------------
# Prefilters
# ---------------------------------------------------------------------------


def xsobel_prefilter(img: torch.Tensor, cap: int = 31) -> torch.Tensor:
    """Horizontal Sobel response clamped to [0, 2·cap] (neutral = cap).

    OpenCV's PREFILTER_XSOBEL: response
    (p[y-1][x+1]−p[y-1][x-1]) + 2(p[y][x+1]−p[y][x-1]) + (p[y+1][x+1]−p[y+1][x-1]),
    rows replicated at top/bottom, first/last column set to the neutral value.
    """
    x = img.float()
    xp = torch.cat([x[:1], x, x[-1:]], dim=0)
    rows = xp[:-2] + 2.0 * xp[1:-1] + xp[2:]
    d = F.pad(rows[:, 2:] - rows[:, :-2], (1, 1))
    out = torch.clamp(d + cap, 0.0, 2.0 * cap)
    # border columns carry the neutral value
    out[:, 0] = float(cap)
    out[:, -1] = float(cap)
    return out


def normalized_response_prefilter(
    img: torch.Tensor, cap: int = 31, win: int = 9
) -> torch.Tensor:
    """PREFILTER_NORMALIZED_RESPONSE — OpenCV's integer formula
    (``prefilterNorm``, modules/calib3d/src/stereobm.cpp):

        scale_g = (win²/8) · scale_s,  scale_s = (1024 + win²/8) / (2·win²/8)
        val     = (cross·scale_g − winsum·scale_s) >> 10
        out     = clamp(val, −cap, cap) + cap                 ∈ [0, 2·cap]

    where ``cross`` = 4·p + its 4-neighbours and ``winsum`` is the win×win
    box sum, both with replicate (edge-clamped) padding, in int32 with an
    arithmetic shift (floor division)."""
    x = img.to(torch.int32)
    wsz2 = win // 2
    scale_g0 = (win * win) // 8
    scale_s = (1024 + scale_g0) // (scale_g0 * 2)
    scale_g = scale_g0 * scale_s

    def edge_pad(a, p):
        rows = torch.cat([a[:1].expand(p, -1), a, a[-1:].expand(p, -1)], dim=0)
        return torch.cat([rows[:, :1].expand(-1, p), rows,
                          rows[:, -1:].expand(-1, p)], dim=1)

    H, W = x.shape
    xe = edge_pad(x, wsz2)
    winsum = torch.zeros_like(x)
    for i in range(win):
        for j in range(win):
            winsum = winsum + xe[i:i + H, j:j + W]

    xp = edge_pad(x, 1)
    cross = (
        4 * x
        + xp[:-2, 1:-1] + xp[2:, 1:-1]      # up, down (row-clamped)
        + xp[1:-1, :-2] + xp[1:-1, 2:]      # left, right (col-clamped)
    )
    val = torch.div(cross * scale_g - winsum * scale_s, 1024, rounding_mode="floor")
    return torch.clamp(val, -cap, cap).float() + cap


def prefilter(img: torch.Tensor, cfg: StereoBMConfig) -> torch.Tensor:
    if cfg.xsobel:
        return xsobel_prefilter(img, cfg.prefilter_cap)
    return normalized_response_prefilter(img, cfg.prefilter_cap)


# ---------------------------------------------------------------------------
# Cost volume + WTA
# ---------------------------------------------------------------------------


def _box_sum(x: torch.Tensor, block: int) -> torch.Tensor:
    """Sum over a block×block window, zero-padded SAME, over the last two
    dims: separable shifted adds (exact for small-integer float values)."""
    H, W = x.shape[-2:]
    r = block // 2
    xp = F.pad(x, (0, 0, r, r))
    acc = xp[..., 0:H, :]
    for i in range(1, block):
        acc = acc + xp[..., i:i + H, :]
    xp = F.pad(acc, (r, r))
    acc = xp[..., :, 0:W]
    for j in range(1, block):
        acc = acc + xp[..., :, j:j + W]
    return acc


def sad_cost_volume(
    left_f: torch.Tensor,
    right_f: torch.Tensor,
    cfg: StereoBMConfig,
) -> torch.Tensor:
    """(ndisp, H, W) float32 SAD cost volume over prefiltered images.

    cost[d, y, x] = Σ_window |L(y+i, x+j) − R(y+i, x+j−(min_disparity+d))|,
    +∞ (1e9) where the right window would leave the image.
    """
    H, W = left_f.shape
    nd = cfg.num_disparities
    mind = cfg.min_disparity
    r = cfg.block_radius

    max_d = mind + nd - 1
    pad_l = max(0, max_d)
    pad_r = max(0, -mind)
    right_p = F.pad(right_f, (pad_l, pad_r))
    # shifted[d] = right_p[:, pad_l − d : pad_l − d + W]
    starts = torch.arange(pad_l - mind, pad_l - mind - nd, -1,
                          device=left_f.device)
    shifted = right_p.unfold(1, W, 1).index_select(1, starts)   # (H, nd, W)
    diff = (left_f[:, None, :] - shifted).abs().permute(1, 0, 2)
    sad = _box_sum(diff, cfg.block_size)

    d = torch.arange(mind, mind + nd, device=left_f.device)[:, None, None]
    col = torch.arange(W, device=left_f.device)[None, None, :]
    # right window must fit: 0 <= x-d-r and x-d+r <= W-1
    valid = (col - d >= r) & (col - d <= W - 1 - r)
    return torch.where(valid, sad, torch.full((), BIG, device=sad.device))


def texture_sum(left_f: torch.Tensor, cfg: StereoBMConfig) -> torch.Tensor:
    """Σ_window |prefiltered − cap| — the texture-validity statistic."""
    return _box_sum((left_f - cfg.prefilter_cap).abs(), cfg.block_size)


def border_mask(H: int, W: int, r: int, device, row_offset: int = 0,
                total_rows: int | None = None) -> torch.Tensor:
    """Pixels whose full block window fits the image (global row
    coordinates for a row band)."""
    if total_rows is None:
        total_rows = H
    row = torch.arange(H, device=device)[:, None] + row_offset
    col = torch.arange(W, device=device)[None, :]
    return ((row >= r) & (row <= total_rows - 1 - r)
            & (col >= r) & (col <= W - 1 - r))


def wta_disparity(
    cost: torch.Tensor,
    left_f: torch.Tensor | None = None,
    cfg: StereoBMConfig = StereoBMConfig(),
    *,
    tex: torch.Tensor | None = None,
    row_offset: int = 0,
    total_rows: int | None = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all with texture/uniqueness checks and subpixel refine.

    Returns (disparity float32 — absolute, i.e. includes min_disparity —
    and validity mask bool).  Invalid pixels carry min_disparity−1.
    Ties keep the smallest disparity (``argmin`` returns the first minimum).
    A row band passes ``row_offset``/``total_rows`` for the border gate.
    """
    nd, H, W = cost.shape
    mind = cfg.min_disparity
    r = cfg.block_radius

    cbest, best = torch.min(cost, dim=0)

    valid = cbest < BIG
    valid &= border_mask(H, W, r, cost.device, row_offset, total_rows)

    # texture check: Σ_window |prefiltered − cap| must reach the threshold
    if cfg.texture_threshold > 0:
        if tex is None:
            tex = texture_sum(left_f, cfg)
        valid &= tex >= cfg.texture_threshold

    # uniqueness: any cost within ratio outside best±1 invalidates
    if cfg.uniqueness_ratio > 0:
        thresh = cbest * (1.0 + cfg.uniqueness_ratio / 100.0)
        didx = torch.arange(nd, device=cost.device)[:, None, None]
        near = (didx - best[None]).abs() <= 1
        contender = (cost <= thresh[None]) & (~near)
        valid &= ~contender.any(dim=0)

    disp = (best + mind).float()

    if cfg.refine_disparity:
        dm = (best - 1).clamp(0, nd - 1)
        dp = (best + 1).clamp(0, nd - 1)
        cm = cost.gather(0, dm[None])[0]
        cp = cost.gather(0, dp[None])[0]
        disp = disp + _subpixel_delta(best, cbest, cm, cp, nd)

    disp = torch.where(valid, disp, torch.full((), float(mind - 1), device=disp.device))
    return disp, valid


def _subpixel_delta(best, cbest, cm, cp, nd: int) -> torch.Tensor:
    """Parabolic subpixel step through the costs at best−1, best, best+1,
    clipped to ±0.5; 0 at the ends of the range or next to a masked cost."""
    denom = cm + cp - 2.0 * cbest
    zero = torch.zeros((), device=denom.device)
    delta = torch.where(denom > 0, (cm - cp) / (2.0 * denom), zero)
    delta = torch.clamp(delta, -0.5, 0.5)
    interior = (best > 0) & (best < nd - 1) & (cm < BIG) & (cp < BIG)
    return torch.where(interior, delta, zero)


def compute_disparity(
    left: torch.Tensor,
    right: torch.Tensor,
    cfg: StereoBMConfig = StereoBMConfig(),
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full block-matching pass: prefilter → cost volume → WTA.

    Args:
      left/right: (H, W) mono images (uint8 or float).
    Returns:
      (disparity float32 (H, W), valid bool (H, W)).
    """
    lf = prefilter(left, cfg)
    rf = prefilter(right, cfg)
    cost = sad_cost_volume(lf, rf, cfg)
    disp, valid = wta_disparity(cost, lf, cfg)
    if cfg.lr_check:
        disp_r = right_disparity_from_cost(cost, cfg)
        return apply_lr_check(disp, valid, disp_r, cfg)
    return disp, valid


def right_disparity_from_cost(cost: torch.Tensor, cfg: StereoBMConfig) -> torch.Tensor:
    """Right-image WTA disparity from the *left-indexed* cost volume.

    cost[d, y, x] measures L(x) vs R(x − (mind + d)), so the candidates for
    right pixel xr are cost[d, y, xr + mind + d] with that column inside the
    image.  Ties keep the smallest d and only costs below 1e9 count.
    Returns float32 absolute right disparity (mind − 1 where no candidate).
    """
    nd, H, W = cost.shape
    mind = cfg.min_disparity
    pad_l, pad_r = max(0, -mind), max(0, mind + nd)
    padded = F.pad(cost, (pad_l, pad_r), value=BIG)
    d = torch.arange(nd, device=cost.device)[:, None]
    xr = torch.arange(W, device=cost.device)[None, :]
    idx = (xr + d + (mind + pad_l))[:, None, :].expand(nd, H, W)
    best, bestd = torch.min(padded.gather(2, idx), dim=0)
    fill = torch.full((), float(mind - 1), device=cost.device)
    return torch.where(best < BIG, (bestd + mind).float(), fill)


def left_right_check(
    disp_l: torch.Tensor,
    disp_r: torch.Tensor,
    cfg: StereoBMConfig,
    max_diff: int = 1,
) -> torch.Tensor:
    """Left-right consistency: pixel x passes iff round(disp_l[x]) lies in
    the search range and |disp_l[x] − disp_r[x − round(disp_l[x])]| ≤
    max_diff.  The column index wraps at the image edge, as the JAX
    function's ``jnp.roll`` does."""
    W = disp_l.shape[1]
    mind = cfg.min_disparity
    dl = torch.round(disp_l).to(torch.int64)
    in_range = (dl >= mind) & (dl < mind + cfg.num_disparities)
    col = torch.arange(W, device=disp_l.device)[None, :]
    dr_at = disp_r.gather(1, (col - dl) % W)
    return in_range & ((dr_at - disp_l).abs() <= max_diff)


def apply_lr_check(disp, valid, disp_r, cfg: StereoBMConfig):
    """Invalidate the pixels that fail :func:`left_right_check`."""
    valid = valid & left_right_check(disp, disp_r, cfg, cfg.lr_max_diff)
    fill = torch.full((), float(cfg.min_disparity - 1), device=disp.device)
    return torch.where(valid, disp, fill), valid


def valid_window(cfg: StereoBMConfig, height: int, width: int):
    """Rectangle of potentially-valid disparities — the corrected form of the
    reference's DisparityImage valid_window (the *intent* of
    src/GpuSenderDisparity.cpp:29-39, with its swapped-ctor-args bug fixed,
    SURVEY.md §2.12).

    Returns (x_offset, y_offset, width, height).
    """
    border = cfg.block_radius
    left = cfg.num_disparities + cfg.min_disparity + border - 1
    left = max(left, border)
    right = width - 1 - border
    top = border
    bottom = height - 1 - border
    return (left, top, max(0, right - left + 1), max(0, bottom - top + 1))
