"""Disparity bilateral filter — edge-preserving disparity refinement.

The port of ``ros_gpu_stereo_processor_tpu/ops/bilateral.py``.  The
reference declares and parameterises a ``cv::cuda::DisparityBilateralFilter``
but never enables it (a stub: the creation / apply block is commented out at
src/StereoProcessor.cpp:324-335, parameters at cfg/GPU.cfg:21-27); like the
JAX package, this implements the intended component with the same parameter
surface.

An iterated checkerboard relaxation: each pixel may replace its disparity
with one of five candidates — its own value or a 4-neighbour's — choosing
the candidate with the lowest bilateral-weighted truncated-L1 cost over a
(2·radius+1)² guidance window:

  * a pixel is only *touched* when a 4-neighbour disparity jump reaches
    ``edge_disc = max(1, ndisp · edge_threshold)``;
  * candidate cost  C_k = Σ_window  w(q) · min(max_disc, |d(q) − dp_k|),
    ``max_disc = ndisp · max_disc_threshold``;
  * w(q) = valid(q) · exp(−ΔI(q)²/(2·sigma_range²)) · exp(−dist(p,q)/(radius+1)),
    ΔI the max-channel absolute difference of the guidance image;
  * updates alternate over the checkerboard ((x + y + t) even in sub-step
    t ∈ {0, 1}); the outermost 1-pixel frame is never modified.

The operations run in the JAX function's order: the weights are computed
once per offset, the cost sums over the offsets ``dy``-major, and ``argmin``
keeps the lowest index on ties (the centre wins).  Plain torch (the JAX
package has no Pallas kernel here).  ``exp`` is the one operation whose last
bit may differ between XLA and torch, or between the CPU and the card; a
weight that differs in its last bit can flip a near-tie between candidates.
"""

from __future__ import annotations

import math

import torch


def _pad_edge(x: torch.Tensor, r: int) -> torch.Tensor:
    """Replicate the first two axes' edges by ``r``."""
    H, W = x.shape[:2]
    rows = torch.arange(-r, H + r, device=x.device).clamp(0, H - 1)
    cols = torch.arange(-r, W + r, device=x.device).clamp(0, W - 1)
    return x[rows][:, cols]


def _intensity_dist(img: torch.Tensor, shifted: torch.Tensor) -> torch.Tensor:
    """Guidance distance: |ΔI| for mono, max-channel |ΔI| for color."""
    d = (shifted - img).abs()
    if d.ndim == 3:
        d = d.amax(dim=-1)
    return d


def _bilateral_core(
    d: torch.Tensor,
    g: torch.Tensor,
    valid: torch.Tensor,
    *,
    ndisp: int,
    radius: int,
    iters: int,
    edge_threshold: float,
    max_disc_threshold: float,
    sigma_range: float,
    row_offset: int = 0,
    total_rows: int | None = None,
) -> torch.Tensor:
    """Filter body shared by :func:`disparity_bilateral_filter` and the
    row-band filter (parallel/frontend.bilateral_row_sharded).

    ``d`` (H, W) and ``g`` (H, W[, C]) float32; ``valid`` (H, W) float 1/0
    marks real image pixels (taps where it is 0 get zero weight).
    ``row_offset``/``total_rows`` put the border and parity decisions in
    global image rows, so a halo-extended row band computes what the whole
    image would."""
    H, W = d.shape
    dev = d.device
    if total_rows is None:
        total_rows = H
    f32 = torch.float32
    # Python constants meet float32 tensors as JAX's weak types do: rounded
    # to float32 once (filled on the device: no host copy, which a CUDA
    # graph capture refuses)
    edge_disc = torch.full((), max(1.0, float(ndisp) * float(edge_threshold)), dtype=f32,
                           device=dev)
    max_disc = torch.full((), float(ndisp) * float(max_disc_threshold), dtype=f32, device=dev)
    inv_2sr2 = 1.0 / (2.0 * float(sigma_range) * float(sigma_range))

    # spatial weight table: exp(-sqrt(dy²+dx²)/(radius+1)) (OpenCV's
    # calc_space_weighted_filter with dist_space = radius + 1)
    offs = [(dy, dx) for dy in range(-radius, radius + 1)
            for dx in range(-radius, radius + 1)]
    w_space = {(dy, dx): math.exp(-math.sqrt(dy * dy + dx * dx) / (radius + 1.0))
               for (dy, dx) in offs}

    yy = torch.arange(H, device=dev)[:, None] + row_offset     # global row
    xx = torch.arange(W, device=dev)[None, :]
    interior = (yy > 0) & (yy < total_rows - 1) & (xx > 0) & (xx < W - 1)
    parity = (yy + xx) % 2
    active_t = [interior & (((parity + t) % 2) == 0) for t in (0, 1)]

    # the guidance taps' weights do not change between iterations
    gp = _pad_edge(g, radius)
    valid_pad = torch.nn.functional.pad(valid.to(f32), (radius, radius, radius, radius))
    weights = []
    for dy, dx in offs:
        g_s = gp[dy + radius:dy + radius + H, dx + radius:dx + radius + W]
        v_s = valid_pad[dy + radius:dy + radius + H, dx + radius:dx + radius + W]
        di = _intensity_dist(g, g_s)
        weights.append(v_s * torch.exp(-di * di * inv_2sr2) * w_space[(dy, dx)])

    def half_step(d, t):
        # 5 candidates: centre, up, left, down, right (OpenCV's dp[0..4])
        dpad = _pad_edge(d, 1)
        cands = torch.stack([
            d,
            dpad[0:H, 1:W + 1],
            dpad[1:H + 1, 0:W],
            dpad[2:H + 2, 1:W + 1],
            dpad[1:H + 1, 2:W + 2],
        ])
        touched = ((cands[1:] - cands[0]).abs() >= edge_disc).any(dim=0)
        dp = torch.nn.functional.pad(d, (radius, radius, radius, radius))
        cost = torch.zeros((5, H, W), dtype=f32, device=dev)
        for (dy, dx), w in zip(offs, weights):
            d_s = dp[dy + radius:dy + radius + H, dx + radius:dx + radius + W]
            cost = cost + w * torch.minimum(max_disc, (d_s[None] - cands).abs())
        best = cost.argmin(dim=0)          # the lowest index on ties
        new_d = cands.gather(0, best[None])[0]
        return torch.where(active_t[t] & touched, new_d, d)

    for _ in range(int(iters)):
        d = half_step(d, 0)
        d = half_step(d, 1)
    return d


def disparity_bilateral_filter(
    disp: torch.Tensor,
    guide: torch.Tensor,
    *,
    ndisp: int = 64,
    radius: int = 3,
    iters: int = 1,
    edge_threshold: float = 0.1,
    max_disc_threshold: float = 0.2,
    sigma_range: float = 10.0,
) -> torch.Tensor:
    """Refine ``disp`` (H, W) guided by ``guide`` (H, W[, C]) on their device.

    Parameter names and defaults mirror the reference's reconfigure group
    (cfg/GPU.cfg:21-27).  Returns the refined disparity, same shape and
    dtype."""
    if radius < 1:
        raise ValueError(f"radius={radius} must be >= 1")
    H, W = disp.shape
    out = _bilateral_core(
        disp.float(), guide.float(),
        torch.ones((H, W), dtype=torch.float32, device=disp.device),
        ndisp=ndisp, radius=radius, iters=iters, edge_threshold=edge_threshold,
        max_disc_threshold=max_disc_threshold, sigma_range=sigma_range,
    )
    return out.to(disp.dtype)
