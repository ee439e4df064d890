"""Disparity → 3-D reprojection and point-cloud packing on the device.

The port of ``ros_gpu_stereo_processor_tpu/ops/reproject.py``: the
reference's GPU ``projectDisparityImageTo3dGPU``
(src/GPUStereoProcessor.cpp:332-346) and its PointCloud2 sender's per-pixel
CPU packing loop (src/GpuSenderPc2.cpp:43-71).  Reprojection is
[X Y Z W]ᵀ = Q·[u v d 1]ᵀ per pixel; invalid points (invalid disparity, or
W ≤ 1e-12) are NaN, the reference's MISSING_Z convention.

``pack_rgb_float`` returns 0x00RRGGBB bit patterns viewed as float32: most
are denormals, so compare them through ``.view(torch.int32)``, never by
value.
"""

from __future__ import annotations

import torch


def reproject_disparity(
    disp: torch.Tensor,
    Q: torch.Tensor,
    valid: torch.Tensor | None = None,
) -> torch.Tensor:
    """(H, W) float disparity + (4, 4) Q → (H, W, 3) float32 XYZ (NaN invalid)."""
    H, W = disp.shape
    Q = Q.to(device=disp.device, dtype=torch.float32)
    u = torch.arange(W, dtype=torch.float32, device=disp.device).expand(H, W)
    v = torch.arange(H, dtype=torch.float32, device=disp.device)[:, None].expand(H, W)
    d = disp.float()

    X = Q[0, 0] * u + Q[0, 1] * v + Q[0, 2] * d + Q[0, 3]
    Y = Q[1, 0] * u + Q[1, 1] * v + Q[1, 2] * d + Q[1, 3]
    Z = Q[2, 0] * u + Q[2, 1] * v + Q[2, 2] * d + Q[2, 3]
    Wh = Q[3, 0] * u + Q[3, 1] * v + Q[3, 2] * d + Q[3, 3]

    ok = Wh > 1e-12
    if valid is not None:
        ok &= valid
    nan = torch.full((), float("nan"), device=disp.device)
    inv_w = torch.where(ok, 1.0 / torch.where(ok, Wh, torch.ones_like(Wh)), nan)
    xyz = torch.stack([X * inv_w, Y * inv_w, Z * inv_w], dim=-1)
    return torch.where(ok[..., None], xyz, nan)


def pack_rgb_float(rgb: torch.Tensor) -> torch.Tensor:
    """(H, W, 3) uint8 RGB → (H, W) float32 with PointCloud2 packed-RGB bit
    layout (0x00RRGGBB reinterpreted as float) — the wire format the
    reference's Pc2 sender writes per pixel (src/GpuSenderPc2.cpp:57-66)."""
    r = rgb[..., 0].to(torch.int32)
    g = rgb[..., 1].to(torch.int32)
    b = rgb[..., 2].to(torch.int32)
    packed = (r << 16) | (g << 8) | b
    return packed.view(torch.float32)


def point_cloud(
    disp: torch.Tensor,
    Q: torch.Tensor,
    rgb: torch.Tensor | None = None,
    valid: torch.Tensor | None = None,
) -> dict:
    """Organized point cloud: {'xyz': (H,W,3) f32 NaN-invalid,
    'rgb': (H,W) f32 packed} — the device-side contents of an organized
    PointCloud2 (is_dense=False)."""
    xyz = reproject_disparity(disp, Q, valid)
    out = {"xyz": xyz}
    if rgb is not None:
        out["rgb"] = pack_rgb_float(rgb)
    return out
