"""SO(3)/SE(3) Lie-group operations in PyTorch.

The port of ``ros_gpu_stereo_processor_tpu/utils/lie.py``: the pose
primitives of the VO/BA/pose-graph stack (models/vo.py, models/ba.py,
models/posegraph.py).  Conventions:

  * rotations as 3×3 matrices, poses as (R, t) with ``x_world = R @ x + t``;
  * tangent vectors ω ∈ ℝ³ (so3) and ξ = [ρ, ω] ∈ ℝ⁶ (se3, translation first);
  * every function is batched over leading dims and differentiable by
    ``torch.func`` (Taylor branches near θ → 0, with the large branch's
    operands sanitised so that neither branch yields a NaN tangent).
"""

from __future__ import annotations

import torch

from ros_gpu_stereo_processor_tpu_torch.utils.division import div_const

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """ω ∈ ℝ³ → skew-symmetric [ω]× (…, 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], -1),
            torch.stack([wz, z, -wx], -1),
            torch.stack([-wy, wx, z], -1),
        ],
        -2,
    )


_EYE3: dict = {}


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    """I₃ broadcast to W's shape (the identity made once per dtype and
    device)."""
    key = (W.dtype, W.device)
    eye = _EYE3.get(key)
    if eye is None:
        eye = _EYE3[key] = torch.eye(3, dtype=W.dtype, device=W.device)
    return eye.expand(W.shape)


def so3_exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: ω → R (…, 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    a = torch.where(theta2 > _EPS, torch.sin(theta) / theta, 1.0 - div_const(theta2, 6.0))
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - div_const(theta2, 24.0))
    return _eye_like(W) + a * W + b * W2


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """R → ω (…, 3).  Differentiable at the identity: the arctan2 form, with
    the large branch's operand sanitised (a ``where`` over an unsanitised
    ``sqrt(0)`` gives NaN tangents).  Rotations at exactly π are outside
    the domain (the axis is unobservable from the skew part)."""
    # scalars per rotation kept as (…, 1): under torch.func transforms a 0-dim
    # float32 tensor combined with a Python number gets a float64 tangent
    tr = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2])[..., None]
    v = torch.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        -1,
    )                                            # ‖v‖ = 2 sin θ
    vn2 = torch.sum(v * v, dim=-1, keepdim=True)
    small = vn2 < 1e-12
    vn2_safe = torch.where(small, torch.ones_like(vn2), vn2)
    vn_safe = torch.sqrt(vn2_safe)
    theta = torch.atan2(0.5 * vn_safe, 0.5 * (tr - 1.0))
    s_large = theta / vn_safe                    # = θ / (2 sin θ)
    s_small = 0.5 + div_const(vn2, 48.0)         # θ²≈vn²/4 ⇒ θ/(2sinθ)≈½+θ²/12
    return torch.where(small, s_small, s_large) * v


def se3_exp(xi: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """ξ = [ρ, ω] → (R, t)."""
    rho, w = xi[..., :3], xi[..., 3:]
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    theta = torch.sqrt(theta2 + _EPS * _EPS)
    W = hat(w)
    W2 = W @ W
    R = so3_exp(w)
    b = torch.where(theta2 > _EPS, (1.0 - torch.cos(theta)) / theta2, 0.5 - div_const(theta2, 24.0))
    c = torch.where(theta2 > _EPS, (theta - torch.sin(theta)) / (theta2 * theta),
                    1.0 / 6.0 - div_const(theta2, 120.0))
    V = _eye_like(W) + b * W + c * W2
    t = (V @ rho[..., None])[..., 0]
    return R, t


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(R, t) → ξ = [ρ, ω].  Differentiable at the identity (sanitised
    branches)."""
    w = so3_log(R)
    theta2 = torch.sum(w * w, dim=-1, keepdim=True)[..., None]
    small = theta2 < 1e-12
    theta2_safe = torch.where(small, torch.ones_like(theta2), theta2)
    theta_safe = torch.sqrt(theta2_safe)
    W = hat(w)
    W2 = W @ W
    # V^{-1} = I - W/2 + (1/θ² − (1+cosθ)/(2θ sinθ)) W²
    coef_large = 1.0 / theta2_safe - (1.0 + torch.cos(theta_safe)) / (
        2.0 * theta_safe * torch.sin(theta_safe)
    )
    coef_small = 1.0 / 12.0 + div_const(theta2, 720.0)
    coef = torch.where(small, coef_small, coef_large)
    Vinv = _eye_like(W) - 0.5 * W + coef * W2
    rho = (Vinv @ t[..., None])[..., 0]
    return torch.cat([rho, w], dim=-1)


def se3_compose(Ra, ta, Rb, tb):
    """(Ra,ta) ∘ (Rb,tb): apply b then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def se3_inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, pts):
    """Apply pose to (…, N, 3) points."""
    return pts @ R.transpose(-1, -2) + t[..., None, :]
