"""Sliding-window bundle adjustment — Gauss–Newton with Schur complement, in
PyTorch.

The port of ``ros_gpu_stereo_processor_tpu/models/ba.py``:

  * fixed-capacity padded window (M poses × N landmarks, observation mask);
    absent observations carry zero weight;
  * residual/Jacobian/Hessian-block assembly as batched einsums over the
    (M, N) observation grid;
  * the reduced camera system (Schur complement over landmarks) is a dense
    (6M, 6M) solve;
  * Huber IRLS re-weighting per iteration, a fixed iteration count;
  * gauge freedom fixed by freezing the first pose.

Solves and inverses are the ``_ex`` variants with ``check_errors=False``:
a singular system gives non-finite values, as ``jnp.linalg`` does, and no
host read.  Float32 matmuls stay at full precision (TF32 off, PyTorch's
default), as the JAX package forces ``"highest"``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ros_gpu_stereo_processor_tpu_torch.utils import lie
from ros_gpu_stereo_processor_tpu_torch.utils.division import div_const, rdiv


class BAProblem(NamedTuple):
    """Padded BA window.  Poses are world→camera: x_c = R x_w + t."""

    R: torch.Tensor        # (M, 3, 3)
    t: torch.Tensor        # (M, 3)
    points: torch.Tensor   # (N, 3) world landmarks
    obs: torch.Tensor      # (M, N, 2) pixel observations
    mask: torch.Tensor     # (M, N) 0/1 observation validity
    fx: float
    cx: float
    cy: float


def reprojection_residuals(p: BAProblem):
    """(M, N, 2) residuals + (M, N, 3) camera-frame points."""
    pc = torch.einsum("mij,nj->mni", p.R, p.points) + p.t[:, None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = p.fx * pc[..., 0] / z + p.cx
    v = p.fx * pc[..., 1] / z + p.cy
    r = torch.stack([u - p.obs[..., 0], v - p.obs[..., 1]], -1)
    return r, pc


def _jacobians(p: BAProblem, pc: torch.Tensor):
    """J wrt pose tangent ξ_m (M,N,2,6) and wrt landmark X_n (M,N,2,3)."""
    X, Y = pc[..., 0], pc[..., 1]
    Z = torch.clamp(pc[..., 2], min=1e-6)
    iz = torch.reciprocal(Z)
    iz2 = iz * iz
    zeros = torch.zeros_like(iz)
    Ju_p = torch.stack([p.fx * iz, zeros, -p.fx * X * iz2], -1)   # (M,N,3) d u/d pc
    Jv_p = torch.stack([zeros, p.fx * iz, -p.fx * Y * iz2], -1)
    Jproj = torch.stack([Ju_p, Jv_p], -2)                         # (M,N,2,3)

    # pose: left-multiplicative se3 on the world→camera pose:
    # d pc/dρ = I, d pc/dω = −[pc]×
    Pskew = lie.hat(pc)                                           # (M,N,3,3)
    J_pose = torch.cat(
        [Jproj, -torch.einsum("mnri,mnij->mnrj", Jproj, Pskew)], -1
    )                                                             # (M,N,2,6)
    # landmark: d pc/dX = R_m
    J_point = torch.einsum("mnri,mij->mnrj", Jproj, p.R)          # (M,N,2,3)
    return J_pose, J_point


def nanmedian(x: torch.Tensor) -> torch.Tensor:
    """Median of the non-NaN values of ``x`` (NaN when there are none), the
    mean of the two middle values for an even count: ``(lo + hi) · 0.5``,
    as ``jnp.nanmedian`` computes it (``torch.nanmedian`` takes the lower
    value, and ``torch.nanquantile``'s interpolation rounds otherwise).
    No host read."""
    flat = x.reshape(-1)
    s = torch.sort(flat).values                    # NaNs sort last
    n = torch.sum(~torch.isnan(flat))
    last = flat.numel() - 1
    lo = torch.take(s, torch.clamp(torch.div(n - 1, 2, rounding_mode="floor"), 0, last))
    hi = torch.take(s, torch.clamp(torch.div(n, 2, rounding_mode="floor"), 0, last))
    return torch.where(n > 0, (lo + hi) * 0.5, torch.nan)


def _robust_weights(r: torch.Tensor, mask: torch.Tensor, huber_px: float):
    """Huber IRLS weights with adaptive gross-outlier rejection: residuals
    beyond max(8·median, 3·huber) are gated out."""
    rn = torch.linalg.norm(r, dim=-1)
    w = torch.where(rn <= huber_px, 1.0, rdiv(huber_px, torch.clamp(rn, min=1e-9)))
    med = nanmedian(torch.where(mask > 0, rn, torch.nan))
    gate = torch.clamp(8.0 * torch.nan_to_num(med, nan=1e9), min=3.0 * huber_px)
    return w * mask * (rn <= gate)


def ba_normal_terms(p: BAProblem, huber_px: float = 3.0):
    """Assemble the GN normal-equation blocks.

    Returns (U (M,6,6), V (N,3,3), W (M,N,6,3), b_p (M,6), b_l (N,3))."""
    r, pc = reprojection_residuals(p)
    J_pose, J_point = _jacobians(p, pc)
    w = _robust_weights(r, p.mask, huber_px)                      # (M,N)
    # points at/behind the camera produce exploding Jacobians — gate them out
    w = w * (pc[..., 2] > 0.05)
    wJp = J_pose * w[..., None, None]
    wJl = J_point * w[..., None, None]

    U = torch.einsum("mnri,mnrj->mij", wJp, J_pose)               # (M,6,6)
    V = torch.einsum("mnri,mnrj->nij", wJl, J_point)              # (N,3,3)
    Wb = torch.einsum("mnri,mnrj->mnij", wJp, J_point)            # (M,N,6,3)
    b_p = torch.einsum("mnri,mnr->mi", wJp, r)                    # (M,6)
    b_l = torch.einsum("mnri,mnr->ni", wJl, r)                    # (N,3)
    return U, V, Wb, b_p, b_l


def eliminate_landmarks(V, Wb, b_p, b_l, damping: float = 1e-4,
                        point_prior: torch.Tensor | None = None):
    """The landmark block's share of the reduced camera system: (V⁻¹ of the
    damped landmark blocks (N,3,3), −Σ_n W V⁻¹ Wᵀ (M,M,6,6), b_p − Σ_n
    W V⁻¹ b_l (M,6)).  The distributed BA sums the last two over landmark
    blocks (parallel/dist_ba.py)."""
    dev, dt = V.device, V.dtype
    eye3 = torch.eye(3, dtype=dt, device=dev)
    # damping relative to each block's scale: an under-observed landmark has
    # a rank-deficient V whose near-zero eigenvalue must be lifted *relative*
    # to the block magnitude or the f32 inverse degenerates
    tr = div_const(torch.diagonal(V, dim1=-2, dim2=-1).sum(-1), 3.0)[:, None, None]
    Vd = V + (damping * (1.0 + tr) + 1e-8) * eye3[None]
    if point_prior is not None:
        Vd = Vd + point_prior[:, None, None] * eye3[None]
    Vinv = torch.linalg.inv_ex(Vd, check_errors=False).inverse   # (N,3,3)

    WVinv = torch.einsum("mnij,njk->mnik", Wb, Vinv)              # (M,N,6,3)
    S_off = -torch.einsum("mnik,lnjk->mlij", WVinv, Wb)           # (M,M,6,6)
    rhs = b_p - torch.einsum("mnik,nk->mi", WVinv, b_l)           # (M,6)
    return Vinv, S_off, rhs


def solve_camera_system(S_off, U, rhs, damping: float = 1e-4,
                        fix_first_pose: bool = True) -> torch.Tensor:
    """dξ (M,6) of the reduced camera system
    S_{mk} = δ_mk (U_m + damping·I) + S_off_{mk}."""
    M = U.shape[0]
    dev, dt = U.device, U.dtype
    S = S_off.clone()
    m = torch.arange(M, device=dev)
    S[m, m] = S[m, m] + (U + damping * torch.eye(6, dtype=dt, device=dev)[None])
    Sd = S.permute(0, 2, 1, 3).reshape(6 * M, 6 * M)
    rhsd = rhs.reshape(-1)
    if fix_first_pose:
        # gauge: hard-eliminate pose 0 (identity rows/cols, zero rhs)
        mask = (torch.arange(6 * M, device=dev) >= 6).to(dt)
        Sd = Sd * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        rhsd = rhsd * mask
    return -torch.linalg.solve_ex(Sd, rhsd, check_errors=False).result.reshape(M, 6)


def back_substitute(Wb, Vinv, b_l, dxi) -> torch.Tensor:
    """dX = −V⁻¹ (b_l + Σ_m W_{mn}ᵀ dξ_m), (N,3)."""
    WtD = torch.einsum("mnij,mi->nj", Wb, dxi)                    # (N,3)
    return -torch.einsum("nij,nj->ni", Vinv, b_l + WtD)


def schur_solve(U, V, Wb, b_p, b_l, damping: float = 1e-4,
                fix_first_pose: bool = True,
                point_prior: torch.Tensor | None = None):
    """Marginalise landmarks, solve the reduced camera system, back-substitute.

    ``point_prior`` (N,): extra diagonal weight per landmark — large values
    freeze landmarks (gauge/scale anchoring, e.g. stereo-triangulated points).
    Returns (dxi (M,6), dX (N,3))."""
    Vinv, S_off, rhs = eliminate_landmarks(V, Wb, b_p, b_l, damping, point_prior)
    dxi = solve_camera_system(S_off, U, rhs, damping, fix_first_pose)
    return dxi, back_substitute(Wb, Vinv, b_l, dxi)


def clip_rows(v: torch.Tensor, max_norm: float = 0.5) -> torch.Tensor:
    """Scale down each row of ``v`` whose norm exceeds ``max_norm``."""
    n = torch.linalg.norm(v, dim=-1, keepdim=True)
    return v * torch.clamp(rdiv(max_norm, torch.clamp(n, min=1e-12)), max=1.0)


def clip_step(dxi: torch.Tensor, dX: torch.Tensor, max_norm: float = 0.5):
    """Trust-region guard: scale down any per-pose/per-point update whose
    norm exceeds ``max_norm``."""
    return clip_rows(dxi, max_norm), clip_rows(dX, max_norm)


def apply_update(p: BAProblem, dxi: torch.Tensor, dX: torch.Tensor) -> BAProblem:
    dR, dt = lie.se3_exp(dxi)
    Rn = torch.einsum("mij,mjk->mik", dR, p.R)
    tn = torch.einsum("mij,mj->mi", dR, p.t) + dt
    return p._replace(R=Rn, t=tn, points=p.points + dX)


def _rms(p: BAProblem) -> torch.Tensor:
    r, _ = reprojection_residuals(p)
    w = p.mask
    return torch.sqrt(torch.sum(torch.sum(r * r, -1) * w) / torch.clamp(torch.sum(w), min=1.0))


def bundle_adjust(
    p: BAProblem,
    iters: int = 10,
    huber_px: float = 3.0,
    damping: float = 1e-4,
    fix_first_pose: bool = True,
    point_prior: torch.Tensor | None = None,
) -> tuple[BAProblem, torch.Tensor]:
    """Run fixed-iteration Gauss–Newton BA.  Returns (refined problem,
    rms history (iters+1,)).

    Monocular reprojection alone leaves global scale free; pass
    ``point_prior`` with large weights on well-triangulated (stereo-depth)
    landmarks to anchor it, as models/slam.py does."""
    hist = []
    for _ in range(iters):
        U, V, Wb, b_p, b_l = ba_normal_terms(p, huber_px)
        dxi, dX = schur_solve(U, V, Wb, b_p, b_l, damping, fix_first_pose, point_prior)
        dxi, dX = clip_step(dxi, dX)
        hist.append(_rms(p))
        p = apply_update(p, dxi, dX)
    hist.append(_rms(p))
    return p, torch.stack(hist)
