"""Pose-graph optimisation over SE(3) — the SLAM backend's global layer, in
PyTorch.

The port of ``ros_gpu_stereo_processor_tpu/models/posegraph.py``: up to M
nodes and E edges.  Each edge (i → j) carries a measured relative pose T_ij
(pose of j in i's frame) and a scalar information weight (0 disables the
edge).  Residual per edge:

    r_e = log( T_ijᵐᵉᵃˢ⁻¹ · T_i⁻¹ · T_j ) ∈ ℝ⁶

Gauss–Newton with forward-mode Jacobians (``torch.func.jacfwd`` over the
stacked tangent, where the JAX package takes ``jax.jacfwd``; the dense
(6E × 6M) Jacobian and 6M×6M normal system are small), node 0 fixed as the
gauge, a fixed iteration count.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ros_gpu_stereo_processor_tpu_torch.utils import lie
from ros_gpu_stereo_processor_tpu_torch.utils.division import rdiv


class PoseGraph(NamedTuple):
    R: torch.Tensor        # (M, 3, 3) node rotations (world←node)
    t: torch.Tensor        # (M, 3)
    edge_i: torch.Tensor   # (E,) int source node
    edge_j: torch.Tensor   # (E,) int target node
    R_meas: torch.Tensor   # (E, 3, 3) measured R_ij
    t_meas: torch.Tensor   # (E, 3)
    weight: torch.Tensor   # (E,) ≥0; 0 disables the edge


def edge_residuals(g: PoseGraph, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """(E, 6) se3 residuals."""
    ei, ej = g.edge_i.to(torch.int64), g.edge_j.to(torch.int64)
    Ri, ti, Rj, tj = R[ei], t[ei], R[ej], t[ej]
    # T_i⁻¹ T_j
    Rij = torch.einsum("eji,ejk->eik", Ri, Rj)          # Riᵀ Rj
    tij = torch.einsum("eji,ej->ei", Ri, tj - ti)
    # T_meas⁻¹ · (T_i⁻¹ T_j)
    Re = torch.einsum("eji,ejk->eik", g.R_meas, Rij)
    te = torch.einsum("eji,ej->ei", g.R_meas, tij - g.t_meas)
    return lie.se3_log(Re, te)


def _retract(xi: torch.Tensor, R: torch.Tensor, t: torch.Tensor):
    dR, dt = lie.se3_exp(xi)
    return torch.einsum("mij,mjk->mik", dR, R), torch.einsum("mij,mj->mi", dR, t) + dt


def optimize_pose_graph(
    g: PoseGraph,
    iters: int = 10,
    damping: float = 1e-5,
) -> tuple[PoseGraph, torch.Tensor]:
    """GN pose-graph optimisation; node 0 is the gauge anchor.

    Returns (optimised graph, per-iteration rms history (iters+1,))."""
    M = g.R.shape[0]
    dev, dt = g.R.device, g.R.dtype
    sqrt_w = torch.sqrt(g.weight)[:, None]

    def residual_of_tangent(xi_flat, R, t):
        Rn, tn = _retract(xi_flat.reshape(M, 6), R, t)
        return (edge_residuals(g, Rn, tn) * sqrt_w).reshape(-1)

    def rms(R, t):
        r = edge_residuals(g, R, t)
        w = g.weight
        return torch.sqrt(torch.sum(torch.sum(r * r, -1) * w) / torch.clamp(torch.sum(w), min=1.0))

    # gauge: freeze node 0
    mask = (torch.arange(6 * M, device=dev) >= 6).to(dt)
    zero = torch.zeros(6 * M, dtype=dt, device=dev)
    R, t = g.R, g.t
    hist = []
    for _ in range(iters):
        J = jacfwd(residual_of_tangent)(zero, R, t)            # (6E, 6M)
        r = residual_of_tangent(zero, R, t)
        H = J.T @ J + damping * torch.eye(6 * M, dtype=dt, device=dev)
        gvec = J.T @ r
        H = H * mask[:, None] * mask[None, :] + torch.diag(1.0 - mask)
        gvec = gvec * mask
        dxi = -torch.linalg.solve_ex(H, gvec, check_errors=False).result.reshape(M, 6)
        n = torch.linalg.norm(dxi, dim=-1, keepdim=True)
        dxi = dxi * torch.clamp(rdiv(1.0, torch.clamp(n, min=1e-12)), max=1.0)
        hist.append(rms(R, t))
        R, t = _retract(dxi, R, t)
    hist.append(rms(R, t))
    return g._replace(R=R, t=t), torch.stack(hist)


def odometry_edges(R_w: torch.Tensor, t_w: torch.Tensor, weight: float = 1.0):
    """Build consecutive-node edges from a trajectory of world poses:
    measurement T_ij = T_i⁻¹ T_j."""
    M = R_w.shape[0]
    i = torch.arange(M - 1, device=R_w.device)
    j = i + 1
    Rij = torch.einsum("eji,ejk->eik", R_w[i], R_w[j])
    tij = torch.einsum("eji,ej->ei", R_w[i], t_w[j] - t_w[i])
    return (i.to(torch.int32), j.to(torch.int32), Rij, tij,
            torch.full((M - 1,), weight, dtype=R_w.dtype, device=R_w.device))
