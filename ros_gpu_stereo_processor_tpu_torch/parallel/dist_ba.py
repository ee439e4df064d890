"""Distributed bundle adjustment: landmark blocks over a mesh axis.

The port of ``ros_gpu_stereo_processor_tpu/parallel/dist_ba.py`` (BASELINE
config 5's distributed Schur BA).  The landmarks are split into one block
per entry of the line ``mesh.along(axis)``; each block assembles its
Gauss–Newton terms (models/ba.py ``ba_normal_terms``, its robust gate over
the block's own residuals, as each JAX shard computes it) and eliminates
its landmarks; the reduced camera system (−Σ W V⁻¹ Wᵀ, U and the right-hand
side) is summed over the line with ``psum``; the (6M × 6M) system is solved
once per process (every entry would solve the same one); each block
back-substitutes its own landmarks.  An iteration exchanges M·M·36 +
M·36 + M·6 floats (three ``psum``), whatever the number of landmarks, and
two scalars for the rms.

Blocks are summed in entry order (``Mesh.psum``) and JAX's ``psum`` order
is its own, so the result equals the single-device BA and the JAX sharded
BA to float32 rounding, not bit for bit (tests: 1e-3 on t and R, 5e-3 on
points, JAX's own bars).  The mesh may be a process mesh
(parallel/multihost.py): each process then holds its own blocks.
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.models import ba as BA
from ros_gpu_stereo_processor_tpu_torch.models.ba import BAProblem
from ros_gpu_stereo_processor_tpu_torch.utils import lie


def bundle_adjust_sharded(
    p: BAProblem,
    mesh,
    axis: str = "kf",
    iters: int = 10,
    huber_px: float = 3.0,
    damping: float = 1e-4,
    fix_first_pose: bool = True,
    point_prior: torch.Tensor | None = None,
) -> Tuple[BAProblem, torch.Tensor]:
    """Landmark-sharded BA, the contract of ``models.ba.bundle_adjust``:
    returns (the refined problem, whole, on the line's first device; the rms
    history (iters + 1,): before each iteration, then after the last).
    Raises ``ValueError`` unless the N landmarks divide into the axis's
    size."""
    m = mesh.along(axis)
    N, n = p.points.shape[0], m.size
    if N % n != 0:
        raise ValueError(f"N={N} landmarks not divisible by mesh axis {axis}={n}")
    nb = N // n
    dev = m.devices[0]
    prior = point_prior if point_prior is not None else torch.zeros(
        N, dtype=p.points.dtype, device=p.points.device)

    def block(x, dim, g, d):
        return x.narrow(dim, g * nb, nb).to(d)

    obs = [block(p.obs, 1, g, d) for g, d in zip(m.indices, m.devices)]
    mask = [block(p.mask, 1, g, d) for g, d in zip(m.indices, m.devices)]
    priors = [block(prior, 0, g, d) for g, d in zip(m.indices, m.devices)]
    points = [block(p.points, 0, g, d) for g, d in zip(m.indices, m.devices)]
    R, t = p.R.to(dev), p.t.to(dev)

    def problems(R, t, points) -> List[BAProblem]:
        return [BAProblem(R=Ri, t=ti, points=x, obs=o, mask=k, fx=p.fx, cx=p.cx, cy=p.cy)
                for Ri, ti, x, o, k in zip(m.replicate(R), m.replicate(t), points, obs, mask)]

    def rms(probs) -> torch.Tensor:
        sq, cnt = [], []
        for q in probs:
            r, _ = BA.reprojection_residuals(q)
            sq.append(torch.sum(torch.sum(r * r, -1) * q.mask))
            cnt.append(torch.sum(q.mask))
        return torch.sqrt(m.psum(sq)[0] / torch.clamp(m.psum(cnt)[0], min=1.0))

    hist = []
    for _ in range(iters):
        probs = problems(R, t, points)
        terms = [BA.ba_normal_terms(q, huber_px) for q in probs]
        elim = [BA.eliminate_landmarks(V, Wb, b_p, b_l, damping, pr)
                for (_, V, Wb, b_p, b_l), pr in zip(terms, priors)]
        # the only exchange of the solve: the reduced camera system
        S_off = m.psum([e[1] for e in elim])[0]
        U = m.psum([tm[0] for tm in terms])[0]
        rhs = m.psum([e[2] for e in elim])[0]
        dxi = BA.solve_camera_system(S_off, U, rhs, damping, fix_first_pose)
        dX = [BA.back_substitute(tm[2], e[0], tm[4], x)
              for tm, e, x in zip(terms, elim, m.replicate(dxi))]
        dxi, dX = BA.clip_rows(dxi), [BA.clip_rows(x) for x in dX]
        hist.append(rms(probs))
        dR, dt = lie.se3_exp(dxi)
        R = torch.einsum("mij,mjk->mik", dR, R)
        t = torch.einsum("mij,mj->mi", dR, t) + dt
        points = [x + d for x, d in zip(points, dX)]
    hist.append(rms(problems(R, t, points)))
    return p._replace(R=R, t=t, points=m.gather(points)), torch.stack(hist)


def synthetic_problem(rng: np.random.Generator, n_poses: int, n_points: int,
                      device) -> BAProblem:
    """The JAX multi-host worker's and dry run's BA window: ``n_poses``
    poses (pose 0 at the origin, the others ξ ~ N(0, 0.05)) seeing all of
    ``n_points`` landmarks in [−2, 2]² × [4, 10] exactly (fx 400, principal
    point (320, 240)), the landmarks' start off by N(0, 0.05); float32 on
    ``device``."""
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n_points, 3))
    xs = rng.normal(0, 0.05, (n_poses, 6))
    xs[0] = 0
    Rs, ts = (a.double().numpy() for a in lie.se3_exp(torch.tensor(xs, dtype=torch.float32)))
    pc = np.einsum("mij,nj->mni", Rs, pts) + ts[:, None]
    obs = np.stack([400.0 * pc[..., 0] / pc[..., 2] + 320.0,
                    400.0 * pc[..., 1] / pc[..., 2] + 240.0], -1)

    def f32(a):
        return torch.tensor(a, dtype=torch.float32, device=device)

    return BAProblem(R=f32(Rs), t=f32(ts), points=f32(pts + rng.normal(0, 0.05, pts.shape)),
                     obs=f32(obs), mask=f32(np.ones((n_poses, n_points))),
                     fx=400.0, cx=320.0, cy=240.0)
