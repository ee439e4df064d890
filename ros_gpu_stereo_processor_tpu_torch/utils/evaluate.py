"""Trajectory evaluation: EuRoC ground truth, alignment, ATE/RPE metrics.

A numpy copy of ``ros_gpu_stereo_processor_tpu/utils/evaluate.py`` (the
port cannot import the JAX package, whose ``__init__`` imports jax): the
accuracy harness for the SLAM stack (BASELINE.md: ATE < 0.1 m on EuRoC
MH_01).  Timestamp association, Umeyama SE(3)/Sim(3) alignment, absolute
trajectory error RMSE.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np


def quat_to_rot(q: np.ndarray) -> np.ndarray:
    """(…, 4) quaternion (w, x, y, z) → (…, 3, 3) rotation."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    R = np.empty(q.shape[:-1] + (3, 3))
    R[..., 0, 0] = 1 - 2 * (y * y + z * z)
    R[..., 0, 1] = 2 * (x * y - w * z)
    R[..., 0, 2] = 2 * (x * z + w * y)
    R[..., 1, 0] = 2 * (x * y + w * z)
    R[..., 1, 1] = 1 - 2 * (x * x + z * z)
    R[..., 1, 2] = 2 * (y * z - w * x)
    R[..., 2, 0] = 2 * (x * z - w * y)
    R[..., 2, 1] = 2 * (y * z + w * x)
    R[..., 2, 2] = 1 - 2 * (x * x + y * y)
    return R


@dataclasses.dataclass
class Trajectory:
    stamps: np.ndarray    # (T,) seconds
    t: np.ndarray         # (T, 3) positions
    R: np.ndarray | None = None  # (T, 3, 3) orientations (optional)

    def __len__(self) -> int:
        return len(self.stamps)


def load_euroc_groundtruth(root: str) -> Trajectory:
    """Read <root>/mav0/state_groundtruth_estimate0/data.csv."""
    path = os.path.join(root, "mav0", "state_groundtruth_estimate0", "data.csv")
    stamps, ts, qs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            vals = line.split(",")
            stamps.append(int(vals[0]) * 1e-9)
            ts.append([float(v) for v in vals[1:4]])
            qs.append([float(v) for v in vals[4:8]])
    return Trajectory(
        stamps=np.asarray(stamps), t=np.asarray(ts),
        R=quat_to_rot(np.asarray(qs)),
    )


def associate(a: Trajectory, b: Trajectory, max_dt: float = 0.02):
    """Nearest-timestamp association; returns (idx_a, idx_b)."""
    ia, ib = [], []
    j = 0
    for i, ta in enumerate(a.stamps):
        while j + 1 < len(b.stamps) and abs(b.stamps[j + 1] - ta) <= abs(b.stamps[j] - ta):
            j += 1
        if abs(b.stamps[j] - ta) <= max_dt:
            ia.append(i)
            ib.append(j)
    return np.asarray(ia, int), np.asarray(ib, int)


def umeyama(src: np.ndarray, dst: np.ndarray, with_scale: bool = False):
    """Least-squares similarity transform src→dst: returns (s, R, t) with
    dst ≈ s·R·src + t."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    if with_scale:
        var_s = (xs**2).sum() / len(src)
        s = float(np.trace(np.diag(D) @ S) / var_s)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est: Trajectory, gt: Trajectory, max_dt: float = 0.02,
             with_scale: bool = False) -> float:
    """Absolute trajectory error RMSE after alignment (the EuRoC metric)."""
    ia, ib = associate(est, gt, max_dt)
    if len(ia) < 3:
        raise ValueError(f"only {len(ia)} associated poses")
    s, R, t = umeyama(est.t[ia], gt.t[ib], with_scale)
    aligned = (s * (R @ est.t[ia].T)).T + t
    err = aligned - gt.t[ib]
    return float(np.sqrt((err**2).sum(axis=1).mean()))


def rpe_rmse(est: Trajectory, gt: Trajectory, delta: int = 1,
             max_dt: float = 0.02) -> float:
    """Relative pose (translation drift) error RMSE over ``delta`` steps."""
    ia, ib = associate(est, gt, max_dt)
    de = est.t[ia][delta:] - est.t[ia][:-delta]
    dg = gt.t[ib][delta:] - gt.t[ib][:-delta]
    err = np.linalg.norm(de, axis=1) - np.linalg.norm(dg, axis=1)
    return float(np.sqrt((err**2).mean()))
