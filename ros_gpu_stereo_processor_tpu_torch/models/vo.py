"""Stereo visual odometry — sparse tracking on top of the dense frontend, in
PyTorch.

The port of ``ros_gpu_stereo_processor_tpu/models/vo.py``.  Per frame:

  1. FAST/BRIEF keypoints on the rectified left image (ops/features.py);
  2. depth for each keypoint from the dense disparity map (the pipeline's
     output — the sparse stack rides the dense one);
  3. descriptor matching against the previous frame;
  4. robust PnP: fixed-iteration Gauss–Newton on the SE(3) tangent with
     Huber-weighted reprojection residuals (mask-gated, no data-dependent
     control flow, so the frame's device work is enqueued without a host
     read).

Poses are world←camera (``T_wc``): ``x_w = R x_c + t``.  The device work of
a frame runs on the VO's device; on a CUDA device ``dispatch`` replays the
step as a CUDA graph (``_vo_first`` on the first frame, ``_vo_core`` after,
each with ``_pack_host_bundle``, captured once per camera and image shape
as the JAX package jits them; utils/graphs.py), copies the frame's packed
host bundle into pinned host memory on the copy stream without blocking
(utils/hostcopy.py, as the pipeline's publish copies) and ``complete``
waits on that copy's event.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import NamedTuple, Optional

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.ops import features as feat_ops
from ros_gpu_stereo_processor_tpu_torch.utils import graphs, lie
from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device
from ros_gpu_stereo_processor_tpu_torch.utils.division import div_const, rdiv
from ros_gpu_stereo_processor_tpu_torch.utils.hostcopy import start_host_copy


class TrackedFrame(NamedTuple):
    """Per-frame sparse state carried between VO steps."""

    kp: feat_ops.Keypoints
    pts_cam: torch.Tensor      # (K, 3) camera-frame 3-D points
    pts_valid: torch.Tensor    # (K,) bool (valid keypoint ∧ valid depth)


def triangulate_keypoints(
    xy: torch.Tensor,
    disparity: torch.Tensor,
    fx: float,
    cx: float,
    cy: float,
    baseline: float,
    disparity_offset: float = 0.0,
    min_disparity: float = 0.5,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Keypoint pixel coords + dense disparity map → camera-frame 3-D points.

    Z = fx·B / (d − offset) (the Q-matrix relation, utils/calib.py).
    Returns (pts (K, 3), valid (K,)).
    """
    H, W = disparity.shape
    flat = disparity.reshape(-1)
    xi = torch.round(xy[:, 0]).to(torch.int64).clamp(0, W - 1)
    yi = torch.round(xy[:, 1]).to(torch.int64).clamp(0, H - 1)
    d = flat[yi * W + xi] - disparity_offset
    valid = d > min_disparity
    # depth-discontinuity gate: keypoints on disparity edges (occlusion
    # boundaries, independently-moving silhouettes) triangulate badly —
    # 3×3 disparity range at the keypoint > 2 px ⇒ drop
    off = torch.arange(-1, 2, device=xy.device)      # a kernel, not a host copy
    yj = (yi[None, :] + off.repeat_interleave(3)[:, None]).clamp(0, H - 1)
    xj = (xi[None, :] + off.repeat(3)[:, None]).clamp(0, W - 1)
    nb = flat[yj * W + xj]                                   # (9, K)
    nb_valid = nb > (min_disparity + disparity_offset)
    d_hi = torch.where(nb_valid, nb, -torch.inf).amax(0)
    d_lo = torch.where(nb_valid, nb, torch.inf).amin(0)
    valid = valid & ((d_hi - d_lo) <= 2.0)
    z = torch.where(valid, rdiv(fx * baseline, torch.where(valid, d, 1.0)), 0.0)
    x = div_const((xy[:, 0] - cx) * z, fx)
    y = div_const((xy[:, 1] - cy) * z, fx)
    return torch.stack([x, y, z], -1), valid


def _project(pts: torch.Tensor, R: torch.Tensor, t: torch.Tensor,
             fx: float, cx: float, cy: float):
    """(…, N, 3) points through the pose (…, 3, 3), (…, 3): ((u, v) each
    (…, N), camera-frame points, clamped depth)."""
    pc = pts @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp(pc[..., 2], min=1e-6)
    u = fx * pc[..., 0] / z + cx
    v = fx * pc[..., 1] / z + cy
    return u, v, pc, z


def pnp_gauss_newton(
    pts3d: torch.Tensor,       # (…, N, 3) points in the *reference* frame
    obs: torch.Tensor,         # (…, N, 2) pixel observations in the current frame
    weights: torch.Tensor,     # (…, N) 0/1 validity
    fx: float,
    cx: float,
    cy: float,
    R0: torch.Tensor,
    t0: torch.Tensor,
    iters: int = 10,
    huber_px: float = 3.0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Estimate T_cur←ref (R, t) minimizing Huber-robust reprojection error.

    Fixed iteration count, 6×6 normal-equation solve per step (leading dims
    are independent problems, loop closure's batch).  Returns (R, t,
    rms_px).  A singular system gives non-finite values, as
    ``jnp.linalg.solve`` does, and no host read."""
    R, t = R0.to(pts3d.dtype), t0.to(pts3d.dtype)
    eye6 = 1e-6 * torch.eye(6, dtype=pts3d.dtype, device=pts3d.device)
    for _ in range(iters):
        u, v, pc, z = _project(pts3d, R, t, fx, cx, cy)
        r = torch.stack([u - obs[..., 0], v - obs[..., 1]], -1)   # (…, N, 2)
        rn = torch.linalg.norm(r, dim=-1)
        # Huber IRLS weight × validity; guard z>0
        w = torch.where(rn <= huber_px, 1.0, rdiv(huber_px, torch.clamp(rn, min=1e-9)))
        w = w * weights * (pc[..., 2] > 1e-3)

        # Jacobian of projection wrt the left se3 perturbation ξ = [ρ, ω] of
        # the current pose: du/dp = fx [1/Z, 0, −X/Z²], dp/dρ = I, dp/dω = −[p]×
        X, Y = pc[..., 0], pc[..., 1]
        iz = torch.reciprocal(z)
        iz2 = iz * iz
        zero = torch.zeros_like(iz)
        Ju = torch.stack([fx * iz, zero, -fx * X * iz2], -1)
        Jv = torch.stack([zero, fx * iz, -fx * Y * iz2], -1)
        Pskew = lie.hat(pc)                                      # (…, N, 3, 3)
        Ju_full = torch.cat([Ju, -(Ju[..., None, :] @ Pskew)[..., 0, :]], -1)
        Jv_full = torch.cat([Jv, -(Jv[..., None, :] @ Pskew)[..., 0, :]], -1)
        J = torch.stack([Ju_full, Jv_full], -2)                  # (…, N, 2, 6)

        Jw = J * w[..., None, None]
        H = torch.einsum("...nri,...nrj->...ij", Jw, J) + eye6
        g = torch.einsum("...nri,...nr->...i", Jw, r)
        dx = -torch.linalg.solve_ex(H, g, check_errors=False).result
        dR, dt = lie.se3_exp(dx)
        R, t = dR @ R, (dR @ t[..., None])[..., 0] + dt
    u, v, pc, _ = _project(pts3d, R, t, fx, cx, cy)
    rn = torch.linalg.norm(torch.stack([u - obs[..., 0], v - obs[..., 1]], -1), dim=-1)
    w = weights * (pc[..., 2] > 1e-3)
    rms = torch.sqrt(torch.sum(rn**2 * w, -1) / torch.clamp(torch.sum(w, -1), min=1.0))
    return R, t, rms


def inlier_gate(pts: torch.Tensor, obs: torch.Tensor, ok: torch.Tensor,
                R: torch.Tensor, t: torch.Tensor, fx: float, cx: float,
                cy: float, max_px: float) -> torch.Tensor:
    """Matches whose reprojection at (R, t) is under ``max_px`` and in
    front of the camera."""
    u, v, pc, _ = _project(pts, R, t, fx, cx, cy)
    rn = torch.hypot(u - obs[..., 0], v - obs[..., 1])
    return ok & (rn < max_px) & (pc[..., 2] > 1e-3)


def _f2i(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.float32).contiguous().view(torch.int32)


def _pack_host_bundle(kp, pts, pv, n=None, R=None, t=None, rms=None):
    """Every per-frame host-bound value in ONE (K+1, 15) int32 tensor (floats
    bitcast): one device→host copy per frame instead of nine.  Layout: rows
    [0, K) = per-keypoint [pts_cam ×3 | pts_valid | desc ×8 | kp_valid | xy
    ×2]; row K = [n, rms, R ×9, t ×3, pad] (zero when the frame has no
    motion solve).  Host twin: :func:`_unpack_host_bundle`."""
    big = torch.cat(
        [_f2i(pts), _f2i(pv)[:, None], kp.desc.to(torch.int32),
         _f2i(kp.valid)[:, None], _f2i(kp.xy)], dim=1)          # (K, 15)
    if n is None:
        tail = torch.zeros((1, 15), dtype=torch.int32, device=big.device)
    else:
        tail = torch.cat(
            [_f2i(torch.stack([n.to(torch.float32), rms])), _f2i(R.reshape(-1)),
             _f2i(t), torch.zeros(1, dtype=torch.int32, device=big.device)]
        ).reshape(1, 15)
    return torch.cat([big, tail], dim=0)


def _unpack_host_bundle(bundle: np.ndarray, has_motion: bool):
    """Host twin of :func:`_pack_host_bundle`: (frame_host dict, motion
    tuple (n, R, t, rms) or None)."""
    b = np.asarray(bundle)
    K = b.shape[0] - 1
    i2f = lambda x: np.ascontiguousarray(x).view(np.float32)
    host = {
        "pts_cam": i2f(b[:K, 0:3]),
        "pts_valid": i2f(b[:K, 3:4])[:, 0] > 0.5,
        "desc": np.ascontiguousarray(b[:K, 4:12]).view(np.uint32),
        "valid": i2f(b[:K, 12:13])[:, 0] > 0.5,
        "xy": i2f(b[:K, 13:15]),
    }
    if not has_motion:
        return host, None
    tail = i2f(b[K : K + 1, :])[0]
    return host, (int(tail[0]), tail[2:11].reshape(3, 3).astype(np.float64),
                  tail[11:14].astype(np.float64), float(tail[1]))


def _vo_core(
    prev_kp: feat_ops.Keypoints,
    prev_pts: torch.Tensor,
    prev_pts_valid: torch.Tensor,
    rect_left: torch.Tensor,
    disparity: torch.Tensor,
    *,
    k: int,
    threshold: float,
    fx: float,
    cx: float,
    cy: float,
    baseline: float,
    disparity_offset: float,
):
    """One VO step: detect+describe → triangulate → match → PnP, enqueued
    with no host read."""
    kp, pts, pvalid = _vo_first(rect_left, disparity, k=k, threshold=threshold, fx=fx,
                                cx=cx, cy=cy, baseline=baseline,
                                disparity_offset=disparity_offset)
    idx, ok = feat_ops.match(prev_kp, kp)
    ok = ok & prev_pts_valid
    obs = kp.xy[torch.where(ok, idx, 0).to(torch.int64)]
    dev = prev_pts.device
    eye = torch.eye(3, device=dev)
    R, t, rms = pnp_gauss_newton(
        prev_pts, obs, ok.to(torch.float32), fx=fx, cx=cx, cy=cy,
        R0=eye, t0=torch.zeros(3, device=dev),
    )
    # inlier-gated re-solve: matches on independently-moving objects survive
    # the Huber IRLS as down-weighted outliers that still bias the pose;
    # hard-gate residuals at the first solve's pose and refine on the
    # static-scene consensus set only
    inl = inlier_gate(prev_pts, obs, ok, R, t, fx, cx, cy, 3.0)
    # fall back to the full match set when the gate would starve the solve
    # (degraded frames): the caller's min_matches logic decides lost-ness
    use_inl = torch.sum(inl) >= 12
    w = torch.where(use_inl, inl.to(torch.float32), ok.to(torch.float32))
    R, t, rms = pnp_gauss_newton(
        prev_pts, obs, w, fx=fx, cx=cx, cy=cy, R0=R, t0=t, iters=6,
    )
    n = torch.where(use_inl, torch.sum(inl), torch.sum(ok))
    return kp, pts, pvalid, n, R, t, rms


def _vo_first(
    rect_left: torch.Tensor,
    disparity: torch.Tensor,
    *,
    k: int,
    threshold: float,
    fx: float,
    cx: float,
    cy: float,
    baseline: float,
    disparity_offset: float,
):
    kp = feat_ops.detect_and_describe(rect_left, k=k, threshold=threshold)
    pts, pvalid = triangulate_keypoints(
        kp.xy, disparity, fx=fx, cx=cx, cy=cy,
        baseline=baseline, disparity_offset=disparity_offset,
    )
    return kp, pts, pvalid & kp.valid


@dataclasses.dataclass
class VOState:
    """Host-side odometry state."""

    R_wc: np.ndarray
    t_wc: np.ndarray
    prev: Optional[TrackedFrame]
    n_frames: int = 0
    n_tracked: int = 0
    # constant-velocity memory: last successful prev→cur motion, applied as a
    # prediction when tracking drops
    R_vel: Optional[np.ndarray] = None
    t_vel: Optional[np.ndarray] = None
    lost_frames: int = 0


class StereoVisualOdometry:
    """Frame-to-frame stereo VO.

    ``step(rect_left, disparity)`` consumes the dense pipeline's outputs and
    returns the updated world pose of the camera.  Runs on the card
    (``device="cuda"``, the default; raises without CUDA) unless given
    ``device="cpu"``.
    """

    def __init__(
        self,
        model,
        num_features: int = 512,
        fast_threshold: float = 20.0,
        min_matches: int = 12,
        device: torch.device | str | None = None,
    ):
        self.model = model
        self.device = require_device(device)
        self.num_features = num_features
        self.fast_threshold = fast_threshold
        self.min_matches = min_matches
        self.state = VOState(R_wc=np.eye(3), t_wc=np.zeros(3), prev=None)
        # the dispatch's steps: _step
        self._steps: dict = {}
        # guards pose/state mutation when a mapping thread applies BA
        # corrections concurrently (StereoSlam async mapping)
        self.pose_lock = threading.RLock()

    def reset(self) -> None:
        self.state = VOState(R_wc=np.eye(3), t_wc=np.zeros(3), prev=None)

    def _step(self, has_motion: bool):
        """The dispatch's device work for a frame with (``_vo_core``) or
        without (``_vo_first``) a previous frame, packed host bundle
        included: one :class:`graphs.Captured` step per motion flag,
        feature settings and camera (the image shape keys its graphs),
        whose outputs are (TrackedFrame, bundle)."""
        m = self.model
        cam = dict(
            k=self.num_features, threshold=self.fast_threshold,
            fx=m.fx, cx=m.left.calib.cx, cy=m.left.calib.cy,
            baseline=m.baseline, disparity_offset=m.disparity_offset,
        )
        key = (has_motion,) + tuple(cam.values())
        fn = self._steps.get(key)
        if fn is not None:
            return fn

        def first(rect_left, disparity):
            kp, pts, pv = _vo_first(rect_left, disparity, **cam)
            return TrackedFrame(kp, pts, pv), _pack_host_bundle(kp, pts, pv)

        def core(prev, rect_left, disparity):
            kp, pts, pv, n, R, t, rms = _vo_core(
                prev.kp, prev.pts_cam, prev.pts_valid, rect_left, disparity, **cam)
            return TrackedFrame(kp, pts, pv), _pack_host_bundle(kp, pts, pv, n, R, t, rms)

        fn = self._steps[key] = graphs.Captured(
            core if has_motion else first, self.device,
            name="vo core" if has_motion else "vo first")
        return fn

    def dispatch(self, rect_left, disparity):
        """Enqueue this frame's VO device work and advance the device-side
        frame chain immediately — the next ``dispatch`` may follow before
        this frame's :meth:`complete` (pipelined stepping).  On the card the
        work is one graph replay: the previous frame's keypoints and points
        and this frame's inputs are copied into the graph's inputs, and the
        frame's outputs are its own (a keyframe or a relocalization may hold
        them for any time).  Returns an opaque pending record; call
        :meth:`complete` once per dispatch, in order."""
        st = self.state
        has_motion = st.prev is not None
        if has_motion:
            cur, bundle = self._step(True)(st.prev, rect_left, disparity)
        else:
            cur, bundle = self._step(False)(rect_left, disparity)
        st.prev = cur
        # the bundle's host copy starts now (pinned, on the copy stream)
        return (cur, start_host_copy(bundle), has_motion)

    def fetch_frame_host(self, cur: TrackedFrame) -> dict:
        """Host copies of the per-frame sparse state the map logic needs on
        keyframes (``pts_cam``, ``pts_valid``, ``desc`` as uint32 words,
        ``valid``, ``xy``), in ONE batched device→host copy of the packed
        bundle.  :meth:`complete` already carries them as
        ``info["frame_host"]``; this is for a frame whose bundle is gone."""
        bundle = _pack_host_bundle(cur.kp, cur.pts_cam, cur.pts_valid)
        return _unpack_host_bundle(start_host_copy(bundle).result()[0], False)[0]

    def complete(self, pending) -> dict:
        """Wait for a dispatched frame's bundle and update the host pose.
        The bundle carries the motion solve AND the keyframe host copies, so
        ``info["frame_host"]`` is always available."""
        cur, copy, has_motion = pending
        st = self.state
        info = {"n_matches": 0, "rms_px": float("nan"), "tracked": False,
                "lost": False, "frame": cur}
        host, motion = _unpack_host_bundle(copy.result()[0], has_motion)
        info["frame_host"] = host
        if motion is not None:
            n, R_rel, t_rel, rms_h = motion
            info["n_matches"] = n
            with self.pose_lock:
                if n >= self.min_matches:
                    # T_cur←prev ⇒ T_w←cur = T_w←prev ∘ T_prev←cur
                    R_pc = R_rel.T
                    t_pc = -R_rel.T @ t_rel
                    st.t_wc = st.R_wc @ t_pc + st.t_wc
                    st.R_wc = st.R_wc @ R_pc
                    st.R_vel, st.t_vel = R_pc, t_pc
                    st.lost_frames = 0
                    st.n_tracked += 1
                    info["rms_px"] = float(rms_h)
                    info["tracked"] = True
                else:
                    # tracking lost: constant-velocity prediction instead of
                    # a silent pose freeze; the caller (StereoSlam) attempts
                    # relocalization against the persistent track store
                    st.lost_frames += 1
                    if st.R_vel is not None:
                        st.t_wc = st.R_wc @ st.t_vel + st.t_wc
                        st.R_wc = st.R_wc @ st.R_vel
                    info["lost"] = True

        st.n_frames += 1
        with self.pose_lock:
            info["R_wc"] = st.R_wc.copy()
            info["t_wc"] = st.t_wc.copy()
        return info

    def step(self, rect_left, disparity) -> dict:
        return self.complete(self.dispatch(rect_left, disparity))
