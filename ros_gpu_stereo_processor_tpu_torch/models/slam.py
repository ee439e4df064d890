"""The full stereo SLAM engine, in PyTorch: dense frontend + VO + keyframes +
local BA + pose graph + checkpoint/resume.

The port of ``ros_gpu_stereo_processor_tpu/models/slam.py``:

  frame ──► StereoPipeline (rectify K1, match K2 or K4–K6, speckle K3/K7)
        ──► StereoVisualOdometry (features, PnP tracking)
        ──► keyframe policy ──► KeyframeStore + persistent TrackStore
        ──► windowed BA (models/ba.py)
        ──► pose graph (odometry edges + loop closures; optimize_global())

The engine runs on the card (``device="cuda"``, the default; raises without
CUDA) unless given ``device="cpu"``; each kernel-backed op dispatches on the
device of its tensors and nothing falls back.  With ``mesh``
(parallel/mesh.py) a ``rows`` axis runs the dense frontend by row bands
over ``mesh.along("rows")``, and a ``kf`` axis runs the windowed BA
landmark-sharded over ``mesh.along("kf")`` (parallel/dist_ba.py); a
``(kf, rows)`` mesh runs both, as the JAX engine does.

Threads: under ``run_stream(async_mapping=True)`` the mapping worker
(track association, BA) and the tracking thread both launch on the
device's default stream — PyTorch's current stream is per thread and
neither thread changes it — so every tensor one thread makes is ordered
before the other thread's later launches that read it, with no event.

Checkpoints are ``torch.save`` files of a dict of tensors with the keys of
the JAX engine's checkpoint; :meth:`StereoSlam.load_state` takes that dict
as numpy arrays, so a JAX engine's state carries across.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.config import Outputs, PipelineConfig
from ros_gpu_stereo_processor_tpu_torch.models import ba as BA
from ros_gpu_stereo_processor_tpu_torch.models import posegraph as PG
from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
from ros_gpu_stereo_processor_tpu_torch.models.vo import (
    StereoVisualOdometry,
    inlier_gate,
    pnp_gauss_newton,
)
from ros_gpu_stereo_processor_tpu_torch.ops import features as feat_ops
from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import bundle_adjust_sharded
from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device
from ros_gpu_stereo_processor_tpu_torch.utils.evaluate import Trajectory
from ros_gpu_stereo_processor_tpu_torch.utils.timing import StageTimer


def _project_so3(R: np.ndarray) -> np.ndarray:
    """Nearest rotation matrix (Frobenius) via SVD — keeps pose chains on
    SO(3) so inverse-by-transpose stays exact."""
    U, _, Vt = np.linalg.svd(R)
    S = np.diag([1.0, 1.0, float(np.sign(np.linalg.det(U @ Vt)))])
    return U @ S @ Vt


def _desc_to_device(desc: np.ndarray, device) -> torch.Tensor:
    """Host uint32 descriptor words → the port's int32 bit patterns."""
    return torch.from_numpy(np.ascontiguousarray(desc, np.uint32).view(np.int32)).to(device)


def _f32(a, device) -> torch.Tensor:
    """A host array as float32 on ``device`` (the JAX engine's numpy float64
    operands become float32 on the device)."""
    return torch.from_numpy(np.asarray(a, np.float32)).to(device)


def _host(*tensors: torch.Tensor) -> list:
    """Several device tensors as float32 numpy arrays with ONE device→host
    copy."""
    flat = torch.cat([t.reshape(-1).to(torch.float32) for t in tensors]).cpu().numpy()
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].reshape(tuple(t.shape)))
        at += t.numel()
    return out


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    num_features: int = 512
    fast_threshold: float = 20.0
    keyframe_every: int = 5            # force a keyframe every N frames
    keyframe_min_translation: float = 0.15   # m
    keyframe_min_rotation: float = 0.15      # rad
    window_size: int = 5               # keyframes in the local BA window
    ba_iters: int = 6
    ba_landmarks: int = 256            # padded landmark capacity per window
    stereo_point_prior: float = 10.0   # anchors scale to stereo depth
    track_capacity: int = 4096         # persistent landmark table size
    # keyframe↔track association matches against a compact buffer of the
    # most recently seen tracks instead of the whole table (old-track
    # re-association is relocalization/loop-closure's job).  None = match
    # the full table.
    assoc_capacity: int | None = 1024
    # relocalization (tracking-loss recovery): match the lost frame against
    # the persistent track store and PnP re-anchor the pose
    reloc_min_matches: int = 20
    reloc_max_rms_px: float = 3.0
    # landmarks whose post-BA reprojection rms exceeds this are killed (a
    # point on an independently-moving object cannot fit the rigid window
    # solve); 0 disables
    track_reject_rms_px: float = 4.0


@dataclasses.dataclass
class Keyframe:
    stamp: float
    R_wc: np.ndarray                   # world←camera
    t_wc: np.ndarray
    kp: feat_ops.Keypoints             # device tensors (fixed capacity)
    pts_cam: np.ndarray                # (K, 3)
    pts_valid: np.ndarray              # (K,)
    track_ids: np.ndarray | None = None  # (K,) int32 — landmark id per kp slot, −1 = none
    # host copies of the kp fields the map logic reads every window (from
    # the frame's bundle; None on checkpoint-restored frames)
    kp_desc_h: np.ndarray | None = None
    kp_valid_h: np.ndarray | None = None
    kp_xy_h: np.ndarray | None = None

    def desc_host(self) -> np.ndarray:
        """(K, 8) uint32 words."""
        if self.kp_desc_h is not None:
            return self.kp_desc_h
        return self.kp.desc.cpu().numpy().view(np.uint32)

    def valid_host(self) -> np.ndarray:
        return self.kp_valid_h if self.kp_valid_h is not None else self.kp.valid.cpu().numpy()

    def xy_host(self) -> np.ndarray:
        return self.kp_xy_h if self.kp_xy_h is not None else self.kp.xy.cpu().numpy()


class TrackStore:
    """Persistent landmark tracks — the structure BA windows and the pose
    graph share: a landmark observed by many keyframes is ONE optimisation
    variable across every window that sees it.  Fixed-capacity host table
    (world position, latest descriptor, aliveness, bookkeeping); slot
    allocation recycles the least-recently-seen tracks when full."""

    def __init__(self, capacity: int = 4096, desc_words: int = 8):
        self.capacity = capacity
        self.pos_w = np.zeros((capacity, 3), np.float64)
        self.desc = np.zeros((capacity, desc_words), np.uint32)
        self.alive = np.zeros(capacity, bool)
        self.last_seen = np.full(capacity, -1, np.int64)
        self.n_obs = np.zeros(capacity, np.int32)
        # bumped on every mutation (under the SLAM map lock): readers that
        # snapshot the table, solve unlocked, and write back detect a
        # concurrent mutation (see StereoSlam._relocalize)
        self.version = 0

    def allocate(self, k: int, protect_after: int = -1) -> np.ndarray:
        """Indices of ≤k slots: dead slots first, then least-recently-seen.
        Alive slots with ``last_seen >= protect_after`` are never recycled
        (the current BA window may still observe them); may return fewer
        than k when the table is saturated with protected tracks."""
        dead = np.where(~self.alive)[0]
        if len(dead) >= k:
            return dead[:k]
        evictable = self.alive & (self.last_seen < protect_after)
        evict = np.argsort(self.last_seen[evictable])  # oldest first
        evict_idx = np.where(evictable)[0][evict]
        return np.concatenate([dead, evict_idx[: k - len(dead)]])

    def to_pytree(self) -> dict:
        return {
            "pos_w": self.pos_w, "desc": self.desc, "alive": self.alive,
            "last_seen": self.last_seen, "n_obs": self.n_obs,
        }

    @classmethod
    def from_pytree(cls, d: dict) -> "TrackStore":
        ts = cls(capacity=len(np.asarray(d["alive"])))
        ts.pos_w = np.asarray(d["pos_w"])
        ts.desc = np.asarray(d["desc"]).astype(np.uint32)
        ts.alive = np.asarray(d["alive"]).astype(bool)
        ts.last_seen = np.asarray(d["last_seen"])
        ts.n_obs = np.asarray(d["n_obs"])
        return ts


class KeyframeStore:
    """Append-only host-side keyframe map (the engine's persistent state)."""

    def __init__(self):
        self.frames: list[Keyframe] = []

    def add(self, kf: Keyframe) -> None:
        self.frames.append(kf)

    def __len__(self) -> int:
        return len(self.frames)

    def window(self, size: int) -> list[Keyframe]:
        return self.frames[-size:]

    # -- checkpoint serialisation ------------------------------------------
    def to_pytree(self) -> dict:
        if not self.frames:
            return {"n": 0}
        kps = [k.kp for k in self.frames]
        return {
            "n": len(self.frames),
            "stamp": np.asarray([k.stamp for k in self.frames]),
            "R_wc": np.stack([k.R_wc for k in self.frames]),
            "t_wc": np.stack([k.t_wc for k in self.frames]),
            "kp_xy": torch.stack([kp.xy for kp in kps]).cpu().numpy(),
            "kp_score": torch.stack([kp.score for kp in kps]).cpu().numpy(),
            "kp_angle": torch.stack([kp.angle for kp in kps]).cpu().numpy(),
            "kp_desc": torch.stack([kp.desc for kp in kps]).cpu().numpy().view(np.uint32),
            "kp_valid": torch.stack([kp.valid for kp in kps]).cpu().numpy(),
            "pts_cam": np.stack([k.pts_cam for k in self.frames]),
            "pts_valid": np.stack([k.pts_valid for k in self.frames]),
            "track_ids": np.stack([
                k.track_ids if k.track_ids is not None
                else np.full(k.pts_cam.shape[0], -1, np.int32)
                for k in self.frames
            ]),
        }

    @classmethod
    def from_pytree(cls, d: dict, device) -> "KeyframeStore":
        store = cls()
        for i in range(int(d["n"])):
            store.add(
                Keyframe(
                    stamp=float(d["stamp"][i]),
                    R_wc=np.asarray(d["R_wc"][i]),
                    t_wc=np.asarray(d["t_wc"][i]),
                    kp=feat_ops.Keypoints(
                        xy=_f32(d["kp_xy"][i], device),
                        score=_f32(d["kp_score"][i], device),
                        angle=_f32(d["kp_angle"][i], device),
                        desc=_desc_to_device(d["kp_desc"][i], device),
                        valid=torch.from_numpy(np.asarray(d["kp_valid"][i], bool)).to(device),
                    ),
                    pts_cam=np.asarray(d["pts_cam"][i]),
                    pts_valid=np.asarray(d["pts_valid"][i]),
                    track_ids=(
                        np.asarray(d["track_ids"][i]).astype(np.int32)
                        if "track_ids" in d else None
                    ),
                )
            )
        return store


def _to_tensors(obj):
    if isinstance(obj, dict):
        return {k: _to_tensors(v) for k, v in obj.items()}
    return torch.from_numpy(np.ascontiguousarray(obj)) if isinstance(obj, np.ndarray) \
        else torch.tensor(obj)


def _to_numpy(obj):
    if isinstance(obj, dict):
        return {k: _to_numpy(v) for k, v in obj.items()}
    return obj.numpy() if isinstance(obj, torch.Tensor) else np.asarray(obj)


class StereoSlam:
    """End-to-end engine: feed stereo frames, read out a trajectory."""

    def __init__(
        self,
        model,
        config: SlamConfig = SlamConfig(),
        pipeline_config: PipelineConfig = PipelineConfig(),
        mesh=None,
        device: torch.device | str | None = None,
    ):
        """``model``: the port's ``StereoCameraModel``.  ``mesh``: optional
        mesh (parallel/mesh.py).  A ``rows`` axis runs the DENSE FRONTEND by
        row bands (StereoPipeline's mesh path, on ``mesh.along("rows")``); a
        ``kf`` axis runs the windowed BA landmark-sharded
        (parallel/dist_ba.py, on ``mesh.along("kf")``) whenever
        ``ba_landmarks`` divides into it, else the single-device BA.  With a
        mesh the engine's device is the mesh's first device."""
        self.model = model
        self.config = config
        self.mesh = mesh
        pipe_mesh = None
        self._ba_mesh = None
        if mesh is not None:
            if ("rows" in mesh.axis_names
                    and model.left.calib.height % mesh.shape["rows"] == 0):
                pipe_mesh = mesh.along("rows")
            if "kf" in mesh.axis_names:
                self._ba_mesh = mesh.along("kf")
            if device is not None and torch.device(device) != mesh.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{mesh.devices[0]}")
            for d in mesh.unique_devices():
                require_device(d)
            self.device = mesh.devices[0]
        else:
            self.device = require_device(device)
        self.pipeline = StereoPipeline(
            model, pipeline_config,
            device=None if pipe_mesh is not None else self.device,
            mesh=pipe_mesh, shard_axis="rows" if pipe_mesh is not None else None,
        )
        self.vo = StereoVisualOdometry(
            model, num_features=config.num_features,
            fast_threshold=config.fast_threshold, device=self.device,
        )
        self.store = KeyframeStore()
        self.tracks = TrackStore(capacity=config.track_capacity)
        self.traj_stamps: list[float] = []
        self.traj_R: list[np.ndarray] = []
        self.traj_t: list[np.ndarray] = []
        self._frames_since_kf = 0
        # keyframes DECIDED so far (== len(store) once mapping catches up);
        # under async mapping the store lags this counter by queue depth
        self._kf_count = 0
        # shared with vo.pose_lock: one lock guards pose, TrackStore and
        # KeyframeStore against the async mapping worker
        self._map_lock = self.vo.pose_lock
        # per-stage wall timing of the SLAM step: dense = pipeline enqueue,
        # vo = the VO bundle wait, map_host = keyframe/TrackStore numpy work
        # (map_match its device match), ba = windowed BA
        self.timer = StageTimer()

    # ------------------------------------------------------------------
    def step(self, left: np.ndarray, right: np.ndarray, stamp: float = 0.0,
             encoding: str = "mono8") -> dict:
        """Process one synchronized stereo frame (synchronous: dispatch +
        complete back to back).  :meth:`run_stream` pipelines the two
        across frames."""
        return self._complete_frame(
            self._dispatch_frame(left, right, encoding), stamp
        )

    def run_stream(self, frames, encoding: str = "mono8",
                   async_mapping: bool = False, depth: int = 2):
        """Pipelined stepping over an iterable of ``(left, right, stamp)``:
        frame t's host work (VO wait, keyframe/TrackStore updates, windowed
        BA) runs while frames t+1..t+depth's dense+VO work is enqueued on
        the device.  Yields one info dict per frame, in order.

        ``async_mapping=True`` additionally moves the MAPPING work
        (TrackStore association, keyframe insertion, windowed BA) onto a
        worker thread — the tracking/mapping split: tracking never stalls
        on BA; BA pose corrections are applied to the live pose as a delta
        under a lock.  Mapping lags tracking by at most the queue depth (2
        keyframes)."""
        from collections import deque

        depth = max(1, depth)
        if not async_mapping:
            pending: deque = deque()
            for left, right, stamp in frames:
                pending.append((self._dispatch_frame(left, right, encoding), stamp))
                if len(pending) > depth:
                    yield self._complete_frame(*pending.popleft())
            while pending:
                yield self._complete_frame(*pending.popleft())
            return

        import queue as _queue
        import threading

        mq: "_queue.Queue" = _queue.Queue(maxsize=2)
        err: list = []

        def mapper():
            # stays alive until the None sentinel EVEN after a failure
            # (draining the queue) — dying with a full queue would deadlock
            # the tracking thread's backpressured put / sentinel put
            while True:
                item = mq.get()
                if item is None:
                    return
                if err:
                    continue   # drain; the error is raised on the tracker
                try:
                    self._map_keyframe(*item)
                except Exception as e:  # surface on the tracking thread
                    err.append(e)

        worker = threading.Thread(target=mapper, daemon=True, name="slam-mapping")
        worker.start()
        try:
            pending = deque()
            for left, right, stamp in frames:
                if err:
                    raise err[0]
                pending.append((self._dispatch_frame(left, right, encoding), stamp))
                if len(pending) > depth:
                    yield self._complete_frame(*pending.popleft(), map_queue=mq)
            while pending:
                yield self._complete_frame(*pending.popleft(), map_queue=mq)
        finally:
            mq.put(None)
            worker.join()
        if err:
            raise err[0]

    def _dispatch_frame(self, left, right, encoding: str = "mono8"):
        """Enqueue one frame's dense pipeline + VO device work."""
        with self.timer.stage("dense"):
            out = self.pipeline.process(
                left, right, Outputs.of("disparity", "rect_mono_left"), encoding=encoding)
            return self.vo.dispatch(out.outputs["rect_mono_left"], out.outputs["disparity"])

    def _complete_frame(self, pend, stamp: float, map_queue=None) -> dict:
        """Wait for one dispatched frame's bundle and run the host-side SLAM
        logic (pose update, relocalization, keyframing); mapping work runs
        inline, or on the mapping worker when ``map_queue`` is given."""
        with self.timer.stage("vo"):
            info = self.vo.complete(pend)
        cur = info.pop("frame")
        host = info.pop("frame_host")
        info["stamp"] = stamp
        info["relocalized"] = False
        if info.get("lost") and self._kf_count > 0:
            # tracking dropped: PnP re-anchor against the persistent map
            info["relocalized"] = self._relocalize(cur)
        # a lost, un-relocalized frame must not spawn keyframes (its pose is
        # a constant-velocity guess); the bootstrap frame always keyframes
        usable = info["tracked"] or info["relocalized"] or self._kf_count == 0
        info["is_keyframe"] = usable and self._keyframe_decision(info)
        # consistent (R, t) pair: the mapping worker's BA delta write-back
        # mutates both under the lock
        with self._map_lock:
            info["R_wc"] = self.vo.state.R_wc.copy()
            info["t_wc"] = self.vo.state.t_wc.copy()

        self.traj_stamps.append(stamp)
        self.traj_R.append(info["R_wc"])
        self.traj_t.append(info["t_wc"])

        if info["is_keyframe"]:
            kf_index = self._kf_count
            self._kf_count += 1
            self._frames_since_kf = 0
            kf = Keyframe(
                stamp=stamp,
                R_wc=info["R_wc"].copy(),
                t_wc=info["t_wc"].copy(),
                kp=cur.kp,
                pts_cam=host["pts_cam"],
                pts_valid=host["pts_valid"],
                kp_desc_h=host["desc"],
                kp_valid_h=host["valid"],
                kp_xy_h=host["xy"],
            )
            if map_queue is None:
                self._map_keyframe(kf, kf_index)
            else:
                map_queue.put((kf, kf_index))   # backpressure at depth 2
        else:
            self._frames_since_kf += 1
        return info

    def _map_keyframe(self, kf: Keyframe, kf_index: int) -> None:
        """Mapping-side work for one keyframe: TrackStore association,
        insertion, windowed BA.  Shared state is mutated under
        ``self._map_lock``; the device match and the BA solve run outside
        it."""
        with self.timer.stage("map_host"):
            self._assign_tracks(kf, kf_index)
            with self._map_lock:
                self.store.add(kf)
        if kf_index >= 1:
            with self.timer.stage("ba"):
                self._local_ba()

    def _relocalize(self, cur=None) -> bool:
        """PnP re-anchor of a lost frame against the persistent track store.

        Matches the lost frame's descriptors against every alive landmark,
        solves world→camera PnP from the landmarks' WORLD positions seeded
        by the constant-velocity prediction, and overwrites the VO pose on
        success.  ``cur``: the lost frame's TrackedFrame (under pipelined
        stepping ``vo.state.prev`` may already be a LATER frame).
        Snapshot → solve unlocked → validate-and-write, up to 2 attempts
        when the mapping thread mutates the table mid-solve."""
        if cur is None:
            cur = self.vo.state.prev
        if cur is None:
            return False
        for _ in range(2):
            with self._map_lock:
                tr = self.tracks
                if not tr.alive.any():
                    return False
                snap_version = tr.version
                snap_desc = tr.desc.copy()
                snap_alive = tr.alive.copy()
                snap_pos = tr.pos_w.copy()
                R_wc0 = self.vo.state.R_wc.copy()
                t_wc0 = self.vo.state.t_wc.copy()
            solved = self._relocalize_solve(
                cur, snap_desc, snap_alive, snap_pos, R_wc0, t_wc0)
            if solved is None:
                return False
            R_cw, t_cw = solved
            with self._map_lock:
                if self.tracks.version != snap_version:
                    continue       # table changed under us — re-snapshot
                self.vo.state.R_wc = R_cw.T
                self.vo.state.t_wc = -(R_cw.T @ t_cw)
                self.vo.state.lost_frames = 0
                return True
        return False

    def _cam(self):
        m = self.model
        return m.fx, m.left.calib.cx, m.left.calib.cy

    def _relocalize_solve(self, cur, tr_desc, tr_alive, tr_pos, R_wc0, t_wc0):
        """Unlocked part of relocalization: match the lost frame against a
        track-table snapshot and PnP-solve T_c←w.  Returns (R_cw, t_cw) or
        None."""
        dev = self.device
        idx, ok = feat_ops.match_desc(
            cur.kp.desc, cur.kp.valid,
            _desc_to_device(tr_desc, dev), torch.from_numpy(tr_alive).to(dev))
        if int(ok.sum()) < self.config.reloc_min_matches:
            return None
        pts_w = _f32(tr_pos, dev)[torch.clamp(idx, min=0).to(torch.int64)]
        obs = cur.kp.xy
        # seed from the constant-velocity prediction: T_c←w = (R_wc, t_wc)⁻¹
        R0 = _f32(R_wc0.T, dev)
        t0 = _f32(-R_wc0.T @ t_wc0, dev)
        fx, cx, cy = self._cam()
        R, t, _ = pnp_gauss_newton(pts_w, obs, ok.to(torch.float32),
                                   fx=fx, cx=cx, cy=cy, R0=R0, t0=t0, iters=12)
        # store matches carry more outliers than frame-to-frame tracking, so
        # gate on the INLIER count at the solved pose, then refine on
        # inliers only
        inl = inlier_gate(pts_w, obs, ok, R, t, fx, cx, cy, self.config.reloc_max_rms_px)
        if int(inl.sum()) < self.config.reloc_min_matches:
            return None
        R, t, rms = pnp_gauss_newton(pts_w, obs, inl.to(torch.float32),
                                     fx=fx, cx=cx, cy=cy, R0=R, t0=t, iters=8)
        R_h, t_h, rms_h = _host(R, t, rms)
        if float(rms_h) > self.config.reloc_max_rms_px:
            return None
        return R_h, t_h

    def _keyframe_decision(self, info) -> bool:
        if self._kf_count == 0:
            return True
        if self._frames_since_kf + 1 >= self.config.keyframe_every:
            return True
        with self._map_lock:
            # async mapping lag: the distance triggers would compare against
            # a STALE newest keyframe; fall back to the counter cadence
            # until mapping catches up
            if len(self.store.frames) < self._kf_count:
                return False
            last = self.store.frames[-1]
            last_R, last_t = last.R_wc, last.t_wc
        dt = np.linalg.norm(info["t_wc"] - last_t)
        dR = last_R.T @ info["R_wc"]
        ang = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
        return bool(
            dt > self.config.keyframe_min_translation
            or ang > self.config.keyframe_min_rotation
        )

    # ------------------------------------------------------------------
    def _assign_tracks(self, kf: Keyframe, kf_index: int) -> None:
        """Associate a new keyframe's keypoints with the persistent track
        set (one match against the recent tracks), spawning tracks for
        unmatched keypoints with valid stereo depth."""
        tr = self.tracks
        kp_desc = kf.desc_host()
        kp_valid = kf.valid_host()
        track_ids = np.full(kp_desc.shape[0], -1, np.int32)
        # the match runs OUTSIDE the map lock: the mapping thread is the only
        # writer of the track table, so its own read is stable
        idx = ok = None
        if tr.alive.any():
            with self.timer.stage("map_match"):
                idx, ok = self._match_recent(kf, tr)
        with self._map_lock:
            self._apply_track_assignment(kf, kf_index, track_ids, kp_desc, kp_valid, idx, ok)

    def _match_recent(self, kf: Keyframe, tr: TrackStore):
        """Match a keyframe's descriptors against the track table, using a
        compact buffer of the ``assoc_capacity`` most recently seen alive
        tracks when the table is larger.  Returns (global_track_idx, ok)
        host arrays."""
        dev = self.device
        A = self.config.assoc_capacity
        if A is not None and A < tr.capacity:
            cand = np.where(tr.alive)[0]
            if cand.size > A:
                cand = cand[np.argsort(-tr.last_seen[cand], kind="stable")[:A]]
            sub_desc = np.zeros((A, tr.desc.shape[1]), tr.desc.dtype)
            sub_alive = np.zeros(A, bool)
            sub_desc[: cand.size] = tr.desc[cand]
            sub_alive[: cand.size] = True
            idx_d, ok_d = feat_ops.match_desc(
                kf.kp.desc, kf.kp.valid,
                _desc_to_device(sub_desc, dev), torch.from_numpy(sub_alive).to(dev))
            both = torch.stack([idx_d, ok_d.to(torch.int32)]).cpu().numpy()
            idx, ok = both[0], both[1].astype(bool)
            # map buffer slots back to global track ids
            pad = np.full(A, -1, np.int64)
            pad[: cand.size] = cand
            idx = pad[np.maximum(idx, 0)].astype(np.int32)
            ok = ok & (idx >= 0)
            return idx, ok
        idx_d, ok_d = feat_ops.match_desc(
            kf.kp.desc, kf.kp.valid,
            _desc_to_device(tr.desc, dev), torch.from_numpy(tr.alive).to(dev))
        both = torch.stack([idx_d, ok_d.to(torch.int32)]).cpu().numpy()
        return both[0], both[1].astype(bool)

    def _apply_track_assignment(self, kf, kf_index, track_ids, kp_desc,
                                kp_valid, idx, ok) -> None:
        tr = self.tracks
        if idx is not None:
            track_ids[ok] = idx[ok]
            tr.last_seen[idx[ok]] = kf_index
            tr.n_obs[idx[ok]] += 1
            tr.desc[idx[ok]] = kp_desc[ok]       # drift with appearance

        new_mask = (track_ids < 0) & kp_valid & kf.pts_valid
        n_new = int(new_mask.sum())
        if n_new:
            # never recycle a slot the current BA window may still observe
            slots = tr.allocate(n_new, protect_after=kf_index - self.config.window_size)
            n_new = len(slots)
            recycled = slots[tr.alive[slots]]
            if recycled.size:
                # stale ids in older stored keyframes must not alias the
                # respawned landmark: one boolean LUT + fancy index per
                # keyframe (id −1 lands on the extra always-False slot)
                hit = np.zeros(tr.capacity + 1, bool)
                hit[recycled] = True
                for old_kf in self.store.frames:
                    tid = old_kf.track_ids
                    if tid is not None:
                        tid[hit[tid]] = -1
            sel = np.where(new_mask)[0][:n_new]
            world = (kf.R_wc @ kf.pts_cam[sel].T).T + kf.t_wc
            tr.pos_w[slots] = world
            tr.desc[slots] = kp_desc[sel]
            tr.alive[slots] = True
            tr.last_seen[slots] = kf_index
            tr.n_obs[slots] = 1
            track_ids[sel] = slots
        kf.track_ids = track_ids
        tr.version += 1

    def _window_problem(self, win: list):
        """Build the BA problem over the window from persistent tracks:
        landmarks = tracks observed by ≥2 window keyframes (most-observed
        first, up to the padded capacity)."""
        cfg = self.config
        M = len(win)
        N = cfg.ba_landmarks
        ids = np.concatenate([k.track_ids for k in win])
        ids = ids[ids >= 0]
        if ids.size == 0:
            return None
        counts = np.bincount(ids, minlength=self.tracks.capacity)
        cand = np.where(counts >= 2)[0]
        if cand.size < 8:
            return None
        cand = cand[np.argsort(-counts[cand])][:N]
        n_eff = len(cand)
        # landmark slot lookup: track id → [0, n_eff)
        lut = np.full(self.tracks.capacity, -1, np.int32)
        lut[cand] = np.arange(n_eff, dtype=np.int32)

        pts_w = np.zeros((N, 3), np.float64)
        pts_w[:n_eff] = self.tracks.pos_w[cand]
        pts_w[n_eff:, 2] = 1.0                   # benign padding depth
        obs = np.zeros((M, N, 2), np.float32)
        mask = np.zeros((M, N), np.float32)
        for m, kf in enumerate(win):
            kp_xy = kf.xy_host()
            has = kf.track_ids >= 0
            slot = np.where(has, lut[np.maximum(kf.track_ids, 0)], -1)
            use = slot >= 0
            obs[m, slot[use]] = kp_xy[use]
            mask[m, slot[use]] = 1.0
        return cand, pts_w, obs, mask, n_eff

    def _local_ba(self) -> None:
        """Windowed BA over the persistent track set: every track observed
        by ≥2 window keyframes is one shared variable; refined positions
        are written back to the table so the NEXT window (and the pose
        graph) starts from them."""
        cfg = self.config
        dev = self.device
        # build under the map lock (window poses + track table snapshot);
        # the SOLVE below runs unlocked so async tracking never waits on it
        with self._map_lock:
            win = self.store.window(cfg.window_size)
            if len(win) < 2:
                return
            built = self._window_problem(win)
            if built is None:
                return
            cand, pts_w, obs, mask, n_eff = built
            # world→camera poses
            R_cw = np.stack([k.R_wc.T for k in win])
            t_cw = np.stack([-(k.R_wc.T @ k.t_wc) for k in win])
            # pre-solve pose of the newest keyframe: the correction delta
            # below is computed against it
            R_kf_old = win[-1].R_wc.copy()
            t_kf_old = win[-1].t_wc.copy()
        N = cfg.ba_landmarks

        fx, cx, cy = self._cam()
        p = BA.BAProblem(R=_f32(R_cw, dev), t=_f32(t_cw, dev), points=_f32(pts_w, dev),
                         obs=_f32(obs, dev), mask=_f32(mask, dev), fx=fx, cx=cx, cy=cy)
        lm_valid = np.zeros((N,), np.float32)
        lm_valid[:n_eff] = 1.0
        prior = _f32(cfg.stereo_point_prior * lm_valid, dev)
        if self._ba_mesh is not None and N % self._ba_mesh.size == 0:
            pf, _ = bundle_adjust_sharded(p, self._ba_mesh, iters=cfg.ba_iters,
                                          point_prior=prior)
        else:
            pf, _ = BA.bundle_adjust(p, iters=cfg.ba_iters, point_prior=prior)

        # per-landmark reprojection rms at the solution: a landmark that
        # cannot fit the rigid window solve is purged from the map below
        r_dev, _ = BA.reprojection_residuals(pf)
        rn2 = torch.sum(r_dev * r_dev, -1)
        lm_rms = torch.sqrt(torch.sum(rn2 * p.mask, 0)
                            / torch.clamp(torch.sum(p.mask, 0), min=1.0))
        Rf, tf, pts_f, lm_rms_h = _host(pf.R, pf.t, pf.points, lm_rms)
        with self._map_lock:
            for m, kf in enumerate(win):
                # project onto SO(3): the solver's rotations carry small
                # non-orthogonality which the delta re-anchor below would
                # otherwise compound
                kf.R_wc = _project_so3(Rf[m].T)
                kf.t_wc = -(kf.R_wc @ tf[m])
            self.tracks.pos_w[cand] = pts_f[:n_eff]
            rej = cfg.track_reject_rms_px
            if rej > 0:
                bad = cand[lm_rms_h[:n_eff] > rej]
                if bad.size:
                    # purge: kill the table slots and unlink the ids from the
                    # window keyframes
                    self.tracks.alive[bad] = False
                    hit = np.zeros(self.tracks.capacity + 1, bool)
                    hit[bad] = True
                    for kf in win:
                        if kf.track_ids is not None:
                            kf.track_ids[hit[kf.track_ids]] = -1
            self.tracks.version += 1
            # re-anchor the live VO pose: apply the newest keyframe's
            # pre→post-BA correction as a DELTA to the current pose (in
            # synchronous stepping the plain overwrite; under async mapping
            # it keeps the motion composed since the keyframe)
            R_old = _project_so3(R_kf_old)
            dR = win[-1].R_wc @ R_old.T
            dt = win[-1].t_wc - dR @ t_kf_old
            self.vo.state.R_wc = _project_so3(dR @ self.vo.state.R_wc)
            self.vo.state.t_wc = dR @ self.vo.state.t_wc + dt

    # ------------------------------------------------------------------
    def detect_loop_closures(
        self,
        min_separation: int = 4,
        min_matches: int = 30,
        max_rms_px: float = 2.0,
        max_candidates: int = 32,
    ) -> list[tuple[int, int, np.ndarray, np.ndarray]]:
        """Appearance-based loop closure, batched over keyframe pairs:

          1. **candidate scoring** — per-keyframe bit-frequency signatures
             and ONE (K × K) cosine matmul; pairs separated by ≥
             ``min_separation`` keyframes keep their score, the top
             ``max_candidates`` go forward;
          2. **batched matching** — ``match_desc`` over the stacked
             candidate pairs (leading pair axis);
          3. **batched PnP** — Gauss-Newton verification of every pair with
             ≥ ``min_matches`` matches, inlier-gated and refined.

        Returns (i, j, R_ij, t_ij) relative-pose measurements (pose of j in
        i's frame) for pairs passing the ``max_rms_px`` gate."""
        frames = self.store.frames
        K = len(frames)
        if K < min_separation + 1:
            return []
        dev = self.device
        desc = torch.stack([f.kp.desc for f in frames])         # (K, F, 8)
        kvalid = torch.stack([f.kp.valid for f in frames])      # (K, F)
        xy = torch.stack([f.kp.xy for f in frames])             # (K, F, 2)
        pts = _f32(np.stack([f.pts_cam for f in frames]), dev)
        pvalid = torch.from_numpy(np.stack([f.pts_valid for f in frames])).to(dev)

        # 1) appearance similarity: (K, 256) signatures → (K, K) cosine
        sigs = feat_ops.descriptor_signature(desc, kvalid)
        sim = (sigs @ sigs.T).cpu().numpy()
        ii = np.arange(K)[:, None]
        jj = np.arange(K)[None, :]
        scores = np.where(jj - ii >= min_separation, sim, -np.inf)
        order = np.argsort(scores.ravel())[::-1][:max_candidates]
        order = order[np.isfinite(scores.ravel()[order])]
        if order.size == 0:
            return []
        ci_h, cj_h = order // K, order % K
        ci, cj = torch.from_numpy(ci_h).to(dev), torch.from_numpy(cj_h).to(dev)

        # 2) mutual-NN matching over all candidate pairs
        idx, ok = feat_ops.match_desc(desc[ci], kvalid[ci], desc[cj], kvalid[cj])
        ok = ok & pvalid[ci]
        counts = ok.sum(1).cpu().numpy()
        keep_h = np.where(counts >= min_matches)[0]
        if keep_h.size == 0:
            return []
        keep = torch.from_numpy(keep_h).to(dev)
        ki, kj = ci[keep], cj[keep]

        # 3) PnP verification (points of the OLDER keyframe i observed in the
        # NEWER j) over all surviving pairs
        sel = torch.clamp(idx[keep], min=0).to(torch.int64)
        obs = torch.gather(xy[kj], 1, sel[..., None].expand(-1, -1, 2))
        w = ok[keep].to(torch.float32)
        fx, cx, cy = self._cam()
        P = keep_h.size
        R, t, _ = pnp_gauss_newton(
            pts[ki], obs, w, fx=fx, cx=cx, cy=cy,
            R0=torch.eye(3, device=dev).expand(P, 3, 3),
            t0=torch.zeros(P, 3, device=dev), iters=12)
        # cross-keyframe match sets carry outliers that inflate the raw rms
        # even when the pose is right: gate on the INLIER count at the
        # solved pose, refine on inliers, then gate the refined rms
        inl = inlier_gate(pts[ki], obs, w > 0, R, t, fx, cx, cy, max_rms_px)
        R, t, rms = pnp_gauss_newton(pts[ki], obs, inl.to(torch.float32),
                                     fx=fx, cx=cx, cy=cy, R0=R, t0=t, iters=8)
        R, t, rms, n_inl = _host(R, t, rms, inl.sum(1))

        closures = []
        for n in range(P):
            if n_inl[n] < min_matches or rms[n] > max_rms_px:
                continue
            # PnP gives T_j←i (points of i seen in j) ⇒ T_ij = inverse
            R_ij, t_ij = R[n].T, -(R[n].T @ t[n])
            closures.append((int(ci_h[keep_h[n]]), int(cj_h[keep_h[n]]), R_ij, t_ij))
        closures.sort(key=lambda c: (c[0], c[1]))
        return closures

    def optimize_global(self, iters: int = 10, with_loop_closures: bool = True) -> int:
        """Pose-graph optimisation over all keyframes: odometry edges plus
        geometrically-verified loop closures.  Returns the number of
        closure edges used."""
        if len(self.store) < 3:
            return 0
        dev = self.device
        R = _f32(np.stack([k.R_wc for k in self.store.frames]), dev)
        t = _f32(np.stack([k.t_wc for k in self.store.frames]), dev)
        ei, ej, Rm, tm, w = PG.odometry_edges(R, t)
        closures = self.detect_loop_closures() if with_loop_closures else []
        if closures:
            ci = torch.tensor([c[0] for c in closures], dtype=torch.int32, device=dev)
            cj = torch.tensor([c[1] for c in closures], dtype=torch.int32, device=dev)
            ei, ej = torch.cat([ei, ci]), torch.cat([ej, cj])
            Rm = torch.cat([Rm, _f32(np.stack([c[2] for c in closures]), dev)])
            tm = torch.cat([tm, _f32(np.stack([c[3] for c in closures]), dev)])
            # closures outweigh odometry
            w = torch.cat([w, torch.full((len(closures),), 5.0, device=dev)])
        g = PG.PoseGraph(R=R, t=t, edge_i=ei, edge_j=ej, R_meas=Rm, t_meas=tm, weight=w)
        old = [(k.R_wc.copy(), k.t_wc.copy(), k.stamp) for k in self.store.frames]
        gf, _ = PG.optimize_pose_graph(g, iters=iters)
        Rf, tf = _host(gf.R, gf.t)
        for i, kf in enumerate(self.store.frames):
            kf.R_wc, kf.t_wc = Rf[i], tf[i]

        # propagate the correction to the per-frame trajectory: each frame is
        # rigidly attached to its most recent keyframe — apply that
        # keyframe's pose delta (T_new ∘ T_old⁻¹)
        kf_stamps = np.asarray([s for (_, _, s) in old])
        for fi, stamp in enumerate(self.traj_stamps):
            ki = int(np.searchsorted(kf_stamps, stamp, side="right")) - 1
            if ki < 0:
                continue
            R_old, t_old, _ = old[ki]
            dR = Rf[ki] @ R_old.T
            dt = tf[ki] - dR @ t_old
            self.traj_R[fi] = dR @ self.traj_R[fi]
            self.traj_t[fi] = dR @ self.traj_t[fi] + dt
        # persistent tracks ride their last-observing keyframe's correction
        alive = np.where(self.tracks.alive)[0]
        if alive.size:
            ki = np.clip(self.tracks.last_seen[alive], 0, len(old) - 1)
            for k in np.unique(ki):
                R_old, t_old, _ = old[int(k)]
                dR = Rf[int(k)] @ R_old.T
                dt = tf[int(k)] - dR @ t_old
                sel = alive[ki == k]
                self.tracks.pos_w[sel] = (dR @ self.tracks.pos_w[sel].T).T + dt
            self.tracks.version += 1
        # live VO pose rides the newest keyframe too
        R_old, t_old, _ = old[-1]
        dR = Rf[-1] @ R_old.T
        dt = tf[-1] - dR @ t_old
        self.vo.state.R_wc = dR @ self.vo.state.R_wc
        self.vo.state.t_wc = dR @ self.vo.state.t_wc + dt
        return len(closures)

    # ------------------------------------------------------------------
    def trajectory(self) -> Trajectory:
        return Trajectory(
            stamps=np.asarray(self.traj_stamps),
            t=np.stack(self.traj_t) if self.traj_t else np.zeros((0, 3)),
            R=np.stack(self.traj_R) if self.traj_R else None,
        )

    # ------------------------------------------------------------------
    # Checkpoint / resume
    # ------------------------------------------------------------------
    def state_dict(self) -> dict:
        """The engine's state as numpy arrays, with the keys of the JAX
        engine's checkpoint."""
        return {
            "store": self.store.to_pytree(),
            "tracks": self.tracks.to_pytree(),
            "traj_stamps": np.asarray(self.traj_stamps),
            "traj_R": np.stack(self.traj_R) if self.traj_R else np.zeros((0, 3, 3)),
            "traj_t": np.stack(self.traj_t) if self.traj_t else np.zeros((0, 3)),
            "vo_R": self.vo.state.R_wc,
            "vo_t": self.vo.state.t_wc,
        }

    def save_checkpoint(self, path: str) -> None:
        """``torch.save`` of :meth:`state_dict` as a dict of tensors (uint32
        descriptor words kept as uint32)."""
        torch.save(_to_tensors(self.state_dict()), path)

    def load_checkpoint(self, path: str) -> None:
        self.load_state(_to_numpy(torch.load(path, map_location="cpu", weights_only=True)))

    def load_state(self, d: dict) -> None:
        """Resume from a state dict of numpy arrays — this engine's
        :meth:`state_dict`, or the dict the JAX engine checkpoints (its
        ``store``/``tracks`` pytrees, trajectory and VO pose).  The next
        frame starts a new VO chain from the restored pose."""
        self.store = KeyframeStore.from_pytree(d["store"], self.device)
        self._kf_count = len(self.store)
        if "tracks" in d:
            self.tracks = TrackStore.from_pytree(d["tracks"])
        self.traj_stamps = list(np.asarray(d["traj_stamps"]))
        self.traj_R = list(np.asarray(d["traj_R"]))
        self.traj_t = list(np.asarray(d["traj_t"]))
        self.vo.reset()
        self.vo.state.R_wc = np.asarray(d["vo_R"])
        self.vo.state.t_wc = np.asarray(d["vo_t"])

