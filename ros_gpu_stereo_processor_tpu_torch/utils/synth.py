"""Synthetic EuRoC-layout dataset generation (validation sequences), numpy only.

The port's copy of ``ros_gpu_stereo_processor_tpu/utils/synth.py``: a
textured plane (or a stack of planes) imaged under a 6-dof loop trajectory
is an exact homography warp of one texture, so ground truth is exact.  The
same poses, the same random textures from the same seed and the same
EuRoC MAV directory layout (mav0/cam{0,1}/data(.csv),
mav0/state_groundtruth_estimate0/data.csv) as the JAX package's module.

The JAX module renders with ``cv2``; this one renders with numpy (a
Gaussian blur, a bicubic resize and a perspective warp of its own, each
modelled on OpenCV's: reflect-101 borders for the blur, replicated borders
for the resize, source coordinates quantised to 1/32 pixel and zero outside
the image for the warp), so it runs where ``cv2`` is absent.  Its frames
differ from cv2's by rounding only (mean |Δ| under one grey level).
:func:`render_planar`, :func:`render_layered` and :func:`render_6dof` (the
homography sequence of tests/test_vo_6dof.py) return the frames and the
ground truth in memory, for machines without an image writer;
``render_layered(..., workers=N)`` renders in N processes, byte-equal to the
serial render.

Geometry convention matches models/vo.py: poses are world←camera (T_wc),
reference camera at the origin looking down +z at the plane z = Z0.
"""

from __future__ import annotations

import os
from typing import List, Tuple

import numpy as np

from ros_gpu_stereo_processor_tpu_torch.utils.evaluate import Trajectory


def rot_to_quat(R: np.ndarray) -> np.ndarray:
    """(3, 3) rotation → quaternion (w, x, y, z)."""
    w = np.sqrt(max(0.0, 1.0 + R[0, 0] + R[1, 1] + R[2, 2])) / 2.0
    if w > 1e-8:
        x = (R[2, 1] - R[1, 2]) / (4 * w)
        y = (R[0, 2] - R[2, 0]) / (4 * w)
        z = (R[1, 0] - R[0, 1]) / (4 * w)
    else:  # w≈0: pick the dominant axis
        i = int(np.argmax(np.diag(R)))
        j, k = (i + 1) % 3, (i + 2) % 3
        s = np.sqrt(max(0.0, 1.0 + R[i, i] - R[j, j] - R[k, k])) * 2.0
        q = np.zeros(4)
        q[1 + i] = s / 4
        q[1 + j] = (R[j, i] + R[i, j]) / s
        q[1 + k] = (R[k, i] + R[i, k]) / s
        q[0] = (R[k, j] - R[j, k]) / s
        return q
    return np.array([w, x, y, z])


def _plane_homography(K: np.ndarray, R_cw: np.ndarray, t_cw: np.ndarray,
                      Z0: float) -> np.ndarray:
    """Homography mapping reference-camera pixels of the plane z=Z0 into the
    camera at world→cam (R_cw, t_cw); plane normal [0,0,1], distance Z0."""
    n = np.array([0.0, 0.0, 1.0])
    H = R_cw + np.outer(t_cw, n) / Z0
    return K @ H @ np.linalg.inv(K)


def _se3_exp_np(xi: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Numpy SE(3) exponential (Rodrigues + left Jacobian)."""
    rho, omega = xi[:3], xi[3:]
    th = np.linalg.norm(omega)
    wx = np.array([[0, -omega[2], omega[1]],
                   [omega[2], 0, -omega[0]],
                   [-omega[1], omega[0], 0]])
    if th < 1e-10:
        return np.eye(3) + wx, rho
    A = np.sin(th) / th
    B = (1 - np.cos(th)) / th**2
    C = (1 - A) / th**2
    R = np.eye(3) + A * wx + B * (wx @ wx)
    V = np.eye(3) + B * wx + C * (wx @ wx)
    return R, V @ rho


def loop_trajectory(n_frames: int, radius: float = 0.3,
                    yaw_amp: float = 0.08) -> list:
    """A closed loop: lateral circle + yaw wobble, ending where it began
    (a loop-closure opportunity for the pose graph).  Returns [(R_wc, t_wc)]."""
    poses = []
    for i in range(n_frames):
        a = 2.0 * np.pi * i / n_frames
        xi = np.array([
            radius * np.sin(a),                 # x
            0.5 * radius * (1 - np.cos(a)),     # y
            0.1 * radius * np.sin(2 * a),       # z
            0.02 * np.sin(a),                   # roll
            0.02 * np.cos(a) - 0.02,            # pitch
            yaw_amp * np.sin(a),                # yaw
        ])
        poses.append(_se3_exp_np(xi))
    return poses


# ---------------------------------------------------------------------------
# numpy image operations (OpenCV's semantics, float arithmetic)
# ---------------------------------------------------------------------------


def _to_u8(f: np.ndarray) -> np.ndarray:
    return np.clip(np.floor(f + 0.5), 0, 255).astype(np.uint8)


def _gaussian_blur(img: np.ndarray, ksize: int, sigma: float) -> np.ndarray:
    """Separable Gaussian, ``ksize`` taps, reflect-101 borders."""
    r = ksize // 2
    x = np.arange(ksize, dtype=np.float64) - r
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    k /= k.sum()
    f = img.astype(np.float64)
    for axis in (0, 1):
        pad = [(0, 0), (0, 0)]
        pad[axis] = (r, r)
        p = np.pad(f, pad, mode="reflect")
        n = f.shape[axis]
        f = sum(k[i] * np.take(p, np.arange(i, i + n), axis=axis) for i in range(ksize))
    return _to_u8(f)


def _cubic_weights(t: np.ndarray) -> np.ndarray:
    """(…, 4) Keys cubic weights (A = −0.75) at offsets −1, 0, 1, 2."""
    A = -0.75
    w0 = ((A * (t + 1) - 5 * A) * (t + 1) + 8 * A) * (t + 1) - 4 * A
    w1 = ((A + 2) * t - (A + 3)) * t * t + 1
    w2 = ((A + 2) * (1 - t) - (A + 3)) * (1 - t) * (1 - t) + 1
    return np.stack([w0, w1, w2, 1.0 - w0 - w1 - w2], -1)


def _resize_cubic(img: np.ndarray, size: Tuple[int, int]) -> np.ndarray:
    """Bicubic resize to (width, height), pixel centres aligned, replicated
    borders."""
    out_w, out_h = size
    f = img.astype(np.float64)
    for axis, n_out in ((0, out_h), (1, out_w)):
        n_in = f.shape[axis]
        src = (np.arange(n_out) + 0.5) * (n_in / n_out) - 0.5
        s0 = np.floor(src).astype(np.int64)
        w = _cubic_weights(src - s0)
        acc = 0.0
        for j in range(4):
            idx = np.clip(s0 + j - 1, 0, n_in - 1)
            wj = w[:, j][:, None] if axis == 0 else w[:, j][None, :]
            acc = acc + wj * np.take(f, idx, axis=axis)
        f = acc
    return _to_u8(f)


def _warp_coords(H: np.ndarray, size: Tuple[int, int]) -> Tuple[np.ndarray, np.ndarray]:
    """Source coordinates (X, Y) of every destination pixel: H⁻¹ (x, y)."""
    W, Hh = size
    Minv = np.linalg.inv(H)
    yy, xx = np.mgrid[0:Hh, 0:W].astype(np.float64)
    den = Minv[2, 0] * xx + Minv[2, 1] * yy + Minv[2, 2]
    den = np.where(den != 0, 1.0 / np.where(den != 0, den, 1.0), 0.0)
    X = (Minv[0, 0] * xx + Minv[0, 1] * yy + Minv[0, 2]) * den
    Y = (Minv[1, 0] * xx + Minv[1, 1] * yy + Minv[1, 2]) * den
    return X, Y


def _tap(src: np.ndarray, yi: np.ndarray, xi: np.ndarray) -> np.ndarray:
    sh, sw = src.shape
    ok = (yi >= 0) & (yi < sh) & (xi >= 0) & (xi < sw)
    return np.where(ok, src[np.clip(yi, 0, sh - 1), np.clip(xi, 0, sw - 1)], 0.0)


def _sample_nearest(img: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """img at the nearest pixel of each (X, Y), zero outside."""
    return _tap(img.astype(np.float64), np.rint(Y).astype(np.int64),
                np.rint(X).astype(np.int64)).astype(img.dtype)


def _sample_bilinear(img: np.ndarray, X: np.ndarray, Y: np.ndarray) -> np.ndarray:
    """img bilinearly at each (X, Y) quantised to 1/32 pixel, zero outside;
    elementwise, so a subset of the coordinates gives that subset of the
    values."""
    src = img.astype(np.float64)
    Xq = np.rint(X * 32.0)
    Yq = np.rint(Y * 32.0)
    x0 = np.floor(Xq / 32.0).astype(np.int64)
    y0 = np.floor(Yq / 32.0).astype(np.int64)
    fx = Xq / 32.0 - x0
    fy = Yq / 32.0 - y0
    out = ((1 - fy) * ((1 - fx) * _tap(src, y0, x0) + fx * _tap(src, y0, x0 + 1))
           + fy * ((1 - fx) * _tap(src, y0 + 1, x0) + fx * _tap(src, y0 + 1, x0 + 1)))
    return _to_u8(out)


def _warp_perspective(img: np.ndarray, H: np.ndarray, size: Tuple[int, int],
                      nearest: bool = False) -> np.ndarray:
    """dst(x, y) = src(H⁻¹ (x, y)), zero outside the source image.  Bilinear
    (source coordinates quantised to 1/32 pixel) or nearest."""
    X, Y = _warp_coords(H, size)
    return (_sample_nearest if nearest else _sample_bilinear)(img, X, Y)


# ---------------------------------------------------------------------------
# Sequences
# ---------------------------------------------------------------------------


def _stamp_ns(i: int, fps: float) -> int:
    return int((1.0 + i / fps) * 1e9)


def _ground_truth(poses, fps: float) -> Trajectory:
    return Trajectory(
        stamps=np.asarray([_stamp_ns(i, fps) * 1e-9 for i in range(len(poses))]),
        t=np.stack([t for _, t in poses]),
        R=np.stack([R for R, _ in poses]),
    )


def render_planar(
    n_frames: int = 80,
    width: int = 400,
    height: int = 300,
    fx: float = 350.0,
    baseline: float = 0.1,
    Z0: float = 3.0,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.3,
) -> Tuple[List[np.ndarray], List[np.ndarray], Trajectory]:
    """The frames of :func:`make_planar_euroc`, in memory: (lefts, rights,
    ground truth); frame i's stamp is ``gt.stamps[i]``."""
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 255, (height, width), np.uint8)
    tex = _gaussian_blur(tex, 3, 0.6)

    Hlr = _plane_homography(K, np.eye(3), np.array([-baseline, 0.0, 0.0]), Z0)
    poses = loop_trajectory(n_frames, radius=radius)
    lefts, rights = [], []
    for R_wc, t_wc in poses:
        R_cw, t_cw = R_wc.T, -(R_wc.T @ t_wc)
        Hl = _plane_homography(K, R_cw, t_cw, Z0)
        lefts.append(_warp_perspective(tex, Hl, (width, height)))
        rights.append(_warp_perspective(tex, Hlr @ Hl, (width, height)))
    return lefts, rights, _ground_truth(poses, fps)


def render_6dof(
    n_frames: int = 6,
    width: int = 400,
    height: int = 300,
    fx: float = 350.0,
    baseline: float = 0.1,
    Z0: float = 2.5,
    seed: int = 0,
    blur=None,
    warp=None,
) -> Tuple[List[np.ndarray], List[np.ndarray], list]:
    """The 6-dof homography sequence of tests/test_vo_6dof.py, in memory: a
    textured fronto-parallel plane at ``Z0`` seen under translation plus
    yaw/pitch wobble (frame i: xi = (0.02 i, 0.004 i, 0.006 i, 0, 0.004 i,
    0.002 i)), each view an exact homography warp of one texture and the
    right view the left one shifted by fx·B/Z0.  Returns (lefts, rights,
    [(R_wc, t_wc)]).  ``blur(tex)`` and ``warp(img, H, (width, height))``
    default to this module's numpy versions of OpenCV's 3×3 σ 0.6 Gaussian
    and bilinear ``warpPerspective``; pass cv2's to render as that test
    does."""
    blur = blur or (lambda t: _gaussian_blur(t, 3, 0.6))
    warp = warp or _warp_perspective
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)
    tex = blur(rng.integers(0, 255, (height, width), np.uint8))
    Hlr = _plane_homography(K, np.eye(3), np.array([-baseline, 0.0, 0.0]), Z0)
    lefts, rights, poses = [], [], []
    for i in range(n_frames):
        R_wc, t_wc = _se3_exp_np(np.array([0.02 * i, 0.004 * i, 0.006 * i,
                                           0.0, 0.004 * i, 0.002 * i]))
        Hl = _plane_homography(K, R_wc.T, -(R_wc.T @ t_wc), Z0)
        lefts.append(warp(tex, Hl, (width, height)))
        rights.append(warp(tex, Hlr @ Hl, (width, height)))
        poses.append((R_wc, t_wc))
    return lefts, rights, poses


def _layered_view(scene: dict, R_cw: np.ndarray, t_cw: np.ndarray, right: bool, i: int,
                  rng: np.random.Generator) -> np.ndarray:
    """One view of frame ``i`` of the layered scene: the planes composited
    far→near, the occluders, then the photometric nuisance (its sensor noise
    is ``rng``'s next (H, W) normal draw) and the degradation."""
    width, height, fx, baseline = (scene[k] for k in ("width", "height", "fx", "baseline"))
    img = np.zeros((height, width), np.uint8)
    # rectified right camera: same orientation, centre offset b·e_x
    # along the left camera's x-axis ⇒ world→right is (R_cw, t_cw − b·e_x)
    t_cam = t_cw - (np.array([baseline, 0.0, 0.0]) if right else 0.0)
    for Zk, tex, mask in sorted(scene["planes"], key=lambda p: -p[0]):
        Hc = _plane_homography(scene["K"], R_cw, t_cam, Zk) @ scene["T_canvas"]
        X, Y = _warp_coords(Hc, (width, height))
        # the texture only where the plane's mask keeps it (the samples
        # are elementwise, so this is the full warp at those pixels)
        keep = _sample_nearest(mask, X, Y) > 127
        img[keep] = _sample_bilinear(tex, X[keep], Y[keep])
    for oc in scene["occluders"]:
        px = oc["cx"] + oc["ax"] * np.sin(oc["wx"] * i + oc["ph"])
        py = oc["cy"] + oc["ay"] * np.sin(oc["wy"] * i + 2 * oc["ph"])
        if right:
            px -= fx * baseline / oc["z"]
        oh, ow = oc["tex"].shape
        x0, y0 = int(px - ow / 2), int(py - oh / 2)
        sx0, sy0 = max(0, -x0), max(0, -y0)
        dx0, dy0 = max(0, x0), max(0, y0)
        dx1 = min(width, x0 + ow)
        dy1 = min(height, y0 + oh)
        if dx1 > dx0 and dy1 > dy0:
            img[dy0:dy1, dx0:dx1] = oc["tex"][
                sy0 : sy0 + dy1 - dy0, sx0 : sx0 + dx1 - dx0]
    if scene["photometric"]:
        gain = 1.0 + 0.06 * np.sin(0.37 * i + (1.1 if right else 0.0))
        bias = 3.0 * np.sin(0.23 * i + (0.7 if right else 0.0))
        f = img.astype(np.float64) * scene["vignette"] * gain + bias
        if scene["exposure_banding"] > 0.0:
            rows_n = np.arange(height, dtype=np.float64)[:, None]
            band = 1.0 + scene["exposure_banding"] * np.sin(
                2 * np.pi * rows_n / height + 0.9 * i
                + (0.5 if right else 0.0))
            f *= band
        f += rng.normal(0.0, 2.0, f.shape)
        img = np.clip(f, 0, 255).astype(np.uint8)
    if i in scene["degraded_frames"]:
        img = _gaussian_blur(img, 51, 12.0)
        img = (img * 0.25).astype(np.uint8)
    return img


def _layered_scene(width, height, fx, baseline, seed, depths, photometric, degraded_frames,
                   dynamic_occluders, occluder_speed, exposure_banding):
    """The layered scene of :func:`render_layered` (textured planes,
    occluders, vignetting) and the generator after drawing it, positioned
    at the first frame's sensor noise."""
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    rng = np.random.default_rng(seed)

    # canvases are 2× the frame so the view stays covered under the loop
    # motion; canvas pixel (u, v) ↔ reference pixel (u − W/2, v − H/2)
    cw, ch = 2 * width, 2 * height
    T_canvas = np.array([[1.0, 0, -width / 2], [0, 1.0, -height / 2],
                         [0, 0, 1.0]])

    def make_canvas(fill_rect=None):
        tex = rng.integers(0, 255, (ch, cw), np.uint8)
        tex = _gaussian_blur(tex, 5, 1.0)
        # low-frequency structure so matching has distinctive corners
        blobs = _resize_cubic(
            rng.integers(0, 255, (ch // 40, cw // 40), np.uint8), (cw, ch))
        tex = (0.55 * tex + 0.45 * blobs).astype(np.uint8)
        mask = np.zeros((ch, cw), np.uint8)
        if fill_rect is None:
            mask[:] = 255
        else:
            x0, y0, x1, y1 = fill_rect
            mask[y0:y1, x0:x1] = 255
        return tex, mask

    planes = []
    bg_tex, bg_mask = make_canvas()
    planes.append((depths[0], bg_tex, bg_mask))
    rects = [
        (int(cw * 0.10), int(ch * 0.15), int(cw * 0.42), int(ch * 0.55)),
        (int(cw * 0.55), int(ch * 0.35), int(cw * 0.88), int(ch * 0.80)),
        (int(cw * 0.33), int(ch * 0.58), int(cw * 0.62), int(ch * 0.92)),
    ]
    for Zk, rect in zip(depths[1:], rects):
        tex, mask = make_canvas(fill_rect=rect)
        planes.append((Zk, tex, mask))

    # independently-moving occluders: small textured patches at a NEAR depth
    # following their own sinusoidal image-space paths (stereo-consistent:
    # the right view sees each patch shifted by its disparity fx·B/Z_occ)
    occluders = []
    for _ in range(dynamic_occluders):
        ow = int(width * rng.uniform(0.06, 0.12))
        oh = int(height * rng.uniform(0.08, 0.16))
        otex = _gaussian_blur(rng.integers(0, 255, (oh, ow), np.uint8), 3, 0.8)
        occluders.append(dict(
            tex=otex, z=float(rng.uniform(1.2, 1.8)),
            cx=rng.uniform(0.2, 0.8) * width,
            cy=rng.uniform(0.2, 0.8) * height,
            ax=rng.uniform(0.15, 0.35) * width,
            ay=rng.uniform(0.10, 0.25) * height,
            wx=occluder_speed * rng.uniform(0.05, 0.12),
            wy=occluder_speed * rng.uniform(0.05, 0.12),
            ph=rng.uniform(0, 2 * np.pi),
        ))

    # vignetting field (shared; real lenses don't change per frame)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    r2 = ((xx - width / 2) ** 2 + (yy - height / 2) ** 2) / (
        (width / 2) ** 2 + (height / 2) ** 2)
    vignette = 1.0 - 0.28 * r2

    scene = dict(width=width, height=height, fx=fx, baseline=baseline, K=K,
                 T_canvas=T_canvas, planes=planes, occluders=occluders,
                 vignette=vignette, photometric=photometric,
                 degraded_frames=tuple(degraded_frames),
                 exposure_banding=exposure_banding)
    return scene, rng


# the scene of a worker process of the parallel render, built once by the
# pool's initializer from the render's arguments (the canvases are not sent)
_WORKER_SCENE: dict = {}


def _init_render_worker(scene_args: tuple) -> None:
    _WORKER_SCENE.update(_layered_scene(*scene_args)[0])


def _render_pair_task(task) -> Tuple[np.ndarray, np.ndarray]:
    """Frame ``i``'s (left, right) in a worker: each view's noise is drawn
    from the generator state the serial render would hold before it."""
    i, R_cw, t_cw, states = task
    views = []
    for right, state in zip((False, True), states):
        rng = np.random.default_rng()
        if state is not None:
            rng.bit_generator.state = state
        views.append(_layered_view(_WORKER_SCENE, R_cw, t_cw, right, i, rng))
    return views[0], views[1]


def render_layered(
    n_frames: int = 200,
    width: int = 752,
    height: int = 480,
    fx: float = 441.0,
    baseline: float = 0.1,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.35,
    depths: Tuple[float, ...] = (7.0, 4.5, 3.0, 2.2),
    photometric: bool = True,
    degraded_frames: Tuple[int, ...] = (),
    dynamic_occluders: int = 0,
    occluder_speed: float = 1.0,
    exposure_banding: float = 0.0,
    workers: int = 1,
) -> Tuple[List[np.ndarray], List[np.ndarray], Trajectory]:
    """The frames of :func:`make_layered_euroc`, in memory: (lefts, rights,
    ground truth).  See :func:`make_layered_euroc` for the scene.

    ``workers`` > 1 renders the frames in a pool of that many spawned
    processes, each building the scene from the same arguments.  The frames
    are byte-equal to the serial render's: the only per-frame random draw is
    each view's sensor noise (left, then right), so this process first walks
    the generator through those draws in the serial order and hands each
    view the state it would start from."""
    scene_args = (width, height, fx, baseline, seed, tuple(depths), photometric,
                  tuple(degraded_frames), dynamic_occluders, occluder_speed,
                  exposure_banding)
    poses = loop_trajectory(n_frames, radius=radius)
    cam_poses = [(R_wc.T, -(R_wc.T @ t_wc)) for R_wc, t_wc in poses]
    if workers <= 1:
        scene, rng = _layered_scene(*scene_args)
        lefts, rights = [], []
        for i, (R_cw, t_cw) in enumerate(cam_poses):
            lefts.append(_layered_view(scene, R_cw, t_cw, False, i, rng))
            rights.append(_layered_view(scene, R_cw, t_cw, True, i, rng))
        return lefts, rights, _ground_truth(poses, fps)

    import multiprocessing

    with multiprocessing.get_context("spawn").Pool(
            min(workers, n_frames), _init_render_worker, (scene_args,)) as pool:
        # the workers build the scene while this process draws the noise
        _, rng = _layered_scene(*scene_args)
        tasks = []
        for i, (R_cw, t_cw) in enumerate(cam_poses):
            states = []
            for _ in range(2):
                states.append(rng.bit_generator.state if photometric else None)
                if photometric:
                    rng.normal(0.0, 2.0, (height, width))
            tasks.append((i, R_cw, t_cw, states))
        # a worker that cannot start leaves the pool waiting: the timeout
        # bounds that wait, and leaving the block terminates the workers
        pairs = pool.map_async(_render_pair_task, tasks, chunksize=1).get(
            timeout=60 + 10 * n_frames)
    return [p[0] for p in pairs], [p[1] for p in pairs], _ground_truth(poses, fps)


def _calib_yaml(path: str, name: str, W: int, H: int, fx: float,
                tx: float) -> None:
    doc = f"""image_width: {W}
image_height: {H}
camera_name: {name}
camera_matrix:
  rows: 3
  cols: 3
  data: [{fx}, 0, {W / 2}, 0, {fx}, {H / 2}, 0, 0, 1]
distortion_model: plumb_bob
distortion_coefficients:
  rows: 1
  cols: 5
  data: [0, 0, 0, 0, 0]
rectification_matrix:
  rows: 3
  cols: 3
  data: [1, 0, 0, 0, 1, 0, 0, 0, 1]
projection_matrix:
  rows: 3
  cols: 4
  data: [{fx}, 0, {W / 2}, {tx}, 0, {fx}, {H / 2}, 0, 0, 0, 1, 0]
"""
    with open(path, "w") as f:
        f.write(doc)


def _write_euroc(root: str, lefts, rights, gt: Trajectory, width: int,
                 height: int, fx: float, baseline: float, fps: float):
    """The EuRoC MAV layout of the JAX module: images, data.csv files,
    ground truth and the two calibration YAMLs."""
    from ros_gpu_stereo_processor_tpu_torch.utils.io import write_image

    for cam in ("cam0", "cam1"):
        os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
    gt_dir = os.path.join(root, "mav0", "state_groundtruth_estimate0")
    os.makedirs(gt_dir, exist_ok=True)

    rows = {"cam0": [], "cam1": []}
    gt_rows = []
    for i, (left, right) in enumerate(zip(lefts, rights)):
        ts = _stamp_ns(i, fps)
        for cam, img in (("cam0", left), ("cam1", right)):
            write_image(os.path.join(root, "mav0", cam, "data", f"{ts}.png"), img)
            rows[cam].append(f"{ts},{ts}.png")
        t_wc = gt.t[i]
        q = rot_to_quat(gt.R[i])
        gt_rows.append(
            f"{ts},{t_wc[0]:.9f},{t_wc[1]:.9f},{t_wc[2]:.9f},"
            f"{q[0]:.9f},{q[1]:.9f},{q[2]:.9f},{q[3]:.9f},0,0,0,0,0,0,0,0,0"
        )
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows[cam]) + "\n")
    with open(os.path.join(gt_dir, "data.csv"), "w") as f:
        f.write("#timestamp, p_RS_R_x [m], p_RS_R_y [m], p_RS_R_z [m], "
                "q_RS_w [], q_RS_x [], q_RS_y [], q_RS_z [], ...\n"
                + "\n".join(gt_rows) + "\n")

    cl = os.path.join(root, "calib_left.yaml")
    cr = os.path.join(root, "calib_right.yaml")
    _calib_yaml(cl, "left", width, height, fx, 0.0)
    _calib_yaml(cr, "right", width, height, fx, -fx * baseline)
    return cl, cr


def make_planar_euroc(
    root: str,
    n_frames: int = 80,
    width: int = 400,
    height: int = 300,
    fx: float = 350.0,
    baseline: float = 0.1,
    Z0: float = 3.0,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.3,
) -> Tuple[str, str]:
    """Render a planar-scene EuRoC-layout dataset with ground truth.

    Returns (calib_left_yaml, calib_right_yaml) paths (written under root).
    """
    lefts, rights, gt = render_planar(n_frames, width, height, fx, baseline, Z0,
                                      fps, seed, radius)
    return _write_euroc(root, lefts, rights, gt, width, height, fx, baseline, fps)


def make_layered_euroc(
    root: str,
    n_frames: int = 200,
    width: int = 752,
    height: int = 480,
    fx: float = 441.0,
    baseline: float = 0.1,
    fps: float = 10.0,
    seed: int = 0,
    radius: float = 0.35,
    depths: Tuple[float, ...] = (7.0, 4.5, 3.0, 2.2),
    photometric: bool = True,
    degraded_frames: Tuple[int, ...] = (),
    dynamic_occluders: int = 0,
    occluder_speed: float = 1.0,
    exposure_banding: float = 0.0,
    workers: int = 1,
) -> Tuple[str, str]:
    """Render a MULTI-DEPTH EuRoC-layout loop sequence with ground truth.

    Fronto-parallel textured planes at different depths composited
    far→near: real depth variation, occlusion boundaries, and optional
    photometric nuisance (vignetting, gain/bias jitter, sensor noise),
    ``degraded_frames`` (blurred and darkened, the relocalization hook),
    ``dynamic_occluders`` (independently-moving foreground patches) and
    ``exposure_banding`` (a per-frame row-wise exposure ramp).  Per-plane
    geometry is an exact homography, so ground truth is exact.  ``workers``:
    see :func:`render_layered`.  Returns the calib YAML paths.
    """
    lefts, rights, gt = render_layered(
        n_frames, width, height, fx, baseline, fps, seed, radius, depths,
        photometric, degraded_frames, dynamic_occluders, occluder_speed,
        exposure_banding, workers)
    return _write_euroc(root, lefts, rights, gt, width, height, fx, baseline, fps)
