"""The port's visual odometry (``models/vo.py``) against the JAX package's on
the CPU, on the same seeded inputs: ``triangulate_keypoints``,
``pnp_gauss_newton`` (seeded problems with gross outliers and masked
points), ``_vo_core`` on a pair of frames and ``StereoVisualOdometry.step``
over the translating-plane sequence of tests/test_vo.py.

Tolerances: triangulated points and validity exact; PnP poses
atol 2e-5 (rotation entries and metres) and rms atol 1e-4 px — float32
Gauss-Newton whose reductions run in another order; VO keypoints, points
and match counts exact, poses atol 2e-5."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.models import vo as JVO
from ros_gpu_stereo_processor_tpu.utils import lie as jlie
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel as JModel
from ros_gpu_stereo_processor_tpu_torch.models import vo as TVO
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal

torch.set_num_threads(1)

FX, CX, CY = 400.0, 320.0, 240.0
POSE_ATOL = 2e-5


def _models(width=320, height=240, fx=300.0, baseline=0.1):
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -fx * baseline
    jm = JModel.from_calibs(JCalib(width, height, K, np.zeros(5), np.eye(3), P, "left"),
                            JCalib(width, height, K, np.zeros(5), np.eye(3), Pr, "right"))
    tm = tcal.StereoCameraModel.from_calibs(
        tcal.CameraCalib(width, height, K, np.zeros(5), np.eye(3), P, "left"),
        tcal.CameraCalib(width, height, K, np.zeros(5), np.eye(3), Pr, "right"))
    return jm, tm


def test_triangulate_keypoints_matches_jax():
    rng = np.random.default_rng(0)
    H, W = 60, 80
    disp = rng.uniform(2.0, 30.0, (H, W)).astype(np.float32)
    disp[rng.random((H, W)) < 0.2] = -1.0                  # invalid pixels
    disp[20:30, 20:40] = 12.0                              # a flat patch
    xy = np.stack([rng.integers(-3, W + 3, 64), rng.integers(-3, H + 3, 64)], -1)
    xy = xy.astype(np.float32)
    xy[:8] = [[25, 22], [30, 25], [35, 28], [21, 21], [38, 28], [0, 0], [79, 59], [40, 30]]
    kw = dict(fx=300.0, cx=40.5, cy=29.5, baseline=0.11, disparity_offset=0.25)
    # compiled as the JAX engine compiles it (camera constants static)
    jtri = jax.jit(JVO.triangulate_keypoints, static_argnames=tuple(kw))
    pj, vj = jtri(jnp.asarray(xy), jnp.asarray(disp), **kw)
    pt, vt = TVO.triangulate_keypoints(torch.from_numpy(xy), torch.from_numpy(disp), **kw)
    np.testing.assert_array_equal(vt.numpy(), np.asarray(vj))
    np.testing.assert_array_equal(pt.numpy(), np.asarray(pj))
    assert 3 <= vt.sum() < 64


def _project(pts, R, t):
    pc = pts @ R.T + t
    return np.stack([FX * pc[:, 0] / pc[:, 2] + CX, FX * pc[:, 1] / pc[:, 2] + CY], -1)


def _pnp_case(kind, seed):
    rng = np.random.default_rng(seed)
    n = 120
    pts = rng.uniform([-2, -2, 4], [2, 2, 10], (n, 3))
    xi = rng.normal(0, [0.08, 0.08, 0.15, 0.03, 0.03, 0.03])
    R, t = (np.asarray(a, np.float64) for a in jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
    obs = _project(pts, R, t) + rng.normal(0, 0.3, (n, 2))
    w = np.ones(n)
    if kind in ("outliers", "both"):
        obs[:20] += rng.uniform(30, 80, (20, 2))
    if kind in ("masked", "both"):
        obs[100:] = 1e6
        w[100:] = 0.0
    return pts.astype(np.float32), obs.astype(np.float32), w.astype(np.float32), R, t


@pytest.mark.parametrize("kind", ["clean", "outliers", "masked", "both"])
@pytest.mark.parametrize("iters", [6, 15])
def test_pnp_gauss_newton_matches_jax(kind, iters):
    pts, obs, w, R_true, t_true = _pnp_case(kind, 3 + iters)
    Rj, tj, rj = JVO.pnp_gauss_newton(
        jnp.asarray(pts), jnp.asarray(obs), jnp.asarray(w), fx=FX, cx=CX, cy=CY,
        R0=jnp.eye(3), t0=jnp.zeros(3), iters=iters)
    Rt, tt, rt = TVO.pnp_gauss_newton(
        torch.from_numpy(pts), torch.from_numpy(obs), torch.from_numpy(w), fx=FX, cx=CX, cy=CY,
        R0=torch.eye(3), t0=torch.zeros(3), iters=iters)
    np.testing.assert_allclose(Rt.numpy(), np.asarray(Rj), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(tt.numpy(), np.asarray(tj), rtol=0, atol=POSE_ATOL)
    np.testing.assert_allclose(float(rt), float(rj), rtol=0, atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), t_true, atol=0.05)


def test_pnp_batched_equals_per_problem():
    cases = [_pnp_case(k, 20 + i) for i, k in enumerate(["clean", "outliers", "both"])]
    stack = [torch.from_numpy(np.stack([c[i] for c in cases])) for i in range(3)]
    Rb, tb, rb = TVO.pnp_gauss_newton(*stack, fx=FX, cx=CX, cy=CY,
                                      R0=torch.eye(3).expand(3, 3, 3), t0=torch.zeros(3, 3))
    for i, c in enumerate(cases):
        R, t, r = TVO.pnp_gauss_newton(*(torch.from_numpy(a) for a in c[:3]), fx=FX, cx=CX,
                                       cy=CY, R0=torch.eye(3), t0=torch.zeros(3))
        torch.testing.assert_close(Rb[i], R, rtol=0, atol=1e-6)
        torch.testing.assert_close(tb[i], t, rtol=0, atol=1e-6)
        torch.testing.assert_close(rb[i], r, rtol=0, atol=1e-5)


def test_pnp_singular_system_gives_nonfinite_without_raising():
    z = torch.zeros(10, 3)
    R, t, _ = TVO.pnp_gauss_newton(z, torch.zeros(10, 2), torch.zeros(10), fx=FX, cx=CX,
                                   cy=CY, R0=torch.eye(3), t0=torch.zeros(3), iters=2)
    assert R.shape == (3, 3) and t.shape == (3,)


def _plane_sequence(n_frames=4, shift=6, seed=6, W=320, H=240):
    rng = np.random.default_rng(seed)
    tex = rng.integers(0, 255, (H, W + shift * n_frames + 8), np.uint8)
    return [tex[:, i * shift: i * shift + W] for i in range(n_frames)]


def test_vo_core_matches_jax():
    jm, tm = _models()
    frames = _plane_sequence(2)
    disp = np.full((240, 320), 15.0, np.float32)
    disp[100:140, 100:140] = 16.0
    cam = dict(k=256, threshold=20.0, fx=jm.fx, cx=jm.left.calib.cx, cy=jm.left.calib.cy,
               baseline=jm.baseline, disparity_offset=jm.disparity_offset)
    jprev = JVO._vo_first(jnp.asarray(frames[0]), jnp.asarray(disp), **cam)
    tprev = TVO._vo_first(torch.from_numpy(frames[0]), torch.from_numpy(disp), **cam)
    jo = JVO._vo_core(*jprev, jnp.asarray(frames[1]), jnp.asarray(disp), **cam)
    to = TVO._vo_core(*tprev, torch.from_numpy(frames[1]), torch.from_numpy(disp), **cam)
    for f in ("xy", "score", "valid", "desc"):
        np.testing.assert_array_equal(getattr(to[0], f).numpy().view(np.asarray(getattr(jo[0], f)).dtype),
                                      np.asarray(getattr(jo[0], f)), err_msg=f)
    np.testing.assert_array_equal(to[1].numpy(), np.asarray(jo[1]))   # points
    np.testing.assert_array_equal(to[2].numpy(), np.asarray(jo[2]))   # validity
    assert int(to[3]) == int(jo[3]) > 100                              # n
    np.testing.assert_allclose(to[4].numpy(), np.asarray(jo[4]), atol=POSE_ATOL)
    np.testing.assert_allclose(to[5].numpy(), np.asarray(jo[5]), atol=POSE_ATOL)


def test_visual_odometry_step_matches_jax():
    """tests/test_vo.py::test_vo_translating_plane through both engines."""
    jm, tm = _models()
    Z = 2.0
    disp = np.full((240, 320), jm.fx * jm.baseline / Z, np.float32)
    jodo = JVO.StereoVisualOdometry(jm, num_features=256, min_matches=8)
    todo = TVO.StereoVisualOdometry(tm, num_features=256, min_matches=8, device="cpu")
    for i, left in enumerate(_plane_sequence(4)):
        a = jodo.step(jnp.asarray(left), jnp.asarray(disp))
        b = todo.step(left, disp)
        assert (a["tracked"], a["lost"], a["n_matches"]) == (b["tracked"], b["lost"], b["n_matches"])
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], atol=POSE_ATOL)
        np.testing.assert_allclose(b["R_wc"], a["R_wc"], atol=POSE_ATOL)
        if i > 0:
            assert b["tracked"]
    np.testing.assert_allclose(todo.state.t_wc[0], 3 * 6 * Z / tm.fx, atol=0.01)
    assert todo.state.n_frames == 4 and todo.state.n_tracked == 3


def test_host_bundle_round_trip():
    from ros_gpu_stereo_processor_tpu_torch.ops import features as tf

    rng = np.random.default_rng(1)
    K = 16
    kp = tf.Keypoints(xy=torch.from_numpy(rng.uniform(0, 300, (K, 2)).astype(np.float32)),
                      score=torch.ones(K), angle=torch.zeros(K),
                      desc=torch.from_numpy(rng.integers(-2**31, 2**31, (K, 8)).astype(np.int32)),
                      valid=torch.from_numpy(rng.random(K) < 0.7))
    pts = torch.from_numpy(rng.normal(size=(K, 3)).astype(np.float32))
    pv = kp.valid & torch.from_numpy(rng.random(K) < 0.8)
    R, t = torch.eye(3) * 0.5, torch.tensor([1.0, -2.0, 3.5])
    b = TVO._pack_host_bundle(kp, pts, pv, torch.tensor(7), R, t, torch.tensor(0.25))
    host, (n, Rh, th, rms) = TVO._unpack_host_bundle(b.numpy(), True)
    np.testing.assert_array_equal(host["desc"], kp.desc.numpy().view(np.uint32))
    np.testing.assert_array_equal(host["xy"], kp.xy.numpy())
    np.testing.assert_array_equal(host["pts_cam"], pts.numpy())
    np.testing.assert_array_equal(host["valid"], kp.valid.numpy())
    np.testing.assert_array_equal(host["pts_valid"], pv.numpy())
    assert (n, rms) == (7, 0.25)
    np.testing.assert_array_equal(Rh, R.numpy())
    np.testing.assert_array_equal(th, t.numpy())


def test_visual_odometry_defaults_to_the_card():
    _, tm = _models()
    if torch.cuda.is_available():
        assert TVO.StereoVisualOdometry(tm).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            TVO.StereoVisualOdometry(tm)
