"""The port's VO and SLAM engine against the JAX package's on the 6-dof
homography sequence of tests/test_vo_6dof.py: its toy model (400×300, fx
350, baseline 0.1), a textured plane at Z0 = 2.5 m and its poses
(translation plus yaw and pitch), rendered once by the port's
``utils/synth.py::render_6dof`` and fed as the same arrays to both engines.
Each test runs on frames warped by cv2 (as the JAX test renders them) and
on frames warped by the port's numpy ``_warp_perspective`` (what a machine
without cv2, such as the card's, renders).

VO (6 frames, 512 features, ``min_matches=10``, the plane's constant
disparity): every frame's ``tracked`` and ``n_matches`` equal to JAX's and
``t_wc`` within 1e-5 m; then the JAX test's bars on the port: ATE < 0.02 m,
final rotation error < 0.02 rad.  SLAM (8 frames, test_slam_6dof_sequence's
configs): the flags equal to JAX's on every frame and poses within 1e-5 m;
then on the port: every frame after the first tracked, ATE after
``optimize_global(iters=5)`` < 0.03 m, at least 3 keyframes."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.config import (
    PipelineConfig, SpeckleConfig, StereoBMConfig)
from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig as JSlamConfig
from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam as JSlam
from ros_gpu_stereo_processor_tpu.models.vo import StereoVisualOdometry as JVO
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel as JModel
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import evaluate as tev
from ros_gpu_stereo_processor_tpu_torch.utils import synth as tsynth

torch.set_num_threads(1)

ATOL = 1e-5
W, H, FX, BASELINE, Z0 = 400, 300, 350.0, 0.1, 2.5
FLAGS = ("is_keyframe", "tracked", "lost", "relocalized", "n_matches")
SLAM_CFG = dict(num_features=384, keyframe_every=2, window_size=3, ba_landmarks=96)
PCFG = PipelineConfig(
    stereobm=StereoBMConfig(num_disparities=16, block_size=9, texture_threshold=5),
    speckle=SpeckleConfig(max_speckle_size=0))
WARPS = {
    "cv2": dict(blur=lambda t: cv2.GaussianBlur(t, (3, 3), 0.6),
                warp=lambda img, Hm, size: cv2.warpPerspective(img, Hm, size,
                                                              flags=cv2.INTER_LINEAR)),
    "numpy": {},
}


def _calib_args():
    K = np.array([[FX, 0, W / 2], [0, FX, H / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -FX * BASELINE
    return [(W, H, K, np.zeros(5), np.eye(3), PP, nm) for PP, nm in ((P, "left"), (Pr, "right"))]


def models():
    return (JModel.from_calibs(*(JCalib(*a) for a in _calib_args())),
            tcal.StereoCameraModel.from_calibs(*(tcal.CameraCalib(*a) for a in _calib_args())))


@pytest.fixture(scope="module", params=sorted(WARPS))
def sequence(request):
    """8 frames (the VO test takes the first 6: the texture is the only
    random draw, so they are the 6-frame render's) and their poses."""
    return tsynth.render_6dof(8, W, H, FX, BASELINE, Z0, seed=0, **WARPS[request.param])


def test_vo_6dof_matches_jax(sequence):
    lefts, _, poses = sequence
    jm, tm = models()
    disp = np.full((H, W), FX * BASELINE / Z0, np.float32)
    jodo = JVO(jm, num_features=512, min_matches=10)
    todo = T.StereoVisualOdometry(tm, num_features=512, min_matches=10, device="cpu")
    est = []
    for i, left in enumerate(lefts[:6]):
        a = jodo.step(jnp.asarray(left), jnp.asarray(disp))
        b = todo.step(left, disp)
        assert (b["tracked"], b["n_matches"]) == (a["tracked"], a["n_matches"]), i
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], rtol=0, atol=ATOL, err_msg=f"frame {i}")
        assert b["tracked"] or i == 0, f"frame {i} lost"
        est.append(b["t_wc"].copy())
    gt = np.asarray([t for _, t in poses[:6]])
    stamps = np.arange(len(gt)) * 0.1
    ate = tev.ate_rmse(tev.Trajectory(stamps, np.asarray(est)), tev.Trajectory(stamps, gt))
    assert ate < 0.02, f"6-dof ATE {ate:.4f} m"
    R_err = todo.state.R_wc.T @ poses[5][0]
    ang = np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1))
    assert ang < 0.02, f"final rotation error {ang:.4f} rad"


def test_slam_6dof_matches_jax(sequence):
    lefts, rights, poses = sequence
    jm, tm = models()
    js = JSlam(jm, JSlamConfig(use_pallas=False, **SLAM_CFG), PCFG)
    ts = T.StereoSlam(tm, T.SlamConfig(**SLAM_CFG), T.from_jax_config(PCFG), device="cpu")
    for i, (left, right) in enumerate(zip(lefts, rights)):
        a = js.step(left, right, stamp=0.1 * i)
        b = ts.step(left, right, stamp=0.1 * i)
        assert tuple(b[f] for f in FLAGS) == tuple(a[f] for f in FLAGS), i
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], rtol=0, atol=ATOL, err_msg=f"frame {i}")
        assert b["tracked"] or i == 0, f"frame {i} lost"
    ts.optimize_global(iters=5)
    traj = ts.trajectory()
    gt = np.asarray([t for _, t in poses])
    ate = tev.ate_rmse(tev.Trajectory(traj.stamps, traj.t),
                       tev.Trajectory(np.arange(len(gt)) * 0.1, gt))
    assert ate < 0.03, f"SLAM 6-dof ATE {ate:.4f} m"
    assert len(ts.store) >= 3
