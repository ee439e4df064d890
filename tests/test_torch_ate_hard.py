"""The port's SLAM engine against the JAX package's on the hard scene of
tests/test_ate_hard.py: the JAX ``make_layered_euroc`` CI sequence (80
frames, 376×240, fx 260, radius 0.3, depths 6/4/2.8/2.1 m, seed 2; frames
40–41 blurred and darkened, one occluder at speed 0.5, exposure banding
0.08) read back by the JAX ``EurocReader``, so that both engines get the
same bytes; ``_run_slam``'s settings (384 features, a keyframe every 3
frames, a 5-keyframe BA window; BM at 32 disparities, block 11, texture 10,
speckle 100).

Both engines ``step`` through all 80 frames.  Held exact: every frame's
``is_keyframe``, ``tracked``, ``lost``, ``relocalized`` and ``n_matches``,
the keyframe count, each keyframe's track ids and the closure pairs of
``detect_loop_closures``.  Within 1e-5 (float32 solves reduced in another
order; the planar test's tolerance): every frame's pose, each closure's
relative pose, and the ATE before and after ``optimize_global``.  Then the
JAX test's gates on the port, unchanged: lost ≥ 1, relocalized ≥ 1, a
closure, ``optimize_global`` ≥ 1, ATE after ≤ max(1.5 · before, 0.02) and
< 0.1 m, and the drift-then-fix check.  One test: the two runs are shared
by every check, and one xdist worker should not repeat them."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from ros_gpu_stereo_processor_tpu.config import (
    PipelineConfig, SpeckleConfig, StereoBMConfig)
from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig as JSlamConfig
from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam as JSlam
from ros_gpu_stereo_processor_tpu.utils import evaluate as jev
from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel as JModel
from ros_gpu_stereo_processor_tpu.utils.io import EurocReader
from ros_gpu_stereo_processor_tpu.utils.synth import make_layered_euroc
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.utils import evaluate as tev

torch.set_num_threads(1)

ATOL = 1e-5
FLAGS = ("is_keyframe", "tracked", "lost", "relocalized", "n_matches")
SEQ = dict(n_frames=80, width=376, height=240, fx=260.0, radius=0.3,
           depths=(6.0, 4.0, 2.8, 2.1), seed=2, degraded_frames=(40, 41),
           dynamic_occluders=1, occluder_speed=0.5, exposure_banding=0.08)
CFG = dict(num_features=384, keyframe_every=3, window_size=5)
PCFG = PipelineConfig(
    stereobm=StereoBMConfig(num_disparities=32, block_size=11, texture_threshold=10),
    speckle=SpeckleConfig(max_speckle_size=100))
DRIFT = np.array([0.30, -0.20, 0.12])


def add_drift(slam):
    """tests/test_ate_hard.py's smooth drift over the keyframes; every
    frame rides its keyframe's share."""
    K = len(slam.store)
    for k, kf in enumerate(slam.store.frames):
        kf.t_wc = kf.t_wc + DRIFT * (k / K)
    kf_stamps = [kf.stamp for kf in slam.store.frames]
    for fi, stamp in enumerate(slam.traj_stamps):
        ki = max(0, int(np.searchsorted(kf_stamps, stamp, side="right")) - 1)
        slam.traj_t[fi] = slam.traj_t[fi] + DRIFT * (ki / K)


def test_hard_scene_matches_jax_and_passes_its_gates(tmp_path):
    root = str(tmp_path)
    cl, cr = make_layered_euroc(root, **SEQ)
    frames = [(f.left, f.right, f.stamp, f.encoding) for f in EurocReader(root)]
    assert len(frames) == SEQ["n_frames"]

    js = JSlam(JModel.from_files(cl, cr), JSlamConfig(use_pallas=False, **CFG), PCFG)
    ts = T.StereoSlam(T.StereoCameraModel.from_files(cl, cr), T.SlamConfig(**CFG),
                      T.from_jax_config(PCFG), device="cpu")
    tinfos = []
    for i, (left, right, stamp, enc) in enumerate(frames):
        a = js.step(left, right, stamp=stamp, encoding=enc)
        b = ts.step(left, right, stamp=stamp, encoding=enc)
        tinfos.append(b)
        assert tuple(a[f] for f in FLAGS) == tuple(b[f] for f in FLAGS), (
            i, [a[f] for f in FLAGS], [b[f] for f in FLAGS])
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], rtol=0, atol=ATOL, err_msg=f"frame {i}")
        np.testing.assert_allclose(b["R_wc"], a["R_wc"], rtol=0, atol=ATOL, err_msg=f"frame {i}")
    assert len(ts.store) == len(js.store)
    for k, (a, b) in enumerate(zip(js.store.frames, ts.store.frames)):
        np.testing.assert_array_equal(b.track_ids, a.track_ids, err_msg=f"keyframe {k}")
    np.testing.assert_allclose(np.stack(ts.traj_t), np.stack(js.traj_t), rtol=0, atol=ATOL)

    gt = tev.load_euroc_groundtruth(root)
    ate_before = float(tev.ate_rmse(ts.trajectory(), gt))
    assert ate_before == pytest.approx(
        float(jev.ate_rmse(js.trajectory(), jev.load_euroc_groundtruth(root))), abs=ATOL)
    jc, tc = js.detect_loop_closures(), ts.detect_loop_closures()
    assert [(c[0], c[1]) for c in tc] == [(c[0], c[1]) for c in jc]
    for a, b in zip(jc, tc):
        np.testing.assert_allclose(b[2], a[2], rtol=0, atol=ATOL, err_msg=f"closure {a[:2]}")
        np.testing.assert_allclose(b[3], a[3], rtol=0, atol=ATOL, err_msg=f"closure {a[:2]}")
    n_used = ts.optimize_global()
    assert n_used == js.optimize_global()
    ate_after = float(tev.ate_rmse(ts.trajectory(), gt))
    assert ate_after == pytest.approx(
        float(jev.ate_rmse(js.trajectory(), jev.load_euroc_groundtruth(root))), abs=ATOL)

    # tests/test_ate_hard.py's gates on the port
    assert sum(bool(i["lost"]) for i in tinfos) >= 1, "degraded frames did not break tracking"
    assert sum(bool(i["relocalized"]) for i in tinfos) >= 1, "no relocalization happened"
    assert len(tc) >= 1, "no loop closure detected on a closed loop"
    assert n_used >= 1
    assert ate_after <= max(ate_before * 1.5, 0.02), (ate_before, ate_after)
    assert ate_after < 0.1, (ate_before, ate_after)

    add_drift(ts)
    ate_drifted = float(tev.ate_rmse(ts.trajectory(), gt))
    assert ate_drifted > max(0.06, 1.3 * ate_after), ate_drifted
    assert ts.optimize_global() >= 1
    ate_fixed = float(tev.ate_rmse(ts.trajectory(), gt))
    assert ate_fixed < ate_drifted, (ate_drifted, ate_fixed)
    assert ate_fixed < 1.15 * ate_after + 0.005, (ate_after, ate_fixed)
