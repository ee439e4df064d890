"""The port's SLAM engine against the JAX package's at the settings of
tests/test_ate.py: the JAX ``make_planar_euroc`` sequence (45 frames,
320×240, fx 300, Z0 3 m, radius 0.25, seed 1) read back by the JAX
``EurocReader``; 256 features, a keyframe every 3 frames, a 5-keyframe BA
window, 16 disparities, block 9, texture 5, speckle 800 px / Δ5 (the CLI's
defaults); ``run_stream`` with pipelining depth 2, then ``optimize_global``.

The JAX engine runs the first 12 frames (4 keyframes, BA windows of 2–4);
the port runs all 45, and its state after frame 12 (``run_stream``
completes frames in order, so the map then holds exactly frames 0–11) is
held against the JAX engine's: the same keyframe decisions, match counts
and track ids, trajectories atol 1e-5 m.  The port's ATE over all 45
frames after ``optimize_global`` must be < 0.1 m, test_ate's gate.  One
test: the two runs are shared by every check, and one xdist worker should
not repeat them."""

import numpy as np
import pytest
import torch

cv2 = pytest.importorskip("cv2")

from ros_gpu_stereo_processor_tpu.config import PipelineConfig, StereoBMConfig
from ros_gpu_stereo_processor_tpu.models.slam import SlamConfig as JSlamConfig
from ros_gpu_stereo_processor_tpu.models.slam import StereoSlam as JSlam
from ros_gpu_stereo_processor_tpu.utils.calib import StereoCameraModel as JModel
from ros_gpu_stereo_processor_tpu.utils.io import EurocReader
from ros_gpu_stereo_processor_tpu.utils.synth import make_planar_euroc
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.utils import evaluate as tev

torch.set_num_threads(1)

JAX_FRAMES = 12
CFG = dict(num_features=256, keyframe_every=3, window_size=5)
PCFG = PipelineConfig(stereobm=StereoBMConfig(num_disparities=16, block_size=9,
                                              texture_threshold=5))


def test_planar_sequence_matches_jax_and_ate_under_10cm(tmp_path):
    root = str(tmp_path)
    cl, cr = make_planar_euroc(root, n_frames=45, width=320, height=240, fx=300.0,
                               Z0=3.0, radius=0.25, seed=1)
    frames = [(f.left, f.right, f.stamp) for f in EurocReader(root)]

    js = JSlam(JModel.from_files(cl, cr), JSlamConfig(use_pallas=False, **CFG), PCFG)
    jinfos = list(js.run_stream(iter(frames[:JAX_FRAMES])))

    ts = T.StereoSlam(T.StereoCameraModel.from_files(cl, cr), T.SlamConfig(**CFG),
                      T.from_jax_config(PCFG), device="cpu")
    tinfos, snap = [], None
    for info in ts.run_stream(iter(frames)):
        tinfos.append(info)
        if len(tinfos) == JAX_FRAMES:
            snap = ([k.track_ids.copy() for k in ts.store.frames], ts.tracks.alive.copy(),
                    np.stack(ts.traj_t))

    for i, (a, b) in enumerate(zip(jinfos, tinfos)):
        for f in ("is_keyframe", "tracked", "lost", "relocalized", "n_matches"):
            assert a[f] == b[f], (i, f)
        np.testing.assert_allclose(b["t_wc"], a["t_wc"], rtol=0, atol=1e-5)
    track_ids, alive, traj = snap
    assert len(track_ids) == len(js.store) == 4
    for k, (a, b) in enumerate(zip(js.store.frames, track_ids)):
        np.testing.assert_array_equal(b, a.track_ids, err_msg=f"keyframe {k}")
    np.testing.assert_array_equal(alive, js.tracks.alive)
    np.testing.assert_allclose(traj, np.stack(js.traj_t), rtol=0, atol=1e-5)

    assert len(tinfos) == 45 and all(i["tracked"] for i in tinfos[1:])
    assert ts.optimize_global() >= 1
    ate = tev.ate_rmse(ts.trajectory(), tev.load_euroc_groundtruth(root))
    assert ate < 0.1, ate
