"""Calibration parity: the port's numpy copy of utils/calib.py gives the
JAX package's rectification maps and Q byte for byte."""

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu.utils import calib as jcal
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal

torch.set_num_threads(1)

H, W = 60, 80
K = np.array([[70.0, 0, 40], [0, 70.0, 30], [0, 0, 1.0]])
P = np.hstack([np.array([[66.0, 0, 38], [0, 66.0, 29], [0, 0, 1.0]]), np.zeros((3, 1))])
PR = P.copy()
PR[0, 3] = -6.6


def _rot(deg):
    a = np.deg2rad(deg)
    return np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0], [-np.sin(a), 0, np.cos(a)]])


@pytest.mark.parametrize("D,R", [
    (np.array([-0.37, 0.11, 0.001, -0.002, 0.0]), np.eye(3)),
    (np.array([-0.28, 0.07, 0.0, 0.0, 0.01]), _rot(1.5)),
    (np.zeros(5), np.eye(3)),
])
def test_rect_maps_and_q_byte_equal(D, R):
    def model(mod):
        return mod.StereoCameraModel.from_calibs(
            mod.CameraCalib(W, H, K, D, R, P, "left"),
            mod.CameraCalib(W, H, K, D, R.T, PR, "right"))

    jm, tm = model(jcal), model(tcal)
    a, b = jm.rect_maps_stacked(), tm.rect_maps_stacked()
    assert a.dtype == b.dtype == np.float32
    assert a.tobytes() == b.tobytes()
    assert jm.Q.tobytes() == tm.Q.tobytes()
    assert (jm.fx, jm.baseline, jm.disparity_offset) == (tm.fx, tm.baseline, tm.disparity_offset)


def test_yaml_and_camera_info_loaders(tmp_path):
    doc = (
        "image_width: 80\nimage_height: 60\ncamera_name: left\n"
        "camera_matrix: {rows: 3, cols: 3, data: [70, 0, 40, 0, 70, 30, 0, 0, 1]}\n"
        "distortion_model: plumb_bob\n"
        "distortion_coefficients: {rows: 1, cols: 5, data: [-0.3, 0.1, 0, 0, 0]}\n"
        "rectification_matrix: {rows: 3, cols: 3, data: [1, 0, 0, 0, 1, 0, 0, 0, 1]}\n"
        "projection_matrix: {rows: 3, cols: 4, data: [66, 0, 38, 0, 0, 66, 29, 0, 0, 0, 1, 0]}\n"
    )
    path = tmp_path / "left.yaml"
    path.write_text(doc)
    a = jcal.load_camera_calib(str(path))
    b = tcal.load_camera_calib(str(path))
    for f in ("K", "D", "R", "P"):
        assert getattr(a, f).tobytes() == getattr(b, f).tobytes()
    info = {"width": 80, "height": 60, "K": a.K.ravel(), "D": a.D, "R": a.R.ravel(),
            "P": a.P.ravel()}
    jm = jcal.StereoCameraModel.from_camera_info(info, info)
    tm = tcal.StereoCameraModel.from_camera_info(info, info)
    assert jm.rect_maps_stacked().tobytes() == tm.rect_maps_stacked().tobytes()
