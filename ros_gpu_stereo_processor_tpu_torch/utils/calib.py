"""Camera calibration & stereo geometry in pure numpy (the PyTorch port's copy
of ``ros_gpu_stereo_processor_tpu/utils/calib.py``; ``yaml`` is imported only
when a YAML file is read, and where it is not installed the camera-info
layout is parsed by :func:`parse_camera_info_yaml`, so the port needs only
numpy).

Replaces the reference's use of ``image_geometry::PinholeCameraModel`` /
``StereoCameraModel`` plus a *forked* GPU image_geometry (reference:
src/GPUStereoProcessor.cpp:41-63 — model init from CameraInfo or from YAML via
camera_calibration_parsers at :55-61; GPU rectify fork call :244,248; Q-matrix
reprojection fork call :332-346).  Here everything is computed once on the
host in float64 and baked into device constants:

  * plumb_bob undistort ∘ rectify maps (the precomputed remap tables a forked
    ``rectifyImageGPU`` would hold),
  * the 4×4 Q reprojection matrix for disparity → 3-D.

The reference bug of never assigning the right camera name
(src/GPUStereoProcessor.cpp:44-45) is naturally absent.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class CameraCalib:
    """One camera's calibration — the fields of a ROS ``sensor_msgs/CameraInfo``
    or a camera_calibration_parsers YAML file
    (e.g. reference test/stereobm/test_data/left.yaml)."""

    width: int
    height: int
    K: np.ndarray                  # (3,3) intrinsics of the *raw* image
    D: np.ndarray                  # (N,) plumb_bob distortion [k1,k2,p1,p2,k3]
    R: np.ndarray                  # (3,3) rectification rotation
    P: np.ndarray                  # (3,4) projection of the *rectified* image
    name: str = ""
    distortion_model: str = "plumb_bob"

    def __post_init__(self) -> None:
        object.__setattr__(self, "K", np.asarray(self.K, np.float64).reshape(3, 3))
        object.__setattr__(self, "D", np.asarray(self.D, np.float64).reshape(-1))
        object.__setattr__(self, "R", np.asarray(self.R, np.float64).reshape(3, 3))
        object.__setattr__(self, "P", np.asarray(self.P, np.float64).reshape(3, 4))
        if self.distortion_model not in ("plumb_bob", "rational_polynomial", ""):
            raise ValueError(f"unsupported distortion model {self.distortion_model!r}")

    # Rectified-image intrinsics
    @property
    def fx(self) -> float:
        return float(self.P[0, 0])

    @property
    def fy(self) -> float:
        return float(self.P[1, 1])

    @property
    def cx(self) -> float:
        return float(self.P[0, 2])

    @property
    def cy(self) -> float:
        return float(self.P[1, 2])

    @property
    def Tx(self) -> float:
        """Baseline times focal: P[0,3] = -fx * B for the right camera of a
        rectified pair (0 for the left)."""
        return float(self.P[0, 3])

    @property
    def size(self) -> Tuple[int, int]:
        return (self.width, self.height)


def camera_info_to_calib(info: dict) -> CameraCalib:
    """Build a calibration from a ROS ``sensor_msgs/CameraInfo``-shaped dict
    (keys: width, height, K (9), D, R (9), P (12)) — the reference's live
    one-shot model init from synced CameraInfo messages
    (imageAndInfoCb, src/StereoProcessor.cpp:144-155)."""
    return CameraCalib(
        width=int(info["width"]),
        height=int(info["height"]),
        K=np.asarray(info["K"], np.float64),
        D=np.asarray(info.get("D", np.zeros(5)), np.float64),
        R=np.asarray(info.get("R", np.eye(3)), np.float64),
        P=np.asarray(info["P"], np.float64),
        name=str(info.get("name", "")),
        distortion_model=str(info.get("distortion_model", "plumb_bob")),
    )


def _yaml_scalar(text: str):
    """A scalar of the camera-info layout: a number, a quoted or bare
    string, or a flow list of numbers (``[1, 0., 2.5e-3]``)."""
    text = text.strip()
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"unterminated list {text!r}")
        return [float(v) for v in text[1:-1].replace("\n", " ").split(",") if v.strip()]
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "'\"":
        return text[1:-1]
    for cast in (int, float):
        try:
            return cast(text)
        except ValueError:
            pass
    return text


def parse_camera_info_yaml(text: str) -> dict:
    """Parse the ``camera_calibration_parsers`` YAML layout without ``yaml``:
    flat ``key: value`` scalars at the top level, and one level of nested
    blocks (``camera_matrix:`` with indented ``rows``/``cols``/``data: [...]``,
    a flow list that may span lines).  Comments and blank lines are skipped.
    Anything else (block sequences, deeper nesting, anchors) raises
    ``ValueError``."""
    doc: dict = {}
    block = None            # the nested mapping being filled
    pending = None          # (mapping, key, text so far) of an open flow list
    for lineno, line in enumerate(text.splitlines(), 1):
        if pending is not None:
            m, key, acc = pending
            acc += " " + line.split("#", 1)[0].strip()
            if acc.rstrip().endswith("]"):
                m[key] = _yaml_scalar(acc)
                pending = None
            else:
                pending = (m, key, acc)
            continue
        body = line.split("#", 1)[0].rstrip()
        if not body.strip() or body.strip() in ("---", "..."):
            continue
        indent = len(body) - len(body.lstrip(" "))
        key, sep, value = body.strip().partition(":")
        if not sep or not key or key.startswith(("-", "&", "*", "!")):
            raise ValueError(f"line {lineno}: not a 'key: value' line: {line!r}")
        if indent == 0:
            block = None
            target = doc
        elif block is not None:
            target = block
        else:
            raise ValueError(f"line {lineno}: indented line outside a block: {line!r}")
        value = value.strip()
        if not value:
            if indent:
                raise ValueError(f"line {lineno}: nesting deeper than one level")
            block = doc[key] = {}
        elif value.startswith("[") and not value.endswith("]"):
            pending = (target, key, value)
        elif value[0] in "{&*!|>":
            raise ValueError(f"line {lineno}: unsupported YAML value {value!r}")
        else:
            target[key] = _yaml_scalar(value)
    if pending is not None:
        raise ValueError(f"unterminated list for {pending[1]!r}")
    return doc


def load_camera_calib(path: str) -> CameraCalib:
    """Parse a camera_calibration_parsers-style YAML file (the format of the
    reference's test calibrations, test/stereobm/test_data/{left,right}.yaml)
    with ``yaml`` where it is installed, else with
    :func:`parse_camera_info_yaml`."""
    with open(path, "r") as f:
        text = f.read()
    try:
        import yaml
    except ImportError:
        doc = parse_camera_info_yaml(text)
    else:
        doc = yaml.safe_load(text)
    return CameraCalib(
        width=int(doc["image_width"]),
        height=int(doc["image_height"]),
        K=np.array(doc["camera_matrix"]["data"], np.float64),
        D=np.array(doc["distortion_coefficients"]["data"], np.float64),
        R=np.array(doc["rectification_matrix"]["data"], np.float64),
        P=np.array(doc["projection_matrix"]["data"], np.float64),
        name=str(doc.get("camera_name", "")),
        distortion_model=str(doc.get("distortion_model", "plumb_bob")),
    )


def _distort_plumb_bob(x: np.ndarray, y: np.ndarray, D: np.ndarray):
    """Apply plumb_bob (Brown–Conrady) distortion to normalized coords."""
    d = np.zeros(8, np.float64)
    d[: D.size] = D
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return xd, yd


def undistort_rectify_map(
    K: np.ndarray,
    D: np.ndarray,
    R: np.ndarray,
    P: np.ndarray,
    size: Tuple[int, int],
) -> np.ndarray:
    """Per-destination-pixel source coordinates for undistort+rectify.

    For each rectified pixel (u, v): back-project through P, rotate by R⁻¹
    into the raw camera frame, re-apply lens distortion, and project through
    K — yielding the raw-image sample position.  Equivalent in semantics to
    OpenCV's initUndistortRectifyMap, computed here from first principles.

    Returns (H, W, 2) float32 array of (x_src, y_src).
    """
    W, H = size
    K = np.asarray(K, np.float64).reshape(3, 3)
    R = np.asarray(R, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, -1)[:, :3]

    u, v = np.meshgrid(np.arange(W, dtype=np.float64), np.arange(H, dtype=np.float64))
    # Invert the rectified projection: normalized rectified ray
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    ones = np.ones_like(x)
    rays = np.stack([x, y, ones], axis=0).reshape(3, -1)
    # Rotate back into the distorted camera frame
    rays = np.linalg.inv(R) @ rays
    xn = rays[0] / rays[2]
    yn = rays[1] / rays[2]
    xd, yd = _distort_plumb_bob(xn, yn, np.asarray(D, np.float64))
    map_x = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    out = np.stack([map_x.reshape(H, W), map_y.reshape(H, W)], axis=-1)
    return out.astype(np.float32)


@dataclasses.dataclass(frozen=True)
class PinholeCameraModel:
    """Monocular model: calibration plus its precomputed rectification map."""

    calib: CameraCalib
    rect_map: np.ndarray  # (H, W, 2) float32 source coords

    @classmethod
    def from_calib(cls, calib: CameraCalib) -> "PinholeCameraModel":
        rect_map = undistort_rectify_map(
            calib.K, calib.D, calib.R, calib.P, calib.size
        )
        return cls(calib=calib, rect_map=rect_map)

    @property
    def fov_x(self) -> float:
        """Horizontal FOV in radians of the rectified image (the quantity the
        reference logs at model init, src/GPUStereoProcessor.cpp:47-51)."""
        return 2.0 * np.arctan(self.calib.width / (2.0 * self.calib.fx))

    @property
    def fov_y(self) -> float:
        return 2.0 * np.arctan(self.calib.height / (2.0 * self.calib.fy))


@dataclasses.dataclass(frozen=True)
class StereoCameraModel:
    """Rectified stereo pair: two pinhole models + reprojection geometry.

    Replaces ``image_geometry::StereoCameraModel`` (reference:
    src/GPUStereoProcessor.cpp:41-63).
    """

    left: PinholeCameraModel
    right: PinholeCameraModel

    @classmethod
    def from_calibs(cls, left: CameraCalib, right: CameraCalib) -> "StereoCameraModel":
        return cls(
            left=PinholeCameraModel.from_calib(left),
            right=PinholeCameraModel.from_calib(right),
        )

    @classmethod
    def from_files(cls, left_yaml: str, right_yaml: str) -> "StereoCameraModel":
        return cls.from_calibs(load_camera_calib(left_yaml), load_camera_calib(right_yaml))

    @classmethod
    def from_camera_info(cls, left_info: dict, right_info: dict) -> "StereoCameraModel":
        """Live-stream model init from CameraInfo-shaped dicts (the
        reference's imageAndInfoCb path)."""
        return cls.from_calibs(
            camera_info_to_calib(left_info), camera_info_to_calib(right_info)
        )

    @property
    def baseline(self) -> float:
        """Stereo baseline in meters: B = -P_r[0,3] / fx."""
        return -self.right.calib.Tx / self.right.calib.fx

    @property
    def fx(self) -> float:
        return self.left.calib.fx

    @property
    def disparity_offset(self) -> float:
        """cx_left - cx_right of the rectified pair; true disparity
        d' = d_measured - offset (the reference's intended 32F conversion,
        src/GPUStereoProcessor.cpp:290-295,315-320)."""
        return self.left.calib.cx - self.right.calib.cx

    @property
    def Q(self) -> np.ndarray:
        """4×4 reprojection matrix: [X Y Z W]ᵀ = Q · [u v d 1]ᵀ.

        Convention matches cv::stereoRectify / image_geometry:
          Z = fx·B / (d − (cx_l − cx_r)),   X = (u − cx_l)·Z/fx,  …
        """
        cx = self.left.calib.cx
        cy = self.left.calib.cy
        fx = self.fx
        B = self.baseline
        Q = np.zeros((4, 4), np.float64)
        Q[0, 0] = 1.0
        Q[0, 3] = -cx
        Q[1, 1] = 1.0
        Q[1, 3] = -cy
        Q[2, 3] = fx
        Q[3, 2] = 1.0 / B
        Q[3, 3] = -self.disparity_offset / B
        return Q

    def rect_maps_stacked(self) -> np.ndarray:
        """(2, H, W, 2) float32 — L/R maps batched on the leading axis, the
        layout the batched pipeline consumes (SURVEY.md §7 architecture)."""
        return np.stack([self.left.rect_map, self.right.rect_map], axis=0)

    def depth_from_disparity(self, disparity: np.ndarray) -> np.ndarray:
        """Z for each (true, offset-corrected) disparity; inf/NaN where d<=0."""
        d = np.asarray(disparity, np.float64) - self.disparity_offset
        with np.errstate(divide="ignore", invalid="ignore"):
            return self.fx * self.baseline / d
