"""Dataset IO, timestamp pairing and synthetic input for the port (numpy only).

Copies of ``ros_gpu_stereo_processor_tpu/utils/io.py`` (the port cannot
import the JAX package, whose ``__init__`` imports jax): the reference's ROS
input plumbing — message_filters Exact/ApproximateTime synchronizers over
stereo topics (include/gpuimageproc/StereoProcessor.h:45-62) — becomes
datasets (PNG directories / EuRoC layout) paired by timestamp, exact or
nearest-within-slop; and ``synthetic_stereo_pair``, so the port's tests and
``chip_smoke.py`` make identical frames.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, List, Sequence, Tuple

import numpy as np


def load_image(path: str) -> np.ndarray:
    """Load an image file to a numpy array (uint8/uint16).

    Color images are returned RGB.  Reads with ``imageio`` or, failing
    that, ``cv2``; raises ``ImportError`` when neither is installed."""
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if iio is not None:
        return np.asarray(iio.imread(path))
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"cannot read {path}: load_image needs imageio or cv2, and neither "
            "is installed") from None
    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(path)
    if img.ndim == 3:
        img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3 else cv2.COLOR_BGRA2RGBA)
    return img


def write_image(path: str, img: np.ndarray) -> None:
    """Write a mono image with ``imageio`` or, failing that, ``cv2``."""
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if iio is not None:
        iio.imwrite(path, img)
        return
    try:
        import cv2
    except ImportError:
        raise ImportError(
            f"cannot write {path}: write_image needs imageio or cv2, and neither "
            "is installed") from None
    cv2.imwrite(path, img)


@dataclasses.dataclass(frozen=True)
class StereoFrame:
    """One synchronized stereo pair — the unit of work of the pipeline
    (the reference's (l_image_msg, r_image_msg) callback pair,
    src/StereoProcessor.cpp:157)."""

    stamp: float                 # seconds
    left: np.ndarray             # (H, W) or (H, W, C)
    right: np.ndarray
    encoding: str = "mono8"
    seq: int = 0


# ---------------------------------------------------------------------------
# Timestamp pairing (the message_filters sync policies)
# ---------------------------------------------------------------------------


def pair_timestamps_exact(
    left: Sequence[float], right: Sequence[float]
) -> List[Tuple[int, int]]:
    """ExactTime policy: match identical stamps only."""
    rmap = {t: i for i, t in enumerate(right)}
    return [(i, rmap[t]) for i, t in enumerate(left) if t in rmap]


def pair_timestamps_approx(
    left: Sequence[float], right: Sequence[float], slop: float = 0.01
) -> List[Tuple[int, int]]:
    """ApproximateTime-like policy: greedy nearest-neighbour within ``slop``
    seconds, monotonic (each frame used at most once)."""
    pairs: List[Tuple[int, int]] = []
    j = 0
    for i, tl in enumerate(left):
        # advance j while the next right stamp is closer
        while j + 1 < len(right) and abs(right[j + 1] - tl) <= abs(right[j] - tl):
            j += 1
        if j < len(right) and abs(right[j] - tl) <= slop:
            pairs.append((i, j))
            j += 1
            if j >= len(right):
                break
    return pairs


# ---------------------------------------------------------------------------
# EuRoC dataset reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EurocReader:
    """Reader for the EuRoC MAV dataset layout::

        <root>/mav0/cam0/data.csv   # "#timestamp [ns],filename"
        <root>/mav0/cam0/data/<stamp>.png
        <root>/mav0/cam1/...

    Yields :class:`StereoFrame` pairs matched by timestamp.
    """

    root: str
    approximate_sync: bool = False
    slop: float = 0.005

    def _cam_index(self, cam: str) -> Tuple[List[float], List[str]]:
        base = os.path.join(self.root, "mav0", cam)
        csv = os.path.join(base, "data.csv")
        stamps: List[float] = []
        files: List[str] = []
        with open(csv, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_str, fname = line.split(",")[:2]
                stamps.append(int(ts_str) * 1e-9)
                files.append(os.path.join(base, "data", fname.strip()))
        return stamps, files

    def _pairs(self, lt, rt):
        if self.approximate_sync:
            return pair_timestamps_approx(lt, rt, self.slop)
        return pair_timestamps_exact(lt, rt)

    def __iter__(self) -> Iterator[StereoFrame]:
        lt, lf = self._cam_index("cam0")
        rt, rf = self._cam_index("cam1")
        for seq, (i, j) in enumerate(self._pairs(lt, rt)):
            yield StereoFrame(
                stamp=lt[i],
                left=load_image(lf[i]),
                right=load_image(rf[j]),
                encoding="mono8",
                seq=seq,
            )

    def __len__(self) -> int:
        lt, _ = self._cam_index("cam0")
        rt, _ = self._cam_index("cam1")
        return len(self._pairs(lt, rt))


@dataclasses.dataclass
class ImagePairSource:
    """Trivial in-memory frame source (for tests and the golden images)."""

    frames: List[StereoFrame]

    def __iter__(self) -> Iterator[StereoFrame]:
        return iter(self.frames)

    def __len__(self) -> int:
        return len(self.frames)


def synthetic_stereo_pair(
    height: int = 480,
    width: int = 752,
    max_disparity: int = 48,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate a textured random-dot stereo pair with a known disparity ramp.

    Returns (left, right, true_disparity).  Used by kernel tests to verify the
    matcher end-to-end with a known answer (no golden file needed).
    """
    rng = np.random.default_rng(seed)
    # Smooth disparity field: horizontal ramp + a raised rectangle
    yy, xx = np.mgrid[0:height, 0:width]
    disp = (max_disparity * 0.25 + max_disparity * 0.5 * xx / width).astype(np.float32)
    disp[height // 4 : height // 2, width // 4 : width // 2] += max_disparity * 0.2
    disp = np.round(disp)  # integer disparity → exact warping

    # Random texture, heavy on high frequencies so SAD locks on.
    # Convention: the matcher reports d(x_left) s.t. right(x_left − d) ==
    # left(x_left); generating left by sampling a common texture at
    # (x + M − D(x)) with right = tex[:, M:] makes D the exact ground truth.
    M = max_disparity + 8
    tex = rng.integers(0, 255, size=(height, width + M), dtype=np.uint8)
    right = tex[:, M:].copy()
    left = tex[yy, xx + M - disp.astype(np.int64)]
    return left, right, disp
