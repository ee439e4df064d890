"""Synthetic input for the port (numpy only).

A copy of ``synthetic_stereo_pair`` from ``ros_gpu_stereo_processor_tpu/utils/io.py``,
so the port's tests and ``chip_smoke.py`` make identical frames without
importing the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np


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
