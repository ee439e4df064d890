"""Diagnostic artifact helpers — the reference test suite's debugging kit.

A copy of ``ros_gpu_stereo_processor_tpu/utils/debug.py`` for the PyTorch
port (numpy only; images are written by utils/io.py's ``write_image``).

Mirrors the reference's artifact-based diagnostics (SURVEY.md §4):
  * side-by-side stereo pair with epipolar lines
    (createStereoWithEpipolar, test/UTest.cpp:151-169),
  * CSV / MATLAB-style dumps of arrays for offline comparison
    (writeCSV / writeMAT, test/UTest.cpp:54-66),
  * disparity difference heat maps for A/B runs (the ExportDisparitiesToCSV
    analysis flow, test/UTest.cpp:333-363).
"""

from __future__ import annotations

import os

import numpy as np


def stereo_with_epipolar(
    left: np.ndarray, right: np.ndarray, n_lines: int = 12
) -> np.ndarray:
    """Horizontal side-by-side of the pair with epipolar guide lines — on a
    rectified pair every scene point lies on the same line in both halves."""
    l = np.asarray(left)
    r = np.asarray(right)
    if l.ndim == 2:
        l = np.stack([l] * 3, -1)
        r = np.stack([r] * 3, -1)
    H = min(l.shape[0], r.shape[0])
    canvas = np.concatenate([l[:H], r[:H]], axis=1).copy()
    for i in range(1, n_lines + 1):
        y = (H * i) // (n_lines + 1)
        canvas[y, :, 0] = 255
        canvas[y, :, 1] = 32
        canvas[y, :, 2] = 32
    return canvas


def write_csv(path: str, arr: np.ndarray, fmt: str = "%.4f") -> None:
    """Dump a 2-D array as CSV (offline numeric comparison)."""
    np.savetxt(path, np.asarray(arr), delimiter=",", fmt=fmt)


def write_mat(path: str, name: str, arr: np.ndarray) -> None:
    """Dump a 2-D array as a MATLAB-readable .m script (the reference's
    writeMAT format: ``name = [ ... ];``)."""
    a = np.asarray(arr)
    with open(path, "w") as f:
        f.write(f"{name} = [\n")
        for row in a:
            f.write(" ".join(f"{v:.6g}" for v in np.atleast_1d(row)) + ";\n")
        f.write("];\n")


def disparity_diff_image(
    a: np.ndarray, b: np.ndarray, scale: float = 32.0
) -> np.ndarray:
    """|a − b| disparity difference rendered to uint8 (white = large)."""
    d = np.abs(np.asarray(a, np.float32) - np.asarray(b, np.float32))
    return np.clip(d * scale, 0, 255).astype(np.uint8)


def dump_comparison(
    out_dir: str,
    ours: np.ndarray,
    oracle: np.ndarray,
    prefix: str = "disparity",
) -> dict:
    """Write the A/B artifact set (CSV + MAT + diff PNG); returns paths."""
    from ros_gpu_stereo_processor_tpu_torch.utils.io import write_image

    os.makedirs(out_dir, exist_ok=True)
    paths = {
        "ours_csv": os.path.join(out_dir, f"{prefix}_tpu.csv"),
        "oracle_csv": os.path.join(out_dir, f"{prefix}_oracle.csv"),
        "mat": os.path.join(out_dir, f"{prefix}_tpu.m"),
        "diff_png": os.path.join(out_dir, f"{prefix}_diff.png"),
    }
    write_csv(paths["ours_csv"], ours)
    write_csv(paths["oracle_csv"], oracle)
    write_mat(paths["mat"], prefix, ours)
    write_image(paths["diff_png"], disparity_diff_image(ours, oracle))
    return paths
