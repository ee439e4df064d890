"""The comparison that decides ``correct``.

A sample of the pairs published in the window (``loop.Sampler``) is held
against the plain reference (``reference.py``), worked out for each
distinct pool pair in the sample from the raw images and the
configuration's calibration numbers, one pair at a time, after the window
has closed and the port's state is freed.  The numbers compared, each with
its limit in the configuration's ``limits``:

  * ``disp_mismatch_px``: pixels whose published disparity (decoded from
    its wire) is not the reference's, bit for bit;
  * ``xyz_nan_mismatch_px``: points invalid (NaN) on one side only;
  * ``xyz_max_rel_err``: the largest ‖xyz − xyz_ref‖ / ‖xyz_ref‖ over the
    points valid on both sides (the reference in float64);
  * ``rgb_mismatch_px``: points whose packed 0x00RRGGBB differs.

A run is correct when every number is within its limit, at least one pair
was compared, and no pair failed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from stereo_bench import reference

NUMBERS = ("disp_mismatch_px", "xyz_nan_mismatch_px", "xyz_max_rel_err", "rgb_mismatch_px")


def compare(published: Dict[str, tuple], ref: Dict) -> Dict[str, float]:
    """The numbers of one pair: ``published`` {"disparity": (image,),
    "pointcloud": (xyz, rgb)} as the messages carried them."""
    disp = np.asarray(published["disparity"][0], np.float32)
    xyz = np.asarray(published["pointcloud"][0], np.float64)
    rgb = np.ascontiguousarray(published["pointcloud"][1], np.float32).view(np.int32)
    r_disp = ref["disparity"].cpu().numpy()
    r_xyz = ref["xyz"].to(torch.float64).cpu().numpy()
    r_rgb = ref["rgb"].cpu().numpy()
    nan, r_nan = np.isnan(xyz).any(-1), np.isnan(r_xyz).any(-1)
    both = ~nan & ~r_nan
    err = 0.0
    if both.any():
        num = np.linalg.norm(xyz[both] - r_xyz[both], axis=-1)
        den = np.maximum(np.linalg.norm(r_xyz[both], axis=-1), 1e-12)
        err = float((num / den).max())
    return {
        "disp_mismatch_px": float((disp.view(np.int32) != r_disp.view(np.int32)).sum()),
        "xyz_nan_mismatch_px": float((nan != r_nan).sum()),
        "xyz_max_rel_err": err,
        "rgb_mismatch_px": float((rgb != r_rgb).sum()),
    }


def check(kept: Dict[int, Dict[str, tuple]], window: Tuple[float, float], done: np.ndarray,
          lefts: List[np.ndarray], rights: List[np.ndarray], config: Dict,
          device, dtype=torch.float32, shape=None) -> Tuple[Dict[str, float], int, List[float]]:
    """(the numbers over the sample, pairs compared, speckle rounds of each
    distinct pool pair).  ``kept``: the sampler's copies; a pair counts when
    both its messages were published and its last one inside ``window``."""
    H, W = shape or (config["image"]["height"], config["image"]["width"])
    maps, Q = reference.camera(config["calibration"], W, H)
    maps = torch.as_tensor(maps, device=device)
    totals = {"disp_mismatch_px": 0.0, "xyz_nan_mismatch_px": 0.0,
              "xyz_max_rel_err": 0.0, "rgb_mismatch_px": 0.0}
    refs: Dict[int, Dict] = {}
    n = 0
    for i in sorted(kept):
        got = kept[i]
        if len(got) < 2 or i >= len(done) or not window[0] <= done[i] <= window[1]:
            continue
        j = i % len(lefts)
        if j not in refs:
            refs[j] = reference.step(lefts[j], rights[j], config, maps, Q, dtype, device)
        one = compare(got, refs[j])
        for k, v in one.items():
            totals[k] = max(totals[k], v) if k == "xyz_max_rel_err" else totals[k] + v
        n += 1
    return totals, n, [r["rounds"] for r in refs.values()]


def verdict(numbers: Dict[str, float], limits: Dict[str, float], compared: int,
            failed: int) -> bool:
    return (compared > 0 and failed == 0
            and all(numbers[k] <= limits[k] for k in NUMBERS))
