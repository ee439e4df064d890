"""The replayed sequence: a pool of distinct raw stereo pairs made from the seed.

A frozen copy of the port's ``utils/io.py::synthetic_stereo_pair`` (a
random-dot texture warped by a disparity field: a horizontal ramp and a
raised rectangle), extended so that invalid disparities and speckles occur
as in real scenes:

  * foreground blocks, each with its own texture and a larger disparity,
    drawn into both images at their own positions, so that the background
    beside them is half-occluded in the other view;
  * a low-texture band: rows of a smooth gradient with sparse ±1 noise,
    where the matcher's choice is weak and often wrong.

Which scenes a pool holds (the ramp, the blocks' places, sizes and
disparities, the band) depends on the pair's index in the pool alone, not
on the seed: every seed replays the same scenes, with textures drawn from
the seed and in an order drawn from the seed.  So the work a pair needs
(the speckle rounds above all) is the same set from seed to seed.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

_LAYOUT_SEED = 20240611   # the scenes' layout: fixed, independent of --seed


def scene_pair(height: int, width: int, scene: Dict, layout: np.random.Generator,
               texture: np.random.Generator) -> Tuple[np.ndarray, np.ndarray]:
    """(left, right) uint8 raw images of one scene.  ``scene``: the
    configuration's ``scene`` block (disparity ranges in pixels, block and
    band sizes as shares of the image)."""
    lo, hi = scene["background_disparity"]
    M = int(scene["foreground_disparity"][1]) + 8
    yy, xx = np.mgrid[0:height, 0:width]
    disp = lo + (hi - lo) * xx / width
    disp[height // 4: height // 2, width // 4: width // 2] += scene["raised_disparity"]
    disp = np.round(disp).astype(np.int64)

    tex = texture.integers(0, 255, size=(height, width + M), dtype=np.uint8)
    b0 = int(layout.uniform(*scene["band_rows"]) * height)
    b1 = min(height, b0 + int(scene["band_height"] * height))
    smooth = np.linspace(60, 200, width + M)[None, :] + np.zeros((b1 - b0, 1))
    noise = texture.integers(-1, 2, size=smooth.shape) * (texture.random(smooth.shape) < 0.3)
    tex[b0:b1] = np.clip(np.round(smooth + noise), 0, 255).astype(np.uint8)

    right = tex[:, M:].copy()
    left = tex[yy, xx + M - disp]
    n_blocks = int(layout.integers(scene["blocks"][0], scene["blocks"][1] + 1))
    for _ in range(n_blocks):
        bh = int(layout.uniform(*scene["block_size"]) * height)
        bw = int(layout.uniform(*scene["block_size"]) * width)
        df = int(layout.integers(scene["foreground_disparity"][0],
                                 scene["foreground_disparity"][1] + 1))
        y0 = int(layout.integers(0, height - bh))
        x0 = int(layout.integers(df, width - bw))
        fg = texture.integers(0, 255, size=(bh, bw), dtype=np.uint8)
        left[y0:y0 + bh, x0:x0 + bw] = fg
        right[y0:y0 + bh, x0 - df:x0 - df + bw] = fg
    return np.ascontiguousarray(left), np.ascontiguousarray(right)


def pool(config: Dict, seed: int, size: int,
         shape: Tuple[int, int] | None = None) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """``size`` distinct (left, right) pairs at the configuration's image
    size (or ``shape`` = (H, W), for tests), in the seed's order."""
    H, W = shape or (config["image"]["height"], config["image"]["width"])
    s = seed % (1 << 64)
    seq = np.random.SeedSequence([s & 0xFFFFFFFF, s >> 32])
    order = np.random.default_rng(seq.spawn(1)[0]).permutation(size)
    textures = seq.spawn(size)
    lefts, rights = [None] * size, [None] * size
    for j in range(size):
        layout = np.random.default_rng([_LAYOUT_SEED, j])
        l, r = scene_pair(H, W, config["scene"], layout, np.random.default_rng(textures[j]))
        lefts[order[j]], rights[order[j]] = l, r
    return lefts, rights
