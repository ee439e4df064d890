#!/usr/bin/env python3
"""Time the port's remap kernel (K1, ``csrc/remap.cu``) at several block
shapes on a CUDA card.

    python3 scripts/torch_remap_blocks.py [--shapes 64x4,32x8,128x2]

Run from the root of a checkout on a machine with an H100, ``nvcc`` and
PyTorch built for CUDA.  For each block shape (threads along a row × rows)
it compiles ``csrc/remap.cu`` alone with ``-DREMAP_BLOCK_X/Y`` and the
library's nvcc flags, all shapes in parallel, into the package's git-ignored
``build/remap_blocks/``, then, at the pipeline's shapes (the 752×480 uint8
mono pair and RGB pair on the maps of ``utils/calib.py::euroc_like_model``): checks
each variant exact against the plain version, and times it by CUDA events
over back-to-back direct calls and by the profiler's device time.  The
shapes are timed in turns (A, B, C, C, B, A) in one process, one JSON line
per shape, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 200


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shapes", default="64x4,32x8,128x2")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_remap_blocks: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.ops import _build, remap
    from ros_gpu_stereo_processor_tpu_torch.utils import calib
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line

    shapes = [tuple(int(v) for v in s.split("x")) for s in args.shapes.split(",")]
    out_dir = _build.BUILD_DIR / "remap_blocks"
    out_dir.mkdir(parents=True, exist_ok=True)
    libs, procs = {}, []
    for bx, by in shapes:
        lib = out_dir / f"libremap_{bx}x{by}.so"
        cmd = [_build._nvcc(), *_build.NVCC_FLAGS, f"-DREMAP_BLOCK_X={bx}",
               f"-DREMAP_BLOCK_Y={by}", "-o", str(lib), str(_build.CSRC / "remap.cu")]
        procs.append((cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                            stderr=subprocess.PIPE, text=True)))
        libs[(bx, by)] = lib
    for cmd, p in procs:
        so, se = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{so}\n{se}")

    dev = torch.device("cuda", 0)
    H, W = chip_smoke.H, chip_smoke.W
    maps = torch.from_numpy(calib.euroc_like_model().rect_maps_stacked()).to(dev)
    l0, r0, _ = port.synthetic_stereo_pair(H, W, 48, seed=100)
    stacks = {
        "mono": torch.from_numpy(np.stack([l0, r0])).to(dev),
        "rgb": torch.from_numpy(
            np.random.default_rng(1).integers(0, 256, (2, H, W, 3), np.uint8)).to(dev),
    }

    def caller(shape, imgs):
        fn = ctypes.CDLL(str(libs[shape])).remap_bilinear_u8
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        C = imgs.shape[3] if imgs.dim() == 4 else 1
        out = torch.empty_like(imgs)
        argv = [_build.ptr(imgs), _build.ptr(maps), _build.ptr(out), 2, H, W, H, W, C]

        def run():
            err = fn(*argv, torch.cuda.current_stream().cuda_stream)
            if err:
                raise RuntimeError(f"remap {shape}: CUDA error {err}")
            return out
        return run

    rows = {s: {"block": f"{s[0]}x{s[1]}"} for s in shapes}
    for label, imgs in stacks.items():
        want = remap.rectify_pair(imgs, maps)
        for s in shapes:
            got = caller(s, imgs)()
            torch.cuda.synchronize()
            chip_smoke.require_equal(f"remap {s} {label}", got, want)
        for s in shapes + shapes[::-1]:           # in turns: A, B, C, C, B, A
            run = caller(s, imgs)
            ms = chip_smoke.cuda_ms(torch, run, REPS)
            dev_ms, per_call = chip_smoke.device_cost(torch, run, REPS)
            rows[s].setdefault(f"{label}_ms", []).append(ms)
            rows[s].setdefault(f"{label}_device_ms", []).append(dev_ms)
            rows[s][f"{label}_device_launches_per_call"] = per_call
    for s in shapes:
        print(json.dumps(rows[s]), flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
