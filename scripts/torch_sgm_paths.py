#!/usr/bin/env python3
"""Captured frame time of BM and of SGM over 2, 4 and 8 paths on a CUDA
card, for this checkout or another (``--root``), so two commits are
compared in one session by running the script once per checkout, in turns.

    python3 scripts/torch_sgm_paths.py [--root DIR] [--frames N]

Run from the root of a checkout on a machine with an H100, ``nvcc`` and
PyTorch built for CUDA.  For each configuration (BM defaults; SGM at P1 10,
P2 120, block 15, texture 10: 4 paths at 128 disparities, 8 paths at 64 and
128, 2 paths at 128) a ``StereoPipeline`` on the card at 752×480 with the
EuRoC-like calibration, ``Outputs.all()``, over ``--frames`` distinct
``synthetic_stereo_pair(480, 752, 96, seed=1000 + i)`` frames (the SGM
frames of ``chip_smoke.py``): the first frame's ms (the eager run and the
capture), ``timed_process`` median and p75 over the others, pipelined ms a
frame, and from one ``torch.profiler`` window over 4 frames the host calls,
device events and device busy ms a frame (``chip_smoke.dispatch_profile``);
and the SHA-256 of frame 0's disparity and validity bytes, which two
checkouts that compute the same function print alike.  Only public entry
points are called in the checkout under ``--root``.  One JSON line per
configuration, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import runpy
import statistics
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = {   # label: StereoBMConfig fields
    "BM": {},
    "SGM 4 paths 128d": dict(algorithm="sgm", sgm_paths=4, num_disparities=128),
    "SGM 8 paths 64d": dict(algorithm="sgm", sgm_paths=8),
    "SGM 8 paths 128d": dict(algorithm="sgm", sgm_paths=8, num_disparities=128),
    "SGM 2 paths 128d": dict(algorithm="sgm", sgm_paths=2, num_disparities=128),
}
PROFILED = 4


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--frames", type=int, default=9)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_sgm_paths: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke           # this checkout's helpers, before --root is on the path
    card_line = runpy.run_path(
        os.path.join(ROOT, "ros_gpu_stereo_processor_tpu_torch", "utils", "device.py"))["card_line"]
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.ops import _build
    from ros_gpu_stereo_processor_tpu_torch.utils import calib

    if not _build.CSRC.is_relative_to(root):
        raise AssertionError(f"imported {_build.CSRC}, not the package under {root}")
    _build.build()
    H, W = chip_smoke.H, chip_smoke.W
    model = calib.euroc_like_model()
    frames = [port.synthetic_stereo_pair(H, W, 96, seed=1000 + i)[:2]
              for i in range(args.frames)]
    outputs = port.Outputs.all()
    label = os.path.basename(root.rstrip("/")) or root
    for name, fields in CONFIGS.items():
        cfg = port.PipelineConfig(stereobm=port.StereoBMConfig(**fields))
        pipe = port.StereoPipeline(model, cfg, device="cuda")
        res, first_ms = pipe.timed_process(*frames[0], outputs)
        out = res.fetch()
        digest = hashlib.sha256(out["disparity"].tobytes() + out["disparity_valid"].tobytes())
        ms = [pipe.timed_process(left, right, outputs)[1] for left, right in frames[1:]]
        line = {
            "root": label, "config": name, "frames": args.frames, "first_frame_ms": first_ms,
            "timed_median_ms": statistics.median(ms),
            "timed_p75_ms": float(np.percentile(ms, 75)),
            "pipelined_ms": chip_smoke.pipelined_ms(
                torch, lambda l, r: pipe.process(l, r, outputs), frames[1:]),
            **chip_smoke.dispatch_profile(
                torch, lambda i: pipe.process(*frames[1 + i % (len(frames) - 1)], outputs),
                PROFILED),
            "frame0_sha256": digest.hexdigest()[:16],
        }
        line.pop("host_calls_by_name")
        print(json.dumps(line), flush=True)
        pipe.senders.shutdown()
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
