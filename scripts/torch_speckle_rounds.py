#!/usr/bin/env python3
"""Device time of the port's speckle walk (K3 ``speckle_labels``, K7
``speckle_maxprop``) by round count, on a CUDA card.

    python3 scripts/torch_speckle_rounds.py

Run from the root of a checkout on a machine with an H100, ``nvcc`` and
PyTorch built for CUDA.  On the 752×480 BM frame of ``chip_smoke.py`` (K3)
and on band 1 of its 4-band split (K7), each also transposed, it prints the
profiler's device time per call at 0, 1, 2, 3 and 4 rounds and at
convergence: round 0 alone is the first row pass (the source written, no
scan), so the differences between counts give the cost of one row pass, one
column pass and the grid barriers, and the transposes tell a row pass from a
column pass of the same length.  One JSON line per field, then the card.
"""

from __future__ import annotations

import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPS = 50
COUNTS = (0, 1, 2, 3, 4, 64)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("torch_speckle_rounds: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel, stereobm_kernel
    from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel
    from ros_gpu_stereo_processor_tpu_torch.parallel import frontend
    from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
    from ros_gpu_stereo_processor_tpu_torch.utils import calib

    dev = torch.device("cuda", 0)
    H, W = chip_smoke.H, chip_smoke.W
    maps = torch.from_numpy(chip_smoke.euroc_like_model(calib).rect_maps_stacked()).to(dev)
    l0, r0, _ = port.synthetic_stereo_pair(H, W, 48, seed=100)
    rect = remap_kernel.rectify(torch.from_numpy(np.stack([l0, r0])).to(dev), maps)
    disp, valid = stereobm_kernel.compute_disparity_fused(rect[0], rect[1],
                                                          port.StereoBMConfig())
    sp = port.SpeckleConfig()
    mesh = make_mesh(4, devices=[dev] * 4)
    field, cx, cy = frontend.speckle_size_fields(
        mesh.split(disp), mesh.split(valid), mesh,
        max_speckle_size=sp.max_speckle_size, max_diff=sp.max_diff)[1]

    def k3(d, v):
        return lambda k: speckle_kernel.labels(d, v, sp.max_diff, k)

    def k7(f, x, y):
        return lambda k: speckle_kernel.max_propagate(f, x, y, k)

    t = lambda a: a.t().contiguous()    # noqa: E731
    cases = [
        ("K3", f"{H}x{W}", k3(disp, valid)),
        ("K3", f"{W}x{H} (transposed)", k3(t(disp), t(valid))),
        ("K7", f"{field.shape[0]}x{field.shape[1]}", k7(field, cx, cy)),
        # transposing swaps which mask links along rows
        ("K7", f"{field.shape[1]}x{field.shape[0]} (transposed)",
         k7(t(field), t(cy), t(cx))),
    ]
    for kernel, shape, run in cases:
        row = {"kernel": kernel, "shape": shape}
        for k in COUNTS:
            ms, per_call = chip_smoke.device_cost(torch, lambda: run(k), REPS)
            row[f"device_ms_at_{k}"] = ms
            row["device_launches_per_call"] = per_call
        print(json.dumps(row), flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
