#!/usr/bin/env python3
"""Where a process's first ``StereoSlam.optimize_global`` spends its time,
on a CUDA card.

    python3 scripts/torch_first_optimize_global.py [--frames N]

Run from the root of a checkout on a machine with an H100, ``nvcc`` and
PyTorch built for CUDA.  The port's SLAM engine runs the planar sequence
(utils/synth.py, 752×480, ``chip_smoke.py``'s camera, N frames, 40 by
default), and then, in this order and each closed by a synchronize:

  * ``detect_loop_closures`` twice (the loop-closure half of
    ``optimize_global``);
  * ``torch.func.jacfwd`` of a small function of a CUDA tensor, twice (the
    pose graph's Jacobian);
  * ``optimize_pose_graph`` on the engine's odometry graph, twice;
  * ``optimize_global`` twice.

The same is run again in a second process, with the first
``optimize_global`` under ``cProfile``: the functions with the most
cumulative and own time show what the first call pays for (imports, kernel
compilation, library handles).  Each process prints one JSON line (its
first-call and second-call times, ms); the profiled one also the profile's
top lines.  Then the card.
"""

from __future__ import annotations

import argparse
import cProfile
import io
import json
import os
import pstats
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def measure(frames: int, profiled: bool) -> dict:
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    import chip_smoke
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.models import posegraph as PG
    from ros_gpu_stereo_processor_tpu_torch.utils import calib, synth

    dev = torch.device("cuda", 0)
    lefts, rights, gt = synth.render_planar(frames, chip_smoke.W, chip_smoke.H, 441.0, 0.11,
                                            3.0, 10.0, 0)
    slam = port.StereoSlam(chip_smoke.planar_model(calib), device=dev)
    for _ in slam.run_stream(zip(lefts, rights, gt.stamps), depth=2):
        pass
    torch.cuda.synchronize()
    out = {"frames": frames, "keyframes": len(slam.store)}

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out[name] = (time.perf_counter() - t0) * 1e3

    def graph():
        R = torch.from_numpy(np.stack([k.R_wc for k in slam.store.frames]).astype(np.float32))
        t = torch.from_numpy(np.stack([k.t_wc for k in slam.store.frames]).astype(np.float32))
        R, t = R.to(dev), t.to(dev)
        return PG.PoseGraph(R, t, *PG.odometry_edges(R, t))

    x = torch.linspace(0.1, 1.0, 12, device=dev)
    if profiled:
        prof = cProfile.Profile()
        t0 = time.perf_counter()
        prof.runcall(slam.optimize_global)
        torch.cuda.synchronize()
        out["optimize_global_first_profiled_ms"] = (time.perf_counter() - t0) * 1e3
        timed("optimize_global_second_ms", slam.optimize_global)
        for key in ("cumulative", "tottime"):
            buf = io.StringIO()
            pstats.Stats(prof, stream=buf).sort_stats(key).print_stats(25)
            out[f"profile_by_{key}"] = buf.getvalue().splitlines()
        return out
    for i in ("first", "second"):
        timed(f"detect_loop_closures_{i}_ms", slam.detect_loop_closures)
    for i in ("first", "second"):
        timed(f"jacfwd_{i}_ms", lambda: torch.func.jacfwd(lambda v: torch.sin(v) * v)(x))
    g = graph()
    for i in ("first", "second"):
        timed(f"optimize_pose_graph_{i}_ms", lambda: PG.optimize_pose_graph(g))
    for i in ("first", "second"):
        timed(f"optimize_global_{i}_ms", slam.optimize_global)
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--one", choices=("timed", "profiled"),
                    help="run one measurement in this process (what each child does)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_first_optimize_global: no CUDA device", file=sys.stderr)
        return 1
    if args.one:
        print(json.dumps(measure(args.frames, args.one == "profiled")), flush=True)
        return 0
    for one in ("timed", "profiled"):
        res = subprocess.run([sys.executable, os.path.abspath(__file__), "--frames",
                              str(args.frames), "--one", one], timeout=900)
        if res.returncode != 0:
            return res.returncode
    sys.path.insert(0, ROOT)
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line

    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
