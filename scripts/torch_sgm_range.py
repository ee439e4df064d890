#!/usr/bin/env python3
"""Device time of the 8-path SGM kernels over disparity ranges, at one
image size: what a wider range costs a cell.

    python3 scripts/torch_sgm_range.py [--shape 1988x2880] [--nds 256,304] [--reps 5] [--root DIR]

For each range, on a prefiltered random pair of the given (H, W), times
each call of the 8-path chain (``sgm_kernel.cost_and_down`` K4,
``aggregate`` K5 ×3, ``aggregate_diagonal`` DG ×2, ``wta`` K6; P1 10, P2
120, block 15, uint16 cost, uint8 excess) with CUDA events, the least of
``--reps`` calls, and prints one JSON line a range: ms a call and ns a cell
(over V = H·W·nd).  DG takes its pair walk up to 256 disparities and its
two-pass walk beyond.  Then the
card's name and power limit.  ``--root`` names the checkout whose
``ros_gpu_stereo_processor_tpu_torch`` is imported and built (default: this
one), so two commits are compared in one run.  Run on a machine with an
H100, ``nvcc`` and PyTorch built for CUDA.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def timed_ms(torch, fn, reps):
    """(least ms of ``reps`` calls, the last call's result)."""
    best, out = float("inf"), None
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        best = min(best, a.elapsed_time(b))
    return best, out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--shape", default="1988x2880", help="HxW")
    ap.add_argument("--nds", default="256,304")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--root", default=str(ROOT), help="checkout whose package is timed")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(Path(args.root).resolve()))
    import torch

    from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
    from ros_gpu_stereo_processor_tpu_torch.ops import sgm_kernel
    from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as bm_ops
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line

    H, W = (int(v) for v in args.shape.split("x"))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(7)
    left = torch.randint(0, 256, (H, W), generator=g, device=dev, dtype=torch.uint8)
    right = torch.roll(left, -40, dims=1)
    for nd in (int(v) for v in args.nds.split(",")):
        cfg = StereoBMConfig(algorithm="sgm", num_disparities=nd, block_size=15, sgm_p1=10.0,
                             sgm_p2=120.0, sgm_paths=8)
        lf, rf = bm_ops.prefilter(left, cfg), bm_ops.prefilter(right, cfg)
        cdt, edt = sgm_kernel.storage_dtypes(cfg, 10.0, 120.0, True)
        ms = {}
        ms["K4"], (cost, down) = timed_ms(
            torch, lambda: sgm_kernel.cost_and_down(lf, rf, cfg, 10.0, 120.0, cdt, edt), args.reps)
        ms["K5 up+down"], ev = timed_ms(
            torch, lambda: sgm_kernel.aggregate(cost, down, 10.0, 120.0, True, True, edt), args.reps)
        del down
        ms["K5 lr"], lr = timed_ms(
            torch, lambda: sgm_kernel.aggregate(cost, None, 10.0, 120.0, False, False, edt),
            args.reps)
        ms["K5 rl+lr"], eh = timed_ms(
            torch, lambda: sgm_kernel.aggregate(cost, lr, 10.0, 120.0, False, True, edt), args.reps)
        del lr
        pairs = [ev, eh]
        for dx in (1, -1):
            ms[f"DG {dx:+d}"], e = timed_ms(
                torch, lambda: sgm_kernel.aggregate_diagonal(cost, 10.0, 120.0, dx, edt),
                args.reps)
            pairs.append(e)
        ms["K6"], _ = timed_ms(torch, lambda: sgm_kernel.wta(cost, pairs, cfg), args.reps)
        V = H * W * nd
        print(json.dumps({"H": H, "W": W, "nd": nd, "root": args.root,
                          "ms": ms, "sum_ms": sum(ms.values()),
                          "ns_per_cell": {k: 1e6 * v / V for k, v in ms.items()}}), flush=True)
        del cost, pairs, ev, eh, e
        torch.cuda.empty_cache()
    print(card_line(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
