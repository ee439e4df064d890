#!/usr/bin/env python3
"""Device time of the block matcher (K2, ``csrc/stereobm.cu``), of the SGM
cost stage and down walk (K4) and of the SGM path walks (K5, the frame's
three calls; ``csrc/sgm.cu``) on a CUDA card, at the whole image and at the
row-band mesh's band shapes.

    python3 scripts/torch_match_kernels.py [--root DIR] [--tiles 4,8,16,32]

Run on a machine with an H100, ``nvcc`` and PyTorch built for CUDA.
``--root`` names the checkout whose ``ros_gpu_stereo_processor_tpu_torch``
is imported and built (default: this one), so two commits are compared by
running the script once per checkout, in turns, in one session.  Only
public entry points are called there: ``stereobm_kernel.fused_raw`` (default
config: 64 disparities, block 15), ``sgm_kernel.cost_and_down`` and
``sgm_kernel.aggregate`` (the SGM cell: 128 disparities, block 15, P1 10, P2
120, uint16 cost, uint8 excess), on a prefiltered
``synthetic_stereo_pair(480, 752, 48, seed=100)`` (``image``), on its rows
0–133 (``band``, 134×752: a BM band of 120 rows with its 2×7 halo rows) and
on its rows 0–197 (``sgm_band``, 198×752: an SGM band of 120 rows with its
2×39 halo rows); every output checked equal to the plain version's.  Device
time per call by kernel name from one ``torch.profiler`` window over
``--reps`` calls: ``bm_fused`` for K2, ``sgm_cost`` (the cost stage) and
``sgm_walk`` (the down walk) for K4, ``sgm_walk`` for each of K5's calls
(up + down, left→right, right→left + left→right), each walk also as ns per
step (device time over its line length); CUDA events give the wrapper's
``ms``.

``--tiles`` (this checkout only) also times the strip heights given (rows
per block for K2, per warp for K4's integer-storage cost stage; 0 is the
automatic choice), each checked equal to the automatic one, in turns (A, B,
C, C, B, A).  One JSON line per measurement, then the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms_by_name(chip_smoke, torch, fn, reps, names):
    """{name: device ms per call} summed over the kernels whose profiler key
    contains the name, from one window over ``reps`` calls of ``fn``."""
    rows = chip_smoke.device_rows(torch, fn, reps)
    return {n: sum(t for k, _, t in rows if n in k) / 1e3 / reps for n in names}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose package is timed")
    ap.add_argument("--tiles", default="", help="strip heights to time, e.g. 0,4,8,16,32")
    ap.add_argument("--reps", type=int, default=50)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_match_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke           # this checkout's helpers, before --root is on the path

    H, W, band_rows = chip_smoke.H, chip_smoke.W, chip_smoke.BAND_ROWS
    sgm_band_rows = 120 + 2 * 39    # parallel/frontend.py: block_radius + 32 warm-up rows
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.ops import _build, sgm_kernel, stereobm, stereobm_kernel

    if not _build.CSRC.is_relative_to(root):
        raise AssertionError(f"imported {_build.CSRC}, not the package under {root}")
    _build.build()
    dev = torch.device("cuda", 0)
    left, right, _ = port.synthetic_stereo_pair(H, W, 48, seed=100)
    bm = port.StereoBMConfig()
    sg = port.StereoBMConfig(num_disparities=128, block_size=15)
    p1, p2 = 10.0, 120.0
    dts = sgm_kernel.storage_dtypes(sg, p1, p2, True)
    lt, rt = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    lf, rf = stereobm.prefilter(lt, bm), stereobm.prefilter(rt, bm)
    shapes = {"image": (lf, rf),
              "band": (lf[:band_rows].contiguous(), rf[:band_rows].contiguous()),
              "sgm_band": (lf[:sgm_band_rows].contiguous(), rf[:sgm_band_rows].contiguous())}
    label = os.path.basename(root.rstrip("/")) or root

    for shape, (a, b) in shapes.items():
        k2 = lambda: stereobm_kernel.fused_raw(a, b, bm)
        k4 = lambda: sgm_kernel.cost_and_down(a, b, sg, p1, p2, *dts)
        for got, want in zip(k2(), stereobm_kernel.fused_raw_plain(a, b, bm)):
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"K2 {shape}: differs from the plain version")
        for got, want in zip(k4(), sgm_kernel.cost_and_down_plain(a, b, sg, p1, p2, *dts)):
            torch.cuda.synchronize()
            if not torch.equal(got.float(), want.float()):
                raise AssertionError(f"K4 {shape}: differs from the plain version")
        t2 = device_ms_by_name(chip_smoke, torch, k2, args.reps, ["bm_fused"])
        t4 = device_ms_by_name(chip_smoke, torch, k4, args.reps, ["sgm_cost", "sgm_walk"])
        row = {"root": label, "shape": shape, "rows": a.shape[0], "cols": a.shape[1],
               "K2_device_ms": t2["bm_fused"], "K2_ms": chip_smoke.cuda_ms(torch, k2, args.reps),
               "K4_cost_device_ms": t4["sgm_cost"], "K4_walk_device_ms": t4["sgm_walk"],
               "K4_walk_step_ns": t4["sgm_walk"] * 1e6 / a.shape[0],
               "K4_ms": chip_smoke.cuda_ms(torch, k4, args.reps), "K5": {}}
        cost, down = k4()
        lr = sgm_kernel.aggregate(cost, None, p1, p2, False, False, dts[1])
        for name, exc_in, vertical, reverse in chip_smoke.k5_calls(down, lr):
            call = (cost, exc_in, p1, p2, vertical, reverse, dts[1])
            torch.cuda.synchronize()
            if not torch.equal(sgm_kernel.aggregate(*call).float(),
                               sgm_kernel.aggregate_plain(*call).float()):
                raise AssertionError(f"K5 {name} {shape}: differs from the plain version")
            ms = device_ms_by_name(chip_smoke, torch, lambda: sgm_kernel.aggregate(*call),
                                   args.reps, ["sgm_walk"])["sgm_walk"]
            row["K5"][name] = {"device_ms": ms,
                               "step_ns": ms * 1e6 / a.shape[0 if vertical else 1]}
        row["K5_mean_device_ms"] = sum(c["device_ms"] for c in row["K5"].values()) / 3
        print(json.dumps(row), flush=True)

    tiles = [int(t) for t in args.tiles.split(",") if t.strip()]
    if tiles:
        rows = {}
        for shape, (a, b) in shapes.items():
            ref2 = stereobm_kernel.fused_raw(a, b, bm)
            ref4 = sgm_kernel.cost_and_down(a, b, sg, p1, p2, *dts)
            for t in tiles + tiles[::-1]:
                k2 = lambda: stereobm_kernel._launch(a, b, bm, t)
                k4 = lambda: sgm_kernel._launch_cost_down(a, b, sg, p1, p2, *dts, tile_rows=t)
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(k2(), ref2)):
                    raise AssertionError(f"K2 {shape} at {t} rows differs")
                if not all(torch.equal(g.float(), w.float()) for g, w in zip(k4(), ref4)):
                    raise AssertionError(f"K4 {shape} at {t} rows differs")
                row = rows.setdefault((shape, t), {"root": label, "shape": shape, "tile_rows": t})
                row.setdefault("K2_device_ms", []).append(
                    device_ms_by_name(chip_smoke, torch, k2, args.reps, ["bm_fused"])["bm_fused"])
                row.setdefault("K4_cost_device_ms", []).append(
                    device_ms_by_name(chip_smoke, torch, k4, args.reps, ["sgm_cost"])["sgm_cost"])
        for row in rows.values():
            print(json.dumps(row), flush=True)
    print(f"card: {chip_smoke.card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
