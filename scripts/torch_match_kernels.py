#!/usr/bin/env python3
"""Device time of the block matcher (K2, ``csrc/stereobm.cu``), of the SGM
cost stage and down walk (K4) and of the SGM path walks (K5, the frame's
three calls; ``csrc/sgm.cu``), of the SGM diagonal pair walk (DG, the
8-path frame's two calls; ``csrc/sgm_diagonal.cu``) and of the SGM
winner-take-all (K6) on a CUDA card, at the whole image and at the row-band
mesh's band shapes.

    python3 scripts/torch_match_kernels.py [--root DIR] [--tiles 4,8,16,32]

Run on a machine with an H100, ``nvcc`` and PyTorch built for CUDA.
``--root`` names the checkout whose ``ros_gpu_stereo_processor_tpu_torch``
is imported and built (default: this one), so two commits are compared by
running the script once per checkout, in turns, in one session.  Only
public entry points are called there: ``stereobm_kernel.fused_raw`` (default
config: 64 disparities, block 15), ``sgm_kernel.cost_and_down`` and
``sgm_kernel.aggregate`` (the SGM cell: 128 disparities, block 15, P1 10, P2
120, uint16 cost, uint8 excess; on the image also 64 disparities in that
storage and 64 at P1 7.5, P2 93.25, float32 storage), on a prefiltered
``synthetic_stereo_pair(480, 752, 48, seed=100)`` (``image``), on its rows
0–133 (``band``, 134×752: a BM band of 120 rows with its 2×7 halo rows) and
on its rows 0–197 (``sgm_band``, 198×752: an SGM band of 120 rows with its
2×39 halo rows); every output checked equal to the plain version's.  Device
time per call by kernel name from one ``torch.profiler`` window over
``--reps`` calls: ``bm_fused`` for K2, ``sgm_cost`` (the cost stage) and
``sgm_walk`` (the down walk) for K4, ``sgm_walk`` for each of K5's calls
(up + down, left→right, right→left + left→right), each walk also as ns per
step (device time over its line length), and, in a checkout that has it,
``sgm_diagonal`` for each of DG's two calls (dx +1, −1; ``steps``, the
call's longest chain, is ``sgm_kernel.diagonal_steps`` where the checkout
has it, min(H, W) for the pair walk, else 2·min(H, W): a line walked down
and back up; ns per step over it; ``flushed_device_ms``, the same with
L2 emptied of the volumes before each call by a read of a 256 MB buffer,
twice the card's L2) and there ``sgm_wta`` for K6 over 2, 4 and 8 paths
(``csrc/sgm_wta.cu``; the frame's pair volumes); CUDA events give the
wrapper's ``ms``.  ``build_s``: the seconds ``_build.build()`` took in
this run (0 where the library for these sources was already built).

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
import time
import runpy
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def device_ms_by_name(chip_smoke, torch, fn, reps, names, least=1):
    """{name: device ms per call} summed over the kernels whose profiler key
    contains the name, from one window over ``reps`` calls of ``fn`` that
    recorded at least ``least`` device events a call (a window that lost
    events is tried again)."""
    rows = chip_smoke.device_rows(torch, fn, reps, least)
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
    # this checkout's card_line, read from its file: the package is imported
    # from --root below, which may be a checkout without it
    card_line = runpy.run_path(
        os.path.join(ROOT, "ros_gpu_stereo_processor_tpu_torch", "utils", "device.py"))["card_line"]

    H, W, band_rows = chip_smoke.H, chip_smoke.W, chip_smoke.BAND_ROWS
    sgm_band_rows = 120 + 2 * 39    # parallel/frontend.py: block_radius + 32 warm-up rows
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.ops import _build, sgm_kernel, stereobm, stereobm_kernel

    if not _build.CSRC.is_relative_to(root):
        raise AssertionError(f"imported {_build.CSRC}, not the package under {root}")
    t0 = time.perf_counter()
    _build.build()
    build_s = time.perf_counter() - t0
    dev = torch.device("cuda", 0)
    left, right, _ = port.synthetic_stereo_pair(H, W, 48, seed=100)
    bm = port.StereoBMConfig()
    p1, p2 = 10.0, 120.0
    lt, rt = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    lf, rf = stereobm.prefilter(lt, bm), stereobm.prefilter(rt, bm)
    shapes = {"image": (lf, rf),
              "band": (lf[:band_rows].contiguous(), rf[:band_rows].contiguous()),
              "sgm_band": (lf[:sgm_band_rows].contiguous(), rf[:sgm_band_rows].contiguous())}
    label = os.path.basename(root.rstrip("/")) or root
    flush = torch.ones(256 << 20, dtype=torch.uint8, device=dev)   # read to empty L2

    # (shape, disparities, P1, P2): the SGM cell on each shape, then DG's and
    # K5's other widths on the image (64 in the same storage, 64 in float32)
    cases = [(shape, 128, p1, p2) for shape in shapes] + [("image", 64, p1, p2),
                                                          ("image", 64, 7.5, 93.25)]
    for shape, nd, p1, p2 in cases:
        a, b = shapes[shape]
        sg = port.StereoBMConfig(num_disparities=nd, block_size=15)
        dts = sgm_kernel.storage_dtypes(sg, p1, p2, True)
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
        t4 = device_ms_by_name(chip_smoke, torch, k4, args.reps, ["sgm_cost", "sgm_walk"], 2)
        row = {"root": label, "shape": shape, "rows": a.shape[0], "cols": a.shape[1],
               "nd": nd, "p1": p1, "p2": p2, "storage": [str(t) for t in dts],
               "build_s": build_s,
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
        if hasattr(sgm_kernel, "aggregate_diagonal"):    # a checkout with DG
            steps = (sgm_kernel.diagonal_steps(*a.shape, nd, *dts)
                     if hasattr(sgm_kernel, "diagonal_steps") else 2 * min(a.shape))
            row["DG"] = {"steps": steps}
            for dx in (1, -1):
                call = (cost, p1, p2, dx, dts[1])
                torch.cuda.synchronize()
                if not torch.equal(sgm_kernel.aggregate_diagonal(*call).float(),
                                   sgm_kernel.aggregate_diagonal_plain(*call).float()):
                    raise AssertionError(f"DG dx {dx} {shape}: differs from the plain version")
                ms = device_ms_by_name(chip_smoke, torch,
                                       lambda: sgm_kernel.aggregate_diagonal(*call),
                                       args.reps, ["sgm_diagonal"])["sgm_diagonal"]
                flushed = device_ms_by_name(
                    chip_smoke, torch,
                    lambda: (flush.max(), sgm_kernel.aggregate_diagonal(*call)),
                    args.reps, ["sgm_diagonal"])["sgm_diagonal"]
                row["DG"][f"dx {dx:+d}"] = {"device_ms": ms, "step_ns": ms * 1e6 / steps,
                                            "flushed_device_ms": flushed}
            # K6 over 2, 4 and 8 paths on this shape's pair volumes
            ev = sgm_kernel.aggregate(cost, down, p1, p2, True, True, dts[1])
            eh = sgm_kernel.aggregate(cost, lr, p1, p2, False, True, dts[1])
            diag = [sgm_kernel.aggregate_diagonal(cost, p1, p2, dx, dts[1]) for dx in (1, -1)]
            row["K6"] = {}
            for n, pairs in ((2, (eh,)), (4, (ev, eh)), (8, (ev, eh, *diag))):
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(sgm_kernel.wta(cost, pairs, sg),
                                                             sgm_kernel.wta_plain(cost, pairs, sg))):
                    raise AssertionError(f"K6 {n} paths {shape}: differs from the plain version")
                row["K6"][f"{n} paths"] = device_ms_by_name(
                    chip_smoke, torch, lambda: sgm_kernel.wta(cost, pairs, sg), args.reps,
                    ["sgm_wta"])["sgm_wta"]
        print(json.dumps(row), flush=True)

    tiles = [int(t) for t in args.tiles.split(",") if t.strip()]
    p1, p2 = 10.0, 120.0
    sg = port.StereoBMConfig(num_disparities=128, block_size=15)
    dts = sgm_kernel.storage_dtypes(sg, p1, p2, True)
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
                    device_ms_by_name(chip_smoke, torch, k4, args.reps, ["sgm_cost"], 2)["sgm_cost"])
        for row in rows.values():
            print(json.dumps(row), flush=True)
    print(f"card: {card_line()}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
