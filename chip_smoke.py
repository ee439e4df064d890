#!/usr/bin/env python3
"""Drive the PyTorch port's dense stereo pipeline once on a CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (any
CUDA card with ``sm_90a``), ``nvcc`` and PyTorch built for CUDA.  It

  1. requires a CUDA device and prints the card's name and power limit;
  2. builds the three hand-written kernels from ``csrc/`` with nvcc;
  3. holds each kernel against its plain PyTorch version, both on the card,
     at the main path's shapes (752×480, 64 disparities, block 15):
     K1 rectification remap (uint8 mono and RGB exact, float32 within
     rtol 1e-6), K2 fused block matcher (disparity and validity exact, for
     the default config, with ``refine_disparity`` and with
     ``uniqueness_ratio=15``), K3 speckle labels at 64 iterations (exact);
     and times both with CUDA events;
  4. runs ``StereoPipeline`` on the card at 752×480, default config,
     ``Outputs.all()``, over synthetic frames, checks that every kernel was
     launched on every frame, and compares every output with the same
     pipeline on CPU tensors (the plain versions): disparity, validity,
     ``disparity_vis`` and the images exact, ``pointcloud_xyz`` with equal
     NaN positions and rtol 1e-5, ``pointcloud_rgb`` bitwise;
  5. prints one JSON line with each kernel's launches, error and times, and
     as its last line ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a ``torch.profiler`` window over a few pipelined
frames, prints the device time by kernel and the device's busy share of the
window, and writes the Chrome trace to ``DIR/trace.json``.

Any failed phase raises, so the script exits nonzero and prints no result
line.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

FRAMES = 41         # frame 0 is the warm-up; 40 timed frames give a p75
COMPARED = 6        # frames also run on the CPU and compared (≥ 5)
KERNEL_REPS = 20
PLAIN_REPS = 3


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def euroc_like_model(calib):
    """The distorted EuRoC-like 752×480 calibration of
    ``__graft_entry__._model_and_frame`` (D = [-0.37, 0.11, 0, 0, 0])."""
    K = np.array([[460.0, 0, 376], [0, 460.0, 240], [0, 0, 1.0]])
    P = np.hstack([np.array([[441.0, 0, 322], [0, 441.0, 230], [0, 0, 1.0]]),
                   np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -44.1
    D = np.array([-0.37, 0.11, 0.0, 0.0, 0.0])

    def mk(PP, name):
        return calib.CameraCalib(752, 480, K, D, np.eye(3), PP, name)

    return calib.StereoCameraModel.from_calibs(mk(P, "left"), mk(Pr, "right"))


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def require_equal(name, got, want):
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not bool((got == want).all()):
        n = int((got != want).sum())
        raise AssertionError(f"{name}: {n} elements differ")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def profile_frames(torch, timing, pipe, frames, outputs, log_dir, top=15):
    """Device time by kernel over pipelined frames, and the device's busy
    share of the window's wall time (host clock around work that ends in a
    synchronize).  The Chrome trace goes to ``log_dir``."""
    torch.cuda.synchronize()
    with timing.trace(log_dir) as prof:
        t0 = time.perf_counter()
        for left, right in frames:
            pipe.process(left, right, outputs)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # kernel and memcpy events only: an operator's row repeats its kernels' time
    rows = [(e.key, e.count, e.self_device_time_total / 1e3)
            for e in prof.key_averages()
            if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
    if not rows:
        log("profile: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(r[2] for r in rows)
    n = len(frames)
    log(f"profile over {n} frames: wall {wall_ms / n:.3f} ms/frame, device busy "
        f"{busy_ms / n:.3f} ms/frame ({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(r[1] for r in rows) / n:.0f} kernels and copies/frame")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"  {ms / n:8.4f} ms/frame  {count / n:6.1f}/frame  {key[:90]}")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace a few frames, print device time by kernel "
                         "and write the Chrome trace into DIR")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.ops import (
        _build, remap, remap_kernel, speckle, speckle_kernel, stereobm,
        stereobm_kernel,
    )
    from ros_gpu_stereo_processor_tpu_torch.utils import calib, timing

    # the port uses no convolution and no matrix product; both TF32
    # switches are off all the same, so no library path can round
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")

    # -- build ------------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    log(f"build: {lib.name} in {time.perf_counter() - t0:.1f} s")

    model = euroc_like_model(calib)
    maps = torch.from_numpy(model.rect_maps_stacked()).to(dev)
    H, W = 480, 752
    results = {}

    # -- K1 remap -----------------------------------------------------------
    l0, r0, _ = port.synthetic_stereo_pair(H, W, 48, seed=100)
    mono = torch.from_numpy(np.stack([l0, r0])).to(dev)
    rgb = torch.from_numpy(
        np.random.default_rng(1).integers(0, 256, (2, H, W, 3), np.uint8)).to(dev)
    errs = []
    for label, imgs in (("mono", mono), ("rgb", rgb)):
        got = remap_kernel.rectify(imgs, maps)
        want = remap.rectify_pair(imgs, maps)
        torch.cuda.synchronize()
        require_equal(f"K1 {label}", got, want)
        errs.append(max_abs(got, want))
    f32 = mono.float() * 0.37
    got = remap_kernel.rectify(f32, maps)
    want = remap.rectify_pair(f32, maps)
    torch.cuda.synchronize()
    if not torch.allclose(got, want, rtol=1e-6, atol=0):
        raise AssertionError(f"K1 float32: max |diff| {max_abs(got, want)}")
    log(f"K1 remap float32 max |diff| {max_abs(got, want)} (rtol 1e-6)")
    results["K1"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(torch, lambda: remap_kernel.rectify(mono, maps), KERNEL_REPS),
        "plain_ms": cuda_ms(torch, lambda: remap.rectify_pair(mono, maps), PLAIN_REPS),
    }
    log("K1 remap: uint8 mono and RGB exact;", results["K1"])

    # -- K2 fused block matcher -------------------------------------------
    rect = remap_kernel.rectify(mono, maps)
    base = port.StereoBMConfig()
    errs = []
    for cfg in (base, base.replace(refine_disparity=True),
                base.replace(uniqueness_ratio=15)):
        d, v = stereobm_kernel.compute_disparity_fused(rect[0], rect[1], cfg)
        dp, vp = stereobm.compute_disparity(rect[0], rect[1], cfg)
        torch.cuda.synchronize()
        require_equal(f"K2 valid {cfg}", v, vp)
        require_equal(f"K2 disp {cfg}", d, dp)
        errs.append(max_abs(d, dp))
        log(f"K2 exact: refine={cfg.refine_disparity} uniq={cfg.uniqueness_ratio} "
            f"valid {float(v.float().mean()):.4f}")
    lf = stereobm.prefilter(rect[0], base)
    rf = stereobm.prefilter(rect[1], base)
    raw = stereobm_kernel.fused_raw(lf, rf, base)
    raw_plain = stereobm_kernel.fused_raw_plain(lf, rf, base)
    for a, b, nm in zip(raw, raw_plain, ("disp_raw", "best_cost", "excl")):
        require_equal(f"K2 {nm}", a, b)
    results["K2"] = {
        "max_abs_err": max(errs),
        "ms": cuda_ms(torch, lambda: stereobm_kernel.fused_raw(lf, rf, base), KERNEL_REPS),
        "plain_ms": cuda_ms(torch, lambda: stereobm_kernel.fused_raw_plain(lf, rf, base),
                            PLAIN_REPS),
    }
    log("K2 block matcher: raw maps and gated output exact;", results["K2"])

    # -- K3 speckle labels ------------------------------------------------
    disp, valid = stereobm_kernel.compute_disparity_fused(rect[0], rect[1], base)
    sp = port.SpeckleConfig()
    lab = speckle_kernel.labels(disp, valid, sp.max_diff, sp.propagation_iters)
    lab_plain = speckle._labels_scan(disp, valid, sp.max_diff, sp.propagation_iters)
    torch.cuda.synchronize()
    require_equal("K3 labels", lab, lab_plain)
    results["K3"] = {
        "max_abs_err": max_abs(lab, lab_plain),
        "ms": cuda_ms(torch, lambda: speckle_kernel.labels(
            disp, valid, sp.max_diff, sp.propagation_iters), KERNEL_REPS),
        "plain_ms": cuda_ms(torch, lambda: speckle._labels_scan(
            disp, valid, sp.max_diff, sp.propagation_iters), PLAIN_REPS),
    }
    log("K3 speckle labels: exact;", results["K3"])

    # -- end to end ---------------------------------------------------------
    outputs = port.Outputs.all()
    arrays = (model.rect_maps_stacked(), model.Q, W, H, model.fx, model.baseline)
    pipe = port.StereoPipeline.from_arrays(*arrays, device=dev)
    cpu_pipe = port.StereoPipeline.from_arrays(*arrays, device="cpu")
    frames = [port.synthetic_stereo_pair(H, W, 48, seed=i)[:2] for i in range(FRAMES)]
    path = {
        "K1": remap_kernel.KERNELS[torch.uint8],
        "K2": stereobm_kernel.KERNEL,
        "K3": speckle_kernel.KERNEL,
    }
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    per_frame_ms, gpu_out = [], []
    for i, (left, right) in enumerate(frames):
        before = {k: kern.launches for k, kern in path.items()}
        res, ms = pipe.timed_process(left, right, outputs)
        for k, kern in path.items():
            if kern.launches <= before[k]:
                raise AssertionError(f"frame {i}: {k} was not launched")
        per_frame_ms.append(ms)
        if i < COMPARED:
            gpu_out.append(res.fetch())
    launches = {k: kern.launches for k, kern in path.items()}
    log(f"launches over {FRAMES} frames: {launches}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for left, right in frames:
        last = pipe.process(left, right, outputs)
    last.block_until_ready()
    torch.cuda.synchronize()
    pipelined_ms = (time.perf_counter() - t0) * 1e3 / FRAMES

    for i in range(COMPARED):
        want = cpu_pipe.process(*frames[i], outputs).fetch()
        got = gpu_out[i]
        if sorted(got) != sorted(want):
            raise AssertionError(f"output keys {sorted(got)} vs {sorted(want)}")
        for k in want:
            g, w = got[k], want[k]
            if g.shape != w.shape or g.dtype != w.dtype:
                raise AssertionError(f"frame {i} {k}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
            if k == "pointcloud_rgb":
                ok = np.array_equal(g.view(np.int32), w.view(np.int32))
            elif k == "pointcloud_xyz":
                ok = (np.array_equal(np.isnan(g), np.isnan(w))
                      and np.allclose(g, w, rtol=1e-5, atol=0, equal_nan=True))
            else:
                ok = np.array_equal(g, w)
            if not ok:
                raise AssertionError(f"frame {i} {k}: GPU and CPU runs differ")
        d = got["disparity"]
        if d.shape != (H, W) or not np.isfinite(d).all() or not got["disparity_valid"].any():
            raise AssertionError(f"frame {i}: bad disparity")
        log(f"frame {i}: every output matches the CPU run; "
            f"valid {float(got['disparity_valid'].mean()):.4f}")

    steady = per_frame_ms[1:]
    median = statistics.median(steady)
    p75 = float(np.percentile(steady, 75))
    log(f"per-frame ms (frame 0 warm-up excluded): {[round(x, 3) for x in steady]}")
    log(f"e2e over {len(steady)} frames: median {median:.3f} ms/frame "
        f"({1e3 / median:.1f} fps), p75 {p75:.3f} ms, pipelined {pipelined_ms:.3f} "
        f"ms/frame, first frame {per_frame_ms[0]:.3f} ms")
    if args.profile:
        profile_frames(torch, timing, pipe, frames[1:11], outputs, args.profile)
    pipe.senders.shutdown()
    cpu_pipe.senders.shutdown()

    source = {
        "K1": ("remap_bilinear_u8", "ros_gpu_stereo_processor_tpu_torch/csrc/remap.cu",
               "ros_gpu_stereo_processor_tpu/ops/remap_pallas.py:154"),
        "K2": ("bm_fused", "ros_gpu_stereo_processor_tpu_torch/csrc/stereobm.cu",
               "ros_gpu_stereo_processor_tpu/ops/stereobm_pallas.py:153"),
        "K3": ("speckle_labels", "ros_gpu_stereo_processor_tpu_torch/csrc/speckle.cu",
               "ros_gpu_stereo_processor_tpu/ops/speckle_pallas.py:104"),
    }
    kernels = [
        {"name": source[k][0], "route": "cuda", "source": source[k][1],
         "replaces": source[k][2], "launches": launches[k], **results[k]}
        for k in ("K1", "K2", "K3")
    ]
    log(json.dumps({"e2e_frames": len(steady), "e2e_median_ms": median,
                    "e2e_p75_ms": p75, "e2e_pipelined_ms": pipelined_ms,
                    "e2e_first_frame_ms": per_frame_ms[0]}))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
