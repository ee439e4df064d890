#!/usr/bin/env python3
"""Drive the PyTorch port's stereo pipeline, SLAM engine, multi-device and
multi-process paths, serve daemon, command line and bench once on a CUDA
card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with one NVIDIA H100 (any
CUDA card with ``sm_90a``), ``nvcc`` and PyTorch built for CUDA.  It

  1. requires a CUDA device and prints the card's name and power limit;
  2. builds the hand-written kernels from ``csrc/`` with nvcc (one process
     per source, in parallel);
  3. holds each kernel against its plain PyTorch version, both on the card,
     at the main paths' shapes (752×480, block 15) and times both with CUDA
     events (``ms``, host enqueue included) and the kernel's device time
     and device launches per call with ``torch.profiler`` (``device_ms``):
     K1 rectification remap at widths 752 and 751 (uint8 mono and RGB
     exact, float32 within rtol 1e-6; one device launch per call; against
     ``grid_sample`` on both clocks), K2 fused block matcher at 64
     disparities (raw maps and gated output exact, default config,
     ``refine_disparity``, ``uniqueness_ratio=15``; raw maps exact and
     device time on a mesh band's 134×752 launch), K3 speckle labels
     (exact at 1, 2, one short of the rounds the frame needs, those rounds
     and 64), and the SGM kernels K4 cost + down path (the cost stage's and
     the down walk's device time apart, and the walk's ns per step), K5 path
     aggregation (the frame's three calls, each also timed apart with its ns
     per step) and K6 winner-take-all at 64 and 128
     disparities with quantised storage and at 64 with float32 storage (P1
     7.5, P2 93.25), all exact; K7 max-propagation on one band of the
     4-band split (120×752, its field and masks built by the row-sharded
     speckle filter from a BM frame's disparity) and the band label rounds
     beside it, exact at the same kinds of round counts (up to 480 and 64);
     K3, K7 and the band label rounds 2 device launches per call (the
     persistent walk and a memset), K4 2 (cost stage, down walk), the
     others 1;
  4. runs ``StereoPipeline`` on the card at 752×480, ``Outputs.all()``, over
     synthetic frames, for each main path:
       * block matching (default config, 64 disparities): 21 frames, each
         launching K1 twice, K2 and K3 once; 3 compared with the CPU run;
       * SGM (4 paths, 128 disparities, block 15, texture 10): 11 frames,
         each launching K1 twice, K3, K4 and K6 once and K5 three times, and
         not K2; 2 compared with the CPU run;
       * the row-band mesh, ``make_mesh(4, devices=["cuda:0"] * 4)``, default
         BM config: 6 frames, each launching K1 and K2 once per band per
         call (8 and 4), K7 once per band (4), the band label rounds at
         least once and K3 never; 2 compared with the CPU run of the same
         4-band mesh;
     and, with ``lr_check=True``, one BM frame (K2 twice) and one SGM frame,
     each compared with the CPU run; on the mesh, one frame with speckle
     off against the single-device card pipeline, and one SGM frame (K4,
     K5 ×3, K6 per band) and one ``lr_check`` frame (K2 twice per band)
     against the CPU mesh run.  The comparison: disparity, validity,
     ``disparity_vis`` and the images exact, ``pointcloud_xyz`` with equal
     NaN positions and rtol 1e-5, ``pointcloud_rgb`` bitwise.  Then
     disparity slabs (``shard_mode="disp"``), BM defaults, at 64
     disparities over 4 slabs and 128 over 8 (BASELINE config 3), each on
     entries of ``cuda:0``: 6 frames, each launching K1 twice per band, K7
     once per band and the band label rounds, never K2 or K3; 2 compared
     with the CPU slab run of the same mesh, frame 0 with speckle off
     against the single-device K2 pipeline on the card (every output
     exact), device launches and busy share per frame by ``torch.profiler``
     over 3;
  5. runs the SLAM engine, ``StereoSlam`` on the card with the default
     ``PipelineConfig`` (BM) and ``SlamConfig``, over the port's planar
     synthetic sequence (utils/synth.py, rendered with numpy while the
     kernels build: 752×480, fx 441, baseline 0.11, Z0 3 m, 60 frames, seed
     0): ``run_stream(depth=2)``, each frame launching K1, K2 and K3 once,
     then ``optimize_global()``; fails unless every frame after the first
     is tracked and the ATE after ``optimize_global`` is under 0.1 m.  The
     card's first 8 frames against the port's CPU run of them (keypoints
     exact, descriptors exact where the steering bins agree, match counts,
     tracked flags and keyframe decisions exact, poses within 1e-5), device
     launches and busy share per SLAM frame from ``torch.profiler`` over 5
     frames, and a 20-frame ``async_mapping=True`` run against the
     synchronous one (the same frame count, keyframes within 1, final pose
     within 0.05 m).  The same 60 frames on a ``("kf",)`` mesh of 2 entries
     of ``cuda:0`` (the windowed BA landmark-sharded; K1, K2, K3 once a
     frame) and on a (kf, rows) 2 × 4 mesh (the pipeline by 4 row bands:
     K1, K2 and K7 four times a frame, never K3): ATE under 0.1 m after
     ``optimize_global``, every frame's position within 1e-4 m of the
     single-device run, BA ms per keyframe;
  6. runs the multi-process worker (parallel/multihost.py) at 752×480, BM
     defaults, as 2 processes × 2 bands on ``cuda:0`` over gloo: ``DENSE``
     (row-band matcher and speckle filter, fed host-locally through the
     native ring) and ``PIPE`` (the whole pipeline on the process mesh)
     equal across the ranks and to the one-process 4-entry mesh on
     ``cuda:0``, ``BA`` (the sharded BA over a 4-entry ``kf`` mesh) equal
     across the ranks and within rtol 1e-3 of one process, each rank's K1,
     K2, K7 and band label rounds launched; then ``measure_scaling`` on 1,
     2 and 4 entries of ``cuda:0`` (row bands with speckle, and slabs;
     ``wall_overhead_vs_1dev`` is the number to read there, since entries
     on one card add no hardware) and ``dryrun_multichip(4, ["cuda:0"] *
     4)`` (the full 752×480 pipeline by bands with speckle and bilateral,
     the band matcher, SGM, remap and slabs against their twins, the
     sharded BA and SLAM on a (kf, rows) mesh);
  7. runs the serving paths at 752×480 with the EuRoC-like calibration,
     each frame launching K1, K2 and K3 and no other kernel:
       * Bayer input: BM defaults on ``bayer_grbg8`` frames (the synthetic
         pairs' planes as the mosaic), ``Outputs.all()``, 6 frames, 2
         compared with the CPU run as in 4, device launches and busy ms per
         frame by ``torch.profiler`` over 3; and ``convert`` from each of
         the four Bayer phases (to mono8, rgb8, bgr8, and the uint16
         debayer) against the CPU, exact;
       * the bilateral tier: BM defaults with the bilateral filter on
         (ndisp 64, radius 3), iterations 1 and 3, 11 frames each (median
         and p75 of ``timed_process``), device launches and busy ms per
         frame by ``torch.profiler`` over 3 frames, 2 frames against the
         CPU run: every output not derived from the disparity exact, the
         disparity equal on at least 99.9 % of the pixels (the card's
         ``expf`` may differ from the CPU's in the last bit) and, where
         equal, ``disparity_vis`` and the points too;
       * the bilateral filter by row band: 4 bands on ``["cuda:0"] * 4``
         against one device on the card, speckle off, 2 frames, exact;
       * the serve daemon: a ``ServeDaemon`` on the card watching a
         temporary directory, the calibration dropped as
         ``camera_info_*.yaml`` after start, 20 pairs dropped one at a time
         as PNGs written by the port's own encoder, a ``reconfigure.json``
         setting 32 disparities before frame 10; gates: 20 frames served
         (K1, K2, K3 20 launches each, counts set to 0 just before), the
         native ring, frames 0, 10 and 19 equal to the port's CPU pipeline
         under the config in force; prints the daemon's TIMING line;
       * the command line, in subprocesses: ``info``, then ``run --euroc``
         on a 5-frame EuRoC directory whose frame 0 is the served frame 0:
         exit 0 and that frame's disparity equal to the served one;
  8. runs the port's bench (``python3 -m
     ros_gpu_stereo_processor_tpu_torch.bench``) in a subprocess at the JAX
     bench's defaults: exit 0, a last line of at most 1,800 characters whose
     every metric is finite and > 0, no ``*_error`` key, K1–K6 launched
     (counts set to 0 at the bench's start) and K7 and BL not; then, in this
     process, the bench's timed compute window and one SGM and SLAM-compute
     unit of work under ``torch.cuda.set_sync_debug_mode("error")``: no host
     sync inside them;
  9. prints the seconds of each phase, one JSON line per path with its
     frame times, one JSON line with each kernel's launches, error, times
     (events and device) and bound, and as its last line
     ``{"ok": true, "device": {...}}``.

``--profile DIR`` adds a ``torch.profiler`` window over a few pipelined
frames of each path, prints the device time by kernel and the device's
busy share of the window, and writes the Chrome traces under ``DIR``.

Any failed phase raises, so the script exits nonzero and prints no result
line.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

FRAMES = 21         # BM path: frame 0 is the warm-up; 20 timed frames give a p75
COMPARED = 3        # BM frames also run on the CPU and compared
SGM_FRAMES = 11     # SGM path: 1 warm-up + 10 timed
SGM_COMPARED = 2
MESH_FRAMES = 6     # mesh path: 1 warm-up + 5 timed
MESH_COMPARED = 2
SLAM_FRAMES = 60    # SLAM path: the planar sequence's frames
SLAM_COMPARED = 8   # its first frames, also run on the CPU and compared
SLAM_ASYNC = 20     # frames of the async-mapping run
SLAM_PROFILED = 5   # frames in a profiler window
SLAM_POSE_ATOL = 1e-5
ATE_GATE_M = 0.1    # tests/test_ate.py's gate
SLAM_FLAGS = ("is_keyframe", "tracked", "lost", "relocalized", "n_matches")
BAYER_FRAMES = 6    # Bayer path: 1 warm-up + 5 timed
BAYER_COMPARED = 2
BILATERAL_FRAMES = 11   # each bilateral path: 1 warm-up + 10 timed
BILATERAL_COMPARED = 2
BILATERAL_PROFILED = 3  # frames in a profiler window
BILATERAL_EQUAL_SHARE = 0.999   # the card's expf may differ from the CPU's in the last bit
SERVE_FRAMES = 20
SERVE_RECONF_AT = 10    # reconfigure.json dropped before this frame
SERVE_CHECKED = (0, 10, 19)
SERVE_RANGE = 32        # the num_disparities it sets (from 64)
CLI_FRAMES = 5
SLAB_FRAMES = 6     # each slab path: 1 warm-up + 5 timed
SLAB_COMPARED = 2
SLAM_MESH_POSE_ATOL = 1e-4   # m: the sharded BA sums its blocks in another order
MULTIHOST_FPS_ITERS = 5
MULTIHOST_TIMEOUT_S = 300
BANDS = 4
SLABS = ((64, BANDS), (128, 8))   # (disparities, slabs): BM defaults; BASELINE config 3
BAND_ROWS = 134     # a mesh band's launch: 480 / BANDS rows and 2 x 7 halo rows
KERNEL_REPS = 20
PLAIN_REPS = 3
PROFILER_WINDOWS = 8   # windows tried when the profiler drops a window's events
BENCH_TIMEOUT_S = 600
BENCH_WINDOW_ITERS = 10   # the compute section's BENCH_ITERS
H, W = 480, 752

SOURCES = {   # key: (C entry point, CUDA source, TPU kernel it replaces)
    "K1": ("remap_bilinear_u8", "csrc/remap.cu", "ops/remap_pallas.py:154"),
    "K2": ("bm_fused", "csrc/stereobm.cu", "ops/stereobm_pallas.py:153"),
    "K3": ("speckle_labels", "csrc/speckle.cu", "ops/speckle_pallas.py:104"),
    "K4": ("sgm_cost_down", "csrc/sgm.cu", "ops/sgm_pallas.py:191"),
    "K5": ("sgm_aggregate", "csrc/sgm.cu", "ops/sgm_pallas.py:349"),
    "K6": ("sgm_wta", "csrc/sgm.cu", "ops/sgm_pallas.py:432"),
    "K7": ("speckle_maxprop", "csrc/speckle.cu", "ops/speckle_pallas.py:164"),
    # the band-local label rounds of the mesh speckle filter: no TPU kernel,
    # they replace the JAX band's jnp scans
    "BL": ("speckle_band_labels", "csrc/speckle.cu", "parallel/frontend.py:585"),
}


def log(*a):
    print(*a, flush=True)


@contextlib.contextmanager
def phase(name, seconds):
    t0 = time.perf_counter()
    yield
    seconds[name] = time.perf_counter() - t0
    log(f"phase {name}: {seconds[name]:.1f} s")


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


def device_rows(torch, fn, reps, least=0):
    """[(key, count, self device µs)] of every device event (kernels,
    memsets, copies) in a ``torch.profiler`` window over ``reps`` runs of
    ``fn()``.  The profiler now and then drops a window's events: a window
    with no device time, or with fewer than ``least`` device events per run,
    is tried again, up to PROFILER_WINDOWS windows, then the phase fails."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(PROFILER_WINDOWS):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        rows = [(e.key, e.count, e.self_device_time_total) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if rows and sum(c for _, c, _ in rows) >= least * reps:
            return rows
    raise AssertionError(f"the profiler recorded no device time, or fewer than {least} "
                         f"device events per run, in {PROFILER_WINDOWS} windows")


def device_cost(torch, fn, reps, calls=1, launches=0):
    """(device ms, device kernels + memsets + copies) per wrapper call of
    ``fn()``, which makes ``calls`` calls of ``launches`` device launches
    each (0: not known): every device event's self time, summed.  Unlike
    ``cuda_ms`` this leaves out the host's enqueue time."""
    rows = device_rows(torch, fn, reps, launches * calls)
    n = reps * calls
    return sum(t for _, _, t in rows) / 1e3 / n, sum(c for _, c, _ in rows) / n


def timed(torch, fn, plain, launches, reps=KERNEL_REPS, calls=1, split=()):
    """A kernel row's times: host-inclusive ``ms`` (CUDA events), the
    profiler's ``device_ms`` and device launches per call, and the plain
    version's ms; for each name in ``split``, ``<name>_device_ms``: the
    device time per call of the kernels whose name holds it, from the same
    profiler window.  Each wrapper call must make exactly ``launches``
    device launches (kernels, memsets and copies): fewer is a window that
    lost events (tried again), more fails."""
    rows = device_rows(torch, fn, reps, launches * calls)
    n = reps * calls
    per_call = sum(c for _, c, _ in rows) / n
    if per_call > launches:
        raise AssertionError(f"{per_call} device launches per call, more than {launches}")
    out = {"ms": cuda_ms(torch, fn, reps) / calls,
           "device_ms": sum(t for _, _, t in rows) / 1e3 / n,
           "device_launches_per_call": per_call}
    for name in split:
        out[f"{name}_device_ms"] = sum(t for k, _, t in rows if name in k) / 1e3 / n
        if out[f"{name}_device_ms"] == 0:
            raise AssertionError(f"no device time under a kernel named {name}")
    out["plain_ms"] = cuda_ms(torch, plain, PLAIN_REPS) / calls
    return out


def check_round_counts(torch, name, kern, plain, large):
    """``kern(k)`` equals ``plain(k)`` at k = 1, 2, one short of the rounds
    the field needs, those rounds and ``large``.  The rounds needed are the
    least count whose result equals the one at ``large`` (monotone in the
    count, so bisect).  Returns (rounds needed, max |err|)."""
    full = kern(large)
    lo, hi = 1, large
    while lo < hi:
        mid = (lo + hi) // 2
        if torch.equal(kern(mid), full):
            hi = mid
        else:
            lo = mid + 1
    err = 0.0
    for k in sorted({1, 2, max(lo - 1, 1), lo, large}):
        got, want = kern(k), plain(k)
        torch.cuda.synchronize()
        require_equal(f"{name} at {k} rounds", got, want)
        err = max(err, max_abs(got, want))
    short = kern(max(lo - 1, 1))
    log(f"{name}: exact at 1, 2, {max(lo - 1, 1)}, {lo} and {large} rounds; converges in "
        f"{lo}; at {max(lo - 1, 1)} rounds "
        f"{'stops before convergence' if not torch.equal(short, full) else 'is converged'}")
    return lo, err


def require_equal(name, got, want):
    """Same shape, dtype and values (storage volumes compared in float32,
    which holds each of their values exactly)."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise AssertionError(f"{name}: {got.shape}/{got.dtype} vs {want.shape}/{want.dtype}")
    if not bool((got.float() == want.float()).all()):
        n = int((got.float() != want.float()).sum())
        raise AssertionError(f"{name}: {n} elements differ")


def max_abs(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def compare_outputs(got, want, label):
    """A card frame's outputs against the CPU run's."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: output keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        g, w = got[k], want[k]
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {k}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        if k == "pointcloud_rgb":
            ok = np.array_equal(g.view(np.int32), w.view(np.int32))
        elif k == "pointcloud_xyz":
            ok = (np.array_equal(np.isnan(g), np.isnan(w))
                  and np.allclose(g, w, rtol=1e-5, atol=0, equal_nan=True))
        else:
            ok = np.array_equal(g, w)
        if not ok:
            raise AssertionError(f"{label} {k}: card and CPU runs differ")
    d = got["disparity"]
    if d.shape != (H, W) or not np.isfinite(d).all() or not got["disparity_valid"].any():
        raise AssertionError(f"{label}: bad disparity")
    xyz_bitwise = np.array_equal(got["pointcloud_xyz"].view(np.int32),
                                 want["pointcloud_xyz"].view(np.int32))
    log(f"{label}: every output matches the CPU run (xyz bitwise: {xyz_bitwise}); "
        f"valid {float(got['disparity_valid'].mean()):.4f}")


def drive(torch, _build, pipe, frames, outputs, per_frame, keep, encoding="mono8"):
    """The main path: every count set to 0 just before, read just after.
    Each frame must launch each kernel of ``per_frame`` exactly that many
    times (at least once where the count is None).  Returns (per-frame ms,
    fetched outputs of the first ``keep`` frames, launches over the run)."""
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    per_frame_ms, kept = [], []
    for i, (left, right) in enumerate(frames):
        before = {k: kern.launches for k, (kern, _) in per_frame.items()}
        res, ms = pipe.timed_process(left, right, outputs, encoding)
        for k, (kern, n) in per_frame.items():
            done = kern.launches - before[k]
            if (done < 1) if n is None else (done != n):
                raise AssertionError(f"frame {i}: {k} launched {done} times, "
                                     f"not {'at least 1' if n is None else n}")
        per_frame_ms.append(ms)
        if i < keep:
            kept.append(res.fetch())
    return per_frame_ms, kept, {k: kern.launches for k, (kern, _) in per_frame.items()}


def summary(label, per_frame_ms, pipelined_ms=None):
    steady = per_frame_ms[1:]
    median = statistics.median(steady)
    p75 = float(np.percentile(steady, 75))
    log(f"{label} per-frame ms (frame 0 warm-up excluded): {[round(x, 3) for x in steady]}")
    log(f"{label} e2e over {len(steady)} frames: median {median:.3f} ms/frame "
        f"({1e3 / median:.1f} fps), p75 {p75:.3f} ms, "
        + (f"pipelined {pipelined_ms:.3f} ms/frame, " if pipelined_ms is not None else "")
        + f"first frame {per_frame_ms[0]:.3f} ms")
    line = {"path": label, "e2e_frames": len(steady), "e2e_median_ms": median,
            "e2e_p75_ms": p75, "e2e_first_frame_ms": per_frame_ms[0]}
    if pipelined_ms is not None:
        line["e2e_pipelined_ms"] = pipelined_ms
    return line


def pipelined(torch, pipe, frames, outputs):
    """Host ms per frame with frames enqueued back to back."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for left, right in frames:
        last = pipe.process(left, right, outputs)
    last.block_until_ready()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / len(frames)


def profile_frames(torch, timing, pipe, frames, outputs, log_dir, label, top=15):
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
        log(f"profile {label}: the profiler recorded no device time (not measured)")
        return
    busy_ms = sum(r[2] for r in rows)
    n = len(frames)
    log(f"profile {label} over {n} frames: wall {wall_ms / n:.3f} ms/frame, device busy "
        f"{busy_ms / n:.3f} ms/frame ({100 * busy_ms / wall_ms:.1f} %), "
        f"{sum(r[1] for r in rows) / n:.0f} kernels and copies/frame")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:top]:
        log(f"  {ms / n:8.4f} ms/frame  {count / n:6.1f}/frame  {key[:90]}")


def k5_calls(down, lr):
    """The SGM frame's three K5 calls as (name, exc_in, vertical, reverse),
    given K4's down excess and the left→right call's output."""
    return (("up+down", down, True, True), ("left-right", None, False, False),
            ("right-left+left-right", lr, False, True))


def check_sgm_kernels(torch, sgm_kernel, stereobm, rl, rect, cfg, p1, p2):
    """K4, K5 (the frame's three calls) and K6 against their plain versions
    on the card, exact; then their times and bounds (``rl``: the port's
    utils/roofline.py)."""
    lf = stereobm.prefilter(rect[0], cfg)
    rf = stereobm.prefilter(rect[1], cfg)
    cdt, edt = sgm_kernel.storage_dtypes(cfg, p1, p2, True)
    cost, down = sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, cdt, edt)
    cost_p, down_p = sgm_kernel.cost_and_down_plain(lf, rf, cfg, p1, p2, cdt, edt)
    torch.cuda.synchronize()
    require_equal("K4 cost", cost, cost_p)
    require_equal("K4 exc_down", down, down_p)
    err = {"K4": max(max_abs(cost, cost_p), max_abs(down, down_p)), "K5": 0.0, "K6": 0.0}

    def aggregate(name, exc_in, vertical, reverse):
        args = (cost, exc_in, p1, p2, vertical, reverse, edt)
        got = sgm_kernel.aggregate(*args)
        want = sgm_kernel.aggregate_plain(*args)
        torch.cuda.synchronize()
        require_equal(f"K5 {name}", got, want)
        err["K5"] = max(err["K5"], max_abs(got, want))
        return got

    ev = aggregate("up + down", down, True, True)
    lr = aggregate("left-right", None, False, False)
    eh = aggregate("right-left + left-right", lr, False, True)
    for c in (cfg, cfg.replace(refine_disparity=True, uniqueness_ratio=10)):
        got = sgm_kernel.wta(cost, ev, eh, c)
        want = sgm_kernel.wta_plain(cost, ev, eh, c)
        torch.cuda.synchronize()
        for a, b, nm in zip(got, want, ("disp_raw", "best_cost", "excl")):
            require_equal(f"K6 {nm} refine={c.refine_disparity}", a, b)
            err["K6"] = max(err["K6"], max_abs(a, b))

    def k5(fn):
        def run():
            ev = fn(cost, down, p1, p2, True, True, edt)
            lr = fn(cost, None, p1, p2, False, False, edt)
            return ev, fn(cost, lr, p1, p2, False, True, edt)
        return run

    # per call; K5's is the mean of the frame's 3 calls
    work = rl.sgm_fused_model(H, W, cfg.num_disparities, cost.element_size(),
                              down.element_size())
    times = {
        "K4": timed(torch, lambda: sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, cdt, edt),
                    lambda: sgm_kernel.cost_and_down_plain(lf, rf, cfg, p1, p2, cdt, edt), 2,
                    split=("sgm_cost", "sgm_walk")),
        "K5": timed(torch, k5(sgm_kernel.aggregate), k5(sgm_kernel.aggregate_plain), 1,
                    calls=3),
        "K6": timed(torch, lambda: sgm_kernel.wta(cost, ev, eh, cfg),
                    lambda: sgm_kernel.wta_plain(cost, ev, eh, cfg), 1),
    }
    # each walk's device time and time per step (one pixel of its lines)
    times["K4"]["down_walk_step_ns"] = times["K4"]["sgm_walk_device_ms"] * 1e6 / H
    times["K5"]["calls"] = {}
    for name, exc_in, vertical, reverse in k5_calls(down, lr):
        args = (cost, exc_in, p1, p2, vertical, reverse, edt)
        ms, _ = device_cost(torch, lambda: sgm_kernel.aggregate(*args), KERNEL_REPS,
                            launches=1)
        times["K5"]["calls"][name] = {"device_ms": ms,
                                      "step_ns": ms * 1e6 / (H if vertical else W)}
    out = {}
    for k in ("K4", "K5", "K6"):
        b_ms, by = rl.bound(work[k]["bytes"], work[k]["ops"])
        out[k] = {"max_abs_err": err[k], **times[k], "bound_ms": b_ms, "bound_by": by,
                  "library_ms": None}
    return out


def check_k7(torch, speckle, speckle_kernel, frontend, rl, mesh, disp, valid, sp_cfg):
    """K7 and the band label rounds on band 1 of the mesh's split of one BM
    frame, against their plain versions on the card, exact at several round
    counts (up to 4·H_b for K7, 64 for the label rounds); then their times
    and bounds.  Each call must make at most 2 device launches (the walk and
    the memset of its flags)."""
    bands = frontend.speckle_size_fields(
        mesh.split(disp), mesh.split(valid), mesh,
        max_speckle_size=sp_cfg.max_speckle_size, max_diff=sp_cfg.max_diff)
    field, cx, cy = bands[1]
    hb, w = field.shape
    iters = 4 * hb
    rounds, err = check_round_counts(
        torch, f"K7 band 1 of {mesh.size} ({hb}x{w})",
        lambda k: speckle_kernel.max_propagate(field, cx, cy, k),
        lambda k: speckle._max_propagate(field, cx, cy, k), iters)
    log(f"K7: {int((speckle_kernel.max_propagate(field, cx, cy, iters) != field).sum())} "
        f"pixels raised")

    # the band label rounds from the band's raster labels
    pix = (hb * w + torch.arange(hb * w, dtype=torch.int32, device=field.device)).reshape(hb, w)
    sentinel = torch.full((), disp.numel(), dtype=torch.int32, device=field.device)
    lab = torch.where(mesh.split(valid)[1], pix, sentinel)
    bl_rounds, bl_err = check_round_counts(
        torch, "band label rounds", lambda k: speckle_kernel.band_labels(lab, cx, cy, k),
        lambda k: speckle._label_rounds(lab, cx, cy, k), 64)

    out = {}
    for key, fn, plain, r, e in (
            ("K7", lambda: speckle_kernel.max_propagate(field, cx, cy, iters),
             lambda: speckle._max_propagate(field, cx, cy, iters), rounds, err),
            ("BL", lambda: speckle_kernel.band_labels(lab, cx, cy, 2),
             lambda: speckle._label_rounds(lab, cx, cy, 2), 2, bl_err)):
        m = rl.maxprop_model(hb, w, r)
        b_ms, by = rl.bound(m["bytes"], m["ops"])
        out[key] = {"max_abs_err": e, **timed(torch, fn, plain, 2),
                    "bound_ms": b_ms, "bound_by": by, "library_ms": None}
    out["K7"]["rounds_to_converge"] = rounds
    out["BL"]["rounds_to_converge"] = bl_rounds
    return out


def planar_model(calib, fx=441.0, baseline=0.11):
    """The camera of the port's planar synthetic sequence (utils/synth.py):
    pinhole, no distortion, the principal point at the image centre."""
    K = np.array([[fx, 0, W / 2], [0, fx, H / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -fx * baseline

    def mk(PP, name):
        return calib.CameraCalib(W, H, K, np.zeros(5), np.eye(3), PP, name)

    return calib.StereoCameraModel.from_calibs(mk(P, "left"), mk(Pr, "right"))


def start_rendering(synth):
    """Render the SLAM sequence on a thread (numpy; it overlaps the kernel
    build).  Returns a function that waits for it and returns ([(left,
    right, stamp)], ground truth)."""
    import threading

    out = {}

    def run():
        try:
            lefts, rights, gt = synth.render_planar(SLAM_FRAMES, W, H, 441.0, 0.11, 3.0,
                                                    10.0, 0)
            out["frames"] = (list(zip(lefts, rights, gt.stamps)), gt)
        except BaseException as e:       # re-raised by the waiter
            out["error"] = e

    th = threading.Thread(target=run, name="render-slam-frames")
    th.start()

    def wait():
        th.join()
        if "error" in out:
            raise out["error"]
        return out["frames"]

    return wait


def slam_steps(torch, slam, frames):
    """``slam.step`` over ``frames``; per frame its info and its keypoints
    on the host."""
    recs = []
    for left, right, stamp in frames:
        info = slam.step(left, right, stamp)
        kp = slam.vo.state.prev.kp
        recs.append({"info": info, **{f: getattr(kp, f).cpu() for f in kp._fields}})
    return recs


def same_slam_frame(torch, features, got, want, label, keypoints=True):
    """One SLAM frame of the card against the CPU run's: flags and match
    counts exact, poses within SLAM_POSE_ATOL; keypoints exact, descriptors
    exact where the steering bins agree (≤ 1 % of keypoints may differ)."""
    g, w = got["info"], want["info"]
    for f in SLAM_FLAGS:
        if g[f] != w[f]:
            raise AssertionError(f"{label}: {f} {g[f]} on the card, {w[f]} on the CPU")
    for f in ("R_wc", "t_wc"):
        d = float(np.abs(g[f] - w[f]).max())
        if d > SLAM_POSE_ATOL:
            raise AssertionError(f"{label}: {f} differs by {d} (> {SLAM_POSE_ATOL})")
    if not keypoints:
        return
    for f in ("xy", "score", "valid"):
        if not torch.equal(got[f], want[f]):
            raise AssertionError(f"{label}: keypoint {f} differ")
    same = features._steering_bins(got["angle"]) == features._steering_bins(want["angle"])
    if float((~same).float().mean()) > 0.01 or not torch.equal(got["desc"][same],
                                                               want["desc"][same]):
        raise AssertionError(f"{label}: descriptors differ")


def slam_profile(torch, timing, port, model, frames, dev, log_dir):
    """Device launches and busy ms per SLAM frame: ``torch.profiler`` over
    SLAM_PROFILED synchronous steps after 10 warm frames (the next window,
    while frames last, if the profiler recorded no device time).  Returns (launches, busy ms, wall
    ms) per frame."""
    from torch.profiler import ProfilerActivity, profile

    slam = port.StereoSlam(model, device=dev)
    for left, right, stamp in frames[:10]:
        slam.step(left, right, stamp)
    for start in range(10, len(frames) - SLAM_PROFILED + 1, SLAM_PROFILED):
        window = frames[start:start + SLAM_PROFILED]
        torch.cuda.synchronize()
        ctx = (timing.trace(log_dir) if log_dir else
               profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]))
        with ctx as prof:
            t0 = time.perf_counter()
            for left, right, stamp in window:
                slam.step(left, right, stamp)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if rows:
            break
    else:
        raise AssertionError("the profiler recorded no device time in any SLAM window")
    slam.pipeline.senders.shutdown()
    n = len(window)
    busy = sum(r[2] for r in rows)
    log(f"profile slam over {n} frames: wall {wall_ms / n:.3f} ms/frame, device busy "
        f"{busy / n:.3f} ms/frame ({100 * busy / wall_ms:.1f} %), "
        f"{sum(r[1] for r in rows) / n:.0f} kernels and copies/frame")
    for key, count, ms in sorted(rows, key=lambda r: -r[2])[:15 if log_dir else 8]:
        log(f"  {ms / n:8.4f} ms/frame  {count / n:6.1f}/frame  {key[:90]}")
    return sum(r[1] for r in rows) / n, busy / n, wall_ms / n


def run_slam(torch, port, _build, features, timing, evaluate, calib, frames, gt, dev,
             kernels, profile_dir):
    """The SLAM path: the main run (every count set to 0 just before it and
    read just after), the ATE gate, the card's first frames against the CPU
    run, the profiler window and the async-mapping run.  Returns (its JSON
    line, launches of each kernel in the main run)."""
    model = planar_model(calib)
    slams = []

    def engine(**kw):
        slams.append(port.StereoSlam(model, **kw))
        return slams[-1]

    slam = engine(device=dev)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    infos, per_frame_ms = [], []
    t0 = last = time.perf_counter()
    for info in slam.run_stream(iter(frames), depth=2):
        now = time.perf_counter()
        per_frame_ms.append((now - last) * 1e3)
        last = now
        infos.append(info)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: kern.launches for k, kern in kernels.items()}
    log(f"SLAM launches over {len(frames)} frames: {launches}")
    for k, n in launches.items():
        want = len(frames) if k in ("K1", "K2", "K3") else 0
        if n != want:
            raise AssertionError(f"SLAM: {k} launched {n} times, not {want}")
    if len(infos) != len(frames) or not all(i["tracked"] for i in infos[1:]):
        raise AssertionError(f"SLAM: frames not tracked: "
                             f"{[k for k, i in enumerate(infos) if not i['tracked']][1:]}")
    stages = slam.timer.as_dict()
    positions = np.stack(slam.traj_t)
    ate_before = evaluate.ate_rmse(slam.trajectory(), gt)
    t1 = time.perf_counter()
    closures = slam.optimize_global()
    og_ms = (time.perf_counter() - t1) * 1e3
    ate_after = evaluate.ate_rmse(slam.trajectory(), gt)
    log(f"SLAM: {len(slam.store)} keyframes, {closures} loop closures, ATE {ate_before:.5f} m "
        f"before optimize_global and {ate_after:.5f} m after")
    if not np.isfinite(ate_after) or ate_after >= ATE_GATE_M:
        raise AssertionError(f"SLAM: ATE {ate_after} m after optimize_global (gate {ATE_GATE_M})")

    # the card's first frames against the port's CPU run of them
    card = slam_steps(torch, engine(device=dev), frames[:SLAM_COMPARED])
    cpu = slam_steps(torch, engine(device="cpu"), frames[:SLAM_COMPARED])
    for i, (g, w) in enumerate(zip(card, cpu)):
        same_slam_frame(torch, features, g, w, f"SLAM frame {i}")
        same_slam_frame(torch, features, {"info": infos[i]}, w, f"SLAM stream frame {i}",
                        keypoints=False)
    log(f"SLAM: the card's first {SLAM_COMPARED} frames match the CPU run (keypoints, "
        f"match counts {[r['info']['n_matches'] for r in cpu]}, keyframes, poses)")

    launches_per_frame, busy_ms, prof_wall_ms = slam_profile(
        torch, timing, port, model, frames, dev,
        os.path.join(profile_dir, "slam") if profile_dir else None)

    # the tracking/mapping split against synchronous stepping
    sync = engine(device=dev)
    for left, right, stamp in frames[:SLAM_ASYNC]:
        sync.step(left, right, stamp)
    asyn = engine(device=dev)
    n_async = len(list(asyn.run_stream(iter(frames[:SLAM_ASYNC]), async_mapping=True)))
    d_async = float(np.linalg.norm(asyn.vo.state.t_wc - sync.vo.state.t_wc))
    if (n_async != SLAM_ASYNC or abs(len(asyn.store) - len(sync.store)) > 1
            or len(asyn.store) != asyn._kf_count or d_async >= 0.05):
        raise AssertionError(f"SLAM async mapping: {n_async} frames, {len(asyn.store)} "
                             f"keyframes against {len(sync.store)}, final pose {d_async} m apart")
    log(f"SLAM async mapping over {SLAM_ASYNC} frames: {len(asyn.store)} keyframes "
        f"(sync {len(sync.store)}), final pose {d_async:.2e} m from the synchronous run")
    for s in slams:
        s.pipeline.senders.shutdown()

    steady = per_frame_ms[1:]
    line = {
        "path": "slam", "frames": len(infos), "keyframes": len(slam.store),
        "e2e_median_ms": statistics.median(steady),
        "e2e_p75_ms": float(np.percentile(steady, 75)),
        "e2e_first_frame_ms": per_frame_ms[0],
        "e2e_wall_ms_per_frame": wall_ms / len(infos),
        "ba_ms_per_keyframe": stages["ba"]["mean_ms"], "ba_calls": stages["ba"]["count"],
        "stage_mean_ms": {k: v["mean_ms"] for k, v in stages.items()},
        "optimize_global_ms": og_ms, "loop_closures": closures,
        "ate_before_m": ate_before, "ate_after_m": ate_after,
        "device_launches_per_frame": launches_per_frame,
        "device_busy_ms_per_frame": busy_ms,
        "device_busy_share": busy_ms / prof_wall_ms,
        "profiled_wall_ms_per_frame": prof_wall_ms,
        "kernel_launches": launches,
        "async_keyframes": len(asyn.store), "sync_keyframes": len(sync.store),
        "async_final_pose_diff_m": d_async,
    }
    log(f"SLAM e2e over {len(steady)} frames: median {line['e2e_median_ms']:.3f} ms/frame, "
        f"p75 {line['e2e_p75_ms']:.3f} ms, BA {line['ba_ms_per_keyframe']:.3f} ms per keyframe")
    return line, launches, positions


def profile_steps(torch, step, n):
    """Device launches, busy ms and wall ms per step: ``torch.profiler`` over
    ``n`` synchronous calls of ``step(i)`` (up to PROFILER_WINDOWS windows
    while the profiler records no device time)."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if rows:
            busy = sum(r[2] for r in rows)
            return sum(r[1] for r in rows) / n, busy / n, wall_ms / n, rows
    raise AssertionError(f"the profiler recorded no device time in {PROFILER_WINDOWS} windows")


def check_bayer(torch, color, port, frames, dev):
    """``convert`` from each Bayer phase on the card against the CPU, exact:
    uint8 to mono8, rgb8 and bgr8, and the uint16 debayer."""
    raw = torch.from_numpy(frames[0][0])
    raw16 = (raw.to(torch.int32) * 257 + 3).to(torch.uint16)
    names = [n for n, e in color.ENCODINGS.items() if e.is_bayer]
    for name in names:
        for dst in ("mono8", "rgb8", "bgr8"):
            require_equal(f"convert {name} -> {dst}", color.convert(raw.to(dev), name, dst),
                          color.convert(raw, name, dst).to(dev))
        pattern = color.encoding(name).bayer_pattern
        require_equal(f"debayer uint16 {name}", color.debayer_bilinear(raw16.to(dev), pattern),
                      color.debayer_bilinear(raw16, pattern).to(dev))
    log(f"Bayer convert: {names} to mono8, rgb8 and bgr8, and the uint16 debayer, "
        "exact against the CPU")


DISPARITY_DERIVED = ("disparity", "disparity_vis", "pointcloud_xyz")


def compare_bilateral(got, want, label):
    """A bilateral frame of the card against the CPU run's: every output not
    derived from the disparity exact; the disparity equal on at least
    BILATERAL_EQUAL_SHARE of the pixels, and where it is equal, so are
    ``disparity_vis`` and the points.  Returns the equal share."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: output keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        if k not in DISPARITY_DERIVED:
            same = (np.array_equal(got[k].view(np.int32), want[k].view(np.int32))
                    if k == "pointcloud_rgb" else np.array_equal(got[k], want[k]))
            if not same:
                raise AssertionError(f"{label} {k}: card and CPU runs differ")
    eq = got["disparity"] == want["disparity"]
    share = float(eq.mean())
    if share < BILATERAL_EQUAL_SHARE:
        raise AssertionError(f"{label}: disparity equal on {share:.6f} of pixels "
                             f"(< {BILATERAL_EQUAL_SHARE})")
    g, w = got["pointcloud_xyz"][eq], want["pointcloud_xyz"][eq]
    if not (np.array_equal(got["disparity_vis"][eq], want["disparity_vis"][eq])
            and np.array_equal(np.isnan(g), np.isnan(w))
            and np.allclose(g, w, rtol=1e-5, atol=0, equal_nan=True)):
        raise AssertionError(f"{label}: disparity_vis or points differ where disparity agrees")
    log(f"{label}: disparity equal on {share:.6f} of pixels "
        f"({int((~eq).sum())} differ); every other output matches the CPU run")
    return share


def run_bayer(torch, _build, new_pipe, frames, outputs, bm_kernels, dev):
    """BM defaults on ``bayer_grbg8`` frames (the synthetic pairs' planes
    taken as the mosaic), ``Outputs.all()``: BAYER_FRAMES frames, each
    launching K1 twice, K2 and K3 once; the first BAYER_COMPARED against the
    CPU run; a profiler window over 3 frames.  Returns (its JSON line,
    launches)."""
    enc = "bayer_grbg8"
    gpipe, cpipe = new_pipe(device=dev), new_pipe(device="cpu")
    bframes = frames[:BAYER_FRAMES]
    ms, got, launches = drive(torch, _build, gpipe, bframes, outputs, bm_kernels,
                              BAYER_COMPARED, encoding=enc)
    for i in range(BAYER_COMPARED):
        compare_outputs(got[i], cpipe.process(*bframes[i], outputs, encoding=enc).fetch(),
                        f"Bayer frame {i}")
    n = min(3, len(bframes) - 1)
    n_launch, busy, wall, _ = profile_steps(
        torch, lambda i: gpipe.process(*bframes[1 + i], outputs, enc).block_until_ready(), n)
    log(f"profile bayer over {n} frames: wall {wall:.3f} ms/frame, device busy {busy:.3f} "
        f"ms/frame ({100 * busy / wall:.1f} %), {n_launch:.0f} kernels and copies/frame")
    return {**summary("bayer", ms), "device_launches_per_frame": n_launch,
            "device_busy_ms_per_frame": busy, "device_busy_share": busy / wall,
            "profiled_wall_ms_per_frame": wall}, launches


def run_bilateral(torch, _build, port, new_pipe, frames, outputs, bm_kernels, bm_frame0,
                  iters, dev):
    """BM defaults with the bilateral filter on (ndisp 64, radius 3,
    ``iters``): BILATERAL_FRAMES frames (K1 twice, K2 and K3 once each), the
    first BILATERAL_COMPARED against the CPU run (compare_bilateral), and a
    profiler window.  ``bm_frame0``: frame 0's outputs with the filter off.
    Returns (its JSON line, launches)."""
    cfg = port.PipelineConfig(bilateral=port.BilateralConfig(
        enabled=True, ndisp=64, radius=3, iters=iters))
    gpipe, cpipe = new_pipe(config=cfg, device=dev), new_pipe(config=cfg, device="cpu")
    label = f"bilateral iters {iters}"
    bl_frames = frames[:BILATERAL_FRAMES]
    ms, got, launches = drive(torch, _build, gpipe, bl_frames, outputs, bm_kernels,
                              BILATERAL_COMPARED)
    shares = [compare_bilateral(got[i], cpipe.process(*bl_frames[i], outputs).fetch(),
                                f"{label} frame {i}") for i in range(BILATERAL_COMPARED)]
    changed = float((got[0]["disparity"] != bm_frame0["disparity"]).mean())
    n_launch, busy, wall, rows = profile_steps(
        torch, lambda i: gpipe.process(*bl_frames[1 + i], outputs).block_until_ready(),
        BILATERAL_PROFILED)
    log(f"profile {label} over {BILATERAL_PROFILED} frames: wall {wall:.3f} ms/frame, "
        f"device busy {busy:.3f} ms/frame ({100 * busy / wall:.1f} %), "
        f"{n_launch:.0f} kernels and copies/frame; the filter changed {changed:.4f} of "
        f"frame 0's pixels")
    for key, count, dms in sorted(rows, key=lambda r: -r[2])[:8]:
        log(f"  {dms / BILATERAL_PROFILED:8.4f} ms/frame  "
            f"{count / BILATERAL_PROFILED:6.1f}/frame  {key[:90]}")
    return {**summary(f"bilateral_iters{iters}", ms),
            "disparity_equal_share_min": min(shares), "changed_share_frame0": changed,
            "device_launches_per_frame": n_launch, "device_busy_ms_per_frame": busy,
            "device_busy_share": busy / wall, "profiled_wall_ms_per_frame": wall}, launches


def run_bilateral_mesh(torch, _build, port, new_pipe, make_mesh, frames, outputs,
                       bm_kernels, dev):
    """The bilateral filter by row band: ``BANDS`` bands on one card against
    one device on the card, speckle off (the band speckle filter is its own
    approximation), exact, on 2 frames (K1 and K2 per band, K3 never).
    Returns launches."""
    cfg = port.PipelineConfig(speckle=port.SpeckleConfig(max_speckle_size=0),
                              bilateral=port.BilateralConfig(enabled=True))
    gpipe = new_pipe(config=cfg, mesh=make_mesh(BANDS, devices=[dev] * BANDS))
    one = new_pipe(config=cfg, device=dev)
    per_frame = {"K1": (bm_kernels["K1"][0], 2 * BANDS),
                 "K2": (bm_kernels["K2"][0], BANDS), "K3": (bm_kernels["K3"][0], 0)}
    _, got, launches = drive(torch, _build, gpipe, frames[:2], outputs, per_frame, 2)
    for i in range(2):
        compare_outputs(got[i], one.process(*frames[i], outputs).fetch(),
                        f"bilateral mesh frame {i}, speckle off, against one device")
    return launches


def run_slab(torch, _build, port, new_pipe, make_mesh, frames, outputs, kern, dev):
    """Disparity slabs (``shard_mode="disp"``) for each (disparities, slabs)
    of SLABS over ``make_mesh(slabs, devices=[dev] * slabs)``, BM defaults
    otherwise: SLAB_FRAMES frames (K1 twice per band, K7 once per band, the
    band label rounds, never K2 or K3), the first SLAB_COMPARED against the
    CPU slab run of the same mesh, frame 0 with speckle off against the
    single-device K2 pipeline on the card (every output exact), and a
    profiler window.  Returns (JSON lines, launches by label)."""
    lines, launches = [], {}
    sframes = frames[:SLAB_FRAMES]
    for nd, n in SLABS:
        label = f"slab {nd}/{n}"
        cfg = port.PipelineConfig(stereobm=port.StereoBMConfig(num_disparities=nd))
        gpipe = new_pipe(config=cfg, mesh=make_mesh(n, devices=[dev] * n), shard_mode="disp")
        cpipe = new_pipe(config=cfg, mesh=make_mesh(n, devices=["cpu"] * n), shard_mode="disp")
        per_frame = {"K1": (kern["K1"], 2 * n), "K2": (kern["K2"], 0), "K3": (kern["K3"], 0),
                     "K7": (kern["K7"], n), "BL": (kern["BL"], None)}
        ms, got, launches[label] = drive(torch, _build, gpipe, sframes, outputs, per_frame,
                                         SLAB_COMPARED)
        log(f"{label} launches over {len(sframes)} frames: {launches[label]}")
        for i in range(SLAB_COMPARED):
            compare_outputs(got[i], cpipe.process(*sframes[i], outputs).fetch(),
                            f"{label} frame {i}")
        off = cfg.replace(speckle=port.SpeckleConfig(max_speckle_size=0))
        compare_outputs(
            new_pipe(config=off, mesh=make_mesh(n, devices=[dev] * n),
                     shard_mode="disp").process(*frames[0], outputs).fetch(),
            new_pipe(config=off, device=dev).process(*frames[0], outputs).fetch(),
            f"{label} frame 0, speckle off, against the single-device K2 pipeline")
        n_prof = min(3, len(sframes) - 1)
        n_launch, busy, wall, rows = profile_steps(
            torch, lambda i: gpipe.process(*sframes[1 + i], outputs).block_until_ready(),
            n_prof)
        log(f"profile {label} over {n_prof} frames: wall {wall:.3f} ms/frame, device busy "
            f"{busy:.3f} ms/frame ({100 * busy / wall:.1f} %), {n_launch:.0f} kernels and "
            f"copies/frame")
        for key, count, dms in sorted(rows, key=lambda r: -r[2])[:8]:
            log(f"  {dms / n_prof:8.4f} ms/frame  {count / n_prof:6.1f}/frame  {key[:90]}")
        lines.append({**summary(f"slab_{nd}_{n}", ms), "device_launches_per_frame": n_launch,
                      "device_busy_ms_per_frame": busy, "device_busy_share": busy / wall,
                      "profiled_wall_ms_per_frame": wall})
    return lines, launches


def run_slam_meshes(torch, port, _build, evaluate, calib, make_mesh, frames, gt, dev,
                    kernels, one_traj):
    """The SLAM cell on a ``("kf",)`` mesh of 2 entries of ``dev`` (the BA
    landmark-sharded, the pipeline on one device: K1, K2, K3 once a frame)
    and on a (kf, rows) 2 × 4 mesh (the pipeline by 4 row bands: K1, K2 and
    K7 four times a frame, the band label rounds, no K3): ``run_stream(depth=2)``
    over every frame, counts set to 0 just before and read just after; the
    ATE gate after ``optimize_global``, and each frame's position within
    SLAM_MESH_POSE_ATOL of the single-device run's (``one_traj``).  Returns
    (JSON lines, launches by label)."""
    model = planar_model(calib)
    n = len(frames)
    lines, launches = [], {}
    for label, mesh, want in (
            ("slam kf", make_mesh(2, ("kf",), devices=[dev] * 2),
             {"K1": n, "K2": n, "K3": n, "K7": 0, "BL": 0}),
            ("slam kf rows", make_mesh(8, ("kf", "rows"), shape=(2, BANDS),
                                       devices=[dev] * 2 * BANDS),
             {"K1": BANDS * n, "K2": BANDS * n, "K3": 0, "K7": BANDS * n, "BL": None})):
        slam = port.StereoSlam(model, mesh=mesh)
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        per_frame_ms, infos = [], []
        last = time.perf_counter()
        for info in slam.run_stream(iter(frames), depth=2):
            now = time.perf_counter()
            per_frame_ms.append((now - last) * 1e3)
            last = now
            infos.append(info)
        torch.cuda.synchronize()
        launches[label] = {k: kernels[k].launches for k in want}
        log(f"{label} launches over {n} frames: {launches[label]}")
        for k, w in want.items():
            got = launches[label][k]
            if (got < n) if w is None else (got != w):
                raise AssertionError(f"{label}: {k} launched {got} times, not "
                                     f"{'at least once a frame' if w is None else w}")
        if len(infos) != n or not all(i["tracked"] for i in infos[1:]):
            raise AssertionError(f"{label}: frames not tracked")
        traj = np.stack(slam.traj_t)
        pose_diff = float(np.abs(traj - one_traj).max())
        stages = slam.timer.as_dict()
        closures = slam.optimize_global()
        ate = evaluate.ate_rmse(slam.trajectory(), gt)
        log(f"{label}: {len(slam.store)} keyframes, {closures} loop closures, ATE {ate:.5f} m "
            f"after optimize_global, positions within {pose_diff:.3e} m of the single-device "
            f"run, BA {stages['ba']['mean_ms']:.3f} ms per keyframe")
        if not np.isfinite(ate) or ate >= ATE_GATE_M:
            raise AssertionError(f"{label}: ATE {ate} m (gate {ATE_GATE_M})")
        if pose_diff > SLAM_MESH_POSE_ATOL:
            raise AssertionError(f"{label}: positions {pose_diff} m from the single-device "
                                 f"run (> {SLAM_MESH_POSE_ATOL})")
        slam.pipeline.senders.shutdown()
        steady = per_frame_ms[1:]
        lines.append({
            "path": label.replace(" ", "_"), "frames": n, "keyframes": len(slam.store),
            "e2e_median_ms": statistics.median(steady),
            "e2e_p75_ms": float(np.percentile(steady, 75)),
            "ba_ms_per_keyframe": stages["ba"]["mean_ms"], "ba_calls": stages["ba"]["count"],
            "ate_after_m": ate, "loop_closures": closures,
            "max_position_diff_vs_one_device_m": pose_diff, "kernel_launches": launches[label]})
    return lines, launches


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_multihost(torch, multihost, make_mesh, dev):
    """The multi-process worker at 752×480, BM defaults (64 disparities,
    block 15, texture 10, speckle 800 / Δ5): 2 processes × 2 bands, both on
    ``dev``, over gloo (NCCL refuses two ranks on one card); every process
    stopped before this returns.  Gates: DENSE and PIPE equal across the
    ranks and to the same checks on a one-process 4-entry mesh on ``dev``,
    BA equal across the ranks and within rtol 1e-3 of one process, and each
    rank's launches (its LAUNCHES line, counted from 0 over its run) of K1,
    K2, K7 and the band label rounds at least 1, of K3 none.  Returns (its
    JSON line, launches summed over the ranks)."""
    shape = dict(rows=H, width=W, ndisp=64, block=15, texture=10, speckle_size=800,
                 speckle_diff=5.0, fps_iters=MULTIHOST_FPS_ITERS)
    cmd = [sys.executable, "-m", "ros_gpu_stereo_processor_tpu_torch.parallel.multihost",
           "--init-method", f"tcp://127.0.0.1:{_free_port()}", "--world-size", "2",
           "--backend", "gloo", "--bands-per-process", "2", "--device", str(dev),
           "--timeout", "120", "--rows", str(H), "--width", str(W), "--ndisp", "64",
           "--block", "15", "--texture-threshold", "10", "--speckle-size", "800",
           "--speckle-diff", "5", "--fps-iters", str(MULTIHOST_FPS_ITERS)]
    root = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=root + os.pathsep + os.environ.get("PYTHONPATH", ""))
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd + ["--rank", str(r)], cwd=root, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=MULTIHOST_TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    wall_s = time.perf_counter() - t0
    for r, (p, out) in enumerate(zip(procs, outs)):
        log(f"multihost rank {r} (exit {p.returncode}):\n" + "\n".join(
            "  " + ln for ln in out.strip().splitlines()[-12:]))
        if p.returncode != 0:
            raise AssertionError(f"multihost rank {r} exited {p.returncode}")
    ref = list(multihost.worker_lines(make_mesh(BANDS, devices=[dev] * BANDS),
                                      make_mesh(BANDS, ("kf",), devices=[dev] * BANDS),
                                      **{**shape, "fps_iters": 1}))

    def tagged(text, tag):
        found = [ln for ln in text.splitlines() if ln.startswith(tag + " ")]
        if len(found) != 1:
            raise AssertionError(f"multihost: {len(found)} {tag} lines")
        return found[0]

    one = "\n".join(ref)
    for tag in ("BACKEND", "DENSE", "PIPE", "BA"):
        if tagged(outs[0], tag) != tagged(outs[1], tag):
            raise AssertionError(f"multihost: {tag} differs between the ranks")
    for tag in ("DENSE", "PIPE"):
        if tagged(outs[0], tag) != tagged(one, tag):
            raise AssertionError(f"multihost: {tag} {tagged(outs[0], tag)} against one "
                                 f"process's {tagged(one, tag)}")
    ba = [float(x) for x in tagged(outs[0], "BA").split()[1:]]
    ba_one = [float(x) for x in tagged(one, "BA").split()[1:]]
    if not np.allclose(ba, ba_one, rtol=1e-3, atol=0) or not ba[1] < 0.1 * ba[0]:
        raise AssertionError(f"multihost: BA {ba} against one process's {ba_one}")
    ranks = [json.loads(tagged(o, "LAUNCHES").split(" ", 1)[1]) for o in outs]
    launches = {}
    for k in ("K1", "K2", "K3", "K7", "BL"):
        per_rank = [c[SOURCES[k][0]] for c in ranks]
        if (k == "K3" and any(per_rank)) or (k != "K3" and min(per_rank) < 1):
            raise AssertionError(f"multihost: {k} launched {per_rank} times by the ranks")
        launches[k] = sum(per_rank)
    fps = [float(tagged(o, "FPS").split()[1]) for o in outs]
    log(f"multihost: {tagged(outs[0], 'BACKEND')}; DENSE and PIPE equal across the 2 ranks "
        f"and to one process ({tagged(one, 'DENSE')}); BA {ba} (one process {ba_one}); "
        f"fps per rank {fps}; launches over both ranks {launches}")
    return {"path": "multihost_2proc_gloo", "backend": tagged(outs[0], "BACKEND").split()[1],
            "dense": tagged(outs[0], "DENSE"), "pipe": tagged(outs[0], "PIPE"),
            "ba_rms": ba, "fps_per_rank": fps, "fps_iters": MULTIHOST_FPS_ITERS,
            "wall_s": wall_s, "kernel_launches": launches}, launches


def run_scaling(torch, port, _build, kernels, dev):
    """``measure_scaling`` on 1, 2 and 4 entries of ``dev`` (row bands with
    the speckle filter, and slabs; one device unsharded beside them), then
    ``dryrun_multichip(4, [dev] * 4)``; counts set to 0 before each and read
    after.  Entries on one card add no hardware, so ``efficiency`` means
    nothing here and ``wall_overhead_vs_1dev`` is the number to read.
    Returns (JSON lines, launches by label)."""
    lines, launches = [], {}
    for mode, speckle in (("rows", 800), ("disp", 0)):
        label = f"scaling {mode}"
        torch.cuda.synchronize()
        _build.reset_launch_counts()
        out = port.measure_scaling(devices=[dev] * BANDS, device_counts=[1, 2, BANDS],
                                   mode=mode, max_speckle_size=speckle,
                                   include_unsharded=True)
        launches[label] = {k: kern.launches for k, kern in kernels.items()}
        need = ("K2",) if mode == "rows" else ()
        for k in need + (("K7", "BL") if speckle else ()):
            if launches[label][k] < 1:
                raise AssertionError(f"{label}: {k} never launched")
        log(f"{label}: " + json.dumps(out))
        lines.append({"path": label.replace(" ", "_"), **out})
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    dry = port.dryrun_multichip(BANDS, devices=[dev] * BANDS)
    launches["dryrun"] = {k: kern.launches for k, kern in kernels.items()}
    for k in ("K1", "K2", "K4", "K5", "K6", "K7", "BL"):
        if launches["dryrun"][k] < 1:
            raise AssertionError(f"dryrun: {k} never launched")
    lines.append({"path": "dryrun_multichip", **dry, "kernel_launches": launches["dryrun"]})
    return lines, launches


def calib_yaml(path, c):
    """Write one camera's calibration in the camera_calibration_parsers
    layout (what a camera node drops as camera_info_*.yaml)."""
    def block(name, a, rows, cols):
        data = ", ".join(repr(float(v)) for v in np.asarray(a).reshape(-1))
        return f"{name}:\n  rows: {rows}\n  cols: {cols}\n  data: [{data}]\n"

    with open(path, "w") as f:
        f.write(f"image_width: {c.width}\nimage_height: {c.height}\ncamera_name: {c.name}\n"
                + block("camera_matrix", c.K, 3, 3)
                + f"distortion_model: {c.distortion_model}\n"
                + block("distortion_coefficients", c.D, 1, c.D.size)
                + block("rectification_matrix", c.R, 3, 3)
                + block("projection_matrix", c.P, 3, 4))


def drop_png(path, img, io):
    """Write a PNG with the port's own encoder, renamed into place whole."""
    tmp = os.path.join(os.path.dirname(path), "." + os.path.basename(path))
    with open(tmp, "wb") as f:
        f.write(io.png_encode(img))
    os.replace(tmp, path)


def run_serve(torch, port, _build, io, calib, kernels, frames, model, work, dev):
    """The serve path: a ``ServeDaemon`` on the card watching ``work/watch``
    with no calibration; the camera_info files drop after start, then the
    pairs one at a time as PNGs (the port's encoder), a reconfigure.json
    before frame SERVE_RECONF_AT.  Every count set to 0 just before the
    frames and read just after.  Gates: every frame served, the ring native,
    frames SERVE_CHECKED equal to the port's CPU pipeline under the config in
    force.  Returns (its JSON line, launches, the served disparities)."""
    from ros_gpu_stereo_processor_tpu_torch.runtime import native_available
    from ros_gpu_stereo_processor_tpu_torch.runtime.serve import ServeDaemon

    watch, out = os.path.join(work, "watch"), os.path.join(work, "served")
    for side in ("left", "right"):
        os.makedirs(os.path.join(watch, side))
    outputs = port.Outputs.of("disparity", "disparity_vis")
    daemon = ServeDaemon(watch, out, outputs, device=dev)
    daemon.poll_once()
    if daemon.pipe is not None:
        raise AssertionError("serve: a model before any camera info")
    yamls = [os.path.join(watch, f) for f in ("camera_info_left.yaml", "camera_info_right.yaml")]
    calib_yaml(yamls[0], model.left.calib)
    calib_yaml(yamls[1], model.right.calib)
    daemon.poll_once()
    if daemon.pipe is None:
        raise AssertionError("serve: the camera-info drops did not initialise the model")

    def serve_until(n, deadline):
        while daemon.n_frames < n:
            daemon.poll_once()
            if time.perf_counter() > deadline:
                raise AssertionError(f"serve: {daemon.n_frames} frames served, not {n}")

    torch.cuda.synchronize()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for i, (left, right) in enumerate(frames[:SERVE_FRAMES]):
        if i == SERVE_RECONF_AT:
            daemon.drain()
            with open(os.path.join(watch, "reconfigure.json"), "w") as f:
                json.dump({"disparity_range": SERVE_RANGE}, f)
        for side, img in (("left", left), ("right", right)):
            drop_png(os.path.join(watch, side, f"{1.0 + 0.05 * i:.6f}.png"), img, io)
        serve_until(i + 1, time.perf_counter() + 60)
    daemon.drain()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    launches = {k: kern.launches for k, kern in kernels.items()}
    log(f"serve launches over {SERVE_FRAMES} frames: {launches}")
    for k, n in launches.items():
        if n != (SERVE_FRAMES if k in ("K1", "K2", "K3") else 0):
            raise AssertionError(f"serve: {k} launched {n} times")
    native = daemon.ingest.ring._lib is not None and native_available()
    if not native:
        raise AssertionError("serve: the ingest ring is not the native one")
    if daemon.pipe.config.stereobm.num_disparities != SERVE_RANGE:
        raise AssertionError("serve: reconfigure.json not applied")
    timing_line, timing = daemon._timing_line(), daemon.timing()
    ring = daemon.ingest.ring.stats()
    daemon.close()

    cpu = port.StereoPipeline(calib.StereoCameraModel.from_files(*yamls), device="cpu")
    served = {}
    for i in SERVE_CHECKED:
        if i == SERVE_RECONF_AT:
            cpu.reconfigure(disparity_range=SERVE_RANGE)
        want = cpu.process(*frames[i], outputs).fetch()
        stamp = 1.0 + 0.05 * i
        served[i] = np.load(os.path.join(out, f"disparity_{stamp:.6f}.npy"))
        with open(os.path.join(out, f"disparity_vis_{stamp:.6f}.png"), "rb") as f:
            vis = io.png_decode(f.read())
        if not (np.array_equal(served[i], want["disparity"])
                and np.array_equal(vis, want["disparity_vis"])):
            raise AssertionError(f"serve frame {i}: differs from the CPU pipeline")
    cpu.senders.shutdown()
    n_files = len([f for f in os.listdir(out) if f.endswith(".npy")])
    if n_files != SERVE_FRAMES:
        raise AssertionError(f"serve: {n_files} disparity files for {SERVE_FRAMES} frames")
    log(f"serve: {SERVE_FRAMES} frames served (native ring {ring}); frames {SERVE_CHECKED} "
        f"equal the CPU pipeline under the config in force; {timing_line}")
    line = {"path": "serve", "frames": SERVE_FRAMES, "native_ring": native,
            "fps": timing["fps"], "p50_dispatch_to_publish_ms": timing["p50_ms"],
            "p95_dispatch_to_publish_ms": timing["p95_ms"],
            "wall_ms_per_frame": wall_ms / SERVE_FRAMES, "kernel_launches": launches,
            "ring": ring}
    return line, launches, served


def run_cli(io, calib_yamls, frames, served0, work):
    """``python3 -m ros_gpu_stereo_processor_tpu_torch.cli`` in subprocesses:
    ``info``, then ``run --euroc`` on a CLI_FRAMES-frame EuRoC directory
    whose frame 0 is the serve phase's frame 0.  Gates: exit 0; the launch
    counts ``run`` reports (set to 0 just before its frames) are CLI_FRAMES
    for K1, K2 and K3 and 0 for every other kernel; frame 0's disparity
    equals what the daemon served for that pair.  Returns (its JSON line,
    the launches by kernel)."""
    root = os.path.join(work, "euroc")
    rows = []
    for i, (left, right) in enumerate(frames[:CLI_FRAMES]):
        ts = 1_000_000_000 + 50_000_000 * i
        for cam, img in (("cam0", left), ("cam1", right)):
            os.makedirs(os.path.join(root, "mav0", cam, "data"), exist_ok=True)
            drop_png(os.path.join(root, "mav0", cam, "data", f"{ts}.png"), img, io)
        rows.append(f"{ts},{ts}.png")
    for cam in ("cam0", "cam1"):
        with open(os.path.join(root, "mav0", cam, "data.csv"), "w") as f:
            f.write("#timestamp [ns],filename\n" + "\n".join(rows) + "\n")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    cal = ["--calib-left", calib_yamls[0], "--calib-right", calib_yamls[1]]
    out = os.path.join(work, "cli_out")
    secs = {}
    for name, args in (("info", ["info", *cal]),
                       ("run", ["run", *cal, "--euroc", root, "--out-dir", out,
                                "--outputs", "disparity,disparity_vis", "--save-frames", "1"])):
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "ros_gpu_stereo_processor_tpu_torch.cli",
                               *args], capture_output=True, text=True, cwd=here, env=env,
                              timeout=300)
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise AssertionError(f"cli {name}: exit {proc.returncode}\n{proc.stdout}\n"
                                 f"{proc.stderr}")
        lines = proc.stdout.strip().splitlines()
        log(f"cli {name} ({secs[name]:.1f} s): {lines[0]}" + (f" ... {lines[-1]}" if len(lines) > 1 else ""))
    report = [ln for ln in lines if ln.startswith("kernel launches: ")]
    if len(report) != 1:
        raise AssertionError("cli run: no kernel launch report")
    by_symbol = json.loads(report[0][len("kernel launches: "):])
    launches = {k: by_symbol.get(SOURCES[k][0], 0) for k in SOURCES}
    for sym, n in by_symbol.items():
        want = CLI_FRAMES if sym in (SOURCES[k][0] for k in ("K1", "K2", "K3")) else 0
        if n != want:
            raise AssertionError(f"cli run: {sym} launched {n} times, not {want}")
    log(f"cli run launches over {CLI_FRAMES} frames: {launches}")
    d0 = np.load(os.path.join(out, "disparity_0000.npy"))
    if not np.array_equal(d0, served0):
        raise AssertionError("cli run: frame 0's disparity differs from the served frame 0")
    log(f"cli: frame 0's disparity equals the serve phase's for the same pair")
    return ({"path": "cli", "frames": CLI_FRAMES, "info_s": secs["info"], "run_s": secs["run"],
             "kernel_launches": launches}, launches)


def run_bench(torch, port, bench, dev):
    """The port's bench, ``python3 -m ros_gpu_stereo_processor_tpu_torch.bench``,
    in a subprocess on the card at the JAX bench's defaults, not cut (B 8,
    64 e2e frames, 24 SLAM frames, 3 repeats).  Gates:
    exit 0; the last line parses and holds at most 1,800 characters; every
    headline metric is present, finite and > 0, each spread's min and max
    too; no ``*_error`` key in either line; the record's launch counts (set
    to 0 at the bench's start) show K1–K6 launched and K7 and BL not.  Then,
    in this process, the compute section's timed window (BENCH_WINDOW_ITERS
    batches of B frames enqueued back to back) and one unit of work of the
    SGM and SLAM-compute sections, each under
    ``torch.cuda.set_sync_debug_mode("error")``: none may raise, while the
    same mode does raise on a host read.
    Returns (its JSON line, the launches by kernel)."""
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line

    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here + os.pathsep + os.environ.get("PYTHONPATH", ""))
    log("bench: the JAX bench's defaults (B 8, 64 e2e frames, 24 SLAM frames, 3 repeats), "
        "not cut")
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "ros_gpu_stereo_processor_tpu_torch.bench"],
                          capture_output=True, text=True, cwd=here, env=env,
                          timeout=BENCH_TIMEOUT_S)
    secs = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or len(lines) < 2:
        raise AssertionError(f"bench: exit {proc.returncode}\n{proc.stdout[-4000:]}\n"
                             f"{proc.stderr[-4000:]}")
    record, last = json.loads(lines[-2]), lines[-1]
    head = json.loads(last)
    log(f"bench ({secs:.1f} s) record: {lines[-2]}")
    log(f"bench headline ({len(last)} characters): {last}")
    if len(last) > bench.HEADLINE_MAX_CHARS:
        raise AssertionError(f"bench: the headline has {len(last)} characters")
    errors = [k for k in list(record) + list(head) if k.endswith("_error")]
    if errors:
        raise AssertionError(f"bench: {errors}")
    for k in bench.HEADLINE_METRICS:
        vals = [head.get(k)]
        if k in bench.SPREADS:
            vals += list(head.get(bench.SPREADS[k], {"min": None}).values())
        if not all(isinstance(v, (int, float)) and np.isfinite(v) and v > 0 for v in vals):
            raise AssertionError(f"bench: {k} = {vals} (not all finite and > 0)")
    if record["kernels"] != "cuda" or record["device"]["card"] != card_line():
        raise AssertionError(f"bench: kernels {record['kernels']}, device {record['device']}")
    by_symbol = record["kernel_launches"]
    launches = {k: by_symbol.get(SOURCES[k][0], 0) for k in SOURCES}
    if not all(launches[k] > 0 for k in ("K1", "K2", "K3", "K4", "K5", "K6")) or \
            launches["K7"] or launches["BL"]:
        raise AssertionError(f"bench: launches {launches}")
    log(f"bench launches: {launches}")

    # the sections' units of work, in this process: no host sync inside
    model, left, right = bench._model_and_frame()
    cfg = bench._bench_config()
    B = 8
    lefts = torch.from_numpy(np.stack([left] * B)).to(dev)
    rights = torch.from_numpy(np.stack([right] * B)).to(dev)
    run = bench._frame_runner(model, cfg, port.Outputs.of("disparity", "pointcloud"), dev)
    sgm = bench._sgm_runner(port.StereoBMConfig(num_disparities=64, block_size=15,
                                                texture_threshold=10))
    chain = bench._slam_chain(model, cfg, dev)
    torch.cuda.set_sync_debug_mode("error")
    try:
        torch.ones(1, device=dev).sum().item()
    except RuntimeError:
        pass
    else:
        raise AssertionError("set_sync_debug_mode('error') let a host read through")
    finally:
        torch.cuda.set_sync_debug_mode("default")
    for name, fn in (
            (f"the compute window ({BENCH_WINDOW_ITERS} batches of {B} frames)",
             lambda: bench._enqueue_batches(run, lefts, rights, BENCH_WINDOW_ITERS)),
            (f"one SGM batch of {B} frames at 64 disparities", lambda: sgm(lefts, rights).sum()),
            (f"one SLAM-compute chain over {B} frames",
             lambda: bench._slam_checksum(chain(lefts, rights)))):
        fn()                    # warm: first-call allocations and caches off the window
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            total = fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
        if not bool(torch.isfinite(total)):
            raise AssertionError(f"bench, {name}: checksum {float(total)}")
        log(f"bench: {name} enqueued under set_sync_debug_mode('error') with no host "
            f"sync; checksum {float(total)}")
    return ({"path": "bench", "seconds": secs, "headline": head,
             "stage_ms": record.get("stage_ms"),
             "roofline_pct_of_bound": {k: v["pct_of_bound"]
                                       for k, v in record["roofline"].items()
                                       if isinstance(v, dict)},
             "kernel_launches": launches}, launches)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", metavar="DIR",
                    help="also trace a few frames of each path, print device time by "
                         "kernel and write the Chrome traces under DIR")
    args = ap.parse_args()
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch import bench
    from ros_gpu_stereo_processor_tpu_torch.ops import (
        _build, remap, remap_kernel, sgm_kernel, speckle, speckle_kernel, stereobm,
        stereobm_kernel,
    )
    from ros_gpu_stereo_processor_tpu_torch.ops import features
    from ros_gpu_stereo_processor_tpu_torch.parallel import frontend, multihost
    from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
    from ros_gpu_stereo_processor_tpu_torch.ops import color
    from ros_gpu_stereo_processor_tpu_torch.utils import calib, evaluate, io, synth, timing
    from ros_gpu_stereo_processor_tpu_torch.utils import roofline as rl
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line

    # the port uses no convolution and no matrix product; both TF32
    # switches are off all the same, so no library path can round
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    t_start = time.perf_counter()
    seconds = {}
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    log(f"card: {card_line()}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device {name}")
    slam_frames = start_rendering(synth)

    with phase("build", seconds):
        lib = _build.build(verbose=True)
        log(f"build: {lib.name}")

    model = calib.euroc_like_model()
    maps = torch.from_numpy(model.rect_maps_stacked()).to(dev)
    results = {}

    # -- K1 remap -----------------------------------------------------------
    with phase("K1", seconds):
        l0, r0, _ = port.synthetic_stereo_pair(H, W, 48, seed=100)
        mono = torch.from_numpy(np.stack([l0, r0])).to(dev)
        rgb = torch.from_numpy(
            np.random.default_rng(1).integers(0, 256, (2, H, W, 3), np.uint8)).to(dev)
        f32 = mono.float() * 0.37
        # full width (the vector variant) and one column short (751: the
        # scalar variant for widths that are not a multiple of 4)
        errs = []
        for width in (W, W - 1):
            m = maps[:, :, :width]
            for label, imgs in (("mono", mono), ("rgb", rgb)):
                got = remap_kernel.rectify(imgs, m)
                want = remap.rectify_pair(imgs, m)
                torch.cuda.synchronize()
                require_equal(f"K1 {label} at width {width}", got, want)
                errs.append(max_abs(got, want))
            got = remap_kernel.rectify(f32, m)
            want = remap.rectify_pair(f32, m)
            torch.cuda.synchronize()
            if not torch.allclose(got, want, rtol=1e-6, atol=0):
                raise AssertionError(f"K1 float32 at width {width}: max |diff| "
                                     f"{max_abs(got, want)}")
            log(f"K1 remap at width {width}: uint8 mono and RGB exact, float32 max |diff| "
                f"{max_abs(got, want)} (rtol 1e-6)")
        # the yardstick: grid_sample (bilinear, zeros, align_corners) on the
        # same maps, float32 (it has no uint8 mode); the port never calls it
        img_f = mono.float()[:, None]
        scale = torch.tensor([2.0 / (W - 1), 2.0 / (H - 1)], device=dev)
        grid = maps * scale - 1.0

        def library():
            return F.grid_sample(img_f, grid, mode="bilinear", padding_mode="zeros",
                                 align_corners=True)

        work = rl.remap_model(H, W)
        b_ms, by = rl.bound(work["bytes"], work["ops"])
        lib_dev_ms, _ = device_cost(torch, library, KERNEL_REPS)
        odd = maps[:, :, :W - 1].contiguous()
        odd_dev_ms, _ = device_cost(torch, lambda: remap_kernel.rectify(mono, odd), KERNEL_REPS,
                                    launches=1)
        results["K1"] = {
            "max_abs_err": max(errs),
            **timed(torch, lambda: remap_kernel.rectify(mono, maps),
                    lambda: remap.rectify_pair(mono, maps), 1),
            "bound_ms": b_ms, "bound_by": by,
            "library_ms": cuda_ms(torch, library, KERNEL_REPS),
            "library_device_ms": lib_dev_ms,
            "odd_width_ms": cuda_ms(torch, lambda: remap_kernel.rectify(mono, odd),
                                    KERNEL_REPS),
            "odd_width_device_ms": odd_dev_ms,
        }
        k1 = results["K1"]
        log(f"K1 remap: device {k1['device_ms']:.5f} ms against grid_sample's "
            f"{lib_dev_ms:.5f} ms ({k1['device_ms'] / lib_dev_ms:.3f}x);", k1)

    # -- K2 fused block matcher -------------------------------------------
    with phase("K2", seconds):
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
        # the shape each mesh band launches: 120 rows and 2 x 7 halo rows
        lb, rb = lf[:BAND_ROWS].contiguous(), rf[:BAND_ROWS].contiguous()
        uq = base.replace(refine_disparity=True, uniqueness_ratio=15)
        for c in (base, uq):
            for a, b, nm in zip(stereobm_kernel.fused_raw(lb, rb, c),
                                stereobm_kernel.fused_raw_plain(lb, rb, c),
                                ("disp_raw", "best_cost", "excl")):
                require_equal(f"K2 band {nm} refine={c.refine_disparity}", a, b)
        band_dev_ms, _ = device_cost(torch, lambda: stereobm_kernel.fused_raw(lb, rb, base),
                                     KERNEL_REPS, launches=1)
        work = rl.stereobm_fused_model(H, W, base.num_disparities)
        b_ms, by = rl.bound(work["bytes"], work["ops"])
        results["K2"] = {
            "max_abs_err": max(errs),
            **timed(torch, lambda: stereobm_kernel.fused_raw(lf, rf, base),
                    lambda: stereobm_kernel.fused_raw_plain(lf, rf, base), 1),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "band_rows": BAND_ROWS, "band_device_ms": band_dev_ms,
            "band_ms": cuda_ms(torch, lambda: stereobm_kernel.fused_raw(lb, rb, base),
                               KERNEL_REPS),
        }
        log("K2 block matcher: raw maps and gated output exact;", results["K2"])

    # -- K3 speckle labels ------------------------------------------------
    with phase("K3", seconds):
        disp, valid = stereobm_kernel.compute_disparity_fused(rect[0], rect[1], base)
        sp = port.SpeckleConfig()
        rounds, err = check_round_counts(
            torch, "K3 labels", lambda k: speckle_kernel.labels(disp, valid, sp.max_diff, k),
            lambda k: speckle._labels_scan(disp, valid, sp.max_diff, k),
            sp.propagation_iters)
        work = rl.speckle_model(H, W, rounds)
        b_ms, by = rl.bound(work["bytes"], work["ops"])
        results["K3"] = {
            "max_abs_err": err,
            **timed(torch, lambda: speckle_kernel.labels(
                        disp, valid, sp.max_diff, sp.propagation_iters),
                    lambda: speckle._labels_scan(
                        disp, valid, sp.max_diff, sp.propagation_iters), 2),
            "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "rounds_to_converge": rounds,
        }
        log(f"K3 speckle labels: exact; converged in {rounds} rounds;", results["K3"])

    # -- K4–K6 SGM ----------------------------------------------------------
    with phase("K4-K6", seconds):
        for nd, p1, p2 in ((64, 10.0, 120.0), (64, 7.5, 93.25), (128, 10.0, 120.0)):
            cfg = port.StereoBMConfig(num_disparities=nd, block_size=15)
            res = check_sgm_kernels(torch, sgm_kernel, stereobm, rl, rect, cfg, p1, p2)
            storage = sgm_kernel.storage_dtypes(cfg, p1, p2, True)
            log(f"SGM kernels exact at {nd} disparities, P1 {p1}, P2 {p2}, storage "
                f"{storage}: " + json.dumps(res))
        results.update(res)       # the last case is the SGM main path's shape

    # -- K7 + band label rounds ------------------------------------------
    with phase("K7", seconds):
        mesh = make_mesh(BANDS, devices=[dev] * BANDS)
        res = check_k7(torch, speckle, speckle_kernel, frontend, rl, mesh, disp, valid, sp)
        log("K7 max-propagation and band label rounds: exact; " + json.dumps(res))
        results.update(res)

    arrays = (model.rect_maps_stacked(), model.Q, W, H, model.fx, model.baseline)
    pipes = []

    def new_pipe(**kw):
        pipes.append(port.StereoPipeline.from_arrays(*arrays, **kw))
        return pipes[-1]

    outputs = port.Outputs.all()
    k1 = remap_kernel.KERNELS[torch.uint8]
    launches, e2e = {}, []

    # -- BM end to end -------------------------------------------------------
    with phase("BM e2e", seconds):
        pipe = new_pipe(device=dev)
        cpu_pipe = new_pipe(device="cpu")
        frames = [port.synthetic_stereo_pair(H, W, 48, seed=i)[:2] for i in range(FRAMES)]
        per_frame = {"K1": (k1, 2), "K2": (stereobm_kernel.KERNEL, 1),
                     "K3": (speckle_kernel.KERNEL, 1)}
        bm_ms, gpu_out, launches["bm"] = drive(torch, _build, pipe, frames, outputs,
                                               per_frame, COMPARED)
        gpu_bm0 = gpu_out[0]
        log(f"BM launches over {FRAMES} frames: {launches['bm']}")
        bm_pipelined = pipelined(torch, pipe, frames, outputs)
        for i in range(COMPARED):
            compare_outputs(gpu_out[i], cpu_pipe.process(*frames[i], outputs).fetch(),
                            f"BM frame {i}")
        e2e.append(summary("bm", bm_ms, bm_pipelined))
        if args.profile:
            profile_frames(torch, timing, pipe, frames[1:11], outputs,
                           os.path.join(args.profile, "bm"), "bm")

    with phase("BM lr_check", seconds):
        cfg = port.PipelineConfig(stereobm=port.StereoBMConfig(lr_check=True))
        lr_pipe = new_pipe(config=cfg, device=dev)
        lr_cpu = new_pipe(config=cfg, device="cpu")
        per_frame = {"K2": (stereobm_kernel.KERNEL, 2)}
        _, got, _ = drive(torch, _build, lr_pipe, frames[:1], outputs, per_frame, 1)
        compare_outputs(got[0], lr_cpu.process(*frames[0], outputs).fetch(),
                        "BM lr_check frame 0")

    # -- SGM end to end ------------------------------------------------------
    with phase("SGM e2e", seconds):
        sgm_bm = port.StereoBMConfig(algorithm="sgm", sgm_paths=4, num_disparities=128)
        cfg = port.PipelineConfig(stereobm=sgm_bm)
        spipe = new_pipe(config=cfg, device=dev)
        scpu = new_pipe(config=cfg, device="cpu")
        sframes = [port.synthetic_stereo_pair(H, W, 96, seed=1000 + i)[:2]
                   for i in range(SGM_FRAMES)]
        per_frame = {"K1": (k1, 2), "K2": (stereobm_kernel.KERNEL, 0),
                     "K3": (speckle_kernel.KERNEL, 1), "K4": (sgm_kernel.COST_DOWN, 1),
                     "K5": (sgm_kernel.AGGREGATE, 3), "K6": (sgm_kernel.WTA, 1)}
        sgm_ms, gpu_out, launches["sgm"] = drive(torch, _build, spipe, sframes, outputs,
                                                 per_frame, SGM_COMPARED)
        log(f"SGM launches over {SGM_FRAMES} frames: {launches['sgm']}")
        sgm_pipelined = pipelined(torch, spipe, sframes, outputs)
        for i in range(SGM_COMPARED):
            compare_outputs(gpu_out[i], scpu.process(*sframes[i], outputs).fetch(),
                            f"SGM frame {i}")
        e2e.append(summary("sgm", sgm_ms, sgm_pipelined))
        if args.profile:
            profile_frames(torch, timing, spipe, sframes[1:6], outputs,
                           os.path.join(args.profile, "sgm"), "sgm")

    with phase("SGM lr_check", seconds):
        cfg = port.PipelineConfig(stereobm=sgm_bm.replace(lr_check=True))
        lr_pipe = new_pipe(config=cfg, device=dev)
        lr_cpu = new_pipe(config=cfg, device="cpu")
        per_frame = {"K4": (sgm_kernel.COST_DOWN, 1), "K5": (sgm_kernel.AGGREGATE, 3),
                     "K6": (sgm_kernel.WTA, 0)}
        _, got, _ = drive(torch, _build, lr_pipe, sframes[:1], outputs, per_frame, 1)
        compare_outputs(got[0], lr_cpu.process(*sframes[0], outputs).fetch(),
                        "SGM lr_check frame 0")

    # -- the row-band mesh end to end ----------------------------------------
    with phase("mesh e2e", seconds):
        mpipe = new_pipe(mesh=make_mesh(BANDS, devices=[dev] * BANDS))
        mcpu = new_pipe(mesh=make_mesh(BANDS, devices=["cpu"] * BANDS))
        mframes = frames[:MESH_FRAMES]
        per_frame = {"K1": (k1, 2 * BANDS), "K2": (stereobm_kernel.KERNEL, BANDS),
                     "K3": (speckle_kernel.KERNEL, 0), "K7": (speckle_kernel.MAXPROP, BANDS),
                     "BL": (speckle_kernel.BAND_LABELS, None)}
        mesh_ms, gpu_out, launches["mesh"] = drive(torch, _build, mpipe, mframes, outputs,
                                                   per_frame, MESH_COMPARED)
        log(f"mesh launches over {MESH_FRAMES} frames: {launches['mesh']}")
        mesh_pipelined = pipelined(torch, mpipe, mframes, outputs)
        for i in range(MESH_COMPARED):
            compare_outputs(gpu_out[i], mcpu.process(*mframes[i], outputs).fetch(),
                            f"mesh frame {i}")
        e2e.append(summary("mesh", mesh_ms, mesh_pipelined))
        if args.profile:
            profile_frames(torch, timing, mpipe, mframes[1:6], outputs,
                           os.path.join(args.profile, "mesh"), "mesh")

    with phase("mesh checks", seconds):
        cfg = port.PipelineConfig(speckle=port.SpeckleConfig(max_speckle_size=0))
        off = new_pipe(config=cfg, mesh=make_mesh(BANDS, devices=[dev] * BANDS))
        compare_outputs(off.process(*frames[0], outputs).fetch(),
                        new_pipe(config=cfg, device=dev).process(*frames[0], outputs).fetch(),
                        "mesh frame 0, speckle off, against one device")
        for label, cfg, frame, per_frame in (
                ("mesh SGM", port.PipelineConfig(stereobm=sgm_bm), sframes[0],
                 {"K2": (stereobm_kernel.KERNEL, 0), "K4": (sgm_kernel.COST_DOWN, BANDS),
                  "K5": (sgm_kernel.AGGREGATE, 3 * BANDS), "K6": (sgm_kernel.WTA, BANDS),
                  "K7": (speckle_kernel.MAXPROP, BANDS)}),
                ("mesh lr_check", port.PipelineConfig(stereobm=port.StereoBMConfig(
                    lr_check=True)), frames[0],
                 {"K2": (stereobm_kernel.KERNEL, 2 * BANDS),
                  "K7": (speckle_kernel.MAXPROP, BANDS)})):
            gpipe = new_pipe(config=cfg, mesh=make_mesh(BANDS, devices=[dev] * BANDS))
            cpipe = new_pipe(config=cfg, mesh=make_mesh(BANDS, devices=["cpu"] * BANDS))
            _, got, launches[label] = drive(torch, _build, gpipe, [frame], outputs,
                                            per_frame, 1)
            compare_outputs(got[0], cpipe.process(*frame, outputs).fetch(), f"{label} frame 0")

    # -- disparity slabs --------------------------------------------------------
    with phase("slab", seconds):
        lines, more = run_slab(torch, _build, port, new_pipe, make_mesh, frames, outputs,
                               {"K1": k1, "K2": stereobm_kernel.KERNEL,
                                "K3": speckle_kernel.KERNEL, "K7": speckle_kernel.MAXPROP,
                                "BL": speckle_kernel.BAND_LABELS}, dev)
        e2e += lines
        launches.update(more)

    # -- Bayer input, the bilateral tier, bilateral by band ------------------
    bm_kernels = {"K1": (k1, 2), "K2": (stereobm_kernel.KERNEL, 1),
                  "K3": (speckle_kernel.KERNEL, 1)}
    with phase("Bayer", seconds):
        check_bayer(torch, color, port, frames, dev)
        line, launches["bayer"] = run_bayer(torch, _build, new_pipe, frames, outputs,
                                            bm_kernels, dev)
        e2e.append(line)
    with phase("bilateral", seconds):
        for iters in (1, 3):
            line, launches[f"bilateral iters {iters}"] = run_bilateral(
                torch, _build, port, new_pipe, frames, outputs, bm_kernels, gpu_bm0,
                iters, dev)
            e2e.append(line)
    with phase("bilateral mesh", seconds):
        launches["bilateral mesh"] = run_bilateral_mesh(
            torch, _build, port, new_pipe, make_mesh, frames, outputs, bm_kernels, dev)

    for p in pipes:
        p.senders.shutdown()

    # -- the SLAM engine end to end -------------------------------------------
    kernels = {"K1": k1, "K2": stereobm_kernel.KERNEL, "K3": speckle_kernel.KERNEL,
               "K4": sgm_kernel.COST_DOWN, "K5": sgm_kernel.AGGREGATE,
               "K6": sgm_kernel.WTA, "K7": speckle_kernel.MAXPROP,
               "BL": speckle_kernel.BAND_LABELS}
    with phase("SLAM e2e", seconds):
        sframes, gt = slam_frames()
        line, launches["slam"], positions = run_slam(
            torch, port, _build, features, timing, evaluate, calib, sframes, gt, dev,
            kernels, args.profile)
        e2e.append(line)
    with phase("SLAM meshes", seconds):
        lines, more = run_slam_meshes(torch, port, _build, evaluate, calib, make_mesh,
                                      sframes, gt, dev, kernels, positions)
        e2e += lines
        launches.update(more)

    # -- the multi-process worker, the scaling harness and the dry run ---------
    with phase("multihost", seconds):
        line, launches["multihost"] = run_multihost(torch, multihost, make_mesh, dev)
        e2e.append(line)
    with phase("scaling", seconds):
        lines, more = run_scaling(torch, port, _build, kernels, dev)
        e2e += lines
        launches.update(more)

    # -- the serve daemon and the CLI -------------------------------------------
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        with phase("serve", seconds):
            line, launches["serve"], served = run_serve(
                torch, port, _build, io, calib, kernels, frames, model, work, dev)
            e2e.append(line)
        with phase("CLI", seconds):
            yamls = [os.path.join(work, "watch", f"camera_info_{s}.yaml")
                     for s in ("left", "right")]
            line, launches["cli"] = run_cli(io, yamls, frames, served[0], work)
            e2e.append(line)

    # -- the port's bench ---------------------------------------------------------
    with phase("bench", seconds):
        line, launches["bench"] = run_bench(torch, port, bench, dev)
        e2e.append(line)

    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "BL"):
        sym, src, tpu = SOURCES[k]
        path = {"K1": "bm", "K2": "bm", "K3": "bm", "K7": "mesh", "BL": "mesh"}.get(k, "sgm")
        kernels.append({
            "name": sym, "route": "cuda",
            "source": f"ros_gpu_stereo_processor_tpu_torch/{src}",
            "replaces": f"ros_gpu_stereo_processor_tpu/{tpu}",
            "launches": launches[path][k], "path": path,
            "launches_by_path": {p: n[k] for p, n in launches.items() if k in n},
            **results[k]})
    log(f"seconds by phase: {json.dumps({k: round(v, 1) for k, v in seconds.items()})}, "
        f"total {time.perf_counter() - t_start:.1f} s")
    for line in e2e:
        log(json.dumps(line))
    log(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
