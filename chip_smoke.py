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
     the down walk's device time apart, and the walk's ns per step; and its
     cost stage alone, the 2-path route's, against K4's cost volume), K5
     path aggregation (the frame's three calls, each also timed apart with
     its ns per step), DG the diagonal pair walk (the 8-path frame's two
     calls, each timed apart with its ns per step over ``steps``, the
     call's longest chain) and K6 winner-take-all
     over 2, 4 and 8 paths at 64 and 128
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
         not K2, DG or K4's cost stage alone; 2 compared with the CPU run;
       * SGM over 8 and over 2 paths (the same config and frames): each frame
         K4 once, K5 three times and DG twice (8 paths), or K4's cost stage
         alone once and K5 twice (2 paths), and K1 twice, K3 and K6 once; 2
         compared with the CPU run;
       * the row-band mesh, ``make_mesh(4, devices=["cuda:0"] * 4)``, default
         BM config: 6 frames, each launching K1 and K2 once per band per
         call (8 and 4), K7 once per band (4), the band label rounds at
         least once (24 merge rounds × 4 bands recorded in its graph, the
         rounds past the fixed point gated off on the device) and K3 never;
         2 compared with the CPU run of the same 4-band mesh;
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
     over 3.
     On one card every frame step is a replay of its variant's CUDA graph
     (utils/graphs.py; a mesh whose band line is one card too): a frame's
     first run is eager and captures, and every kernel count goes up at the
     replays (never at the capture), so each frame's launch gate holds as
     it did.
     The ``graphs`` phase (after SGM ``lr_check``) sets each captured
     variant beside its eager step in this call: first K3's cooperative
     launch and ``torch.linalg.solve_ex`` captured alone, equal to their
     eager calls; then BM at ``Outputs.all()``, BM ``lr_check``, 4-path
     SGM at 128 disparities, 8-path SGM at 64 and 128, 2-path SGM at 128,
     Bayer and the bilateral filter (iters 1), 9 distinct frames each, all
     held to the end and each equal to the eager step bit for bit (the 8-
     and 2-path rows' first frames also to the CPU run); ``process_batch`` of 8 frames (the
     first call and a replay); the VO step over the planar sequence (each
     dispatch against ``_vo_first``/``_vo_core`` run eagerly); the bench's
     SLAM-compute chain and compute batch.  For each: ``timed`` median and
     p75, pipelined ms a frame, and from ``torch.profiler`` the host calls
     (runtime launches, graph launches, copies, memsets), device events
     and busy share per frame, captured and eager; gates: at most 16 host
     calls a BM or SGM frame and 32 a SLAM-compute frame, one graph
     launch a step.  The ``mesh graphs`` phase (after the slabs) does the
     same for each mesh variant on 4 (slabs 128/8: 8) entries of
     ``cuda:0``: BM, BM ``lr_check``, 4-path SGM at 128 disparities, the
     bilateral filter (iters 1), slabs 64/4 and 128/8, 6 frames each; for
     each, one replay under ``torch.cuda.set_sync_debug_mode("error")``
     held to the CPU mesh, and the band label launches of a frame as
     recorded and as run (the merge loop's ``done`` flags read after an
     eager frame); before them the band label rounds' ``done`` gate on the
     card (off: equal to the ungated launch; on: a copy of the field), and
     after them the graph nodes and device µs of one gated merge round
     (the BM mesh frame at 24 and 48 merge rounds) and the planar SLAM
     run's windowed BA solves, each captured result equal to its eager
     solve bit for bit, one graph per window size, BA ms per keyframe and
     the solve's ms captured beside eager;
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
     single-device run, BA ms per keyframe.  Then the hard phases:
       * the 6-dof homography sequence of tests/test_vo_6dof.py (400×300,
         fx 350, a plane at 2.5 m, rendered with numpy): VO over 6 frames
         and ``StereoSlam`` (BM at 16 disparities, speckle off: K1 and K2
         once a frame) over 8, on the card against the port's CPU run of
         the same frames (flags exact, poses within 1e-5) and held to that
         test's bars (VO ATE < 0.02 m and final rotation < 0.02 rad, SLAM
         ATE < 0.03 m after ``optimize_global(iters=5)``, ≥ 3 keyframes);
       * the layered scene over SGM (utils/synth.py::render_layered, 752×480,
         200 frames, rendered in a process pool on a thread that starts
         before the kernel build; frames 100–101 blurred and darkened,
         banding 0.08) at scripts/torch_record_ate_hard.py's SGM settings
         (48 disparities, block 11, texture 10, speckle 200, 4 paths, P1
         10, P2 120; 512 features, a keyframe every 4 frames, a window of
         5): ``run_stream(depth=2)``, each frame launching K1 once (both
         sides in one launch), K3, K4 and K6 once and K5 three times, never
         K2; then ``detect_loop_closures`` and ``optimize_global``; fails
         unless a frame is lost, one relocalizes, a closure is found and
         the ATE after ``optimize_global`` is under 0.1 m; prints keyframes,
         lost, relocalized, closures detected and used, ATE before and
         after, median and p95 ms a frame, BA ms per keyframe,
         ``optimize_global`` ms and the render seconds; the card's first 8
         frames against the port's CPU run of them (as in the SLAM phase),
         the bench's SLAM-compute chain over them under
         ``set_sync_debug_mode("error")`` (no host sync with SGM inside),
         and device launches and busy share per frame over 5;
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
       * the publish path: 64 BM frames, ``Outputs.all()``, every output
         published through ``enqueue_send`` to registered publishers (K1
         128, K2 and K3 64 launches, counts set to 0 just before), frames
         1–63 enqueued under ``set_sync_debug_mode("error")``; gates:
         frames 0, 31 and 63's messages equal the CPU pipeline's, and in a
         profiler window over 8 published frames every device→host copy is
         ``Device -> Pinned`` on a stream that ran no K2 and no copy is
         pageable; prints the copy time overlapping kernels, host ms a
         frame with and without publishing, and pinned and pageable MB/s
         (1.44 and 4.33 MB);
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
     (counts set to 0 at the bench's start) and K7, BL and DG not; then, in this
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
HARD_FRAMES = 200   # the layered scene over SGM: scripts/torch_record_ate_hard.py's SGM record
HARD_COMPARED = 8   # its first frames, also run on the CPU and compared
SIXDOF = dict(width=400, height=300, fx=350.0, baseline=0.1, Z0=2.5)   # tests/test_vo_6dof.py
SIXDOF_VO_FRAMES = 6
SIXDOF_SLAM_FRAMES = 8
SIXDOF_BARS = (0.02, 0.02, 0.03)   # m, rad, m: VO ATE, VO final rotation, SLAM ATE
BENCH_WINDOW_ITERS = 10   # the compute section's BENCH_ITERS
PUBLISH_FRAMES = 64     # the publish phase: BM defaults, every output published
PUBLISH_CHECKED = (0, 31, 63)
PUBLISH_PROFILED = 8    # frames in the publish phase's profiler window
PUBLISH_COPIES = 12     # device→host copies a frame: 11 outputs, the point cloud's two arrays
LINK_REPS = 10
GRAPH_FRAMES = 9    # each path of the graphs phase: frame 0 runs eagerly and captures
GRAPH_BATCH = 8     # process_batch's B in the graphs phase
GRAPH_PROFILED = 4  # frames (or batches) in each profiler window of the graphs phase
GRAPH_HOST_CALLS_MAX = 16       # per BM or SGM frame, captured
MESH_GRAPH_FRAMES = 6   # each variant of the mesh graphs phase: frame 0 runs eagerly and captures
MESH_GRAPH_PROFILED = 2  # frames in each profiler window of the mesh graphs phase
GATED_PROBE_ROUNDS = 48  # merge rounds of the gated-round probe (the 4-band default is 24)
GRAPH_SLAM_HOST_CALLS_MAX = 32  # per frame of the SLAM-compute chain (pipeline + VO), captured
# the CUDA runtime and driver calls the profiler records that enqueue work:
# kernel, cooperative and graph launches, copies and memsets
HOST_CALL_PREFIXES = ("cudaLaunch", "cuLaunch", "cudaGraphLaunch", "cuGraphLaunch",
                      "cudaMemcpy", "cuMemcpy", "cudaMemset", "cuMemset")
H, W = 480, 752

SOURCES = {   # key: (C entry point, CUDA source, TPU kernel it replaces)
    "K1": ("remap_bilinear_u8", "csrc/remap.cu", "ops/remap_pallas.py:154"),
    "K2": ("bm_fused", "csrc/stereobm.cu", "ops/stereobm_pallas.py:153"),
    "K3": ("speckle_labels", "csrc/speckle.cu", "ops/speckle_pallas.py:104"),
    "K4": ("sgm_cost_down", "csrc/sgm.cu", "ops/sgm_pallas.py:191"),
    "K5": ("sgm_aggregate", "csrc/sgm.cu", "ops/sgm_pallas.py:349"),
    "K6": ("sgm_wta", "csrc/sgm_wta.cu", "ops/sgm_pallas.py:432"),
    "K7": ("speckle_maxprop", "csrc/speckle.cu", "ops/speckle_pallas.py:164"),
    # the band-local label rounds of the mesh speckle filter: no TPU kernel,
    # they replace the JAX band's jnp scans
    "BL": ("speckle_band_labels", "csrc/speckle.cu", "parallel/frontend.py:585"),
    # the diagonal pair walk of 8-path SGM: no TPU kernel, it replaces the
    # JAX pipeline's jnp diagonal scans
    "DG": ("sgm_aggregate_diagonal", "csrc/sgm_diagonal.cu", "ops/sgm.py:75"),
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
    return pipelined_ms(torch, lambda left, right: pipe.process(left, right, outputs), frames)


def pipelined_ms(torch, enqueue, frames):
    """Host ms per frame with ``enqueue(left, right)`` called back to back
    over ``frames`` and closed by one synchronize."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for left, right in frames:
        enqueue(left, right)
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
    """K4 (and its cost stage alone, the 2-path route's), K5 (the frame's
    three calls), DG (the 8-path frame's two calls) and K6 over 2, 4 and 8
    paths against their plain versions on the card, exact; then their times
    and bounds (``rl``: the port's utils/roofline.py)."""
    lf = stereobm.prefilter(rect[0], cfg)
    rf = stereobm.prefilter(rect[1], cfg)
    cdt, edt = sgm_kernel.storage_dtypes(cfg, p1, p2, True)
    cost, down = sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, cdt, edt)
    cost_p, down_p = sgm_kernel.cost_and_down_plain(lf, rf, cfg, p1, p2, cdt, edt)
    alone = sgm_kernel.cost_volume(lf, rf, cfg, p2, cdt)
    torch.cuda.synchronize()
    require_equal("K4 cost", cost, cost_p)
    require_equal("K4 exc_down", down, down_p)
    require_equal("K4 cost stage alone", alone, cost_p)
    err = {"K4": max(max_abs(cost, cost_p), max_abs(down, down_p), max_abs(alone, cost_p)),
           "K5": 0.0, "K6": 0.0, "DG": 0.0}

    def held(key, name, fn, plain, *args):
        got, want = fn(*args), plain(*args)
        torch.cuda.synchronize()
        require_equal(f"{key} {name}", got, want)
        err[key] = max(err[key], max_abs(got, want))
        return got

    ev = held("K5", "up + down", sgm_kernel.aggregate, sgm_kernel.aggregate_plain,
              cost, down, p1, p2, True, True, edt)
    lr = held("K5", "left-right", sgm_kernel.aggregate, sgm_kernel.aggregate_plain,
              cost, None, p1, p2, False, False, edt)
    eh = held("K5", "right-left + left-right", sgm_kernel.aggregate,
              sgm_kernel.aggregate_plain, cost, lr, p1, p2, False, True, edt)
    diag = [held("DG", f"dx {dx:+d}", sgm_kernel.aggregate_diagonal,
                 sgm_kernel.aggregate_diagonal_plain, cost, p1, p2, dx, edt) for dx in (1, -1)]
    pairs = {2: (eh,), 4: (ev, eh), 8: (ev, eh, *diag)}
    for c in (cfg, cfg.replace(refine_disparity=True, uniqueness_ratio=10)):
        for n, pv in pairs.items():
            got = sgm_kernel.wta(cost, pv, c)
            want = sgm_kernel.wta_plain(cost, pv, c)
            torch.cuda.synchronize()
            for a, b, nm in zip(got, want, ("disp_raw", "best_cost", "excl")):
                require_equal(f"K6 {n} paths {nm} refine={c.refine_disparity}", a, b)
                err["K6"] = max(err["K6"], max_abs(a, b))

    def k5(fn):
        def run():
            ev = fn(cost, down, p1, p2, True, True, edt)
            lr = fn(cost, None, p1, p2, False, False, edt)
            return ev, fn(cost, lr, p1, p2, False, True, edt)
        return run

    def dg(fn):
        return lambda: [fn(cost, p1, p2, dx, edt) for dx in (1, -1)]

    # per call; K5's is the mean of the frame's 3 calls, DG's of its 2
    work = {n: rl.sgm_fused_model(H, W, cfg.num_disparities, cost.element_size(),
                                  down.element_size(), paths=n) for n in pairs}
    times = {
        "K4": timed(torch, lambda: sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, cdt, edt),
                    lambda: sgm_kernel.cost_and_down_plain(lf, rf, cfg, p1, p2, cdt, edt), 2,
                    split=("sgm_cost", "sgm_walk")),
        "K5": timed(torch, k5(sgm_kernel.aggregate), k5(sgm_kernel.aggregate_plain), 1,
                    calls=3),
        "DG": timed(torch, dg(sgm_kernel.aggregate_diagonal),
                    dg(sgm_kernel.aggregate_diagonal_plain), 1, calls=2),
        "K6": timed(torch, lambda: sgm_kernel.wta(cost, pairs[4], cfg),
                    lambda: sgm_kernel.wta_plain(cost, pairs[4], cfg), 1),
    }
    # each walk's device time and time per step (one pixel of its lines; a
    # DG call's longest chain is sgm_kernel.diagonal_steps: min(H, W) steps
    # where both directions walk at once, twice that down and back up)
    times["K4"]["down_walk_step_ns"] = times["K4"]["sgm_walk_device_ms"] * 1e6 / H
    times["K4"]["cost_only"] = timed(
        torch, lambda: sgm_kernel.cost_volume(lf, rf, cfg, p2, cdt),
        lambda: sgm_kernel.cost_volume_plain(lf, rf, cfg, p2, cdt), 1)
    times["K4"]["cost_only"]["bound_ms"], times["K4"]["cost_only"]["bound_by"] = \
        rl.model_bound(work[2]["K4 cost"])
    times["K5"]["calls"] = {}
    for name, exc_in, vertical, reverse in k5_calls(down, lr):
        args = (cost, exc_in, p1, p2, vertical, reverse, edt)
        ms, _ = device_cost(torch, lambda: sgm_kernel.aggregate(*args), KERNEL_REPS,
                            launches=1)
        times["K5"]["calls"][name] = {"device_ms": ms,
                                      "step_ns": ms * 1e6 / (H if vertical else W)}
    times["DG"]["calls"] = {}
    times["DG"]["steps"] = steps = sgm_kernel.diagonal_steps(H, W, cfg.num_disparities, cdt, edt)
    for dx in (1, -1):
        ms, _ = device_cost(torch, lambda: sgm_kernel.aggregate_diagonal(cost, p1, p2, dx, edt),
                            KERNEL_REPS, launches=1)
        times["DG"]["calls"][f"dx {dx:+d}"] = {"device_ms": ms, "step_ns": ms * 1e6 / steps}
    times["K6"]["paths"] = {}
    for n, pv in pairs.items():
        ms, _ = device_cost(torch, lambda: sgm_kernel.wta(cost, pv, cfg), KERNEL_REPS,
                            launches=1)
        b_ms, by = rl.model_bound(work[n]["K6"])
        times["K6"]["paths"][n] = {"device_ms": ms, "bound_ms": b_ms, "bound_by": by}
    out = {}
    for k in ("K4", "K5", "DG", "K6"):
        b_ms, by = rl.model_bound(work[8][k])
        out[k] = {"max_abs_err": err[k], **times[k], "bound_ms": b_ms, "bound_by": by,
                  "library_ms": None}
    out["K6"]["bound_ms"], out["K6"]["bound_by"] = rl.model_bound(work[4]["K6"])
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


def planar_model(calib, fx=441.0, baseline=0.11, width=None, height=None):
    """The camera of the port's synthetic sequences (utils/synth.py), W×H
    unless given: pinhole, no distortion, the principal point at the image
    centre."""
    width, height = width or W, height or H
    K = np.array([[fx, 0, width / 2], [0, fx, height / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -fx * baseline

    def mk(PP, name):
        return calib.CameraCalib(width, height, K, np.zeros(5), np.eye(3), PP, name)

    return calib.StereoCameraModel.from_calibs(mk(P, "left"), mk(Pr, "right"))


def start_rendering(name, render):
    """Run ``render()`` on a thread (numpy; it overlaps the kernel build and
    the phases before its frames are needed).  Returns a function that waits
    for it and returns what ``render`` returned."""
    import threading

    out = {}

    def run():
        try:
            out["result"] = render()
        except BaseException as e:       # re-raised by the waiter
            out["error"] = e

    th = threading.Thread(target=run, name=name)
    th.start()

    def wait():
        th.join()
        if "error" in out:
            raise out["error"]
        return out["result"]

    return wait


def render_planar(synth):
    """The SLAM sequence: ([(left, right, stamp)], ground truth)."""
    lefts, rights, gt = synth.render_planar(SLAM_FRAMES, W, H, 441.0, 0.11, 3.0, 10.0, 0)
    return list(zip(lefts, rights, gt.stamps)), gt


def render_hard(synth, hard):
    """The hard phase's sequences: the layered scene of the SGM record
    (HARD_FRAMES frames at W×H, ``hard``: scripts/torch_record_ate_hard.py)
    rendered in a process pool, and the 6-dof homography sequence.  Returns
    (([(left, right, stamp)], ground truth, render s, workers), 6-dof
    (lefts, rights, poses))."""
    workers = max(2, (os.cpu_count() or 4) - 2)
    t0 = time.perf_counter()
    lefts, rights, gt = synth.render_layered(
        workers=workers, **hard.scene_kwargs(HARD_FRAMES, W, H, occluders=0))
    render_s = time.perf_counter() - t0
    sixdof = synth.render_6dof(SIXDOF_SLAM_FRAMES, SIXDOF["width"], SIXDOF["height"],
                               SIXDOF["fx"], SIXDOF["baseline"], SIXDOF["Z0"], seed=0)
    return (list(zip(lefts, rights, gt.stamps)), gt, render_s, workers), sixdof


def load_script(name):
    """scripts/<name>.py of this checkout as a module."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


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
    """One SLAM (or VO) frame of the card against the CPU run's: flags (those
    the info carries) and match counts exact, poses within SLAM_POSE_ATOL;
    keypoints exact, descriptors exact where the steering bins agree (≤ 1 %
    of keypoints may differ)."""
    g, w = got["info"], want["info"]
    for f in SLAM_FLAGS:
        if f in w and g[f] != w[f]:
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


def slam_profile(torch, timing, slam, frames, log_dir, label="slam"):
    """Device launches and busy ms per SLAM frame of the fresh engine
    ``slam``: ``torch.profiler`` over SLAM_PROFILED synchronous steps after
    10 warm frames (the next window, while frames last, if the profiler
    recorded no device time).  Returns (launches, busy ms, wall ms) per
    frame."""
    from torch.profiler import ProfilerActivity, profile

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
    n = len(window)
    busy = sum(r[2] for r in rows)
    log(f"profile {label} over {n} frames: wall {wall_ms / n:.3f} ms/frame, device busy "
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
        torch, timing, engine(device=dev), frames,
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


def profile_window(torch, step, n, read):
    """``torch.profiler`` over ``n`` calls of ``step(i)`` closed by one
    synchronize; returns ``read(profile, wall ms)``.  The profiler now and
    then drops a window's events: a window that ``read`` finds short (it
    returns None) is tried again, up to PROFILER_WINDOWS windows."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILER_WINDOWS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for i in range(n):
                step(i)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        out = read(prof, wall_ms)
        if out is not None:
            return out
    raise AssertionError(f"the profiler recorded no device time in {PROFILER_WINDOWS} windows")


def profile_steps(torch, step, n):
    """Device launches, busy ms and wall ms per step: ``torch.profiler`` over
    ``n`` synchronous calls of ``step(i)``."""
    def read(prof, wall_ms):
        rows = [(e.key, e.count, e.self_device_time_total / 1e3) for e in prof.key_averages()
                if str(e.device_type).endswith("CUDA") and e.self_device_time_total > 0]
        if not rows:
            return None
        busy = sum(r[2] for r in rows)
        return sum(r[1] for r in rows) / n, busy / n, wall_ms / n, rows

    return profile_window(torch, step, n, read)


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


def run_6dof(torch, port, _build, features, calib, evaluate, sixdof, dev, kernels):
    """tests/test_vo_6dof.py's sequences (rendered with numpy) on the card
    against the port's CPU run of the same frames (flags exact, poses within
    SLAM_POSE_ATOL) and held to that test's bars: VO over SIXDOF_VO_FRAMES
    frames (512 features, ``min_matches=10``, the plane's constant
    disparity; ATE and final rotation error), then ``StereoSlam`` over
    SIXDOF_SLAM_FRAMES (384 features, a keyframe every 2nd frame, a window
    of 3, 96 BA landmarks; BM at 16 disparities, block 9, texture 5, speckle
    off: K1 and K2 once a frame, no other kernel; ATE after
    ``optimize_global(iters=5)``, at least 3 keyframes).  Returns (its JSON
    line, launches)."""
    lefts, rights, poses = sixdof
    w, h, fx, b, z0 = (SIXDOF[k] for k in ("width", "height", "fx", "baseline", "Z0"))
    model = planar_model(calib, fx, b, w, h)
    vo_bar, rot_bar, slam_bar = SIXDOF_BARS
    disp = np.full((h, w), fx * b / z0, np.float32)

    def vo_run(d):
        odo = port.StereoVisualOdometry(model, num_features=512, min_matches=10, device=d)
        return [odo.step(left, disp) for left in lefts[:SIXDOF_VO_FRAMES]], odo.state.R_wc

    (vo_card, R_last), (vo_cpu, _) = vo_run(dev), vo_run("cpu")
    for i, (g, c) in enumerate(zip(vo_card, vo_cpu)):
        same_slam_frame(torch, features, {"info": g}, {"info": c}, f"6-dof VO frame {i}",
                        keypoints=False)
        if i and not g["tracked"]:
            raise AssertionError(f"6-dof VO frame {i} lost")
    stamps = np.arange(SIXDOF_VO_FRAMES) * 0.1
    gt_t = np.asarray([t for _, t in poses[:SIXDOF_VO_FRAMES]])
    est = np.stack([g["t_wc"] for g in vo_card])
    vo_ate = evaluate.ate_rmse(evaluate.Trajectory(stamps, est), evaluate.Trajectory(stamps, gt_t))
    R_err = R_last.T @ poses[SIXDOF_VO_FRAMES - 1][0]
    vo_rot = float(np.arccos(np.clip((np.trace(R_err) - 1) / 2, -1, 1)))
    if not (vo_ate < vo_bar and vo_rot < rot_bar):
        raise AssertionError(f"6-dof VO: ATE {vo_ate} m (bar {vo_bar}), rotation {vo_rot} rad "
                             f"(bar {rot_bar})")

    cfg = port.SlamConfig(num_features=384, keyframe_every=2, window_size=3, ba_landmarks=96)
    pcfg = port.PipelineConfig(
        stereobm=port.StereoBMConfig(num_disparities=16, block_size=9, texture_threshold=5),
        speckle=port.SpeckleConfig(max_speckle_size=0))
    frames = [(lft, rgt, 0.1 * i) for i, (lft, rgt) in enumerate(zip(lefts, rights))]
    slam, cpu_slam = (port.StereoSlam(model, cfg, pcfg, device=d) for d in (dev, "cpu"))
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    card = [slam.step(*f) for f in frames]
    torch.cuda.synchronize()
    launches = {k: kern.launches for k, kern in kernels.items()}
    n = len(frames)
    for k, got in launches.items():
        if got != (n if k in ("K1", "K2") else 0):
            raise AssertionError(f"6-dof SLAM: {k} launched {got} times over {n} frames")
    for i, (f, g) in enumerate(zip(frames, card)):
        same_slam_frame(torch, features, {"info": g}, {"info": cpu_slam.step(*f)},
                        f"6-dof SLAM frame {i}", keypoints=False)
        if i and not g["tracked"]:
            raise AssertionError(f"6-dof SLAM frame {i} lost")
    slam.optimize_global(iters=5)
    traj = slam.trajectory()
    slam_ate = evaluate.ate_rmse(
        evaluate.Trajectory(traj.stamps, traj.t),
        evaluate.Trajectory(np.arange(n) * 0.1, np.asarray([t for _, t in poses])))
    if not (slam_ate < slam_bar and len(slam.store) >= 3):
        raise AssertionError(f"6-dof SLAM: ATE {slam_ate} m (bar {slam_bar}), "
                             f"{len(slam.store)} keyframes")
    for s in (slam, cpu_slam):
        s.pipeline.senders.shutdown()
    log(f"6-dof: VO over {SIXDOF_VO_FRAMES} frames and SLAM over {n} match the CPU run; "
        f"VO ATE {vo_ate:.5f} m, rotation {vo_rot:.5f} rad; SLAM ATE {slam_ate:.5f} m, "
        f"{len(slam.store)} keyframes; launches {launches}")
    return {"path": "hard_6dof", "vo_frames": SIXDOF_VO_FRAMES, "vo_ate_m": vo_ate,
            "vo_rotation_err_rad": vo_rot, "slam_frames": n, "slam_ate_m": slam_ate,
            "slam_keyframes": len(slam.store),
            "vo_matches": [g["n_matches"] for g in vo_card],
            "kernel_launches": launches}, launches


def run_hard(torch, port, _build, features, timing, calib, bench, hard, rendered, dev,
             kernels, profile_dir):
    """The layered scene over SGM at W×H (scripts/torch_record_ate_hard.py's
    SGM record, ``hard``: 48 disparities, block 11, texture 10, speckle 200,
    4 paths, P1 10, P2 120; 512 features, a keyframe every 4 frames, a
    window of 5; frames HARD_FRAMES/2 and HARD_FRAMES/2 + 1 degraded, no
    occluders, banding 0.08): ``run_stream(depth=2)`` over every frame with
    the counts set to 0 just before and read just after (each frame
    launches K1 once, for both sides, K3, K4 and K6 once and K5 three
    times; K2, K7 and BL never); then ``detect_loop_closures`` and
    ``optimize_global``.  Fails unless a frame was lost, one relocalized, a
    closure was found and the ATE after ``optimize_global`` is under
    ATE_GATE_M.  Then the card's first HARD_COMPARED frames against the
    port's CPU run of them (as the SLAM phase compares), the bench's
    SLAM-compute chain (the frame step and VO) over those frames at these
    settings under ``torch.cuda.set_sync_debug_mode("error")`` (SGM inside
    the chain makes no host sync), and a profiler window.  Returns (its JSON
    line, launches)."""
    frames, gt, render_s, workers = rendered
    model = planar_model(calib, fx=441.0, baseline=0.1)
    n = len(frames)
    torch.cuda.synchronize()
    _build.reset_launch_counts()
    slam, rec = hard.run_slam(port, frames, gt, model, "sgm", dev)
    torch.cuda.synchronize()
    launches = {k: kern.launches for k, kern in kernels.items()}
    log(f"hard launches over {n} frames: {launches}")
    want = {"K1": n, "K2": 0, "K3": n, "K4": n, "K4 cost": 0, "K5": 3 * n, "K6": n, "K7": 0,
            "BL": 0, "DG": 0}
    for k, w in want.items():
        if launches[k] != w:
            raise AssertionError(f"hard: {k} launched {launches[k]} times, not {w}")
    if rec["frames_run"] != n:
        raise AssertionError(f"hard: {rec['frames_run']} frames of {n} completed")
    bad = hard.gate(rec)
    if rec["lost_frames"] < 1:
        bad.append("no frame lost")
    if bad:
        raise AssertionError(f"hard: {', '.join(bad)}: {rec}")
    log(f"hard: {rec['keyframes']} keyframes, {rec['lost_frames']} lost, "
        f"{rec['relocalized_frames']} relocalized, {rec['loop_closures_detected']} closures "
        f"({rec['loop_closures_used']} used), ATE {rec['ate_rmse_m_before_global']:.5f} m "
        f"before optimize_global and {rec['ate_rmse_m_after_global']:.5f} m after")

    # the card's first frames against the port's CPU run of them
    slam_cfg, pipe_cfg = hard.configs(port, "sgm")
    slams = [slam] + [port.StereoSlam(model, slam_cfg, pipe_cfg, device=d)
                      for d in (dev, "cpu", dev)]
    card = slam_steps(torch, slams[1], frames[:HARD_COMPARED])
    cpu = slam_steps(torch, slams[2], frames[:HARD_COMPARED])
    for i, (g, w) in enumerate(zip(card, cpu)):
        same_slam_frame(torch, features, g, w, f"hard frame {i}")
    log(f"hard: the card's first {HARD_COMPARED} frames match the CPU run (keypoints, "
        f"match counts {[r['info']['n_matches'] for r in cpu]}, keyframes, poses)")
    chain = bench._slam_chain(model, pipe_cfg, dev)
    lefts, rights = (bench._on(dev, [f[k] for f in frames[:HARD_COMPARED]]) for k in (0, 1))
    bench._slam_checksum(chain(lefts, rights))     # warm
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        total = bench._slam_checksum(chain(lefts, rights))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    if not bool(torch.isfinite(total)):
        raise AssertionError(f"hard: SLAM-compute chain checksum {float(total)}")
    log(f"hard: the SGM SLAM-compute chain over {HARD_COMPARED} frames enqueued under "
        f"set_sync_debug_mode('error') with no host sync; checksum {float(total)}")
    launches_per_frame, busy_ms, prof_wall_ms = slam_profile(
        torch, timing, slams[3], frames,
        os.path.join(profile_dir, "hard") if profile_dir else None, "hard")
    for s in slams:
        s.pipeline.senders.shutdown()
    line = {"path": "hard", "frames": n, "size": [W, H], "matcher": "sgm",
            **{k: v for k, v in rec.items() if k != "frames_run"},
            "render_seconds": render_s, "render_workers": workers,
            "device_launches_per_frame": launches_per_frame,
            "device_busy_ms_per_frame": busy_ms,
            "device_busy_share": busy_ms / prof_wall_ms,
            "profiled_wall_ms_per_frame": prof_wall_ms,
            "kernel_launches": launches}
    return line, launches


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


def compare_messages(got, want, label):
    """Two published frames' messages (by output name) equal: images and
    the disparity exact, the point cloud's xyz with equal NaN positions and
    rtol 1e-5 and its packed RGB bitwise, every header and metadata field."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: messages {sorted(got)} vs {sorted(want)}")
    for name, g in got.items():
        w = want[name]
        if type(g) is not type(w) or g.header != w.header:
            raise AssertionError(f"{label} {name}: {type(g).__name__} {g.header} vs "
                                 f"{type(w).__name__} {w.header}")
        if name == "pointcloud":
            pairs = [("rgb", g.rgb.view(np.int32), w.rgb.view(np.int32))]
            ok = (g.xyz.dtype == w.xyz.dtype and np.array_equal(np.isnan(g.xyz), np.isnan(w.xyz))
                  and np.allclose(g.xyz, w.xyz, rtol=1e-5, atol=0, equal_nan=True)
                  and (g.height, g.width) == (w.height, w.width))
        elif name == "disparity":
            pairs = [("image", g.image, w.image)]
            ok = (g.f, g.T, g.min_disparity, g.max_disparity, g.delta_d, g.valid_window) == \
                (w.f, w.T, w.min_disparity, w.max_disparity, w.delta_d, w.valid_window)
        else:
            pairs = [("data", g.data, w.data)]
            ok = (g.height, g.width, g.encoding) == (w.height, w.width, w.encoding)
        for field, a, b in pairs:
            ok = ok and a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        if not ok:
            raise AssertionError(f"{label} {name}: the card's and the CPU's messages differ")


def published(pipe, port, keep):
    """Register a publisher for every output of ``pipe`` that keeps the
    messages of the frames ``keep`` and drops the others, as a node's
    publisher drops a message once it is sent (their pinned memory goes back
    to the cache).  Returns ({(name, header seq): message}, [(name, seq)
    of every message published])."""
    got, seen = {}, []

    def publish(m, name):
        seen.append((name, m.header.seq))
        if m.header.seq in keep:
            got[(name, m.header.seq)] = m

    for name in port.Outputs.all().flags:
        pipe.senders.register(name, lambda m, n=name: publish(m, n))
    return got, seen


def copy_windows(torch, prof):
    """Device→host copies, kernels and host→device copies of a profiler
    window, from its raw events: {"d2h": [(kind, stream, start, end)],
    "h2d_kinds": {kind: n}, "k2_streams": streams that ran the block
    matcher, "kernels": merged (start, end) intervals of every kernel}."""
    d2h, h2d, k2, spans = [], {}, set(), []
    for e in prof.profiler.kineto_results.events():
        if not str(e.device_type()).endswith("CUDA") or e.duration_ns() <= 0:
            continue
        name, a = e.name(), e.start_ns()
        b = a + e.duration_ns()
        stream = e.device_resource_id()
        if name.startswith("Memcpy DtoH"):
            d2h.append((name, stream, a, b))
        elif name.startswith("Memcpy HtoD"):
            h2d[name] = h2d.get(name, 0) + 1
        elif not name.startswith(("Memcpy", "Memset")):
            spans.append((a, b))
            if "bm_fused" in name:
                k2.add(stream)
    merged = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return {"d2h": d2h, "h2d_kinds": h2d, "k2_streams": k2, "kernels": merged}


def link_rates(torch, hostcopy, dev):
    """Device→host MB/s into pinned memory (the publish path's
    ``start_host_copy``) and into pageable memory (``x.cpu()``) of a
    1.44 MB and a 4.33 MB tensor: a fresh tensor each time, after a
    synchronize, host clock, median of LINK_REPS."""
    out = {}
    for label, shape in (("1.44MB", (H, W)), ("4.33MB", (H, W, 3))):
        x = torch.rand(shape, device=dev)
        mb = x.numel() * x.element_size() / 1e6
        for kind, copy in (("pinned", lambda y: hostcopy.start_host_copy(y).result()),
                           ("pageable", lambda y: y.cpu())):
            rates = []
            for i in range(LINK_REPS + 1):
                y = x + float(i)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                copy(y)
                dt = time.perf_counter() - t0
                if i:
                    rates.append(mb / dt)
            out[f"{kind}_MBps_{label}"] = statistics.median(rates)
    return out


def run_publish(torch, port, _build, hostcopy, new_pipe, frames, kernels, dev):
    """The deployed node's path: PUBLISH_FRAMES BM frames at 752×480 on the
    reference's defaults, ``Outputs.all()``, every output published through
    ``enqueue_send`` to registered publishers; counts set to 0 just before
    and read just after (K1 twice, K2 and K3 once a frame), every frame
    after the first (its capture and the first pinned allocations) enqueued
    under
    ``set_sync_debug_mode("error")``.  Gates: frames PUBLISH_CHECKED's
    messages equal the CPU pipeline's; in a profiler window over
    PUBLISH_PROFILED published frames every device→host copy is ``Device
    -> Pinned`` on a stream that ran no block matcher (K2), and no copy is
    pageable either way.  Also: the copy time that overlaps kernels, host ms
    a frame with and without publishing (in turns: on, off, on, off), frame
    0's enqueue apart, and pinned and pageable MB/s.  Returns (its JSON line, launches)."""
    from ros_gpu_stereo_processor_tpu_torch.utils.msgs import Header

    outputs = port.Outputs.all()
    pipe = new_pipe(device=dev)
    got, seen = published(pipe, port, PUBLISH_CHECKED)

    def run(publish, debug=False):
        """Host ms of frame 0's enqueue, and a frame's after it until every
        frame is published (``wait_all``) or done (a synchronize)."""
        torch.cuda.synchronize()
        t0 = t1 = time.perf_counter()
        try:
            for i, (left, right) in enumerate(frames):
                if i == 1:
                    t1 = time.perf_counter()
                    if debug:
                        torch.cuda.set_sync_debug_mode("error")
                res = pipe.process(left, right, outputs, header=Header(seq=i))
                if publish:
                    pipe.enqueue_send(res, outputs)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        if publish:
            pipe.wait_all()
        torch.cuda.synchronize()
        return (t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3 / (len(frames) - 1)

    _build.reset_launch_counts()
    first_ms, main_ms = run(True, debug=True)
    launches = {k: kern.launches for k, kern in kernels.items()}
    log(f"publish launches over {len(frames)} frames: {launches}")
    for k, n in launches.items():
        if n != {"K1": 2, "K2": 1, "K3": 1}.get(k, 0) * len(frames):
            raise AssertionError(f"publish: {k} launched {n} times")
    if len(set(seen)) != len(seen) or len(seen) != len(outputs.flags) * len(frames):
        raise AssertionError(f"publish: {len(seen)} messages for {len(frames)} frames")
    cpu = new_pipe(device="cpu")
    want, _ = published(cpu, port, PUBLISH_CHECKED)
    for i in PUBLISH_CHECKED:
        cpu.enqueue_send(cpu.process(*frames[i], outputs, header=Header(seq=i)), outputs)
    cpu.wait_all()
    for i in PUBLISH_CHECKED:
        compare_messages({n: m for (n, s), m in got.items() if s == i},
                         {n: m for (n, s), m in want.items() if s == i}, f"publish frame {i}")
    log(f"publish: frames {PUBLISH_CHECKED}' messages equal the CPU pipeline's; "
        f"no host sync while enqueuing frames 1-{len(frames) - 1}")

    def step(i):
        left, right = frames[i]
        pipe.enqueue_send(pipe.process(left, right, outputs), outputs)
        if i == PUBLISH_PROFILED - 1:
            pipe.wait_all()

    def read(prof, wall_ms):
        w = copy_windows(torch, prof)
        return w if len(w["d2h"]) >= PUBLISH_COPIES * PUBLISH_PROFILED and w["k2_streams"] \
            else None

    w = profile_window(torch, step, PUBLISH_PROFILED, read)
    kinds = {}
    for kind, _, _, _ in w["d2h"]:
        kinds[kind] = kinds.get(kind, 0) + 1
    copy_streams = {s for _, s, _, _ in w["d2h"]}
    if set(kinds) != {"Memcpy DtoH (Device -> Pinned)"} or copy_streams & w["k2_streams"]:
        raise AssertionError(f"publish: device→host copies {kinds} on streams "
                             f"{sorted(copy_streams)}, the block matcher on "
                             f"{sorted(w['k2_streams'])}")
    if any("Pageable" in k for k in w["h2d_kinds"]):
        raise AssertionError(f"publish: host→device copies {w['h2d_kinds']}")
    d2h_ns = sum(b - a for _, _, a, b in w["d2h"])
    overlap_ns = sum(max(0, min(b, y) - max(a, x))
                     for _, _, a, b in w["d2h"] for x, y in w["kernels"])
    log(f"publish: {kinds} on copy streams {sorted(copy_streams)}, K2 on "
        f"{sorted(w['k2_streams'])}; host→device {w['h2d_kinds']}")

    turns = {"publish": [main_ms], "no_publish": []}
    for key in ("no_publish", "publish", "no_publish"):
        turns[key].append(run(key == "publish")[1])
    link = link_rates(torch, hostcopy, dev)
    line = {"path": "publish", "frames": len(frames), "outputs": "all",
            "ms_per_frame_publish": turns["publish"],
            "ms_per_frame_no_publish": turns["no_publish"],
            "first_frame_ms": first_ms,
            "profiled_frames": PUBLISH_PROFILED,
            "d2h_copies_per_frame": len(w["d2h"]) / PUBLISH_PROFILED,
            "d2h_ms_per_frame": d2h_ns / 1e6 / PUBLISH_PROFILED,
            "d2h_overlapping_kernels_ms_per_frame": overlap_ns / 1e6 / PUBLISH_PROFILED,
            "d2h_kinds": kinds, "h2d_kinds": w["h2d_kinds"], **link,
            "kernel_launches": launches}
    log("publish: " + json.dumps(line))
    return line, launches


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


def same_bits(got, want, label):
    """Two results (dicts of numpy arrays) equal in keys, dtype, shape and
    every bit."""
    if sorted(got) != sorted(want):
        raise AssertionError(f"{label}: keys {sorted(got)} vs {sorted(want)}")
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        if g.shape != w.shape or g.dtype != w.dtype:
            raise AssertionError(f"{label} {k}: {g.shape}/{g.dtype} vs {w.shape}/{w.dtype}")
        gb, wb = (np.ascontiguousarray(a).reshape(-1).view(np.uint8) for a in (g, w))
        if not np.array_equal(gb, wb):
            raise AssertionError(f"{label} {k}: captured and eager differ")


def host_tree(torch, tree):
    """A pytree's tensors as {leaf index: numpy array}."""
    leaves, _ = torch.utils._pytree.tree_flatten(tree)
    return {str(i): x.cpu().numpy() for i, x in enumerate(leaves)}


def dispatch_profile(torch, step, n, per=1):
    """``n`` calls of ``step(i)`` (``per`` frames each) enqueued back to back
    and closed by one synchronize, in a ``torch.profiler`` window: per frame,
    the host calls that enqueue work (the profiler's CUDA runtime and driver
    events named by HOST_CALL_PREFIXES, by name), the device events
    (kernels, memsets, copies: the events on the card) and the device busy
    ms; and the busy share of the window's wall time.  Read from the
    profiler's raw events: building its per-event Python records takes
    tens of seconds for an eager 8-path SGM frame."""
    def read(prof, wall):
        host, events, busy_ns = {}, 0, 0
        for e in prof.profiler.kineto_results.events():
            if str(e.device_type()).endswith("CUDA"):
                if e.duration_ns() > 0:
                    events += 1
                    busy_ns += e.duration_ns()
            elif e.name().startswith(HOST_CALL_PREFIXES):
                host[e.name()] = host.get(e.name(), 0) + 1
        if not events or not host:
            return None
        f, busy = n * per, busy_ns / 1e6
        return {"host_calls_per_frame": sum(host.values()) / f,
                "graph_launches_per_frame": sum(v for k, v in host.items()
                                                if "GraphLaunch" in k) / f,
                "host_calls_by_name": {k: v / f for k, v in sorted(host.items())},
                "device_events_per_frame": events / f,
                "device_busy_ms_per_frame": busy / f,
                "device_busy_share": busy / wall,
                "profiled_wall_ms_per_frame": wall / f}

    return profile_window(torch, step, n, read)


def side_by_side(torch, timing, frames, graph_frame, eager_frame, graph_enqueue,
                 eager_enqueue, dev, per=1, timed_ms=None, profiled=GRAPH_PROFILED):
    """Captured against eager in one call on the same frames: ``timed`` ms
    of a synchronous frame (CUDA events; median and p75; ``timed_ms``: the
    lists already measured, by "captured" and "eager"), pipelined ms a
    frame, and the profiler's host calls, device events and busy share over
    ``profiled`` frames.  ``per``: frames per call."""
    out = {}
    for name, frame, enqueue in (("captured", graph_frame, graph_enqueue),
                                 ("eager", eager_frame, eager_enqueue)):
        ms = timed_ms[name] if timed_ms else [
            timing.timed(lambda: frame(left, right), dev)[1] / per for left, right in frames]
        out[name] = {
            "timed_median_ms": statistics.median(ms),
            "timed_p75_ms": float(np.percentile(ms, 75)),
            "pipelined_ms": pipelined_ms(torch, enqueue, frames) / per,
            **dispatch_profile(torch, lambda i: enqueue(*frames[i % len(frames)]),
                               min(profiled, len(frames)), per),
        }
    return out


def report(label, res, host_max, graph_launches):
    """Log a graphs-phase path, gate its captured host calls and graph
    launches per frame, and return its JSON line."""
    c, e = res["captured"], res["eager"]
    log(f"graphs {label} ({res['seconds']:.1f} s): captured timed median {c['timed_median_ms']:.3f} ms (p75 "
        f"{c['timed_p75_ms']:.3f}), pipelined {c['pipelined_ms']:.3f} ms/frame, "
        f"{c['host_calls_per_frame']:.2f} host calls/frame, {c['device_events_per_frame']:.1f} "
        f"device events/frame, busy {c['device_busy_ms_per_frame']:.3f} ms "
        f"({100 * c['device_busy_share']:.1f} %); eager {e['timed_median_ms']:.3f} ms (p75 "
        f"{e['timed_p75_ms']:.3f}), pipelined {e['pipelined_ms']:.3f}, "
        f"{e['host_calls_per_frame']:.1f} host calls/frame, {e['device_events_per_frame']:.1f} "
        f"device events/frame, busy {e['device_busy_ms_per_frame']:.3f} ms "
        f"({100 * e['device_busy_share']:.1f} %)")
    log(f"  captured host calls by name: {c['host_calls_by_name']}")
    if c["host_calls_per_frame"] > host_max:
        raise AssertionError(f"graphs {label}: {c['host_calls_per_frame']} host calls a "
                             f"frame, more than {host_max}")
    if abs(c["graph_launches_per_frame"] - graph_launches) > 1e-9:
        raise AssertionError(f"graphs {label}: {c['graph_launches_per_frame']} graph launches "
                             f"a frame, not {graph_launches}")
    return {"path": f"graphs {label}", **res}


def graph_pipeline(torch, timing, pipe, frames, outputs, label, encoding="mono8",
                   profiled=GRAPH_PROFILED, cpu=None):
    """One single-device frame path of the graphs phase: every frame
    enqueued (its graph; frame 0 runs eagerly and captures) with its
    FrameResult held (more than ``max_in_flight`` + 2), then each frame's
    eager step timed and each held result fetched and held to it, bit for
    bit, and the first ``len(cpu)`` held to ``cpu`` (the CPU run's outputs of
    those frames) as ``compare_outputs`` holds a frame; one graph; then
    ``timed_process`` over the frames after frame 0 and ``side_by_side``
    (with those and the eager times)."""
    t0 = time.perf_counter()
    if len(frames) <= pipe.config.max_in_flight + 2:
        raise ValueError("hold more frames than max_in_flight + 2")
    held, first_ms = [], None
    for left, right in frames:
        res, first_ms = (pipe.process(left, right, outputs, encoding), first_ms) \
            if held else pipe.timed_process(left, right, outputs, encoding)
        held.append(res)
    ms = {"eager": []}
    for i, (res, (left, right)) in enumerate(zip(held, frames)):
        want, t = timing.timed(lambda: pipe._eager(left, right, outputs, encoding),
                               pipe.device)
        ms["eager"].append(t)
        got = res.fetch()
        same_bits(got, {k: v.cpu().numpy() for k, v in want.items()},
                  f"graphs {label} frame {i}")
        if i < len(cpu or ()):
            compare_outputs(got, cpu[i], f"graphs {label} frame {i} against the CPU run")
    if pipe._get_variant(outputs, encoding).graph_count() != 1:
        raise AssertionError(f"graphs {label}: more than one graph")
    log(f"graphs {label}: {len(frames)} frames held to the end, each equal to the eager "
        f"step bit for bit ({len(cpu or ())} to the CPU run); the first (eager run and "
        f"capture) {first_ms:.1f} ms")
    ms = {"captured": [pipe.timed_process(left, right, outputs, encoding)[1]
                       for left, right in frames[1:]], "eager": ms["eager"][1:]}
    res = side_by_side(
        torch, timing, frames[1:],
        lambda l, r: pipe.process(l, r, outputs, encoding).block_until_ready(),
        lambda l, r: pipe._eager(l, r, outputs, encoding),
        lambda l, r: pipe.process(l, r, outputs, encoding),
        lambda l, r: pipe._eager(l, r, outputs, encoding), pipe.device,
        timed_ms=ms, profiled=profiled)
    return report(label, {"frames": len(frames), "bit_exact": True,
                          "cpu_compared": len(cpu or ()), "first_frame_ms": first_ms,
                          "seconds": time.perf_counter() - t0, **res},
                  GRAPH_HOST_CALLS_MAX, 1)


def graph_batch(torch, timing, pipe, frames, outputs):
    """``process_batch`` of B distinct frames: the first call (eager, then
    the capture) and a replay, both held and each frame equal to its eager
    step bit for bit; one graph launch per batch."""
    t0 = time.perf_counter()
    B = len(frames)
    ls, rs = (np.stack([f[k] for f in frames]) for k in (0, 1))
    first = pipe.process_batch(ls, rs, outputs)
    again = pipe.process_batch(ls, rs, outputs)
    for i, (left, right) in enumerate(frames):
        want = {k: v.cpu().numpy() for k, v in pipe._eager(left, right, outputs,
                                                              "mono8").items()}
        for name, out in (("first", first), ("replay", again)):
            same_bits({k: v[i].cpu().numpy() for k, v in out.items()}, want,
                      f"graphs batch {name} frame {i}")
    log(f"graphs batch: B {B}, the first call and a replay held, each frame equal to the "
        "eager step bit for bit")
    batch = [(ls, rs)] * 3

    def eager(l, r):
        return [pipe._eager(l[i], r[i], outputs, "mono8") for i in range(B)]

    res = side_by_side(torch, timing, batch,
                       lambda l, r: pipe.process_batch(l, r, outputs)["disparity"].sum(),
                       eager, lambda l, r: pipe.process_batch(l, r, outputs), eager,
                       pipe.device, per=B)
    return report(f"batch B{B}", {"frames": B, "bit_exact": True,
                                  "seconds": time.perf_counter() - t0, **res},
                  GRAPH_HOST_CALLS_MAX, 1 / B)


def eager_vo(vo_mod, prev, rect, disp, cam):
    """The VO dispatch's device work run op by op: (TrackedFrame, bundle)."""
    if prev is None:
        kp, pts, pv = vo_mod._vo_first(rect, disp, **cam)
        return vo_mod.TrackedFrame(kp, pts, pv), vo_mod._pack_host_bundle(kp, pts, pv)
    kp, pts, pv, n, R, t, rms = vo_mod._vo_core(prev.kp, prev.pts_cam, prev.pts_valid,
                                                rect, disp, **cam)
    return (vo_mod.TrackedFrame(kp, pts, pv),
            vo_mod._pack_host_bundle(kp, pts, pv, n, R, t, rms))


def graph_vo(torch, port, timing, vo_mod, model, frames, dev):
    """The SLAM-compute chain, frame step and VO, over the planar sequence:
    each VO dispatch (a graph) held to ``_vo_first`` / ``_vo_core`` run
    eagerly on its inputs and previous frame, bit for bit, every frame's
    outputs held to the end; then ``side_by_side`` (a frame: the pipeline's
    graph, the VO's graph, the pinned bundle copy and its wait)."""
    from ros_gpu_stereo_processor_tpu_torch.utils.hostcopy import start_host_copy

    t0 = time.perf_counter()
    pipe = port.StereoPipeline(model, port.PipelineConfig(), device=dev)
    outs = port.Outputs.of("disparity", "rect_mono_left")
    vo = vo_mod.StereoVisualOdometry(model, device=dev)
    cam = dict(k=vo.num_features, threshold=vo.fast_threshold, fx=model.fx,
               cx=model.left.calib.cx, cy=model.left.calib.cy, baseline=model.baseline,
               disparity_offset=model.disparity_offset)
    held = []
    for left, right in frames:
        o = pipe.process(left, right, outs).outputs
        prev = vo.state.prev
        pending = vo.dispatch(o["rect_mono_left"], o["disparity"])
        held.append((pending, host_tree(torch, eager_vo(vo_mod, prev, o["rect_mono_left"],
                                                        o["disparity"], cam))))
    tracked = [vo.complete(p)["tracked"] for p, _ in held]
    for i, ((cur, copy, _), want) in enumerate(held):
        same_bits(host_tree(torch, (cur, torch.from_numpy(copy.result()[0]))), want,
                  f"graphs VO frame {i}")
    if not all(tracked[1:]):
        raise AssertionError(f"graphs VO: tracked {tracked}")
    log(f"graphs VO: {len(frames)} frames held to the end, each dispatch equal to the eager "
        "VO step bit for bit (solve_ex inside the graph); all tracked")
    prev = {"frame": vo.state.prev}

    def eager_enqueue(left, right):
        o = pipe._eager(left, right, outs, "mono8")
        prev["frame"], bundle = eager_vo(vo_mod, prev["frame"], o["rect_mono_left"],
                                         o["disparity"], cam)
        return start_host_copy(bundle)

    def graph_enqueue(left, right):
        o = pipe.process(left, right, outs).outputs
        return vo.dispatch(o["rect_mono_left"], o["disparity"])[1]

    def wait(copy):
        copy.result()                # the bundle copy's event (none on the CPU)

    res = side_by_side(torch, timing, frames[1:],
                       lambda l, r: wait(graph_enqueue(l, r)),
                       lambda l, r: wait(eager_enqueue(l, r)),
                       graph_enqueue, eager_enqueue, dev)
    return report("VO (pipeline + VO step)",
                  {"frames": len(frames), "bit_exact": True,
                   "seconds": time.perf_counter() - t0, **res},
                  GRAPH_SLAM_HOST_CALLS_MAX, 2)


def graph_bench_chains(torch, port, timing, bench, dev):
    """The bench's SLAM-compute chain and compute batch (B frames, each one
    graph) against their eager functions (``Captured.fn``) on the bench's
    inputs: outputs bit for bit (the first call and a replay), then
    ``side_by_side``."""
    model, left, right = bench._model_and_frame()
    cfg = bench._bench_config()
    B = GRAPH_BATCH
    lefts = bench._on(dev, [left + np.uint8(i) for i in range(B)])
    rights = bench._on(dev, [right + np.uint8(i) for i in range(B)])
    lines = []
    for label, unit in (
            ("bench SLAM-compute chain", bench._slam_chain(model, cfg, dev)),
            ("bench compute batch", bench._frame_runner(
                model, cfg, port.Outputs.of("disparity", "pointcloud"), dev))):
        t0 = time.perf_counter()
        want = host_tree(torch, unit.fn(lefts, rights))
        for call in ("first", "replay"):
            same_bits(host_tree(torch, unit(lefts, rights)), want, f"graphs {label} {call}")
        res = side_by_side(torch, timing, [(lefts, rights)] * 3,
                           lambda l, r: unit(l, r), lambda l, r: unit.fn(l, r),
                           lambda l, r: unit(l, r), lambda l, r: unit.fn(l, r), dev, per=B,
                           profiled=1)
        lines.append(report(label, {"frames": B, "bit_exact": True,
                                    "seconds": time.perf_counter() - t0, **res},
                            GRAPH_SLAM_HOST_CALLS_MAX, 1 / B))
    return lines


def run_graphs(torch, port, timing, bench, graphs, speckle_kernel, vo_mod, calib, arrays,
               frames, sframes, slam_frames, cpu_sgm, dev):
    """The compiled dispatch (utils/graphs.py) on the card, each captured
    variant beside its eager step in this call.  First the cooperative
    speckle launch (K3's memset and ``cudaLaunchCooperativeKernel``) and
    ``torch.linalg.solve_ex`` (the PnP's 6×6 solve) captured alone and
    replayed, equal to their eager calls; then, over GRAPH_FRAMES distinct
    frames each: BM at ``Outputs.all()``, BM with ``lr_check``, 4-path SGM
    at 128 disparities, 8-path SGM at 64 and 128, 2-path SGM at 128 (those
    three also equal to the CPU run on their compared frames: ``cpu_sgm``,
    the e2e phases' CPU outputs by path, and one CPU frame of the 8-path
    row at 64), Bayer, the bilateral filter at iters 1;
    ``process_batch`` of GRAPH_BATCH frames; the VO step over the planar
    sequence; the bench's SLAM-compute chain and compute batch.  Each path:
    outputs equal to the eager step bit for bit, every result held to the
    end, ``timed`` median and p75 and pipelined ms a frame, host calls,
    device events and busy share per frame (gated: at most
    GRAPH_HOST_CALLS_MAX host calls a BM or SGM frame, GRAPH_SLAM_HOST_CALLS_MAX
    a SLAM-compute frame, one graph launch a step).  Returns the JSON
    lines."""
    d, v = (port.StereoPipeline.from_arrays(*arrays, device=dev)._eager(
        *frames[0], port.Outputs.of("disparity"), "mono8")[k]
        for k in ("disparity", "disparity_valid"))
    sp = port.SpeckleConfig()
    k3 = graphs.Captured(lambda d, v: speckle_kernel.labels(d, v, sp.max_diff,
                                                            sp.propagation_iters),
                         dev, name="K3 alone")
    want = speckle_kernel.labels(d, v, sp.max_diff, sp.propagation_iters)
    for call in ("first", "replay"):
        require_equal(f"graphs: K3 captured, {call}", k3(d, v), want)
    rng = np.random.default_rng(0)
    m = torch.from_numpy(rng.standard_normal((6, 6)).astype(np.float32)).to(dev)
    a, b = m @ m.T + 6 * torch.eye(6, device=dev), torch.ones(6, device=dev)
    solve = graphs.Captured(lambda a, b: torch.linalg.solve_ex(a, b, check_errors=False).result,
                            dev, name="solve_ex alone")
    want = torch.linalg.solve_ex(a, b, check_errors=False).result
    for call in ("first", "replay"):
        require_equal(f"graphs: solve_ex captured, {call}", solve(a, b).view(torch.int32),
                      want.view(torch.int32))
    log("graphs: the cooperative speckle launch (memset + cudaLaunchCooperativeKernel) and "
        "solve_ex capture; their replays equal the eager calls bit for bit")

    def pipe(**cfg):
        return port.StereoPipeline.from_arrays(*arrays, port.PipelineConfig(**cfg), device=dev)

    def sgm(**kw):
        return {"stereobm": bm(algorithm="sgm", **kw)}

    outputs = port.Outputs.all()
    bm = port.StereoBMConfig
    lines = []
    # the 2- and 8-path rows against the CPU run too: the frames the e2e
    # phases compared (the same frames and config), and one CPU frame at 64
    cpu64 = [port.StereoPipeline.from_arrays(
        *arrays, port.PipelineConfig(**sgm(sgm_paths=8)), device="cpu"
    ).process(*sframes[0], outputs).fetch()]
    for label, cfg, fr, enc, cpu in (
            ("BM", {}, frames, "mono8", None),
            ("BM lr_check", {"stereobm": bm(lr_check=True)}, frames, "mono8", None),
            ("SGM 4 paths 128d", sgm(sgm_paths=4, num_disparities=128), sframes, "mono8",
             None),
            ("SGM 8 paths 64d", sgm(sgm_paths=8), sframes, "mono8", cpu64),
            ("SGM 8 paths 128d", sgm(sgm_paths=8, num_disparities=128), sframes, "mono8",
             cpu_sgm["sgm8"]),
            ("SGM 2 paths 128d", sgm(sgm_paths=2, num_disparities=128), sframes, "mono8",
             cpu_sgm["sgm2"]),
            ("Bayer", {}, frames, "bayer_grbg8", None),
            ("bilateral iters 1", {"bilateral": port.BilateralConfig(enabled=True, iters=1)},
             frames, "mono8", None)):
        lines.append(graph_pipeline(torch, timing, pipe(**cfg), fr[:GRAPH_FRAMES], outputs,
                                    label, enc, cpu=cpu))
    lines.append(graph_batch(torch, timing, pipe(), frames[:GRAPH_BATCH], outputs))
    lines.append(graph_vo(torch, port, timing, vo_mod, planar_model(calib),
                          [(left, right) for left, right, _ in slam_frames[:GRAPH_FRAMES]], dev))
    lines += graph_bench_chains(torch, port, timing, bench, dev)
    return lines


def merge_rounds_run(torch, speckle_kernel, step):
    """One eager mesh frame ``step()`` with the band label rounds' calls
    watched: (calls, calls whose ``done`` flag was 0 at the launch, i.e.
    rounds that ran, times bands).  The flags are read after the frame:
    each round's flag is a tensor of its own, never written again."""
    flags, real = [], speckle_kernel.band_labels

    def watched(lab, conn_x, conn_y, rounds, done=None):
        flags.append(done)
        return real(lab, conn_x, conn_y, rounds, done)

    speckle_kernel.band_labels = watched
    try:
        step()
    finally:
        speckle_kernel.band_labels = real
    torch.cuda.synchronize()
    return len(flags), sum(1 for d in flags if d is None or int(d) == 0)


def check_gated_bl(torch, speckle, speckle_kernel, disp, valid, sp_cfg, dev):
    """The band label rounds' ``done`` gate on the card, on band 1 of a
    BANDS-band split of a BM frame: gated off equals the ungated launch,
    gated on equals a copy of the field, at 2 rounds (the merge loop's) and
    64."""
    hb, w = disp.shape[0] // BANDS, disp.shape[1]
    d, v = disp[hb:2 * hb].contiguous(), valid[hb:2 * hb].contiguous()
    cx, cy = speckle._connectivity(d, v, sp_cfg.max_diff)
    lab = torch.where(v, hb * w + torch.arange(hb * w, dtype=torch.int32, device=dev).reshape(
        hb, w), torch.full((), disp.numel(), dtype=torch.int32, device=dev))
    off, on = (torch.full((), f, dtype=torch.int32, device=dev) for f in (0, 1))
    for rounds in (2, 64):
        want = speckle_kernel.band_labels(lab, cx, cy, rounds)
        got_off = speckle_kernel.band_labels(lab, cx, cy, rounds, off)
        got_on = speckle_kernel.band_labels(lab, cx, cy, rounds, on)
        torch.cuda.synchronize()
        require_equal(f"BL gated off, {rounds} rounds", got_off, want)
        require_equal(f"BL gated on, {rounds} rounds", got_on, lab)
        if torch.equal(want, lab):
            raise AssertionError("BL: the ungated rounds changed nothing, so the gate is untested")
    log(f"BL gate: off equals the ungated launch, on equals a copy of the field "
        f"({hb}x{w}, 2 and 64 rounds)")


def gated_round_cost(torch, port, arrays, make_mesh, frames, outputs, dev):
    """Graph nodes and device µs of one gated merge round: the captured BM
    mesh frame at the default round count (4·BANDS + 8) and at
    GATED_PROBE_ROUNDS (the rounds past the fixed point are gated), each in
    a profiler window; the difference over the extra rounds."""
    out = {}
    for rounds in (4 * BANDS + 8, GATED_PROBE_ROUNDS):
        cfg = port.PipelineConfig(speckle=port.SpeckleConfig(boundary_merge_rounds=rounds))
        pipe = port.StereoPipeline.from_arrays(*arrays, cfg,
                                               mesh=make_mesh(BANDS, devices=[dev] * BANDS))
        pipe.process(*frames[0], outputs).block_until_ready()     # the capture
        out[rounds] = dispatch_profile(torch, lambda i: pipe.process(
            *frames[1 + i % (len(frames) - 1)], outputs), MESH_GRAPH_PROFILED)
        pipe.senders.shutdown()
    lo, hi = (out[r] for r in sorted(out))
    extra = GATED_PROBE_ROUNDS - (4 * BANDS + 8)
    res = {"graph_nodes_per_gated_round": (hi["device_events_per_frame"]
                                           - lo["device_events_per_frame"]) / extra,
           "device_us_per_gated_round": (hi["device_busy_ms_per_frame"]
                                         - lo["device_busy_ms_per_frame"]) * 1e3 / extra,
           "frame_device_events": {str(r): o["device_events_per_frame"] for r, o in out.items()},
           "frame_busy_ms": {str(r): o["device_busy_ms_per_frame"] for r, o in out.items()}}
    log(f"mesh graphs: a gated merge round costs {res['graph_nodes_per_gated_round']:.1f} "
        f"graph nodes and {res['device_us_per_gated_round']:.2f} device us (BM, {BANDS} bands; "
        f"frames at {sorted(out)} rounds: {res['frame_device_events']} device events, "
        f"{res['frame_busy_ms']} busy ms)")
    return res


def run_mesh_graphs(torch, port, timing, speckle_kernel, make_mesh, arrays, frames, sframes,
                    dev):
    """Each single-card mesh variant captured beside its eager step
    (``graph_pipeline``: MESH_GRAPH_FRAMES frames held to the end, each equal
    to the eager step bit for bit, one graph, one graph launch a frame, host
    calls gated, timed and pipelined ms, host calls, device events and busy
    share per frame captured and eager): the BANDS-band BM, BM
    ``lr_check``, 4-path SGM at 128 disparities, the bilateral filter
    (iters 1), and slabs 64/4 and 128/8.  For each, a replay under
    ``set_sync_debug_mode("error")`` (inputs on the card) held to the CPU
    mesh (``compare_outputs``; ``compare_bilateral`` for the bilateral
    filter), and the band label launches of one frame as recorded and as
    run.  Returns the JSON lines."""
    outputs = port.Outputs.all()
    bm = port.StereoBMConfig
    lines = []
    for label, cfg, fr, mode, n in (
            ("mesh BM", {}, frames, "rows", BANDS),
            ("mesh BM lr_check", {"stereobm": bm(lr_check=True)}, frames, "rows", BANDS),
            ("mesh SGM 4 paths 128d", {"stereobm": bm(algorithm="sgm", sgm_paths=4,
                                                      num_disparities=128)}, sframes, "rows",
             BANDS),
            ("mesh bilateral iters 1",
             {"bilateral": port.BilateralConfig(enabled=True, iters=1)}, frames, "rows", BANDS),
            ("slab 64/4", {"stereobm": bm(num_disparities=64)}, frames, "disp", 4),
            ("slab 128/8", {"stereobm": bm(num_disparities=128)}, frames, "disp", 8)):
        config = port.PipelineConfig(**cfg)

        def mesh_pipe(devices):
            return port.StereoPipeline.from_arrays(*arrays, config, shard_mode=mode,
                                                   mesh=make_mesh(n, devices=devices))

        pipe = mesh_pipe([dev] * n)
        fr = fr[:MESH_GRAPH_FRAMES]
        line = graph_pipeline(torch, timing, pipe, fr, outputs, label,
                              profiled=MESH_GRAPH_PROFILED)
        left, right = (torch.from_numpy(x).to(dev) for x in fr[1])
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            res = pipe.process(left, right, outputs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        cpu = mesh_pipe(["cpu"] * n)
        want = cpu.process(*fr[1], outputs).fetch()
        (compare_bilateral if "bilateral" in cfg else compare_outputs)(
            res.fetch(), want, f"{label}: a replay with no host sync, against the CPU mesh")
        recorded, ran = merge_rounds_run(torch, speckle_kernel,
                                         lambda: pipe._eager(*fr[1], outputs, "mono8"))
        log(f"{label}: band label launches a frame {recorded} recorded ({recorded // n} merge "
            f"rounds x {n} bands), {ran} ran ({ran / n:g} rounds before the fixed point)")
        line.update(bands=n, bl_launches_recorded_per_frame=recorded,
                    bl_launches_run_per_frame=ran, no_host_sync_replay=True,
                    replay_equals_cpu_mesh=True)
        lines.append(line)
        for p in (pipe, cpu):
            p.senders.shutdown()
    return lines


def run_ba_graphs(torch, port, timing, calib, frames, dev):
    """The planar SLAM run (``run_stream(depth=2)``) with each windowed BA
    solve recorded: every window's captured result against its eager solve
    (``Captured.fn``) on the same inputs, bit for bit; one graph per window
    shape; BA ms per keyframe (the engine's stage timer), and the solve's
    ms captured (a replay, inputs copied in) beside eager, by CUDA events
    over every window, with host calls and device events per solve from
    the profiler on the last window.  Returns the JSON line."""
    t0 = time.perf_counter()
    slam = port.StereoSlam(planar_model(calib), device=dev)
    solve, windows = slam._ba_solve, []

    def recorded(M):
        entry = solve(M)

        def call(*arrays):
            out = entry(*arrays)
            windows.append((entry, [a.copy() for a in arrays], host_tree(torch, out)))
            return out
        return call

    slam._ba_solve = recorded
    n_frames = len(list(slam.run_stream(iter(frames), depth=2)))
    slam.pipeline.senders.shutdown()
    if not windows:
        raise AssertionError("BA graphs: the planar run solved no window")

    def eager(entry, arrays):
        return entry.fn(*(torch.from_numpy(a).to(dev) for a in arrays))

    ms = {"captured": [], "eager": []}
    for i, (entry, arrays, got) in enumerate(windows):
        same_bits(got, host_tree(torch, eager(entry, arrays)), f"BA window {i}")
        ms["captured"].append(timing.timed(lambda: entry(*arrays), dev)[1])
        ms["eager"].append(timing.timed(lambda: eager(entry, arrays), dev)[1])
    shapes = sorted({arrays[0].shape[0] for _, arrays, _ in windows})
    if len(slam._ba_solves) != len(shapes) or any(
            e.graph_count() != 1 for e in slam._ba_solves.values()):
        raise AssertionError(f"BA graphs: {len(slam._ba_solves)} entries for window sizes "
                             f"{shapes}, graphs {[e.graph_count() for e in slam._ba_solves.values()]}")
    entry, arrays, _ = windows[-1]
    prof = {name: dispatch_profile(torch, lambda i: fn(), 3) for name, fn in (
        ("captured", lambda: entry(*arrays)), ("eager", lambda: eager(entry, arrays)))}
    stage = slam.timer.as_dict()["ba"]
    line = {"path": "graphs BA windows (planar SLAM)", "frames": n_frames,
            "windows": len(windows), "window_sizes": shapes, "bit_exact": True,
            "ba_ms_per_keyframe": stage["mean_ms"], "ba_calls": stage["count"],
            **{f"solve_{k}_median_ms": statistics.median(v) for k, v in ms.items()},
            **{f"solve_{k}_p75_ms": float(np.percentile(v, 75)) for k, v in ms.items()},
            **{f"{k}_{f}": prof[k][f] for k in prof for f in (
                "host_calls_per_frame", "graph_launches_per_frame", "device_events_per_frame",
                "device_busy_ms_per_frame")},
            "seconds": time.perf_counter() - t0}
    log(f"graphs BA: {len(windows)} windows of sizes {shapes} over {n_frames} planar frames, "
        f"each captured solve equal to the eager one bit for bit, {len(slam._ba_solves)} "
        f"graphs; BA {stage['mean_ms']:.3f} ms per keyframe (captures included); the solve "
        f"median {line['solve_captured_median_ms']:.3f} ms captured against "
        f"{line['solve_eager_median_ms']:.3f} eager; host calls a solve "
        f"{line['captured_host_calls_per_frame']:.1f} against "
        f"{line['eager_host_calls_per_frame']:.1f}")
    return line


def run_bench(torch, port, bench, dev):
    """The port's bench, ``python3 -m ros_gpu_stereo_processor_tpu_torch.bench``,
    in a subprocess on the card at the JAX bench's defaults, not cut (B 8,
    64 e2e frames, 24 SLAM frames, 3 repeats).  Gates:
    exit 0; the last line parses and holds at most 1,800 characters; every
    headline metric is present, finite and > 0, each spread's min and max
    too; no ``*_error`` key in either line; the record's launch counts (set
    to 0 at the bench's start) show K1–K6 launched and K7, BL and DG not.  Then,
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
            launches["K7"] or launches["BL"] or launches["DG"]:
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
    from ros_gpu_stereo_processor_tpu_torch.models import vo as vo_mod
    from ros_gpu_stereo_processor_tpu_torch.utils import graphs, hostcopy
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
    slam_frames = start_rendering("render-slam-frames", lambda: render_planar(synth))
    hard = load_script("torch_record_ate_hard")
    hard_frames = start_rendering("render-hard-frames", lambda: render_hard(synth, hard))

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
                     "K4 cost": (sgm_kernel.COST, 0), "K5": (sgm_kernel.AGGREGATE, 3),
                     "DG": (sgm_kernel.DIAGONAL, 0), "K6": (sgm_kernel.WTA, 1)}
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

    # -- SGM over 8 and over 2 paths end to end: DG, K4's cost stage alone ------
    cpu_sgm = {}     # path label -> the CPU run's outputs of its compared frames
    for label, paths, kern in (
            ("sgm8", 8, {"K4": (sgm_kernel.COST_DOWN, 1), "K4 cost": (sgm_kernel.COST, 0),
                         "K5": (sgm_kernel.AGGREGATE, 3), "DG": (sgm_kernel.DIAGONAL, 2)}),
            ("sgm2", 2, {"K4": (sgm_kernel.COST_DOWN, 0), "K4 cost": (sgm_kernel.COST, 1),
                         "K5": (sgm_kernel.AGGREGATE, 2), "DG": (sgm_kernel.DIAGONAL, 0)})):
        with phase(f"SGM {paths} paths e2e", seconds):
            cfg = port.PipelineConfig(stereobm=sgm_bm.replace(sgm_paths=paths))
            ppipe = new_pipe(config=cfg, device=dev)
            pcpu = new_pipe(config=cfg, device="cpu")
            per_frame = {"K1": (k1, 2), "K2": (stereobm_kernel.KERNEL, 0),
                         "K3": (speckle_kernel.KERNEL, 1), "K6": (sgm_kernel.WTA, 1), **kern}
            p_ms, gpu_out, launches[label] = drive(torch, _build, ppipe, sframes, outputs,
                                                   per_frame, SGM_COMPARED)
            log(f"SGM {paths} paths launches over {SGM_FRAMES} frames: {launches[label]}")
            p_pipelined = pipelined(torch, ppipe, sframes, outputs)
            cpu_sgm[label] = [pcpu.process(*sframes[i], outputs).fetch()
                              for i in range(SGM_COMPARED)]
            for i in range(SGM_COMPARED):
                compare_outputs(gpu_out[i], cpu_sgm[label][i], f"SGM {paths} paths frame {i}")
            e2e.append(summary(label, p_ms, p_pipelined))
            if args.profile:
                profile_frames(torch, timing, ppipe, sframes[1:6], outputs,
                               os.path.join(args.profile, label), label)

    # -- the compiled dispatch: captured variants beside the eager step --------
    with phase("graphs", seconds):
        e2e += run_graphs(torch, port, timing, bench, graphs, speckle_kernel, vo_mod, calib,
                          arrays, frames, sframes, slam_frames()[0], cpu_sgm, dev)

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

    # -- the single-card mesh variants and the BA windows as graphs ----------
    with phase("mesh graphs", seconds):
        check_gated_bl(torch, speckle, speckle_kernel, disp, valid, sp, dev)
        e2e += run_mesh_graphs(torch, port, timing, speckle_kernel, make_mesh, arrays, frames,
                               sframes, dev)
        e2e.append({"path": "graphs mesh gated round",
                    **gated_round_cost(torch, port, arrays, make_mesh, frames[:3], outputs,
                                       dev)})
        e2e.append(run_ba_graphs(torch, port, timing, calib, slam_frames()[0], dev))

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

    # -- the publish path: host copies of every output ------------------------
    with phase("publish", seconds):
        pframes = frames + [port.synthetic_stereo_pair(H, W, 48, seed=i)[:2]
                            for i in range(len(frames), PUBLISH_FRAMES)]
        line, launches["publish"] = run_publish(
            torch, port, _build, hostcopy, new_pipe, pframes,
            {"K1": k1, "K2": stereobm_kernel.KERNEL, "K3": speckle_kernel.KERNEL}, dev)
        e2e.append(line)

    for p in pipes:
        p.senders.shutdown()

    # -- the SLAM engine end to end -------------------------------------------
    kernels = {"K1": k1, "K2": stereobm_kernel.KERNEL, "K3": speckle_kernel.KERNEL,
               "K4": sgm_kernel.COST_DOWN, "K4 cost": sgm_kernel.COST,
               "K5": sgm_kernel.AGGREGATE, "K6": sgm_kernel.WTA, "K7": speckle_kernel.MAXPROP,
               "BL": speckle_kernel.BAND_LABELS, "DG": sgm_kernel.DIAGONAL}
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

    # -- the hard scene and the 6-dof sequences ---------------------------------
    with phase("hard 6dof", seconds):
        rendered, sixdof = hard_frames()
        line, launches["hard 6dof"] = run_6dof(torch, port, _build, features, calib, evaluate,
                                               sixdof, dev, kernels)
        e2e.append(line)
    with phase("hard", seconds):
        line, launches["hard"] = run_hard(torch, port, _build, features, timing, calib, bench,
                                          hard, rendered, dev, kernels, args.profile)
        e2e.append(line)

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

    results["K4"]["cost_only"]["launches"] = launches["sgm2"]["K4 cost"]
    kernels = []
    for k in ("K1", "K2", "K3", "K4", "K5", "K6", "K7", "BL", "DG"):
        sym, src, tpu = SOURCES[k]
        path = {"K1": "bm", "K2": "bm", "K3": "bm", "K7": "mesh", "BL": "mesh",
                "DG": "sgm8"}.get(k, "sgm")
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
