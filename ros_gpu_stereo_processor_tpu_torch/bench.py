"""Streaming benchmark of the PyTorch port: dense 752×480 disparity
throughput on one card, end to end through the ingest ring and the
publishers, by stage, SGM, the kernels against their bounds, and SLAM.

    python -m ros_gpu_stereo_processor_tpu_torch.bench [--device {cuda,cpu}]
    tpu-stereo-torch bench [--device {cuda,cpu}]

The port of the JAX engine's root ``bench.py`` (the engine's counterpart of
the reference's DisparityTiming node): the same sections under the same
function names, writing the same record keys.

  * ``value`` (``dense_disparity_fps_752x480_64d``, frames/s/chip): batches
    of B frames (``BENCH_BATCH``, 8) of the frame step (``_pipeline_step``,
    BM defaults, disparity and point cloud), each frame's outputs reduced to
    a float32 checksum on the device and accumulated there, the batch one
    CUDA graph (the JAX bench's jitted ``lax.scan``); ``BENCH_ITERS`` (10)
    batches enqueued back to back, closed by one synchronize.  Nothing in
    the window reads back to the host.  ``vs_baseline`` = fps / 20.
  * ``e2e_fps``: fresh frames through the native ingest ring and its pinned
    uploader (``StreamingIngest.frames_prefetch``), ``process_batch`` of
    ``BENCH_E2E_BATCH`` (8) frames and a ``SenderPool`` worker copying each
    batch's fixed8 disparity wire to the host, over ``BENCH_E2E_FRAMES``
    (64) frames; ``e2e_fps_per_frame_dispatch``: the same with one frame
    step per frame, over ``BENCH_PF_FRAMES`` (24); ``latency_ms_p50/p95``:
    ring push → published, with frames fed at 70 % of that rate.
  * ``stage_ms``: upload, rectify, disparity, disparity_vis, pointcloud and
    the whole step, ms per frame, each stage set run eagerly (the
    reference's TIMING line).
  * ``sgm_ms_64d`` / ``sgm_ms_128d``: the 4-path SGM matcher (K4–K6), ms
    per frame, a batch of B frames one CUDA graph.
  * ``roofline``: K1, K2, K3 and the SGM matcher against their bounds
    (utils/roofline.py), beside the card's name and power limit.
  * ``slam_compute_ms_frame``: the frame step and VO (``_vo_first`` then
    ``_vo_core``) chained over B frames, one CUDA graph; ``slam_fps``:
    ``StereoSlam.run_stream(async_mapping=True)`` over a planar sequence of
    ``BENCH_SLAM_FRAMES`` (24) frames.

Each metric is the median of ``BENCH_REPEATS`` (3) runs, with its min and
max.  A window is closed by ``torch.cuda.synchronize()`` and then read on
the host clock; the roofline's kernels are timed by CUDA events.  On the
card the kernels run (``"kernels": "cuda"``), with ``--device cpu`` their
plain versions (``"kernels": "plain"``); nothing falls back.  The timed
units of work are captured CUDA graphs on the card (``"dispatch":
"graph"``, utils/graphs.py), the functions themselves on the CPU
(``"dispatch": "eager"``).  ``BENCH_E2E``,
``BENCH_STAGES``, ``BENCH_SGM``, ``BENCH_ROOFLINE`` and ``BENCH_SLAM`` set
to ``0`` leave a section out.

Output: the whole record as one JSON line, then, as the last line, a
headline of at most 1,800 characters with the scalar metrics and their
spreads.  A section that raises records ``<section>_error`` and the run
exits 1.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import tempfile
import threading
import time
import traceback

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.config import (
    Outputs, PipelineConfig, SpeckleConfig, StereoBMConfig,
)
from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline, _pipeline_step
from ros_gpu_stereo_processor_tpu_torch.models.vo import _vo_core, _vo_first
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.utils.calib import StereoCameraModel, euroc_like_model
from ros_gpu_stereo_processor_tpu_torch.utils import graphs
from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line, require_device
from ros_gpu_stereo_processor_tpu_torch.utils.hostcopy import start_host_copy, upload
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

BASELINE_FPS = 20.0       # BASELINE.md: > 20 fps dense disparity, 64 candidates
HEADLINE_MAX_CHARS = 1800
# the headline's metrics: each is finite and > 0 in a complete run on the card
HEADLINE_METRICS = (
    "value", "vs_baseline", "e2e_fps", "e2e_fps_per_frame_dispatch", "latency_ms_p50",
    "latency_ms_p95", "link_d2h_MBps", "sgm_ms_64d", "sgm_ms_128d",
    "slam_compute_ms_frame", "slam_fps",
)
SPREADS = {"value": "value_spread", "e2e_fps": "e2e_spread",
           "e2e_fps_per_frame_dispatch": "e2e_pf_spread",
           "sgm_ms_64d": "sgm_ms_64d_spread", "sgm_ms_128d": "sgm_ms_128d_spread",
           "slam_compute_ms_frame": "slam_compute_ms_spread", "slam_fps": "slam_fps_spread"}


def _env(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def _repeats() -> int:
    return _env("BENCH_REPEATS", 3)


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _med_spread(vals):
    s = sorted(vals)
    return s[len(s) // 2], {"min": s[0], "max": s[-1]}


def _model_and_frame():
    """(model, left, right): the JAX bench's distorted EuRoC-like 752×480
    calibration (``utils/calib.py::euroc_like_model``) and a synthetic
    random-dot pair (disparities up to 48)."""
    left, right, _ = synthetic_stereo_pair(480, 752, 48, seed=0)
    return euroc_like_model(), left, right


def _bench_config() -> PipelineConfig:
    """The reference's defaults: 64 disparities, block 15, texture 10,
    speckle 800 px / Δ5, 16 label rounds."""
    return PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10),
        speckle=SpeckleConfig(max_speckle_size=800, max_diff=5.0, propagation_iters=16),
    )


def _on(dev, images) -> torch.Tensor:
    return upload(np.stack(images), dev)


def _checksum(out) -> torch.Tensor:
    """A frame's outputs as one float32 sum on their device (NaN as 0)."""
    return sum(torch.nan_to_num(v.float()).sum() for v in out.values())


def _model_tensors(model, dev):
    return (torch.from_numpy(model.rect_maps_stacked()).to(dev),
            torch.from_numpy(model.Q.astype(np.float32)).to(dev))


def _frame_runner(model, cfg: PipelineConfig, outputs: Outputs, dev):
    """The compute section's unit of work: ``run(lefts, rights)`` enqueues
    one frame step per frame of the (B, H, W) stacks and returns the frames'
    checksums stacked on the device; on the card the batch is one captured
    graph (the JAX bench's jitted ``lax.scan``)."""
    maps, Q = _model_tensors(model, dev)

    def run(lefts, rights):
        return torch.stack([
            _checksum(_pipeline_step(lefts[i], rights[i], maps, Q, encoding="mono8",
                                     outputs=outputs, bm=cfg.stereobm, speckle=cfg.speckle))
            for i in range(len(lefts))])

    return graphs.Captured(run, dev, name="bench compute batch")


def _enqueue_batches(run, lefts, rights, iters: int) -> torch.Tensor:
    """The compute section's timed window, less its closing synchronize:
    ``iters`` batches enqueued back to back; the last batch's total."""
    last = None
    for _ in range(iters):
        last = run(lefts, rights).sum()
    return last


def _compute_metric(model, left, right, cfg, outputs, dev):
    """Streaming compute throughput: batches of frames kept in flight,
    outputs reduced to on-device checksums (host I/O off the clock).
    Returns (fps, spread)."""
    B = _env("BENCH_BATCH", 8)
    lefts, rights = _on(dev, [left] * B), _on(dev, [right] * B)
    run = _frame_runner(model, cfg, outputs, dev)
    for _ in range(2):            # warm-up: builds, caches and first runs off the clock
        run(lefts, rights).sum()
        _sync(dev)
    iters = _env("BENCH_ITERS", 10)
    fps_runs = []
    for _ in range(_repeats()):
        t0 = time.perf_counter()
        _enqueue_batches(run, lefts, rights, iters)
        _sync(dev)
        fps_runs.append(iters * B / (time.perf_counter() - t0))
    return _med_spread(fps_runs)


def _feeder(ing, left, right, n: int, base_stamp: float, pace_s: float = 0.0,
            push_t=None) -> threading.Thread:
    """A started thread feeding ``n`` pairs into ``ing`` (every ``pace_s``
    seconds when > 0, else as fast as the ring takes them), recording each
    pair's push time in ``push_t`` by sequence number."""
    def feed():
        stamp, next_t = base_stamp, time.perf_counter()
        for i in range(n):
            if pace_s:
                now = time.perf_counter()
                if now < next_t:
                    time.sleep(next_t - now)
                next_t += pace_s
            if push_t is not None:
                push_t[i] = time.perf_counter()
            ing.feed("left", left, stamp)
            ing.feed("right", right, stamp)
            stamp += 0.05

    t = threading.Thread(target=feed, daemon=True, name="bench-feeder")
    t.start()
    return t


def _e2e_metric(model, left, right, cfg, dev):
    """End-to-end streaming: native ring → pinned upload → pipeline → async
    publish (device→host copy into pinned memory started at enqueue, the
    message built on a sender worker), every boundary the
    reference's TIMING line crosses.  Returns (batched fps + spread,
    per-frame fps + spread, d2h MB/s or None on the CPU, (p50, p95) ms,
    point-cloud bytes, latency budget)."""
    from ros_gpu_stereo_processor_tpu_torch.runtime import StreamingIngest
    from ros_gpu_stereo_processor_tpu_torch.utils.msgs import SenderPool, disparity_fixed8

    # the disparity and the point cloud are computed; the disparity is
    # published, as the reference's primary topic, on the fixed8 wire
    outputs = Outputs.of("disparity", "pointcloud")
    pipe = StereoPipeline(model, cfg.replace(max_in_flight=4), device=dev)
    shape = left.shape
    B = _env("BENCH_E2E_BATCH", 8)
    n_frames = max(B, (_env("BENCH_E2E_FRAMES", 64) // B) * B)
    cuda = dev.type == "cuda"

    def wire(disp):
        """The fixed8 wire of ``disp`` and the event its host copy waits on
        (None on the CPU): recorded after ``disparity_fixed8``, so the copy
        never reads an unwritten wire."""
        w = disparity_fixed8(disp)
        ev = None
        if cuda:
            ev = torch.cuda.Event()
            ev.record()
        return w, ev

    def run(n, base_stamp):
        """Wall seconds to push ``n`` frames through and publish them: the
        feeder fills the ring, the ingest uploader stages stacked pinned
        pairs, the consumer stacks B staged pairs on the device and runs ONE
        ``process_batch``, its host copy starts at enqueue, sender workers
        split the batch."""
        pool = SenderPool(max_workers=3)
        t0 = time.perf_counter()
        ing = StreamingIngest(shape, capacity=2 * B, drop_on_full=False, device=dev)
        ft = _feeder(ing, left, right, n, base_stamp)
        frames = ing.frames_prefetch(timeout=1.0, depth=B + 2, stacked=True)
        got_l, got_r, inflight, done = [], [], [], 0
        for l_d, r_d, _, _ in frames:
            got_l.append(l_d)
            got_r.append(r_d)
            if len(got_l) == B:
                out = pipe.process_batch(torch.stack(got_l), torch.stack(got_r), outputs)
                got_l, got_r = [], []
                w, ev = wire(out["disparity"])
                inflight.append(pool.enqueue(
                    "disparity", w, lambda d: [d[i] for i in range(d.shape[0])], ready=ev))
                if len(inflight) > 3:
                    inflight.pop(0).result()
                done += B
                if done >= n:
                    break
        pool.wait_all()
        dt = time.perf_counter() - t0
        frames.close()           # the uploader's last empty wait stays off the clock
        ft.join()
        pool.shutdown()
        return dt

    run(2 * B, 0.0)              # warm-up
    e2e_runs = [n_frames / run(n_frames, 1000.0 * (rep + 1)) for rep in range(_repeats())]
    batched = _med_spread(e2e_runs)

    # one frame step per frame (the reference's deployment shape, one
    # imageCb per pair); upload, compute and publish overlap, and each
    # frame's latency is ring push → its publish built
    n_pf = min(_env("BENCH_PF_FRAMES", 24), n_frames)

    def run_per_frame(n, pace_s=0.0):
        ing = StreamingIngest(shape, capacity=6, drop_on_full=False, device=dev)
        snd = SenderPool(max_workers=3)
        push_t, yield_t, done_t = {}, {}, {}

        def published(seq):
            def build(d):
                done_t[seq] = time.perf_counter()
                return d
            return build

        t0 = time.perf_counter()
        ft = _feeder(ing, left, right, n, 0.0, pace_s, push_t)
        futs = []
        frames = ing.frames_prefetch(timeout=1.0, depth=3, stacked=True)
        for l_d, r_d, _, seq in frames:
            yield_t[seq] = time.perf_counter()
            w, ev = wire(pipe._step(l_d, r_d, outputs, "mono8")["disparity"])
            futs.append(snd.enqueue("disparity", w, published(seq), ready=ev))
            if len(futs) > 4:
                futs.pop(0).result()
            if seq == n - 1:
                break
        snd.wait_all()
        fps = len(done_t) / (max(done_t.values()) - t0)
        frames.close()
        ft.join()
        snd.shutdown()
        lats = sorted((done_t[s] - push_t[s]) * 1e3 for s in done_t)
        # ring push → staged frame yielded, and dispatch → published, medians
        up = sorted((yield_t[s] - push_t[s]) * 1e3 for s in yield_t)
        pub = sorted((done_t[s] - yield_t[s]) * 1e3 for s in done_t)
        budget = {"upload_ms_p50": up[len(up) // 2],
                  "dispatch_to_publish_ms_p50": pub[len(pub) // 2]}
        return fps, lats, budget

    run_per_frame(min(4, n_pf))   # warm-up
    pf = _med_spread([run_per_frame(n_pf)[0] for _ in range(_repeats())])
    # latency paced BELOW capacity (~70 %), so the percentiles measure the
    # path (upload → compute → publish), not queueing in the ring
    _, lats, budget = run_per_frame(n_pf, pace_s=1.0 / max(1.0, 0.7 * pf[0]))
    lat = (lats[len(lats) // 2], lats[min(len(lats) - 1, int(len(lats) * 0.95))])
    budget["wire"] = "fixed8_u8"
    budget["wire_bytes_frame"] = int(np.prod(shape))

    # the link's device→host rate as the node copies: the publish path's
    # pinned copy on the copy stream (utils/hostcopy.py); a fresh tensor
    # each time, after a synchronize, so the copy alone is on the clock
    # (none on the CPU)
    d2h = None
    if cuda:
        d2h_runs = []
        for i in range(_repeats()):
            x = pipe.process(left, right, outputs).outputs["disparity"] + float(i)
            _sync(dev)
            t0 = time.perf_counter()
            start_host_copy(x).result()
            d2h_runs.append(x.numel() * x.element_size() / (time.perf_counter() - t0) / 1e6)
        d2h, _ = _med_spread(d2h_runs)

    # the point cloud's wire cost, from a real frame's valid points: the
    # organized H×W xyz+rgb PointCloud2 against valid points only
    xyz = pipe.process(left, right, outputs).fetch()["pointcloud_xyz"]
    pc_bytes = {"organized": xyz.shape[0] * xyz.shape[1] * 16,
                "packed_valid": int(np.isfinite(xyz[..., 2]).sum()) * 16}
    pipe.senders.shutdown()
    return batched, pf, d2h, lat, pc_bytes, budget


def _sgm_runner(cfg: StereoBMConfig):
    """The SGM section's unit of work: ``run(lefts, rights)`` → each frame's
    ``sum(disparity) + sum(valid)`` from the fused 4-path SGM (P1 10, P2
    120), stacked on the device; a batch on the card is one captured graph
    (on the device of the stacks)."""
    from ros_gpu_stereo_processor_tpu_torch.ops.sgm_kernel import compute_disparity_sgm_fused

    def run(lefts, rights):
        sums = []
        for i in range(len(lefts)):
            d, v = compute_disparity_sgm_fused(lefts[i], rights[i], cfg)
            sums.append(d.sum() + v.sum())
        return torch.stack(sums)

    return graphs.Captured(run, name="bench SGM batch")


def _sgm_metric(model, left, right, dev, ndisp=64):
    """Per-frame ms of the fused SGM matcher (K4–K6) at ``ndisp``
    disparities (64 and 128 are recorded: the reference's reconfigure
    schema caps the range at 128).  Returns (ms, spread)."""
    cfg = StereoBMConfig(num_disparities=ndisp, block_size=15, texture_threshold=10)
    B = _env("BENCH_BATCH", 8)
    lefts = _on(dev, [left + np.uint8(i) for i in range(B)])
    rights = _on(dev, [right + np.uint8(i) for i in range(B)])
    run = _sgm_runner(cfg)
    for i in range(3):
        run(lefts + (7 + i), rights + (7 + i)).sum()
        _sync(dev)
    iters = _env("BENCH_SGM_ITERS", 6)
    ms_runs = []
    for _ in range(_repeats()):
        t0 = time.perf_counter()
        for i in range(iters):
            run(lefts + i, rights + i).sum()
        _sync(dev)
        ms_runs.append((time.perf_counter() - t0) / (iters * B) * 1e3)
    return _med_spread(ms_runs)


def _per_call_ms(fn, iters: int, dev) -> float:
    """Median over the repeats of ms per call of ``fn()`` run ``iters``
    times back to back: CUDA events on the card (the host's enqueue shows
    only where it is slower than the device), the host clock on the CPU."""
    fn()
    _sync(dev)
    runs = []
    for _ in range(_repeats()):
        if dev.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) / iters * 1e3)
    return _med_spread(runs)[0]


def _rounds_needed(labels, large: int) -> int:
    """The least round count whose labels equal those at ``large`` (the
    walk is monotone in the count, so bisect)."""
    full = labels(large)
    lo, hi = 1, large
    while lo < hi:
        mid = (lo + hi) // 2
        if torch.equal(labels(mid), full):
            hi = mid
        else:
            lo = mid + 1
    return lo


def _kernel_roofline(model, left, right, cfg, dev, sgm64_ms, sgm128_ms):
    """Each kernel of the BM path called alone through its wrapper (K1
    rectify of both sides, K2 on the prefiltered pair, K3 on the matched
    disparity), and the SGM matcher's per-frame ms from its section, against
    the bounds of utils/roofline.py."""
    from ros_gpu_stereo_processor_tpu_torch.ops import (
        remap_kernel, sgm_kernel, speckle_kernel, stereobm, stereobm_kernel,
    )
    from ros_gpu_stereo_processor_tpu_torch.utils import roofline as rl

    H, W = left.shape
    bm, sp = cfg.stereobm, cfg.speckle
    nd = bm.num_disparities
    iters = _env("BENCH_ROOF_ITERS", 6)
    maps, _ = _model_tensors(model, dev)
    raw = _on(dev, [left, right])
    rect = remap_kernel.rectify(raw, maps)
    lf, rf = stereobm.prefilter(rect[0], bm), stereobm.prefilter(rect[1], bm)
    disp, valid = stereobm_kernel.compute_disparity_fused(rect[0], rect[1], bm)

    out = {"chip": card_line() if dev.type == "cuda" else "cpu",
           "model": f"utils/roofline.py's {rl.H100_SXM['name']}; measured_ms by "
                    + ("CUDA events" if dev.type == "cuda" else "the host clock")}
    out["remap"] = rl.roofline(
        rl.remap_model(H, W), _per_call_ms(lambda: remap_kernel.rectify(raw, maps), iters, dev))
    out["stereobm"] = rl.roofline(
        rl.stereobm_fused_model(H, W, nd),
        _per_call_ms(lambda: stereobm_kernel.fused_raw(lf, rf, bm), iters, dev))
    out["stereobm"].update(rl.stereobm_structure_floor(nd, bm.block_size))
    k = sp.propagation_iters
    rounds = _rounds_needed(lambda r: speckle_kernel.labels(disp, valid, sp.max_diff, r), k)
    out["speckle"] = rl.roofline(
        rl.speckle_model(H, W, rounds),
        _per_call_ms(lambda: speckle_kernel.labels(disp, valid, sp.max_diff, k), iters, dev))
    out["speckle"].update(rl.speckle_structure_analysis(rounds, k))
    for key, n, ms in (("sgm_64d", 64, sgm64_ms), ("sgm_128d", 128, sgm128_ms)):
        if ms is not None:
            c = StereoBMConfig(num_disparities=n, block_size=15)
            cdt, edt = sgm_kernel.storage_dtypes(c, 10.0, 120.0, True)
            out[key] = rl.roofline(rl.sgm_fused_model(H, W, n, cdt.itemsize, edt.itemsize), ms)
    return out


def _slam_chain(model, cfg: PipelineConfig, dev):
    """The SLAM-compute section's unit of work: ``run(lefts, rights)`` runs
    the frame step (disparity and the left rectified image) on every frame,
    ``_vo_first`` on the first and ``_vo_core`` on each later one, the
    tracked state carried along (the dependency chain ``StereoSlam``
    executes), and returns each ``_vo_core``'s (n, R, t, rms) on the
    device; on the card the whole chain is one captured graph (the JAX
    bench's jitted scan)."""
    maps, Q = _model_tensors(model, dev)
    outputs = Outputs.of("disparity", "rect_mono_left")
    cam = dict(k=512, threshold=20.0, fx=model.fx, cx=model.left.calib.cx,
               cy=model.left.calib.cy, baseline=model.baseline,
               disparity_offset=model.disparity_offset)

    def dense(left, right):
        out = _pipeline_step(left, right, maps, Q, encoding="mono8", outputs=outputs,
                             bm=cfg.stereobm, speckle=cfg.speckle)
        return out["rect_mono_left"], out["disparity"]

    def run(lefts, rights):
        kp, pts, pv = _vo_first(*dense(lefts[0], rights[0]), **cam)
        steps = []
        for i in range(1, len(lefts)):
            kp, pts, pv, n, R, t, rms = _vo_core(kp, pts, pv, *dense(lefts[i], rights[i]),
                                                 **cam)
            steps.append((n, R, t, rms))
        return steps

    return graphs.Captured(run, dev, name="bench SLAM-compute chain")


def _slam_checksum(steps) -> torch.Tensor:
    return torch.stack([n.float() + R.sum() + t.sum() + rms for n, R, t, rms in steps]).sum()


def _slam_compute_metric(model, left, right, cfg, dev):
    """Device-bound SLAM step time: the frame step and the VO step chained
    over B frames with the tracked state carried along; host I/O off the
    clock.  Counts B frames per run (B − 1 VO steps and the bootstrap).
    Returns (ms per frame, spread)."""
    B = _env("BENCH_BATCH", 8)
    lefts = _on(dev, [left + np.uint8(i) for i in range(B)])
    rights = _on(dev, [right + np.uint8(i) for i in range(B)])
    run = _slam_chain(model, cfg, dev)
    for _ in range(2):
        _slam_checksum(run(lefts, rights))
        _sync(dev)
    iters = _env("BENCH_SLAM_COMPUTE_ITERS", 6)
    ms_runs = []
    for _ in range(_repeats()):
        t0 = time.perf_counter()
        for _ in range(iters):
            _slam_checksum(run(lefts, rights))
        _sync(dev)
        ms_runs.append((time.perf_counter() - t0) / (iters * B) * 1e3)
    return _med_spread(ms_runs)


def _slam_metric(dev, shape):
    """SLAM throughput: ``StereoSlam.run_stream(async_mapping=True)`` fps over
    a planar sequence (``utils/synth.py::make_planar_euroc``, fx 441 at 752
    wide, radius 0.25), BM defaults, 512 features, a keyframe every 2nd
    frame (the BA window fills during the warm-up); three contiguous chunks
    of the frames after the warm-up are the repeats.  Returns (fps, spread,
    ms by stage of the engine's own timer)."""
    from ros_gpu_stereo_processor_tpu_torch.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu_torch.utils.io import EurocReader
    from ros_gpu_stereo_processor_tpu_torch.utils.synth import make_planar_euroc

    H, W = shape
    n = _env("BENCH_SLAM_FRAMES", 24)
    with tempfile.TemporaryDirectory(prefix="bench_slam_") as root:
        cl, cr = make_planar_euroc(root, n_frames=n, width=W, height=H, fx=441.0 * W / 752,
                                   radius=0.25)
        model = StereoCameraModel.from_files(cl, cr)
        frames = [(fr.left, fr.right, fr.stamp) for fr in EurocReader(root)]
    slam = StereoSlam(model, SlamConfig(num_features=512, keyframe_every=2),
                      pipeline_config=_bench_config(), device=dev)
    warm = min(10, len(frames) // 2)
    for f in frames[:warm]:
        slam.step(*f)
    slam.timer.stages.clear()
    timed = frames[warm:]
    k = max(1, len(timed) // 3)
    fps_runs = []
    for c in range(3):
        chunk = timed[c * k:(c + 1) * k]
        if not chunk:
            continue
        t0 = time.perf_counter()
        for _ in slam.run_stream(iter(chunk), async_mapping=True):
            pass
        fps_runs.append(len(chunk) / (time.perf_counter() - t0))
    slam.pipeline.senders.shutdown()
    fps, spread = _med_spread(fps_runs)
    stages = {name: st.total_ms / max(1, st.count) for name, st in slam.timer.stages.items()}
    return fps, spread, stages


def _stage_breakdown(model, left, right, cfg, dev):
    """ms per frame of each stage set (the reference's TIMING line: upload,
    rectify, disparity, disparity_vis, pointcloud, total), each run
    eagerly, op by op, as the reference times its stages; each window of
    ``BENCH_STAGE_ITERS`` steps closed by a synchronize; every step's
    outputs reduced to an on-device checksum.  ``upload`` copies both
    host frames through pinned staging (a host copy into a pinned tensor,
    then the device copy), as ``StereoPipeline.process`` does;
    ``upload_pinned`` (card only) one (2, H, W) pinned buffer, as the
    ingest uploader does.  Returns (ms by stage, spread by stage)."""
    iters = _env("BENCH_STAGE_ITERS", 10)
    pipe = StereoPipeline(model, cfg, device=dev)
    stages = {
        "rectify": Outputs.of("rect_mono_left", "rect_mono_right"),
        "disparity": Outputs.of("disparity"),
        "disparity_vis": Outputs.of("disparity_vis"),
        "pointcloud": Outputs.of("pointcloud"),
        "total": Outputs.of("disparity", "disparity_vis", "pointcloud"),
    }

    def window_ms(fn):
        fn()
        _sync(dev)
        runs = []
        for _ in range(_repeats()):
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            _sync(dev)
            runs.append((time.perf_counter() - t0) / iters * 1e3)
        return _med_spread(runs)

    out, spread = {}, {}
    out["upload"], spread["upload"] = window_ms(
        lambda: (pipe._to_device(left), pipe._to_device(right)))
    if dev.type == "cuda":
        pinned = torch.from_numpy(np.stack([left, right])).pin_memory()
        out["upload_pinned"], spread["upload_pinned"] = window_ms(
            lambda: pinned.to(dev, non_blocking=True))
    l_d, r_d = pipe._to_device(left), pipe._to_device(right)
    for name, o in stages.items():
        out[name], spread[name] = window_ms(
            lambda o=o: _checksum(pipe._eager(l_d, r_d, o, "mono8")))
    pipe.senders.shutdown()
    return out, spread


def _section(record, name, fn) -> None:
    """Run one section; a failure is recorded as ``<name>_error`` (its
    traceback goes to stderr) and the run goes on, to exit 1 at the end."""
    try:
        fn()
    except Exception as e:
        traceback.print_exc()
        record[f"{name}_error"] = f"{type(e).__name__}: {e}"[:300]


def _headline(record) -> dict:
    """The record's scalar metrics and their spreads (no ``roofline`` or
    ``stage_ms``), in at most HEADLINE_MAX_CHARS characters of JSON."""
    def short(x):
        if isinstance(x, float) and math.isfinite(x):
            return float(f"{x:.6g}")
        if isinstance(x, dict):
            return {k: short(v) for k, v in x.items()}
        return x

    head = {k: record[k] for k in ("metric", "unit", "kernels", "dispatch", "repeats")
            if k in record}
    head["device"] = record["device"].get("card", record["device"]["platform"])
    for k in HEADLINE_METRICS:
        if k in record:
            head[k] = short(record[k])
        if k in SPREADS and SPREADS[k] in record:
            head[SPREADS[k]] = short(record[SPREADS[k]])
    errors = {k: v for k, v in record.items() if k.endswith("_error")}
    head.update(errors)
    room = max(map(len, errors.values()), default=0)
    while len(json.dumps(head)) > HEADLINE_MAX_CHARS and room:
        room //= 2                     # only error texts can make it this long
        head.update({k: v[:room] for k, v in errors.items()})
    return head


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bench", description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where every section runs (default: the card)")
    args = ap.parse_args(argv)
    dev = require_device(args.device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    model, left, right = _model_and_frame()
    cfg = _bench_config()
    outputs = Outputs.of("disparity", "pointcloud")
    H, W = left.shape
    device = {"platform": "cpu"}
    if dev.type == "cuda":
        device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                  "card": card_line()}
    record = {"metric": "dense_disparity_fps_752x480_64d", "unit": "frames/s/chip",
              "shape": [H, W], "repeats": _repeats(),
              "kernels": "cuda" if dev.type == "cuda" else "plain",
              "dispatch": "graph" if dev.type == "cuda" else "eager", "device": device}
    _build.reset_launch_counts()

    def compute():
        fps, spread = _compute_metric(model, left, right, cfg, outputs, dev)
        record.update(value=fps, vs_baseline=fps / BASELINE_FPS, value_spread=spread)

    def e2e():
        batched, pf, d2h, lat, pc_bytes, budget = _e2e_metric(model, left, right, cfg, dev)
        record.update(
            e2e_fps=batched[0], e2e_spread=batched[1],
            e2e_wire={"batched": "fixed8_u8", "per_frame": "fixed8_u8"},
            e2e_vs_baseline=batched[0] / BASELINE_FPS,
            e2e_fps_per_frame_dispatch=pf[0], e2e_pf_spread=pf[1],
            latency_ms_p50=lat[0], latency_ms_p95=lat[1], latency_budget=budget,
            link_d2h_MBps=d2h, pc2_bytes_frame=pc_bytes)

    def stages():
        record["stage_ms"], record["stage_ms_spread"] = _stage_breakdown(
            model, left, right, cfg, dev)
        record["stage_upload_memory"] = {k: "pinned" if k.endswith("pinned") else "staged"
                                         for k in record["stage_ms"] if k.startswith("upload")}

    def sgm():
        for nd in (64, 128):
            ms, spread = _sgm_metric(model, left, right, dev, ndisp=nd)
            record[f"sgm_ms_{nd}d"], record[f"sgm_ms_{nd}d_spread"] = ms, spread

    def roof():
        record["roofline"] = _kernel_roofline(model, left, right, cfg, dev,
                                              record.get("sgm_ms_64d"),
                                              record.get("sgm_ms_128d"))

    def slam_compute():
        ms, spread = _slam_compute_metric(model, left, right, cfg, dev)
        record.update(slam_compute_ms_frame=ms, slam_compute_ms_spread=spread,
                      slam_compute_fps=1e3 / ms,
                      slam_compute_realtime_20fps=bool(1e3 / ms >= BASELINE_FPS))

    def slam():
        fps, spread, stage = _slam_metric(dev, (H, W))
        record.update(slam_fps=fps, slam_fps_spread=spread, slam_stage_ms=stage,
                      slam_realtime_20fps=bool(fps >= BASELINE_FPS))

    _section(record, "compute", compute)
    for env, name, fn in (("BENCH_E2E", "e2e", e2e), ("BENCH_STAGES", "stage", stages),
                          ("BENCH_SGM", "sgm", sgm), ("BENCH_ROOFLINE", "roofline", roof),
                          ("BENCH_SLAM", "slam_compute", slam_compute),
                          ("BENCH_SLAM", "slam", slam)):
        if os.environ.get(env, "1") == "1":
            _section(record, name, fn)
    record["kernel_launches"] = {sym: k.launches for sym, k in sorted(_build.kernels().items())}
    print(json.dumps(record), flush=True)
    print(json.dumps(_headline(record)), flush=True)
    return 1 if any(k.endswith("_error") for k in record) else 0


if __name__ == "__main__":
    sys.exit(main())
