#!/usr/bin/env python3
"""The port's publish path on a CUDA card: where the bench's streaming
consumer waits, where the device→host copies sit against the frame graphs,
and what publishing every output of a frame costs.

    python3 scripts/torch_publish.py [--root DIR] [--sections profile,publish,link,bench,serve]
                                     [--out FILE]

Run on a machine with an H100, ``nvcc`` and PyTorch built for CUDA.
``--root`` names the checkout whose ``ros_gpu_stereo_processor_tpu_torch``
is imported (default: this one), so two commits are compared by running the
script once per checkout, in turns, on one machine.  Only entry points both
checkouts have are called.  Sections (default: all):

  * ``profile``: the port bench's streaming section (``bench._e2e_metric``:
    the batched ``run`` and the per-frame ``run_per_frame``) at 32 and 16
    frames, one repeat.  First with every blocking call of each host thread
    timed (the feeder's ring pushes, the uploader's ring peeks, event waits
    and queue puts, the consumer's wait for a staged frame, its dispatch,
    its enqueue of the publish and its wait on the oldest publish, a sender
    worker's event wait and device→host copy): seconds by thread and call.
    Then again in a ``torch.profiler`` window (CPU and CUDA): every
    device→host copy by kind (``Device -> Pinned`` or ``Device ->
    Pageable``) and stream, how many frames' block matcher (K2) launches
    ran between a copy's issue and its start (a copy queued behind later
    frames), and the copy time that overlaps kernels.
  * ``publish``: 64 block-matching frames at 752×480 on the reference's
    defaults with ``Outputs.all()``, back to back, each run on a new
    pipeline: host ms a frame with every output published through
    ``enqueue_send`` and registered publishers (closed by ``wait_all``)
    against the same frames with no publish (closed by a synchronize), in
    turns (off, on, on, off); the first frame (its capture, and the first
    pinned allocations) apart; then one more published run in a
    ``torch.profiler`` window: the CUDA runtime calls a frame makes, by
    name, with their host ms (``cudaHostAlloc`` is a new pinned block).
  * ``link``: device→host MB/s of a 1.44 MB (the float32 disparity) and a
    4.33 MB (the xyz point cloud) tensor into pageable memory (``x.cpu()``)
    and into pinned memory (a non-blocking copy into a pinned tensor), each
    after a synchronize, host clock, median of 20.
  * ``bench``: the checkout's bench (``python3 -m
    ros_gpu_stereo_processor_tpu_torch.bench``) in a subprocess with its
    compute and e2e sections only: ``value``, ``e2e_fps``,
    ``latency_ms_p50/p95``, ``link_d2h_MBps``.
  * ``serve``: ``chip_smoke.run_serve`` (this checkout's) on the checkout's
    package: the serve daemon over 20 PNG pairs, fps and p50 / p95
    dispatch→publish.

One JSON line per section (with the checkout and the card's name and power
limit), also appended to ``--out``.
"""

from __future__ import annotations

import argparse
import collections
import concurrent.futures
import contextlib
import functools
import json
import os
import queue
import runpy
import statistics
import subprocess
import sys
import tempfile
import threading
import time


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SECTIONS = ("profile", "publish", "link", "bench", "serve")
PUBLISH_FRAMES = 64
LINK_REPS = 20


def thread_role(name: str) -> str:
    if name.startswith("ThreadPoolExecutor"):
        return "sender worker"
    return {"MainThread": "consumer", "bench-feeder": "feeder",
            "ingest-uploader": "uploader"}.get(name, name)


class Waits:
    """Seconds spent in wrapped calls, by (thread role, call)."""

    def __init__(self):
        self.seconds = collections.defaultdict(float)
        self.count = collections.defaultdict(int)
        self.lock = threading.Lock()
        self.undo = []

    def wrap(self, owner, attr, label):
        fn = getattr(owner, attr)

        @functools.wraps(fn)
        def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                self.add(label, time.perf_counter() - t0)

        setattr(owner, attr, timed)
        self.undo.append((owner, attr, fn))

    def wrap_generator(self, owner, attr, label):
        """Time each ``next()`` of the generators ``owner.attr`` returns."""
        fn = getattr(owner, attr)
        waits = self

        @functools.wraps(fn)
        def gen(*a, **kw):
            it = fn(*a, **kw)

            class Timed:
                def __iter__(self):
                    return self

                def __next__(self):
                    t0 = time.perf_counter()
                    try:
                        return next(it)
                    finally:
                        waits.add(label, time.perf_counter() - t0)

                def close(self):
                    it.close()

            return Timed()

        setattr(owner, attr, gen)
        self.undo.append((owner, attr, fn))

    def add(self, label, dt):
        key = (thread_role(threading.current_thread().name), label)
        with self.lock:
            self.seconds[key] += dt
            self.count[key] += 1

    def restore(self):
        for owner, attr, fn in reversed(self.undo):
            setattr(owner, attr, fn)
        self.undo = []

    def table(self, frames):
        return {f"{role}: {label}": {"s": round(s, 6), "calls": self.count[(role, label)],
                                     "ms_per_frame": round(s * 1e3 / frames, 4)}
                for (role, label), s in sorted(self.seconds.items(), key=lambda kv: -kv[1])}


@contextlib.contextmanager
def bench_sizes(**env):
    old = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        yield
    finally:
        for k, v in old.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def wrap_host_waits(torch, waits):
    from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu_torch.runtime import ingest
    from ros_gpu_stereo_processor_tpu_torch.utils import msgs

    waits.wrap(ingest.StreamingIngest, "feed", "ring feed (push a side)")
    waits.wrap(ingest.FrameRing, "peek", "ring peek (wait for a pair)")
    waits.wrap(queue.Queue, "put", "queue put (staged frame handed over)")
    waits.wrap_generator(ingest.StreamingIngest, "frames_prefetch", "wait for a staged frame")
    waits.wrap(StereoPipeline, "process_batch", "dispatch (process_batch)")
    waits.wrap(StereoPipeline, "_step", "dispatch (frame step)")
    waits.wrap(msgs.SenderPool, "enqueue", "publish enqueue")
    waits.wrap(msgs.SenderPool, "wait_all", "SenderPool.wait_all")
    waits.wrap(concurrent.futures.Future, "result", "Future.result (a publish)")
    waits.wrap(torch.cuda.Event, "synchronize", "cuda Event.synchronize")
    if hasattr(msgs, "to_host"):
        waits.wrap(msgs, "to_host", "to_host (device→host copy)")
    with contextlib.suppress(ImportError):
        from ros_gpu_stereo_processor_tpu_torch.utils import hostcopy

        waits.wrap(hostcopy.HostCopy, "result", "HostCopy.result (copy's event)")


def _start_ns(e):
    return e.start_ns() if hasattr(e, "start_ns") else int(e.start_us() * 1000)


def _get(e, name):
    """A raw profiler event's ``name()``, or None where this PyTorch lacks it."""
    fn = getattr(e, name, None)
    return fn() if fn is not None else None


def copy_timeline(prof):
    """Device→host copies in a profiler window: kind, stream, the K2
    launches (one a frame, eight a batch) that started between each copy's
    issue and its start, and the copy time that overlaps kernels."""
    evs = list(prof.profiler.kineto_results.events())
    gpu = [e for e in evs if str(e.device_type()).endswith("CUDA") and e.duration_ns() > 0]
    issue = {}
    for e in evs:
        if not str(e.device_type()).endswith("CUDA") and e.name() in (
                "cudaMemcpyAsync", "cudaMemcpy", "cuMemcpyDtoHAsync_v2"):
            issue[_get(e, "correlation_id")] = _start_ns(e)
    k2 = sorted(_start_ns(e) for e in gpu if "bm_fused" in e.name())
    k2_streams = sorted({_get(e, "device_resource_id") for e in gpu if "bm_fused" in e.name()},
                        key=str)
    kernels = sorted((_start_ns(e), _start_ns(e) + e.duration_ns()) for e in gpu
                     if not e.name().startswith(("Memcpy", "Memset")))
    merged = []
    for a, b in kernels:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    kinds = collections.Counter()
    streams = collections.Counter()
    behind, d2h_ns, overlap_ns = [], 0, 0
    for e in gpu:
        if not e.name().startswith("Memcpy DtoH"):
            continue
        kinds[e.name()] += 1
        streams[str(_get(e, "device_resource_id"))] += 1
        a = _start_ns(e)
        b = a + e.duration_ns()
        d2h_ns += b - a
        overlap_ns += sum(max(0, min(b, y) - max(a, x)) for x, y in merged)
        t_issue = issue.get(_get(e, "correlation_id"))
        if t_issue is not None:
            behind.append(sum(1 for t in k2 if t_issue <= t < a))
    return {"d2h_copies_by_kind": dict(kinds), "d2h_copy_streams": dict(streams),
            "k2_streams": k2_streams, "d2h_ms": d2h_ns / 1e6,
            "d2h_ms_overlapping_kernels": overlap_ns / 1e6,
            "k2_launches_between_issue_and_copy": {
                "copies": len(behind),
                "median": statistics.median(behind) if behind else None,
                "max": max(behind) if behind else None}}


def run_profile(torch, bench, dev):
    from torch.profiler import ProfilerActivity, profile

    model, left, right = bench._model_and_frame()
    cfg = bench._bench_config()
    sizes = dict(BENCH_E2E_FRAMES=32, BENCH_PF_FRAMES=16, BENCH_REPEATS=1, BENCH_E2E_BATCH=8)
    # runs: run(16) warm-up, run(32); run_per_frame(4) warm-up, (16), paced (16)
    frames = 16 + 32 + 4 + 16 + 16
    out = {}
    with bench_sizes(**sizes):
        bench._e2e_metric(model, left, right, cfg, dev)     # builds, captures
        waits = Waits()
        wrap_host_waits(torch, waits)
        t0 = time.perf_counter()
        try:
            batched, pf, d2h, lat, _, budget = bench._e2e_metric(model, left, right, cfg, dev)
        finally:
            waits.restore()
        out["host_waits"] = waits.table(frames)
        out["wall_s"] = time.perf_counter() - t0
        out["e2e_fps"], out["e2e_fps_per_frame_dispatch"] = batched[0], pf[0]
        out["latency_ms_p50_p95"], out["latency_budget"] = lat, budget
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            bench._e2e_metric(model, left, right, cfg, dev)
            torch.cuda.synchronize()
        out["device_timeline"] = copy_timeline(prof)
    return out


def bm_frames(port, n, H=480, W=752):
    return [port.synthetic_stereo_pair(H, W, 48, seed=i)[:2] for i in range(n)]


def runtime_calls(prof, frames):
    """CUDA runtime and driver calls of a profiler window: per frame, the
    count and host ms of each, by name (``cudaHostAlloc``: a new pinned
    block; ``cudaMalloc``/``cudaFree``: device memory; the synchronizing
    calls)."""
    out = {}
    for e in prof.profiler.kineto_results.events():
        name = e.name()
        if str(e.device_type()).endswith("CUDA") or not name.startswith(("cuda", "cu")):
            continue
        n, ns = out.get(name, (0, 0))
        out[name] = (n + 1, ns + e.duration_ns())
    return {k: {"calls": n / frames, "ms": ns / 1e6 / frames}
            for k, (n, ns) in sorted(out.items(), key=lambda kv: -kv[1][1])}


def run_publish(torch, port, dev, frames):
    from torch.profiler import ProfilerActivity, profile

    from ros_gpu_stereo_processor_tpu_torch.utils import calib

    model = calib.euroc_like_model()
    outputs = port.Outputs.all()

    def one(publish, profiled=False):
        pipe = port.StereoPipeline(model, port.PipelineConfig(), device=dev)
        got = {}
        if publish:
            for name in outputs.flags:
                pipe.senders.register(name, lambda m, n=name: got.__setitem__(n, m))

        def close():
            if publish:
                pipe.wait_all()
            torch.cuda.synchronize()

        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = pipe.process(*frames[0], outputs)
        if publish:
            pipe.enqueue_send(res, outputs)
        close()
        first = (time.perf_counter() - t0) * 1e3
        with (profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) if profiled
              else contextlib.nullcontext()) as prof:
            t0 = time.perf_counter()
            for left, right in frames[1:]:
                res = pipe.process(left, right, outputs)
                if publish:
                    pipe.enqueue_send(res, outputs)
            close()
            ms = (time.perf_counter() - t0) * 1e3 / (len(frames) - 1)
        pipe.senders.shutdown()
        if publish and set(got) != set(outputs.flags):
            raise AssertionError(f"published {sorted(got)}")
        return first, ms, runtime_calls(prof, len(frames) - 1) if profiled else None

    runs = {"off": [], "on": []}
    for key in ("off", "on", "on", "off"):
        runs[key].append(one(key == "on"))
    return {"frames": len(frames),
            "runtime_calls_per_frame_publish_all": one(True, profiled=True)[2],
            "ms_per_frame_no_publish": [r[1] for r in runs["off"]],
            "ms_per_frame_publish_all": [r[1] for r in runs["on"]],
            "first_frame_ms_no_publish": [r[0] for r in runs["off"]],
            "first_frame_ms_publish_all": [r[0] for r in runs["on"]]}


def run_link(torch, dev):
    out = {}
    for label, shape in (("1.44MB", (480, 752)), ("4.33MB", (480, 752, 3))):
        x = torch.rand(shape, device=dev)
        mb = x.numel() * x.element_size() / 1e6
        for kind in ("pageable", "pinned"):
            rates = []
            for i in range(LINK_REPS + 1):
                y = x + float(i)
                if kind == "pinned":
                    host = torch.empty(shape, dtype=y.dtype, pin_memory=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                if kind == "pinned":
                    host.copy_(y, non_blocking=True)
                    torch.cuda.synchronize()
                else:
                    y.cpu()
                dt = time.perf_counter() - t0
                if i:
                    rates.append(mb / dt)
            out[f"{kind}_{label}_MBps"] = statistics.median(rates)
    return out


def run_bench(root):
    env = dict(os.environ, BENCH_STAGES="0", BENCH_SGM="0", BENCH_ROOFLINE="0",
               BENCH_SLAM="0")
    t0 = time.perf_counter()
    p = subprocess.run([sys.executable, "-m", "ros_gpu_stereo_processor_tpu_torch.bench"],
                       cwd=root, env=env, capture_output=True, text=True, timeout=900)
    if p.returncode != 0:
        raise AssertionError(f"bench exit {p.returncode}: {p.stderr[-2000:]}")
    record = json.loads(p.stdout.strip().splitlines()[-2])
    keys = ("value", "e2e_fps", "e2e_fps_per_frame_dispatch", "latency_ms_p50",
            "latency_ms_p95", "link_d2h_MBps", "latency_budget")
    return {"seconds": time.perf_counter() - t0, **{k: record.get(k) for k in keys}}


def run_serve(chip_smoke, torch, port, dev, frames):
    from ros_gpu_stereo_processor_tpu_torch.ops import (
        _build, remap_kernel, speckle_kernel, stereobm_kernel,
    )
    from ros_gpu_stereo_processor_tpu_torch.utils import calib, io

    kernels = {"K1": remap_kernel.KERNELS[torch.uint8], "K2": stereobm_kernel.KERNEL,
               "K3": speckle_kernel.KERNEL}
    with tempfile.TemporaryDirectory(prefix="torch_publish_") as work:
        line, _, _ = chip_smoke.run_serve(torch, port, _build, io, calib, kernels, frames,
                                          calib.euroc_like_model(), work, dev)
    return {k: line[k] for k in ("fps", "p50_dispatch_to_publish_ms",
                                 "p95_dispatch_to_publish_ms", "wall_ms_per_frame")}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=ROOT, help="checkout whose package is measured")
    ap.add_argument("--sections", default=",".join(SECTIONS))
    ap.add_argument("--out", default="", help="also append each JSON line to this file")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("torch_publish: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    import chip_smoke           # this checkout's, before --root is on the path
    card_line = runpy.run_path(
        os.path.join(ROOT, "ros_gpu_stereo_processor_tpu_torch", "utils", "device.py"))["card_line"]
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch import bench
    from ros_gpu_stereo_processor_tpu_torch.ops import _build

    if not _build.CSRC.is_relative_to(root):
        raise AssertionError(f"imported {_build.CSRC}, not the package under {root}")
    _build.build()
    dev = torch.device("cuda", 0)
    card = card_line()
    sections = [s for s in args.sections.split(",") if s]
    frames = bm_frames(port, PUBLISH_FRAMES) if {"publish", "serve"} & set(sections) else []
    for s in sections:
        t0 = time.perf_counter()
        if s == "profile":
            res = run_profile(torch, bench, dev)
        elif s == "publish":
            res = run_publish(torch, port, dev, frames)
        elif s == "link":
            res = run_link(torch, dev)
        elif s == "bench":
            res = run_bench(root)
        elif s == "serve":
            res = run_serve(chip_smoke, torch, port, dev, frames)
        else:
            raise SystemExit(f"unknown section {s!r}")
        line = json.dumps({"section": s, "root": root, "card": card,
                           "seconds": time.perf_counter() - t0, **res})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
