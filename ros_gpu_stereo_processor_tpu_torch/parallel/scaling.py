"""Scaling of the sharded frontend, and a dry run of every multi-device path.

The port of ``ros_gpu_stereo_processor_tpu/parallel/scaling.py`` and of
``__graft_entry__.py``'s ``dryrun_multichip``.

:func:`measure_scaling` times the sharded matcher (row bands, optionally
with the row-band speckle filter, or disparity slabs) on meshes of 1 … N
entries and reports frames per second, the efficiency against linear
scaling and the wall-time overhead against one entry.  As JAX jits a
``lax.scan`` over the batch for each mesh size, a mesh whose line is one
card in this process (``devices=["cuda:0"] * 4``) runs the whole batch as
one CUDA graph replay (utils/graphs.py::batch_runner), and so does the
unsharded leg on one card.  A line over several devices runs eagerly,
frame by frame: a graph per device and the peer copies between them are not
captured.  Time is the host's wall clock around batches that end in one
host read of the batch's checksum.

A mesh whose entries share one card or the CPU adds no hardware: n entries
split the same work n ways on the same device, so ``efficiency`` =
fps(n) / (n · fps(1)) tends to 1/n by construction and means nothing there.
The number to read on such a mesh is ``wall_overhead_vs_1dev`` = t(n) / t(1)
at fixed total work: 1 plus the device's cost of sharding (halo exchanges,
collectives, the speckle filter's merge rounds and n times the launches).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, Iterator, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
from ros_gpu_stereo_processor_tpu_torch.utils import graphs
from ros_gpu_stereo_processor_tpu_torch.utils.calib import euroc_like_model

BM = StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10)


def scaling_frames(batch: int, height: int, width: int,
                   device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The harness's (B, H, W) uint8 left and right stacks on ``device``:
    uniform noise from ``default_rng(0)``, as the JAX harness draws them."""
    rng = np.random.default_rng(0)
    lefts = rng.integers(0, 255, (batch, height, width), np.uint8)
    rights = rng.integers(0, 255, (batch, height, width), np.uint8)
    dev = torch.device(device)
    return torch.from_numpy(lefts).to(dev), torch.from_numpy(rights).to(dev)


def scaling_steps(
    height: int,
    cfg: StereoBMConfig = BM,
    device_counts: Optional[List[int]] = None,
    mode: str = "rows",
    max_speckle_size: int = 0,
    include_unsharded: bool = False,
    devices: Optional[Sequence] = None,
) -> Iterator[Tuple[Union[int, str], graphs.Captured, bool]]:
    """The batch step of each entry count :func:`measure_scaling` times, one
    at a time: ``(n, runner, captured)``, n the entry count (``"unsharded"``
    for one device without a mesh, last), ``runner`` the
    :func:`graphs.batch_runner` of the entry's frame (``runner.fn`` is the
    eager batch) and ``captured`` whether the entry runs as the runner's
    graph replay (a line of one CUDA device in this process) or eagerly.
    Drop each runner before taking the next: its graph and memory pool go
    with it.  Arguments as :func:`measure_scaling`'s."""
    from ros_gpu_stereo_processor_tpu_torch.ops import speckle as speckle_ops
    from ros_gpu_stereo_processor_tpu_torch.ops import stereobm_kernel
    from ros_gpu_stereo_processor_tpu_torch.parallel.frontend import (
        disparity_row_sharded, disparity_slab_sharded, filter_speckles_row_sharded)

    if mode not in ("rows", "disp"):
        raise ValueError(f"mode={mode!r} must be 'rows' or 'disp'")
    devices = _devices(devices)
    if device_counts is None:
        device_counts = [n for n in (1, 2, 4, 8, 16) if n <= len(devices)]
    first = devices[0]
    for n in device_counts:
        if mode == "rows" and height % n != 0:
            continue
        if mode == "disp" and cfg.num_disparities % n != 0:
            continue
        axis = "rows" if mode == "rows" else "disp"
        mesh = make_mesh(n, (axis,), devices=devices[:n])

        def frame(left, right, mesh=mesh, axis=axis):
            if mode == "disp":
                return disparity_slab_sharded(left, right, cfg, mesh, axis)
            d, v = disparity_row_sharded(left, right, cfg, mesh, axis)
            if max_speckle_size > 0:
                d, v = filter_speckles_row_sharded(d, v, mesh, axis,
                                                   max_speckle_size=max_speckle_size)
            return d, v

        yield (n, graphs.batch_runner(frame, first, name=f"scaling {mode} {n}"),
               mesh.on_one_device() and first.type == "cuda")
    if include_unsharded:
        def unsharded(left, right):
            d, v = stereobm_kernel.compute_disparity_fused(left, right, cfg)
            if max_speckle_size > 0:
                d, v = speckle_ops.filter_speckles(d, v, max_speckle_size=max_speckle_size)
            return d, v

        yield ("unsharded", graphs.batch_runner(unsharded, first, name="scaling unsharded"),
               first.type == "cuda")


def timed_batch(run: Callable, lefts: torch.Tensor, rights: torch.Tensor, iters: int) -> float:
    """ms a frame of ``run(lefts, rights)``, as JAX's harness times its
    jitted scan: the first call (the warm-up, the kernels' build and the
    capture) untimed, then ``iters`` calls each ending in one host read of
    the batch's checksum (JAX's ``float(run(...))``), on the host's clock;
    the mean call's ms over B."""
    float(run(lefts, rights).sum())
    t0 = time.perf_counter()
    for _ in range(iters):
        float(run(lefts, rights).sum())
    dt = (time.perf_counter() - t0) / iters
    return dt * 1e3 / lefts.shape[0]


def measure_scaling(
    height: int = 480,
    width: int = 752,
    cfg: StereoBMConfig = BM,
    device_counts: Optional[List[int]] = None,
    batch: int = 4,
    iters: int = 3,
    mode: str = "rows",
    max_speckle_size: int = 0,
    include_unsharded: bool = False,
    devices: Optional[Sequence] = None,
) -> Dict:
    """Throughput of the sharded frontend at each entry count.

    ``devices``: the entries a mesh of n takes the first n of (default: the
    CUDA devices; ``["cuda:0"] * 4`` for bands on one card, ``["cpu"] * 4``
    on the CPU).  ``mode``: ``"rows"`` (row bands, halo exchange) or
    ``"disp"`` (disparity slabs, ``pmin`` of packed keys).
    ``max_speckle_size`` > 0 adds the row-band speckle filter (rows mode).
    ``include_unsharded`` also times one device without a mesh (K2 and the
    speckle filter), so the 1-entry mesh's overhead over it is visible.

    Returns {"mode", "speckle", "devices", "results": [{n_devices,
    ms_per_frame, fps}], "efficiency": {n: fps(n) / ((n / n0) · fps(n0))},
    "wall_overhead_vs_1dev": {n: t(n) / t(1)} (``_vs_<n0>dev`` when no
    1-entry run was measured), "captured": {n: whether n's batch was a
    graph replay}}, plus "unsharded_ms_per_frame" on request (and
    ``captured["unsharded"]``).
    """
    devices = _devices(devices)
    lefts, rights = scaling_frames(batch, height, width, devices[0])

    results, captured, unsharded_ms = [], {}, None
    for n, runner, graph in scaling_steps(height, cfg, device_counts, mode, max_speckle_size,
                                          include_unsharded, devices):
        ms = timed_batch(runner if graph else runner.fn, lefts, rights, iters)
        captured[n] = graph
        if n == "unsharded":
            unsharded_ms = ms
        else:
            results.append({"n_devices": n, "ms_per_frame": ms, "fps": 1e3 / ms})
        del runner      # its graph and pool, before the next entry captures

    # the baseline is the 1-entry run when there is one (the divisibility
    # filters may drop it), else the smallest count measured
    base = next((r for r in results if r["n_devices"] == 1), results[0] if results else None)
    base_fps = base["fps"] if base else 1.0
    base_n = base["n_devices"] if base else 1
    base_ms = base["ms_per_frame"] if base else 1.0
    out = {
        "mode": mode, "speckle": max_speckle_size, "devices": [str(d) for d in devices],
        "results": results,
        "efficiency": {r["n_devices"]: r["fps"] / ((r["n_devices"] / base_n) * base_fps)
                       for r in results},
        ("wall_overhead_vs_1dev" if base_n == 1 else f"wall_overhead_vs_{base_n}dev"): {
            r["n_devices"]: r["ms_per_frame"] / base_ms for r in results},
        "captured": captured,
    }
    if include_unsharded:
        out["unsharded_ms_per_frame"] = unsharded_ms
    return out


def _devices(devices: Optional[Sequence]) -> List[torch.device]:
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have == 0:
            raise RuntimeError("no CUDA device; pass devices= (e.g. ['cpu'] * 4)")
        return [torch.device("cuda", i) for i in range(have)]
    return [torch.device(d) for d in devices]


def dryrun_multichip(n_devices: int, devices: Optional[Sequence] = None, height: int = 480,
                     width: int = 752) -> Dict:
    """One pass over every multi-device path on a mesh of ``n_devices``
    entries (``devices``: one per entry; default the first n CUDA devices):

      1. the full pipeline by row bands at ``width`` × ``height`` (752×480:
         block 15, 64 disparities, speckle 800 / Δ5 and the bilateral filter
         on, every output), through ``StereoPipeline(mesh=...)``; a height
         the mesh does not divide becomes 60 rows per entry;
      2. at a tiny size (8 rows per entry, 256 columns, 32 disparities,
         block 5): the band matcher equals the single-device matcher, the
         band SGM equals the same bands computed on the mesh's first device
         and agrees with the single-device SGM on ≥ 99 % of pixels (the
         vertical paths' warm-up halo is an approximation), the band remap
         equals the whole-image remap, and slabs equal one device;
      3. the landmark-sharded BA over a ``kf`` mesh of n entries;
      4. the SLAM engine on a (kf, rows) mesh for 6 frames.

    Prints a line per step; raises on any failed check; returns the numbers
    it printed."""
    from ros_gpu_stereo_processor_tpu_torch.config import (
        BilateralConfig, Outputs, PipelineConfig, SpeckleConfig)
    from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu_torch.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel, sgm_kernel, stereobm_kernel
    from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as par
    from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import (
        bundle_adjust_sharded, synthetic_problem)
    from ros_gpu_stereo_processor_tpu_torch.utils.calib import CameraCalib, StereoCameraModel
    from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

    n = n_devices
    mesh = make_mesh(n, ("rows",), devices=devices)
    entries = list(mesh.devices)
    dev = entries[0]
    summary = {"n_devices": n, "devices": [str(d) for d in entries]}

    # -- 1. the full pipeline by row bands --------------------------------
    H = height if height % n == 0 else 60 * n
    model = euroc_like_model(width, H)
    rng = np.random.default_rng(0)
    left = rng.integers(0, 255, (H, width), np.uint8)
    right = rng.integers(0, 255, (H, width), np.uint8)
    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=64, block_size=15, texture_threshold=10),
        speckle=SpeckleConfig(max_speckle_size=800, max_diff=5.0, propagation_iters=16),
        bilateral=BilateralConfig(enabled=True, radius=3, iters=1))
    pipe = StereoPipeline(model, cfg, mesh=mesh)
    out = pipe.process(left, right, Outputs.all()).fetch()
    pipe.senders.shutdown()
    if out["disparity"].shape != (H, width) or out["pointcloud_xyz"].shape != (H, width, 3):
        raise AssertionError(f"dryrun: output shapes {out['disparity'].shape}, "
                             f"{out['pointcloud_xyz'].shape}")
    if not np.isfinite(out["disparity"]).all():
        raise AssertionError("dryrun: non-finite disparity")
    summary["valid_pct"] = float(out["disparity_valid"].mean()) * 100
    print(f"dryrun_multichip({n}): dense OK — full {width}x{H} pipeline by {n} row bands "
        f"(block 15, 64 disp, speckle+bilateral on), outputs {sorted(out)}, "
        f"{summary['valid_pct']:.1f}% valid")

    # -- 2. the band and slab matchers against their twins, tiny ----------
    tl, tr, _ = synthetic_stereo_pair(8 * n, 256, 24, seed=0)
    tl, tr = torch.from_numpy(tl).to(dev), torch.from_numpy(tr).to(dev)
    tcfg = StereoBMConfig(num_disparities=32, block_size=5, texture_threshold=10)
    d, v = par.disparity_row_sharded(tl, tr, tcfg, mesh)
    d1, v1 = stereobm_kernel.compute_disparity_fused(tl, tr, tcfg)
    if not (torch.equal(mesh.gather(v), v1) and torch.equal(mesh.gather(d), d1)):
        raise AssertionError("dryrun: band matcher differs from one device")
    one = make_mesh(n, ("rows",), devices=[dev] * n)
    ds, vs = par.disparity_sgm_row_sharded(tl, tr, tcfg, mesh, warmup_rows=4)
    ds1, vs1 = par.disparity_sgm_row_sharded(tl, tr, tcfg, one, warmup_rows=4)
    ds, vs, ds1, vs1 = mesh.gather(ds), mesh.gather(vs), one.gather(ds1), one.gather(vs1)
    if not (torch.equal(vs, vs1) and torch.equal(ds, ds1)):
        raise AssertionError("dryrun: band SGM differs from its bands on one device")
    dw, vw = sgm_kernel.compute_disparity_sgm_fused(tl, tr, tcfg)
    agree = float((vs == vw).float().mean())
    if agree < 0.99:
        raise AssertionError(f"dryrun: band SGM validity agrees with one device on {agree}")
    yy, xx = np.mgrid[0:8 * n, 0:256].astype(np.float32)
    rmap = torch.from_numpy(np.stack([xx + 2.5 - 0.01 * yy, yy + 1.25 + 0.01 * xx], -1)).to(dev)
    img = torch.from_numpy(np.random.default_rng(2).integers(0, 256, (1, 8 * n, 256),
                                                              np.uint8)).to(dev)
    got = torch.cat([b[0] for b in par.remap_row_sharded(img, rmap[None], mesh)])
    if not torch.equal(got.to(dev), remap_kernel.rectify(img, rmap[None])[0]):
        raise AssertionError("dryrun: band remap differs from the whole-image remap")
    if 32 % n == 0:
        dsl, vsl = par.disparity_slab_sharded(tl, tr, tcfg, make_mesh(n, ("disp",),
                                                                      devices=entries))
        if not (torch.equal(vsl, v1) and torch.equal(dsl, d1)):
            raise AssertionError("dryrun: slabs differ from one device")
    summary["sgm_validity_agreement"] = agree
    print(f"dryrun_multichip({n}): twins OK — band matcher and slabs equal one device, band "
        f"SGM equals its bands on one device ({agree * 100:.2f}% validity agreement with "
        f"whole-image SGM), band remap equals the whole-image remap")

    # -- 3. the landmark-sharded BA ------------------------------------------
    prob = synthetic_problem(np.random.default_rng(1), 3, n * -(-max(16, 8 * n) // n), dev)
    _, hist = bundle_adjust_sharded(prob, make_mesh(n, ("kf",), devices=entries), iters=3)
    summary["ba_rms"] = [float(hist[0]), float(hist[-1])]
    if not hist[-1] < hist[0]:
        raise AssertionError(f"dryrun: sharded BA did not reduce the rms: {summary['ba_rms']}")
    print(f"dryrun_multichip({n}): dist-BA OK — rms {float(hist[0]):.3f} → "
        f"{float(hist[-1]):.3f} px over {n} landmark blocks")

    # -- 4. SLAM on a (kf, rows) mesh ---------------------------------------
    n_rows = n // 2 if n % 2 == 0 else n
    n_kf = n // n_rows
    slam_mesh = make_mesh(n, ("kf", "rows"), shape=(n_kf, n_rows), devices=entries)
    Hs, Ws, fxs = 40 * n_rows, 240, 200.0
    Ks = np.array([[fxs, 0, Ws / 2], [0, fxs, Hs / 2], [0, 0, 1.0]])
    Ps = np.hstack([Ks, np.zeros((3, 1))])
    Prs = Ps.copy()
    Prs[0, 3] = -fxs * 0.1
    smodel = StereoCameraModel.from_calibs(
        *(CameraCalib(Ws, Hs, Ks, np.zeros(5), np.eye(3), PP, nm)
          for PP, nm in ((Ps, "left"), (Prs, "right"))))
    slam = StereoSlam(
        smodel, SlamConfig(num_features=128, keyframe_every=2, window_size=3,
                           ba_landmarks=max(64, n_kf * 32)),
        PipelineConfig(stereobm=StereoBMConfig(num_disparities=16, block_size=9,
                                               texture_threshold=5),
                       speckle=SpeckleConfig(max_speckle_size=0)),
        mesh=slam_mesh)
    tex = np.random.default_rng(3).integers(0, 255, (Hs, Ws + 6 * 4 + 10 + 8), np.uint8)
    d0 = int(round(fxs * 0.1 / 2.0))
    n_ba = 0
    for i in range(6):
        info = slam.step(tex[:, 4 * i: 4 * i + Ws], tex[:, 4 * i + d0: 4 * i + d0 + Ws],
                         stamp=0.1 * i)
        n_ba += int(info["is_keyframe"] and len(slam.store) >= 2)
    slam.pipeline.senders.shutdown()
    traj = slam.trajectory()
    if not (np.isfinite(traj.t).all() and len(slam.store) >= 2 and n_ba >= 1):
        raise AssertionError(f"dryrun: SLAM on the mesh: {len(slam.store)} keyframes, "
                             f"{n_ba} BA windows")
    summary.update(slam_keyframes=len(slam.store), slam_ba_windows=n_ba)
    print(f"dryrun_multichip({n}): SLAM-on-mesh OK — {n_kf}×{n_rows} (kf×rows) mesh, "
        f"{len(traj.t)} frames stepped, {len(slam.store)} keyframes, {n_ba} BA windows")
    return summary
