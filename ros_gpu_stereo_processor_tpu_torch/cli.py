"""Command-line interface of the PyTorch port — ``tpu-stereo-torch``.

The port of ``ros_gpu_stereo_processor_tpu/cli.py``: the reference's node
executable (src/StereoProcessorNode.cpp:4-34) and launch-file recipes as
subcommands:

  * ``info``     — calibration / model summary (the reference's FOV log at
                   model init, src/GPUStereoProcessor.cpp:47-51);
  * ``run``      — a stereo pair or an EuRoC sequence through the pipeline,
                   dumping image/cloud artifacts (≙ gpu_image_processor.launch);
  * ``compare``  — A/B the pipeline against the OpenCV CPU oracle (needs
                   ``cv2``; ≙ the side-by-side test_node.launch);
  * ``slam``     — the SLAM engine over an EuRoC sequence;
  * ``serve``    — the watch-dir serve daemon (runtime/serve.py);
  * ``bench``    — the streaming benchmark (bench.py): one JSON record line,
                   then a headline of at most 1,800 characters.

Every subcommand runs on the card unless ``--device cpu`` is given; without
CUDA the default raises.  Block-matcher flags mirror the dynamic_reconfigure
schema with the same validation.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

import numpy as np


def _add_bm_flags(p: argparse.ArgumentParser) -> None:
    p.add_argument("--ndisp", type=int, default=64, help="disparity range (mult of 16)")
    p.add_argument("--block", type=int, default=15, help="correlation window (odd)")
    p.add_argument("--min-disparity", type=int, default=0)
    p.add_argument("--texture-threshold", type=int, default=10)
    p.add_argument("--uniqueness", type=int, default=0)
    p.add_argument("--no-xsobel", action="store_true")
    p.add_argument("--refine", action="store_true", help="subpixel refinement")
    p.add_argument("--speckle-size", type=int, default=800)
    p.add_argument("--speckle-diff", type=float, default=5.0)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the pipeline runs (default: the card)")
    p.add_argument("--algorithm", choices=["bm", "sgm"], default="bm")
    p.add_argument("--sgm-p1", type=float, default=10.0)
    p.add_argument("--sgm-p2", type=float, default=120.0)
    p.add_argument("--sgm-paths", type=int, default=4, choices=[2, 4, 8])
    p.add_argument("--wire", choices=["float32", "fixed16", "fixed8"], default="float32",
                   help="disparity publish wire (fixed8: 1 B/px offset encoding; "
                        "needs min-disparity >= 0)")
    p.add_argument("--lr-check", action="store_true", help="left-right consistency check")


def _bm_config(args):
    from ros_gpu_stereo_processor_tpu_torch.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig,
    )

    return PipelineConfig(
        queue_size=getattr(args, "queue_size", 5),
        max_in_flight=getattr(args, "max_in_flight", 2),
        disparity_wire=args.wire,
        stereobm=StereoBMConfig(
            num_disparities=args.ndisp,
            block_size=args.block,
            min_disparity=args.min_disparity,
            texture_threshold=args.texture_threshold,
            uniqueness_ratio=args.uniqueness,
            xsobel=not args.no_xsobel,
            refine_disparity=args.refine,
            algorithm=args.algorithm,
            sgm_p1=args.sgm_p1,
            sgm_p2=args.sgm_p2,
            sgm_paths=args.sgm_paths,
            lr_check=args.lr_check,
        ),
        speckle=SpeckleConfig(max_speckle_size=args.speckle_size, max_diff=args.speckle_diff),
    )


def _load_model(args):
    from ros_gpu_stereo_processor_tpu_torch.utils.calib import StereoCameraModel

    return StereoCameraModel.from_files(args.calib_left, args.calib_right)


def _mesh_from_args(args):
    """The band mesh of ``--devices N``: N CUDA devices, or with
    ``--device cpu`` N bands on the CPU; None without ``--devices``."""
    n = getattr(args, "devices", 0)
    if not n:
        return None
    from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh

    if args.device == "cpu":
        return make_mesh(n, ("rows",), devices=["cpu"] * n)
    return make_mesh(n, ("rows",))


def _load_pair(args):
    from ros_gpu_stereo_processor_tpu_torch.utils.io import load_image

    left = load_image(args.left)
    right = load_image(args.right)
    if left.ndim == 3 and args.encoding.startswith("mono"):
        left, right = left[..., 0], right[..., 0]
    return left, right


def cmd_info(args) -> int:
    m = _load_model(args)
    print(f"left : {m.left.calib.name}  {m.left.calib.width}x{m.left.calib.height}")
    print(f"right: {m.right.calib.name}")
    print(f"fx={m.fx:.3f} px  baseline={m.baseline:.4f} m  "
          f"disparity_offset={m.disparity_offset:.3f} px")
    print(f"FOV: {np.degrees(m.left.fov_x):.1f} x {np.degrees(m.left.fov_y):.1f} deg")
    print("Q =")
    print(np.array_str(m.Q, precision=4, suppress_small=True))
    return 0


def _write_ply(path: str, xyz: np.ndarray, rgb_packed: np.ndarray | None) -> int:
    """Dump an organized cloud's finite points as ASCII PLY."""
    ok = np.isfinite(xyz).all(axis=-1)
    pts = xyz[ok]
    lines = ["ply", "format ascii 1.0", f"element vertex {len(pts)}",
             "property float x", "property float y", "property float z"]
    cols = None
    if rgb_packed is not None:
        packed = rgb_packed[ok].view(np.uint32)
        cols = np.stack([(packed >> 16) & 0xFF, (packed >> 8) & 0xFF, packed & 0xFF],
                        -1).astype(np.uint8)
        lines += ["property uchar red", "property uchar green", "property uchar blue"]
    lines += ["end_header"]
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
        for i, p in enumerate(pts):
            if cols is None:
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f}\n")
            else:
                c = cols[i]
                f.write(f"{p[0]:.4f} {p[1]:.4f} {p[2]:.4f} {c[0]} {c[1]} {c[2]}\n")
    return len(pts)


def _euroc_frames(args):
    """The sequence's pairs, decoded on a producer thread into the native
    staging ring (depth ``--queue-size``, blocking push: nothing is dropped)."""
    from ros_gpu_stereo_processor_tpu_torch.runtime import FrameRing
    from ros_gpu_stereo_processor_tpu_torch.utils.io import EurocReader, StereoFrame

    reader = EurocReader(args.euroc, approximate_sync=args.approximate_sync)
    state = {"ring": None, "error": None}
    ready, done = threading.Event(), threading.Event()

    def produce():
        try:
            for fr in reader:
                if state["ring"] is None:
                    state["ring"] = FrameRing(max(2, args.queue_size), fr.left.shape,
                                              drop_on_full=False)
                    ready.set()
                state["ring"].push(fr.left, fr.right, fr.stamp, timeout=-1.0)
        except Exception as e:       # raised again in the consumer
            state["error"] = e
        finally:
            done.set()
            ready.set()

    threading.Thread(target=produce, daemon=True, name="euroc-reader").start()
    ready.wait()
    ring = state["ring"]
    while ring is not None:
        got = ring.pop(timeout=0.25)
        if got is None:
            if done.is_set() and len(ring) == 0:
                break
            continue
        l, r, stamp, _ = got
        yield StereoFrame(stamp=stamp, left=l, right=r, encoding=args.encoding)
    if state["error"] is not None:
        raise state["error"]


def cmd_run(args) -> int:
    from ros_gpu_stereo_processor_tpu_torch.config import Outputs
    from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu_torch.ops import _build
    from ros_gpu_stereo_processor_tpu_torch.utils.io import StereoFrame, write_image

    model = _load_model(args)
    mesh = _mesh_from_args(args)
    pipe = StereoPipeline(model, _bm_config(args), device=None if mesh else args.device,
                          mesh=mesh, shard_mode=args.shard_mode)
    outputs = Outputs.of(*args.outputs.split(","))
    os.makedirs(args.out_dir, exist_ok=True)
    if args.euroc:
        frames = _euroc_frames(args)
    else:
        left, right = _load_pair(args)
        frames = [StereoFrame(stamp=0.0, left=left, right=right, encoding=args.encoding)]

    n = 0
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    for fr in frames:
        out = pipe.process(fr.left, fr.right, outputs, encoding=fr.encoding).fetch()
        if n < args.save_frames:
            for name in ("disparity_vis", "rect_mono_left", "rect_color_left"):
                if name in out:
                    write_image(os.path.join(args.out_dir, f"{name}_{n:04d}.png"), out[name])
            if "disparity" in out:
                np.save(os.path.join(args.out_dir, f"disparity_{n:04d}.npy"), out["disparity"])
            if "pointcloud_xyz" in out:
                npts = _write_ply(os.path.join(args.out_dir, f"cloud_{n:04d}.ply"),
                                  out["pointcloud_xyz"], out.get("pointcloud_rgb"))
                print(f"frame {n}: wrote {npts} points")
        n += 1
        if args.max_frames and n >= args.max_frames:
            break
    dt = time.perf_counter() - t0
    pipe.senders.shutdown()
    print(f"processed {n} frames in {dt:.2f}s ({n / dt:.1f} fps incl. host IO)")
    # CUDA kernel launches over these frames, by C entry point (all 0 on the
    # CPU, where each op runs its plain version)
    print("kernel launches: " + json.dumps(
        {sym: k.launches for sym, k in sorted(_build.kernels().items())}))
    return 0


def _cv_oracle_disparity(cv2, model, cfg, left, right):
    """OpenCV CPU StereoBM with mirrored settings — the reference's own
    parity oracle (src/GPUStereoProcessor.cpp:20,319).  Returns
    (cv_disp float32, cv_valid bool, rect dict)."""
    bm = cfg.stereobm
    rect = {}
    for side, img in (("left", left), ("right", right)):
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_RGB2GRAY)
        mp = getattr(model, side).rect_map
        rect[side] = cv2.remap(img, mp[..., 0], mp[..., 1], cv2.INTER_LINEAR)
    sbm = cv2.StereoBM_create(bm.num_disparities, bm.block_size)
    sbm.setPreFilterType(cv2.STEREO_BM_PREFILTER_XSOBEL if bm.xsobel
                         else cv2.STEREO_BM_PREFILTER_NORMALIZED_RESPONSE)
    sbm.setPreFilterCap(bm.prefilter_cap)
    sbm.setTextureThreshold(bm.texture_threshold)
    sbm.setUniquenessRatio(bm.uniqueness_ratio)
    sbm.setMinDisparity(bm.min_disparity)
    # mirror the speckle setting so both sides are filtered alike
    sp = cfg.speckle
    sbm.setSpeckleWindowSize(sp.max_speckle_size if sp.enabled else 0)
    sbm.setSpeckleRange(int(sp.max_diff * 16) if sp.enabled else 0)
    d16 = sbm.compute(rect["left"], rect["right"])
    cv_disp = d16.astype(np.float32) / 16.0
    cv_valid = d16 > (bm.min_disparity - 1) * 16
    return cv_disp, cv_valid, rect


def _compare_frame(cv2, pipe, model, cfg, left, right, encoding):
    """One pipeline-vs-oracle frame comparison; returns (report, ours, cv,
    rect)."""
    from ros_gpu_stereo_processor_tpu_torch.config import Outputs

    res = pipe.process(left, right, Outputs.of("disparity"), encoding=encoding).fetch()
    cv_disp, cv_valid, rect = _cv_oracle_disparity(cv2, model, cfg, left, right)
    both = cv_valid & res["disparity_valid"]
    diff = np.abs(res["disparity"][both] - cv_disp[both])
    report = {
        "joint_valid_fraction": float(both.mean()),
        "valid_mask_agreement": float((cv_valid == res["disparity_valid"]).mean()),
        "within_1px": float((diff <= 1.0).mean()) if both.any() else None,
        "mean_abs_diff": float(diff.mean()) if both.any() else None,
    }
    return report, res, cv_disp, rect


def cmd_compare(args) -> int:
    """A/B the pipeline against the OpenCV CPU oracle — the reference's
    side-by-side CPU stereo_image_proc comparison (launch/test_node.launch).

    Single pair (--left/--right) or a whole sequence (--euroc): the sequence
    mode aggregates per-frame agreement into one JSON report and dumps
    artifacts for the worst frame (lowest within-1px agreement)."""
    try:
        import cv2
    except ImportError:
        print("compare needs OpenCV (the cv2 module) for its CPU oracle, and cv2 is "
              "not installed", file=sys.stderr)
        return 2
    from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline

    model = _load_model(args)
    cfg = _bm_config(args)
    pipe = StereoPipeline(model, cfg, device=args.device)

    if args.euroc:
        from ros_gpu_stereo_processor_tpu_torch.utils.io import EurocReader

        reader = EurocReader(args.euroc, approximate_sync=args.approximate_sync)
        frames = []
        worst = None
        t0 = time.perf_counter()
        for i, fr in enumerate(reader):
            if args.max_frames and i >= args.max_frames:
                break
            rep, res, cv_disp, rect = _compare_frame(cv2, pipe, model, cfg, fr.left,
                                                     fr.right, fr.encoding)
            rep["stamp"] = fr.stamp
            frames.append(rep)
            w1 = rep["within_1px"] if rep["within_1px"] is not None else 0.0
            if worst is None or w1 < worst[0]:
                worst = (w1, fr.stamp, res, cv_disp, rect)
        dt = time.perf_counter() - t0
        w1s = [r["within_1px"] for r in frames if r["within_1px"] is not None]
        report = {
            "frames": len(frames),
            "seconds": round(dt, 2),
            "within_1px_mean": float(np.mean(w1s)) if w1s else None,
            "within_1px_min": float(np.min(w1s)) if w1s else None,
            "within_1px_p10": float(np.percentile(w1s, 10)) if w1s else None,
            "valid_mask_agreement_mean": float(
                np.mean([r["valid_mask_agreement"] for r in frames])) if frames else None,
            "mean_abs_diff_mean": float(np.mean(
                [r["mean_abs_diff"] for r in frames if r["mean_abs_diff"] is not None]
            )) if w1s else None,
            "worst_frame_stamp": worst[1] if worst else None,
        }
        print(json.dumps(report, indent=2))
        if args.dump_dir and worst is not None:
            os.makedirs(args.dump_dir, exist_ok=True)
            with open(os.path.join(args.dump_dir, "compare_report.json"), "w") as f:
                json.dump({"summary": report, "per_frame": frames}, f, indent=2)
            from ros_gpu_stereo_processor_tpu_torch.utils.debug import dump_comparison

            dump_comparison(args.dump_dir, worst[2]["disparity"], worst[3])
            print(f"worst-frame artifacts -> {args.dump_dir}")
        pipe.senders.shutdown()
        ok = report["within_1px_mean"] is not None and report["within_1px_mean"] > 0.85
        print("PASS" if ok else "FAIL")
        return 0 if ok else 1

    left, right = _load_pair(args)
    report, res, cv_disp, rect = _compare_frame(cv2, pipe, model, cfg, left, right,
                                                args.encoding)
    print(json.dumps(report, indent=2))
    if args.dump_dir:
        # the artifact set for offline analysis (the reference's
        # ExportDisparitiesToCSV / epipolar-overlay diagnostics)
        from ros_gpu_stereo_processor_tpu_torch.utils.debug import (
            dump_comparison, stereo_with_epipolar,
        )
        from ros_gpu_stereo_processor_tpu_torch.utils.io import write_image

        dump_comparison(args.dump_dir, res["disparity"], cv_disp)
        write_image(os.path.join(args.dump_dir, "epipolar.png"),
                    stereo_with_epipolar(rect["left"], rect["right"]))
        print(f"artifacts -> {args.dump_dir}")
    pipe.senders.shutdown()
    ok = report["within_1px"] is not None and report["within_1px"] > 0.85
    print("PASS" if ok else "FAIL")
    return 0 if ok else 1


def cmd_slam(args) -> int:
    """Run the SLAM engine over an EuRoC sequence; write the trajectory
    (``t x y z`` per line) and report ATE when ground truth is there."""
    from ros_gpu_stereo_processor_tpu_torch.models.slam import SlamConfig, StereoSlam
    from ros_gpu_stereo_processor_tpu_torch.utils import evaluate as ev
    from ros_gpu_stereo_processor_tpu_torch.utils.io import EurocReader

    model = _load_model(args)
    slam = StereoSlam(
        model,
        SlamConfig(num_features=args.features, keyframe_every=args.keyframe_every,
                   window_size=args.window),
        _bm_config(args),
        device=args.device,
    )
    reader = EurocReader(args.euroc, approximate_sync=args.approximate_sync)
    n = 0
    t0 = time.perf_counter()
    # pipelined stepping: frame t's host work overlaps frame t+1's device
    # work; --async-mapping also moves the track table and BA to a worker
    stream = slam.run_stream(((fr.left, fr.right, fr.stamp) for fr in reader),
                             async_mapping=args.async_mapping)
    for info in stream:
        n += 1
        if n % 50 == 0:
            print(f"frame {n}: t={info['t_wc'].round(3)} matches={info['n_matches']} "
                  f"kf={len(slam.store)}")
        if args.max_frames and n >= args.max_frames:
            break
    dt = time.perf_counter() - t0
    slam.optimize_global()
    traj = slam.trajectory()
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "trajectory.txt")
    with open(out, "w") as f:
        for i in range(len(traj)):
            p = traj.t[i]
            f.write(f"{traj.stamps[i]:.6f} {p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")
    print(f"{n} frames in {dt:.1f}s ({n / dt:.1f} fps incl. IO); "
          f"{len(slam.store)} keyframes; trajectory -> {out}")
    if args.checkpoint:
        slam.save_checkpoint(args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}")
    slam.pipeline.senders.shutdown()

    gt_path = os.path.join(args.euroc, "mav0", "state_groundtruth_estimate0", "data.csv")
    if os.path.exists(gt_path):
        ate = ev.ate_rmse(traj, ev.load_euroc_groundtruth(args.euroc))
        print(json.dumps({"ate_rmse_m": round(ate, 4), "frames": n}))
    return 0


def cmd_serve(args) -> int:
    """Live mode: watch <dir>/left and <dir>/right for '<stamp>.png' frames,
    pair them through the native ingest runtime, process, and write results
    to <out-dir> (runtime/serve.py).  Calibration may arrive after startup as
    camera_info_{left,right}.yaml drops, and <watch-dir>/reconfigure.json
    retunes the matcher while serving."""
    from ros_gpu_stereo_processor_tpu_torch.config import Outputs
    from ros_gpu_stereo_processor_tpu_torch.runtime.serve import ServeDaemon

    daemon = ServeDaemon(
        watch_dir=args.watch_dir,
        out_dir=args.out_dir,
        outputs=Outputs.of(*args.outputs.split(",")),
        encoding=args.encoding,
        config=_bm_config(args),
        calib_left=args.calib_left or "",
        calib_right=args.calib_right or "",
        queue_size=args.queue_size,
        approximate_sync=args.approximate_sync,
        idle_timeout=args.idle_timeout,
        device=args.device,
    )
    try:
        daemon.run()
    finally:
        daemon.close()
    return 0


def cmd_bench(args) -> int:
    from ros_gpu_stereo_processor_tpu_torch import bench

    return bench.main(["--device", args.device])


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="tpu-stereo-torch",
        description="Stereo vision / SLAM engine, PyTorch + CUDA port")
    sub = ap.add_subparsers(dest="cmd", required=True)

    common = argparse.ArgumentParser(add_help=False)
    common.add_argument("--calib-left", required=True)
    common.add_argument("--calib-right", required=True)

    p = sub.add_parser("info", parents=[common])
    p.set_defaults(fn=cmd_info)

    p = sub.add_parser("run", parents=[common])
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--euroc", help="EuRoC dataset root (mav0/...)")
    p.add_argument("--encoding", default="mono8")
    p.add_argument("--outputs", default="disparity,disparity_vis,pointcloud")
    p.add_argument("--out-dir", default="./tpu_stereo_out")
    p.add_argument("--save-frames", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--queue-size", type=int, default=5)
    p.add_argument("--max-in-flight", type=int, default=2,
                   help="dispatched frames kept outstanding before joining")
    p.add_argument("--devices", type=int, default=0,
                   help="split each frame into row bands over N devices (0 = one device)")
    p.add_argument("--shard-mode", choices=["rows", "disp"], default="rows")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_run)

    p = sub.add_parser("compare", parents=[common])
    p.add_argument("--left")
    p.add_argument("--right")
    p.add_argument("--euroc", help="aggregate A/B over an EuRoC sequence")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--encoding", default="mono8")
    p.add_argument("--dump-dir", default="", help="write CSV/MAT/diff/epipolar artifacts here")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_compare)

    p = sub.add_parser("slam", parents=[common])
    p.add_argument("--euroc", required=True)
    p.add_argument("--out-dir", default="./tpu_slam_out")
    p.add_argument("--max-frames", type=int, default=0)
    p.add_argument("--features", type=int, default=512)
    p.add_argument("--keyframe-every", type=int, default=5)
    p.add_argument("--window", type=int, default=5)
    p.add_argument("--checkpoint", default="", help="torch.save the engine's state here")
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--async-mapping", action="store_true",
                   help="tracking/mapping split: track table + windowed BA on a worker")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_slam)

    # serve takes calibration optionally: without it, the daemon waits for
    # camera_info_{left,right}.yaml drops (src/StereoProcessor.cpp:51-77,144-155)
    p = sub.add_parser("serve")
    p.add_argument("--calib-left", default="")
    p.add_argument("--calib-right", default="")
    p.add_argument("--watch-dir", required=True,
                   help="directory containing left/ and right/ frame drops")
    p.add_argument("--out-dir", default="./tpu_serve_out")
    p.add_argument("--outputs", default="disparity,disparity_vis")
    p.add_argument("--encoding", default="mono8")
    p.add_argument("--queue-size", type=int, default=5)
    p.add_argument("--approximate-sync", action="store_true")
    p.add_argument("--idle-timeout", type=float, default=0.0,
                   help="exit after this many idle seconds (0 = run forever)")
    _add_bm_flags(p)
    p.set_defaults(fn=cmd_serve)

    p = sub.add_parser("bench")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                   help="where the bench runs (default: the card)")
    p.set_defaults(fn=cmd_bench)

    args = ap.parse_args(argv)
    if args.cmd in ("run", "compare") and not args.euroc and not (args.left and args.right):
        ap.error(f"{args.cmd} requires --euroc or --left/--right")
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
