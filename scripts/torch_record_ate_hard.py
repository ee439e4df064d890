#!/usr/bin/env python3
"""Run the hard layered sequence end to end with the PyTorch port and
record ATE_HARD_TORCH.json: the port's counterpart of
scripts/record_ate_hard.py, with the same arguments and settings.

    python3 scripts/torch_record_ate_hard.py [n_frames [width height]] \\
        [--algorithm=sgm] [--occluders=N] [--device cpu]

The scene (``utils/synth.py::make_layered_euroc``, seed 0): four depth
planes with occlusion boundaries, vignetting, gain and bias jitter, sensor
noise, ``--occluders`` independently-moving occluders (speed 0.3), exposure
banding 0.08, and frames n/2 and n/2 + 1 blurred and darkened so that
tracking breaks; a closed loop at 752×480 (400 frames) by default.  It is
rendered with the port's numpy renderer (whose frames differ from cv2's by
rounding only) in one process per core of the host,
written in the EuRoC layout into a temporary directory and read back by the
port's ``EurocReader``, the camera from the written calibration.  The
engine: 512 features, a keyframe every 4 frames, a 5-keyframe BA window;
48 disparities, block 11, texture 10, speckle 200, and with
``--algorithm=sgm`` SGM (4 paths, P1 10, P2 120); ``run_stream`` (depth
2), then ``detect_loop_closures`` and ``optimize_global``.

Runs on the card unless ``--device cpu``.  The record goes under the key
``<algorithm>`` (``<algorithm>_dynamic_stress`` with occluders) of
ATE_HARD_TORCH.json at the repository root, with the keys of ATE_HARD.json
(``slam_seconds_card`` in place of ``slam_seconds_cpu`` on the card), the
card's name and power limit, the render seconds, the median and p95 ms a
frame, BA ms per keyframe and ``optimize_global`` ms.  Exits 1 unless a run
without occluders relocalized at least once, found a closure and ends with
an ATE under 0.1 m after ``optimize_global``; a run with occluders is
recorded with no gate, as the reference records it."""

from __future__ import annotations

import json
import os
import statistics
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATE_GATE_M = 0.1


def scene_kwargs(n_frames: int, width: int, height: int, occluders: int) -> dict:
    """make_layered_euroc's arguments for the record's sequence."""
    return dict(n_frames=n_frames, width=width, height=height,
                degraded_frames=(n_frames // 2, n_frames // 2 + 1),
                dynamic_occluders=occluders, occluder_speed=0.3, exposure_banding=0.08)


def configs(port, algorithm: str):
    """(SlamConfig, PipelineConfig) of the record."""
    bm = dict(num_disparities=48, block_size=11, texture_threshold=10)
    if algorithm == "sgm":
        bm["algorithm"] = "sgm"
    return (port.SlamConfig(num_features=512, keyframe_every=4, window_size=5),
            port.PipelineConfig(stereobm=port.StereoBMConfig(**bm),
                                speckle=port.SpeckleConfig(max_speckle_size=200)))


def run_slam(port, frames, gt, model, algorithm: str, device, log=None) -> tuple:
    """``StereoSlam`` over ``frames`` ([(left, right, stamp)]) with
    ``run_stream``, then ATE before and after ``optimize_global``.  Returns
    (the engine, the record's measured fields).  Each frame's ms is the host
    time between two completed frames."""
    import numpy as np
    import torch

    from ros_gpu_stereo_processor_tpu_torch.utils.evaluate import ate_rmse

    slam_cfg, pipe_cfg = configs(port, algorithm)
    slam = port.StereoSlam(model, slam_cfg, pipe_cfg, device=device)
    sync = torch.cuda.synchronize if slam.device.type == "cuda" else (lambda: None)
    n_lost = n_reloc = 0
    per_frame_ms = []
    sync()
    t0 = last = time.perf_counter()
    for i, info in enumerate(slam.run_stream(iter(frames), depth=2)):
        now = time.perf_counter()
        per_frame_ms.append((now - last) * 1e3)
        last = now
        n_lost += bool(info["lost"])
        n_reloc += bool(info["relocalized"])
        if log and i % 50 == 0:
            log(f"frame {i}: lost={n_lost} reloc={n_reloc} ({now - t0:.1f} s)")
    sync()
    slam_s = time.perf_counter() - t0
    stages = slam.timer.as_dict()
    ate_before = float(ate_rmse(slam.trajectory(), gt))
    t1 = time.perf_counter()
    closures = slam.detect_loop_closures()
    detect_ms = (time.perf_counter() - t1) * 1e3
    t1 = time.perf_counter()
    n_used = slam.optimize_global()
    og_ms = (time.perf_counter() - t1) * 1e3
    ate_after = float(ate_rmse(slam.trajectory(), gt))
    steady = per_frame_ms[1:]
    return slam, {
        "frames_run": len(per_frame_ms),
        "keyframes": len(slam.store),
        "lost_frames": n_lost,
        "relocalized_frames": n_reloc,
        "loop_closures_detected": len(closures),
        "loop_closures_used": n_used,
        "ate_rmse_m_before_global": ate_before,
        "ate_rmse_m_after_global": ate_after,
        "slam_seconds": slam_s,
        "ms_per_frame_median": statistics.median(steady),
        "ms_per_frame_p95": float(np.percentile(steady, 95)),
        "first_frame_ms": per_frame_ms[0],
        "ba_ms_per_keyframe": stages["ba"]["mean_ms"] if "ba" in stages else None,
        "ba_calls": stages["ba"]["count"] if "ba" in stages else 0,
        "detect_loop_closures_ms": detect_ms,
        "optimize_global_ms": og_ms,
    }


def gate(rec: dict) -> list:
    """The reasons a record without occluders fails, or []."""
    bad = []
    if rec["relocalized_frames"] < 1:
        bad.append("no relocalization")
    if rec["loop_closures_detected"] < 1:
        bad.append("no loop closure")
    if not rec["ate_rmse_m_after_global"] < ATE_GATE_M:
        bad.append(f"ATE {rec['ate_rmse_m_after_global']} m after optimize_global "
                   f"(gate {ATE_GATE_M})")
    return bad


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args, algorithm, occluders, device = [], "bm", 0, "cuda"
    workers = os.cpu_count() or 1
    it = iter(argv)
    for a in it:
        if a.startswith("--algorithm="):
            algorithm = a.split("=", 1)[1]
        elif a.startswith("--occluders="):
            occluders = int(a.split("=", 1)[1])
        elif a == "--device":
            device = next(it)
        elif a.startswith("--"):
            raise SystemExit(f"unknown option {a}")
        else:
            args.append(a)
    n_frames = int(args[0]) if len(args) > 0 else 400
    width = int(args[1]) if len(args) > 1 else 752
    height = int(args[2]) if len(args) > 2 else 480

    import torch

    sys.path.insert(0, ROOT)
    import ros_gpu_stereo_processor_tpu_torch as port
    from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line, require_device
    from ros_gpu_stereo_processor_tpu_torch.utils.evaluate import load_euroc_groundtruth
    from ros_gpu_stereo_processor_tpu_torch.utils.io import EurocReader
    from ros_gpu_stereo_processor_tpu_torch.utils.synth import make_layered_euroc

    dev = require_device(device)
    on_card = dev.type == "cuda"
    card = card_line() if on_card else "cpu"
    print(f"device: {card}", flush=True)
    kw = scene_kwargs(n_frames, width, height, occluders)
    with tempfile.TemporaryDirectory(prefix="ate_hard_seq_") as root:
        t0 = time.perf_counter()
        cl, cr = make_layered_euroc(root, workers=workers, **kw)
        t_render = time.perf_counter() - t0
        print(f"rendered {n_frames} frames {width}x{height} in {t_render:.1f} s "
              f"({workers} workers)", flush=True)
        t0 = time.perf_counter()
        frames = [(f.left, f.right, f.stamp) for f in EurocReader(root)]
        t_read = time.perf_counter() - t0
        gt = load_euroc_groundtruth(root)
        model = port.StereoCameraModel.from_files(cl, cr)
    slam, rec = run_slam(port, frames, gt, model, algorithm, dev,
                         log=lambda m: print(m, flush=True))
    slam.pipeline.senders.shutdown()

    record = {
        "sequence": {
            "frames": n_frames, "size": [width, height],
            "scene": "4-depth layered planes (occlusions), vignetting, gain/bias jitter,"
                     f" sensor noise, {occluders} independently-moving occluders,"
                     " rolling-shutter-style exposure banding",
            "degraded_frames": list(kw["degraded_frames"]),
        },
        "matcher": algorithm,
        **{k: rec[k] for k in ("keyframes", "lost_frames", "relocalized_frames",
                               "loop_closures_detected", "loop_closures_used",
                               "ate_rmse_m_before_global", "ate_rmse_m_after_global")},
        ("slam_seconds_card" if on_card else "slam_seconds_cpu"): rec["slam_seconds"],
        "device": card,
        "render_seconds": t_render,
        "render_workers": workers,
        "read_seconds": t_read,
        **{k: rec[k] for k in ("ms_per_frame_median", "ms_per_frame_p95", "first_frame_ms",
                               "ba_ms_per_keyframe", "ba_calls", "detect_loop_closures_ms",
                               "optimize_global_ms")},
        "torch": torch.__version__,
    }
    if occluders:
        record["note"] = (
            "recorded with no ATE gate, as scripts/record_ate_hard.py records it: "
            "persistent independent motion over long horizons defeats frame-to-frame "
            "stereo VO without dynamic-object masking")
    out = os.path.join(ROOT, "ATE_HARD_TORCH.json")
    data = {}
    if os.path.exists(out):
        with open(out) as f:
            data = json.load(f)
    data[algorithm + ("_dynamic_stress" if occluders else "")] = record
    with open(out, "w") as f:
        json.dump(data, f, indent=1)
        f.write("\n")
    print(json.dumps(record, indent=1), flush=True)
    bad = [] if occluders else gate(rec)
    if bad:
        print(f"torch_record_ate_hard: {', '.join(bad)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
