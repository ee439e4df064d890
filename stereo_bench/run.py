"""One run of one cell:

    python3 -m stereo_bench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (counted in ``setup_s``, from the process's start to the window's
first timed pair): imports, the card, the kernel library (built into the
port's ``build/`` directory by the first run of a checkout, loaded from
there after), the replayed pool of pairs made from the seed, the pipeline
(its rectification maps from the calibration numbers), the frame step's
graph captured at the cell's own batch, and a warm-up of the served loop.
Then the window (``loop.py``); in a ``--trace 1`` run a profiled stretch
after it (``trace.py``); the drain; the peak device memory of the process
so far (set-up's first eager step included); the port's state freed; the
check against the reference (``check.py``).

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics, or
with ``--trace 1`` its per-layer ones), ``device``, with ``--trace 1`` a
``breakdown``, and last ``checks``: each number compared with its limit,
which the last lines of standard error repeat.  No card, fewer cards than
the cell asks for, or JAX or the JAX package loaded: no result, exit 1.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "ros_gpu_stereo_processor_tpu")
TRACE_S = 0.75          # the profiled stretch of a traced run
K1_SYMBOL = "remap_bilinear_u8"   # K1's C entry point: its launches count the pairs


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def forbidden_modules() -> list:
    """Loaded modules whose top-level name, whole, is JAX's or the JAX
    package's (the port's name only begins with the latter)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # caches inside the checkout, at fixed paths
    build = ROOT / "ros_gpu_stereo_processor_tpu_torch" / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    os.environ.setdefault("USE_FLAX", "0")

    from stereo_bench import spec

    cell = spec.cell(args.workload)
    t = time.perf_counter()
    import torch

    import_s = time.perf_counter() - t
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        log(f"no result: {cell['name']} needs {cell['chips']} CUDA device(s); "
            f"torch.cuda.is_available()={torch.cuda.is_available()}, "
            f"device_count={torch.cuda.device_count()}")
        return 1
    out = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0),
                  setup={"import_torch_s": import_s})
    found = forbidden_modules()
    if found:
        log(f"no result: modules {found} were loaded")
        return 1
    for k, c in out["checks"].items():
        log(f"check {k}: {c['value']} (limit {c['limit']})")
    print(json.dumps(out), flush=True)
    return 0


def execute(cell, seed: int, seconds: float, traced: bool, dev, shape=None,
            setup=None, t_start: float = T_START) -> dict:
    """The run of ``cell`` (``spec.cell``) on ``dev``; returns the result's
    object.  ``shape`` = (H, W) replaces the configuration's image size, for
    tests on the CPU."""
    import numpy as np
    import torch

    setup = dict(setup or {})
    t = time.perf_counter()
    from stereo_bench import check, inputs, loop, spec, trace
    from ros_gpu_stereo_processor_tpu_torch.config import Outputs
    from ros_gpu_stereo_processor_tpu_torch.ops import _build
    from ros_gpu_stereo_processor_tpu_torch.runtime.ingest import native_available
    setup["import_port_s"] = time.perf_counter() - t
    cuda = dev.type == "cuda"
    if cuda:
        t = time.perf_counter()
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        from ros_gpu_stereo_processor_tpu_torch.utils.device import card_line
        card = card_line()
        setup["cuda_init_s"] = time.perf_counter() - t
        log(f"card: {card}; torch {torch.__version__} CUDA {torch.version.cuda}")
        t = time.perf_counter()
        _build.library()
        setup["kernel_load_s"] = time.perf_counter() - t

    cfg_data, traffic = cell["config_data"], cell["traffic_data"]
    t = time.perf_counter()
    lefts, rights = inputs.pool(cfg_data, seed, int(traffic["pool_pairs"]), shape)
    setup["inputs_s"] = time.perf_counter() - t

    t = time.perf_counter()
    pipe, ing = build_node(cfg_data, traffic, dev, shape)
    outputs = Outputs.of(*cfg_data["outputs"])
    setup["node_s"] = time.perf_counter() - t
    log(f"native ring and pairer: {native_available()}")

    t = time.perf_counter()
    capture(pipe, traffic, outputs, lefts, rights, dev)
    setup["capture_s"] = time.perf_counter() - t
    log("set-up split: " + ", ".join(f"{k} {v:.3f}" for k, v in setup.items()))

    sampler = loop.Sampler(int(cfg_data["check"]["sample_pairs"]), seed)
    tracer = trace.DeviceTrace() if traced and cuda else None
    _build.reset_launch_counts()
    run = loop.serve(pipe, ing, lefts, rights, traffic, outputs, seconds, t_start,
                     sampler, tracer=tracer, trace_s=TRACE_S, log=log)
    peak = 0
    if cuda:
        torch.cuda.synchronize(dev)
        peak = int(torch.cuda.max_memory_allocated(dev))
    if tracer is not None:
        k1 = _build.kernels().get(K1_SYMBOL)
        run.trace = tracer.summary(run.spans, run.step_return,
                                   k1.launches / run.pairs if k1 is not None else 0.0)
        tracer.prof = None
    del pipe, ing
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    t = time.perf_counter()
    numbers, compared, rounds = check.check(sampler.kept, (run.t0, run.t_end), run.done,
                                            lefts, rights, cfg_data, dev, shape=shape)
    run.rounds = sum(rounds) / len(rounds) if rounds else None
    log(f"reference: {compared} pairs compared, {len(rounds)} distinct, "
        f"{time.perf_counter() - t:.3f} s; speckle rounds needed {rounds}")

    in_win = run.in_window()
    failed = int((run.done == 0).sum()) + len(run.send_errors)
    attempted = int(in_win.sum()) + failed
    limits = cfg_data["limits"]
    correct = check.verdict(numbers, limits, compared, failed)
    span = run.t_end - run.t0
    log(f"window {span:.3f} s ({run.t1 - run.t0:.3f} s of dispatch, then the drain): "
        f"{int(in_win.sum())} pairs published, {run.pairs} fed, failed {failed}, "
        f"{run.ring_stats}, send errors {run.send_errors}")
    per_s = np.histogram(run.done[in_win] - run.t0, bins=max(1, int(span)),
                         range=(0, max(1, int(span))))[0]
    log(f"published a second: {per_s.tolist()}")
    least = loop.least_a_second(run)
    log(f"steps the card still had queued at each dispatch, the fewest a second: "
        f"{[least[k] for k in sorted(least)]}")
    log(f"CPU seconds a second by thread over the window: {run.cpu}")

    if traced:
        metrics = {}
        for m in spec.metrics_for(cell["name"], "per_layer"):
            v = spec.reader(m["name"]).read(run, cell)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        lat = (run.done[in_win] - run.arrive[in_win]) * 1e3
        e2e = {
            "pairs_per_s": int(in_win.sum()) / (run.t_end - run.t0),
            "latency_ms_p95": float(np.percentile(lat, 95)) if len(lat) else None,
            "setup_s": run.setup_s,
        }
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
                   for m in spec.metrics_for(cell["name"], "end_to_end")
                   if e2e.get(m["name"]) is not None}
    device = {"platform": "gpu" if cuda else "cpu",
              "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
              "count": 1, "memory_peak_bytes": peak}
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if traced and run.trace is None:
        log("the profiler recorded no device operation: device metrics not measured")
    elif traced:
        device["busy_s"], device["window_s"] = run.trace.busy_s, run.trace.window_s
        top = sorted(run.trace.op_s.items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": [[k, v] for k, v in run.trace.idle_gaps[:10]]}
    checks = {k: {"value": numbers[k], "limit": limits[k]} for k in check.NUMBERS}
    checks["pairs_compared"] = {"value": compared, "limit": 1}
    checks["failed"] = {"value": failed, "limit": 0}
    out["checks"] = checks
    return out


def build_node(cfg, traffic, dev, shape=None):
    """The port's pipeline, its camera model made from the configuration's
    calibration numbers (as the node's CameraInfo callback makes it), and
    its ingest."""
    import numpy as np

    from ros_gpu_stereo_processor_tpu_torch import StereoPipeline
    from ros_gpu_stereo_processor_tpu_torch.config import (
        PipelineConfig, SpeckleConfig, StereoBMConfig)
    from ros_gpu_stereo_processor_tpu_torch.runtime import StreamingIngest
    from ros_gpu_stereo_processor_tpu_torch.utils.calib import CameraCalib, StereoCameraModel

    H, W = shape or (cfg["image"]["height"], cfg["image"]["width"])
    cal = cfg["calibration"]
    model = StereoCameraModel.from_calibs(*(
        CameraCalib(W, H, np.array(cal[f"K_{s}"]), np.array(cal[f"D_{s}"]),
                    np.array(cal[f"R_{s}"]), np.array(cal[f"P_{s}"]), s)
        for s in ("left", "right")))
    pcfg = PipelineConfig(
        max_in_flight=int(traffic["max_in_flight"]), disparity_wire=cfg["disparity_wire"],
        stereobm=StereoBMConfig(**cfg["matcher"]), speckle=SpeckleConfig(**cfg["speckle"]))
    pipe = StereoPipeline(model, pcfg, device=dev)
    ing = StreamingIngest((H, W), capacity=int(traffic["ring_capacity"]), exact=True,
                          drop_on_full=False, device=dev)
    return pipe, ing


def capture(pipe, traffic, outputs, lefts, rights, dev) -> None:
    """The frame step at the cell's own batch, run twice before the window
    (the first call runs eagerly and captures the graph, the second replays
    it); a per-pair step is published too."""
    import torch

    B = int(traffic["batch"])
    L = torch.stack([torch.from_numpy(lefts[k % len(lefts)]) for k in range(B)]).to(dev)
    R = torch.stack([torch.from_numpy(rights[k % len(rights)]) for k in range(B)]).to(dev)
    for _ in range(2):
        if traffic["step"] == "process_batch":
            pipe.process_batch(L, R, outputs)
        else:
            res = pipe.process(L[0], R[0], outputs)
            pipe.enqueue_send(res, outputs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    pipe.senders.wait_all()


if __name__ == "__main__":
    sys.exit(main())
