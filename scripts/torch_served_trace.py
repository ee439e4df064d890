"""One run of a benchmark cell with the port's recorder on, and what the
recorder saw; or the recorder's own cost.

    python3 scripts/torch_served_trace.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--out FILE]
    python3 scripts/torch_served_trace.py --cost [--records N]

The first form is ``python3 -m stereo_bench.run`` with the same arguments
(its result line, on standard output, is the same) inside
``stereo_bench.program.recording()``: the recorder
(``ros_gpu_stereo_processor_tpu_torch/utils/timing.py``) is on from just
before the served loop to just after it, and a traced run keeps each idle
gap of the device trace.  Then one JSON line, and ``FILE`` where given:
the per-layer numbers of ``stereo_bench/program.py``, the idle gaps named
from inside the program, the chain of spans of each pair published in the
window, launches by kernel, graph captures, the ring's and pairer's
counts, the gauges, the publish bytes and DG launches a pair stepped, the
DG walk the device trace names, the bytes of one step's SGM volumes (from
the configuration), and each span's count and wall ms in the window.

The second form times the recorder's calls on this host, one thread, on
and off, in ns a call.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

from stereo_bench import run as bench_run  # noqa: E402  (its clock starts the set-up)


def served(argv) -> int:
    from stereo_bench import program, spec

    ap = argparse.ArgumentParser()
    ap.add_argument("--out")
    ap.add_argument("--workload", required=True)
    args, rest = ap.parse_known_args(argv)
    rest = ["--workload", args.workload] + rest
    with program.recording() as runs:
        rc = bench_run.main(rest)
    if rc != 0 or not runs:
        return rc or 1
    run = runs[0]
    snap = run.program
    spans = sorted({snap.names[k] for k in snap.records["name"]
                    if snap.kinds[k] == program.SPAN})
    out = {
        "metrics": program.metrics(run),
        "chains": program.chains(run),
        "idle_gaps_program": [[k, v] for k, v in program.label_gaps(
            snap, getattr(run.trace, "gaps_host", []))[:10]] if run.trace is not None else None,
        "counters": {k: v for k, v in snap.counters.items() if v},
        "gauges": {g: program.gauge(snap, g, run)
                   for g in ("ring.depth", "staged.depth", "sender.depth")},
        "per_pair": per_pair(snap),
        "dg_walk_ms_per_pair": dg_walks(run.trace),
        "sgm_volume_bytes": volume_bytes(spec.cell(args.workload)["config_data"]),
        "spans": {name: program.span_ms(snap, name, run) for name in spans},
        "copy_waits_that_waited": program.waited_share(snap, run),
        "records": int(len(snap.records["name"])),
        "lost": snap.lost,
        "threads": list(snap.threads),
    }
    line = json.dumps(out)
    print("program: " + line, flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(line + "\n")
    return 0


def per_pair(snap) -> dict:
    """The publish layer's bytes and DG's launches over the whole recording
    (warm-up included) a pair stepped: the pairs of its ``step.batch``
    spans and one a ``step.frame``."""
    r = snap.records
    pairs = int(r["n"][r["name"] == snap.id("step.batch")].sum()
                + (r["name"] == snap.id("step.frame")).sum())
    return {"pairs_stepped": pairs,
            **{k: v / pairs for k, v in snap.counters.items()
               if pairs and k.startswith(("publish.bytes", "launches.sgm_aggregate_diagonal"))}}


def dg_walks(summary):
    """Device ms a pair of DG's two walks, by the kernel the device trace
    names (``csrc/sgm_diagonal.cu``): the two-pass walk and the pair walk;
    None untraced."""
    if summary is None:
        return None
    return {"two_pass": summary.ms_per_pair(("sgm_diagonal_kernel",)),
            "pair": summary.ms_per_pair(("sgm_diagonal_pair_kernel",))}


def volume_bytes(cfg) -> int:
    """Bytes of the volumes one SGM call hands K6 on the configuration's
    image, at the storage widths ``costmodel.sgm_storage_bytes`` gives: the
    cost volume and one excess volume for each pair of paths."""
    from stereo_bench import costmodel

    m = cfg["matcher"]
    cb, eb = costmodel.sgm_storage_bytes(m)
    n = cfg["image"]["height"] * cfg["image"]["width"] * m["num_disparities"]
    return n * (cb + m["sgm_paths"] // 2 * eb)


def cost(records: int) -> int:
    """ns a call of each recorder call, on and off, over ``records`` calls."""
    import threading

    from ros_gpu_stereo_processor_tpu_torch.utils import timing

    nid = timing.intern("cost.span")
    gid = timing.intern("cost.gauge", timing.GAUGE)

    def per_call(fn) -> float:
        t = time.perf_counter_ns()
        fn()
        return (time.perf_counter_ns() - t) / records

    def off_site():
        for _ in range(records):
            s = timing.begin(nid) if timing.ON else -1
            if s >= 0:
                timing.end(s)

    def bare():
        for _ in range(records):
            s = -1
            if s >= 0:
                pass

    def spans():
        for i in range(records):
            s = timing.begin(nid, i) if timing.ON else -1
            if s >= 0:
                timing.end(s)

    def spans_cpu():
        for i in range(records):
            s = timing.begin(nid, i, cpu=True) if timing.ON else -1
            if s >= 0:
                timing.end(s)

    def instants():
        for i in range(records):
            if timing.ON:
                timing.instant(nid, i)

    def gauges():
        for i in range(records):
            if timing.ON:
                timing.gauge(gid, i)

    out = {"records": records, "thread": threading.current_thread().name}
    timing.disable()
    out["off_site_ns"] = per_call(off_site) - per_call(bare)
    timing.enable(capacity=4 * records)
    out["span_ns"] = per_call(spans)
    out["span_with_cpu_ns"] = per_call(spans_cpu)
    out["instant_ns"] = per_call(instants)
    out["gauge_ns"] = per_call(gauges)
    t = time.perf_counter()
    snap = timing.snapshot()
    out["snapshot_s"] = time.perf_counter() - t
    out["kept"], out["lost"] = int(len(snap.records["name"])), snap.lost
    timing.disable()
    print("cost: " + json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if "--cost" in argv:
        ap = argparse.ArgumentParser()
        ap.add_argument("--cost", action="store_true")
        ap.add_argument("--records", type=int, default=200_000)
        return cost(ap.parse_args(argv).records)
    return served(argv)


if __name__ == "__main__":
    sys.exit(main())
