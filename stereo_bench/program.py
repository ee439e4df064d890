"""The port's own spans and counters in a run of the served path: the
snapshot of the port's recorder (``utils/timing.py``, ``run.program``)
joined by pair, windowed, read into per-layer numbers, and the device
trace's idle gaps named from inside the program.

The recorder's clock is ``time.perf_counter_ns()``, the clock the loop
stamps (``time.perf_counter()``) and onto which the device trace maps the
card's timestamps, so its times (ns) compare with ``run.t0``, ``run.t1``,
``run.arrive``, ``run.done`` and the trace's gaps (s) as they are.
Windows follow the existing readers: the spans, or the pairs, that begin
in [``run.t0``, ``run.t1``].  Every reader returns None where the run
holds no snapshot (a port without the recorder) or nothing to read.

:func:`recording` turns the recorder on around ``loop.serve`` and keeps
each idle gap's interval of a traced run, for one block, by replacing
``loop.serve`` and ``trace.DeviceTrace`` there: what ``run.py`` and
``trace.py`` would do themselves once a change to the benchmark takes
these numbers in (``PERF.md`` §7).  ``scripts/torch_served_trace.py`` runs
a cell so.
"""

from __future__ import annotations

import contextlib
from collections import defaultdict
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

NS = 1e-9
SPAN = "span"


def snapshot(run):
    """The recorder's snapshot of ``run``, or None."""
    return getattr(run, "program", None)


@contextlib.contextmanager
def recording() -> Iterator[List]:
    """Within the block, each ``loop.serve`` runs with the port's recorder
    on (enabled just before it, read into ``run.program`` just after it,
    then disabled), and each device trace's summary carries ``gaps_host``
    (:func:`device_gaps`).  Yields the list that receives each ``Run``."""
    from ros_gpu_stereo_processor_tpu_torch.utils import timing
    from stereo_bench import loop, trace

    runs: List = []
    serve, device_trace = loop.serve, trace.DeviceTrace

    def recorded(*args, **kwargs):
        timing.enable()
        try:
            run = serve(*args, **kwargs)
            run.program = timing.snapshot()
        finally:
            timing.disable()
        runs.append(run)
        return run

    class GapTrace(device_trace):
        def summary(self, *args, **kwargs):
            out = super().summary(*args, **kwargs)
            if out is not None:
                out.gaps_host = device_gaps(self)
            return out

    loop.serve, trace.DeviceTrace = recorded, GapTrace
    try:
        yield runs
    finally:
        loop.serve, trace.DeviceTrace = serve, device_trace


def device_gaps(tracer) -> List[Tuple[float, float]]:
    """The stretches with nothing on the device in ``tracer``'s analysed
    window (``trace.DeviceTrace``: the marker, the window and the union of
    the device operations as its ``summary`` finds them), in host seconds;
    empty without the marker."""
    events = [e for e in tracer.prof.events() if str(e.device_type).endswith("CUDA")]
    names = [e.name for e in events]
    marks = [k for k, n in enumerate(names) if "spin" in n or "sleep" in n]
    if not marks:
        return []
    start = np.array([e.time_range.start for e in events], np.float64)   # µs
    end = np.array([e.time_range.end for e in events], np.float64)
    offset = start[marks[0]] - tracer.t_mark * 1e6
    wa, wb = tracer.t_start * 1e6 + offset, tracer.t_stop * 1e6 + offset
    sel = (start >= wa) & (start < wb)
    sel[marks[0]] = False
    if not sel.any():
        return []
    order = np.argsort(start[sel])
    s_, e_ = np.clip(start[sel][order], wa, wb), np.clip(end[sel][order], wa, wb)
    gaps = [(wa, s_[0])] if s_[0] > wa else []
    cur = e_[0]
    for a, b in zip(s_[1:], e_[1:]):
        if a > cur:
            gaps.append((cur, a))
        cur = max(cur, b)
    if cur < wb:
        gaps.append((cur, wb))
    return [((a - offset) / 1e6, (b - offset) / 1e6) for a, b in gaps]


# -- records by name, by pair --------------------------------------------------

def _named(snap, name: str) -> Dict[str, np.ndarray]:
    """The closed records named ``name``: their columns, times in s."""
    idx = snap.of(name)
    r = snap.records
    out = {f: r[f][idx] for f in ("seq", "n", "cpu", "tag", "thread", "parent")}
    out["t0"], out["t1"] = r["t0"][idx] * NS, r["t1"][idx] * NS
    return out


def _began_in(x: Dict[str, np.ndarray], run) -> np.ndarray:
    return (x["t0"] >= run.t0) & (x["t0"] <= run.t1)


def pairs(snap) -> Dict[str, np.ndarray]:
    """Per pair, indexed by ``seq``: ``pair`` (the ``ingest.pair``
    instant), ``deliver`` (``ingest.deliver``), ``enqueue``
    (``publish.enqueue``'s start), ``landing`` (the pair's earliest
    landed host copy: a ``sender.copy_wait``'s end where the copy had not
    landed when the wait began, else the wait's start, by which it had: an
    upper bound), ``published`` (its last ``sender.publish``'s end), in s,
    NaN where missing; ``feed_s`` (the ``ingest.feed`` call that completed
    the pair); ``wait_cpu_ns`` (thread CPU in its ``sender.copy_wait``s);
    ``sends``, ``publishes`` (its ``sender.queued`` and ``sender.publish``
    spans)."""
    r = snap.records
    m = int(r["seq"].max()) + 1 if len(r["seq"]) and r["seq"].max() >= 0 else 0
    out: Dict[str, np.ndarray] = {}

    def at(name, value, ufunc):
        x = _named(snap, name)
        k = x["seq"] >= 0
        a = np.full(m, np.nan)
        ufunc.at(a, x["seq"][k], value(x)[k])
        return a

    out["pair"] = at("ingest.pair", lambda x: x["t0"], np.fmin)
    out["deliver"] = at("ingest.deliver", lambda x: x["t0"], np.fmin)
    out["enqueue"] = at("publish.enqueue", lambda x: x["t0"], np.fmin)
    out["landing"] = at("sender.copy_wait",
                        lambda x: np.where(x["n"] > 0, x["t1"], x["t0"]), np.fmin)
    out["published"] = at("sender.publish", lambda x: x["t1"], np.fmax)
    out["feed_s"] = at("ingest.feed", lambda x: x["t1"] - x["t0"], np.fmax)
    w = _named(snap, "sender.copy_wait")
    k = (w["seq"] >= 0) & (w["cpu"] >= 0)
    out["wait_cpu_ns"] = np.bincount(w["seq"][k], w["cpu"][k], minlength=m)[:m]
    for key, name in (("sends", "sender.queued"), ("publishes", "sender.publish")):
        s = _named(snap, name)["seq"]
        out[key] = np.bincount(s[s >= 0], minlength=m)[:m]
    return out


def _median_ms(x: np.ndarray) -> Optional[float]:
    x = x[np.isfinite(x)]
    return float(np.median(x) * 1e3) if len(x) else None


# -- the per-layer numbers -------------------------------------------------------

def ingest_queue_ms_p50(run) -> Optional[float]:
    """Median ms from a pair's completion in ``feed`` (``ingest.pair``) to
    its delivery to the consumer (``ingest.deliver``), over the pairs
    completed in the window: the ring, the uploader and the staging
    queue."""
    snap = snapshot(run)
    if snap is None:
        return None
    p = pairs(snap)
    sel = (p["pair"] >= run.t0) & (p["pair"] <= run.t1)
    return _median_ms(p["deliver"][sel] - p["pair"][sel])


def graph_launch_ms_per_pair(run) -> Optional[float]:
    """Host ms a pair inside ``CUDAGraph.replay()`` (``graph.replay``) over
    the pairs stepped (``step.batch`` and ``step.frame``), spans begun in
    the window: the part of ``dispatch_ms_per_pair`` that is the launch
    itself (0 where no graph ran, as on the CPU)."""
    snap = snapshot(run)
    if snap is None:
        return None
    stepped = sum(int(x["n"][_began_in(x, run)].sum())
                  for x in (_named(snap, "step.batch"), _named(snap, "step.frame")))
    if not stepped:
        return None
    g = _named(snap, "graph.replay")
    sel = _began_in(g, run)
    return float((g["t1"][sel] - g["t0"][sel]).sum() * 1e3 / stepped)


def card_queue_ms_p50(run) -> Optional[float]:
    """Median ms from a pair's ``publish.enqueue`` to its host copy's
    landing, over the pairs enqueued in the window: the card's queue ahead
    of the pair, its step and the D→H copy.  The landing is the end of the
    pair's earliest ``sender.copy_wait`` that waited, or else the start of
    that wait, by which the copy had landed: an upper bound, which holds
    the time the send queued in the pool after the copy landed."""
    snap = snapshot(run)
    if snap is None:
        return None
    p = pairs(snap)
    sel = (p["enqueue"] >= run.t0) & (p["enqueue"] <= run.t1)
    return _median_ms(p["landing"][sel] - p["enqueue"][sel])


def sender_lag_ms_p50(run) -> Optional[float]:
    """Median ms from a pair's host copy landing (as :func:`card_queue_ms_p50`
    takes it) to the end of its last ``sender.publish``, over the pairs
    enqueued in the window: the sender pool's queue, the message builds
    and the publisher callbacks."""
    snap = snapshot(run)
    if snap is None:
        return None
    p = pairs(snap)
    sel = (p["enqueue"] >= run.t0) & (p["enqueue"] <= run.t1)
    return _median_ms(p["published"][sel] - p["landing"][sel])


def sender_wait_cpu_ms_per_pair(run) -> Optional[float]:
    """Thread CPU ms inside ``sender.copy_wait`` (the workers' wait for the
    host copies) a pair, over the pairs enqueued in the window and
    published: what the workers' waiting takes from the host's other
    threads."""
    snap = snapshot(run)
    if snap is None:
        return None
    p = pairs(snap)
    sel = (p["enqueue"] >= run.t0) & (p["enqueue"] <= run.t1) & (p["publishes"] > 0)
    return float(p["wait_cpu_ns"][sel].sum() / 1e6 / sel.sum()) if sel.any() else None


METRICS = {f.__name__: f for f in (ingest_queue_ms_p50, graph_launch_ms_per_pair,
                                   card_queue_ms_p50, sender_lag_ms_p50,
                                   sender_wait_cpu_ms_per_pair)}


def metrics(run) -> Dict[str, float]:
    """Every number of :data:`METRICS` that ``run`` has."""
    out = {}
    for name, read in METRICS.items():
        v = read(run)
        if v is not None:
            out[name] = v
    return out


# -- checks and breakdowns -------------------------------------------------------

def chains(run, slack_s: float = 1e-4) -> Dict[str, float]:
    """The pairs the loop saw published in the window (``run.in_window()``,
    pair index = ``seq``): how many have their whole chain in the recorder
    (``ingest.pair``, ``ingest.deliver``, ``publish.enqueue``, a landing,
    and a ``sender.publish`` for each send), and for how many of those the
    recorder's ``ingest.pair`` → last ``sender.publish`` end falls short of
    the loop's arrive → done by 0 to the completing ``feed``'s span +
    ``slack_s`` (the loop stamps ``arrive`` before that ``feed`` and ``done``
    inside the last publisher callback)."""
    snap = snapshot(run)
    if snap is None:
        return {}
    p = pairs(snap)
    idx = np.nonzero(run.in_window())[0]
    idx = idx[idx < len(p["pair"])]
    whole = idx[np.isfinite(p["pair"][idx]) & np.isfinite(p["deliver"][idx])
                & np.isfinite(p["enqueue"][idx]) & np.isfinite(p["landing"][idx])
                & np.isfinite(p["published"][idx]) & (p["sends"][idx] >= 1)
                & (p["publishes"][idx] == p["sends"][idx])]
    d = (run.done[whole] - run.arrive[whole]) - (p["published"][whole] - p["pair"][whole])
    over = d > p["feed_s"][whole] + slack_s
    agree = (d >= 0) & ~over
    return {"published": int(len(run.in_window().nonzero()[0])), "whole": int(len(whole)),
            "agree": int(agree.sum()), "under": int((d < 0).sum()), "over": int(over.sum()),
            "short_ms_min": float(d.min() * 1e3) if len(d) else float("nan"),
            "short_ms_max": float(d.max() * 1e3) if len(d) else float("nan"),
            "disagree_seqs": [int(k) for k in whole[~agree][:20]]}


def _thread_of(snap, names: Tuple[str, ...]) -> int:
    r = snap.records
    t = r["thread"][np.isin(r["name"], [snap.id(n) for n in names])]
    return int(np.bincount(t).argmax()) if len(t) else -1


def label_gaps(snap, gaps: List[Tuple[float, float]]) -> List[Tuple[str, float]]:
    """Each idle gap (host s) labelled by the innermost span open on the
    consumer thread (the one that steps) at its middle, or, where that is
    ``ingest.staged_wait``, by the uploader thread's (``upload.*``), or
    ``between_spans``; seconds summed by label, largest first."""
    if snap is None or not gaps:
        return []
    r = snap.records
    lo, hi = min(a for a, _ in gaps) / NS, max(b for _, b in gaps) / NS
    spans = (np.isin(r["name"], [k for k, kind in enumerate(snap.kinds) if kind == SPAN])
             & (r["t1"] >= r["t0"]) & (r["t1"] >= lo) & (r["t0"] <= hi))
    consumer = _thread_of(snap, ("step.batch", "step.frame"))
    uploader = _thread_of(snap, ("upload.stage",))

    def innermost(thread: int, t: float) -> Optional[str]:
        k = np.nonzero(spans & (r["thread"] == thread) & (r["t0"] <= t) & (r["t1"] >= t))[0]
        return snap.names[r["name"][k[np.argmax(r["t0"][k])]]] if len(k) else None

    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2 / NS
        label = innermost(consumer, mid) or "between_spans"
        if label == "ingest.staged_wait":
            label = innermost(uploader, mid) or label
        idle[label] += b - a
    return sorted(idle.items(), key=lambda kv: -kv[1])


def gauge(snap, name: str, run) -> Optional[Dict[str, float]]:
    """Median and largest value of the gauge ``name`` over the window."""
    if snap is None:
        return None
    x = _named(snap, name)
    v = x["n"][_began_in(x, run)]
    return {"median": float(np.median(v)), "max": int(v.max())} if len(v) else None


def span_ms(snap, name: str, run) -> Optional[Dict[str, float]]:
    """Count, median and summed wall ms of the spans ``name`` begun in the
    window."""
    if snap is None:
        return None
    x = _named(snap, name)
    sel = _began_in(x, run)
    d = (x["t1"] - x["t0"])[sel] * 1e3
    return ({"count": int(sel.sum()), "median_ms": float(np.median(d)),
             "total_ms": float(d.sum())} if len(d) else None)


def waited_share(snap, run) -> Optional[float]:
    """The share of the ``sender.copy_wait`` spans begun in the window whose
    host copy had not landed when the wait began."""
    if snap is None:
        return None
    x = _named(snap, "sender.copy_wait")
    n = x["n"][_began_in(x, run)]
    return float((n > 0).mean()) if len(n) else None
