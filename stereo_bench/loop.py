"""The one traffic generator: a recorded sequence replayed through the node's
served path, as a traffic mix (``traffic/<name>.json``) describes it.

  * The producer: one thread calls ``StreamingIngest.feed`` for the left
    and then the right image of pair ``i`` (stamped ``float(i)``, exact
    pairing), as a recording's player delivers both topics in time order.
    One thread, not one a side: the native ring is a single-producer ring
    (``ring_push`` claims its slot by a plain load and store of ``head``),
    and two threads feeding at once lose pairs.  The ring does not drop
    (``drop_on_full=False``), so a full ring holds the producer back: a
    closed loop, as fast as the node takes the pairs.
  * The consumer (this thread): ``frames_prefetch(stacked=True)`` stages
    each pair through pinned memory on the uploader's stream; the frame
    step is ``process_batch`` of ``batch`` pairs (``step:
    "process_batch"``), each pair then its own ``FrameResult`` holding its
    slice of the stacked outputs and the batch's event, or ``process`` per
    pair (``step: "process"``); at most ``max_in_flight`` steps are
    outstanding on the card (the consumer waits for the oldest first, as
    ``process`` itself does, on an event that blocks rather than spins);
    every pair goes through ``enqueue_send``.  A deep ``max_in_flight``
    dispatches seconds of work ahead, so the card stays fed while the
    host stands still.
  * The subscriber: a publisher callback on the pipeline's ``SenderPool``
    for each output stamps its message's pair as it is published.

The run's phases, by the consumer's clock: a warm-up of ``warmup_s``
(a fixed length, so that set-up does not wait on the host's speed); the
window of ``seconds``; in a traced
run a short profiled stretch after it; then the producer stops at a
multiple of the batch, nothing more is sent once the ring is empty, and
everything sent is waited for: the clock read after that wait closes the
window, so every pair published from the window's start counts, over all
of that time.  Spans are taken around the calls into each layer, from
this file, on the host's clock; ``feed`` also by its thread's CPU time (a
full ring blocks it, which costs no CPU).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

CAPACITY = 1 << 18          # pairs a run can stamp
STAGED_TIMEOUT_S = 3.0       # the ring empty this long ends the stream: a fault, or the drain's end
now = time.perf_counter


def thread_cpu() -> Dict[str, float]:
    """This process's CPU seconds by thread name (``/proc/self/task``);
    empty where ``/proc`` is not there."""
    import os

    names = {t.native_id: t.name for t in threading.enumerate()}
    out: Dict[str, float] = {}
    try:
        tick = os.sysconf("SC_CLK_TCK")
        for tid in os.listdir("/proc/self/task"):
            with open(f"/proc/self/task/{tid}/stat") as f:
                raw = f.read()
            name = names.get(int(tid), raw[raw.index("(") + 1:raw.rindex(")")])
            fields = raw[raw.rindex(")") + 2:].split()
            out[name] = out.get(name, 0.0) + (int(fields[11]) + int(fields[12])) / tick
    except (OSError, ValueError):
        return {}
    return out


def cpu_use(a: Dict[str, float], b: Dict[str, float], seconds: float) -> str:
    """This process's busiest threads between two :func:`thread_cpu`
    readings, in CPU seconds a second."""
    busy = sorted(((b.get(k, 0.0) - v) / seconds, k) for k, v in a.items())
    return ", ".join(f"{k} {v:.2f}" for v, k in busy[::-1][:8] if v > 0.01) or "not read"


def outstanding(events: deque) -> int:
    """Steps in ``events`` (oldest first, recorded on one stream, so the
    finished ones are a prefix) that the card has not finished."""
    lo, hi = 0, len(events)
    while lo < hi:
        mid = (lo + hi) // 2
        e = events[mid]
        if e is None or e.query():
            lo = mid + 1
        else:
            hi = mid
    return len(events) - lo


class Sampler:
    """A seeded sample of the pairs published in the window: the ``k`` pairs
    with the smallest keys (drawn from the seed per pair index) among those
    whose first message was published while the window was open.  A pair's
    messages are copied as they are published, from the sender's thread;
    a pair pushed out of the sample drops its copies."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.keys = np.random.default_rng([seed % (1 << 63), 7]).random(CAPACITY)
        self.kept: Dict[int, Dict[str, tuple]] = {}
        self.open = False
        self._lock = threading.Lock()

    def offer(self, i: int, kind: str, arrays) -> None:
        with self._lock:
            if i not in self.kept:
                if not self.open:
                    return
                if len(self.kept) >= self.k:
                    worst = max(self.kept, key=lambda j: self.keys[j])
                    if self.keys[i] >= self.keys[worst]:
                        return
                    del self.kept[worst]
                self.kept[i] = {}
            self.kept[i][kind] = tuple(np.array(a, copy=True) for a in arrays)


@dataclasses.dataclass
class Run:
    """What one run recorded, on the host's clock (``time.perf_counter``
    seconds): per pair index, its arrival at the ingest (the right image's
    ``feed`` call, which completes it), the frame step's return and its last publish; spans of
    the consumer's calls; ``feed``'s CPU ms per pair; the window."""

    pairs: int                       # pairs fed (indices 0 .. pairs-1)
    arrive: np.ndarray
    step_return: np.ndarray
    done: np.ndarray                 # the pair's last publish; 0 if never
    feed_cpu_ms: np.ndarray          # both images' feed calls, CPU ms
    spans: Dict[str, np.ndarray]     # name → (n, 3): start, end, pairs
    t0: float
    t1: float                        # the last dispatch of the window's traffic
    t_end: float                     # the clock after every pair sent was published
    setup_s: float
    send_errors: List[str]
    ring_stats: Dict[str, int]
    cpu: str = ""                    # this process's CPU by thread over the window
    trace: Optional[object] = None   # trace.Summary of a traced run
    rounds: Optional[float] = None   # speckle rounds the inputs need (reference)
    ahead: Optional[np.ndarray] = None   # (host time, steps the card still had) before each dispatch

    def in_window(self) -> np.ndarray:
        """The pairs published from the window's start to its close."""
        return (self.done >= self.t0) & (self.done <= self.t_end)

    def span_total(self, name: str) -> float:
        """Seconds of the ``name`` spans that began in the window."""
        s = self.spans.get(name)
        if s is None or not len(s):
            return 0.0
        sel = (s[:, 0] >= self.t0) & (s[:, 0] <= self.t1)
        return float((s[sel, 1] - s[sel, 0]).sum())

    def span_pairs(self, name: str) -> int:
        s = self.spans.get(name)
        if s is None or not len(s):
            return 0
        sel = (s[:, 0] >= self.t0) & (s[:, 0] <= self.t1)
        return int(s[sel, 2].sum())


class _Producer:
    """The thread feeding pair ``i`` = pool[i % P], left then right, until
    the consumer sets ``stop_at``."""

    def __init__(self, ing, lefts, rights, arrive: np.ndarray, cpu_ns: np.ndarray):
        self.ing, self.lefts, self.rights = ing, lefts, rights
        self.arrive, self.cpu_ns = arrive, cpu_ns
        self.fed = 0
        self.stop_at = CAPACITY
        self.error: Optional[BaseException] = None
        self.thread = threading.Thread(target=self._run, daemon=True, name="producer")

    def _run(self) -> None:
        try:
            P = len(self.lefts)
            i = 0
            while i < self.stop_at:
                c = time.thread_time_ns()
                self.ing.feed("left", self.lefts[i % P], float(i))
                t = now()                    # the right image completes the pair
                self.ing.feed("right", self.rights[i % P], float(i))
                self.cpu_ns[i] = time.thread_time_ns() - c
                self.arrive[i] = t
                i += 1
                self.fed = i
        except BaseException as e:      # handed to the consumer, which raises it
            self.error = e

    def stop(self, batch: int) -> int:
        """Stop at a multiple of ``batch`` past every pair begun; returns it."""
        self.stop_at = min(self.stop_at, -(-(self.fed + 1) // batch) * batch + batch)
        return self.stop_at


def serve(pipe, ing, lefts: List[np.ndarray], rights: List[np.ndarray], traffic: Dict,
          outputs, seconds: float, t_start: float, sampler: Sampler,
          tracer=None, trace_s: float = 0.0,
          log: Callable[[str], None] = lambda s: None) -> Run:
    """Run the mix through ``pipe`` (a ``StereoPipeline``) and ``ing`` (its
    ``StreamingIngest``); ``t_start``: the process's start on the host's
    clock, for ``setup_s``.  ``tracer``: a ``trace.DeviceTrace`` started
    when the window closes and stopped ``trace_s`` later."""
    from ros_gpu_stereo_processor_tpu_torch.models.pipeline import FrameResult
    from ros_gpu_stereo_processor_tpu_torch.utils.msgs import Header

    B = int(traffic["batch"])
    batched = traffic["step"] == "process_batch"
    if not batched and B != 1:
        raise ValueError(f"step 'process' takes batch 1, not {B}")
    depth = int(traffic["max_in_flight"])
    cuda = pipe.device.type == "cuda"

    arrive = np.zeros(CAPACITY)
    cpu_ns = np.zeros(CAPACITY, np.int64)
    step_ret = np.zeros(CAPACITY)
    pub = np.zeros((2, CAPACITY))            # disparity, pointcloud publish times
    spans: Dict[str, list] = {k: [] for k in
                              ("staged_wait", "in_flight_wait", "dispatch", "enqueue")}

    def on_disparity(msg):
        i = int(msg.header.stamp)
        pub[0, i] = now()
        sampler.offer(i, "disparity", (msg.image,))

    def on_pointcloud(msg):
        i = int(msg.header.stamp)
        pub[1, i] = now()
        sampler.offer(i, "pointcloud", (msg.xyz, msg.rgb))

    pipe.senders.register("disparity", on_disparity)
    pipe.senders.register("pointcloud", on_pointcloud)

    prod = _Producer(ing, lefts, rights, arrive, cpu_ns)
    frames = ing.frames_prefetch(timeout=STAGED_TIMEOUT_S, depth=int(traffic["staged_depth"]),
                                 stacked=True)
    prod.thread.start()
    t_loop = now()
    t0 = t1 = t_trace_end = None
    stop_at = None
    phase = "warmup"
    pending: list = []
    in_flight: deque = deque()
    ahead: list = []         # (host time, steps the card still had queued) before each dispatch
    consumed = 0
    it = iter(frames)
    try:
        while stop_at is None or consumed < stop_at:
            ts = now()
            try:
                left, right, stamp, _ = next(it)
            except StopIteration:
                raise RuntimeError(
                    f"the ring stayed empty for {STAGED_TIMEOUT_S} s after {consumed} pairs "
                    f"({prod.fed} fed, ring {ing.ring.stats()}, pairer {ing.pairer.stats()})"
                    + (f": producer failed: {prod.error!r}" if prod.error else "")) from prod.error
            spans["staged_wait"].append((ts, now(), 1))
            consumed += 1
            pending.append((left, right, int(stamp)))
            if len(pending) < B:
                continue
            idx = [p[2] for p in pending]
            if len(in_flight) >= depth:
                ts = now()
                oldest = in_flight.popleft()
                if oldest is not None:
                    oldest.synchronize()
                spans["in_flight_wait"].append((ts, now(), B))
            ts = now()
            if phase != "warmup":
                ahead.append((ts, outstanding(in_flight)))
            if batched:
                out = pipe.process_batch(torch.stack([p[0] for p in pending]),
                                         torch.stack([p[1] for p in pending]), outputs)
                ev = None
                if cuda:
                    ev = torch.cuda.Event(blocking=True)
                    ev.record()
                results = [FrameResult(outputs={k: v[b] for k, v in out.items()},
                                       header=Header(stamp=float(i), seq=i), event=ev)
                           for b, i in enumerate(idx)]
            else:
                res = pipe.process(left, right, outputs,
                                   header=Header(stamp=float(idx[0]), seq=idx[0]))
                ev, results = res.event, [res]
            te = now()
            spans["dispatch"].append((ts, te, B))
            in_flight.append(ev)
            step_ret[idx] = te
            ts = now()
            for res in results:
                pipe.enqueue_send(res, outputs)
            spans["enqueue"].append((ts, now(), B))
            pending.clear()

            t = now()
            if phase == "warmup" and t - t_loop >= float(traffic["warmup_s"]):
                phase, t0, t1 = "window", t, t + seconds
                sampler.open = True
                cpu0 = thread_cpu()
                log(f"setup_s {t0 - t_start:.3f} (warm-up {t0 - t_loop:.3f} s, "
                    f"{consumed} pairs, {outstanding(in_flight)} steps outstanding)")
            elif phase == "window" and t >= t1:
                t1 = t
                cpu = cpu_use(cpu0, thread_cpu(), t - t0)
                if tracer is not None:
                    phase = "trace"
                    tracer.start()
                    t_trace_end = now() + trace_s
                else:
                    phase, stop_at = "drain", prod.stop(B)
            elif phase == "trace" and t >= t_trace_end:
                tracer.stop()
                phase, stop_at = "drain", prod.stop(B)
            if prod.error is not None:
                raise RuntimeError(f"producer failed: {prod.error!r}") from prod.error
        # the window closes: everything sent is waited for, then the clock read
        for ev in in_flight:
            if ev is not None:
                ev.synchronize()
        errors = []
        try:
            pipe.senders.wait_all()
        except Exception as e:      # noqa: BLE001 — a send that failed: counted, reported
            errors.append(repr(e))
        t_end = now()
        sampler.open = False
    finally:
        frames.close()
        if stop_at is None:      # a fault: let the producers end
            prod.stop(B)
    prod.thread.join(timeout=10.0)
    done = np.where((pub[0] > 0) & (pub[1] > 0), np.maximum(pub[0], pub[1]), 0.0)[:stop_at]
    stats = {**{f"ring_{k}": v for k, v in ing.ring.stats().items()},
             **{f"pairer_{k}": v for k, v in ing.pairer.stats().items()}}
    return Run(
        pairs=stop_at, arrive=arrive[:stop_at], step_return=step_ret[:stop_at],
        done=done, feed_cpu_ms=cpu_ns[:stop_at] / 1e6,
        spans={k: np.array(v, dtype=np.float64).reshape(-1, 3) for k, v in spans.items()},
        t0=t0, t1=t1, t_end=t_end, setup_s=t0 - t_start, send_errors=errors,
        ring_stats=stats, cpu=cpu, ahead=np.array(ahead, np.float64).reshape(-1, 2))


def least_a_second(run: Run) -> Dict[int, int]:
    """Whole second of the window → the fewest steps the card still had
    queued when the consumer came to dispatch in it (0: the card ran dry)."""
    out: Dict[int, int] = {}
    if run.ahead is None:
        return out
    for t, n in run.ahead:
        if run.t0 <= t < run.t0 + int(run.t1 - run.t0):
            k = int(t - run.t0)
            out[k] = min(out.get(k, int(n)), int(n))
    return out
