"""The port's observability layer: one recorder of spans, instants, gauges
and counters, with the per-frame TIMING line, event timing and the
profiler exporter around it.

The port of ``ros_gpu_stereo_processor_tpu/utils/timing.py``, grown into
one system:

  * the recorder (:func:`enable`, :func:`disable`, :func:`snapshot`):
    spans and counters taken where the work happens in the served path
    (the ingest, the uploader, the frame step, the graph replay, the host
    copy and the sender workers), keyed by the pair's ``seq``; off by
    default;
  * :class:`StageTimer` — the per-frame ``TIMING [ms]`` line
    (reference: boost timers in imageCb, src/StereoProcessor.cpp:159-297),
    exponential moving averages of host wall time by stage; while the
    recorder is on, each stage is also one of its spans;
  * :func:`timed` — run a callable and time it: CUDA events on a CUDA device,
    the host clock elsewhere;
  * :func:`trace` — a ``torch.profiler`` trace context (the
    nvprof-launch-prefix slot, launch/test_nodelet.launch:27-29);
  * :func:`print_stats` — min/max/mean array summary, the debug helper the
    reference calls printStats (src/GPUStereoProcessor.cpp:421-435).

CUDA work is asynchronous: a host clock around it measures the enqueue.  So
``StageTimer.stage(name, block_on)`` synchronises the devices of
``block_on``'s tensors before stamping, and :func:`timed` reads CUDA events.

The recorder
------------

The clock is ``time.perf_counter_ns()``, the clock of
``time.perf_counter()``: the clock the benchmark's loop stamps
(``stereo_bench/loop.py``) and onto which its device trace maps the card's
timestamps through a marker kernel (``stereo_bench/trace.py``).  Program
spans therefore line up with the device trace and with the loop's stamps
with no alignment of their own.

While the recorder is off, a call site costs one read of the module flag
:data:`ON`: no clock read, no allocation, no context manager.  A span site
reads::

    s = timing.begin(FEED, cpu=True) if timing.ON else -1
    ...
    if s >= 0:
        timing.end(s, seq)

and nested sites inside it test ``s >= 0`` rather than the flag.  Names
are interned once (:func:`intern`), when the recording module is imported.

Each thread records into a buffer of its own, claimed at its first record
after :func:`enable` (a list of ``capacity`` slots a field, made then:
a list's item store is the cheapest store Python has), with no lock and
no growth on the record path; a record that finds its thread's
buffer full is counted in ``lost`` and not kept.  A record holds a name, a
tag (an interned label, such as an output's or a graph variant's name, or
-1), its start and end in ns, a ``seq`` (the ingest's pair number, or -1),
``n`` (the pairs a span covers, a gauge's value or a counter's increment),
its parent (the span open on the same thread when it began, or -1) and the
thread CPU ns spent inside it (-1 where not read: only the sites that ask
read the thread's CPU clock).  An instant, a gauge and a counter are
records whose end equals their start.  Counters are summed at the
snapshot, beside the counts of the sources :func:`watch` names (the
ingest's ring and pairer) and the kernel library's launches by kernel
(``ops/_build.py``), each read at :func:`enable` and at :func:`snapshot`:
the snapshot holds their change.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import threading
import time
import weakref
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch

# -- the recorder ------------------------------------------------------------

ON = False                      # the recorder's switch; call sites read it, and only it, when off
CAPACITY = 1 << 19              # records a thread keeps, by default
SPAN, INSTANT, GAUGE, COUNTER, TAG = "span", "instant", "gauge", "counter", "tag"
FIELDS = ("name", "tag", "t0", "t1", "seq", "n", "parent", "cpu")
_DEFAULTS = {"tag": -1, "seq": -1, "n": 1, "cpu": -1}

_clock = time.perf_counter_ns
_thread_clock = time.thread_time_ns
_names: List[str] = []
_kinds: List[str] = []
_ids: Dict[str, int] = {}
_names_lock = threading.Lock()
_watched: List[Tuple[int, str, Callable[[], Optional[Callable[[], Dict[str, int]]]]]] = []
_tls = threading.local()
_rec: Optional["_Recorder"] = None
_serials = iter(range(1, 1 << 30))    # one a buffer, one a watched source


def intern(text: str, kind: str = SPAN) -> int:
    """The id of ``text`` (interned at its first use, with its ``kind``:
    :data:`SPAN`, :data:`INSTANT`, :data:`GAUGE`, :data:`COUNTER` or
    :data:`TAG`)."""
    i = _ids.get(text)
    if i is None:
        with _names_lock:
            i = _ids.get(text)
            if i is None:
                i = len(_names)
                _names.append(text)
                _kinds.append(kind)
                _ids[text] = i
    return i


def watch(prefix: str, counts: Callable[[], Dict[str, int]]) -> None:
    """Read ``counts()`` (a dict of monotonic counts) at :func:`enable` and
    at :func:`snapshot`; the snapshot's counters hold the change under
    ``<prefix>.<key>``, summed over the live sources of one prefix.  A
    bound method is held weakly: its object's counts leave with it."""
    ref = weakref.WeakMethod(counts) if hasattr(counts, "__self__") else (lambda: counts)
    with _names_lock:
        _watched[:] = [w for w in _watched if w[2]() is not None]
        _watched.append((next(_serials), prefix, ref))


def _read_watched() -> Dict[Tuple[int, str], Dict[str, int]]:
    """Each live source's counts, by (its key, its prefix); the kernel
    library's launches under key 0."""
    from ros_gpu_stereo_processor_tpu_torch.ops import _build

    out = {(0, "launches"): {s: k.launches for s, k in _build.kernels().items()}}
    with _names_lock:
        sources = [(key, prefix, r()) for key, prefix, r in _watched]
    for key, prefix, fn in sources:
        if fn is not None:
            out[(key, prefix)] = {k: int(v) for k, v in fn().items()}
    return out


class _Buffer:
    """One thread's records: a list a field, filled with each field's
    default, so that a record stores only what differs."""

    __slots__ = FIELDS + ("count", "cap", "top", "lost", "base", "rec", "thread")

    def __init__(self, rec: "_Recorder"):
        cap = rec.capacity
        for f in FIELDS:
            setattr(self, f, [_DEFAULTS.get(f, 0)] * cap)
        self.count, self.cap, self.top, self.lost = 0, cap, -1, 0
        self.base = next(_serials) << 32      # tokens of this buffer: base + index
        self.rec = rec
        self.thread = threading.current_thread().name


class _Recorder:
    def __init__(self, capacity: int):
        self.capacity = int(capacity)
        self.buffers: List[_Buffer] = []
        self.lock = threading.Lock()
        self.base = _read_watched()


def _claim() -> _Buffer:
    """This thread's buffer in the current recording, made at its first
    record."""
    rec = _rec
    b = _Buffer(rec)
    with rec.lock:
        rec.buffers.append(b)
    _tls.buf = b
    return b


def enable(capacity: int = CAPACITY) -> None:
    """Start a new recording (the last one's records are dropped), each
    thread keeping up to ``capacity`` records."""
    global ON, _rec
    ON = False
    _rec = _Recorder(capacity)
    ON = True


def disable() -> None:
    """Stop recording; :func:`snapshot` still reads what was recorded."""
    global ON
    ON = False


def now() -> int:
    """The recorder's clock, in ns."""
    return _clock()


def begin(nid: int, seq: int = -1, n: int = 1, tag: int = -1, cpu: bool = False) -> int:
    """Open a span on this thread; returns its token for :func:`end` (-1
    when the thread's buffer is full).  ``cpu``: also read the thread's
    CPU clock, at both ends."""
    b = getattr(_tls, "buf", None)
    if b is None or b.rec is not _rec:
        b = _claim()
    i = b.count
    if i >= b.cap:
        b.lost += 1
        return -1
    b.count = i + 1
    b.name[i] = nid
    b.parent[i] = b.top
    b.top = i
    if seq >= 0:
        b.seq[i] = seq
    if n != 1:
        b.n[i] = n
    if tag >= 0:
        b.tag[i] = tag
    if cpu:
        b.cpu[i] = _thread_clock()
    b.t0[i] = _clock()
    return b.base + i


def end(token: int, seq: int = -1) -> None:
    """Close the span of ``token`` (opened on this thread); ``seq`` ≥ 0
    sets its pair, where that was known only at its end.  A token of
    another recording, or -1, is ignored."""
    t = _clock()
    b = getattr(_tls, "buf", None)
    if b is None:
        return
    i = token - b.base
    if i < 0 or i >= b.cap:
        return
    b.t1[i] = t
    c = b.cpu[i]
    if c >= 0:
        b.cpu[i] = _thread_clock() - c
    if seq >= 0:
        b.seq[i] = seq
    b.top = b.parent[i]


def span(nid: int, t0: int, t1: int, seq: int = -1, n: int = 1, tag: int = -1) -> None:
    """A span timed by the caller (``t0``, ``t1`` from :func:`now`), such
    as one that starts on another thread."""
    b = getattr(_tls, "buf", None)
    if b is None or b.rec is not _rec:
        b = _claim()
    i = b.count
    if i >= b.cap:
        b.lost += 1
        return
    b.count = i + 1
    b.name[i] = nid
    b.parent[i] = b.top
    if seq >= 0:
        b.seq[i] = seq
    if n != 1:
        b.n[i] = n
    if tag >= 0:
        b.tag[i] = tag
    b.t0[i] = t0
    b.t1[i] = t1


def instant(nid: int, seq: int = -1, n: int = 1, tag: int = -1) -> None:
    t = _clock()
    span(nid, t, t, seq, n, tag)


def gauge(nid: int, value: int, tag: int = -1) -> None:
    t = _clock()
    span(nid, t, t, -1, value, tag)


def count(nid: int, by: int = 1, tag: int = -1) -> None:
    t = _clock()
    span(nid, t, t, -1, by, tag)


@dataclasses.dataclass
class Snapshot:
    """What the recorder holds: ``records`` maps each of :data:`FIELDS`,
    and ``thread`` (an index into ``threads``), to one array over every
    thread's records, one thread after another; ``parent`` indexes these
    arrays.  ``counters``: counter records summed by name (``name[tag]``
    where tagged), and the change of the watched counts since
    :func:`enable`.  ``lost``: records that found no room."""

    names: Tuple[str, ...]
    kinds: Tuple[str, ...]
    threads: Tuple[str, ...]
    records: Dict[str, np.ndarray]
    counters: Dict[str, int]
    lost: int

    def id(self, text: str) -> int:
        """The id of ``text``, or -1 where it was never interned."""
        return self.names.index(text) if text in self.names else -1

    def of(self, text: str) -> np.ndarray:
        """Indices of the records named ``text`` (spans still open left
        out)."""
        r = self.records
        return np.nonzero((r["name"] == self.id(text)) & (r["t1"] >= r["t0"]))[0]


def snapshot() -> Snapshot:
    """The records of the current (or last) recording; empty where none
    was enabled."""
    rec = _rec
    with _names_lock:
        names, kinds = tuple(_names), tuple(_kinds)
    if rec is None:
        empty = {f: np.zeros(0, np.int64) for f in FIELDS + ("thread",)}
        return Snapshot(names, kinds, (), empty, {}, 0)
    with rec.lock:
        buffers = list(rec.buffers)
    cols: Dict[str, List[np.ndarray]] = {f: [] for f in FIELDS + ("thread",)}
    offset = 0
    for k, b in enumerate(buffers):
        n = min(b.count, b.cap)
        for f in FIELDS:
            cols[f].append(np.array(getattr(b, f)[:n], np.int64))
        par = cols["parent"][-1]
        par[par >= 0] += offset
        cols["thread"].append(np.full(n, k, np.int64))
        offset += n
    records = {f: np.concatenate(v) if v else np.zeros(0, np.int64) for f, v in cols.items()}
    counters: Dict[str, int] = defaultdict(int)
    for i in np.nonzero(np.isin(records["name"],
                                [k for k, kind in enumerate(kinds) if kind == COUNTER]))[0]:
        tag = records["tag"][i]
        key = names[records["name"][i]] + (f"[{names[tag]}]" if tag >= 0 else "")
        counters[key] += int(records["n"][i])
    for source, now_counts in _read_watched().items():
        base = rec.base.get(source, {})
        for k, v in now_counts.items():
            counters[f"{source[1]}.{k}"] += v - base.get(k, 0)
    return Snapshot(names, kinds, tuple(b.thread for b in buffers), records, dict(counters),
                    sum(b.lost for b in buffers))


# -- the TIMING line, event timing, the profiler exporter ---------------------

@dataclasses.dataclass
class StageStats:
    last_ms: float = 0.0
    ema_ms: float = 0.0
    total_ms: float = 0.0
    count: int = 0

    def update(self, ms: float, alpha: float = 0.1) -> None:
        self.last_ms = ms
        self.ema_ms = ms if self.count == 0 else (1 - alpha) * self.ema_ms + alpha * ms
        self.total_ms += ms
        self.count += 1


def _tensors(obj: Any) -> Iterator[torch.Tensor]:
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def synchronize(obj: Any) -> None:
    """Wait for every CUDA device that holds a tensor of ``obj`` (a tensor,
    or a dict/list/tuple of them)."""
    for dev in {t.device for t in _tensors(obj) if t.is_cuda}:
        torch.cuda.synchronize(dev)


class StageTimer:
    """Named-stage wall timing with a TIMING summary line: the recorder's
    view for a log line.  While the recorder is on, each :meth:`stage` is
    also its span ``stage.<name>``."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None) -> Iterator[None]:
        s = begin(intern("stage." + name)) if ON else -1
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            self.stages[name].update((time.perf_counter() - t0) * 1e3)
            if s >= 0:
                end(s)

    def timing_line(self) -> str:
        """The reference's debug line:
        'TIMING [ms]: upload(..) color(..) … total(..)'."""
        parts = [
            f"{name}({s.ema_ms:.1f})" for name, s in self.stages.items()
        ]
        return "TIMING [ms]: " + " ".join(parts)

    def as_dict(self) -> Dict[str, Dict[str, float]]:
        return {
            k: {"last_ms": v.last_ms, "ema_ms": v.ema_ms,
                "mean_ms": v.total_ms / max(v.count, 1), "count": v.count}
            for k, v in self.stages.items()
        }

    def reset(self) -> None:
        self.stages.clear()


def timed(fn: Callable[[], Any], device: torch.device | str) -> Tuple[Any, float]:
    """Run ``fn()`` and return ``(result, ms)``.  On a CUDA device the time
    is read from CUDA events recorded on the current stream around the call
    (so it covers the device work ``fn`` enqueued, and the call waits for
    it); elsewhere the work is synchronous and the host clock times it."""
    device = torch.device(device)
    if device.type == "cuda":
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = fn()
        end.record()
        end.synchronize()
        return out, start.elapsed_time(end)
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``torch.profiler`` trace context (CPU, plus CUDA where a card is
    present); writes ``trace.json`` (Chrome trace format) into ``log_dir``."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def print_stats(name: str, arr) -> str:
    """min/max/mean per channel — the reference's printStats debug helper."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().cpu().numpy()
    a = np.asarray(arr)
    if a.ndim == 3:
        lines = []
        for c in range(a.shape[-1]):
            ch = a[..., c].astype(np.float64)
            lines.append(
                f"{name}[{c}]: min={ch.min():.3f} max={ch.max():.3f} "
                f"mean={ch.mean():.3f}"
            )
        out = "\n".join(lines)
    else:
        af = a.astype(np.float64)
        out = f"{name}: min={af.min():.3f} max={af.max():.3f} mean={af.mean():.3f}"
    print(out)
    return out
