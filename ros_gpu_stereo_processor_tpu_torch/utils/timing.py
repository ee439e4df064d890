"""Per-stage timing, counters and profiling hooks — the observability layer.

The PyTorch port of ``ros_gpu_stereo_processor_tpu/utils/timing.py``:

  * :class:`StageTimer` — the per-frame ``TIMING [ms]`` line
    (reference: boost timers in imageCb, src/StereoProcessor.cpp:159-297),
    with exponential moving averages and a formatted summary;
  * :class:`Counters` — pushed/dropped/processed counters;
  * :func:`timed` — run a callable and time it: CUDA events on a CUDA device,
    the host clock elsewhere;
  * :func:`trace` — a ``torch.profiler`` trace context (the
    nvprof-launch-prefix slot, launch/test_nodelet.launch:27-29);
  * :func:`print_stats` — min/max/mean array summary, the debug helper the
    reference calls printStats (src/GPUStereoProcessor.cpp:421-435).

CUDA work is asynchronous: a host clock around it measures the enqueue.  So
``StageTimer.stage(name, block_on)`` synchronises the devices of
``block_on``'s tensors before stamping, and :func:`timed` reads CUDA events.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import time
from collections import defaultdict
from typing import Any, Callable, Dict, Iterator, Tuple

import numpy as np
import torch


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
    """Named-stage wall timing with a TIMING summary line."""

    def __init__(self):
        self.stages: Dict[str, StageStats] = defaultdict(StageStats)
        self._open: Dict[str, float] = {}

    @contextlib.contextmanager
    def stage(self, name: str, block_on: Any = None) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            if block_on is not None:
                synchronize(block_on)
            self.stages[name].update((time.perf_counter() - t0) * 1e3)

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        t0 = self._open.pop(name)
        self.stages[name].update((time.perf_counter() - t0) * 1e3)

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


class Counters:
    """Monotonic event counters (frames in/out, drops, keyframes …)."""

    def __init__(self):
        self._c: Dict[str, int] = defaultdict(int)

    def inc(self, name: str, by: int = 1) -> None:
        self._c[name] += by

    def __getitem__(self, name: str) -> int:
        return self._c[name]

    def as_dict(self) -> Dict[str, int]:
        return dict(self._c)


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
