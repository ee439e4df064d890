"""The device trace of a traced run: ``torch.profiler`` (device activity only,
events kept in memory) over a short stretch of steady traffic, reduced to
what the per-layer metrics read.

  * Alignment: the stretch starts with a marker kernel
    (``torch.cuda._sleep``) launched at a known host time on a stream of
    its own at high priority, which runs beside the queued steps and does
    not wait for them (no device synchronize: seconds of steps are queued
    ahead), so the device's timestamps map onto the host's clock to within
    a block's wait for room on the card.  The first ``SETTLE_S`` after
    the marker are left out (the profiler's start disturbs the flow); the
    profiler's exit waits for the card, so every operation that began in
    the stretch is recorded.
  * ``busy_s``: the union of every device operation's interval (kernels,
    copies, memsets) inside the analysed window; ``window_s`` its length.
  * By name: each device operation's summed seconds, kernels and copies
    apart; pairs in the window: K1's launches in it over K1's launches a
    pair (the port's launch counter over the run, over the pairs stepped:
    2 with a point cloud, the mono pair and the left colour image), or,
    where the counter names no K1, the host's count of pairs stepped in
    the window.
  * Idle gaps: each stretch with nothing on the device, labelled by what
    the consumer thread was doing at its middle (its span on the host's
    clock), summed by label.
"""

from __future__ import annotations

import dataclasses
import time
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

SETTLE_S = 0.15
K1_KERNEL = "remap_bilinear_kernel"


@dataclasses.dataclass
class Summary:
    busy_s: float
    window_s: float
    pairs: float
    op_s: Dict[str, float]          # device seconds by operation name
    kernel_s: float                  # all kernels
    d2d_memset_s: float              # device-to-device copies and memsets
    copy_s: float                    # host<->device copies
    idle_gaps: List[Tuple[str, float]]

    def ms_per_pair(self, parts: Tuple[str, ...]) -> Optional[float]:
        """Device ms a pair of the operations whose name holds one of
        ``parts`` (None when none ran)."""
        s = sum(v for k, v in self.op_s.items() if any(p in k for p in parts))
        return 1e3 * s / self.pairs if s > 0 and self.pairs > 0 else None


class DeviceTrace:
    """Started and stopped by the consumer thread; :meth:`summary` after
    the run."""

    def __init__(self):
        self.prof = None
        self.t_mark = self.t_start = self.t_stop = None

    def start(self) -> None:
        from torch.profiler import ProfilerActivity, profile

        self.prof = profile(activities=[ProfilerActivity.CUDA])
        self.prof.__enter__()
        side = torch.cuda.Stream(priority=-1)
        with torch.cuda.stream(side):
            self.t_mark = time.perf_counter()
            torch.cuda._sleep(1000)
        side.synchronize()
        self.t_start = self.t_mark + SETTLE_S

    def stop(self) -> None:
        self.t_stop = time.perf_counter()
        self.prof.__exit__(None, None, None)

    def summary(self, spans: Dict[str, np.ndarray], step_return: np.ndarray,
                k1_per_pair: float) -> Optional[Summary]:
        """None when the profiler recorded no device operation."""
        events = [e for e in self.prof.events() if str(e.device_type).endswith("CUDA")]
        if not events:
            return None
        start = np.array([e.time_range.start for e in events], np.float64)   # µs
        end = np.array([e.time_range.end for e in events], np.float64)
        names = [e.name for e in events]
        marks = [k for k, n in enumerate(names) if "spin" in n or "sleep" in n]
        aligned = bool(marks)
        # device µs = host s · 1e6 + offset
        offset = start[marks[0]] - self.t_mark * 1e6 if aligned else start.min() - self.t_mark * 1e6
        wa, wb = self.t_start * 1e6 + offset, self.t_stop * 1e6 + offset
        sel = (start >= wa) & (start < wb)
        if aligned:
            sel[marks[0]] = False
        if not sel.any():
            return None
        op_s: Dict[str, float] = defaultdict(float)
        kernel_s = d2d_s = copy_s = 0.0
        k1 = 0
        for k in np.nonzero(sel)[0]:
            n, d = names[k], (end[k] - start[k]) / 1e6
            op_s[n] += d
            low = n.lower()
            if low.startswith("memcpy") and ("htod" in low or "dtoh" in low):
                copy_s += d
            elif low.startswith(("memcpy", "memset")):
                d2d_s += d
            else:
                kernel_s += d
            k1 += K1_KERNEL in n
        # busy: the union of the intervals, clipped to the window
        order = np.argsort(start[sel])
        s_, e_ = np.clip(start[sel][order], wa, wb), np.clip(end[sel][order], wa, wb)
        busy, gaps = 0.0, []
        cur_s, cur_e = s_[0], e_[0]
        if cur_s > wa:
            gaps.append((wa, cur_s))
        for a, b in zip(s_[1:], e_[1:]):
            if a > cur_e:
                busy += cur_e - cur_s
                gaps.append((cur_e, a))
                cur_s, cur_e = a, b
            else:
                cur_e = max(cur_e, b)
        busy += cur_e - cur_s
        if cur_e < wb:
            gaps.append((cur_e, wb))
        if k1 and k1_per_pair > 0:
            pairs = k1 / k1_per_pair
        else:
            pairs = float(((step_return >= self.t_start) & (step_return < self.t_stop)).sum())
        idle: Dict[str, float] = defaultdict(float)
        for a, b in gaps:
            mid = ((a + b) / 2 - offset) / 1e6 if aligned else None
            idle[_label(spans, mid)] += (b - a) / 1e6
        return Summary(
            busy_s=busy / 1e6, window_s=(wb - wa) / 1e6, pairs=pairs, op_s=dict(op_s),
            kernel_s=kernel_s, d2d_memset_s=d2d_s, copy_s=copy_s,
            idle_gaps=sorted(idle.items(), key=lambda kv: -kv[1]))


def _label(spans: Dict[str, np.ndarray], t: Optional[float]) -> str:
    """The consumer's span at host time ``t``: ``between_calls`` when it
    was in none, ``unaligned`` without a marker."""
    if t is None:
        return "unaligned"
    for name, s in spans.items():
        if len(s):
            k = np.searchsorted(s[:, 0], t, side="right") - 1
            if k >= 0 and s[k, 1] >= t:
                return name
    return "between_calls"
