"""Median ms from the frame step's return to the pair's last publish callback,
over the pairs stepped in the window's dispatch (not those of a traced
run's profiled stretch, whose profiler holds the host up): the device's
queue, the host copy and the sender workers."""

import numpy as np

LAYER = "publish (utils/hostcopy.py, utils/msgs.py)"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "latency_ms_p95"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    sel = (run.step_return >= run.t0) & (run.step_return <= run.t1) & (run.done > 0)
    if not sel.any():
        return None
    return float(np.median(run.done[sel] - run.step_return[sel]) * 1e3)
