"""Share of the profiled stretch in which no kernel, copy or memset ran on the
card, in %."""

LAYER = "device (one H100)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    t = run.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
