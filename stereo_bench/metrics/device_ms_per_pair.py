"""Device ms a pair in the profiled stretch: every kernel, copy and memset's
time (summed; copies may overlap kernels), over the pairs in it."""

LAYER = "device (one H100)"
UNIT = "ms"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
BETTER = "lower"


def reads(config, traffic):
    return True


def read(run, cell):
    t = run.trace
    if t is None or t.pairs <= 0:
        return None
    return 1e3 * (t.kernel_s + t.d2d_memset_s + t.copy_s) / t.pairs
