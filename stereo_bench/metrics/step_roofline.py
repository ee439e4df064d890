"""The whole frame step's share of its roofline, in %: the bound of a pair's
work (``costmodel.step_model``: K1, the prefilter, the matcher, the speckle
filter at the mean rounds the reference counts on the sampled pairs, its
sizing, reprojection), whichever kernels do it, over the device time a
pair of every kernel, device-to-device copy and memset in the profiled
stretch (host copies left out)."""

from stereo_bench import costmodel

LAYER = "kernels (ops/*_kernel.py, csrc/*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
BETTER = "higher"


def reads(config, traffic):
    return True


def read(run, cell):
    t = run.trace
    if t is None or t.pairs <= 0 or run.rounds is None:
        return None
    ms = 1e3 * (t.kernel_s + t.d2d_memset_s) / t.pairs
    return 100.0 * costmodel.model_ms(costmodel.step_model(cell["config_data"], run.rounds)) / ms
