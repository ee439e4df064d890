"""The SGM matcher's share of its roofline, in %: the bound of K4, K5, DG and
K6's work a pair (``costmodel.sgm_fused_model`` at the port's storage
widths; int32 walk operations over the measured 32.9 T/s) over the summed
device time a pair of the kernels whose names hold ``sgm_`` in the profiled
stretch."""

from stereo_bench import costmodel

LAYER = "kernels (ops/*_kernel.py, csrc/*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
BETTER = "higher"


def reads(config, traffic):
    return config["matcher"]["algorithm"] == "sgm"


def read(run, cell):
    if run.trace is None:
        return None
    ms = run.trace.ms_per_pair(("sgm_",))
    if ms is None:
        return None
    c = cell["config_data"]
    H, W = c["image"]["height"], c["image"]["width"]
    return 100.0 * costmodel.model_ms(costmodel.matcher_model(c["matcher"], H, W)) / ms
