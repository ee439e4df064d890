"""K2's share of its roofline, in %: the bound of the block matcher's work a
pair (``costmodel.stereobm_fused_model``: bytes over 3.35 TB/s, float32
operations over 67 TFLOP/s) over K2's device time a pair
(``bm_fused_kernel``) in the profiled stretch."""

from stereo_bench import costmodel

LAYER = "kernels (ops/*_kernel.py, csrc/*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
BETTER = "higher"


def reads(config, traffic):
    return config["matcher"]["algorithm"] == "bm"


def read(run, cell):
    if run.trace is None:
        return None
    ms = run.trace.ms_per_pair(("bm_fused_kernel",))
    if ms is None:
        return None
    c = cell["config_data"]
    H, W = c["image"]["height"], c["image"]["width"]
    return 100.0 * costmodel.model_ms(costmodel.matcher_model(c["matcher"], H, W)) / ms
