"""DG's two-pass walk against its roofline, in %: the bound of a pair's two
DG calls (``costmodel.sgm_fused_model``'s ``DG`` part at the port's storage
widths, bytes over 3.35 TB/s or int32 walk operations over 32.9 T/s) over
the device ms a pair of the operations whose name holds
``sgm_diagonal_kernel``: the two-pass walk, which the port runs above 256
disparities (``csrc/sgm_diagonal.cu``).  The pair walk's
``sgm_diagonal_pair_kernel`` does not match that name, so where the pair
walk does the work the metric reads nothing."""

from stereo_bench import costmodel

LAYER = "kernels (ops/*_kernel.py, csrc/*.cu)"
UNIT = "%"
SOURCE = "device_trace"
MOVES = "pairs_per_s"
BETTER = "higher"
KERNEL = "sgm_diagonal_kernel"
PAIR_WALK_MAX_ND = 256      # the widest range DG's pair walk takes


def reads(config, traffic):
    m = config["matcher"]
    return (m["algorithm"] == "sgm" and m["sgm_paths"] == 8
            and m["num_disparities"] > PAIR_WALK_MAX_ND)


def read(run, cell):
    if run.trace is None:
        return None
    ms = run.trace.ms_per_pair((KERNEL,))
    if ms is None:
        return None
    c = cell["config_data"]
    m = c["matcher"]
    H, W = c["image"]["height"], c["image"]["width"]
    cb, eb = costmodel.sgm_storage_bytes(m)
    dg = costmodel.sgm_fused_model(H, W, m["num_disparities"], cb, eb, 8)["DG"]
    return 100.0 * 2 * costmodel.model_ms(dg) / ms
