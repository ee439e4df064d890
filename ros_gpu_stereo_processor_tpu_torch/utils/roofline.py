"""Roofline accounting of the port's CUDA kernels on one NVIDIA H100.

The port of ``ros_gpu_stereo_processor_tpu/utils/roofline.py``: for each
kernel a model of the work the function it computes must do, and the least
time one card could take for that work.

  * ``bytes``: each input read once and each output written once, at its
    storage width: what the function must move, not what the kernel reads
    again;
  * ``ops`` and ``int_ops``: the arithmetic of the function's inner loop
    per output element, counted once, in float32 and in int32 (the SGM
    walks run their recurrence in int32 on integer storage); where the
    work depends on the data (the speckle walks stop when a round changes
    nothing), the rounds these inputs need.

``bound_ms = max(bytes / memory rate, ops / float32 rate, int_ops / int32
rate)``, ``bound_by`` says whether the bytes or the operations set it, and
``pct_of_bound = 100 · bound_ms / measured_ms``.  A kernel far above both
is limited by its structure (sequential rounds, latency, launches), not by
the card's rates.

Chip: :data:`H100_SXM`, NVIDIA's data sheet for the SXM part at 700 W: 3.35
TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores (a fused
multiply-add counted as two operations on 128 FP32 lanes per SM and
clock), and the int32 rate the card reached in ``scripts/torch_int_peak.py``
(dependent-free ``add.s32`` and ``min.s32`` chains: 32.9 and 33.1 T
operations/s in two runs, the lower one taken; two to a three-input SASS
instruction, 16.4–16.6 T instructions/s on the 64 INT32 lanes per SM at
1.98 GHz; NVIDIA H100 80GB HBM3 at 700 W): the data sheet gives no int32
rate.  The block matcher (K2) and the SGM cost
stage (K4) sum float32 values, exact for integers, so their operations
stay float32.  A card set below 700 W runs slower under load: read a
bound beside the card's power limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

H100_SXM = {
    "name": "H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32, 32.9 T int32 op/s",
    "hbm_bytes_per_ms": 3.35e9,
    "fp32_ops_per_ms": 67e9,
    "int32_ops_per_ms": 32.88e9,
}


def bound(nbytes: float, nops: float, chip: Dict = H100_SXM,
          int_ops: float = 0.0) -> Tuple[float, str]:
    """(least ms, what sets it: ``"bytes"`` or ``"operations"``) for moving
    ``nbytes`` and doing ``nops`` float32 and ``int_ops`` int32 operations
    on ``chip``."""
    b = nbytes / chip["hbm_bytes_per_ms"]
    o = max(nops / chip["fp32_ops_per_ms"], int_ops / chip["int32_ops_per_ms"])
    return (b, "bytes") if b >= o else (o, "operations")


def model_bound(model: Dict, chip: Dict = H100_SXM) -> Tuple[float, str]:
    """:func:`bound` of a model's ``bytes``, ``ops`` and ``int_ops``."""
    return bound(model["bytes"], model["ops"], chip, model.get("int_ops", 0.0))


def remap_model(H: int, W: int, images: int = 2) -> Dict:
    """K1, ``csrc/remap.cu``: ``images`` uint8 (H, W) images rectified in one
    launch (the pipeline's two sides).  Per output pixel: the source pixel
    (1 byte), the map's float32 (x, y) (8) and the output (1); ~20 operations
    (the bilinear weights, four taps, the blend and the rounding)."""
    return {"bytes": images * H * W * (1 + 8 + 1), "ops": 20 * images * H * W}


def stereobm_fused_model(H: int, W: int, nd: int) -> Dict:
    """K2, ``csrc/stereobm.cu``: two prefiltered float32 images in, three
    4-byte maps out (raw disparity, best cost, the runner-up exclusion); per
    (pixel, disparity) 8 operations: the absolute difference, the column
    sum's add and subtract, the window sum's add and subtract, the compare,
    and the two selects of the winner.  No cost volume reaches memory."""
    return {"bytes": 5 * H * W * 4, "ops": 8 * H * W * nd}


def speckle_model(H: int, W: int, rounds: int) -> Dict:
    """K3, ``csrc/speckle.cu::speckle_labels``: disparity (float32) and
    validity (1 byte) in, int32 labels out; per round the data needs a row
    pass and a column pass of 2 operations per pixel (compare, min)."""
    return {"bytes": H * W * (4 + 1 + 4), "ops": 2 * 2 * rounds * H * W}


def sizing_model(H: int, W: int) -> Dict:
    """SZ, ``csrc/speckle.cu::speckle_sizing``: the speckle filter's sizing
    and masking.  Labels (4 bytes), disparity (4) and validity (1) in; the
    filtered disparity (4) and validity (1) out; ~4 operations a pixel
    (count, gather, compare, select).  The atomics of the count pass are
    not in the model: it is what the function must move."""
    return {"bytes": H * W * (4 + 4 + 1 + 4 + 1), "ops": 4 * H * W}


def maxprop_model(H_b: int, W: int, rounds: int) -> Dict:
    """K7, ``csrc/speckle.cu::speckle_maxprop``, on one (H_b, W) band, and
    the band label rounds (BL) beside it: an int32 field and two 1-byte
    connectivity masks in, the int32 field out; per round 2 passes of 2
    operations per pixel."""
    return {"bytes": H_b * W * (4 + 1 + 1 + 4), "ops": 2 * 2 * rounds * H_b * W}


def sgm_fused_model(H: int, W: int, nd: int, cost_bytes: int = 2,
                    exc_bytes: int = 1, paths: int = 4) -> Dict:
    """The SGM kernels, ``csrc/sgm*.cu``, on (H, W, nd) volumes (V = H·W·nd
    cells) stored at ``cost_bytes`` (cost) and ``exc_bytes`` (excess) per
    cell (``ops/sgm_kernel.py::storage_dtypes``); a walk's operations are
    int32 on integer storage (2-byte cost), float32 otherwise:

      * K4 (cost stage and down walk): two prefiltered float32 images in,
        the cost and the down excess out; 6 float32 operations per cell
        for the sliding SAD (the difference, its absolute value, the column
        and window slides) and 10 for the walk;
      * K4 cost (the cost stage alone, 2 paths): the images in, the cost
        out; the 6;
      * K5 (one path-walk call; 4 and 8 paths make three: up + down, left →
        right, right → left + left → right; 2 paths the last two): the
        cost and, in two of the three calls, an excess in, an excess out;
        10 walk operations per cell;
      * DG (one diagonal pair call, both directions; 8 paths make two): the
        cost in, the pair sum out; 20 walk operations per cell;
      * K6 (winner-take-all over ``paths``): the cost and ``paths / 2``
        pair volumes in, three 4-byte maps out; 5 + paths / 2 float32
        operations per cell (the scaled cost, one add per pair, the mask,
        the minimum, the first index).

    ``bytes``, ``ops`` and ``int_ops`` at the top level are the frame's sum
    over its calls (``calls``): the traffic of the volumes these kernels
    keep in memory."""
    if paths not in (2, 4, 8):
        raise ValueError(f"paths={paths} must be 2, 4 or 8")
    V = H * W * nd
    walk = "int_ops" if cost_bytes == 2 else "ops"

    def part(nbytes, fp32=0, walk_ops=0):
        p = {"bytes": nbytes, "ops": fp32 * V, "int_ops": 0}
        p[walk] += walk_ops * V
        return p

    pairs = paths // 2
    parts = {
        "K4": part(2 * H * W * 4 + V * (cost_bytes + exc_bytes), 6, 10),
        "K4 cost": part(2 * H * W * 4 + V * cost_bytes, 6),
        "K5": part(V * (cost_bytes + 5 * exc_bytes / 3), 0, 10),
        "DG": part(V * (cost_bytes + exc_bytes), 0, 20),
        "K6": part(V * (cost_bytes + pairs * exc_bytes) + 3 * H * W * 4, 5 + pairs),
    }
    calls = {2: {"K4 cost": 1, "K5": 2, "K6": 1},
             4: {"K4": 1, "K5": 3, "K6": 1},
             8: {"K4": 1, "K5": 3, "DG": 2, "K6": 1}}[paths]
    return {**{k: sum(n * parts[p][k] for p, n in calls.items())
               for k in ("bytes", "ops", "int_ops")},
            "calls": calls, **parts}


def speckle_structure_analysis(rounds: int, iters: int) -> Dict:
    """What K3's call is made of on the card: one cooperative launch of the
    label walk (row and column passes, persistent over the rounds, stopping
    on the device once a round changes nothing) and a memset of its flags;
    the sizing after it is SZ's call (:func:`sizing_model`)."""
    return {
        "structure": "1 cooperative launch of the label walk (grid barriers between "
                     "passes, stops on the device after the last changing round) + "
                     "1 memset; sizing (SZ, its own call): 1 memset of H*W int32 "
                     "counts, a warp-aggregated count pass, a keep-and-fill pass",
        "device_launches_per_call": 2,
        "rounds_needed": rounds,
        "rounds_allowed": iters,
    }


def stereobm_structure_floor(nd: int, block: int) -> Dict:
    """What K2's call is made of on the card: one launch; each warp sweeps a
    strip of rows for a range of disparities (lane = disparity), sliding the
    block's column sums down and its window sums across, and the block's
    warps merge their ranges in disparity order."""
    return {
        "structure": f"1 launch: sliding-window SAD sweep (lane = disparity, "
                     f"{nd} disparities, block {block}), no cost volume in memory, "
                     f"one merge of the warps' ranges",
        "device_launches_per_call": 1,
        "ops_per_pixel_disparity": 8,
    }


def roofline(model: Dict, measured_ms: float, chip: Dict = H100_SXM) -> Dict:
    """The bound of ``model`` (``{"bytes", "ops"}``, and ``"int_ops"`` where
    it has int32 operations) on ``chip`` beside a measured time, and the
    share of the bound the measurement reaches."""
    b_ms, by = model_bound(model, chip)
    return {
        "bytes": model["bytes"],
        "ops": model["ops"],
        "int_ops": model.get("int_ops", 0),
        "bound_ms": b_ms,
        "bound_by": by,
        "measured_ms": measured_ms,
        "pct_of_bound": 100.0 * b_ms / measured_ms if measured_ms > 0 else None,
    }
