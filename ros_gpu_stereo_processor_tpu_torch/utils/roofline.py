"""Roofline accounting of the port's CUDA kernels on one NVIDIA H100.

The port of ``ros_gpu_stereo_processor_tpu/utils/roofline.py``: for each
kernel a model of the work the function it computes must do, and the least
time one card could take for that work.

  * ``bytes``: each input read once and each output written once, at its
    storage width: what the function must move, not what the kernel reads
    again;
  * ``ops``: the arithmetic of the function's inner loop per output element,
    counted once; where the work depends on the data (the speckle walks stop
    when a round changes nothing), the rounds these inputs need.

``bound_ms = max(bytes / memory rate, ops / arithmetic rate)``, ``bound_by``
says which of the two sets it, and ``pct_of_bound = 100 · bound_ms /
measured_ms``.  A kernel far above both is limited by its structure
(sequential rounds, latency, launches), not by the card's rates.

Chip: :data:`H100_SXM`, NVIDIA's data sheet for the SXM part at 700 W: 3.35
TB/s of HBM3 and 67 TFLOP/s of float32 outside the tensor cores.  Every
operation count is divided by that float32 peak, which counts a fused
multiply-add as two operations on 128 FP32 lanes per SM and clock.  The
block matcher's (K2) and the SGM cost stage's (K4) integer adds issue on 64
INT32 lanes per SM and clock, so their operation bounds may be optimistic by
up to 2×; which peak should bound an integer operation is an open question
(PERF.md §7).  A card set below 700 W runs slower under load: read a bound
beside the card's power limit.
"""

from __future__ import annotations

from typing import Dict, Tuple

H100_SXM = {
    "name": "H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32",
    "hbm_bytes_per_ms": 3.35e9,
    "fp32_ops_per_ms": 67e9,
}


def bound(nbytes: float, nops: float, chip: Dict = H100_SXM) -> Tuple[float, str]:
    """(least ms, what sets it: ``"bytes"`` or ``"operations"``) for moving
    ``nbytes`` and doing ``nops`` on ``chip``."""
    b, o = nbytes / chip["hbm_bytes_per_ms"], nops / chip["fp32_ops_per_ms"]
    return (b, "bytes") if b >= o else (o, "operations")


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


def maxprop_model(H_b: int, W: int, rounds: int) -> Dict:
    """K7, ``csrc/speckle.cu::speckle_maxprop``, on one (H_b, W) band, and
    the band label rounds (BL) beside it: an int32 field and two 1-byte
    connectivity masks in, the int32 field out; per round 2 passes of 2
    operations per pixel."""
    return {"bytes": H_b * W * (4 + 1 + 1 + 4), "ops": 2 * 2 * rounds * H_b * W}


def sgm_fused_model(H: int, W: int, nd: int, cost_bytes: int = 2,
                    exc_bytes: int = 1) -> Dict:
    """The 4-path SGM kernels, ``csrc/sgm.cu``, on (H, W, nd) volumes
    (V = H·W·nd cells) stored at ``cost_bytes`` (cost) and ``exc_bytes``
    (excess) per cell (``ops/sgm_kernel.py::storage_dtypes``):

      * K4 (cost stage and down walk): two prefiltered float32 images in,
        the cost and the down excess out; 16 operations per cell;
      * K5 (one path-walk call; the frame makes three: up + down, left →
        right, right → left + left → right): the cost and, in two of the
        three calls, an excess in, an excess out; 10 operations per cell;
      * K6 (winner-take-all): the cost and two excesses in, three 4-byte
        maps out; 7 operations per cell.

    ``bytes`` and ``ops`` at the top level are the frame's sum, K4 + 3·K5 +
    K6: the traffic of the volumes these kernels keep in memory."""
    V = H * W * nd
    parts = {
        "K4": {"bytes": 2 * H * W * 4 + V * (cost_bytes + exc_bytes), "ops": 16 * V},
        "K5": {"bytes": V * (cost_bytes + 5 * exc_bytes / 3), "ops": 10 * V},
        "K6": {"bytes": V * (cost_bytes + 2 * exc_bytes) + 3 * H * W * 4, "ops": 7 * V},
    }
    calls = {"K4": 1, "K5": 3, "K6": 1}
    return {"bytes": sum(calls[k] * p["bytes"] for k, p in parts.items()),
            "ops": sum(calls[k] * p["ops"] for k, p in parts.items()), **parts}


def speckle_structure_analysis(rounds: int, iters: int) -> Dict:
    """What K3's call is made of on the card: one cooperative launch of the
    label walk (row and column passes, persistent over the rounds, stopping
    on the device once a round changes nothing) and a memset of its flags,
    then the sizing of the components in plain PyTorch."""
    return {
        "structure": "1 cooperative launch of the label walk (grid barriers between "
                     "passes, stops on the device after the last changing round) + "
                     "1 memset; sizing: index_add_ of ones into H*W int64 counts, "
                     "then a gather",
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
    """The bound of ``model`` (``{"bytes", "ops"}``) on ``chip`` beside a
    measured time, and the share of the bound the measurement reaches."""
    b_ms, by = bound(model["bytes"], model["ops"], chip)
    return {
        "bytes": model["bytes"],
        "ops": model["ops"],
        "bound_ms": b_ms,
        "bound_by": by,
        "measured_ms": measured_ms,
        "pct_of_bound": 100.0 * b_ms / measured_ms if measured_ms > 0 else None,
    }
