"""The cost model: the least time one H100 could take for a kernel's work.

A frozen copy of the port's ``utils/roofline.py`` counts (each input read
once, each output written once, at its storage width; the inner loop's
operations counted once per output element; where the work depends on the
data, what these inputs need), and the same peaks: NVIDIA's data sheet for
the H100 SXM at 700 W, 3.35 TB/s of HBM3 and 67 TFLOP/s of float32 outside
the tensor cores, and 32.9 T int32 operations/s, the rate of dependent-free
``add.s32``/``min.s32`` chains measured on an NVIDIA H100 80GB HBM3 at 700 W
(the data sheet gives no int32 rate).  A card set below 700 W runs slower:
read a share beside the card's power limit.

Beyond the copy, :func:`step_model` counts a whole frame step of the served
path, whichever kernels do the work: rectification (K1), the prefilter, the
matcher (K2, or K4/K5/DG/K6), the speckle filter at the rounds the data
needs and its sizing, and reprojection.  The float32 disparity wire is the
disparity itself and adds nothing.
"""

from __future__ import annotations

from typing import Dict, Tuple

H100_SXM = {
    "name": "H100 SXM at 700 W: 3.35 TB/s, 67 TFLOP/s float32, 32.9 T int32 op/s",
    "hbm_bytes_per_ms": 3.35e9,
    "fp32_ops_per_ms": 67e9,
    "int32_ops_per_ms": 32.88e9,
}


def bound(nbytes: float, nops: float, int_ops: float = 0.0,
          chip: Dict = H100_SXM) -> Tuple[float, str]:
    """(least ms, what sets it: ``"bytes"`` or ``"operations"``)."""
    b = nbytes / chip["hbm_bytes_per_ms"]
    o = max(nops / chip["fp32_ops_per_ms"], int_ops / chip["int32_ops_per_ms"])
    return (b, "bytes") if b >= o else (o, "operations")


def model_ms(model: Dict, chip: Dict = H100_SXM) -> float:
    return bound(model["bytes"], model["ops"], model.get("int_ops", 0.0), chip)[0]


def remap_model(H: int, W: int, images: int = 2) -> Dict:
    """K1: per output pixel the source pixel (1 byte), the map's float32
    (x, y) (8) and the output (1); ~20 operations."""
    return {"bytes": images * H * W * (1 + 8 + 1), "ops": 20 * images * H * W}


def prefilter_model(H: int, W: int, images: int = 2) -> Dict:
    """The x-Sobel prefilter: a uint8 image in, float32 out; ~10
    operations a pixel (the 3×2 taps, the clamp)."""
    return {"bytes": images * H * W * (1 + 4), "ops": 10 * images * H * W}


def stereobm_fused_model(H: int, W: int, nd: int) -> Dict:
    """K2: two prefiltered float32 images in, three 4-byte maps out; 8
    operations per (pixel, disparity)."""
    return {"bytes": 5 * H * W * 4, "ops": 8 * H * W * nd}


def speckle_model(H: int, W: int, rounds: float) -> Dict:
    """K3: disparity (float32) and validity (1 byte) in, int32 labels out;
    per round the data needs a row and a column pass of 2 operations a
    pixel."""
    return {"bytes": H * W * (4 + 1 + 4), "ops": 2 * 2 * rounds * H * W}


def sizing_model(H: int, W: int) -> Dict:
    """The speckle filter's sizing and masking: labels (4 bytes), disparity
    (4) and validity (1) in; the filtered disparity (4) and validity (1)
    out; ~4 operations a pixel (count, gather, compare, select)."""
    return {"bytes": H * W * (4 + 4 + 1 + 4 + 1), "ops": 4 * H * W}


def reproject_model(H: int, W: int) -> Dict:
    """Reprojection: disparity (4) and validity (1) in, xyz (12) out; four
    rows of Q (3 multiply-adds each), a reciprocal and 3 products."""
    return {"bytes": H * W * (4 + 1 + 12), "ops": 28 * H * W}


def sgm_fused_model(H: int, W: int, nd: int, cost_bytes: int = 2,
                    exc_bytes: int = 1, paths: int = 4) -> Dict:
    """The SGM kernels on (H, W, nd) volumes (V = H·W·nd cells) at
    ``cost_bytes`` and ``exc_bytes`` a cell; walk operations are int32 on
    integer (2-byte) cost storage, float32 otherwise.  K4: images in, cost
    and down excess out, 6 float32 + 10 walk operations a cell; K4 cost
    (2 paths): images in, cost out, 6; K5 (one call): cost and, in two of
    three calls, an excess in, an excess out, 10 walk; DG (one pair call):
    cost in, pair sum out, 20 walk; K6: cost and ``paths / 2`` pair volumes
    in, three 4-byte maps out, 5 + paths / 2 float32 a cell."""
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


def sgm_storage_bytes(matcher: Dict) -> Tuple[int, int]:
    """(cost, excess) bytes a cell the port stores for integer images:
    uint16 cost when the clamp 2·P2 + 255·block² fits, then uint8 excess
    when 2·P2 fits 255, int16 when it fits 32767; float32 otherwise."""
    p1, p2 = float(matcher["sgm_p1"]), float(matcher["sgm_p2"])
    clamp = 2.0 * p2 + 255.0 * matcher["block_size"] ** 2
    if p1.is_integer() and p2.is_integer() and p1 >= 0 and p2 >= 0 and clamp <= 65535:
        if 2 * p2 <= 255:
            return 2, 1
        if 2 * p2 <= 32767:
            return 2, 2
    return 4, 4


def matcher_model(matcher: Dict, H: int, W: int) -> Dict:
    """The matcher's kernels alone: K2 for ``bm``, the SGM chain for
    ``sgm``."""
    nd = matcher["num_disparities"]
    if matcher["algorithm"] == "bm":
        return stereobm_fused_model(H, W, nd)
    cb, eb = sgm_storage_bytes(matcher)
    return sgm_fused_model(H, W, nd, cb, eb, matcher["sgm_paths"])


def step_model(config: Dict, rounds: float) -> Dict:
    """A whole frame step of ``config`` (its ``image`` size, ``matcher``
    and ``speckle``), with ``rounds`` label rounds: the sum of its stages'
    bytes and operations."""
    H, W = config["image"]["height"], config["image"]["width"]
    parts = [remap_model(H, W), prefilter_model(H, W),
             matcher_model(config["matcher"], H, W), reproject_model(H, W)]
    if config["speckle"]["max_speckle_size"] > 0:
        parts += [speckle_model(H, W, rounds), sizing_model(H, W)]
    return {k: sum(p.get(k, 0) for p in parts) for k in ("bytes", "ops", "int_ops")}
