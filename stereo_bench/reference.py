"""The plain reference of the served stereo step, in plain PyTorch and NumPy.

What decides ``correct``: for a pair, the disparity and the point cloud the
node should publish, worked out from the raw images and the
configuration's calibration numbers alone.  It imports nothing of the
port; its functions are frozen copies of the port's plain versions
(``utils/calib.py``'s rectification maps and Q, ``ops/remap.py``,
``ops/stereobm.py``, ``ops/sgm.py``, ``ops/speckle.py``), which the port's
tests hold its kernels to bit for bit, with two changes:

  * the speckle labels stop at the first round that changes nothing (the
    same labels as running every allowed round, since a round that changes
    nothing changes nothing after it) and count the rounds that changed
    something: the rounds the data needs, which the cost model reads;
  * the point cloud is worked out in float64 from the disparity and Q.

``dtype`` is the precision of every computed stage (float32 as the
configurations state; bfloat16 makes the control that ``correct`` has to
reject).  Run on any device; on the card it runs after the window, in
blocks of one pair.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

BIG = 1e9
_RESTART = 1e6


def _is_big(x: torch.Tensor) -> torch.Tensor:
    """The cells that hold BIG: every real cost lies far below BIG / 2
    (a block-15 SAD at most 62·225, an 8-path total under 10^6), so the
    test keeps its meaning when BIG is rounded to a lower precision."""
    return x >= 0.5 * BIG


# ---------------------------------------------------------------------------
# Calibration: rectification maps and Q from the configuration's numbers
# ---------------------------------------------------------------------------


def _distort_plumb_bob(x, y, D):
    d = np.zeros(8, np.float64)
    d[: D.size] = D
    k1, k2, p1, p2, k3, k4, k5, k6 = d
    r2 = x * x + y * y
    r4 = r2 * r2
    r6 = r4 * r2
    radial = (1.0 + k1 * r2 + k2 * r4 + k3 * r6) / (1.0 + k4 * r2 + k5 * r4 + k6 * r6)
    xy = x * y
    xd = x * radial + 2.0 * p1 * xy + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * xy
    return xd, yd


def rect_map(K, D, R, P, width: int, height: int) -> np.ndarray:
    """(H, W, 2) float32 raw-image sample position of each rectified pixel:
    back-project through P, rotate by R⁻¹, distort (plumb_bob), project
    through K."""
    K = np.asarray(K, np.float64).reshape(3, 3)
    R = np.asarray(R, np.float64).reshape(3, 3)
    P = np.asarray(P, np.float64).reshape(3, -1)[:, :3]
    u, v = np.meshgrid(np.arange(width, dtype=np.float64), np.arange(height, dtype=np.float64))
    x = (u - P[0, 2]) / P[0, 0]
    y = (v - P[1, 2]) / P[1, 1]
    rays = np.stack([x, y, np.ones_like(x)], axis=0).reshape(3, -1)
    rays = np.linalg.inv(R) @ rays
    xd, yd = _distort_plumb_bob(rays[0] / rays[2], rays[1] / rays[2], np.asarray(D, np.float64))
    map_x = K[0, 0] * xd + K[0, 1] * yd + K[0, 2]
    map_y = K[1, 1] * yd + K[1, 2]
    return np.stack([map_x.reshape(height, width), map_y.reshape(height, width)],
                    axis=-1).astype(np.float32)


def camera(calib: Dict, width: int, height: int) -> Tuple[np.ndarray, np.ndarray]:
    """(rect maps (2, H, W, 2) float32, Q (4, 4) float64) of a configuration's
    ``calibration`` block."""
    maps = np.stack([rect_map(calib[f"K_{side}"], calib[f"D_{side}"], calib[f"R_{side}"],
                              calib[f"P_{side}"], width, height) for side in ("left", "right")])
    Pl = np.asarray(calib["P_left"], np.float64)
    Pr = np.asarray(calib["P_right"], np.float64)
    fx, cx, cy = Pl[0, 0], Pl[0, 2], Pl[1, 2]
    B = -Pr[0, 3] / Pr[0, 0]
    Q = np.zeros((4, 4), np.float64)
    Q[0, 0] = Q[1, 1] = 1.0
    Q[0, 3], Q[1, 3] = -cx, -cy
    Q[2, 3] = fx
    Q[3, 2] = 1.0 / B
    Q[3, 3] = -(cx - Pr[0, 2]) / B
    return maps, Q


# ---------------------------------------------------------------------------
# Rectification (K1)
# ---------------------------------------------------------------------------


def remap(img: torch.Tensor, src_map: torch.Tensor, dtype=torch.float32) -> torch.Tensor:
    """Bilinear sample of the uint8 ``img`` (H, W[, C]) at ``src_map`` (H, W,
    2); out-of-range taps give 0; rounded half to even and clipped."""
    H, W = img.shape[0], img.shape[1]
    chan = img.dim() == 3
    x = src_map[..., 0].to(dtype)
    y = src_map[..., 1].to(dtype)
    x0, y0 = torch.floor(x), torch.floor(y)
    fx, fy = x - x0, y - y0
    x0i, y0i = x0.to(torch.int64), y0.to(torch.int64)
    flat = img.reshape((H * W,) + tuple(img.shape[2:]))

    def sample(yi, xi):
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        v = flat[yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)].to(dtype)
        mask = valid[..., None] if chan else valid
        return torch.where(mask, v, torch.zeros((), dtype=dtype, device=v.device))

    if chan:
        fx, fy = fx[..., None], fy[..., None]
    out = (sample(y0i, x0i) * ((1 - fx) * (1 - fy)) + sample(y0i, x0i + 1) * (fx * (1 - fy))
           + sample(y0i + 1, x0i) * ((1 - fx) * fy) + sample(y0i + 1, x0i + 1) * (fx * fy))
    return torch.clamp(torch.round(out), 0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# Matchers: block matching (K2) and semi-global matching (K4, K5, DG, K6)
# ---------------------------------------------------------------------------


def xsobel(img: torch.Tensor, cap: int, dtype=torch.float32) -> torch.Tensor:
    """x-Sobel response clamped to [0, 2·cap], rows replicated at the top
    and bottom, the first and last column neutral (cap)."""
    x = img.to(dtype)
    xp = torch.cat([x[:1], x, x[-1:]], dim=0)
    rows = xp[:-2] + 2.0 * xp[1:-1] + xp[2:]
    d = F.pad(rows[:, 2:] - rows[:, :-2], (1, 1))
    out = torch.clamp(d + cap, 0.0, 2.0 * cap)
    out[:, 0] = float(cap)
    out[:, -1] = float(cap)
    return out


def box_sum(x: torch.Tensor, block: int) -> torch.Tensor:
    """Sum over a block×block window, zero-padded, over the last two dims."""
    H, W = x.shape[-2:]
    r = block // 2
    xp = F.pad(x, (0, 0, r, r))
    acc = xp[..., 0:H, :]
    for i in range(1, block):
        acc = acc + xp[..., i:i + H, :]
    xp = F.pad(acc, (r, r))
    acc = xp[..., :, 0:W]
    for j in range(1, block):
        acc = acc + xp[..., :, j:j + W]
    return acc


def sad_cost(lf: torch.Tensor, rf: torch.Tensor, m: Dict) -> torch.Tensor:
    """(nd, H, W) SAD over the block, BIG where the right window leaves
    the image."""
    H, W = lf.shape
    nd, mind, block = m["num_disparities"], m["min_disparity"], m["block_size"]
    r = block // 2
    pad_l, pad_r = max(0, mind + nd - 1), max(0, -mind)
    right_p = F.pad(rf, (pad_l, pad_r))
    starts = torch.arange(pad_l - mind, pad_l - mind - nd, -1, device=lf.device)
    shifted = right_p.unfold(1, W, 1).index_select(1, starts)
    sad = box_sum((lf[:, None, :] - shifted).abs().permute(1, 0, 2), block)
    d = torch.arange(mind, mind + nd, device=lf.device)[:, None, None]
    col = torch.arange(W, device=lf.device)[None, None, :]
    ok = (col - d >= r) & (col - d <= W - 1 - r)
    return torch.where(ok, sad, torch.full((), BIG, dtype=sad.dtype, device=sad.device))


def wta(cost: torch.Tensor, lf: torch.Tensor, m: Dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """Winner-take-all (first minimum) with the border, texture and
    uniqueness gates; invalid pixels get min_disparity − 1."""
    nd, H, W = cost.shape
    mind, cap, r = m["min_disparity"], m["prefilter_cap"], m["block_size"] // 2
    cbest, best = torch.min(cost, dim=0)
    valid = ~_is_big(cbest)
    row = torch.arange(H, device=cost.device)[:, None]
    col = torch.arange(W, device=cost.device)[None, :]
    valid &= (row >= r) & (row <= H - 1 - r) & (col >= r) & (col <= W - 1 - r)
    if m["texture_threshold"] > 0:
        valid &= box_sum((lf - cap).abs(), m["block_size"]) >= m["texture_threshold"]
    if m["uniqueness_ratio"] > 0:
        thresh = cbest * (1.0 + m["uniqueness_ratio"] / 100.0)
        near = (torch.arange(nd, device=cost.device)[:, None, None] - best[None]).abs() <= 1
        valid &= ~((cost <= thresh[None]) & ~near).any(dim=0)
    if m.get("refine_disparity"):
        raise ValueError("the reference has no subpixel step: refine_disparity must be false")
    disp = (best + mind).to(torch.float32)
    return torch.where(valid, disp, torch.full((), float(mind - 1), device=disp.device)), valid


def _step_excess(prev, p1, p2):
    m = prev.amin(dim=-1, keepdim=True)
    guard = torch.full_like(prev[..., :1], BIG)
    up = torch.cat([prev[..., 1:], guard], dim=-1)
    dn = torch.cat([guard, prev[..., :-1]], dim=-1)
    best = torch.minimum(torch.minimum(prev, m + p2), torch.minimum(up + p1, dn + p1))
    return best - m


def _path(chw, p1, p2, vertical: bool, reverse: bool):
    """L = C + excess along rows or columns, forward or reverse."""
    seq = chw.movedim(0 if vertical else 1, 0)
    out = torch.empty_like(seq)
    prev = torch.zeros_like(seq[0])
    for t in (range(seq.shape[0] - 1, -1, -1) if reverse else range(seq.shape[0])):
        e = _step_excess(prev, p1, p2)
        prev = seq[t] + e
        out[t] = e
    return chw + out.movedim(0, 0 if vertical else 1)


def _diagonal(chw, p1, p2, dx: int, reverse: bool):
    """L = C + excess along a 45° diagonal; vacated carry columns restart
    the path."""
    fill = torch.full_like(chw[0, :1], _RESTART)

    def shift(a):
        return torch.cat([fill, a[:-1]], dim=0) if dx == 1 else torch.cat([a[1:], fill], dim=0)

    H = chw.shape[0]
    out = torch.empty_like(chw)
    prev = torch.full_like(chw[0], _RESTART)
    for t in (range(H - 1, -1, -1) if reverse else range(H)):
        e = _step_excess(shift(prev), p1, p2)
        prev = chw[t] + e
        out[t] = e
    return chw + out


def sgm_cost(cost: torch.Tensor, m: Dict) -> torch.Tensor:
    """The SAD volume aggregated over 2, 4 or 8 paths (P1, P2), BIG where
    the right window leaves the image."""
    p1, p2, paths = float(m["sgm_p1"]), float(m["sgm_p2"]), m["sgm_paths"]
    invalid = _is_big(cost)
    clampv = 2.0 * p2 + 255.0 * m["block_size"] ** 2
    chw = torch.where(invalid, torch.full((), clampv, dtype=cost.dtype, device=cost.device),
                      cost).movedim(0, -1).contiguous()
    agg = _path(chw, p1, p2, False, False) + _path(chw, p1, p2, False, True)
    if paths >= 4:
        agg = agg + _path(chw, p1, p2, True, False) + _path(chw, p1, p2, True, True)
    if paths == 8:
        agg = (agg + _diagonal(chw, p1, p2, 1, False) + _diagonal(chw, p1, p2, -1, False)
               + _diagonal(chw, p1, p2, 1, True) + _diagonal(chw, p1, p2, -1, True))
    return torch.where(invalid, torch.full((), BIG, dtype=cost.dtype, device=cost.device),
                       agg.movedim(-1, 0))


def disparity(left: torch.Tensor, right: torch.Tensor, m: Dict, dtype=torch.float32):
    """(disparity float32, valid) of a rectified uint8 pair."""
    if m.get("lr_check"):
        raise ValueError("the reference has no left-right check: lr_check must be false")
    lf = xsobel(left, m["prefilter_cap"], dtype)
    rf = xsobel(right, m["prefilter_cap"], dtype)
    cost = sad_cost(lf, rf, m)
    if m["algorithm"] == "sgm":
        cost = sgm_cost(cost, m)
    return wta(cost, lf, m)


# ---------------------------------------------------------------------------
# Speckle filter (K3 and the sizing)
# ---------------------------------------------------------------------------


def _shift(x, dy, dx, fill):
    H, W = x.shape
    out = torch.full_like(x, fill)
    out[max(dy, 0):H + min(dy, 0), max(dx, 0):W + min(dx, 0)] = \
        x[max(-dy, 0):H + min(-dy, 0), max(-dx, 0):W + min(-dx, 0)]
    return out


def _run_min(lab, conn, axis: int):
    """Every run of connected elements along ``axis`` gets its minimum."""
    n = lab.shape[axis]
    top = torch.iinfo(lab.dtype).max

    def sh(x, off, fill):
        return _shift(x, 0, off, fill) if axis == 1 else _shift(x, off, 0, fill)

    f_lab, f_conn, off = lab, conn, 1
    while off < n:
        f_lab = torch.where(f_conn, torch.minimum(f_lab, sh(f_lab, off, top)), f_lab)
        f_conn = f_conn & sh(f_conn, off, False)
        off <<= 1
    b_lab, b_conn, off = f_lab, sh(conn, -1, False), 1
    while off < n:
        b_lab = torch.where(b_conn, torch.minimum(b_lab, sh(b_lab, -off, top)), b_lab)
        b_conn = b_conn & sh(b_conn, -off, False)
        off <<= 1
    return b_lab


def speckle(disp: torch.Tensor, valid: torch.Tensor, s: Dict, fill: float):
    """(filtered disparity, valid, rounds needed): components of 4-connected
    valid pixels with |Δd| ≤ max_diff of at most max_speckle_size pixels are
    invalidated; labels by row/column minimum rounds, at most
    ``propagation_iters``."""
    H, W = disp.shape
    n = H * W
    idx = torch.arange(n, dtype=torch.int32, device=disp.device).reshape(H, W)
    lab = torch.where(valid, idx, torch.full((), n, dtype=torch.int32, device=disp.device))
    max_diff = s["max_diff"]
    conn_x = valid & _shift(valid, 0, 1, False) & ((disp - _shift(disp, 0, 1, float("inf"))).abs() <= max_diff)
    conn_y = valid & _shift(valid, 1, 0, False) & ((disp - _shift(disp, 1, 0, float("inf"))).abs() <= max_diff)
    rounds = 0
    for _ in range(s["propagation_iters"]):
        new = _run_min(_run_min(lab, conn_x, 1), conn_y, 0)
        if torch.equal(new, lab):
            break
        lab, rounds = new, rounds + 1
    counts = torch.zeros(n + 1, dtype=torch.int64, device=disp.device)
    flat = lab.reshape(-1).long()
    counts.index_add_(0, flat, torch.ones_like(flat))
    keep = (counts[flat] > int(s["max_speckle_size"])).reshape(H, W) & valid
    return torch.where(keep, disp, torch.full((), fill, device=disp.device)), keep, rounds


# ---------------------------------------------------------------------------
# The whole step
# ---------------------------------------------------------------------------


def points(disp: torch.Tensor, valid: torch.Tensor, Q: np.ndarray, dtype=torch.float64):
    """(H, W, 3) xyz = Q·[u v d 1] over W, NaN where invalid or W ≤ 1e-12."""
    H, W = disp.shape
    Qt = torch.as_tensor(Q, dtype=dtype, device=disp.device)
    u = torch.arange(W, dtype=dtype, device=disp.device).expand(H, W)
    v = torch.arange(H, dtype=dtype, device=disp.device)[:, None].expand(H, W)
    d = disp.to(dtype)
    rows = [Qt[i, 0] * u + Qt[i, 1] * v + Qt[i, 2] * d + Qt[i, 3] for i in range(4)]
    ok = valid & (rows[3] > 1e-12)
    xyz = torch.stack(rows[:3], dim=-1) / torch.where(ok, rows[3], torch.ones_like(rows[3]))[..., None]
    return torch.where(ok[..., None], xyz, torch.full((), float("nan"), dtype=dtype, device=disp.device))


def step(left: np.ndarray, right: np.ndarray, config: Dict, maps: torch.Tensor,
         Q: np.ndarray, dtype=torch.float32, device="cpu") -> Dict:
    """What the node publishes for one raw mono8 pair: ``disparity`` (H, W)
    float32, ``xyz`` (H, W, 3) float64, ``rgb`` (H, W) int32 (the packed
    0x00RRGGBB of the rectified left image, grey in all three channels),
    and the speckle rounds the pair needs."""
    m, s = config["matcher"], config["speckle"]
    lt = torch.as_tensor(left, device=device)
    rt = torch.as_tensor(right, device=device)
    rect_l = remap(lt, maps[0], dtype)
    rect_r = remap(rt, maps[1], dtype)
    disp, valid = disparity(rect_l, rect_r, m, dtype)
    rounds = 0
    if s["max_speckle_size"] > 0:
        disp, valid, rounds = speckle(disp, valid, s, float(m["min_disparity"] - 1))
    xyz = points(disp, valid, Q, torch.float64 if dtype == torch.float32 else dtype)
    g = rect_l.to(torch.int32)
    return {"disparity": disp.to(torch.float32), "xyz": xyz,
            "rgb": (g << 16) | (g << 8) | g, "rounds": rounds}
