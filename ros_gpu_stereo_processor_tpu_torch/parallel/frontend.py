"""The sharded frontend: rectification, matching, the speckle filter and
the bilateral filter by row band, and block matching by disparity slab.

The port of ``ros_gpu_stereo_processor_tpu/parallel/frontend.py``.  Each
function takes a mesh (parallel/mesh.py, or the process mesh of
parallel/multihost.py) and the axis to shard over, and runs on the line
``mesh.along(axis)``.  By row band, an image is split into n horizontal
bands, band i on the line's entry i; the functions take whole (H, ...)
tensors or this process's bands and return this process's bands.  Where
the JAX version runs ``shard_map`` with ``ppermute``/``psum``/``pmin``/
``all_gather`` over a named mesh axis, the port runs a loop over its parts,
and the collectives are the mesh's methods (``shift_down``, ``shift_up``,
``psum``, ``pmin``, ``all_gather``; :func:`halo_exchange` is built on the
shifts).  On a mesh in one process nothing here reads a device value on
the host, so a frame on one card captures as one CUDA graph
(models/pipeline.py).

  * :func:`remap_row_sharded`: each band rectifies its own rows with K1 (the
    band's rows of the maps over the replicated source frame).
  * :func:`disparity_row_sharded`: K2 per band on the halo-extended
    prefiltered rows (``block_radius`` rows from each neighbour, zeros at
    the image's edges), interior rows kept; bit-identical to one device.
  * :func:`disparity_sgm_row_sharded`: the fused 4-path SGM (K4–K6) per
    band extended by ``block_radius + warmup_rows`` rows: the JAX version's
    tiled approximation, value for value.
  * :func:`disparity_slab_sharded`: each entry searches nd/n candidates
    over the whole image (a plain-torch cost slab, as JAX runs XLA's cost
    volume there), winners combined by a ``pmin`` over packed keys; equal
    to the single-device matcher.
  * :func:`filter_speckles_row_sharded`: band-local labels, a cross-band
    merge loop of a fixed round count on the device (its label rounds
    gated by a device-side ``done`` flag), band-local sizing,
    boundary-record reconciliation and K7, the max-propagation of the
    reconciled sizes.
  * :func:`bilateral_row_sharded`: the bilateral filter per band on rows
    extended by ``2·iters·radius`` (plain torch, as on one device);
    bit-identical to one device while the halo fits in a band.

Each band's prefilter reads the rows its stencil needs from its neighbours
(edge rows replicated at the image's first and last row, as the whole-image
prefilter does), so band prefilters and texture sums equal the whole
image's.  Row offsets and the image's edges are judged by a part's index on
the line (``Mesh.indices``), so a process that holds only some of the bands
computes them as one process holding all would.  Kernel-backed ops dispatch
on the device of their tensors, so a CPU mesh runs the plain versions and a
CUDA mesh the kernels.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple, Union

import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import bilateral as bilateral_ops
from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import sgm_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as speckle_ops
from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as bm_ops
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm_kernel
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import Mesh

Bands = List[torch.Tensor]

_BIG_INT = 10**6  # invalid-cost sentinel of the packed slab keys


def _bands(m: Mesh, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> Bands:
    """This process's bands of a whole tensor on the line ``m``, or a band
    list (one band per part) checked."""
    (axis,), n = m.axis_names, m.size
    if isinstance(x, torch.Tensor):
        if x.shape[0] % n != 0:
            raise ValueError(f"H={x.shape[0]} not divisible by mesh axis {axis}={n}")
        return m.split(x)
    x = list(x)
    if len(x) != len(m.devices) or len({b.shape for b in x}) != 1:
        raise ValueError(f"{len(x)} bands of shapes {[tuple(b.shape) for b in x]} "
                         f"for mesh axis {axis}={n}")
    return [b.to(d) for b, d in zip(x, m.devices)]


def _whole(m: Mesh, x: Union[torch.Tensor, Sequence[torch.Tensor]]) -> torch.Tensor:
    """A whole tensor on the line's first device, from itself or its bands."""
    return x.to(m.devices[0]) if isinstance(x, torch.Tensor) else m.gather(list(x))


def halo_exchange(mesh: Mesh, bands: Sequence[torch.Tensor], halo: int) -> Bands:
    """Extend each (Hb, ...) band with ``halo`` rows from each neighbour:
    (Hb + 2·halo, ...).  The image's first and last band receive zeros —
    identical to the single-device zero-padded window sums."""
    if halo == 0:
        return list(bands)
    if halo > bands[0].shape[0]:
        raise ValueError(f"halo {halo} exceeds the band height {bands[0].shape[0]}")
    top = mesh.shift_down([b[-halo:] for b in bands])
    bot = mesh.shift_up([b[:halo] for b in bands])
    return [torch.cat([t, b, u]) for t, b, u in zip(top, bands, bot)]


# ---------------------------------------------------------------------------
# Rectification
# ---------------------------------------------------------------------------


def remap_row_sharded(
    images: torch.Tensor,
    maps: Union[torch.Tensor, Sequence[torch.Tensor]],
    mesh: Mesh,
    axis: str = "rows",
) -> Bands:
    """Row-band rectification: ``images`` (S, H_src, W_src[, C]) is the raw
    frame stack, replicated (every band reads any source row it needs);
    ``maps`` (S, H, W, 2), or its bands (S, H/n, W, 2).  Each band runs one
    K1 launch for its destination rows.  Returns the (S, H/n, W[, C])
    bands, bit-identical to the whole-image remap."""
    m = mesh.along(axis)
    if isinstance(maps, torch.Tensor):
        if maps.shape[1] % m.size != 0:
            raise ValueError(f"H={maps.shape[1]} not divisible by mesh axis {axis}={m.size}")
        maps = m.split(maps, dim=1)
    return [remap_kernel.rectify(img, mp) for img, mp in zip(m.replicate(images), maps)]


# ---------------------------------------------------------------------------
# Matching by row band
# ---------------------------------------------------------------------------


def _prefilter_halo(cfg: StereoBMConfig) -> int:
    """Rows the prefilter's stencil reaches above and below a pixel: the
    x-Sobel's 3 × 3, the normalized response's 9 × 9 window
    (ops/stereobm.py)."""
    return 1 if cfg.xsobel else 4


def _prefilter_bands(m: Mesh, bands: Bands, cfg: StereoBMConfig) -> Bands:
    """Each band's prefilter over its rows plus its neighbours' stencil rows;
    at the image's first and last row the prefilter's own edge padding
    applies, as on the whole image."""
    p = _prefilter_halo(cfg)
    n, hb = m.size, bands[0].shape[0]
    if n > 1 and p > hb:
        raise ValueError(f"prefilter halo {p} exceeds the band height {hb}")
    top = m.shift_down([b[-p:] for b in bands])
    bot = m.shift_up([b[:p] for b in bands])
    out = []
    for i, g, b in zip(range(len(bands)), m.indices, bands):
        parts = ([top[i]] if g > 0 else []) + [b] + ([bot[i]] if g < n - 1 else [])
        lo = p if g > 0 else 0
        out.append(bm_ops.prefilter(torch.cat(parts), cfg)[lo:lo + hb])
    return out


def _texture_bands(m: Mesh, lf: Bands, cfg: StereoBMConfig) -> List:
    """``texture_sum`` by band (None per band when the gate is off): the
    window sum of |prefiltered − cap| over halo rows that are zero beyond
    the image, as the whole image's zero-padded sum."""
    if cfg.texture_threshold <= 0:
        return [None] * len(lf)
    r, hb = cfg.block_radius, lf[0].shape[0]
    t_e = halo_exchange(m, [(x - cfg.prefilter_cap).abs() for x in lf], r)
    return [bm_ops._box_sum(t, cfg.block_size)[r:r + hb] for t in t_e]


def _matcher_inputs(L: Bands, R: Bands, cfg: StereoBMConfig, m: Mesh, halo: int):
    """(prefiltered left and right bands extended by ``halo``, texture
    bands)."""
    lf = _prefilter_bands(m, L, cfg)
    rf = _prefilter_bands(m, R, cfg)
    return halo_exchange(m, lf, halo), halo_exchange(m, rf, halo), _texture_bands(m, lf, cfg)


def disparity_row_sharded(
    left_rect,
    right_rect,
    cfg: StereoBMConfig,
    mesh: Mesh,
    axis: str = "rows",
) -> Tuple[Bands, Bands]:
    """Row-band block matching, bit-identical to
    :func:`ops.stereobm_kernel.compute_disparity_fused` without
    ``lr_check``.  Inputs: (H, W) rectified mono images or their bands;
    outputs: the (disparity float32, valid bool) bands.

    Each band runs K2 on its prefiltered rows extended by ``block_radius``
    halo rows (the JAX ``fused_raw(..., halo=r)`` contract) and keeps the
    interior rows; the gates judge border rows by their image row.  With
    ``lr_check`` the right disparity is a second K2 launch on the band's
    mirrored, swapped extended rows, ungated, as in the JAX band
    (frontend.py, ``use_pallas``)."""
    m = mesh.along(axis)
    L, R = _bands(m, left_rect), _bands(m, right_rect)
    hb, halo = L[0].shape[0], cfg.block_radius
    H = hb * m.size
    lf_e, rf_e, tex = _matcher_inputs(L, R, cfg, m, halo)
    disp_out, valid_out = [], []
    inner = slice(halo, halo + hb)
    for i, g in enumerate(m.indices):
        raw = [x[inner] for x in stereobm_kernel.fused_raw(lf_e[i], rf_e[i], cfg)]
        disp, valid = stereobm_kernel.fused_gates(*raw, cfg, tex[i], row_offset=g * hb,
                                                  total_rows=H)
        if cfg.lr_check:
            dr_raw = stereobm_kernel.fused_raw(rf_e[i].flip(1), lf_e[i].flip(1), cfg)[0]
            disp, valid = bm_ops.apply_lr_check(disp, valid, dr_raw[inner].flip(1), cfg)
        disp_out.append(disp)
        valid_out.append(valid)
    return disp_out, valid_out


def disparity_sgm_row_sharded(
    left_rect,
    right_rect,
    cfg: StereoBMConfig,
    mesh: Mesh,
    axis: str = "rows",
    p1: float = 10.0,
    p2: float = 120.0,
    warmup_rows: int = 32,
) -> Tuple[Bands, Bands]:
    """Row-band 4-path SGM.  Horizontal paths are exact per row; vertical
    paths start each band ``block_radius + warmup_rows`` rows early (capped
    at H/n, zeros beyond the image), the JAX version's tiled approximation.

    Each band runs the fused SGM (K4, K5 ×3, K6) on its extended rows, keeps
    the interior rows and gates them by image row.  With ``lr_check`` the
    band assembles the aggregated total from the stored volumes and runs the
    WTA and consistency tail in plain PyTorch, as the single-device fused
    path does."""
    m = mesh.along(axis)
    L, R = _bands(m, left_rect), _bands(m, right_rect)
    hb = L[0].shape[0]
    H = hb * m.size
    # a band can only export as many halo rows as it owns
    halo = min(cfg.block_radius + warmup_rows, hb)
    integer_input = not L[0].is_floating_point()
    lf_e, rf_e, tex = _matcher_inputs(L, R, cfg, m, halo)
    disp_out, valid_out = [], []
    inner = slice(halo, halo + hb)
    for i, g in enumerate(m.indices):
        if cfg.lr_check:
            vols = sgm_kernel.sgm_fused_raw(lf_e[i], rf_e[i], cfg, p1, p2, integer_input,
                                            return_volumes=True)
            total = sgm_kernel._masked_total(*(v.permute(1, 2, 0) for v in vols), cfg)
            cost_agg = total.permute(2, 0, 1)[:, inner]
            disp, valid = bm_ops.wta_disparity(cost_agg, None, cfg, tex=tex[i],
                                               row_offset=g * hb, total_rows=H)
            disp_r = bm_ops.right_disparity_from_cost(cost_agg, cfg)
            disp, valid = bm_ops.apply_lr_check(disp, valid, disp_r, cfg)
        else:
            raw = sgm_kernel.sgm_fused_raw(lf_e[i], rf_e[i], cfg, p1, p2, integer_input)
            disp, valid = stereobm_kernel.fused_gates(*(x[inner] for x in raw), cfg, tex[i],
                                                      row_offset=g * hb, total_rows=H)
        disp_out.append(disp)
        valid_out.append(valid)
    return disp_out, valid_out


# ---------------------------------------------------------------------------
# Matching by disparity slab
# ---------------------------------------------------------------------------


def disparity_slab_sharded(
    left_rect,
    right_rect,
    cfg: StereoBMConfig,
    mesh: Mesh,
    axis: str = "disp",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Disparity-slab block matching, the JAX ``disparity_slab_sharded``:
    each entry of the line along ``axis`` evaluates ``num_disparities / n``
    candidates over the whole image, and the winners combine by a ``pmin``
    over packed int32 keys ``round(cost·16)·nd + d`` (``_BIG_INT`` for an
    invalid cost; ties go to the smallest disparity, as the single-device
    argmin).  Inputs: (H, W) rectified mono images or their row bands on the
    same line; outputs: the whole (disparity float32, valid bool) on the
    line's first device, equal to :func:`ops.stereobm.compute_disparity`.

    Subpixel refinement takes the winner's neighbour costs, which may lie
    in the next slab: each slab's first and last cost planes go to its
    neighbours (``shift_up`` / ``shift_down``), the winner's own cost comes
    from the owning slab by a ``psum``, and so does the parabola's step.
    Uniqueness is the ``pmin`` of each slab's minimum over |d − best| > 1.
    ``lr_check`` is not applied, as in the JAX version.

    The slab's cost volume is plain torch (:func:`ops.stereobm.sad_cost_volume`
    at the slab's disparity offset, one batched pass per slab), as slab mode
    runs XLA's cost-volume path and never the fused matcher in JAX: the
    cross-slab reductions need the cost planes in memory."""
    m = mesh.along(axis)
    n, nd = m.size, cfg.num_disparities
    if nd % n != 0:
        raise ValueError(f"num_disparities={nd} not divisible by {n}")
    k, mind, r = nd // n, cfg.min_disparity, cfg.block_radius
    lf = bm_ops.prefilter(_whole(m, left_rect), cfg)
    rf = bm_ops.prefilter(_whole(m, right_rect), cfg)
    H, W = lf.shape
    dev = lf.device
    offsets = [g * k for g in m.indices]
    costs = [bm_ops.sad_cost_volume(a, b, cfg, d_offset=o, count=k)
             for a, b, o in zip(m.replicate(lf), m.replicate(rf), offsets)]

    keys = []
    for c, o in zip(costs, offsets):
        local_cost, local_best = torch.min(c, dim=0)
        ci = torch.where(local_cost >= bm_ops.BIG, _BIG_INT,
                         torch.round(local_cost * 16.0).to(torch.int32))
        keys.append(ci * nd + (local_best.to(torch.int32) + o))
    key = m.pmin(keys)[0]
    q = torch.div(key, nd, rounding_mode="floor")
    best_cost = torch.where(q >= _BIG_INT, bm_ops.BIG, q.float() / 16.0)
    best_d = torch.remainder(key, nd)
    valid = (best_cost < bm_ops.BIG) & bm_ops.border_mask(H, W, r, dev)
    if cfg.texture_threshold > 0:
        valid &= bm_ops.texture_sum(lf, cfg) >= cfg.texture_threshold
    disp = (best_d + mind).float()

    bests = m.replicate(best_d)
    if cfg.refine_disparity:
        # boundary planes from the neighbour slabs (the line's ends see BIG)
        prev_pl = m.shift_down([c[-1] for c in costs])
        next_pl = m.shift_up([c[0] for c in costs])
        c0s, steps = [], []
        for i, (g, c, o, bd) in enumerate(zip(m.indices, costs, offsets, bests)):
            rel = bd - o
            owner = (rel >= 0) & (rel < k)
            idx0 = rel.clamp(-1, k)
            edge_lo = prev_pl[i] if g > 0 else bm_ops.BIG
            edge_hi = next_pl[i] if g < n - 1 else bm_ops.BIG

            def plane_at(idx, c=c, edge_lo=edge_lo, edge_hi=edge_hi):
                inside = c.gather(0, idx.clamp(0, k - 1)[None])[0]
                return torch.where((idx >= 0) & (idx < k), inside,
                                   torch.where(idx == -1, edge_lo,
                                               torch.where(idx == k, edge_hi, bm_ops.BIG)))

            cm, cp = plane_at(idx0 - 1), plane_at(idx0 + 1)
            c0s.append(torch.where(owner, plane_at(idx0), 0.0))
            steps.append((owner, bd, cm, cp))
        # the winner's exact cost from its owner (the packed one is in 1/16)
        deltas = []
        for c0, (owner, bd, cm, cp) in zip(m.psum(c0s), steps):
            denom = cm + cp - 2.0 * c0
            delta = torch.where(denom > 0, (cm - cp) / (2.0 * denom), 0.0).clamp(-0.5, 0.5)
            interior = owner & (bd > 0) & (bd < nd - 1) & (cm < bm_ops.BIG) & (cp < bm_ops.BIG)
            deltas.append(torch.where(interior, delta, 0.0))
        disp = disp + m.psum(deltas)[0]

    if cfg.uniqueness_ratio > 0:
        excl = []
        for c, o, bd in zip(costs, offsets, bests):
            didx = o + torch.arange(k, device=c.device)[:, None, None]
            away = (didx - bd[None]).abs() > 1
            excl.append(torch.where(away, c, bm_ops.BIG).amin(0))
        thresh = best_cost * (1.0 + cfg.uniqueness_ratio / 100.0)
        valid &= ~(m.pmin(excl)[0] <= thresh)

    disp = torch.where(valid, disp, torch.full((), float(mind - 1), device=dev))
    return disp, valid


# ---------------------------------------------------------------------------
# Speckle filter
# ---------------------------------------------------------------------------


def _band_counts(lab: torch.Tensor, n_labels: int, cap: int) -> torch.Tensor:
    """Per pixel, min(count of its label within the band, cap), int32:
    ``index_add_`` into an int64 buffer over the global label range
    [0, n_labels] (no sort, no host read)."""
    flat = lab.reshape(-1).long()
    counts = torch.zeros(n_labels + 1, dtype=torch.int64, device=lab.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return counts[flat].clamp_max(cap).to(torch.int32).reshape(lab.shape)


def _reconcile(rec_lab: torch.Tensor, rec_cnt: torch.Tensor, n_labels: int,
               cap: int) -> torch.Tensor:
    """The (n, 2, W) boundary records (label, band-local count) → each
    record's component total, capped at ``cap``: every distinct
    (label, band) pair contributes that band's count once.  Duplicates of a
    pair carry equal counts, so scattering them into a (band, label) table
    keeps exactly one."""
    n = rec_lab.shape[0]
    lab = rec_lab.long()
    band = torch.arange(n, device=lab.device)[:, None, None].expand_as(lab)
    seen = torch.zeros((n, n_labels + 1), dtype=torch.int64, device=lab.device)
    seen[band, lab] = rec_cnt.long()
    total = seen.sum(0).clamp_max(cap)
    return total[lab].to(torch.int32)


def speckle_size_fields(
    disp: Bands,
    valid: Bands,
    mesh: Mesh,
    *,
    max_speckle_size: int,
    max_diff: float,
    merge_rounds: int = 0,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Everything of :func:`filter_speckles_row_sharded` before K7: per band
    (field, conn_x, conn_y) — the band-local component sizes (capped at
    ``max_speckle_size + 1``) raised at the boundary rows to the reconciled
    totals of the components that cross the band's edges, and the
    band-local link masks.  With one band the field is the band's sizes.
    ``mesh`` is the band line (``Mesh.along``)."""
    n, (hb, W) = mesh.size, disp[0].shape
    H = n * hb
    sentinel = H * W
    cap = max_speckle_size + 1
    max_merge = merge_rounds if merge_rounds > 0 else 4 * n + 8
    conn = [speckle_ops._connectivity(d, v, max_diff) for d, v in zip(disp, valid)]

    # cross-boundary connectivity (disp/valid of the adjacent rows)
    prev_d = mesh.shift_down([d[-1] for d in disp])
    prev_v = mesh.shift_down([v[-1] for v in valid])
    next_d = mesh.shift_up([d[0] for d in disp])
    next_v = mesh.shift_up([v[0] for v in valid])
    conn_top = [v[0] & pv & ((d[0] - pd).abs() <= max_diff)
                for d, v, pd, pv in zip(disp, valid, prev_d, prev_v)]
    conn_bot = [v[-1] & nv & ((d[-1] - nd).abs() <= max_diff)
                for d, v, nd, nv in zip(disp, valid, next_d, next_v)]

    def pixels(g, dev):
        return (g * hb * W + torch.arange(hb * W, dtype=torch.int32, device=dev)).reshape(hb, W)

    fill = [torch.full((), sentinel, dtype=torch.int32, device=v.device) for v in valid]
    lab = [torch.where(v, pixels(g, v.device), s)
           for g, v, s in zip(mesh.indices, valid, fill)]

    def merge(lab):
        # boundary rows connected across a band edge take the smaller label
        # (conn_top implies the neighbour row is valid, so its label is used
        # as it is: the JAX merge's sentinel for invalid rows never shows)
        prev_lab = mesh.shift_down([x[-1] for x in lab])
        next_lab = mesh.shift_up([x[0] for x in lab])
        for i, x in enumerate(lab):
            top = torch.where(conn_top[i], torch.minimum(x[0], prev_lab[i]), x[0])
            bot = torch.where(conn_bot[i], torch.minimum(x[-1], next_lab[i]), x[-1])
            x[0] = top
            x[-1] = bot
        return lab

    # label propagation to global convergence (or max_merge rounds): each
    # round is 2 band-local label rounds, then the boundary merge.  Exactly
    # max_merge rounds run, with no host read: each round's changed flag is
    # a psum, and a device-side `done` flag, set once a round changed
    # nothing, gates the label rounds of the rounds after it.  Propagation
    # is monotone, so a round at the fixed point changes nothing, and the
    # labels are those of JAX's while_loop (i < max_merge & changed), capped
    # runs included.  A mesh that spans processes (its psum an exchange
    # through the host) also reads the flag and leaves the loop once it is
    # set.
    done = torch.zeros((), dtype=torch.int32, device=mesh.devices[0])
    for _ in range(max_merge):
        gates = mesh.replicate(done)
        new = [speckle_kernel.band_labels(x, cx, cy, 2, d)
               for x, (cx, cy), d in zip(lab, conn, gates)]
        if n > 1:
            new = merge(new)
        changed = mesh.psum([(a != b).any() for a, b in zip(new, lab)])[0]
        done = done | ~changed
        lab = new
        if mesh.spans_processes and bool(done):
            break
    lab = [torch.where(v, x, s) for v, x, s in zip(valid, lab, fill)]
    cnt = [_band_counts(x, sentinel, cap) for x in lab]
    if n == 1:
        return [(cnt[0],) + conn[0]]

    # reconciliation over boundary rows only: (n, 2, W) records
    rec_lab = mesh.all_gather([torch.stack([x[0], x[-1]]) for x in lab])
    rec_cnt = mesh.all_gather([torch.stack([c[0], c[-1]]) for c in cnt])
    btot = _reconcile(rec_lab, rec_cnt, sentinel, cap)
    out = []
    for i, (g, c) in enumerate(zip(mesh.indices, cnt)):
        mine = btot[g].to(c.device)
        field = c.clone()
        field[0] = torch.maximum(c[0], mine[0])
        field[-1] = torch.maximum(field[-1], mine[1])
        out.append((field,) + conn[i])
    return out


def filter_speckles_row_sharded(
    disp,
    valid,
    mesh: Mesh,
    axis: str = "rows",
    *,
    max_speckle_size: int = 800,
    max_diff: float = 5.0,
    iters: int = 16,
    merge_rounds: int = 0,
    fill_value: float = -1.0,
) -> Tuple[Bands, Bands]:
    """Row-band speckle filter (connected-component invalidation), value for
    value the JAX ``filter_speckles_row_sharded``:

      1. each band labels locally with global raster-index labels;
      2. merge rounds — 2 band-local label rounds, then each boundary row
         connected across a band edge takes the smaller label — until no
         band changes, or ``4n + 8`` rounds (``merge_rounds`` when > 0):
         on a mesh in one process every one of those rounds is enqueued and
         the rounds after the fixed point are gated off on the device (no
         host read); a mesh that spans processes reads the flag each round
         and stops there;
      3. band-local sizes capped at ``max_speckle_size + 1``, reconciled
         across bands through the (n, 2, W) boundary records;
      4. K7: the reconciled totals, raised at the boundary rows, are
         max-propagated through each band (``iters = 4·H/n`` rounds) — with
         one band the local sizes are final and K7 does not run.

    ``iters`` is accepted and not read, as in the JAX version: the label
    rounds are a fixed 2 per merge round.  Returns the (filtered disparity,
    keep) bands."""
    m = mesh.along(axis)
    D, V = _bands(m, disp), _bands(m, valid)
    fields = speckle_size_fields(D, V, m, max_speckle_size=max_speckle_size,
                                 max_diff=max_diff, merge_rounds=merge_rounds)
    disp_out, keep_out = [], []
    for d, v, (field, cx, cy) in zip(D, V, fields):
        sizes = field if m.size == 1 else speckle_kernel.max_propagate(
            field, cx, cy, 4 * d.shape[0])
        keep = (sizes > max_speckle_size) & v
        fill = torch.full((), float(fill_value), device=d.device)
        disp_out.append(torch.where(keep, d, fill))
        keep_out.append(keep)
    return disp_out, keep_out


# ---------------------------------------------------------------------------
# Bilateral filter
# ---------------------------------------------------------------------------


def bilateral_row_sharded(
    disp,
    guide,
    mesh: Mesh,
    axis: str = "rows",
    *,
    ndisp: int = 64,
    radius: int = 3,
    iters: int = 1,
    edge_threshold: float = 0.1,
    max_disc_threshold: float = 0.2,
    sigma_range: float = 10.0,
) -> Bands:
    """Row-band disparity bilateral filter, the JAX
    ``bilateral_row_sharded``.  Each of the ``2·iters`` checkerboard
    half-steps moves information at most ``radius`` rows, so a halo of
    ``2·iters·radius`` rows (exchanged once: the disparity, the guide and a
    ones "valid" band, zeros beyond the image so out-of-image taps weigh 0)
    makes each band's own rows bit-identical to the single-device filter.
    The halo is clamped to the band height; beyond that the result is the
    tiled approximation the JAX version computes.  Returns the refined
    disparity bands."""
    m = mesh.along(axis)
    D, G = _bands(m, disp), _bands(m, guide)
    hb, W = D[0].shape
    H = hb * m.size
    halo = min(2 * iters * radius, hb)
    d_e = halo_exchange(m, [d.float() for d in D], halo)
    g_e = halo_exchange(m, [g.float() for g in G], halo)
    v_e = halo_exchange(m, [torch.ones((hb, W), dtype=torch.float32, device=d.device)
                            for d in D], halo)
    out = []
    for i, (gi, d, g, v) in enumerate(zip(m.indices, d_e, g_e, v_e)):
        r = bilateral_ops._bilateral_core(
            d, g, v, ndisp=ndisp, radius=radius, iters=iters,
            edge_threshold=edge_threshold, max_disc_threshold=max_disc_threshold,
            sigma_range=sigma_range, row_offset=gi * hb - halo, total_rows=H)
        out.append(r[halo:halo + hb].to(D[i].dtype))
    return out
