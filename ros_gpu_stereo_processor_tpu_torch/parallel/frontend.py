"""Row-band frontend: rectification, matching, the speckle filter and the
bilateral filter by band.

The port of the row-band half of
``ros_gpu_stereo_processor_tpu/parallel/frontend.py``.  An image is split
into n horizontal bands, band i on device i of a :class:`BandMesh`
(parallel/mesh.py); each function takes whole (H, ...) tensors or lists of
bands and returns lists of bands.  Where the JAX version runs ``shard_map``
with ``ppermute``/``psum``/``all_gather`` over a named mesh axis, the port
runs a loop over the bands, and the collectives are copies and reductions
across the band list (:func:`halo_exchange`, :func:`shift_down`,
:func:`shift_up`, :func:`any_band`, :func:`all_gather`).

  * :func:`remap_row_sharded`: each band rectifies its own rows with K1 (the
    band's rows of the maps over the replicated source frame).
  * :func:`disparity_row_sharded`: K2 per band on the halo-extended
    prefiltered rows (``block_radius`` rows from each neighbour, zeros at
    the image's edges), interior rows kept; bit-identical to one device.
  * :func:`disparity_sgm_row_sharded`: the fused 4-path SGM (K4–K6) per
    band extended by ``block_radius + warmup_rows`` rows: the JAX version's
    tiled approximation, value for value.
  * :func:`filter_speckles_row_sharded`: band-local labels, a cross-band
    merge loop, band-local sizing, boundary-record reconciliation and K7,
    the max-propagation of the reconciled sizes.
  * :func:`bilateral_row_sharded`: the bilateral filter per band on rows
    extended by ``2·iters·radius`` (plain torch, as on one device);
    bit-identical to one device while the halo fits in a band.

Each band's prefilter reads the rows its stencil needs from its neighbours
(edge rows replicated at the image's first and last row, as the whole-image
prefilter does), so band prefilters and texture sums equal the whole
image's.  Kernel-backed ops dispatch on the device of their tensors, so a
CPU mesh runs the plain versions and a CUDA mesh the kernels.  Slab mode
(``disparity_slab_sharded``) is not ported (ROADMAP.md, Queue 1 item 13).
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
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import BandMesh

Bands = List[torch.Tensor]


def _bands(mesh: BandMesh, x: Union[torch.Tensor, Sequence[torch.Tensor]],
           axis: str = "rows") -> Bands:
    """A whole tensor split into the mesh's bands, or a band list checked."""
    n = mesh.shape[axis]
    if isinstance(x, torch.Tensor):
        if x.shape[0] % n != 0:
            raise ValueError(f"H={x.shape[0]} not divisible by mesh axis {axis}={n}")
        return mesh.split(x)
    x = list(x)
    if len(x) != n or len({b.shape for b in x}) != 1:
        raise ValueError(f"{len(x)} bands of shapes {[tuple(b.shape) for b in x]} "
                         f"for mesh axis {axis}={n}")
    return [b.to(d) for b, d in zip(x, mesh.devices)]


# ---------------------------------------------------------------------------
# Collectives across the band list
# ---------------------------------------------------------------------------


def shift_down(mesh: BandMesh, parts: Sequence[torch.Tensor]) -> Bands:
    """``ppermute`` i → i + 1: band i receives band i − 1's part, band 0
    receives zeros."""
    return [torch.zeros_like(parts[0]).to(mesh.devices[0])] + [
        p.to(d) for p, d in zip(parts[:-1], mesh.devices[1:])]


def shift_up(mesh: BandMesh, parts: Sequence[torch.Tensor]) -> Bands:
    """``ppermute`` i + 1 → i: band i receives band i + 1's part, the last
    band receives zeros."""
    return [p.to(d) for p, d in zip(parts[1:], mesh.devices[:-1])] + [
        torch.zeros_like(parts[-1]).to(mesh.devices[-1])]


def halo_exchange(mesh: BandMesh, bands: Sequence[torch.Tensor], halo: int) -> Bands:
    """Extend each (Hb, ...) band with ``halo`` rows from each neighbour:
    (Hb + 2·halo, ...).  The image's first and last band receive zeros —
    identical to the single-device zero-padded window sums."""
    if halo == 0:
        return list(bands)
    if halo > bands[0].shape[0]:
        raise ValueError(f"halo {halo} exceeds the band height {bands[0].shape[0]}")
    top = shift_down(mesh, [b[-halo:] for b in bands])
    bot = shift_up(mesh, [b[:halo] for b in bands])
    return [torch.cat([t, b, u]) for t, b, u in zip(top, bands, bot)]


def any_band(mesh: BandMesh, flags: Sequence[torch.Tensor]) -> bool:
    """``psum(flag) > 0`` of one 0-d bool per band, read on the host."""
    return bool(torch.stack([f.to(mesh.devices[0]) for f in flags]).any())


def all_gather(mesh: BandMesh, parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """Every band's part stacked, (n, ...), on the first device; what the
    bands compute from it is computed there once and sent back."""
    return torch.stack([p.to(mesh.devices[0]) for p in parts])


# ---------------------------------------------------------------------------
# Rectification
# ---------------------------------------------------------------------------


def remap_row_sharded(
    images: torch.Tensor,
    maps: Union[torch.Tensor, Sequence[torch.Tensor]],
    mesh: BandMesh,
    axis: str = "rows",
) -> Bands:
    """Row-band rectification: ``images`` (S, H_src, W_src[, C]) is the raw
    frame stack, replicated (every band reads any source row it needs);
    ``maps`` (S, H, W, 2), or its bands (S, H/n, W, 2).  Each band runs one
    K1 launch for its destination rows.  Returns the (S, H/n, W[, C])
    bands, bit-identical to the whole-image remap."""
    if isinstance(maps, torch.Tensor):
        n = mesh.shape[axis]
        if maps.shape[1] % n != 0:
            raise ValueError(f"H={maps.shape[1]} not divisible by mesh axis {axis}={n}")
        hb = maps.shape[1] // n
        maps = [maps[:, i * hb:(i + 1) * hb].to(d) for i, d in enumerate(mesh.devices)]
    return [remap_kernel.rectify(img, m) for img, m in zip(mesh.replicate(images), maps)]


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _prefilter_halo(cfg: StereoBMConfig) -> int:
    """Rows the prefilter's stencil reaches above and below a pixel: the
    x-Sobel's 3 × 3, the normalized response's 9 × 9 window
    (ops/stereobm.py)."""
    return 1 if cfg.xsobel else 4


def _prefilter_bands(mesh: BandMesh, bands: Bands, cfg: StereoBMConfig) -> Bands:
    """Each band's prefilter over its rows plus its neighbours' stencil rows;
    at the image's first and last row the prefilter's own edge padding
    applies, as on the whole image."""
    p = _prefilter_halo(cfg)
    n, hb = len(bands), bands[0].shape[0]
    if n > 1 and p > hb:
        raise ValueError(f"prefilter halo {p} exceeds the band height {hb}")
    top = shift_down(mesh, [b[-p:] for b in bands])
    bot = shift_up(mesh, [b[:p] for b in bands])
    out = []
    for i, b in enumerate(bands):
        parts = ([top[i]] if i > 0 else []) + [b] + ([bot[i]] if i < n - 1 else [])
        lo = p if i > 0 else 0
        out.append(bm_ops.prefilter(torch.cat(parts), cfg)[lo:lo + hb])
    return out


def _texture_bands(mesh: BandMesh, lf: Bands, cfg: StereoBMConfig) -> List:
    """``texture_sum`` by band (None per band when the gate is off): the
    window sum of |prefiltered − cap| over halo rows that are zero beyond
    the image, as the whole image's zero-padded sum."""
    if cfg.texture_threshold <= 0:
        return [None] * len(lf)
    r, hb = cfg.block_radius, lf[0].shape[0]
    t_e = halo_exchange(mesh, [(x - cfg.prefilter_cap).abs() for x in lf], r)
    return [bm_ops._box_sum(t, cfg.block_size)[r:r + hb] for t in t_e]


def _matcher_inputs(L: Bands, R: Bands, cfg: StereoBMConfig, mesh: BandMesh, halo: int):
    """(prefiltered left and right bands extended by ``halo``, texture
    bands)."""
    lf = _prefilter_bands(mesh, L, cfg)
    rf = _prefilter_bands(mesh, R, cfg)
    return halo_exchange(mesh, lf, halo), halo_exchange(mesh, rf, halo), _texture_bands(
        mesh, lf, cfg)


def disparity_row_sharded(
    left_rect,
    right_rect,
    cfg: StereoBMConfig,
    mesh: BandMesh,
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
    L, R = _bands(mesh, left_rect, axis), _bands(mesh, right_rect, axis)
    hb, halo = L[0].shape[0], cfg.block_radius
    H = hb * len(L)
    lf_e, rf_e, tex = _matcher_inputs(L, R, cfg, mesh, halo)
    disp_out, valid_out = [], []
    for i in range(len(L)):
        inner = slice(halo, halo + hb)
        raw = [m[inner] for m in stereobm_kernel.fused_raw(lf_e[i], rf_e[i], cfg)]
        disp, valid = stereobm_kernel.fused_gates(*raw, cfg, tex[i], row_offset=i * hb,
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
    mesh: BandMesh,
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
    L, R = _bands(mesh, left_rect, axis), _bands(mesh, right_rect, axis)
    hb = L[0].shape[0]
    H = hb * len(L)
    # a band can only export as many halo rows as it owns
    halo = min(cfg.block_radius + warmup_rows, hb)
    integer_input = not L[0].is_floating_point()
    lf_e, rf_e, tex = _matcher_inputs(L, R, cfg, mesh, halo)
    disp_out, valid_out = [], []
    for i in range(len(L)):
        inner = slice(halo, halo + hb)
        if cfg.lr_check:
            vols = sgm_kernel.sgm_fused_raw(lf_e[i], rf_e[i], cfg, p1, p2, integer_input,
                                            return_volumes=True)
            total = sgm_kernel._masked_total(*(v.permute(1, 2, 0) for v in vols), cfg)
            cost_agg = total.permute(2, 0, 1)[:, inner]
            disp, valid = bm_ops.wta_disparity(cost_agg, None, cfg, tex=tex[i],
                                               row_offset=i * hb, total_rows=H)
            disp_r = bm_ops.right_disparity_from_cost(cost_agg, cfg)
            disp, valid = bm_ops.apply_lr_check(disp, valid, disp_r, cfg)
        else:
            raw = sgm_kernel.sgm_fused_raw(lf_e[i], rf_e[i], cfg, p1, p2, integer_input)
            disp, valid = stereobm_kernel.fused_gates(*(m[inner] for m in raw), cfg, tex[i],
                                                      row_offset=i * hb, total_rows=H)
        disp_out.append(disp)
        valid_out.append(valid)
    return disp_out, valid_out


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
    mesh: BandMesh,
    *,
    max_speckle_size: int,
    max_diff: float,
    merge_rounds: int = 0,
) -> List[Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Everything of :func:`filter_speckles_row_sharded` before K7: per band
    (field, conn_x, conn_y) — the band-local component sizes (capped at
    ``max_speckle_size + 1``) raised at the boundary rows to the reconciled
    totals of the components that cross the band's edges, and the
    band-local link masks.  With one band the field is the band's sizes."""
    n, (hb, W) = len(disp), disp[0].shape
    H = n * hb
    sentinel = H * W
    cap = max_speckle_size + 1
    max_merge = merge_rounds if merge_rounds > 0 else 4 * n + 8
    conn = [speckle_ops._connectivity(d, v, max_diff) for d, v in zip(disp, valid)]

    # cross-boundary connectivity (disp/valid of the adjacent rows)
    prev_d = shift_down(mesh, [d[-1] for d in disp])
    prev_v = shift_down(mesh, [v[-1] for v in valid])
    next_d = shift_up(mesh, [d[0] for d in disp])
    next_v = shift_up(mesh, [v[0] for v in valid])
    conn_top = [v[0] & pv & ((d[0] - pd).abs() <= max_diff)
                for d, v, pd, pv in zip(disp, valid, prev_d, prev_v)]
    conn_bot = [v[-1] & nv & ((d[-1] - nd).abs() <= max_diff)
                for d, v, nd, nv in zip(disp, valid, next_d, next_v)]

    def pixels(i, dev):
        return (i * hb * W + torch.arange(hb * W, dtype=torch.int32, device=dev)).reshape(hb, W)

    fill = [torch.full((), sentinel, dtype=torch.int32, device=v.device) for v in valid]
    lab = [torch.where(v, pixels(i, v.device), s) for i, (v, s) in enumerate(zip(valid, fill))]

    def merge(lab):
        # boundary rows connected across a band edge take the smaller label
        prev_lab = shift_down(mesh, [x[-1] for x in lab])
        next_lab = shift_up(mesh, [x[0] for x in lab])
        for i, x in enumerate(lab):
            pl = torch.where(prev_v[i], prev_lab[i], fill[i])
            nl = torch.where(next_v[i], next_lab[i], fill[i])
            top = torch.where(conn_top[i], torch.minimum(x[0], pl), x[0])
            bot = torch.where(conn_bot[i], torch.minimum(x[-1], nl), x[-1])
            x[0] = top
            x[-1] = bot
        return lab

    # label propagation to global convergence (or max_merge rounds): each
    # round is 2 band-local label rounds, then the boundary merge; monotone,
    # so an unchanged round is the fixed point and the loop stops there
    for _ in range(max_merge):
        new = [speckle_kernel.band_labels(x, cx, cy, 2) for x, (cx, cy) in zip(lab, conn)]
        if n > 1:
            new = merge(new)
        changed = any_band(mesh, [(a != b).any() for a, b in zip(new, lab)])
        lab = new
        if not changed:
            break
    lab = [torch.where(v, x, s) for v, x, s in zip(valid, lab, fill)]
    cnt = [_band_counts(x, sentinel, cap) for x in lab]
    if n == 1:
        return [(cnt[0],) + conn[0]]

    # reconciliation over boundary rows only: (n, 2, W) records
    rec_lab = all_gather(mesh, [torch.stack([x[0], x[-1]]) for x in lab])
    rec_cnt = all_gather(mesh, [torch.stack([c[0], c[-1]]) for c in cnt])
    btot = _reconcile(rec_lab, rec_cnt, sentinel, cap)
    out = []
    for i, c in enumerate(cnt):
        mine = btot[i].to(c.device)
        field = c.clone()
        field[0] = torch.maximum(c[0], mine[0])
        field[-1] = torch.maximum(field[-1], mine[1])
        out.append((field,) + conn[i])
    return out


def filter_speckles_row_sharded(
    disp,
    valid,
    mesh: BandMesh,
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
         band changes, or ``4n + 8`` rounds (``merge_rounds`` when > 0);
      3. band-local sizes capped at ``max_speckle_size + 1``, reconciled
         across bands through the (n, 2, W) boundary records;
      4. K7: the reconciled totals, raised at the boundary rows, are
         max-propagated through each band (``iters = 4·H/n`` rounds) — with
         one band the local sizes are final and K7 does not run.

    ``iters`` is accepted and not read, as in the JAX version: the label
    rounds are a fixed 2 per merge round.  Returns the (filtered disparity,
    keep) bands."""
    D = _bands(mesh, disp, axis)
    V = _bands(mesh, valid, axis)
    fields = speckle_size_fields(D, V, mesh, max_speckle_size=max_speckle_size,
                                 max_diff=max_diff, merge_rounds=merge_rounds)
    disp_out, keep_out = [], []
    for d, v, (field, cx, cy) in zip(D, V, fields):
        sizes = field if len(D) == 1 else speckle_kernel.max_propagate(
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
    mesh: BandMesh,
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
    D = _bands(mesh, disp, axis)
    G = _bands(mesh, guide, axis)
    hb, W = D[0].shape
    H = hb * len(D)
    halo = min(2 * iters * radius, hb)
    d_e = halo_exchange(mesh, [d.float() for d in D], halo)
    g_e = halo_exchange(mesh, [g.float() for g in G], halo)
    v_e = halo_exchange(mesh, [torch.ones((hb, W), dtype=torch.float32, device=d.device)
                               for d in D], halo)
    out = []
    for i, (d, g, v) in enumerate(zip(d_e, g_e, v_e)):
        r = bilateral_ops._bilateral_core(
            d, g, v, ndisp=ndisp, radius=radius, iters=iters,
            edge_threshold=edge_threshold, max_disc_threshold=max_disc_threshold,
            sigma_range=sigma_range, row_offset=i * hb - halo, total_rows=H)
        out.append(r[halo:halo + hb].to(D[i].dtype))
    return out
