"""Speckle removal — connected-component labels and sizes on the device.

The port of ``ros_gpu_stereo_processor_tpu/ops/speckle.py``.  The reference's
speckle filter is a CPU flood fill that round-trips the disparity through the
host (src/GPUStereoProcessor.cpp:356-385); here it stays on the device.
Speckles are 4-connected components of valid pixels whose neighbours differ
by at most ``max_diff``, with at most ``max_speckle_size`` pixels.

Labels: each pixel's label is the minimum raster index of its component,
found by ``iters`` alternating row/column passes, each of which gives every
run of connected pixels the minimum of the run (:func:`_labels_scan`, the
plain version of the label kernel in ops/speckle_kernel.py).  Sizes: the
exact ``bincount(lab)[lab] > T`` decision and the fill (:func:`_sizing`, the
plain version of the sizing kernel in ops/speckle_kernel.py), counted with
``index_add_`` into a preallocated int64 buffer (no host read-back).
"""

from __future__ import annotations

import torch


def _shift(x: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """Shift a 2-D tensor by (dy, dx), filling vacated cells."""
    H, W = x.shape
    out = torch.full_like(x, fill)
    ys = slice(max(dy, 0), H + min(dy, 0))
    xs = slice(max(dx, 0), W + min(dx, 0))
    ys_src = slice(max(-dy, 0), H + min(-dy, 0))
    xs_src = slice(max(-dx, 0), W + min(-dx, 0))
    out[ys, xs] = x[ys_src, xs_src]
    return out


def _segmented_min_scan(lab: torch.Tensor, conn: torch.Tensor, axis: int) -> torch.Tensor:
    """Full-segment min along ``axis``, segments delimited where ``conn`` is
    False (``conn[i]`` = element i connected to element i−1; conn[0]=False).

    Hillis–Steele doubling, forward then backward, as the JAX twin: every
    element of a run ends with the run's minimum."""
    n = lab.shape[axis]
    sentinel = torch.iinfo(lab.dtype).max

    def sh(x, off, fill):
        if axis == 1:
            return _shift(x, 0, off, fill)
        return _shift(x, off, 0, fill)

    # forward: lab[i] ← min over its run-prefix
    f_lab, f_conn = lab, conn
    off = 1
    while off < n:
        f_lab = torch.where(f_conn, torch.minimum(f_lab, sh(f_lab, off, sentinel)), f_lab)
        f_conn = f_conn & sh(f_conn, off, False)
        off <<= 1
    # backward: propagate each run's final prefix-min back across the run.
    # conn_next[i] = conn[i+1]  (element i connected to element i+1)
    conn_next = sh(conn, -1, False)
    b_lab, b_conn = f_lab, conn_next
    off = 1
    while off < n:
        b_lab = torch.where(b_conn, torch.minimum(b_lab, sh(b_lab, -off, sentinel)), b_lab)
        b_conn = b_conn & sh(b_conn, -off, False)
        off <<= 1
    return b_lab


def _connectivity(disp: torch.Tensor, valid: torch.Tensor, max_diff: float):
    """(conn_x, conn_y): pixel connected to its left / upper neighbour."""
    left_d = _shift(disp, 0, 1, float("inf"))
    left_v = _shift(valid, 0, 1, False)
    conn_x = valid & left_v & ((disp - left_d).abs() <= max_diff)
    up_d = _shift(disp, 1, 0, float("inf"))
    up_v = _shift(valid, 1, 0, False)
    conn_y = valid & up_v & ((disp - up_d).abs() <= max_diff)
    return conn_x, conn_y


def _labels_scan(
    disp: torch.Tensor, valid: torch.Tensor, max_diff: float, iters: int
) -> torch.Tensor:
    """Component labels via ``iters`` alternating row/column segmented
    min-scans (int32; H·W for invalid pixels)."""
    H, W = disp.shape
    n = H * W
    idx = torch.arange(n, dtype=torch.int32, device=disp.device).reshape(H, W)
    sentinel = torch.full((), n, dtype=torch.int32, device=disp.device)
    lab = torch.where(valid, idx, sentinel)
    conn_x, conn_y = _connectivity(disp, valid, max_diff)
    for _ in range(iters):
        lab = _segmented_min_scan(lab, conn_x, axis=1)
        lab = _segmented_min_scan(lab, conn_y, axis=0)
    return torch.where(valid, lab, sentinel)


def _label_rounds(lab: torch.Tensor, conn_x: torch.Tensor, conn_y: torch.Tensor,
                  rounds: int, done: torch.Tensor | None = None) -> torch.Tensor:
    """``rounds`` row/column segmented min-scans of a given label field —
    the band-local label rounds of the row-sharded speckle filter
    (parallel/frontend.py), plain version of ``speckle_kernel.band_labels``.
    A nonzero ``done`` (0-d) gives a copy of ``lab``: read here in Python,
    where the kernel reads it on the device."""
    if done is not None and bool(done):
        return lab.clone()
    for _ in range(rounds):
        lab = _segmented_min_scan(lab, conn_x, axis=1)
        lab = _segmented_min_scan(lab, conn_y, axis=0)
    return lab


def _max_propagate(field: torch.Tensor, conn_x: torch.Tensor, conn_y: torch.Tensor,
                   iters: int) -> torch.Tensor:
    """Max-propagate an int32 ``field`` across the runs of ``conn_x``
    (rows) and ``conn_y`` (columns): alternating row/column segmented max
    sweeps (min-scans of the negated field, as the JAX twin) until a round
    changes nothing or ``iters`` rounds have run.  Monotone, so stopping at
    an unchanged round is exact.  Plain version of
    ``speckle_kernel.max_propagate`` (K7)."""
    neg = -field
    for _ in range(iters):
        new = _segmented_min_scan(neg, conn_x, axis=1)
        new = _segmented_min_scan(new, conn_y, axis=0)
        changed = bool((new < neg).any())
        neg = new
        if not changed:
            break
    return -neg


def _keep_large_components(lab: torch.Tensor, max_speckle_size: int) -> torch.Tensor:
    """keep[p] ⇔ (# pixels sharing p's label) > max_speckle_size — the exact
    ``bincount(lab)[lab] > T`` for any label image, converged or not.
    Counts go into an int64 buffer of n + 1 slots (labels lie in [0, n]),
    so nothing is read back to the host (``torch.bincount`` on a CUDA tensor
    reads ``max()`` back) and nothing overflows.  ``T >= n`` keeps nothing,
    as no count can exceed n."""
    n = lab.numel()
    flat = lab.reshape(-1).long()
    counts = torch.zeros(n + 1, dtype=torch.int64, device=lab.device)
    counts.index_add_(0, flat, torch.ones_like(flat))
    return (counts[flat] > int(max_speckle_size)).reshape(lab.shape)


def _sizing(disp: torch.Tensor, valid: torch.Tensor, lab: torch.Tensor,
            max_speckle_size: int, fill_value: float) -> tuple[torch.Tensor, torch.Tensor]:
    """(disparity with the pixels of components of at most
    ``max_speckle_size`` pixels set to ``fill_value``, their validity) from
    the labels ``lab`` — plain version of ``speckle_kernel.sizing``."""
    keep = _keep_large_components(lab, max_speckle_size) & valid
    fill = torch.full((), float(fill_value), device=disp.device)
    return torch.where(keep, disp, fill), keep


def filter_speckles(
    disp: torch.Tensor,
    valid: torch.Tensor,
    max_speckle_size: int = 800,
    max_diff: float = 5.0,
    iters: int = 16,
    fill_value: float = -1.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Invalidate small connected components of similar disparity.

    Args:
      disp: (H, W) float32 disparity.
      valid: (H, W) bool validity mask.
      max_speckle_size: components with ≤ this many pixels are removed
        (OpenCV convention).
      max_diff: neighbouring pixels join a component iff |Δd| ≤ max_diff.
      iters: label-propagation iterations (row + column pass pairs).

    The labels come from ops/speckle_kernel.labels and the sizes from
    ops/speckle_kernel.sizing: the kernels for a CUDA tensor,
    :func:`_labels_scan` and :func:`_sizing` for a CPU tensor.

    Returns (filtered disparity with removed pixels set to ``fill_value``,
    updated valid mask).
    """
    # imported here: speckle_kernel imports this module for the plain version
    from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel

    lab = speckle_kernel.labels(disp, valid, max_diff, iters)
    return speckle_kernel.sizing(disp, valid, lab, max_speckle_size, fill_value)
