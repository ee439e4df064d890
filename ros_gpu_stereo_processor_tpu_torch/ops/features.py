"""Feature detection, description and matching — the sparse frontend, in PyTorch.

The port of ``ros_gpu_stereo_processor_tpu/ops/features.py`` (no Pallas
kernel there; plain torch here, on the device of its inputs):

  * **FAST-9** corner test from the 16 circle taps (one gather) and a
    bit-mask doubling trick for the contiguous-arc test;
  * 3×3 non-max suppression by max-pool comparison, and a 16-pixel margin;
  * fixed-capacity keypoint sets: the K best scores in a STABLE descending
    order (larger score first, then the lower flat index) — the order of
    ``jax.lax.top_k``, which ``torch.topk`` does not promise on ties;
  * rotation-steered binary descriptors (BRIEF-style 256-pair pattern with
    ORB's intensity-centroid orientation), 16 steering bins;
  * brute-force Hamming matching with mutual-nearest + ratio gating.

Descriptors are (K, 8) **int32** words whose bit patterns equal the JAX
package's uint32 words (``.numpy().view(np.uint32)`` gives them back):
PyTorch has no shifts on uint32, so packing, popcount and the signature
work in int64.  Every function takes leading batch dims where the JAX
version is ``vmap``-ped (``match_desc``, ``descriptor_signature``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ros_gpu_stereo_processor_tpu_torch.utils.division import div_const

# FAST circle of radius 3 (Bresenham), (dy, dx) pairs in ring order
_CIRCLE = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    np.int32,
)
_MARGIN = 16


class Keypoints(NamedTuple):
    """Fixed-capacity keypoint set (static shapes; ``valid`` gates slots)."""

    xy: torch.Tensor       # (K, 2) float32 (x, y)
    score: torch.Tensor    # (K,) float32
    angle: torch.Tensor    # (K,) float32 radians
    desc: torch.Tensor     # (K, 8) int32: the bits of the packed uint32 words
    valid: torch.Tensor    # (K,) bool


def _circle_taps(x: torch.Tensor) -> torch.Tensor:
    """(16, H, W): the image shifted by each circle offset, edges replicated
    (border pixels never become corners — the margin masks them)."""
    H, W = x.shape
    dev = x.device
    dy = torch.from_numpy(_CIRCLE[:, 0].astype(np.int64)).to(dev)[:, None, None]
    dx = torch.from_numpy(_CIRCLE[:, 1].astype(np.int64)).to(dev)[:, None, None]
    ys = (torch.arange(H, device=dev)[None, :, None] + dy).clamp(0, H - 1)
    xs = (torch.arange(W, device=dev)[None, None, :] + dx).clamp(0, W - 1)
    return x.reshape(-1)[ys * W + xs]


def _rot16(m: torch.Tensor, k: int) -> torch.Tensor:
    return ((m << k) | (m >> (16 - k))) & 0xFFFF


def _has_arc9(mask16: torch.Tensor) -> torch.Tensor:
    """True where the 16-bit circle mask (int32) contains ≥9 contiguous set
    bits (wrap-around) — doubling AND-reduction."""
    a = mask16 & _rot16(mask16, 1)      # runs of ≥2
    a = a & _rot16(a, 2)                # ≥4
    a = a & _rot16(a, 4)                # ≥8
    a = a & _rot16(mask16, 8)           # ≥9
    return a > 0


def fast_score_map(img: torch.Tensor, threshold: float = 20.0) -> torch.Tensor:
    """FAST-9 corner response: 0 where not a corner, else a contrast score
    (sum of circle |differences| beyond the threshold)."""
    x = img.to(torch.float32)
    H, W = x.shape
    db = _circle_taps(x) - x                                   # (16, H, W)
    is_b = db > threshold
    is_d = -db > threshold
    weight = (1 << torch.arange(16, dtype=torch.int32, device=x.device))[:, None, None]
    bright = (is_b.to(torch.int32) * weight).sum(0, dtype=torch.int32)
    dark = (is_d.to(torch.int32) * weight).sum(0, dtype=torch.int32)
    tb = torch.where(is_b, db - threshold, 0.0)
    td = torch.where(is_d, -db - threshold, 0.0)
    # the JAX order of the float sums: tap 0 first, one tap at a time
    s_bright = torch.zeros_like(x)
    s_dark = torch.zeros_like(x)
    for i in range(16):
        s_bright = s_bright + tb[i]
        s_dark = s_dark + td[i]

    corner = _has_arc9(bright) | _has_arc9(dark)
    score = torch.maximum(s_bright, s_dark)

    # 3×3 non-max suppression (−inf padding) + border mask (patch radius 15)
    nb = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    row = torch.arange(H, device=x.device)[:, None]
    col = torch.arange(W, device=x.device)[None, :]
    inb = ((row >= _MARGIN) & (row < H - _MARGIN)
           & (col >= _MARGIN) & (col < W - _MARGIN))
    return torch.where(corner & (score >= nb) & inb, score, 0.0)


def select_keypoints(score_map: torch.Tensor, k: int = 512):
    """Top-K corner slots: returns (xy (K,2) f32, score (K,), valid (K,)).

    The K largest scores, larger first and, among equal scores, the lower
    flat index first (``jax.lax.top_k``'s order).  Scores are ≥ 0, so their
    float32 bit patterns order as the values do: one ``topk`` over the
    unique int64 keys ``bits · 2^b + (2^b − 1 − index)`` gives that order
    on any device."""
    H, W = score_map.shape
    flat = score_map.reshape(-1)
    n = flat.numel()
    b = max(1, int(n - 1).bit_length())
    idx_all = torch.arange(n, device=flat.device, dtype=torch.int64)
    key = (flat.view(torch.int32).to(torch.int64) << b) | ((1 << b) - 1 - idx_all)
    _, order = torch.topk(key, k)
    vals = flat[order]
    ys = torch.div(order, W, rounding_mode="floor").to(torch.float32)
    xs = (order % W).to(torch.float32)
    return torch.stack([xs, ys], -1), vals, vals > 0.0


# ---------------------------------------------------------------------------
# Orientation + descriptors (patch-based)
#
#   1. one 32×32 patch per keypoint (keypoints are integer pixels, so the
#      patch is an exact gather);
#   2. orientation moments: the patch against static coordinate masks;
#   3. descriptor steering quantised to 16 angle bins; each bin's rotated
#      sampling positions are static indices into the flattened patch.
# ---------------------------------------------------------------------------

_PATCH_R = 15
_PATCH = 2 * _PATCH_R + 2            # 32
_NBINS = 16                          # steering quantisation (22.5°)


def _pattern(seed: int = 7, n: int = 256) -> np.ndarray:
    """(n, 4) sampling offsets (x1, y1, x2, y2), Gaussian-distributed, with
    norm ≤ _PATCH_R − 1 so every rotation stays inside the patch."""
    rng = np.random.default_rng(seed)
    p = rng.normal(0.0, _PATCH_R / 2.5, size=(n, 4))
    for sl in (slice(0, 2), slice(2, 4)):
        v = p[:, sl]
        norm = np.linalg.norm(v, axis=1, keepdims=True)
        scale = np.minimum(1.0, (_PATCH_R - 1.0) / np.maximum(norm, 1e-9))
        p[:, sl] = v * scale
    return p.astype(np.float32)


_PATTERN = _pattern()


def _binned_indices() -> np.ndarray:
    """(NBINS, 2, 256) static flattened-patch indices of the rotated pattern
    taps for each quantised steering angle."""
    out = np.zeros((_NBINS, 2, _PATTERN.shape[0]), np.int32)
    c = _PATCH_R + 0  # patch centre offset (patch[15,15] is the keypoint)
    for b in range(_NBINS):
        a = 2.0 * np.pi * b / _NBINS
        ca, sa = np.cos(a), np.sin(a)
        for t, sl in enumerate((slice(0, 2), slice(2, 4))):
            px, py = _PATTERN[:, sl][:, 0], _PATTERN[:, sl][:, 1]
            rx = np.clip(np.round(px * ca - py * sa) + c, 0, _PATCH - 1)
            ry = np.clip(np.round(px * sa + py * ca) + c, 0, _PATCH - 1)
            out[b, t] = (ry * _PATCH + rx).astype(np.int32)
    return out


_BIN_IDX = _binned_indices()


def _moment_masks() -> tuple[np.ndarray, np.ndarray]:
    ys, xs = np.mgrid[0:_PATCH, 0:_PATCH].astype(np.float32)
    dx = xs - _PATCH_R
    dy = ys - _PATCH_R
    circ = (dx * dx + dy * dy <= _PATCH_R * _PATCH_R).astype(np.float32)
    return circ * dx, circ * dy


_MASK_X, _MASK_Y = _moment_masks()


def extract_patches(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """(K, 32, 32) float32 patches centred on integer keypoints (clamped)."""
    H, W = img.shape
    imf = img.to(torch.float32)
    y0 = (torch.round(xy[:, 1]).to(torch.int64) - _PATCH_R).clamp(0, H - _PATCH)
    x0 = (torch.round(xy[:, 0]).to(torch.int64) - _PATCH_R).clamp(0, W - _PATCH)
    r = torch.arange(_PATCH, device=img.device)
    idx = (y0[:, None, None] + r[None, :, None]) * W + x0[:, None, None] + r[None, None, :]
    return imf.reshape(-1)[idx]


def orientations_from_patches(patches: torch.Tensor) -> torch.Tensor:
    """ORB intensity-centroid angle.  On integer images every moment is an
    integer below 2^24, so the float32 sums are exact in any order."""
    mx = torch.from_numpy(_MASK_X).to(patches.device)
    my = torch.from_numpy(_MASK_Y).to(patches.device)
    m10 = (patches * mx).sum((-2, -1))
    m01 = (patches * my).sum((-2, -1))
    return torch.atan2(m01, m10)


def _steering_bins(angle: torch.Tensor) -> torch.Tensor:
    """round(mod(angle, 2π) / 2π · 16) mod 16, in float32 as the JAX
    package's compiled code computes it (the division by 2π as a multiply
    by its float32 reciprocal, utils/division.py; a one-ulp change can
    move a bin)."""
    two_pi = torch.full((), 2.0 * np.pi, dtype=torch.float32, device=angle.device)
    frac = div_const(torch.remainder(angle, two_pi), 2.0 * np.pi)
    return torch.round(frac * _NBINS).to(torch.int64) % _NBINS


def _pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(…, 256) 0/1 → (…, 8) int32 words, bit j of word w = bit 32·w + j."""
    shifts = torch.arange(32, device=bits.device, dtype=torch.int64)
    words = (bits.to(torch.int64).reshape(*bits.shape[:-1], 8, 32) << shifts).sum(-1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def describe_from_patches(patches: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Quantised-steering 256-bit descriptors, packed (K, 8) int32."""
    K = patches.shape[0]
    flat = patches.reshape(K, -1)                            # (K, 1024)
    bins = _steering_bins(angle)                             # (K,)
    idx = torch.from_numpy(_BIN_IDX.astype(np.int64)).to(patches.device)
    # the taps of the keypoint's own bin: (K, 256) each
    i1 = idx[bins, 0]
    i2 = idx[bins, 1]
    bits = flat.gather(1, i1) < flat.gather(1, i2)
    return _pack_bits(bits)


def orientations(img: torch.Tensor, xy: torch.Tensor) -> torch.Tensor:
    """ORB intensity-centroid angle per keypoint (patch formulation)."""
    return orientations_from_patches(extract_patches(img, xy))


def describe(img: torch.Tensor, xy: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    """Rotation-steered binary descriptors (quantised steering)."""
    return describe_from_patches(extract_patches(img, xy), angle)


def detect_and_describe(img: torch.Tensor, k: int = 512,
                        threshold: float = 20.0) -> Keypoints:
    """Full sparse frontend for one image: FAST-9 → NMS → top-K → orientation
    → steered binary descriptors."""
    score = fast_score_map(img, threshold)
    xy, s, valid = select_keypoints(score, k)
    patches = extract_patches(img, xy)
    ang = orientations_from_patches(patches)
    desc = describe_from_patches(patches, ang)
    return Keypoints(xy=xy, score=s, angle=ang, desc=desc, valid=valid)


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Set bits of each 32-bit word (int32 bit patterns), in int64."""
    x = x.to(torch.int64) & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) >> 24) & 0xFF


def hamming_matrix(da: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(…, Ka, 8) × (…, Kb, 8) int32 words → (…, Ka, Kb) int32 Hamming
    distances."""
    x = da[..., :, None, :] ^ db[..., None, :, :]
    return _popcount32(x).sum(-1).to(torch.int32)


def match_desc(
    desc_a: torch.Tensor,
    valid_a: torch.Tensor,
    desc_b: torch.Tensor,
    valid_b: torch.Tensor,
    max_distance: int = 64,
    ratio: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Descriptor-level mutual-nearest matching (the core of :func:`match`;
    leading dims are a batch of pairs — loop closure's candidate batch in
    one call).  Returns (idx_b (…, Ka) — the match in b for each a-slot, −1
    if none; ok (…, Ka) bool)."""
    BIG = 10_000
    d = hamming_matrix(desc_a, desc_b)
    d = torch.where(valid_a[..., :, None] & valid_b[..., None, :], d, BIG)

    dist1, best_b = torch.min(d, dim=-1)
    # second best for the ratio test
    d2 = d.scatter(-1, best_b[..., None], BIG)
    dist2 = torch.min(d2, dim=-1).values
    # mutual check
    best_a_of_b = torch.argmin(d, dim=-2)
    arange_a = torch.arange(d.shape[-2], device=d.device)
    mutual = best_a_of_b.gather(-1, best_b) == arange_a

    ok = (
        (dist1 <= max_distance)
        & (dist1.to(torch.float32) <= ratio * dist2.to(torch.float32))
        & mutual
        & valid_a
    )
    return torch.where(ok, best_b, -1).to(torch.int32), ok


def match(
    kp_a: Keypoints,
    kp_b: Keypoints,
    max_distance: int = 64,
    ratio: float = 0.9,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Mutual-nearest Hamming matching with Lowe ratio test.

    Returns (idx_b (Ka,) int32 — match in b for each a-slot, −1 if none;
    valid (Ka,) bool)."""
    return match_desc(kp_a.desc, kp_a.valid, kp_b.desc, kp_b.valid,
                      max_distance=max_distance, ratio=ratio)


def descriptor_signature(desc: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """(…, K, 8) packed descriptors + (…, K) validity → (…, 256)
    L2-normalised bit-frequency signature — a compact whole-image
    appearance vector (loop-closure candidate scoring)."""
    shifts = torch.arange(32, device=desc.device, dtype=torch.int64)
    words = desc.to(torch.int64) & 0xFFFFFFFF
    bits = ((words[..., None] >> shifts) & 1).to(torch.float32)
    bits = bits.reshape(*desc.shape[:-2], desc.shape[-2], 256)
    w = valid.to(torch.float32)
    sig = torch.sum(bits * w[..., None], dim=-2) / torch.clamp(
        torch.sum(w, dim=-1, keepdim=True), min=1.0)
    sig = sig - torch.mean(sig, dim=-1, keepdim=True)
    return sig / torch.clamp(torch.linalg.norm(sig, dim=-1, keepdim=True), min=1e-9)
