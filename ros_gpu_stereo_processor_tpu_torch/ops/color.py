"""Color / encoding conversion ops (debayer, gray, channel order, bit depth).

The PyTorch port of ``ros_gpu_stereo_processor_tpu/ops/color.py``, the
replacement for the reference's encoding-driven converter
(src/GPUStereoProcessor.cpp:65-88,119-172):

  * bilinear debayer for the four Bayer phases (masked 3×3 weighted sums,
    normalised by the sum of the mask under the same weights),
  * RGB↔BGR channel swap, gray↔color replication,
  * color→gray with BT.601 weights, rounded half to even,
  * 8↔16-bit rescale with the reference's 65535/255 scale factor
    (src/GPUStereoProcessor.cpp:154-158).

Each function is the same sequence of float32 operations as its JAX twin, so
integer results agree exactly.  The debayer's 3×3 sums are nine shifted-slice
multiply-adds over a zero-padded tensor rather than a convolution: every term
is a small integer, exact in float32, and the quotient is one IEEE division,
so the result is exact on every device (a cuDNN convolution may round uint16
input through TF32).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class Encoding:
    name: str
    channels: int
    bit_depth: int
    is_bayer: bool = False
    # For bayer: 2x2 pattern of channel indices (0=R,1=G,2=B) at (0,0),(0,1),(1,0),(1,1)
    bayer_pattern: Tuple[int, ...] = ()
    # For color: order of channels as (R,G,B[,A]) positions; e.g. bgr8 -> (2,1,0)
    channel_order: Tuple[int, ...] = ()


ENCODINGS: Dict[str, Encoding] = {
    "mono8": Encoding("mono8", 1, 8),
    "mono16": Encoding("mono16", 1, 16),
    "rgb8": Encoding("rgb8", 3, 8, channel_order=(0, 1, 2)),
    "bgr8": Encoding("bgr8", 3, 8, channel_order=(2, 1, 0)),
    "rgba8": Encoding("rgba8", 4, 8, channel_order=(0, 1, 2, 3)),
    "bgra8": Encoding("bgra8", 4, 8, channel_order=(2, 1, 0, 3)),
    # ROS bayer encoding names state the 2x2 phase at the image origin:
    # bayer_rggb8 → row0 = R G, row1 = G B.
    "bayer_rggb8": Encoding("bayer_rggb8", 1, 8, is_bayer=True, bayer_pattern=(0, 1, 1, 2)),
    "bayer_bggr8": Encoding("bayer_bggr8", 1, 8, is_bayer=True, bayer_pattern=(2, 1, 1, 0)),
    "bayer_gbrg8": Encoding("bayer_gbrg8", 1, 8, is_bayer=True, bayer_pattern=(1, 2, 0, 1)),
    "bayer_grbg8": Encoding("bayer_grbg8", 1, 8, is_bayer=True, bayer_pattern=(1, 0, 2, 1)),
}


def encoding(name: str) -> Encoding:
    try:
        return ENCODINGS[name]
    except KeyError:
        raise ValueError(f"unsupported encoding {name!r}") from None


def bytes_per_pixel(name: str) -> int:
    e = encoding(name)
    return e.channels * (e.bit_depth // 8)


# ---------------------------------------------------------------------------
# Primitive conversions
# ---------------------------------------------------------------------------


def rgb_to_gray_u8(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma for uint8: round(0.299·R + 0.587·G + 0.114·B)."""
    r = rgb[..., 0].float()
    g = rgb[..., 1].float()
    b = rgb[..., 2].float()
    y = 0.299 * r + 0.587 * g + 0.114 * b
    return torch.clamp(torch.round(y), 0, 255).to(torch.uint8)


def rgb_to_gray_f32(rgb: torch.Tensor) -> torch.Tensor:
    """BT.601 luma in float32, rounded as the JAX twin's 3-term dot product
    is: a chain of fused multiply-adds, ((R·wr) + G·wg) + B·wb with one
    rounding per step.  The float64 steps reproduce each fused step (the
    product of two float32 values is exact in float64)."""
    x = rgb.double()
    w = torch.tensor([0.299, 0.587, 0.114], dtype=torch.float32).double()
    acc = (x[..., 0] * w[0]).float()
    acc = (x[..., 1] * w[1] + acc.double()).float()
    return (x[..., 2] * w[2] + acc.double()).float()


def gray_to_rgb(gray: torch.Tensor) -> torch.Tensor:
    return gray[..., None].expand(gray.shape + (3,))


def rescale_depth(img: torch.Tensor, src_bits: int, dst_bits: int) -> torch.Tensor:
    """8↔16-bit rescale with the reference's 65535/255 (= 257) factor."""
    if src_bits == dst_bits:
        return img
    if src_bits == 8 and dst_bits == 16:
        return img.to(torch.uint16) * 257
    if src_bits == 16 and dst_bits == 8:
        return (img.float() * (255.0 / 65535.0) + 0.5).to(torch.uint8)
    raise ValueError(f"unsupported bit depth conversion {src_bits}->{dst_bits}")


# ---------------------------------------------------------------------------
# Debayer (bilinear, masked weighted sums)
# ---------------------------------------------------------------------------


_K_RB = ((1, 2, 1), (2, 4, 2), (1, 2, 1))
_K_G = ((0, 1, 0), (1, 4, 1), (0, 1, 0))


def _bayer_masks(pattern: Tuple[int, ...], height: int, width: int,
                 device=None) -> torch.Tensor:
    """(3, H, W) float32 masks: which pixels sample R/G/B under this phase."""
    masks = torch.zeros((3, height, width), dtype=torch.float32, device=device)
    for dy in range(2):
        for dx in range(2):
            masks[pattern[dy * 2 + dx], dy::2, dx::2] = 1.0
    return masks


def _sum3x3(x: torch.Tensor, k) -> torch.Tensor:
    """'Same' 3×3 weighted sum of a (..., H, W) float32 tensor, zeros outside:
    the nonzero taps of ``k`` as shifted slices (scaled where the weight is
    not 1), added in row-major order."""
    H, W = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (1, 1, 1, 1))
    out = None
    for i in range(3):
        for j in range(3):
            if k[i][j] == 0:
                continue
            term = xp[..., i:i + H, j:j + W]
            if k[i][j] != 1:
                term = term * float(k[i][j])
            out = term if out is None else out + term
    return out


@functools.lru_cache(maxsize=16)
def _bayer_weights(pattern: Tuple[int, ...], height: int, width: int,
                   device: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The (3, H, W) masks of a phase and their 3×3 sums under each channel's
    kernel (the denominators); they depend only on the phase, the shape and
    the device, so they are made once per (pattern, H, W, device)."""
    masks = _bayer_masks(pattern, height, width, device)
    den = torch.stack([_sum3x3(masks[0], _K_RB), _sum3x3(masks[1], _K_G),
                       _sum3x3(masks[2], _K_RB)])
    return masks, den


def debayer_bilinear(raw: torch.Tensor, pattern: Tuple[int, ...]) -> torch.Tensor:
    """Bilinear demosaic: (..., H, W) Bayer mosaic → (..., H, W, 3) RGB.

    Each channel is the weighted sum of its samples under the 3×3 kernel
    divided by the sum of the mask under the same kernel (the per-channel
    weighted average of the available samples; border pixels use the
    renormalised partial kernel).  uint8/uint16 input is rounded (+0.5,
    clipped, truncated) back to its dtype; float input stays float32.
    R and B share their kernel, so their sums run as one (..., 2, H, W)
    pass."""
    H, W = raw.shape[-2:]
    masks, den = _bayer_weights(tuple(pattern), H, W, raw.device)
    samples = raw.float().unsqueeze(-3) * masks              # (..., 3, H, W)
    num_rb = _sum3x3(samples[..., 0::2, :, :], _K_RB)
    num_g = _sum3x3(samples[..., 1:2, :, :], _K_G)
    num = torch.cat([num_rb[..., :1, :, :], num_g, num_rb[..., 1:, :, :]], dim=-3)
    rgb = num / den                # tensor by tensor: one IEEE division
    if raw.dtype == torch.uint8:
        rgb = torch.clamp(rgb + 0.5, 0, 255).to(torch.uint8)
    elif raw.dtype == torch.uint16:
        rgb = torch.clamp(rgb + 0.5, 0, 65535).to(torch.uint16)
    return rgb.movedim(-3, -1).contiguous()


# ---------------------------------------------------------------------------
# General conversion entry point
# ---------------------------------------------------------------------------


def _to_canonical_rgb(img: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """Convert any supported encoding to (..., 3) uint8/uint16 RGB."""
    if enc.is_bayer:
        return debayer_bilinear(img, enc.bayer_pattern)
    if enc.channels == 1:
        return gray_to_rgb(img)
    # channel_order maps channel-position -> color; invert to color -> position
    pos_of_color = {color: pos for pos, color in enumerate(enc.channel_order)}
    return torch.stack([img[..., pos_of_color[c]] for c in range(3)], dim=-1)


def _from_canonical_rgb(rgb: torch.Tensor, enc: Encoding) -> torch.Tensor:
    if enc.channels == 1:
        if enc.bit_depth == 8 and rgb.dtype == torch.uint8:
            return rgb_to_gray_u8(rgb)
        return rgb_to_gray_f32(rgb).to(rgb.dtype)
    chans = []
    for pos in range(enc.channels):
        color = enc.channel_order[pos]
        if color == 3:  # alpha
            chans.append(torch.full(rgb.shape[:-1], 255, dtype=rgb.dtype,
                                    device=rgb.device))
        else:
            chans.append(rgb[..., color])
    return torch.stack(chans, dim=-1)


def convert(img: torch.Tensor, src: str, dst: str) -> torch.Tensor:
    """Convert an image tensor between ROS encodings (the reference's
    convertColor, src/GPUStereoProcessor.cpp:119-172): same-encoding copy,
    bit-depth rescale, and cvtColor-style conversions."""
    se, de = encoding(src), encoding(dst)
    if se.name == de.name:
        return img
    # pure bit-depth change of same layout (mono8<->mono16)
    if se.channels == de.channels == 1 and not se.is_bayer:
        return rescale_depth(img, se.bit_depth, de.bit_depth)
    rgb = _to_canonical_rgb(img, se)
    if se.bit_depth != de.bit_depth:
        rgb = rescale_depth(rgb, se.bit_depth, de.bit_depth)
    return _from_canonical_rgb(rgb, de)
