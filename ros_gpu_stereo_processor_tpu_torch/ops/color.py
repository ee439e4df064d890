"""Color / encoding conversion ops (gray, channel order, bit depth).

The PyTorch port of ``ros_gpu_stereo_processor_tpu/ops/color.py``, the
replacement for the reference's encoding-driven converter
(src/GPUStereoProcessor.cpp:65-88,119-172):

  * RGB↔BGR channel swap, gray↔color replication,
  * color→gray with BT.601 weights, rounded half to even,
  * 8↔16-bit rescale with the reference's 65535/255 scale factor
    (src/GPUStereoProcessor.cpp:154-158).

Each function is the same sequence of float32 operations as its JAX twin, so
integer results agree exactly.  The Bayer encodings are recognised but their
debayer is not ported yet (ROADMAP.md, Queue 1 item 2): ``convert`` raises
``NotImplementedError`` for them.
"""

from __future__ import annotations

import dataclasses
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
# General conversion entry point
# ---------------------------------------------------------------------------


def _to_canonical_rgb(img: torch.Tensor, enc: Encoding) -> torch.Tensor:
    """Convert any supported encoding to (..., 3) uint8/uint16 RGB."""
    if enc.is_bayer:
        raise NotImplementedError(
            f"{enc.name}: the bilinear debayer is not ported yet "
            "(ROADMAP.md, Queue 1 item 2)")
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
    if se.is_bayer or de.is_bayer:
        raise NotImplementedError(
            f"{src}->{dst}: Bayer conversions are not ported yet "
            "(ROADMAP.md, Queue 1 item 2)")
    # pure bit-depth change of same layout (mono8<->mono16)
    if se.channels == de.channels == 1:
        return rescale_depth(img, se.bit_depth, de.bit_depth)
    rgb = _to_canonical_rgb(img, se)
    if se.bit_depth != de.bit_depth:
        rgb = rescale_depth(rgb, se.bit_depth, de.bit_depth)
    return _from_canonical_rgb(rgb, de)
