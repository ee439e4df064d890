"""Dataset IO, timestamp pairing and synthetic input for the port (numpy only).

Copies of ``ros_gpu_stereo_processor_tpu/utils/io.py`` (the port cannot
import the JAX package, whose ``__init__`` imports jax): the reference's ROS
input plumbing — message_filters Exact/ApproximateTime synchronizers over
stereo topics (include/gpuimageproc/StereoProcessor.h:45-62) — becomes
datasets (PNG directories / EuRoC layout) paired by timestamp, exact or
nearest-within-slop; and ``synthetic_stereo_pair``, so the port's tests and
``chip_smoke.py`` make identical frames.

Images are read and written with ``imageio`` or ``cv2`` where one is
installed, else by this module's own PNG codec (:func:`png_decode`,
:func:`png_encode`: numpy and ``zlib``), so a machine with neither can still
serve PNG drops and write its outputs.
"""

from __future__ import annotations

import dataclasses
import os
import struct
import zlib
from typing import Iterator, List, Sequence, Tuple

import numpy as np

# ---------------------------------------------------------------------------
# PNG codec (numpy + zlib), the last option of load_image / write_image
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# colour type -> channels: grey, RGB, grey + alpha, RGBA (no palette)
_PNG_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters (None, Sub, Up, Average, Paeth) of
    ``raw``: height rows of 1 filter byte + ``stride`` bytes."""
    rows = raw.reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.int64)
    for y in range(height):
        ftype = int(rows[y, 0])
        line = rows[y, 1:].astype(np.int64)
        if ftype == 0:
            cur = line
        elif ftype == 1:        # Sub: a running sum of each byte lane
            cur = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) & 0xFF
        elif ftype == 2:        # Up
            cur = (line + prior) & 0xFF
        elif ftype in (3, 4):   # Average, Paeth: depend on the reconstructed left byte
            cur = line.copy()
            up = prior
            for x in range(stride):
                a = int(cur[x - bpp]) if x >= bpp else 0
                b = int(up[x])
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = int(up[x - bpp]) if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
                cur[x] = (int(cur[x]) + pred) & 0xFF
        else:
            raise ValueError(f"PNG: unknown row filter {ftype}")
        out[y] = cur
        prior = cur
    return out


def png_decode(data: bytes) -> np.ndarray:
    """Decode a PNG: 8- or 16-bit grey, grey + alpha, RGB or RGBA,
    non-interlaced, any of the five row filters.  Returns (H, W) or
    (H, W, C) uint8/uint16.  Raises ``ValueError`` on anything else, a bad
    CRC or a truncated file."""
    if data[:8] != _PNG_SIG:
        raise ValueError("not a PNG file")
    pos, ihdr, idat, ended = 8, None, [], False
    while pos + 8 <= len(data):
        length, ctype = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        crc = data[pos + 8 + length:pos + 12 + length]
        if len(body) != length or len(crc) != 4:
            raise ValueError("PNG: truncated chunk")
        if zlib.crc32(ctype + body) != struct.unpack(">I", crc)[0]:
            raise ValueError(f"PNG: bad CRC in chunk {ctype!r}")
        pos += 12 + length
        if ctype == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif ctype == b"IDAT":
            idat.append(body)
        elif ctype == b"IEND":
            ended = True
            break
    if ihdr is None or not ended:
        raise ValueError("PNG: missing IHDR or IEND (truncated file?)")
    width, height, depth, color, comp, filt, interlace = ihdr
    if color not in _PNG_CHANNELS or depth not in (8, 16) or comp or filt or interlace:
        raise ValueError(f"PNG: unsupported layout (colour type {color}, depth {depth}, "
                         f"interlace {interlace}); only 8/16-bit grey, grey+alpha, RGB "
                         "and RGBA, non-interlaced")
    channels = _PNG_CHANNELS[color]
    bpp = channels * depth // 8
    stride = width * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size != height * (stride + 1):
        raise ValueError("PNG: image data of the wrong size")
    px = _unfilter(raw, height, stride, bpp)
    if depth == 16:
        px = px.reshape(height, stride // 2, 2).view(">u2")[..., 0].astype(np.uint16)
    img = px.reshape(height, width, channels)
    return img[..., 0] if channels == 1 else img


def png_encode(img: np.ndarray) -> bytes:
    """Encode (H, W) or (H, W, C ∈ {1, 2, 3, 4}) uint8/uint16 as a PNG:
    no row filter, one zlib stream."""
    a = np.asarray(img)
    if a.dtype not in (np.uint8, np.uint16) or a.ndim not in (2, 3):
        raise ValueError(f"png_encode: needs (H, W[, C]) uint8 or uint16, got "
                         f"{a.shape} {a.dtype}")
    if a.ndim == 2:
        a = a[..., None]
    height, width, channels = a.shape
    color = {1: 0, 3: 2, 2: 4, 4: 6}.get(channels)
    if color is None:
        raise ValueError(f"png_encode: {channels} channels")
    depth = 8 * a.dtype.itemsize
    px = np.ascontiguousarray(a.astype(">u2") if depth == 16 else a).view(np.uint8)
    rows = np.concatenate([np.zeros((height, 1), np.uint8), px.reshape(height, -1)], axis=1)

    def chunk(ctype: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + ctype + body
                + struct.pack(">I", zlib.crc32(ctype + body)))

    ihdr = struct.pack(">IIBBBBB", width, height, depth, color, 0, 0, 0)
    return (_PNG_SIG + chunk(b"IHDR", ihdr) + chunk(b"IDAT", zlib.compress(rows.tobytes(), 6))
            + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """Load an image file to a numpy array (uint8/uint16).

    Color images are returned RGB.  Reads with ``imageio``, else ``cv2``,
    else (a ``.png`` only) with :func:`png_decode`."""
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if iio is not None:
        return np.asarray(iio.imread(path))
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
        if img is None:
            raise FileNotFoundError(path)
        if img.ndim == 3:
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB if img.shape[2] == 3
                               else cv2.COLOR_BGRA2RGBA)
        return img
    if not path.lower().endswith(".png"):
        raise ImportError(f"cannot read {path}: without imageio or cv2, load_image "
                          "reads PNG files only")
    with open(path, "rb") as f:
        return png_decode(f.read())


def write_image(path: str, img: np.ndarray) -> None:
    """Write an image (mono, or RGB / RGBA in that channel order) with
    ``imageio``, else ``cv2``, else (a ``.png`` only) with
    :func:`png_encode`."""
    try:
        import imageio.v3 as iio
    except ImportError:
        iio = None
    if iio is not None:
        iio.imwrite(path, img)
        return
    try:
        import cv2
    except ImportError:
        cv2 = None
    if cv2 is not None:
        a = np.asarray(img)
        if a.ndim == 3 and a.shape[2] in (3, 4):
            a = cv2.cvtColor(a, cv2.COLOR_RGB2BGR if a.shape[2] == 3 else cv2.COLOR_RGBA2BGRA)
        if not cv2.imwrite(path, a):
            raise OSError(f"cv2 could not write {path}")
        return
    if not path.lower().endswith(".png"):
        raise ImportError(f"cannot write {path}: without imageio or cv2, write_image "
                          "writes PNG files only")
    data = png_encode(img)
    with open(path, "wb") as f:
        f.write(data)


@dataclasses.dataclass(frozen=True)
class StereoFrame:
    """One synchronized stereo pair — the unit of work of the pipeline
    (the reference's (l_image_msg, r_image_msg) callback pair,
    src/StereoProcessor.cpp:157)."""

    stamp: float                 # seconds
    left: np.ndarray             # (H, W) or (H, W, C)
    right: np.ndarray
    encoding: str = "mono8"
    seq: int = 0


# ---------------------------------------------------------------------------
# Timestamp pairing (the message_filters sync policies)
# ---------------------------------------------------------------------------


def pair_timestamps_exact(
    left: Sequence[float], right: Sequence[float]
) -> List[Tuple[int, int]]:
    """ExactTime policy: match identical stamps only."""
    rmap = {t: i for i, t in enumerate(right)}
    return [(i, rmap[t]) for i, t in enumerate(left) if t in rmap]


def pair_timestamps_approx(
    left: Sequence[float], right: Sequence[float], slop: float = 0.01
) -> List[Tuple[int, int]]:
    """ApproximateTime-like policy: greedy nearest-neighbour within ``slop``
    seconds, monotonic (each frame used at most once)."""
    pairs: List[Tuple[int, int]] = []
    j = 0
    for i, tl in enumerate(left):
        # advance j while the next right stamp is closer
        while j + 1 < len(right) and abs(right[j + 1] - tl) <= abs(right[j] - tl):
            j += 1
        if j < len(right) and abs(right[j] - tl) <= slop:
            pairs.append((i, j))
            j += 1
            if j >= len(right):
                break
    return pairs


# ---------------------------------------------------------------------------
# EuRoC dataset reader
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class EurocReader:
    """Reader for the EuRoC MAV dataset layout::

        <root>/mav0/cam0/data.csv   # "#timestamp [ns],filename"
        <root>/mav0/cam0/data/<stamp>.png
        <root>/mav0/cam1/...

    Yields :class:`StereoFrame` pairs matched by timestamp.
    """

    root: str
    approximate_sync: bool = False
    slop: float = 0.005

    def _cam_index(self, cam: str) -> Tuple[List[float], List[str]]:
        base = os.path.join(self.root, "mav0", cam)
        csv = os.path.join(base, "data.csv")
        stamps: List[float] = []
        files: List[str] = []
        with open(csv, "r") as f:
            for line in f:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                ts_str, fname = line.split(",")[:2]
                stamps.append(int(ts_str) * 1e-9)
                files.append(os.path.join(base, "data", fname.strip()))
        return stamps, files

    def _pairs(self, lt, rt):
        if self.approximate_sync:
            return pair_timestamps_approx(lt, rt, self.slop)
        return pair_timestamps_exact(lt, rt)

    def __iter__(self) -> Iterator[StereoFrame]:
        lt, lf = self._cam_index("cam0")
        rt, rf = self._cam_index("cam1")
        for seq, (i, j) in enumerate(self._pairs(lt, rt)):
            yield StereoFrame(
                stamp=lt[i],
                left=load_image(lf[i]),
                right=load_image(rf[j]),
                encoding="mono8",
                seq=seq,
            )

    def __len__(self) -> int:
        lt, _ = self._cam_index("cam0")
        rt, _ = self._cam_index("cam1")
        return len(self._pairs(lt, rt))


@dataclasses.dataclass
class ImagePairSource:
    """Trivial in-memory frame source (for tests and the golden images)."""

    frames: List[StereoFrame]

    def __iter__(self) -> Iterator[StereoFrame]:
        return iter(self.frames)

    def __len__(self) -> int:
        return len(self.frames)


def synthetic_stereo_pair(
    height: int = 480,
    width: int = 752,
    max_disparity: int = 48,
    seed: int = 0,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Generate a textured random-dot stereo pair with a known disparity ramp.

    Returns (left, right, true_disparity).  Used by kernel tests to verify the
    matcher end-to-end with a known answer (no golden file needed).
    """
    rng = np.random.default_rng(seed)
    # Smooth disparity field: horizontal ramp + a raised rectangle
    yy, xx = np.mgrid[0:height, 0:width]
    disp = (max_disparity * 0.25 + max_disparity * 0.5 * xx / width).astype(np.float32)
    disp[height // 4 : height // 2, width // 4 : width // 2] += max_disparity * 0.2
    disp = np.round(disp)  # integer disparity → exact warping

    # Random texture, heavy on high frequencies so SAD locks on.
    # Convention: the matcher reports d(x_left) s.t. right(x_left − d) ==
    # left(x_left); generating left by sampling a common texture at
    # (x + M − D(x)) with right = tex[:, M:] makes D the exact ground truth.
    M = max_disparity + 8
    tex = rng.integers(0, 255, size=(height, width + M), dtype=np.uint8)
    right = tex[:, M:].copy()
    left = tex[yy, xx + M - disp.astype(np.int64)]
    return left, right, disp
