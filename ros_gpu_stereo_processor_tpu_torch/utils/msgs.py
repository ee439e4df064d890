"""Output message structs, disparity wire codecs and async senders.

The port of ``ros_gpu_stereo_processor_tpu/utils/msgs.py``.  The reference
builds ROS messages inside CUDA stream host-callbacks
(src/GpuSenderIfc.cpp:13-26), overlapping publish I/O with later compute.
Here the frame step enqueues its work and returns device tensors; a
:class:`SenderPool` worker waits for the frame's CUDA event, copies the
tensors to the host, builds the message and calls the publisher registered
for it.  A ``None`` publisher is allowed and skips publishing — the
reference's NULL-publisher test trick (test/UTest.cpp:304).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import threading
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import color as color_ops


@dataclasses.dataclass(frozen=True)
class Header:
    stamp: float = 0.0
    frame_id: str = ""
    seq: int = 0


@dataclasses.dataclass
class ImageMessage:
    """sensor_msgs/Image equivalent (reference: src/GpuSenderImage.cpp:15-26)."""

    header: Header
    height: int
    width: int
    encoding: str
    data: np.ndarray                 # (H, W[, C]) array

    @property
    def step(self) -> int:
        return self.width * color_ops.bytes_per_pixel(self.encoding)


@dataclasses.dataclass
class DisparityImageMessage:
    """stereo_msgs/DisparityImage equivalent with *correctly wired* metadata —
    the intent of the reference's sender, fixing its ctor-argument-swap and
    8U-as-32F bugs (SURVEY.md §2.12).  ``image`` is true float32 disparity."""

    header: Header
    image: np.ndarray                # (H, W) float32, invalid < min_disparity
    f: float                         # focal length (px)
    T: float                         # baseline (m)
    min_disparity: float
    max_disparity: float
    delta_d: float                   # smallest disparity increment
    valid_window: Tuple[int, int, int, int]  # x, y, w, h


@dataclasses.dataclass
class PointCloud2Message:
    """sensor_msgs/PointCloud2 equivalent: organized H×W cloud with
    x/y/z/rgb float32 fields (reference: src/GpuSenderPc2.cpp:15-72).
    ``xyz`` is NaN for invalid points; is_dense=False."""

    header: Header
    height: int
    width: int
    xyz: np.ndarray                  # (H, W, 3) float32
    rgb: Optional[np.ndarray]        # (H, W) float32 packed 0x00RRGGBB, or None
    is_dense: bool = False

    fields = (("x", 0), ("y", 4), ("z", 8), ("rgb", 12))
    point_step: int = 16

    def packed_data(self) -> np.ndarray:
        """Serialise to the PointCloud2 wire layout (H*W, 16 bytes)."""
        out = np.zeros((self.height * self.width, 4), np.float32)
        out[:, :3] = self.xyz.reshape(-1, 3)
        if self.rgb is not None:
            out[:, 3] = self.rgb.reshape(-1)
        return out.view(np.uint8).reshape(self.height, self.width * self.point_step)


def make_disparity_message(
    header: Header,
    disp_np: np.ndarray,
    cfg: StereoBMConfig,
    fx: float,
    baseline: float,
    shape: Tuple[int, int],
) -> DisparityImageMessage:
    from ros_gpu_stereo_processor_tpu_torch.ops.stereobm import valid_window

    H, W = shape
    delta_d = (1.0 / 16.0) if cfg.refine_disparity else 1.0
    if disp_np.dtype == np.int16:
        # fixed-point ×16 wire format (the matcher's native 1/16 px
        # resolution): half the publish bytes, lossless for |d| < 2048
        disp_np = disp_np.astype(np.float32) / 16.0
    elif disp_np.dtype == np.uint8:
        # fixed8 offset wire: quarter the float bytes, 1/4 px
        disp_np = disparity_fixed8_decode(
            disp_np, cfg.min_disparity,
            fill_value=float(cfg.min_disparity - 1))
        delta_d = max(delta_d, 0.25)
    return DisparityImageMessage(
        header=header,
        image=disp_np,
        f=fx,
        T=baseline,
        min_disparity=float(cfg.min_disparity),
        max_disparity=float(cfg.min_disparity + cfg.num_disparities - 1),
        delta_d=delta_d,
        valid_window=valid_window(cfg, H, W),
    )


def disparity_fixed16(disp: torch.Tensor) -> torch.Tensor:
    """Device-side ×16 int16 quantisation for wire transfer (exact at the
    matcher's 1/16 px resolution)."""
    return torch.round(disp * 16.0).to(torch.int16)


def disparity_fixed8(disp: torch.Tensor, min_disparity: int = 0) -> torch.Tensor:
    """Device-side ×4 uint8 quantisation for wire transfer: the OFFSET from
    ``min_disparity`` plus a half-pixel bias,
    ``code = (d − min_disparity + 0.5)·4``, decoded by
    :func:`disparity_fixed8_decode`; 255 is the invalid sentinel (the
    engine's fill ``min_disparity − 1`` is detected as
    ``d < min_disparity − 0.5``).  Exact at 1/4 px for
    d ∈ [min−0.5, min+63.0]; the top excursion saturates at code 254.
    Negative search ranges don't fit an unsigned wire — use
    :func:`disparity_fixed16`."""
    if min_disparity < 0:
        raise ValueError(
            "disparity_fixed8 needs a non-negative search range; "
            "use disparity_fixed16 for min_disparity < 0")
    q = torch.round((disp - float(min_disparity) + 0.5) * 4.0)
    invalid = disp < float(min_disparity) - 0.5
    code = torch.where(invalid, torch.full_like(q, 255.0),
                       torch.clamp(q, max=254.0))
    return code.to(torch.uint8)


def disparity_fixed8_decode(wire: np.ndarray, min_disparity: int = 0,
                            fill_value: float = float("nan")) -> np.ndarray:
    """Decode the :func:`disparity_fixed8` wire back to float32 disparity
    (``fill_value`` at the 255 sentinel).  Host-side numpy (consumers run
    off-device)."""
    w = np.asarray(wire)
    d = w.astype(np.float32) / 4.0 - 0.5 + float(min_disparity)
    return np.where(w == 255, np.float32(fill_value), d)


def to_host(x) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


PublishFn = Callable[[Any], None]


class SenderPool:
    """Async output delivery: per-output device tensors → messages → publishers.

    ``enqueue(name, tensors, build_fn, ready)`` returns immediately; a worker
    waits on ``ready`` (the frame's CUDA event, or None), copies the tensors
    to the host, builds the message and calls the publisher registered for
    ``name`` (if any).  ``wait_all()`` ≙ the reference's
    ``waitForAllStreams`` + sender drain (src/GPUStereoProcessor.cpp:348-354).
    """

    def __init__(self, max_workers: int = 2):
        self._pool = concurrent.futures.ThreadPoolExecutor(max_workers=max_workers)
        self._publishers: Dict[str, PublishFn] = {}
        self._inflight: list = []
        self._lock = threading.Lock()
        self._sent: Dict[str, bool] = {}

    def register(self, name: str, publish: Optional[PublishFn]) -> None:
        if publish is not None:
            self._publishers[name] = publish

    def enqueue(self, name: str, arrays, build_fn: Callable[..., Any],
                ready: Optional[torch.cuda.Event] = None,
                ) -> "concurrent.futures.Future":
        """arrays: tensor or tuple of them; build_fn(*host_arrays) → msg."""
        self._sent[name] = False
        arrs = arrays if isinstance(arrays, tuple) else (arrays,)

        def work():
            if ready is not None:
                ready.synchronize()
            host = tuple(to_host(a) for a in arrs)
            msg = build_fn(*host)
            pub = self._publishers.get(name)
            if pub is not None:
                pub(msg)
            self._sent[name] = True
            return msg

        fut = self._pool.submit(work)
        with self._lock:
            self._inflight.append(fut)
        return fut

    def was_data_sent(self, name: str) -> bool:
        """The reference's wasDataSent() test hook (GpuSenderIfc.h:20)."""
        return self._sent.get(name, False)

    def wait_all(self) -> None:
        with self._lock:
            inflight, self._inflight = self._inflight, []
        for fut in inflight:
            fut.result()

    def shutdown(self) -> None:
        self.wait_all()
        self._pool.shutdown(wait=True)
