"""Long-running serve daemon — the engine's live-node deployment.

The port of ``ros_gpu_stereo_processor_tpu/runtime/serve.py``, the role of
the reference's ros::spin() loop with its live surface
(src/StereoProcessorNode.cpp + StereoProcessor wiring):

  * **frame intake**: watches ``<watch_dir>/left`` and ``<watch_dir>/right``
    for ``<stamp>.png`` drops and pairs them through the native ingest
    runtime (Exact/ApproximateTime — the message_filters synchronizers);
  * **live CameraInfo model init**: constructed without calibration, it
    waits for ``camera_info_left.yaml`` / ``camera_info_right.yaml`` drops
    in the watch dir and builds the stereo model then (the reference's
    one-shot ``imageAndInfoCb``, src/StereoProcessor.cpp:51-77,144-155);
  * **live reconfigure**: on every change of ``<watch_dir>/reconfigure.json``
    applies its keys through :meth:`StereoPipeline.reconfigure`, which speaks
    the reference's dynamic_reconfigure names with configCb's sanitisation
    (src/StereoProcessor.cpp:307-336, cfg/GPU.cfg:12-40); an ``outputs`` key
    switches the demand flag-set;
  * **outputs**: disparity ``.npy`` and visualisation / rectified images per
    frame into ``out_dir``, written by sender workers while the consumer
    keeps dispatching (the publish-from-stream-callback overlap,
    src/GpuSenderIfc.cpp:13-26).

The daemon runs its pipeline and its ingest on the card unless the caller
asks for ``device="cpu"``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from typing import Optional

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.config import Outputs, PipelineConfig
from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device
from ros_gpu_stereo_processor_tpu_torch.utils.msgs import SenderPool, disparity_fixed8_decode
from ros_gpu_stereo_processor_tpu_torch.utils.timing import StageTimer

logger = logging.getLogger("tpu_stereo")

CAMERA_INFO_FILES = ("camera_info_left.yaml", "camera_info_right.yaml")
RECONFIGURE_FILE = "reconfigure.json"


class ServeDaemon:
    """Watch-dir serving loop.  Construct, then :meth:`run` (or drive
    :meth:`poll_once` yourself — the testable surface)."""

    def __init__(
        self,
        watch_dir: str,
        out_dir: str,
        outputs: Outputs,
        encoding: str = "mono8",
        config: Optional[PipelineConfig] = None,
        calib_left: str = "",
        calib_right: str = "",
        queue_size: int = 5,
        approximate_sync: bool = False,
        idle_timeout: float = 0.0,
        device: torch.device | str | None = None,
        save_outputs: bool = True,
    ):
        self.device = require_device(device)
        self.watch_dir = watch_dir
        self.out_dir = out_dir
        self.outputs = outputs
        self.encoding = encoding
        self.config = config or PipelineConfig()
        self.queue_size = queue_size
        self.approximate_sync = approximate_sync
        self.idle_timeout = idle_timeout
        self.save_outputs = save_outputs

        os.makedirs(out_dir, exist_ok=True)
        self.pipe = None
        self.ingest = None
        self.timer = StageTimer()
        self.n_frames = 0
        self._seen = {"left": set(), "right": set()}
        self._watermark = {"left": -1e30, "right": -1e30}
        self._reconf_mtime = 0.0
        self._idle = 0.0
        self.poll_interval = 0.2
        # sender workers copy outputs to the host and write them while the
        # consumer keeps dispatching
        self._senders = SenderPool(max_workers=3)
        self._inflight: list = []
        # (publish time, latency ms): fps over the window the deque holds, so
        # a run longer than its capacity is not under-reported
        self._lat_ms: deque = deque(maxlen=256)

        if calib_left and calib_right:
            self._init_model(calib_left, calib_right)

    # ------------------------------------------------------------------
    def _init_model(self, calib_left: str, calib_right: str) -> None:
        from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
        from ros_gpu_stereo_processor_tpu_torch.runtime.ingest import StreamingIngest
        from ros_gpu_stereo_processor_tpu_torch.utils.calib import StereoCameraModel

        model = StereoCameraModel.from_files(calib_left, calib_right)
        self.pipe = StereoPipeline(model, self.config, device=self.device)
        shape = (model.left.calib.height, model.left.calib.width)
        self.ingest = StreamingIngest(shape, capacity=self.queue_size,
                                      exact=not self.approximate_sync, device=self.device)
        logger.info("serve: stereo model initialised (%dx%d)", *shape[::-1])

    def _check_camera_info(self) -> None:
        """One-shot model init from dropped camera-info files — the live
        analogue of imageAndInfoCb (src/StereoProcessor.cpp:144-155)."""
        if self.pipe is not None:
            return
        paths = [os.path.join(self.watch_dir, f) for f in CAMERA_INFO_FILES]
        if all(os.path.exists(p) for p in paths):
            try:
                self._init_model(paths[0], paths[1])
            except Exception as e:   # a partially written file: retry next poll
                logger.debug("serve: camera-info parse retry (%s)", e)

    def _check_reconfigure(self) -> bool:
        """Apply <watch_dir>/reconfigure.json if it changed.  Returns True
        when new parameters were applied."""
        path = os.path.join(self.watch_dir, RECONFIGURE_FILE)
        try:
            mtime = os.stat(path).st_mtime
        except OSError:
            return False
        if mtime <= self._reconf_mtime or self.pipe is None:
            return False
        try:
            with open(path) as f:
                kw = json.load(f)
        except (OSError, ValueError):
            return False   # mid-write: retry at the next poll
        self._reconf_mtime = mtime
        if not isinstance(kw, dict):
            logger.warning("serve: reconfigure.json must hold an object")
            return False
        # "outputs" switches the demand flag-set live — the role of the
        # reference's subscriber-driven connectCb (src/StereoProcessor.cpp:104-142)
        out_names = kw.pop("outputs", None)
        applied = False
        if out_names is not None:
            try:
                names = (out_names.split(",") if isinstance(out_names, str)
                         else list(out_names))
                self.outputs = Outputs.of(*[n.strip() for n in names if n])
                logger.info("serve: outputs -> %s", sorted(self.outputs.flags))
                applied = True
            except ValueError as e:
                logger.warning("serve: outputs rejected: %s", e)
        if kw:
            try:
                self.pipe.reconfigure(**kw)
                applied = True
            except (TypeError, ValueError) as e:
                logger.warning("serve: reconfigure rejected: %s", e)
        return applied

    # ------------------------------------------------------------------
    def _scan_side(self, side: str) -> int:
        from ros_gpu_stereo_processor_tpu_torch.utils.io import load_image

        d = os.path.join(self.watch_dir, side)
        if not os.path.isdir(d) or self.ingest is None:
            return 0
        seen = self._seen[side]
        # bound the long-running daemon's memory and scan cost: files at or
        # below the watermark are done; prune them from `seen`
        if len(seen) > 256:
            wm = self._watermark[side]

            def _keep(f: str) -> bool:
                # unparsable names were added to skip them forever: they
                # must survive the prune or they would be fed every scan
                try:
                    return float(os.path.splitext(f)[0]) > wm - 1.0
                except ValueError:
                    return True

            self._seen[side] = seen = {f for f in seen if _keep(f)}
        new = 0
        for f in sorted(os.listdir(d)):
            if not f.endswith(".png") or f.startswith(".") or f in seen:
                continue
            try:
                stamp = float(os.path.splitext(f)[0])
            except ValueError:
                seen.add(f)   # unparsable name: skip forever
                continue
            if stamp <= self._watermark[side]:
                continue
            try:
                img = load_image(os.path.join(d, f))
            except Exception:       # a partially written file (producer race)
                logger.debug("serve: %s/%s not readable yet", side, f, exc_info=True)
                continue
            seen.add(f)
            self._watermark[side] = max(self._watermark[side], stamp)
            if img.ndim == 3 and self.encoding.startswith("mono"):
                img = img[..., 0]
            self.ingest.feed(side, img, stamp)
            new += 1
        return new

    def _publish(self, res, stamp: float, t_dispatch: float) -> None:
        """Enqueue one frame's outputs on the sender pool: a worker waits for
        the frame, copies its tensors to the host and writes the files off
        the consumer thread."""
        from ros_gpu_stereo_processor_tpu_torch.utils.io import write_image

        save = self.save_outputs
        out_dir = self.out_dir
        names = [n for n in ("disparity", "disparity_vis", "rect_mono_left")
                 if n in res.outputs]
        ready = res.event
        if not names:  # nothing publishable requested: just join the frame
            names, arrays = ["_sync"], (next(iter(res.outputs.values())),)
        else:
            # disparity crosses to the host on the configured wire
            # (config.disparity_wire); build() decodes before writing
            arrays = tuple(self.pipe._wire_disparity(res.outputs[n]) if n == "disparity"
                           else res.outputs[n] for n in names)
            if ready is not None and "disparity" in names:
                # the wire codec is enqueued after the frame's event
                ready = torch.cuda.Event()
                ready.record()
        min_disp = int(self.pipe.config.stereobm.min_disparity)

        def build(*host):
            if save:
                for n, a in zip(names, host):
                    if n == "disparity":
                        if a.dtype == np.int16:
                            a = a.astype(np.float32) / 16.0
                        elif a.dtype == np.uint8:
                            a = disparity_fixed8_decode(a, min_disp,
                                                        fill_value=float(min_disp - 1))
                        np.save(os.path.join(out_dir, f"disparity_{stamp:.6f}.npy"), a)
                    elif n != "_sync":
                        write_image(os.path.join(out_dir, f"{n}_{stamp:.6f}.png"), a)
            return names

        fut = self._senders.enqueue("frame", arrays, build, ready=ready)

        def _done(_f, t0=t_dispatch):
            now = time.perf_counter()
            self._lat_ms.append((now, (now - t0) * 1e3))

        fut.add_done_callback(_done)
        self._inflight.append(fut)
        # bounded pipelining: never run unboundedly ahead of the senders
        while len(self._inflight) > max(2, self.pipe.config.max_in_flight):
            self._inflight.pop(0).result()

    def timing(self) -> dict:
        """fps and p50/p95 dispatch→publish ms over the frames the latency
        window holds (None before the first published frame)."""
        window = list(self._lat_ms)
        if not window:
            return {"frames": 0, "fps": None, "p50_ms": None, "p95_ms": None}
        lats = sorted(lat for _, lat in window)
        span = window[-1][0] - window[0][0]
        n = len(window)
        return {"frames": n, "fps": (n - 1) / span if span > 0 and n > 1 else 0.0,
                "p50_ms": lats[n // 2], "p95_ms": lats[min(n - 1, int(n * 0.95))]}

    def _timing_line(self) -> str:
        """The reference's TIMING debug line, with the percentiles the
        per-frame deployment shape is judged by."""
        t = self.timing()
        if not t["frames"]:
            return self.timer.timing_line()
        return (f"TIMING fps={t['fps']:.1f} lat_ms p50={t['p50_ms']:.1f} "
                f"p95={t['p95_ms']:.1f} (dispatch→publish, last {t['frames']})")

    def _process_ready(self) -> int:
        if len(self.ingest.ring) == 0:
            return 0   # idle poll: no uploader thread for nothing
        done = 0
        # the uploader thread stages stacked pairs while the consumer
        # dispatches and the sender workers copy out and write
        for left_d, right_d, stamp, seq in self.ingest.frames_prefetch(
                timeout=0, depth=3, stacked=True):
            t0 = time.perf_counter()
            with self.timer.stage("dispatch"):
                res = self.pipe.process(left_d, right_d, self.outputs, encoding=self.encoding)
            self._publish(res, stamp, t0)
            self.n_frames += 1
            done += 1
            if self.n_frames % 10 == 0:
                print(f"[{self.n_frames}] {self._timing_line()}  "
                      f"ring={self.ingest.ring.stats()}", flush=True)
        return done

    def drain(self) -> None:
        """Join every in-flight publish (tests / shutdown)."""
        while self._inflight:
            self._inflight.pop(0).result()
        self._senders.wait_all()

    def close(self) -> None:
        """Drain, then stop the sender workers and the pipeline's pool."""
        self.drain()
        self._senders.shutdown()
        if self.pipe is not None:
            self.pipe.senders.shutdown()

    def poll_once(self) -> int:
        """One poll cycle: control files, new frames, processing.  Returns
        the number of new inputs consumed (frames fed + control changes)."""
        n = 0
        self._check_camera_info()
        if self._check_reconfigure():
            n += 1
        for side in ("left", "right"):
            n += self._scan_side(side)
        if self.pipe is not None:
            self._process_ready()
        return n

    def run(self) -> int:
        """Poll until idle_timeout (0 = forever).  Returns frames served."""
        while True:
            new = self.poll_once()
            if new == 0:
                self._idle += self.poll_interval
                if self.idle_timeout and self._idle >= self.idle_timeout:
                    break
                time.sleep(self.poll_interval)
            else:
                self._idle = 0.0
        self.drain()
        print(f"served {self.n_frames} frames; {self._timing_line()}")
        return self.n_frames
