"""The demand-driven stereo frame pipeline, in PyTorch.

The port of ``ros_gpu_stereo_processor_tpu/models/pipeline.py``: the
reference's orchestrator ``StereoProcessor::imageCb``
(src/StereoProcessor.cpp:157-298) and engine ``GpuStereoProcessor``.

  * The :class:`Outputs` flag-set selects the stages a frame runs; a stage
    whose output nobody asked for is skipped, as in the reference's
    demand-driven branches of imageCb.
  * Both sides go through each stage together: one remap launch rectifies
    the left and right images (the reference's two CUDA streams).
  * Frames are enqueued on the current CUDA stream and not awaited: a frame
    records a CUDA event, :meth:`FrameResult.fetch` waits on it, and
    ``config.max_in_flight`` bounds how many frames may be outstanding.
  * Each (flag set, encoding, config) variant of the step is compiled once,
    as the JAX pipeline jits it: on the card a CUDA graph per input shape
    (utils/graphs.py), so a frame is one graph launch and the copies in and
    out; ``process_batch`` replays one graph for the whole batch.  A mesh
    whose band line is one card (``make_mesh(4, devices=["cuda:0"] * 4)``)
    is captured the same way; a line over several devices or processes
    runs eagerly.  Every frame's outputs are its own, however long they
    are held.
  * While the port's recorder is on (utils/timing.py), ``process_batch``
    records ``step.batch`` (its pairs), ``process`` records ``step.frame``
    (the header's ``seq``) and its wait for the oldest frame,
    ``step.in_flight_wait``, and ``enqueue_send`` records
    ``publish.enqueue`` (the header's ``seq``) with its children
    ``publish.wire``, ``publish.copy_start`` and ``publish.submit``, and
    counts under ``publish.bytes`` (tagged with the output) the bytes each
    send copies to the host.

A pipeline runs on the card (``device="cuda"``, the default) unless the
caller asks for ``device="cpu"``.  There is no device switch beyond that:
each kernel-backed op dispatches on the device of its tensors (the Hopper
kernel on CUDA, the plain version on the CPU), and nothing falls back from
one to the other.  The matcher is the block matcher or, with
``algorithm="sgm"``, semi-global matching over 2, 4 or 8 paths, all
through the kernels of ops/sgm_kernel.py (the JAX pipeline routes only 4
paths to Pallas and scans 2 and 8 in jnp; the functions are the same).

The optional bilateral post-filter (``config.bilateral.enabled``) refines
the disparity after the speckle filter, guided by the left rectified image
(ops/bilateral.py, plain torch).

With ``mesh`` (parallel/mesh.py, or a process mesh of parallel/multihost.py)
the frame runs the sharded frontend of parallel/frontend.py on the line
``mesh.along(shard_axis)``: rectification, matching, the speckle filter and
the bilateral filter by row band, as the JAX pipeline's ``mesh`` branch
does (SGM there is always the 4-path row-band SGM, whatever ``sgm_paths``
says).  With ``shard_mode="disp"`` the block matcher runs by disparity
slab over the same line (the JAX pipeline uses its shard axis as the slab
axis too), and the whole disparity is then split into bands for the
row-band speckle filter.  The images, the disparity and every output are
assembled whole on the line's first device, which changes no value.
"""

from __future__ import annotations

import dataclasses
import logging
from collections import deque
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.config import (
    BilateralConfig,
    Outputs,
    PipelineConfig,
    SpeckleConfig,
    StereoBMConfig,
    sanitize_reconfigure,
)
from ros_gpu_stereo_processor_tpu_torch.ops import bilateral as bilateral_ops
from ros_gpu_stereo_processor_tpu_torch.ops import color as color_ops
from ros_gpu_stereo_processor_tpu_torch.ops import colormap as colormap_ops
from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import reproject as reproject_ops
from ros_gpu_stereo_processor_tpu_torch.ops import sgm_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as speckle_ops
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm_kernel
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as par
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import Mesh
from ros_gpu_stereo_processor_tpu_torch.utils import graphs, timing
from ros_gpu_stereo_processor_tpu_torch.utils import msgs as msgs_mod
from ros_gpu_stereo_processor_tpu_torch.utils.hostcopy import start_host_copy, upload
from ros_gpu_stereo_processor_tpu_torch.utils.calib import StereoCameraModel
from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device
from ros_gpu_stereo_processor_tpu_torch.utils.msgs import (
    Header,
    ImageMessage,
    PointCloud2Message,
    SenderPool,
    make_disparity_message,
)
from ros_gpu_stereo_processor_tpu_torch.utils.timing import StageTimer, timed

logger = logging.getLogger("tpu_stereo")
# the recorder's names (utils/timing.py)
_STEP_BATCH = timing.intern("step.batch")
_STEP_FRAME = timing.intern("step.frame")
_IN_FLIGHT_WAIT = timing.intern("step.in_flight_wait")
_ENQUEUE = timing.intern("publish.enqueue")
_WIRE = timing.intern("publish.wire")
_COPY_START = timing.intern("publish.copy_start")
_SUBMIT = timing.intern("publish.submit")
_PUBLISH_BYTES = timing.intern("publish.bytes", timing.COUNTER)

SIDES = ("left", "right")


def _pipeline_step(
    left_raw: torch.Tensor,
    right_raw: torch.Tensor,
    rect_maps: torch.Tensor,     # (2, H, W, 2)
    Q: torch.Tensor,             # (4, 4)
    *,
    encoding: str,
    outputs: Outputs,
    bm: StereoBMConfig,
    speckle: SpeckleConfig,
    bilateral: BilateralConfig = BilateralConfig(),
    mesh: Optional[Mesh] = None,
    band_maps: Optional[List[torch.Tensor]] = None,
    shard_axis: str = "rows",
    shard_mode: str = "rows",
) -> Dict[str, torch.Tensor]:
    """One frame step: the stage DAG of imageCb (SURVEY.md §3.1), running
    only the stages ``outputs`` needs.  With ``mesh`` (the 1-D line along
    ``shard_axis``), ``band_maps`` holds each band's rows of ``rect_maps``
    on its device, and the rectified images and the disparity are band
    lists until assembled."""
    res: Dict[str, torch.Tensor] = {}

    def whole(x):
        return x if mesh is None else mesh.gather(x)

    def rectify(images: Dict[str, torch.Tensor]) -> Dict:
        # every requested side in one remap launch (per band on a mesh)
        sides = list(images)
        stack = torch.stack([images[s] for s in sides])

        def side_maps(m):
            # slices, not a list index: indexing by a list first copies the
            # list to the device, which makes the host wait for the stream
            if len(sides) == 2:
                return m if sides == list(SIDES) else m.flip(0)
            i = SIDES.index(sides[0])
            return m[i:i + 1]

        if mesh is None:
            return dict(zip(sides, remap_kernel.rectify(stack, side_maps(rect_maps))))
        maps = [side_maps(m) for m in band_maps]
        bands = par.remap_row_sharded(stack, maps, mesh, shard_axis)
        return {s: [b[k] for b in bands] for k, s in enumerate(sides)}

    enc = color_ops.encoding(encoding)
    bayer_rgb = None
    if enc.is_bayer and (outputs.needs_mono or outputs.needs_color):
        # one debayer of both sides: mono8 and rgb8 both derive from it, with
        # the values convert(..., "mono8") and convert(..., "rgb8") give
        bayer_rgb = color_ops.debayer_bilinear(
            torch.stack([left_raw, right_raw]), enc.bayer_pattern)

    mono = {}
    if outputs.needs_mono:
        if bayer_rgb is not None:
            mono = dict(zip(SIDES, color_ops.rgb_to_gray_u8(bayer_rgb)))
        else:
            mono["left"] = color_ops.convert(left_raw, encoding, "mono8")
            mono["right"] = color_ops.convert(right_raw, encoding, "mono8")
        for side in SIDES:
            if f"mono_{side}" in outputs:
                res[f"mono_{side}"] = mono[side]

    colr = {}
    if outputs.needs_color:
        if bayer_rgb is not None:
            colr = dict(zip(SIDES, bayer_rgb))
        else:
            colr["left"] = color_ops.convert(left_raw, encoding, "rgb8")
            colr["right"] = color_ops.convert(right_raw, encoding, "rgb8")
        for side in SIDES:
            if f"color_{side}" in outputs:
                res[f"color_{side}"] = colr[side]

    rect_mono = {}
    if outputs.needs_rect_mono:
        rect_mono = rectify(mono)
        for side in SIDES:
            if f"rect_mono_{side}" in outputs:
                res[f"rect_mono_{side}"] = whole(rect_mono[side])

    rect_color = {}
    if outputs.needs_rect_color:
        # the reference rectifies color only for requested sides + pc left
        # (src/StereoProcessor.cpp:239-256)
        need = [
            s
            for s in SIDES
            if f"rect_color_{s}" in outputs or (s == "left" and "pointcloud" in outputs)
        ]
        rect_color = rectify({s: colr[s] for s in need})
        for side in need:
            if f"rect_color_{side}" in outputs:
                res[f"rect_color_{side}"] = whole(rect_color[side])

    if outputs.needs_disparity:
        if mesh is not None:
            disp, valid = _mesh_disparity(rect_mono, bm, speckle, mesh, shard_axis, shard_mode)
        elif bm.algorithm == "sgm":
            disp, valid = sgm_kernel.compute_disparity_sgm_fused(
                rect_mono["left"], rect_mono["right"], bm,
                p1=bm.sgm_p1, p2=bm.sgm_p2, num_paths=bm.sgm_paths,
            )
        else:
            disp, valid = stereobm_kernel.compute_disparity_fused(
                rect_mono["left"], rect_mono["right"], bm
            )
        if speckle.enabled and mesh is None:
            disp, valid = speckle_ops.filter_speckles(
                disp,
                valid,
                max_speckle_size=speckle.max_speckle_size,
                max_diff=speckle.max_diff,
                iters=speckle.propagation_iters,
                fill_value=float(bm.min_disparity - 1),
            )
        if bilateral.enabled:
            # the intended post-filter of the reference's stub: refine the
            # disparity guided by the left rectified image; invalid pixels
            # stay as they are
            kw = dict(ndisp=bilateral.ndisp, radius=bilateral.radius,
                      iters=bilateral.iters, edge_threshold=bilateral.edge_threshold,
                      max_disc_threshold=bilateral.max_disc_threshold,
                      sigma_range=bilateral.sigma_range)
            if mesh is not None:
                refined = mesh.gather(par.bilateral_row_sharded(
                    disp, rect_mono["left"], mesh, shard_axis, **kw))
            else:
                refined = bilateral_ops.disparity_bilateral_filter(
                    disp, rect_mono["left"], **kw)
            disp = torch.where(valid, refined, disp)
        if "disparity" in outputs:
            res["disparity"] = disp
            res["disparity_valid"] = valid
        if "disparity_vis" in outputs:
            res["disparity_vis"] = colormap_ops.colorize_disparity(
                disp, bm.num_disparities, valid
            )
        if "pointcloud" in outputs:
            rgb = rect_color.get("left")
            pc = reproject_ops.point_cloud(
                disp, Q, rgb=None if rgb is None else whole(rgb), valid=valid
            )
            res["pointcloud_xyz"] = pc["xyz"]
            if "rgb" in pc:
                res["pointcloud_rgb"] = pc["rgb"]

    return res


def _mesh_disparity(rect_mono, bm: StereoBMConfig, speckle: SpeckleConfig,
                    mesh: Mesh, shard_axis: str, shard_mode: str):
    """The matcher (by band, or by disparity slab) and the speckle filter
    by band; (disparity, valid) assembled whole on the line's first
    device."""
    left, right = rect_mono["left"], rect_mono["right"]
    if bm.algorithm == "sgm":
        disp, valid = par.disparity_sgm_row_sharded(
            left, right, bm, mesh, shard_axis, p1=bm.sgm_p1, p2=bm.sgm_p2)
    elif shard_mode == "disp":
        # whole (disparity, valid); the speckle filter splits them into bands
        disp, valid = par.disparity_slab_sharded(left, right, bm, mesh, shard_axis)
    else:
        disp, valid = par.disparity_row_sharded(left, right, bm, mesh, shard_axis)
    if speckle.enabled:
        disp, valid = par.filter_speckles_row_sharded(
            disp, valid, mesh, shard_axis,
            max_speckle_size=speckle.max_speckle_size,
            max_diff=speckle.max_diff,
            iters=speckle.propagation_iters,
            merge_rounds=speckle.boundary_merge_rounds,
            fill_value=float(bm.min_disparity - 1),
        )
    if isinstance(disp, torch.Tensor):
        return disp, valid
    return mesh.gather(disp), mesh.gather(valid)


@dataclasses.dataclass
class FrameResult:
    """Device-tensor outputs of one frame step, with the CUDA event recorded
    after its work (None on the CPU, where the step ran synchronously) and,
    on a mesh, one more per further CUDA device the frame used."""

    outputs: Dict[str, torch.Tensor]
    header: Header
    event: Optional[torch.cuda.Event] = None
    band_events: Tuple[torch.cuda.Event, ...] = ()

    @property
    def events(self) -> Tuple[torch.cuda.Event, ...]:
        """The frame's events: every device it used."""
        return ((self.event,) if self.event is not None else ()) + self.band_events

    def fetch(self) -> Dict[str, np.ndarray]:
        """The outputs as numpy arrays: every output's host copy starts at
        once after the frame's events (utils/hostcopy.py), then one wait."""
        host = start_host_copy(tuple(self.outputs.values()), self.events).result()
        return dict(zip(self.outputs, host))

    def block_until_ready(self) -> "FrameResult":
        for e in self.events:
            e.synchronize()
        return self


class StereoPipeline:
    """The engine object: construct once with a stereo model (or with its
    arrays, :meth:`from_arrays`) and a device, then ``process`` frames with
    any demand flag-set.

    ``device`` defaults to the card.  ``mesh``: a mesh
    (``parallel.mesh.make_mesh``, ``parallel.multihost.global_mesh``) — run
    every frame sharded over its ``shard_axis`` (default: its first axis);
    the pipeline's device is then the first device of the line along that
    axis.  ``shard_mode``: ``"rows"``, or ``"disp"`` (the block matcher by
    disparity slab); SGM configs always row-shard."""

    def __init__(
        self,
        model: StereoCameraModel,
        config: PipelineConfig = PipelineConfig(),
        device: torch.device | str | None = None,
        mesh: Optional[Mesh] = None,
        shard_axis: Optional[str] = None,
        shard_mode: str = "rows",
    ):
        self._setup(
            model.rect_maps_stacked(), model.Q,
            model.left.calib.width, model.left.calib.height,
            model.fx, model.baseline, config, device, mesh, shard_axis, shard_mode,
        )

    @classmethod
    def from_arrays(
        cls,
        rect_maps: np.ndarray,
        Q: np.ndarray,
        width: int,
        height: int,
        fx: float,
        baseline: float,
        config: PipelineConfig = PipelineConfig(),
        device: torch.device | str | None = None,
        mesh: Optional[Mesh] = None,
        shard_axis: Optional[str] = None,
        shard_mode: str = "rows",
    ) -> "StereoPipeline":
        """A pipeline from a model's arrays: ``rect_maps`` (2, H, W, 2) float32
        (``StereoCameraModel.rect_maps_stacked()``) and the 4×4 ``Q`` — of
        this package's model or of the JAX package's, which are identical."""
        self = cls.__new__(cls)
        self._setup(rect_maps, Q, width, height, fx, baseline, config, device,
                    mesh, shard_axis, shard_mode)
        return self

    def _setup(self, rect_maps, Q, width, height, fx, baseline, config, device,
               mesh=None, shard_axis=None, shard_mode="rows"):
        rect_maps = np.asarray(rect_maps, np.float32)
        if rect_maps.shape != (2, height, width, 2):
            raise ValueError(
                f"rect_maps {rect_maps.shape} != (2, {height}, {width}, 2)")
        if shard_mode not in ("rows", "disp"):
            raise ValueError(f"shard_mode={shard_mode!r} must be 'rows' or 'disp'")
        self.mesh, self.shard_mode = mesh, shard_mode
        self.shard_axis = shard_axis or (mesh.axis_names[0] if mesh is not None else "rows")
        # the 1-D line the frame is sharded over
        self._line = None if mesh is None else mesh.along(self.shard_axis)
        if mesh is not None:
            n = self._line.size
            if height % n != 0:
                raise ValueError(f"image height {height} not divisible by mesh axis "
                                 f"{self.shard_axis}={n}")
            if device is not None and torch.device(device) != self._line.devices[0]:
                raise ValueError(f"device {device} is not the mesh's first device "
                                 f"{self._line.devices[0]}")
            device = self._line.devices[0]
        self.device = require_device(device)
        self.width, self.height = int(width), int(height)
        self.fx, self.baseline = float(fx), float(baseline)
        self.config = config
        self._rect_maps = torch.from_numpy(rect_maps).to(self.device)
        self._Q = torch.from_numpy(
            np.asarray(Q).astype(np.float32)).to(self.device)
        self._band_maps = None
        if mesh is not None:
            self._band_maps = [m.contiguous() for m in self._line.split(self._rect_maps, 1)]
        self.senders = SenderPool(
            max_workers=max(1, config.publisher_queue_size + 1)
        )
        self.timer = StageTimer()
        # one step per (outputs, encoding, config): _get_variant
        self._variants: Dict[tuple, object] = {}
        # bounded dispatch depth (config.max_in_flight): the reference syncs
        # every frame (src/StereoProcessor.cpp:284); we keep up to
        # max_in_flight frames outstanding and wait for the oldest before
        # admitting a new one
        self._in_flight: deque = deque()
        logger.info(
            "stereo model: %dx%d fx=%.2f baseline=%.4fm device=%s",
            self.width, self.height, self.fx, self.baseline, self.device,
        )

    # -- live-tunable config (the dynamic_reconfigure role, SURVEY.md §2.19)
    def reconfigure(self, **kw) -> None:
        # accept the reference's full dynamic_reconfigure vocabulary
        # (cfg/GPU.cfg:12-40) alongside our field names, with the reference
        # configCb's sanitisation (window odd, range ×16)
        kw = sanitize_reconfigure(kw)
        bm_fields = {f.name for f in dataclasses.fields(StereoBMConfig)}
        sp_fields = {f.name for f in dataclasses.fields(SpeckleConfig)}
        bl_fields = {f.name for f in dataclasses.fields(BilateralConfig)}
        unknown = set(kw) - bm_fields - sp_fields - bl_fields
        if unknown:
            raise ValueError(f"unknown reconfigure parameters: {sorted(unknown)}")
        bm_kw = {k: v for k, v in kw.items() if k in bm_fields}
        sp_kw = {k: v for k, v in kw.items() if k in sp_fields and k not in bm_fields}
        bl_kw = {
            k: v
            for k, v in kw.items()
            if k in bl_fields and k not in bm_fields and k not in sp_fields
        }
        cfg = self.config
        if bm_kw:
            cfg = cfg.replace(stereobm=cfg.stereobm.replace(**bm_kw))
        if sp_kw:
            cfg = cfg.replace(speckle=cfg.speckle.replace(**sp_kw))
        if bl_kw:
            cfg = cfg.replace(bilateral=cfg.bilateral.replace(**bl_kw))
        self.config = cfg
        # reconfigure summary line (reference: src/StereoProcessor.cpp:322)
        logger.info("reconfigured: %s %s %s", cfg.stereobm, cfg.speckle, cfg.bilateral)

    def _to_device(self, img) -> torch.Tensor:
        return upload(img, self.device)

    def _eager(self, left, right, outputs: Outputs, encoding: str):
        """The frame step run op by op (no graph): the reference the
        captured variants are held to, and the bench's per-stage timing."""
        cfg = self.config
        return _pipeline_step(
            self._to_device(left), self._to_device(right),
            self._rect_maps, self._Q,
            encoding=encoding, outputs=outputs, bm=cfg.stereobm,
            speckle=cfg.speckle, bilateral=cfg.bilateral,
            mesh=self._line, band_maps=self._band_maps,
            shard_axis=self.shard_axis, shard_mode=self.shard_mode,
        )

    def _get_variant(self, outputs: Outputs, encoding: str, batch: bool = False):
        """The step for ``(outputs, encoding)`` under the current config, as
        the JAX pipeline's ``_get_variant`` keys its jitted steps (and
        ``process_batch`` its scans, under ``"batch"``): one entry per
        (flag set, encoding, matcher, speckle, bilateral settings).  On one
        device the entry is a :class:`graphs.Captured` step (one CUDA graph
        per input shape on the card, the step itself on the CPU); a batch
        entry takes (B, H, W[, C]) stacks and returns stacked outputs.  So
        is a mesh entry whose band line is one device in this process: the
        sharded frontend reads nothing back to the host there.  A line over
        several devices runs the step eagerly (a graph per device and the
        peer copies between them are not captured), and so does a line
        that spans processes (its collectives are host exchanges)."""
        cfg = self.config
        key = (outputs.flags, encoding, cfg.stereobm, cfg.speckle, cfg.bilateral)
        if batch:
            key = ("batch",) + key
        fn = self._variants.get(key)
        if fn is not None:
            return fn
        kw = dict(encoding=encoding, outputs=outputs, bm=cfg.stereobm,
                  speckle=cfg.speckle, bilateral=cfg.bilateral, mesh=self._line,
                  band_maps=self._band_maps, shard_axis=self.shard_axis,
                  shard_mode=self.shard_mode)
        maps, Q = self._rect_maps, self._Q

        def step(left, right):
            return _pipeline_step(left, right, maps, Q, **kw)

        def steps(lefts, rights):
            outs = [step(lefts[i], rights[i]) for i in range(lefts.shape[0])]
            return {k: torch.stack([o[k] for o in outs]) for k in outs[0]} if outs else {}

        run = steps if batch else step
        line = self._line
        if line is None or line.on_one_device():
            name = (f"{'batch ' if batch else ''}{'' if line is None else 'mesh '}step "
                    f"{'+'.join(sorted(outputs.flags))} {encoding}")
            fn = graphs.Captured(run, self.device, name=name)
        else:
            def fn(left, right, dev=self.device):
                return run(upload(left, dev), upload(right, dev))
        self._variants[key] = fn
        return fn

    def _step(self, left, right, outputs: Outputs, encoding: str):
        """One frame step through its variant: on the card, one graph
        replay (inputs copied into its static buffers, outputs copied
        out)."""
        return self._get_variant(outputs, encoding)(left, right)

    def process(
        self,
        left,
        right,
        outputs: Outputs,
        encoding: str = "mono8",
        header: Optional[Header] = None,
    ) -> FrameResult:
        """Enqueue one frame and return without waiting for it — unless
        ``config.max_in_flight`` frames are already outstanding, in which
        case the oldest is waited for first (bounded pipelining).  On one
        card the frame is its variant's graph replay (the first frame of a
        variant and shape runs eagerly, then captures), as on a mesh whose
        band line is that card; on a line over several devices it runs
        eagerly."""
        s = timing.begin(_STEP_FRAME, -1 if header is None else header.seq) if timing.ON else -1
        out = self._step(left, right, outputs, encoding)
        devices = [self.device] if self.mesh is None else self._line.unique_devices()
        events = []
        for d in devices:
            if d.type == "cuda":
                with torch.cuda.device(d):
                    events.append(torch.cuda.Event())
                    events[-1].record()
        res = FrameResult(outputs=out, header=header or Header(),
                          event=events[0] if events else None,
                          band_events=tuple(events[1:]))
        depth = max(1, self.config.max_in_flight)
        self._in_flight.append(res)
        while len(self._in_flight) > depth:
            w = timing.begin(_IN_FLIGHT_WAIT) if s >= 0 else -1
            self._in_flight.popleft().block_until_ready()
            if w >= 0:
                timing.end(w)
        if s >= 0:
            timing.end(s)
        return res

    def process_batch(
        self,
        lefts,
        rights,
        outputs: Outputs,
        encoding: str = "mono8",
    ) -> Dict[str, torch.Tensor]:
        """Process a batch of frames, lefts/rights (B, H, W[, C]), in one
        device dispatch on the card: the B frame steps are captured as one
        CUDA graph (per B and frame shape) that writes the stacked outputs,
        and each call replays it once, as the JAX pipeline runs
        ``jit(lax.scan)``.  Returns a dict of stacked outputs (B leading
        axis), fresh on every call.  On a line over several devices or
        processes the steps run eagerly."""
        s = timing.begin(_STEP_BATCH, n=len(lefts)) if timing.ON else -1
        out = self._get_variant(outputs, encoding, batch=True)(lefts, rights)
        if s >= 0:
            timing.end(s)
        return out

    def timed_process(self, left, right, outputs, encoding="mono8", header=None):
        """Synchronous process with timing — the TIMING instrumentation hook
        (reference: src/StereoProcessor.cpp:288-297).  On a CUDA device the
        time is read from CUDA events around the frame's work.  Accumulates
        into ``self.timer`` and returns (FrameResult, total_ms)."""
        res, ms = timed(
            lambda: self.process(left, right, outputs, encoding, header).block_until_ready(),
            self.device)
        self.timer.stages[f"process[{len(outputs.flags)} outs]"].update(ms)
        return res, ms

    def timing_line(self) -> str:
        return self.timer.timing_line()

    # ------------------------------------------------------------------
    # Async publish: enqueue outputs to the sender pool
    # ------------------------------------------------------------------

    def enqueue_send(self, res: FrameResult, outputs: Outputs) -> None:
        """Register async message builds for every requested output —
        the role of enqueueSendImage/Disparity/Points
        (src/GPUStereoProcessor.cpp:210-234).  Every output's device→host
        copy starts here, in one host copy of the frame (one stream switch
        and one event for all of them, utils/hostcopy.py) ordered after the
        frame's events and the disparity's wire codec; a sender worker
        builds and publishes each message once that copy has landed."""
        h = res.header
        s = timing.begin(_ENQUEUE, h.seq) if timing.ON else -1
        cfg = self.config.stereobm
        H, W = self.height, self.width

        def img_builder(enc):
            return lambda a: ImageMessage(h, a.shape[0], a.shape[1], enc, a)

        def pc_builder(xyz, rgb=None):
            return PointCloud2Message(h, xyz.shape[0], xyz.shape[1], xyz, rgb)

        sends = []      # (output name, its tensors, message builder)
        ready = res.event
        for name in outputs.flags:
            if name.startswith(("mono_", "rect_mono_")):
                sends.append((name, (res.outputs[name],), img_builder("mono8")))
            elif name.startswith(("color_", "rect_color_")) or name == "disparity_vis":
                sends.append((name, (res.outputs[name],), img_builder("rgb8")))
            elif name == "disparity":
                w = timing.begin(_WIRE, h.seq) if s >= 0 else -1
                wire = self._wire_disparity(res.outputs["disparity"])
                if ready is not None:
                    # the wire codec is enqueued after the frame's event
                    ready = torch.cuda.Event()
                    ready.record()
                if w >= 0:
                    timing.end(w)
                sends.append((name, (wire,), lambda a: make_disparity_message(
                    h, a, cfg, self.fx, self.baseline, (H, W))))
            elif name == "pointcloud":
                arrays = (res.outputs["pointcloud_xyz"],)
                if "pointcloud_rgb" in res.outputs:
                    arrays = arrays + (res.outputs["pointcloud_rgb"],)
                sends.append((name, arrays, pc_builder))
        # after every device the frame used (a mesh over several cards)
        w = timing.begin(_COPY_START, h.seq) if s >= 0 else -1
        copy = start_host_copy([t for _, ts, _ in sends for t in ts],
                               (ready,) + res.band_events)
        if w >= 0:
            timing.end(w)
        w = timing.begin(_SUBMIT, h.seq) if s >= 0 else -1
        start = 0
        for name, ts, build in sends:
            if s >= 0:
                timing.count(_PUBLISH_BYTES, sum(t.nbytes for t in ts),
                             tag=timing.intern(name, timing.TAG))
            self.senders.enqueue_copy(name, copy.part(start, start + len(ts)), build, h.seq)
            start += len(ts)
        if w >= 0:
            timing.end(w)
        if s >= 0:
            timing.end(s)

    def _wire_disparity(self, disp: torch.Tensor) -> torch.Tensor:
        """Quantize disparity on the device per ``config.disparity_wire``
        before the device→host publish copy (the message builder decodes,
        make_disparity_message)."""
        wire = self.config.disparity_wire
        if wire == "float32":
            return disp
        if wire == "fixed16":
            return msgs_mod.disparity_fixed16(disp)
        return msgs_mod.disparity_fixed8(
            disp, min_disparity=int(self.config.stereobm.min_disparity))

    def wait_all(self) -> None:
        self.senders.wait_all()
