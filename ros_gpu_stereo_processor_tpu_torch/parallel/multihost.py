"""Multi-process runtime on ``torch.distributed``: process group set-up,
process-spanning meshes and host-local frame feeding.

The port of ``ros_gpu_stereo_processor_tpu/parallel/multihost.py``.  Where
JAX's distributed runtime makes ``jax.devices()`` span every process and
``shard_map`` collectives ride ICI and DCN, here each process holds its own
entries of a :class:`ProcessMesh`, and the mesh's collectives are
``torch.distributed`` operations, so every function of parallel/frontend.py
and parallel/dist_ba.py (and ``StereoPipeline(mesh=...)``) runs on it
unchanged:

  * :func:`initialize` — one call per process: ``init_process_group`` with
    the caller's backend (``"nccl"`` for one card per process, ``"gloo"``
    otherwise; NCCL refuses two ranks on one card, and that error is not
    caught) and a timeout;
  * :func:`global_mesh` — a mesh over every process's entries, rank-major
    (rank r holds entries r·k … r·k + k − 1 of k local entries); with two
    axes and no ``shape``, processes along the first axis and each
    process's entries along the second (``("kf", "rows")``);
  * :func:`host_local_rows` / :func:`put_row_sharded` — host-local frame
    ingest: each process stages only the row band its own entries own and
    places it on its devices, with no copy of pixels between processes.

Collectives: ``shift_down``/``shift_up`` (``ppermute``) are point-to-point
sends and receives issued together by ``batch_isend_irecv``, so no order
of them can deadlock; ``psum``/``pmin`` and the speckle merge loop's flag
are ``all_reduce``; ``all_gather`` and ``gather`` are ``all_gather``.
With gloo, which has no CUDA send, receive or all-gather, every exchanged
tensor is staged through host memory; the kernels still run on the card.

The worker, one process of an N-process run that prints checksums for its
launcher to compare (``DENSE``, ``FPS``, ``PIPE``, ``BA`` lines, as the JAX
worker does, plus ``BACKEND`` and ``LAUNCHES``):

    python -m ros_gpu_stereo_processor_tpu_torch.parallel.multihost \\
        --init-method tcp://127.0.0.1:29500 --world-size 2 --rank 0 \\
        --backend gloo --bands-per-process 2 [--device cpu]
"""

from __future__ import annotations

import argparse
import datetime
import hashlib
import json
import time
from typing import Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import Mesh, _device, _fold
from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device


def initialize(
    init_method: str,
    world_size: int,
    rank: int,
    backend: str = "gloo",
    device=None,
    timeout_s: float = 120.0,
) -> torch.device:
    """Join the process group (``init_method`` e.g. ``tcp://host:port``) and
    return this process's device: the card unless ``device`` says
    otherwise.  ``backend`` is ``"nccl"`` (CUDA tensors between processes,
    one card per process) or ``"gloo"`` (tensors staged through host
    memory).  A first ``all_reduce`` checks the group; NCCL raises there
    when two ranks share a card."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r} must be 'gloo' or 'nccl'")
    dev = _device(require_device(device))
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the NCCL backend needs a CUDA device per process")
    if not dist.is_initialized():
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                                rank=rank, timeout=datetime.timedelta(seconds=timeout_s))
        probe = torch.ones(1, device=dev if backend == "nccl" else "cpu")
        dist.all_reduce(probe)
        if int(probe.item()) != world_size:
            raise RuntimeError(f"all_reduce over {world_size} ranks gave {probe.item()}")
    return dev


def shutdown() -> None:
    if dist.is_initialized():
        dist.destroy_process_group()


class ProcessMesh(Mesh):
    """A mesh whose entries belong to the processes of the group: ``owners``
    (the rank of each entry) and ``slots`` (its index into that rank's
    ``local_devices``) over ``axis_names``.  ``devices`` and ``indices`` are
    this process's; ``size`` and ``shape`` are the whole mesh's.  Built by
    :func:`global_mesh`; a line (``along``) talks to the ranks on it."""

    def __init__(self, owners: np.ndarray, slots: np.ndarray, local_devices: Sequence,
                 axis_names: Tuple[str, ...], groups: dict, group=None):
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, owners.shape))
        self.owners, self.slots = owners, slots
        self.local_devices = [_device(d) for d in local_devices]
        self.rank = dist.get_rank()
        self.ranks = sorted(set(owners.ravel().tolist()))
        self._groups, self._group, self._lines = groups, group, {}
        self._stage = dist.get_backend() == "gloo"
        counts = {r: int((owners == r).sum()) for r in self.ranks}
        if len(set(counts.values())) != 1:
            raise ValueError(f"every rank must hold as many entries: {counts}")

    @property
    def devices(self) -> Tuple[torch.device, ...]:
        return tuple(self.local_devices[s] for o, s in zip(self.owners.ravel(), self.slots.ravel())
                     if o == self.rank)

    @property
    def size(self) -> int:
        return self.owners.size

    @property
    def indices(self) -> List[int]:
        return [i for i, o in enumerate(self.owners.ravel()) if o == self.rank]

    def along(self, axis: str) -> "ProcessMesh":
        """The line along ``axis`` through this process's first entry."""
        if axis not in self.axis_names:
            raise ValueError(f"mesh has no axis {axis!r}: {self.axis_names}")
        if self.axis_names == (axis,):
            return self
        if axis not in self._lines:
            ax = self.axis_names.index(axis)
            at = list(np.argwhere(self.owners == self.rank)[0])
            key = (axis,) + tuple(int(c) for i, c in enumerate(at) if i != ax)
            at[ax] = slice(None)
            self._lines[axis] = ProcessMesh(self.owners[tuple(at)], self.slots[tuple(at)],
                                            self.local_devices, (axis,), self._groups,
                                            self._groups.get(key))
        return self._lines[axis]

    # -- the exchange ------------------------------------------------------

    @property
    def _local(self) -> bool:
        return self.ranks == [self.rank]

    def _wire(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as sent: bool as uint8, in host memory under gloo."""
        w = t.to(torch.uint8) if t.dtype == torch.bool else t
        return (w.cpu() if self._stage else w).contiguous()

    def gather(self, bands: Sequence[torch.Tensor], dim: int = 0) -> torch.Tensor:
        if self._local:
            return super().gather(bands, dim)
        return torch.cat(list(self.all_gather(bands).unbind(0)), dim)

    def all_gather(self, parts: Sequence[torch.Tensor]) -> torch.Tensor:
        if self._local:
            return super().all_gather(parts)
        dev, dtype = self.devices[0], parts[0].dtype
        mine = self._wire(torch.stack([p.to(dev) for p in parts]))
        bufs = [torch.empty_like(mine) for _ in self.ranks]
        dist.all_gather(bufs, mine, group=self._group)
        owners = self.owners.ravel()
        out = [None] * self.size
        for r, buf in zip(self.ranks, bufs):
            for i, part in zip(np.flatnonzero(owners == r), buf.unbind(0)):
                out[i] = part
        return torch.stack(out).to(device=dev, dtype=dtype)

    def _reduce(self, parts, fold, op) -> torch.Tensor:
        acc = _fold(parts, self.devices[0], fold)
        if not self._local:
            w = self._wire(acc)
            dist.all_reduce(w, op=op, group=self._group)
            acc = w.to(device=acc.device, dtype=acc.dtype)
        return acc

    def psum(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.replicate(self._reduce(parts, torch.add, dist.ReduceOp.SUM))

    def pmin(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self.replicate(self._reduce(parts, torch.minimum, dist.ReduceOp.MIN))

    def any(self, flags: Sequence[torch.Tensor]) -> bool:
        mine = torch.stack([f.to(self.devices[0]) for f in flags]).any().to(torch.int32)
        return bool(self._reduce([mine], torch.maximum, dist.ReduceOp.MAX))

    def _shift(self, parts: Sequence[torch.Tensor], step: int) -> List[torch.Tensor]:
        """Part i receives part i − step (zeros where that is off the line):
        local parts are copied, the others sent and received in one batch."""
        if self._local:
            return super().shift_down(parts) if step == 1 else super().shift_up(parts)
        owners, n = self.owners.ravel(), self.size
        pos = {g: j for j, g in enumerate(self.indices)}
        out, recvs, ops = [], [], []
        for j, (g, d) in enumerate(zip(self.indices, self.devices)):
            src = g - step
            if not 0 <= src < n:
                out.append(torch.zeros_like(parts[j]).to(d))
            elif src in pos:
                out.append(parts[pos[src]].to(d))
            else:
                like = parts[j]
                buf = torch.empty(like.shape, device="cpu" if self._stage else like.device,
                                  dtype=torch.uint8 if like.dtype == torch.bool else like.dtype)
                ops.append(dist.P2POp(dist.irecv, buf, int(owners[src]), tag=g))
                recvs.append((j, buf))
                out.append(None)
        for j, g in enumerate(self.indices):
            dst = g + step
            if 0 <= dst < n and dst not in pos:
                ops.append(dist.P2POp(dist.isend, self._wire(parts[j]), int(owners[dst]),
                                      tag=dst))
        if ops:
            for req in dist.batch_isend_irecv(ops):
                req.wait()
        for j, buf in recvs:
            out[j] = buf.to(device=self.devices[j], dtype=parts[j].dtype)
        return out

    def shift_down(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._shift(parts, 1)

    def shift_up(self, parts: Sequence[torch.Tensor]) -> List[torch.Tensor]:
        return self._shift(parts, -1)

    def __repr__(self) -> str:
        return (f"ProcessMesh(rank {self.rank}, {[str(d) for d in self.devices]}, "
                f"axis_names={self.axis_names}, shape={tuple(self.shape.values())})")


def global_mesh(axis_names: Tuple[str, ...], shape: Optional[Tuple[int, ...]] = None,
                local_devices: Optional[Sequence] = None) -> ProcessMesh:
    """A mesh over every process's ``local_devices`` (one entry each; by
    default one entry on the current CUDA device), rank-major.  Without
    ``shape``: one axis over every entry, or for two axes (processes,
    entries per process).  Every rank must call this with the same
    arguments, in the same order: it makes the process groups of the lines
    that span some but not all ranks."""
    if local_devices is None:
        local_devices = [require_device(torch.device("cuda", torch.cuda.current_device())
                                        if torch.cuda.is_available() else None)]
    world, k = dist.get_world_size(), len(local_devices)
    if shape is None:
        if len(axis_names) == 1:
            shape = (world * k,)
        elif len(axis_names) == 2:
            shape = (world, k)
        else:
            raise ValueError("pass an explicit shape for more than 2 mesh axes")
    if int(np.prod(shape)) != world * k:
        raise ValueError(f"shape {shape} does not hold {world} ranks × {k} entries")
    owners = (np.arange(world * k) // k).reshape(shape)
    slots = (np.arange(world * k) % k).reshape(shape)
    groups = {}
    for ax, axis in enumerate(axis_names):
        others = [range(s) for i, s in enumerate(shape) if i != ax]
        for key in np.ndindex(*[len(r) for r in others]):
            at = list(key)
            at.insert(ax, slice(None))
            ranks = sorted(set(owners[tuple(at)].ravel().tolist()))
            if 1 < len(ranks) < world:
                groups[(axis,) + key] = dist.new_group(ranks)
    return ProcessMesh(owners, slots, local_devices, tuple(axis_names), groups)


def host_local_rows(mesh, axis: str, total_rows: int) -> Tuple[int, int]:
    """[start, stop) of the rows owned by THIS process's entries on the line
    along ``axis`` — what the host-local camera feed must stage."""
    m = mesh.along(axis)
    if total_rows % m.size:
        raise ValueError(f"rows={total_rows} not divisible by {axis}={m.size}")
    band = total_rows // m.size
    return m.indices[0] * band, (m.indices[-1] + 1) * band


def put_row_sharded(local_rows: np.ndarray, mesh, axis: str, total_rows: int) -> List[torch.Tensor]:
    """This process's row bands, on its devices, from the rows it staged
    (``host_local_rows``); a copy, so the staging buffer may be reused."""
    m = mesh.along(axis)
    lo, hi = host_local_rows(mesh, axis, total_rows)
    if local_rows.shape[0] != hi - lo:
        raise ValueError(f"{local_rows.shape[0]} local rows for the range [{lo}, {hi})")
    x = torch.from_numpy(np.array(local_rows))
    band = total_rows // m.size
    return [x[g * band - lo:(g + 1) * band - lo].to(d) for g, d in zip(m.indices, m.devices)]


# ---------------------------------------------------------------------------
# The worker: the sharded dense step, the sharded pipeline and the
# distributed BA over process-spanning meshes, printing checksums.
# ---------------------------------------------------------------------------


def digest(disp: torch.Tensor, valid: torch.Tensor) -> str:
    """``sum(disparity where valid) count sha1`` of whole outputs."""
    d, v = disp.cpu(), valid.cpu()
    h = hashlib.sha1(d.numpy().tobytes() + v.numpy().tobytes()).hexdigest()[:16]
    return f"{float(torch.where(v, d, 0.0).sum()):.3f} {int(v.sum())} {h}"


def worker_lines(rows_mesh, kf_mesh, *, rows: int = 64, width: int = 96, ndisp: int = 16,
                 block: int = 5, texture: int = 5, speckle_size: int = 8,
                 speckle_diff: float = 1.0, fps_iters: int = 10) -> Iterator[str]:
    """The worker's checks over a ``rows`` mesh and a ``kf`` mesh (a process
    mesh, or one process's ``Mesh`` for the reference run), one line each:

      * ``DENSE``: the row-band matcher and speckle filter, fed host-locally
        through the native ``FrameRing`` (the frame's rows of this
        process's bands only);
      * ``FPS``: frames per second of that step on this process's clock;
      * ``PIPE``: the whole ``StereoPipeline(mesh=rows_mesh)``, outputs
        gathered whole on every process;
      * ``BA``: rms before and after 3 iterations of ``bundle_adjust_sharded``
        over ``kf_mesh`` (8 landmarks per entry);
      * ``LAUNCHES``: this process's kernel launches over all of the above.
    """
    from ros_gpu_stereo_processor_tpu_torch.config import (
        Outputs, PipelineConfig, SpeckleConfig, StereoBMConfig)
    from ros_gpu_stereo_processor_tpu_torch.models.pipeline import StereoPipeline
    from ros_gpu_stereo_processor_tpu_torch.ops import _build
    from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import (
        bundle_adjust_sharded, synthetic_problem)
    from ros_gpu_stereo_processor_tpu_torch.parallel.frontend import (
        disparity_row_sharded, filter_speckles_row_sharded)
    from ros_gpu_stereo_processor_tpu_torch.runtime import FrameRing
    from ros_gpu_stereo_processor_tpu_torch.utils.calib import CameraCalib, StereoCameraModel

    _build.reset_launch_counts()
    H, W = rows, width
    cfg = StereoBMConfig(num_disparities=ndisp, block_size=block, texture_threshold=texture)
    rng = np.random.default_rng(0)     # the same stream everywhere; sliced locally
    left = rng.integers(0, 255, (H, W), np.uint8)
    right = rng.integers(0, 255, (H, W), np.uint8)
    lo, hi = host_local_rows(rows_mesh, "rows", H)
    ring = FrameRing(2, (hi - lo, W))
    ring.push(left[lo:hi], right[lo:hi])
    l_loc, r_loc, _, _ = ring.peek()
    L = put_row_sharded(l_loc, rows_mesh, "rows", H)
    R = put_row_sharded(r_loc, rows_mesh, "rows", H)
    ring.release()

    def step():
        d, v = disparity_row_sharded(L, R, cfg, rows_mesh)
        return filter_speckles_row_sharded(d, v, rows_mesh, max_speckle_size=speckle_size,
                                           max_diff=speckle_diff, iters=8, merge_rounds=2)

    line = rows_mesh.along("rows")
    d, v = step()
    yield "DENSE " + digest(line.gather(d), line.gather(v))

    sync = [x for x in line.unique_devices() if x.type == "cuda"]
    for _ in range(2):
        step()
    for x in sync:
        torch.cuda.synchronize(x)
    t0 = time.perf_counter()
    for _ in range(fps_iters):
        step()
    for x in sync:
        torch.cuda.synchronize(x)
    yield f"FPS {fps_iters / (time.perf_counter() - t0):.2f}"

    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -8.0
    model = StereoCameraModel.from_calibs(
        *(CameraCalib(W, H, K, np.zeros(5), np.eye(3), PP, nm)
          for PP, nm in ((P, "left"), (Pr, "right"))))
    pipe = StereoPipeline(model, PipelineConfig(
        stereobm=cfg, speckle=SpeckleConfig(max_speckle_size=speckle_size,
                                            max_diff=speckle_diff, propagation_iters=8)),
        mesh=rows_mesh)
    out = pipe.process(left, right, Outputs.of("disparity", "pointcloud")).fetch()
    pipe.senders.shutdown()
    yield "PIPE " + digest(torch.from_numpy(out["disparity"]),
                           torch.from_numpy(out["disparity_valid"]))

    kf_line = kf_mesh.along("kf")
    prob = synthetic_problem(rng, 3, 8 * kf_line.size, kf_line.devices[0])
    _, hist = bundle_adjust_sharded(prob, kf_mesh, iters=3)
    yield f"BA {float(hist[0]):.6e} {float(hist[-1]):.6e}"
    yield "LAUNCHES " + json.dumps({s: k.launches for s, k in sorted(_build.kernels().items())})


def _worker(args) -> int:
    dev = initialize(args.init_method, args.world_size, args.rank, args.backend, args.device,
                     args.timeout)
    try:
        print(f"BACKEND {dist.get_backend()} {dev}", flush=True)
        local = [dev] * args.bands_per_process
        rows_mesh = global_mesh(("rows",), local_devices=local)
        kf_mesh = global_mesh(("kf",), local_devices=local)
        for line in worker_lines(rows_mesh, kf_mesh, rows=args.rows, width=args.width,
                                 ndisp=args.ndisp, block=args.block,
                                 texture=args.texture_threshold,
                                 speckle_size=args.speckle_size,
                                 speckle_diff=args.speckle_diff, fps_iters=args.fps_iters):
            print(line, flush=True)
    finally:
        shutdown()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one process of a multi-process run")
    ap.add_argument("--init-method", required=True, help="e.g. tcp://127.0.0.1:29500")
    ap.add_argument("--world-size", type=int, required=True)
    ap.add_argument("--rank", type=int, required=True)
    ap.add_argument("--backend", choices=["gloo", "nccl"], default="gloo")
    ap.add_argument("--device", default=None, help="cuda[:i] (default) or cpu")
    ap.add_argument("--bands-per-process", type=int, default=2)
    ap.add_argument("--timeout", type=float, default=120.0,
                    help="seconds the process group waits for a peer")
    ap.add_argument("--rows", type=int, default=64)
    ap.add_argument("--width", type=int, default=96)
    ap.add_argument("--ndisp", type=int, default=16)
    ap.add_argument("--block", type=int, default=5)
    ap.add_argument("--texture-threshold", type=int, default=5)
    ap.add_argument("--speckle-size", type=int, default=8)
    ap.add_argument("--speckle-diff", type=float, default=1.0)
    ap.add_argument("--fps-iters", type=int, default=10)
    return _worker(ap.parse_args(argv))


if __name__ == "__main__":
    raise SystemExit(main())
