"""CUDA graph capture and replay: the port's counterpart of ``jax.jit``.

The JAX package compiles its frame step once per variant
(``models/pipeline.py::_get_variant``, the row-band mesh step included), a
batch of frames into one dispatch (``process_batch``, ``jit(lax.scan)``),
the VO step (``models/vo.py``'s jitted ``_vo_core``) and the windowed BA
solve (``models/ba.py``).  Run eagerly, each is one host launch per kernel
and copy; :class:`Captured` records such a function's launches once as a
CUDA graph and then enqueues the whole step with one graph launch.  Its
users: the frame step on one card or on a mesh whose band line is one
card, ``process_batch``, the VO step, ``models/slam.py``'s BA solve per
window shape (the landmark-sharded solve too, on a ``kf`` line that is one
card), and :func:`batch_runner`: a batch of frames reduced to checksums,
the unit the scaling harness (parallel/scaling.py), the A/B harness
(:func:`ab`) and the bench time.

  * One graph per input signature (the shape and dtype of every tensor
    input, and the device), captured at the first call with it.  That call
    runs the function eagerly on a side stream first (it loads the kernel
    library and every kernel, fills the kernels' occupancy caches and the
    libraries' handles and workspaces, and settles the allocator) and
    returns that run's outputs; then it captures, with
    ``capture_error_mode="thread_local"`` so that other threads (SLAM's
    mapping thread, the publishers) keep launching meanwhile, and with the
    garbage collector held off (a collection that destroyed an earlier
    graph inside the capture would invalidate it).  Two threads never
    capture at once.
  * Every later call copies its inputs into the graph's static input
    buffers (a host input through a pinned staging copy made by the host
    before the call returns, utils/hostcopy.py; a tensor device to device),
    replays the graph and copies the outputs out.
  * Outputs never alias a later replay, as JAX returns fresh buffers on
    every call: inside the graph every output is copied into one byte
    arena, and each replay clones the arena (one device copy) and returns
    views of the clone.  A result may be held across any number of frames.
  * Kernel launch counts (``ops/_build.py``): the capture records each
    wrapper's launches and adds nothing; every replay adds them.
  * A capture that fails raises :class:`CaptureError` naming the function
    and the line of the op that failed.  Nothing runs the eager function
    in a graph's place on the card.

On the CPU (inputs, or the given device, not CUDA) the function is simply
called: graphs are a CUDA mechanism.

What a captured function may do: launch kernels and copies on the current
stream, allocate (from the graph's private memory pool) and read its
inputs; it may not read anything back to the host, copy from pageable host
memory or branch on device values, all of which the eager step avoids
already.  Values it reads from Python (configs, camera scalars) are baked
into the graph, so they belong in the owner's cache key.
"""

from __future__ import annotations

import gc
import os
import threading
import time
import traceback
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils import _pytree as pytree

from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.utils.hostcopy import staged

_ALIGN = 64   # bytes: every output's offset in the arena
# one capture at a time in the process: a capture's start synchronizes the
# device and empties the allocator's cache (torch.cuda.graph), which must
# not fall inside another thread's capture (SLAM's mapping thread captures
# its BA windows while the tracking thread may capture a new variant)
_capture_lock = threading.Lock()


class CaptureError(RuntimeError):
    """A CUDA graph capture failed; the message names the op."""


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    if isinstance(x, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(x))
    raise TypeError(f"a captured function takes tensors and numpy arrays, not {type(x)}")


def _origin(e: BaseException) -> str:
    """Where ``e`` was raised: the innermost frame outside PyTorch and this
    module (the op of the captured function that failed)."""
    frames = traceback.extract_tb(e.__traceback__)
    ours = [f for f in frames
            if f"{os.sep}torch{os.sep}" not in f.filename and f.filename != __file__]
    if not ours:
        return "capture end"
    f = ours[-1]
    return f"{Path(f.filename).name}:{f.lineno} ({(f.line or '').strip()})"


def _pack(out) -> Tuple[Optional[torch.Tensor], list, Any]:
    """Copy every tensor of the pytree ``out`` into one fresh uint8 arena:
    (arena, leaf layout, tree spec).  A layout entry is (offset, dtype,
    shape) for a tensor, or ``(None, value)`` for any other leaf."""
    leaves, spec = pytree.tree_flatten(out)
    layout, total = [], 0
    for x in leaves:
        if isinstance(x, torch.Tensor):
            layout.append((total, x.dtype, tuple(x.shape)))
            total += -(-x.numel() * x.element_size() // _ALIGN) * _ALIGN
        else:
            layout.append((None, x))
    tensors = [x for x in leaves if isinstance(x, torch.Tensor)]
    if not tensors:
        return None, layout, spec
    arena = torch.empty(total, dtype=torch.uint8, device=tensors[0].device)
    for x, entry in zip(leaves, layout):
        if entry[0] is not None and x.numel():
            _view(arena, *entry).copy_(x)
    return arena, layout, spec


def _view(arena: torch.Tensor, offset: int, dtype: torch.dtype, shape) -> torch.Tensor:
    n = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
    return arena[offset:offset + n].view(dtype).view(shape)


def _unpack(arena: Optional[torch.Tensor], layout: list, spec) -> Any:
    leaves = [_view(arena, *entry) if entry[0] is not None else entry[1]
              for entry in layout]
    return pytree.tree_unflatten(leaves, spec)


class _Graph:
    """One captured graph: static inputs, the output arena and its layout,
    and the kernel launches one replay makes."""

    def __init__(self, name: str, fn: Callable, inputs: List[torch.Tensor],
                 spec, device: torch.device):
        self.name, self.fn, self.spec, self.device = name, fn, spec, device
        self.inputs = [torch.empty(x.shape, dtype=x.dtype, device=device) for x in inputs]
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.arena = None
        self.layout: list = []
        self.out_spec = None
        self.launches = None

    def _load(self, inputs: List[torch.Tensor]) -> None:
        for buf, x in zip(self.inputs, inputs):
            buf.copy_(staged(x) if x.device.type == "cpu" else x, non_blocking=True)

    def _call(self):
        return self.fn(*pytree.tree_unflatten(self.inputs, self.spec))

    def first(self, inputs: List[torch.Tensor]):
        """The first call: the eager run on a side stream (returned), then
        the capture."""
        self._load(inputs)
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            arena, layout, out_spec = _pack(self._call())
        cur.wait_stream(side)
        if arena is not None:
            arena.record_stream(cur)
        self._capture()
        return _unpack(arena, layout, out_spec)

    def _capture(self) -> None:
        graph = torch.cuda.CUDAGraph()
        failure: Optional[BaseException] = None
        # a garbage collection inside the capture may destroy an earlier
        # graph, whose teardown (frees) the capturing thread may not call:
        # hold the collector off until the capture ends
        collecting = gc.isenabled()
        gc.disable()
        try:
            with _capture_lock, _build.recording() as launches, torch.cuda.graph(
                    graph, capture_error_mode="thread_local"):
                try:
                    self.arena, self.layout, self.out_spec = _pack(self._call())
                except Exception as e:   # noqa: BLE001 — reported below, with the op
                    failure = e
        except Exception as e:   # noqa: BLE001 — the capture's end refused it
            failure = failure or e
        finally:
            if collecting:
                gc.enable()
        if failure is not None:
            graph = None    # not kept alive by the traceback below
            raise CaptureError(
                f"{self.name}: CUDA graph capture failed at {_origin(failure)}: "
                f"{type(failure).__name__}: {failure}") from failure
        self.graph, self.launches = graph, launches

    def replay(self, inputs: List[torch.Tensor]):
        self._load(inputs)
        self.graph.replay()
        _build.add_launches(self.launches)
        arena = None if self.arena is None else self.arena.clone()
        return _unpack(arena, self.layout, self.out_spec)


class Captured:
    """``fn`` captured as one CUDA graph per input signature and replayed.

    ``fn`` takes a pytree (tensors, dicts, tuples, NamedTuples) of tensors
    and returns one; call the wrapper with the same structure, where numpy
    arrays may stand for tensors.  ``device``: where the graph runs and
    host inputs are copied to; by default the device of the first tensor
    input.  On a device that is not CUDA, ``fn`` is called directly (numpy
    inputs as tensors on that device).  Calls are serialized by a lock and
    enqueued on the caller's current stream; a caller that replays one
    wrapper from several streams orders those streams itself."""

    def __init__(self, fn: Callable, device=None, name: Optional[str] = None):
        self.fn = fn
        self.device = None if device is None else torch.device(device)
        self.name = name or getattr(fn, "__qualname__", repr(fn))
        self._graphs: Dict[tuple, _Graph] = {}
        self._lock = threading.Lock()

    def _device(self, leaves) -> torch.device:
        if self.device is not None:
            return self.device
        for x in leaves:
            if isinstance(x, torch.Tensor):
                return x.device
        return torch.device("cpu")

    def __call__(self, *args):
        leaves, spec = pytree.tree_flatten(args)
        leaves = [_as_tensor(x) for x in leaves]
        dev = self._device(leaves)
        if dev.type != "cuda":
            return self.fn(*pytree.tree_unflatten([x.to(dev) for x in leaves], spec))
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        key = (dev, str(spec)) + tuple((tuple(x.shape), x.dtype) for x in leaves)
        with self._lock, torch.cuda.device(dev):
            g = self._graphs.get(key)
            if g is None:
                g = _Graph(self.name, self.fn, leaves, spec, dev)
                out = g.first(leaves)
                self._graphs[key] = g
                return out
            return g.replay(leaves)

    def graph_count(self) -> int:
        """Graphs captured so far (one per input signature)."""
        return len(self._graphs)


def checksum(out) -> torch.Tensor:
    """One float32 number for a frame's outputs, as the JAX harnesses reduce
    them (``scripts/abbench.py::make_runner``, the JAX bench): the sum over
    the tensor leaves of ``out`` (a pytree; a dict in insertion order) of
    each leaf's float32 sum with NaN as 0 and ±inf as the largest finite
    values (``jnp.nan_to_num``), added from 0 in leaf order, on the first
    leaf's device."""
    leaves = [x for x in pytree.tree_leaves(out) if isinstance(x, torch.Tensor)]
    dev = leaves[0].device
    return sum(torch.nan_to_num(x.to(torch.float32)).sum().to(dev) for x in leaves)


def batch_runner(fn: Callable, device=None, name: Optional[str] = None) -> Captured:
    """A batch of frames as one compiled dispatch: the port's counterpart of
    the JAX harnesses' jitted ``lax.scan`` over the batch
    (``scripts/abbench.py::make_runner``, ``parallel/scaling.py``'s ``run``).

    Returns a :class:`Captured` function of (B, H, W) ``lefts`` and
    ``rights`` stacks that applies ``fn(left, right)`` to each frame and
    returns the (B,) stack of each frame's :func:`checksum`.  On the card a
    batch is one graph replay per input shape, with :class:`Captured`'s
    rules (a capture that fails raises :class:`CaptureError`; nothing runs
    eagerly in the graph's place); on the CPU it is the function.  The
    eager batch is ``.fn``: the reference of the graph, and the step of a
    caller whose frames span several devices."""
    def run(lefts, rights):
        return torch.stack([checksum(fn(lefts[i], rights[i])) for i in range(lefts.shape[0])])

    return Captured(run, device, name=name or f"batch {getattr(fn, '__qualname__', fn)}")


def ab(candidates: Dict[str, Callable], lefts, rights, trials: int = 6,
       reps: int = 3) -> Dict[str, Dict[str, float]]:
    """Interleaved A/B timing, the port of ``scripts/abbench.py::ab``.

    ``candidates``: {name: fn(left, right) -> pytree}.  Each becomes a
    :func:`batch_runner` on the device of ``lefts``; each runner is called
    twice first (the eager run and the capture, then a replay).  Then
    ``trials`` rounds take the candidates round-robin, so that a slow phase
    of the host or the card hits every candidate alike: in each round,
    ``reps`` calls of a candidate, each ending in one host read of its
    batch's checksum, timed on the host's clock.  A candidate's time is
    the minimum over the rounds of the mean call.  Prints and returns
    {name: {"ms_per_frame", "fps"}}."""
    B = lefts.shape[0]
    runners = {}
    for name, fn in candidates.items():
        run = batch_runner(fn, lefts.device, name=name)
        float(run(lefts, rights).sum())
        float(run(lefts, rights).sum())
        runners[name] = run
    best = {name: float("inf") for name in runners}
    for _ in range(trials):
        for name, run in runners.items():
            t0 = time.perf_counter()
            for _ in range(reps):
                float(run(lefts, rights).sum())
            best[name] = min(best[name], (time.perf_counter() - t0) / reps)
    out = {}
    for name, dt in best.items():
        out[name] = {"ms_per_frame": dt / B * 1e3, "fps": B / dt}
        print(f"{name:36s} {out[name]['ms_per_frame']:8.3f} ms/frame  "
              f"({out[name]['fps']:7.1f} fps)")
    return out
