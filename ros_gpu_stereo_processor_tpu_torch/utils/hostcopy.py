"""Copies between the card and host memory: the publish path's device→host
copies, and host frames staged for the card.

The reference publishes from page-locked ``HostMem`` buffers filled on a
stream (src/GPUStereoProcessor.cpp:89-117, 174-188); the JAX package starts
every output's ``copy_to_host_async`` on the thread that enqueues the
publish (``utils/msgs.py::SenderPool.enqueue``).  Here:

  * :func:`start_host_copy` starts the copies of a set of tensors on the
    calling thread and returns at once.  CUDA tensors are copied on their
    device's copy stream (:func:`copy_stream`), ordered after the ``ready``
    events (or after the caller's current stream), into pinned host tensors
    from PyTorch's caching host allocator (so steady-state frames allocate
    no page-locked memory), with one event recorded after the last copy.
    Each source is marked as used on the copy stream (``record_stream``):
    its owner may drop it at once, and the caching allocator does not hand
    its memory to later work before the copy has read it.
  * :meth:`HostCopy.result` waits on that event only, never on the device,
    and returns numpy views of the pinned tensors.  A view keeps its tensor
    alive, so a message that holds one is never overwritten by a later
    frame.
  * :func:`upload` and :func:`staged`: a host tensor bound for the card is
    first copied by the host into a pinned tensor, then copied with
    ``non_blocking=True`` on the current stream; the caller may reuse its
    array as soon as the call returns (the caching host allocator keeps
    the pinned block until the copy has run).

CPU tensors keep their plain behaviour (:func:`to_host`, ``Tensor.to``).
A failed pinned allocation or copy raises; nothing falls back to pageable
memory.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence, Tuple, Union

import numpy as np
import torch

Events = Union[None, "torch.cuda.Event", Sequence[Optional["torch.cuda.Event"]]]

# one copy stream per device, shared by every copy in the process (as the
# device itself is); made at first use
_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
_streams_lock = threading.Lock()


def to_host(x) -> np.ndarray:
    """A tensor (or array) as a host numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def copy_stream(device) -> "torch.cuda.Stream":
    """The copy stream of a CUDA ``device``.  It comes from PyTorch's
    high-priority stream pool: a pool stream is non-blocking against the
    legacy default stream (so a copy never waits on the whole device), and
    a high-priority one is never the default-priority pool stream a CUDA
    graph capture runs on (``torch.cuda.graph``), which another thread's
    copy must not join."""
    device = torch.device(device)
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    with _streams_lock:
        s = _streams.get(device)
        if s is None:
            s = _streams[device] = torch.cuda.Stream(device, priority=-1)
        return s


class HostCopy:
    """Host copies started by :func:`start_host_copy`: ``host`` holds a
    pinned tensor per CUDA source (a numpy array per host source), and
    ``event`` is recorded after the last copy (None when nothing was
    copied from a card)."""

    def __init__(self, host: tuple, event: Optional["torch.cuda.Event"]):
        self.host = host
        self.event = event

    def part(self, start: int, stop: int) -> "HostCopy":
        """Copies ``start`` to ``stop`` (exclusive), under the same event."""
        return HostCopy(self.host[start:stop], self.event)

    def ready(self) -> bool:
        """True when the copies have landed (or none was from a card)."""
        return self.event is None or self.event.query()

    def result(self) -> Tuple[np.ndarray, ...]:
        """Wait for the copies' event and return the arrays, in the order
        of the sources."""
        if self.event is not None:
            self.event.synchronize()
        return tuple(h.numpy() if isinstance(h, torch.Tensor) else h for h in self.host)


def start_host_copy(tensors, ready: Events = None) -> HostCopy:
    """Start the device→host copies of ``tensors`` (a tensor or a sequence
    of them, all CUDA ones on one device) and return at once.  ``ready``: an
    event or a sequence of events (None entries skipped) the copies are
    ordered after; without one, the copies follow the work enqueued so far
    on the caller's current stream."""
    srcs = tuple(tensors) if isinstance(tensors, (tuple, list)) else (tensors,)
    devices = {t.device for t in srcs if isinstance(t, torch.Tensor) and t.is_cuda}
    if not devices:
        return HostCopy(tuple(to_host(t) for t in srcs), None)
    if len(devices) > 1:
        raise ValueError(f"one host copy takes tensors of one device, not {sorted(map(str, devices))}")
    (device,) = devices
    stream = copy_stream(device)
    if ready is None or isinstance(ready, torch.cuda.Event):
        ready = (ready,)
    events = [e for e in ready if e is not None]
    for e in events:
        stream.wait_event(e)
    if not events:
        stream.wait_stream(torch.cuda.current_stream(device))
    host = []
    with torch.cuda.stream(stream):
        for t in srcs:
            if isinstance(t, torch.Tensor) and t.is_cuda:
                t = t.detach()
                t.record_stream(stream)
                h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                h.copy_(t, non_blocking=True)
                host.append(h)
            else:
                host.append(to_host(t))
        done = torch.cuda.Event()
        done.record(stream)
    return HostCopy(tuple(host), done)


def staged(x: torch.Tensor) -> torch.Tensor:
    """A pinned copy of the host tensor ``x``, made by the host now."""
    p = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    p.copy_(x)
    return p


def upload(x, device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) on ``device``.  A host source bound
    for a CUDA device goes through :func:`staged` and a non-blocking copy on
    the current stream."""
    t = x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x))
    device = torch.device(device)
    if device.type != "cuda" or t.device.type != "cpu":
        return t.to(device)
    return staged(t).to(device, non_blocking=True)
