"""Frame-ingest runtime: ctypes bindings to the native C++ ring/pairer.

The port of ``ros_gpu_stereo_processor_tpu/runtime/ingest.py``.  The
reference's ingest path — message_filters synchronizers feeding pinned
``HostMem`` staging buffers (SURVEY.md §2.4/§2.16) — is C++; so is this
one: ``native/frame_ring.cpp`` (the repo's native ring, shared with the JAX
package) provides

  * :class:`FrameRing` — fixed-capacity staging ring with drop-on-overflow
    (the ``queue_size`` semantics) and zero-copy consumption: ``peek()``
    returns numpy views into the ring slot; ``release()`` recycles the slot;
  * :class:`StereoPairer` — Exact/ApproximateTime timestamp pairing in
    native code (producer threads never hold the GIL);
  * :class:`StreamingIngest` — pairer → ring, and a device double buffer:
    ``frames()`` yields device tensors while the next pair stages, and
    ``frames_prefetch()`` stages pairs on an uploader thread through pinned
    host buffers and its own CUDA stream.

The library is compiled with ``g++`` at first use into the package's
git-ignored ``build/`` directory, under a name keyed by a hash of the
source, and loaded with ctypes; on a machine with no compiler the
pure-Python ring and pairer of the same API run instead
(:func:`native_available` says which).  ``StreamingIngest`` stages onto the
card unless the caller asks for ``device="cpu"``.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import queue
import subprocess
import tempfile
import threading
from collections import deque
from pathlib import Path
from typing import Iterator, Optional, Tuple

import numpy as np
import torch

from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device

_PKG = Path(__file__).resolve().parent.parent
NATIVE_SRC = _PKG.parent / "native" / "frame_ring.cpp"
BUILD_DIR = _PKG / "build"
CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-fPIC", "-shared")

_lock = threading.Lock()
_lib = None
_lib_err: Optional[str] = None


def _build_lib() -> Path:
    """Compile ``native/frame_ring.cpp`` unless the library for this source
    and these flags exists; returns its path."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(NATIVE_SRC.read_bytes())
    out = BUILD_DIR / f"libframe_ring_{h.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build under a private name, then rename: a concurrent build never
    # loads a half-written library
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as work:
        tmp = os.path.join(work, "lib.so")
        subprocess.run([os.environ.get("CXX", "g++"), *CXX_FLAGS, str(NATIVE_SRC), "-o", tmp],
                       check=True, capture_output=True, timeout=120)
        os.replace(tmp, out)
    return out


def _load_lib():
    global _lib, _lib_err
    with _lock:
        if _lib is not None or _lib_err is not None:
            return _lib
        try:
            lib = ctypes.CDLL(str(_build_lib()))
        except (OSError, subprocess.SubprocessError) as e:   # no toolchain
            _lib_err = str(e)
            return None
        u8p = ctypes.POINTER(ctypes.c_uint8)
        lib.ring_create.restype = ctypes.c_void_p
        lib.ring_create.argtypes = [ctypes.c_size_t, ctypes.c_size_t, ctypes.c_int]
        lib.ring_destroy.argtypes = [ctypes.c_void_p]
        lib.ring_size.restype = ctypes.c_size_t
        lib.ring_size.argtypes = [ctypes.c_void_p]
        for f in ("ring_pushed", "ring_popped", "ring_dropped"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        lib.ring_push.restype = ctypes.c_int
        lib.ring_push.argtypes = [ctypes.c_void_p, u8p, u8p, ctypes.c_double,
                                  ctypes.c_uint64, ctypes.c_double]
        lib.ring_peek.restype = ctypes.c_int
        lib.ring_peek.argtypes = [ctypes.c_void_p, ctypes.POINTER(u8p), ctypes.POINTER(u8p),
                                  ctypes.POINTER(ctypes.c_double),
                                  ctypes.POINTER(ctypes.c_uint64), ctypes.c_double]
        lib.ring_release.argtypes = [ctypes.c_void_p]
        lib.ring_pop.restype = ctypes.c_int
        lib.ring_pop.argtypes = [ctypes.c_void_p, u8p, u8p, ctypes.POINTER(ctypes.c_double),
                                 ctypes.POINTER(ctypes.c_uint64), ctypes.c_double]
        lib.pairer_create.restype = ctypes.c_void_p
        lib.pairer_create.argtypes = [ctypes.c_double, ctypes.c_int, ctypes.c_size_t,
                                      ctypes.c_size_t]
        lib.pairer_destroy.argtypes = [ctypes.c_void_p]
        lib.pairer_add.argtypes = [ctypes.c_void_p, ctypes.c_int, u8p, ctypes.c_double]
        lib.pairer_get.restype = ctypes.c_int
        lib.pairer_get.argtypes = [ctypes.c_void_p, u8p, u8p, ctypes.POINTER(ctypes.c_double)]
        for f in ("pairer_paired", "pairer_dropped"):
            getattr(lib, f).restype = ctypes.c_uint64
            getattr(lib, f).argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_available() -> bool:
    """True when the native ring and pairer run (the library built and
    loaded); False when the pure-Python versions stand in."""
    return _load_lib() is not None


def _u8ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


class FrameRing:
    """Fixed-capacity stereo staging ring of uint8 pairs (native when
    possible)."""

    def __init__(self, capacity: int, shape: Tuple[int, ...], drop_on_full: bool = True):
        self.shape = tuple(shape)
        self.image_bytes = int(np.prod(shape))
        self.capacity = capacity
        self._lib = _load_lib()
        if self._lib is not None:
            self._h = self._lib.ring_create(capacity, self.image_bytes,
                                            1 if drop_on_full else 0)
            self._peeking = False
        else:
            self._q: deque = deque()
            self._drop_on_full = drop_on_full
            self._lock = threading.Lock()
            self._nonempty = threading.Condition(self._lock)
            self._stats = {"pushed": 0, "popped": 0, "dropped": 0}

    # -- producer -----------------------------------------------------------
    def push(self, left: np.ndarray, right: np.ndarray, stamp: float = 0.0,
             seq: int = 0, timeout: float = -1.0) -> bool:
        l = np.ascontiguousarray(left, dtype=np.uint8)
        r = np.ascontiguousarray(right, dtype=np.uint8)
        if l.size != self.image_bytes or r.size != self.image_bytes:
            raise ValueError(f"frame of {l.size}/{r.size} bytes for a ring of "
                             f"{self.image_bytes}-byte slots {self.shape}")
        if self._lib is not None:
            return bool(self._lib.ring_push(self._h, _u8ptr(l), _u8ptr(r), stamp, seq,
                                            timeout))
        with self._nonempty:
            if len(self._q) >= self.capacity:
                if self._drop_on_full:
                    self._stats["dropped"] += 1
                    return False
                # blocking semantics (as the native ring): wait for a slot
                if not self._nonempty.wait_for(lambda: len(self._q) < self.capacity,
                                               None if timeout < 0 else timeout):
                    return False
            self._q.append((l.copy(), r.copy(), stamp, seq))
            self._stats["pushed"] += 1
            self._nonempty.notify()
            return True

    # -- consumer -----------------------------------------------------------
    def peek(self, timeout: float = -1.0):
        """Zero-copy view of the oldest pair: (left, right, stamp, seq) or
        None.  Call :meth:`release` when done with the views."""
        if self._lib is not None:
            if self._peeking:
                raise RuntimeError("peek/release must alternate")
            pl = ctypes.POINTER(ctypes.c_uint8)()
            pr = ctypes.POINTER(ctypes.c_uint8)()
            stamp = ctypes.c_double()
            seq = ctypes.c_uint64()
            if not self._lib.ring_peek(self._h, ctypes.byref(pl), ctypes.byref(pr),
                                       ctypes.byref(stamp), ctypes.byref(seq), timeout):
                return None
            self._peeking = True
            l = np.ctypeslib.as_array(pl, shape=(self.image_bytes,)).reshape(self.shape)
            r = np.ctypeslib.as_array(pr, shape=(self.image_bytes,)).reshape(self.shape)
            return l, r, stamp.value, seq.value
        with self._nonempty:
            if not self._q:
                if timeout == 0:
                    return None
                if not self._nonempty.wait_for(lambda: bool(self._q),
                                               None if timeout < 0 else timeout):
                    return None
            l, r, stamp, seq = self._q[0]
            return l.reshape(self.shape), r.reshape(self.shape), stamp, seq

    def release(self) -> None:
        if self._lib is not None:
            if not self._peeking:
                raise RuntimeError("release without peek")
            self._lib.ring_release(self._h)
            self._peeking = False
        else:
            with self._nonempty:
                self._q.popleft()
                self._stats["popped"] += 1
                self._nonempty.notify_all()

    def pop(self, timeout: float = -1.0):
        """Copy-out consume: (left, right, stamp, seq) or None."""
        got = self.peek(timeout)
        if got is None:
            return None
        l, r, stamp, seq = got
        out = (l.copy(), r.copy(), stamp, seq)
        self.release()
        return out

    # -- stats (the reference's observability-by-log, SURVEY.md §5.5) -------
    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ring_size(self._h))
        return len(self._q)

    def stats(self) -> dict:
        if self._lib is not None:
            return {"pushed": int(self._lib.ring_pushed(self._h)),
                    "popped": int(self._lib.ring_popped(self._h)),
                    "dropped": int(self._lib.ring_dropped(self._h))}
        return dict(self._stats)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.ring_destroy(self._h)
            self._h = None


class StereoPairer:
    """Exact/ApproximateTime stereo pairing (message_filters equivalent)."""

    def __init__(self, shape: Tuple[int, ...], exact: bool = True,
                 slop: float = 0.01, queue_size: int = 5):
        self.shape = tuple(shape)
        self.image_bytes = int(np.prod(shape))
        self._lib = _load_lib()
        if self._lib is not None:
            self._h = self._lib.pairer_create(slop, 1 if exact else 0, self.image_bytes,
                                              queue_size)
        else:
            self._exact = exact
            self._slop = slop
            self._queue_size = queue_size
            self._left: deque = deque()
            self._right: deque = deque()
            self._lock = threading.Lock()
            self._stats = {"paired": 0, "dropped": 0}

    def add(self, side: str, image: np.ndarray, stamp: float) -> None:
        img = np.ascontiguousarray(image, dtype=np.uint8)
        if img.size != self.image_bytes:
            raise ValueError(f"{side} image of {img.size} bytes for a pairer of "
                             f"{self.shape}")
        s = 0 if side == "left" else 1
        if self._lib is not None:
            self._lib.pairer_add(self._h, s, _u8ptr(img), stamp)
            return
        with self._lock:
            q = self._left if s == 0 else self._right
            q.append((img.copy(), stamp))
            if len(q) > self._queue_size:
                q.popleft()
                self._stats["dropped"] += 1

    def get(self):
        """(left, right, stamp) or None."""
        if self._lib is not None:
            l = np.empty(self.image_bytes, np.uint8)
            r = np.empty(self.image_bytes, np.uint8)
            stamp = ctypes.c_double()
            if not self._lib.pairer_get(self._h, _u8ptr(l), _u8ptr(r), ctypes.byref(stamp)):
                return None
            return l.reshape(self.shape), r.reshape(self.shape), stamp.value
        with self._lock:
            while self._left and self._right:
                tl = self._left[0][1]
                tr = self._right[0][1]
                match = tl == tr if self._exact else abs(tl - tr) <= self._slop
                if match:
                    if (not self._exact and len(self._right) > 1
                            and abs(self._right[1][1] - tl) < abs(tr - tl)):
                        self._right.popleft()
                        continue
                    l = self._left.popleft()[0]
                    r = self._right.popleft()[0]
                    self._stats["paired"] += 1
                    return l.reshape(self.shape), r.reshape(self.shape), tl
                if tl < tr:
                    self._left.popleft()
                else:
                    self._right.popleft()
                self._stats["dropped"] += 1
            return None

    def stats(self) -> dict:
        if self._lib is not None:
            return {"paired": int(self._lib.pairer_paired(self._h)),
                    "dropped": int(self._lib.pairer_dropped(self._h))}
        return dict(self._stats)

    def __del__(self):
        if getattr(self, "_lib", None) is not None and getattr(self, "_h", None):
            self._lib.pairer_destroy(self._h)
            self._h = None


class StreamingIngest:
    """Pairer → ring → device double buffer.

    Producers call :meth:`feed`; the consumer iterates :meth:`frames` or
    :meth:`frames_prefetch`, which yield ``(left, right, stamp, seq)`` with
    the images as tensors on ``device`` (the card unless ``device="cpu"``;
    a CUDA device without CUDA raises)."""

    def __init__(self, shape: Tuple[int, ...], capacity: int = 4,
                 exact: bool = True, slop: float = 0.01, queue_size: int = 5,
                 drop_on_full: bool = True, device: torch.device | str | None = None):
        self.device = require_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.shape = tuple(shape)
        self.pairer = StereoPairer(shape, exact=exact, slop=slop, queue_size=queue_size)
        self.ring = FrameRing(capacity, shape, drop_on_full=drop_on_full)
        self._seq = 0

    def feed(self, side: str, image: np.ndarray, stamp: float) -> None:
        self.pairer.add(side, image, stamp)
        got = self.pairer.get()
        if got is not None:
            l, r, t = got
            self.ring.push(l, r, t, self._seq)
            self._seq += 1

    def _upload(self, img: np.ndarray) -> torch.Tensor:
        """A copy of ``img`` on the device, finished when this returns (the
        source may be a ring slot that is recycled next)."""
        t = torch.from_numpy(img)
        if self.device.type == "cpu":
            return t.clone()
        dev = t.to(self.device)
        torch.cuda.current_stream(self.device).synchronize()
        return dev

    def frames(self, timeout: float = 0.0) -> Iterator[tuple]:
        """Yield (left, right, stamp, seq) device-tensor frames until the ring
        drains (with ``timeout`` ≤ 0: a non-blocking drain), one pair staged
        ahead of the one yielded.

        Each pair is copied straight from the ring slot's views, and the slot
        is released only after the copies have finished."""
        pending = None
        while True:
            got = self.ring.peek(timeout)
            if got is None:
                break
            l, r, stamp, seq = got
            try:
                dev = (self._upload(l), self._upload(r))
            finally:
                self.ring.release()
            if pending is not None:
                yield pending
            pending = (dev[0], dev[1], stamp, seq)
        if pending is not None:
            yield pending

    def frames_prefetch(self, timeout: float = 0.0, depth: int = 3,
                        stacked: bool = False) -> Iterator[tuple]:
        """Like :meth:`frames`, but host→device staging runs on an uploader
        thread that keeps up to ``depth`` frames staged while the consumer
        computes — the reference's upload-on-stream overlap
        (src/StereoProcessor.cpp:179-180).

        On a CUDA device the uploader copies each pair out of the ring slot
        into one of ``depth + 1`` pinned host buffers and issues
        ``non_blocking`` host→device copies on its own CUDA stream, recording
        an event per frame.  The consumer's current stream waits on that
        event before the frame is yielded, each yielded tensor is marked as
        used on the consumer's stream (``record_stream``, so the caching
        allocator does not hand its memory back to the uploader's stream
        early), and a pinned buffer is refilled only once its event has
        completed.  ``stacked=True`` makes one (2, H, W) copy per pair and
        yields its two rows.

        ``timeout`` is per pop: the stream ends when the ring stays empty for
        ``timeout`` seconds (≤ 0: a non-blocking drain)."""
        q: "queue.Queue" = queue.Queue(maxsize=max(1, depth))
        stop = threading.Event()
        end = object()
        cuda = self.device.type == "cuda"
        pinned, pin_events = [], []
        if cuda:
            upload_stream = torch.cuda.Stream(self.device)
            for _ in range(max(1, depth) + 1):
                pinned.append(torch.empty((2,) + self.shape, dtype=torch.uint8).pin_memory())
                pin_events.append(None)

        def stage(k: int, l: np.ndarray, r: np.ndarray):
            """The pair on the device from pinned buffer k (CUDA), or copied
            into CPU tensors; returns (left, right, event or None), ``right``
            None when ``left`` is the stacked (2, H, W) copy."""
            if not cuda:
                return torch.from_numpy(l.copy()), torch.from_numpy(r.copy()), None
            if pin_events[k] is not None:
                pin_events[k].synchronize()       # its last copy has finished
            buf = pinned[k]
            host = buf.numpy()
            host[0], host[1] = l, r
            if stacked:
                left, right = buf.to(self.device, non_blocking=True), None
            else:
                left = buf[0].to(self.device, non_blocking=True)
                right = buf[1].to(self.device, non_blocking=True)
            ev = torch.cuda.Event()
            ev.record(upload_stream)
            pin_events[k] = ev
            return left, right, ev

        def uploader():
            try:
                if cuda:
                    # the current stream is per thread: set it in this one
                    torch.cuda.set_device(self.device)
                    ctx = torch.cuda.stream(upload_stream)
                else:
                    ctx = contextlib.nullcontext()
                with ctx:
                    k = 0
                    while not stop.is_set():
                        got = self.ring.peek(timeout)
                        if got is None:
                            break
                        l, r, stamp, seq = got
                        try:
                            item = stage(k, l, r) + (stamp, seq)
                        finally:
                            self.ring.release()      # staged: the slot is free
                        k = (k + 1) % max(1, len(pinned))
                        _put_until(q, item, stop)
            except Exception as e:       # handed to the consumer, which raises it
                _put_until(q, _Failed(e), stop)
            finally:
                _put_until(q, end, stop)

        t = threading.Thread(target=uploader, daemon=True, name="ingest-uploader")
        t.start()
        try:
            consumer = torch.cuda.current_stream(self.device) if cuda else None
            while True:
                item = q.get()
                if item is end:
                    break
                if isinstance(item, _Failed):
                    raise item.error
                left, right, ev, stamp, seq = item
                if cuda:
                    consumer.wait_event(ev)
                    left.record_stream(consumer)
                    if right is not None:
                        right.record_stream(consumer)
                if right is None:        # stacked: the rows of one (2, H, W) copy
                    left, right = left[0], left[1]
                yield left, right, stamp, seq
        finally:
            stop.set()
            t.join(timeout=5.0)


class _Failed:
    """An exception of the uploader thread, on its way to the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


def _put_until(q: "queue.Queue", item, stop: threading.Event) -> None:
    """Put ``item``, retrying while the queue is full until ``stop``."""
    while True:
        try:
            q.put(item, timeout=0.1)
            return
        except queue.Full:
            if stop.is_set():
                return
