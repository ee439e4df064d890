"""The port's ingest runtime (``runtime/ingest.py``): ring semantics,
zero-copy views, pairing policies, threading, the device double buffer on
``device="cpu"``, the pure-Python ring and pairer that stand in without a
compiler, and (on a card) the uploader's stream handoff.

Mirrors tests/test_runtime.py; imports nothing of JAX, so its card tests run
on a machine without it."""

import threading
import time

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.runtime import (
    FrameRing, StereoPairer, StreamingIngest, native_available,
)
from ros_gpu_stereo_processor_tpu_torch.runtime import ingest
from ros_gpu_stereo_processor_tpu_torch.utils.device import require_device
from ros_gpu_stereo_processor_tpu_torch.utils.io import pair_timestamps_approx

SHAPE = (16, 24)


def mk(i):
    return np.full(SHAPE, i % 251, np.uint8)


@pytest.fixture(params=["native", "python"])
def impl(request, monkeypatch):
    """Each ring/pairer test runs on the native library and on the
    pure-Python stand-in."""
    if request.param == "python":
        monkeypatch.setattr(ingest, "_load_lib", lambda: None)
    return request.param


def test_native_library_builds():
    assert native_available(), "the C++ frame_ring library must build (g++)"
    assert list(ingest.BUILD_DIR.glob("libframe_ring_*.so"))


def test_ring_fifo_roundtrip(impl):
    ring = FrameRing(4, SHAPE)
    for i in range(3):
        assert ring.push(mk(i), mk(i + 100), stamp=float(i), seq=i)
    assert len(ring) == 3
    for i in range(3):
        l, r, stamp, seq = ring.pop(timeout=0)
        np.testing.assert_array_equal(l, mk(i))
        np.testing.assert_array_equal(r, mk(i + 100))
        assert stamp == float(i) and seq == i
    assert ring.pop(timeout=0) is None


def test_ring_drop_on_full(impl):
    ring = FrameRing(2, SHAPE)
    assert ring.push(mk(0), mk(0), 0.0, 0)
    assert ring.push(mk(1), mk(1), 1.0, 1)
    assert not ring.push(mk(2), mk(2), 2.0, 2)   # dropped
    s = ring.stats()
    assert s["dropped"] == 1 and s["pushed"] == 2
    with pytest.raises(ValueError, match="bytes"):
        ring.push(np.zeros((3, 3), np.uint8), mk(0))


def test_ring_zero_copy_peek(impl):
    ring = FrameRing(2, SHAPE)
    ring.push(mk(7), mk(8), 3.5, 42)
    l, r, stamp, seq = ring.peek(timeout=0)
    np.testing.assert_array_equal(l, mk(7))
    assert stamp == 3.5 and seq == 42
    ring.release()
    assert len(ring) == 0


def test_ring_threaded_producer_consumer(impl):
    ring = FrameRing(8, SHAPE)
    N = 200
    got = []

    def producer():
        for i in range(N):
            while not ring.push(mk(i), mk(i), float(i), i):
                time.sleep(0.0005)

    t = threading.Thread(target=producer)
    t.start()
    while len(got) < N:
        item = ring.pop(timeout=2.0)
        assert item is not None, "consumer timed out"
        got.append(item)
    t.join(timeout=10)
    assert not t.is_alive()
    # FIFO order, no loss (the producer retried on drop)
    assert [g[3] for g in got] == list(range(N))


def test_pairer_exact(impl):
    p = StereoPairer(SHAPE, exact=True)
    p.add("left", mk(1), 1.0)
    assert p.get() is None
    p.add("right", mk(2), 1.0)
    l, r, stamp = p.get()
    assert stamp == 1.0
    np.testing.assert_array_equal(l, mk(1))
    np.testing.assert_array_equal(r, mk(2))


def test_pairer_exact_discards_unmatched(impl):
    p = StereoPairer(SHAPE, exact=True)
    p.add("left", mk(1), 1.0)
    p.add("right", mk(2), 2.0)   # no 1.0 right ever comes
    p.add("left", mk(3), 2.0)
    l, r, stamp = p.get()
    assert stamp == 2.0
    assert p.stats()["dropped"] >= 1


def test_pairer_approx_matches_python_reference(impl):
    """Streaming approximate pairing reproduces the batch pairing of
    utils/io.pair_timestamps_approx on jittered streams."""
    rng = np.random.default_rng(0)
    lt = np.arange(30) * 0.1
    rt = np.arange(30) * 0.1 + rng.uniform(-0.004, 0.004, 30)
    expected = pair_timestamps_approx(list(lt), list(rt), slop=0.01)
    p = StereoPairer(SHAPE, exact=False, slop=0.01, queue_size=50)
    pairs = []
    for i in range(30):
        p.add("left", mk(i), lt[i])
        p.add("right", mk(i + 100), rt[i])
        while (got := p.get()) is not None:
            pairs.append(got[2])
    assert len(pairs) == len(expected)
    np.testing.assert_allclose(pairs, [lt[i] for i, _ in expected])


def _fed(n=5, capacity=4, base=0.0, **kw):
    ing = StreamingIngest(SHAPE, capacity=capacity, device="cpu", **kw)
    for i in range(n):
        ing.feed("left", mk(i), base + i)
        ing.feed("right", mk(i + 50), base + i)
    return ing


def test_streaming_ingest_device_frames(impl):
    frames = list(_fed().frames(timeout=0))
    assert len(frames) == 4                       # capacity-bounded: one dropped
    for k, (l, r, stamp, seq) in enumerate(frames):
        assert isinstance(l, torch.Tensor) and l.device.type == "cpu"
        np.testing.assert_array_equal(l.numpy(), mk(k))
        np.testing.assert_array_equal(r.numpy(), mk(k + 50))
        assert stamp == float(k) and seq == k


@pytest.mark.parametrize("stacked", [False, True])
def test_frames_prefetch_against_fed_arrays(impl, stacked):
    """``frames_prefetch`` yields every fed pair, in order, equal to the fed
    arrays (stacked: the two rows of one (2, H, W) copy)."""
    ing = _fed(n=6, capacity=8)
    got = list(ing.frames_prefetch(timeout=0, depth=2, stacked=stacked))
    assert [g[3] for g in got] == list(range(6))
    for k, (l, r, stamp, seq) in enumerate(got):
        assert l.shape == SHAPE and r.shape == SHAPE and stamp == float(k)
        np.testing.assert_array_equal(l.numpy(), mk(k))
        np.testing.assert_array_equal(r.numpy(), mk(k + 50))
    assert len(ing.ring) == 0


def test_frames_prefetch_producer_thread(impl):
    """A producer feeding while the consumer drains through the uploader
    thread (blocking pops with a timeout): nothing lost, order kept."""
    ing = StreamingIngest(SHAPE, capacity=64, device="cpu")
    N = 40

    def producer():
        for i in range(N):
            ing.feed("left", mk(i), float(i))
            ing.feed("right", mk(i + 7), float(i))
            time.sleep(0.001)

    t = threading.Thread(target=producer)
    t.start()
    got = [(int(l[0, 0]), int(r[0, 0]), seq)
           for l, r, _, seq in ing.frames_prefetch(timeout=1.0, depth=3, stacked=True)]
    t.join(timeout=10)
    assert not t.is_alive()
    assert got == [(i % 251, (i + 7) % 251, i) for i in range(N)]


def test_frames_prefetch_stops_early():
    """A consumer that stops mid-stream stops the uploader thread."""
    def uploaders():
        return {t for t in threading.enumerate()
                if t.name == "ingest-uploader" and t.is_alive()}

    before = uploaders()
    ing = _fed(n=8, capacity=8)
    it = ing.frames_prefetch(timeout=0, depth=1)
    next(it)
    assert uploaders() - before          # its uploader is running
    it.close()
    assert not uploaders() - before


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert StreamingIngest(SHAPE).device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        StreamingIngest(SHAPE)


@pytest.mark.parametrize("device", [None, "cuda", "cuda:0", "cpu", torch.device("cpu")])
def test_require_device(device):
    """The shared entry-point check: the card when no device is given, the
    CPU only when asked for, and a CUDA device raises where there is none."""
    if device is not None and torch.device(device).type == "cpu":
        assert require_device(device) == torch.device("cpu")
    elif torch.cuda.is_available():
        assert require_device(device).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            require_device(device)


@pytest.mark.cuda
@pytest.mark.parametrize("stacked", [False, True])
def test_prefetch_stream_handoff_on_card(stacked):
    """On a card: frames come off the uploader's own stream; the consumer's
    stream waits on each frame's event, so device work on the yielded
    tensors sees the uploaded bytes even with a slow consumer that frees
    each frame at once (record_stream keeps the allocator from reusing it
    early) and more frames than pinned buffers."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    shape = (480, 752)
    ing = StreamingIngest(shape, capacity=32, device="cuda")
    rng = np.random.default_rng(0)
    fed = [(rng.integers(0, 256, shape, np.uint8), rng.integers(0, 256, shape, np.uint8))
           for _ in range(12)]
    for i, (l, r) in enumerate(fed):
        ing.feed("left", l, float(i))
        ing.feed("right", r, float(i))
    sums = []
    for l, r, stamp, seq in ing.frames_prefetch(timeout=0, depth=2, stacked=stacked):
        assert l.device.type == "cuda" and l.shape == shape
        torch.cuda._sleep(2_000_000)              # a slow consumer stream
        sums.append((l.long().sum(), r.long().sum(), seq))
        del l, r
    torch.cuda.synchronize()
    assert [s[2] for s in sums] == list(range(len(fed)))
    for (sl, sr, _), (l, r) in zip(sums, fed):
        assert int(sl) == int(l.astype(np.int64).sum())
        assert int(sr) == int(r.astype(np.int64).sum())
