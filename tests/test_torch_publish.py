"""The port's publish path: ``utils/hostcopy.py`` (device→host copies
started at enqueue into pinned memory on a copy stream, and host frames
staged through pinned memory), ``utils/msgs.py::SenderPool`` and
``StereoPipeline.enqueue_send`` / ``FrameResult.fetch``.

On the CPU (64×96 frames, every pipeline ``device="cpu"``):

  * every message ``enqueue_send`` builds equals the JAX package's message
    for the same seeded frame and header (the JAX side:
    ``StereoPipeline(..., use_pallas=False)`` with its own ``SenderPool``
    and ``enqueue_send``), for each disparity wire (float32, fixed16,
    fixed8) and each output: images and the disparity exact,
    ``pointcloud`` xyz with equal NaN positions and rtol 1e-5, its packed
    RGB bitwise;
  * ``FrameResult.fetch`` equals ``to_host`` of each output;
  * a build that raises surfaces from its future and from ``wait_all``;
  * the pool keeps no message of a send that succeeded (its pinned memory
    lives as long as the publisher and the caller keep the message).

On the card (marked ``cuda``; they skip elsewhere and import no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_publish.py

  * the host arrays are pinned, on the publish path too;
  * the copy runs on a stream of its own, not behind work enqueued on the
    current stream after it;
  * a copy ordered after ``torch.cuda._sleep`` and a fill (on the current
    stream, after an event, after events of two streams) sees the fill;
  * non-contiguous sources land in contiguous host arrays;
  * a frame's messages are intact after its tensors are dropped and 16
    further frames have run and published;
  * ``process`` of a numpy frame that is overwritten right after the call
    (captured and eager) gives that frame's result;
  * ``process`` and ``enqueue_send`` run under
    ``torch.cuda.set_sync_debug_mode("error")``.
"""

import functools
import time
import weakref

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import hostcopy
from ros_gpu_stereo_processor_tpu_torch.utils.msgs import Header, SenderPool

try:
    import ros_gpu_stereo_processor_tpu as J
    from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
    from ros_gpu_stereo_processor_tpu.utils.msgs import Header as JHeader
except ImportError:   # a machine without the JAX reference runs the card tests only
    J = None

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(J is None, reason="needs the JAX reference package")

H, W = 64, 96
_K = np.array([[75.0, 0, 48], [0, 75.0, 32], [0, 0, 1.0]])
_P = np.hstack([np.array([[72.0, 0, 47], [0, 72.0, 31], [0, 0, 1.0]]), np.zeros((3, 1))])
_PR = _P.copy()
_PR[0, 3] = -7.2
_D = np.array([-0.3, 0.09, 0.0, 0.0, 0.0])
WIRES = ("float32", "fixed16", "fixed8")
NAMES = tuple(sorted(T.Outputs.all().flags))
HEADER = dict(stamp=12.5, frame_id="stereo", seq=7)


def _jax_config(wire):
    return J.PipelineConfig(
        stereobm=J.StereoBMConfig(num_disparities=16, block_size=9),
        speckle=J.SpeckleConfig(max_speckle_size=30),
        disparity_wire=wire)


def _collect(pipe, outputs, header, frame):
    got = {}
    for name in NAMES:
        pipe.senders.register(name, lambda m, n=name: got.__setitem__(n, m))
    pipe.enqueue_send(pipe.process(*frame, outputs, header=header), outputs)
    pipe.wait_all()
    pipe.senders.shutdown()
    return got


@functools.lru_cache(maxsize=None)
def _messages(wire):
    """(port messages, JAX messages) by output name: one seeded frame with
    every output, published at ``wire``."""
    jm = J.StereoCameraModel.from_calibs(
        JCalib(W, H, _K, _D, np.eye(3), _P, "left"),
        JCalib(W, H, _K, _D, np.eye(3), _PR, "right"))
    cfg = _jax_config(wire)
    frame = T.synthetic_stereo_pair(H, W, 12, seed=21)[:2]
    jp = J.StereoPipeline(jm, cfg, use_pallas=False)
    want = _collect(jp, J.Outputs.all(), JHeader(**HEADER), frame)
    tp = T.StereoPipeline.from_arrays(jm.rect_maps_stacked(), jm.Q, W, H, jm.fx, jm.baseline,
                                      T.from_jax_config(cfg), device="cpu")
    got = _collect(tp, T.Outputs.all(), Header(**HEADER), frame)
    return got, want


def _same_array(g, w, label):
    assert g.dtype == w.dtype and g.shape == w.shape, label
    np.testing.assert_array_equal(g, w, err_msg=label)


@needs_jax
@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("wire", WIRES)
def test_messages_match_jax(wire, name):
    got_all, want_all = _messages(wire)
    assert sorted(got_all) == sorted(want_all) == sorted(NAMES)
    got, want = got_all[name], want_all[name]
    assert type(got).__name__ == type(want).__name__
    assert (got.header.stamp, got.header.frame_id, got.header.seq) == \
        (want.header.stamp, want.header.frame_id, want.header.seq)
    if name == "disparity":
        _same_array(got.image, want.image, name)
        assert (got.f, got.T, got.min_disparity, got.max_disparity, got.delta_d,
                got.valid_window) == (want.f, want.T, want.min_disparity,
                                      want.max_disparity, want.delta_d, want.valid_window)
        assert 0.2 < np.mean(got.image >= got.min_disparity)
    elif name == "pointcloud":
        assert (got.height, got.width, got.is_dense) == (want.height, want.width, want.is_dense)
        assert got.xyz.dtype == want.xyz.dtype and got.xyz.shape == want.xyz.shape
        np.testing.assert_array_equal(np.isnan(got.xyz), np.isnan(want.xyz))
        np.testing.assert_allclose(got.xyz, want.xyz, rtol=1e-5, atol=0)
        _same_array(got.rgb.view(np.int32), want.rgb.view(np.int32), "pointcloud rgb")
        assert got.packed_data().shape == want.packed_data().shape == (H, W * 16)
    else:
        assert (got.height, got.width, got.encoding, got.step) == \
            (want.height, want.width, want.encoding, want.step)
        _same_array(got.data, want.data, name)


def test_fetch_equals_to_host():
    model = tcal.StereoCameraModel.from_calibs(
        tcal.CameraCalib(W, H, _K, _D, np.eye(3), _P, "left"),
        tcal.CameraCalib(W, H, _K, _D, np.eye(3), _PR, "right"))
    cfg = T.PipelineConfig(stereobm=T.StereoBMConfig(num_disparities=16, block_size=9))
    pipe = T.StereoPipeline(model, cfg, device="cpu")
    res = pipe.process(*T.synthetic_stereo_pair(H, W, 12, seed=22)[:2], T.Outputs.all())
    got = res.fetch()
    assert list(got) == list(res.outputs)
    for k, v in res.outputs.items():
        _same_array(got[k], hostcopy.to_host(v), k)
    pipe.senders.shutdown()


def test_build_error_surfaces_from_wait_all():
    pool = SenderPool(max_workers=2)
    seen = []
    pool.register("bad", seen.append)

    def bad(a):
        raise ValueError(f"no message from {a.shape}")

    fut = pool.enqueue("bad", torch.arange(6).reshape(2, 3), bad)
    ok = pool.enqueue("ok", (torch.ones(2), np.zeros(3)), lambda a, b: (a.sum(), b.size))
    with pytest.raises(ValueError, match=r"no message from \(2, 3\)"):
        pool.wait_all()
    with pytest.raises(ValueError):
        fut.result()
    assert ok.result() == (2.0, 3)
    assert not seen and not pool.was_data_sent("bad") and pool.was_data_sent("ok")
    pool.shutdown()


def test_pool_keeps_no_published_message():
    pool = SenderPool(max_workers=1)
    refs = []

    class Message:
        pass

    def build(a):
        m = Message()
        refs.append(weakref.ref(m))
        return m

    fut = pool.enqueue("x", torch.arange(3), build)
    fut.result()
    del fut
    deadline = time.monotonic() + 10
    while refs[0]() is not None and time.monotonic() < deadline:
        time.sleep(0.01)
    assert refs[0]() is None
    pool.wait_all()
    pool.shutdown()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CH, CW = 480, 752
SLEEP_CYCLES = 500_000_000    # ~0.3 s of torch.cuda._sleep on an H100


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: pinned memory and copy streams have no CPU mode")
    return torch.device("cuda", 0)


def _card_frames(n, seed=0):
    return [T.synthetic_stereo_pair(CH, CW, 48, seed=seed + i)[:2] for i in range(n)]


@pytest.mark.cuda
def test_host_arrays_are_pinned(dev):
    x = torch.arange(CH * CW, device=dev, dtype=torch.int32).reshape(CH, CW)
    copy = hostcopy.start_host_copy((x, x.float(), x > 5))
    for h, a in zip(copy.host, copy.result()):
        assert h.is_pinned() and a.ctypes.data == h.data_ptr()
    pipe = T.StereoPipeline(tcal.euroc_like_model(), device=dev)
    got = {}
    for name in ("disparity", "rect_mono_left", "pointcloud"):
        pipe.senders.register(name, lambda m, n=name: got.__setitem__(n, m))
    outputs = T.Outputs.of("disparity", "rect_mono_left", "pointcloud")
    pipe.enqueue_send(pipe.process(*_card_frames(1)[0], outputs), outputs)
    pipe.wait_all()
    for a in (got["disparity"].image, got["rect_mono_left"].data, got["pointcloud"].xyz,
              got["pointcloud"].rgb):
        assert torch.from_numpy(a).is_pinned()
    pipe.senders.shutdown()


@pytest.mark.cuda
def test_copy_runs_on_its_own_stream(dev):
    cur = torch.cuda.current_stream(dev)
    assert hostcopy.copy_stream(dev) != cur
    x = torch.full((1 << 22,), 3.0, device=dev)
    torch.cuda.synchronize()
    copy = hostcopy.start_host_copy(x)
    torch.cuda._sleep(SLEEP_CYCLES)      # on the current stream, after the copy started
    (a,) = copy.result()
    assert not cur.query(), "the copy waited for work enqueued after it"
    assert (a == 3.0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_copy_after_sleep_and_fill_sees_the_fill(dev):
    x = torch.zeros(1 << 22, device=dev)
    torch.cuda.synchronize()
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(7.0)
    (a,) = hostcopy.start_host_copy(x).result()      # after the current stream
    assert (a == 7.0).all()
    torch.cuda._sleep(SLEEP_CYCLES)
    x.fill_(9.0)
    ev = torch.cuda.Event()
    ev.record()
    (a,) = hostcopy.start_host_copy(x, ev).result()
    assert (a == 9.0).all()
    # ordered after events of two streams, as a mesh frame's band events
    side = torch.cuda.Stream(dev)
    y = torch.zeros(1 << 22, device=dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        torch.cuda._sleep(SLEEP_CYCLES)
        y.fill_(5.0)
        band = torch.cuda.Event()
        band.record(side)
    y.record_stream(side)
    main = torch.cuda.Event()
    main.record()
    (a,) = hostcopy.start_host_copy(y, (main, band)).result()
    assert (a == 5.0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_non_contiguous_sources_land_contiguous(dev):
    x = torch.arange(2 * 4 * 5 * 3, device=dev, dtype=torch.float32).reshape(2, 4, 5, 3)
    srcs = (x[1], x[..., 1], x.transpose(1, 2), x[:, ::2])
    for a, s in zip(hostcopy.start_host_copy(srcs).result(), srcs):
        assert a.flags.c_contiguous
        _same_array(a, s.cpu().numpy(), str(s.shape))


@pytest.mark.cuda
def test_messages_intact_after_sources_freed_and_16_frames(dev):
    outputs = T.Outputs.all()
    pipe = T.StereoPipeline(tcal.euroc_like_model(), device=dev)
    got = {}
    for name in NAMES:
        pipe.senders.register(name, lambda m, n=name: got.__setitem__((n, m.header.seq), m))
    frames = _card_frames(17, seed=40)
    for i, frame in enumerate(frames):
        res = pipe.process(*frame, outputs, header=Header(seq=i))
        pipe.enqueue_send(res, outputs)
        del res                          # the device tensors go back to the allocator
    pipe.wait_all()
    want = pipe.process(*frames[0], outputs).fetch()
    _same_array(got[("disparity", 0)].image, want["disparity"], "disparity")
    _same_array(got[("disparity_vis", 0)].data, want["disparity_vis"], "disparity_vis")
    _same_array(got[("rect_color_left", 0)].data, want["rect_color_left"], "rect_color_left")
    _same_array(got[("mono_right", 0)].data, want["mono_right"], "mono_right")
    pc = got[("pointcloud", 0)]
    _same_array(pc.xyz.view(np.int32), want["pointcloud_xyz"].view(np.int32), "xyz")
    _same_array(pc.rgb.view(np.int32), want["pointcloud_rgb"].view(np.int32), "rgb")
    assert not np.array_equal(got[("disparity", 16)].image, got[("disparity", 0)].image)
    pipe.senders.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("captured", [True, False], ids=["captured", "eager"])
def test_overwritten_numpy_frame_gives_its_result(dev, captured):
    outputs = T.Outputs.of("disparity", "rect_mono_left")
    pipe = T.StereoPipeline(tcal.euroc_like_model(), device=dev)
    (l0, r0), warm = _card_frames(2, seed=60)
    pipe.process(*warm, outputs).fetch()       # the capture: later calls replay
    left, right = l0.copy(), r0.copy()
    torch.cuda._sleep(SLEEP_CYCLES)            # the frame's device copies queue behind this
    if captured:
        out = pipe.process(left, right, outputs).outputs
    else:
        out = pipe._eager(left, right, outputs, "mono8")
    left[:] = 0
    right[:] = 255
    got = hostcopy.start_host_copy(tuple(out.values())).result()
    want = pipe.process(l0, r0, outputs).fetch()
    for k, g in zip(out, got):
        _same_array(g, want[k], k)
    pipe.senders.shutdown()


@pytest.mark.cuda
@pytest.mark.parametrize("wire", WIRES)
def test_enqueue_without_host_sync(dev, wire):
    outputs = T.Outputs.all()
    pipe = T.StereoPipeline(tcal.euroc_like_model(),
                            T.PipelineConfig(disparity_wire=wire), device=dev)
    got = {}
    for name in NAMES:
        pipe.senders.register(name, lambda m, n=name: got.__setitem__(n, m))
    frames = _card_frames(3, seed=80)
    pipe.enqueue_send(pipe.process(*frames[0], outputs), outputs)    # capture, first pins
    pipe.wait_all()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for frame in frames[1:]:
            pipe.enqueue_send(pipe.process(*frame, outputs), outputs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    pipe.wait_all()
    assert sorted(got) == sorted(NAMES)
    pipe.senders.shutdown()
