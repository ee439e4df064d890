"""The port's compiled dispatch (``utils/graphs.py``): the frame step's
variant cache, ``process_batch`` as one dispatch and the captured VO step.

On the CPU (no graphs: the captured functions are called as they are):

  * the JAX pipeline's ``test_variant_cache`` and
    ``test_reconfigure_recompiles`` sequence, and a ``process_batch``, on
    both packages at 96×128: ``len(_variants)`` grows exactly as JAX's
    does, and every output is equal (``pointcloud_xyz`` excepted, which no
    case here asks for);
  * ``process_batch`` against the JAX ``process_batch`` (its ``lax.scan``,
    ``use_pallas=False``), exact;
  * the helper's pieces: the output arena, the launch recording, where a
    failed capture names its op.

On the card (marked ``cuda``; they skip elsewhere and import no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_graphs.py

  * every captured variant against the eager step on the same card, bit for
    bit: BM (``Outputs.all()`` and the disparity alone, ``lr_check``), SGM
    (2, 4 and 8 paths, ``lr_check``), Bayer, the bilateral filter,
    ``process_batch`` and the VO step (``torch.linalg.solve_ex`` captured);
  * results held across many later replays stay intact;
  * a capture while another thread launches, copies and reads back;
  * an op that cannot be captured raises, naming its line;
  * the launch counters after replays (a capture adds nothing).
"""

import threading

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.models import vo as tvo
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel, speckle_kernel, stereobm_kernel
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal
from ros_gpu_stereo_processor_tpu_torch.utils import graphs
from ros_gpu_stereo_processor_tpu_torch.utils import synth as tsynth

try:
    import ros_gpu_stereo_processor_tpu as J
    from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
except ImportError:   # a machine without the JAX reference runs the card tests only
    J = None

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(J is None, reason="needs the JAX reference package")

H, W = 96, 128
_K = np.array([[110.0, 0, 64], [0, 110.0, 48], [0, 0, 1.0]])
_P = np.hstack([np.array([[105.0, 0, 62], [0, 105.0, 47], [0, 0, 1.0]]), np.zeros((3, 1))])
_PR = _P.copy()
_PR[0, 3] = -10.5
_D = np.array([-0.37, 0.11, 0.0, 0.0, 0.0])


def _frame(seed, h=H, w=W, ndisp=24):
    return T.synthetic_stereo_pair(h, w, ndisp, seed=seed)[:2]


def _equal_outputs(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = np.asarray(got[k])
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)


# ---------------------------------------------------------------------------
# on the CPU, against the JAX pipeline
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def pair():
    """(JAX pipeline, port pipeline) on the same 96×128 toy model."""
    if J is None:
        pytest.skip("needs the JAX reference package")
    cfg = J.PipelineConfig(stereobm=J.StereoBMConfig(num_disparities=32, block_size=9),
                           speckle=J.SpeckleConfig(max_speckle_size=40))
    jm = J.StereoCameraModel.from_calibs(JCalib(W, H, _K, _D, np.eye(3), _P, "left"),
                                         JCalib(W, H, _K, _D, np.eye(3), _PR, "right"))
    port = T.StereoPipeline.from_arrays(jm.rect_maps_stacked(), jm.Q, W, H, jm.fx,
                                        jm.baseline, T.from_jax_config(cfg), device="cpu")
    return J.StereoPipeline(jm, cfg, use_pallas=False), port


@needs_jax
def test_variant_cache_grows_as_jax(pair):
    """tests/test_pipeline.py's variant-cache and reconfigure sequence, then
    a batch, on both pipelines: the same number of variants after every
    call, and the same outputs."""
    jp, tp = pair
    left, right = _frame(3)
    counts = []

    def both(names, batch=False):
        jo, to = J.Outputs.of(*names), T.Outputs.of(*names)
        if batch:
            ls, rs = (np.stack([f[k] for f in (_frame(5), _frame(6))]) for k in (0, 1))
            want = {k: np.asarray(v) for k, v in jp.process_batch(ls, rs, jo).items()}
            got = {k: v.numpy() for k, v in tp.process_batch(ls, rs, to).items()}
        else:
            want = jp.process(left, right, jo).fetch()
            got = tp.process(left, right, to).fetch()
        _equal_outputs(got, want)
        counts.append((len(jp._variants), len(tp._variants)))
        return got

    for _ in range(4):
        both(["mono_left"])
    both(["disparity"])
    old = tp.config.stereobm
    jold = jp.config.stereobm
    for p in (jp, tp):
        p.reconfigure(num_disparities=16, texture_threshold=20)
    assert tp.config.stereobm.num_disparities == 16
    got = both(["disparity"])
    assert np.nanmax(got["disparity"]) <= 16.0
    jp.config = jp.config.replace(stereobm=jold)
    tp.config = tp.config.replace(stereobm=old)
    both(["disparity"])                          # the first variant again: cached
    both(["disparity", "rect_mono_left"], batch=True)
    both(["disparity", "rect_mono_left"], batch=True)
    assert [t for _, t in counts] == [j for j, _ in counts]
    assert counts[-1][1] == counts[0][1] + 3     # two configs and one batch variant


@needs_jax
def test_process_batch_equals_jax_scan(pair):
    """The port's ``process_batch`` against the JAX ``lax.scan`` over the
    same three frames, every output exact (the batch stacks ``rect_mono``
    and the colour images as well as the disparity)."""
    jp, tp = pair
    frames = [_frame(s) for s in (20, 21, 22)]
    names = ("disparity", "disparity_vis", "rect_mono_left", "color_left")
    ls, rs = (np.stack([f[k] for f in frames]) for k in (0, 1))
    want = {k: np.asarray(v) for k, v in jp.process_batch(ls, rs, J.Outputs.of(*names)).items()}
    got = {k: v.numpy() for k, v in tp.process_batch(ls, rs, T.Outputs.of(*names)).items()}
    _equal_outputs(got, want)
    assert got["disparity"].shape == (3, H, W)


# ---------------------------------------------------------------------------
# on the CPU, the helper's pieces
# ---------------------------------------------------------------------------


def test_captured_on_the_cpu_calls_the_function():
    """No graph on the CPU: numpy inputs become tensors, the pytree comes
    back as the function returns it (an input returned is the input)."""
    a = np.arange(6, dtype=np.float32).reshape(2, 3)
    b = torch.ones(3)
    calls = []

    def fn(x, pair):
        calls.append(1)
        return {"sum": x + pair[0], "same": pair[1], "n": 3}

    out = graphs.Captured(fn, "cpu")(a, (b, b))
    assert len(calls) == 1 and out["n"] == 3 and out["same"] is b
    assert torch.equal(out["sum"], torch.from_numpy(a) + 1)
    # without a device: the device of the tensor inputs
    assert torch.equal(graphs.Captured(lambda x: x * 2)(b), b * 2)


@pytest.mark.parametrize("leaves", [
    [torch.arange(5, dtype=torch.int32), torch.tensor([True, False, True])],
    [torch.tensor(2.5), torch.zeros((0, 3)), torch.full((3, 4, 2), -1.0).double()],
    [torch.arange(7, dtype=torch.uint8)[::2], 7, None, torch.ones((2, 2), dtype=torch.int64)],
], ids=["int_bool", "scalar_empty_double", "strided_and_constants"])
def test_output_arena_round_trip(leaves):
    """Every output goes through one byte arena and comes back as a view of
    it, equal in dtype, shape and value; other leaves come back as they
    are."""
    out = {"a": leaves[0], "rest": tuple(leaves[1:])}
    arena, layout, spec = graphs._pack(out)
    back = graphs._unpack(arena.clone(), layout, spec)
    for g, w in zip([back["a"], *back["rest"]], leaves):
        if isinstance(w, torch.Tensor):
            assert g.dtype == w.dtype and g.shape == w.shape and torch.equal(g, w)
            assert g.data_ptr() % graphs._ALIGN == 0 or g.numel() == 0
        else:
            assert g == w


def test_launch_recording(monkeypatch):
    """A wrapper called inside ``recording()`` adds its launch to the
    recording, not to ``launches``; ``add_launches`` adds a recording to
    the counters, as each replay does."""
    kern = speckle_kernel.KERNEL
    monkeypatch.setattr(kern, "_fn", lambda *args: 0)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda *a: type("S", (), {"cuda_stream": 0})())
    monkeypatch.setattr(kern, "launches", 0)
    kern()
    assert kern.launches == 1
    with _build.recording() as rec:
        kern()
        kern()
    assert kern.launches == 1 and rec == {"speckle_labels": 2}
    _build.add_launches(rec)
    _build.add_launches(rec)
    assert kern.launches == 5


def test_failed_capture_names_the_op():
    """The message of a failed capture points at the line of the captured
    function that raised, not at PyTorch's or the helper's frames."""
    def step(x):
        return x.sum().item()     # the line named

    try:
        step(torch.ones(2).to("meta"))
    except Exception as e:   # noqa: BLE001 — any error will do
        where = graphs._origin(e)
    assert where.startswith("test_torch_graphs.py:") and "x.sum().item()" in where


def test_mesh_variants_run_eagerly():
    """On a mesh whose band line spans two devices the variant is the eager
    step (no graph helper), cached under the same key as on one device; a
    line on one device gets the graph helper, as one device does."""
    from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh

    rng = np.random.default_rng(0)
    maps = np.stack(np.meshgrid(np.arange(W, dtype=np.float32),
                                np.arange(H, dtype=np.float32)), -1)
    left = rng.integers(0, 255, (H, W), np.uint8)
    for devices, captured in ((["cpu:0", "cpu:1"], False), (["cpu"] * 2, True)):
        pipe = T.StereoPipeline.from_arrays(np.stack([maps, maps]), np.eye(4), W, H, 100.0,
                                            0.1, mesh=make_mesh(2, devices=devices))
        res = pipe.process(left, left, T.Outputs.of("rect_mono_left"))
        np.testing.assert_array_equal(res.fetch()["rect_mono_left"], left)
        assert res.band_events == ()        # no CUDA device: no event at all
        (fn,) = pipe._variants.values()
        batch = pipe._get_variant(T.Outputs.of("rect_mono_left"), "mono8", batch=True)
        assert isinstance(fn, graphs.Captured) == isinstance(batch, graphs.Captured) == captured


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

CH, CW = 480, 752


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and the kernels have no CPU mode")
    return torch.device("cuda", 0)


def _bits(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def _same(got, want, label=""):
    """Equal dtype, shape and bits (NaN included)."""
    got_leaves, got_spec = torch.utils._pytree.tree_flatten(got)
    want_leaves, want_spec = torch.utils._pytree.tree_flatten(want)
    assert got_spec == want_spec, label
    for g, w in zip(got_leaves, want_leaves):
        assert g.dtype == w.dtype and g.shape == w.shape, label
        assert torch.equal(_bits(g), _bits(w)), label


def _pipe(dev, **bm):
    model = tcal.euroc_like_model()
    cfg = T.PipelineConfig()
    if bm:
        cfg = cfg.replace(stereobm=cfg.stereobm.replace(**bm))
    return T.StereoPipeline(model, cfg, device=dev)


def _card_frames(n, seed=0, ndisp=48):
    return [T.synthetic_stereo_pair(CH, CW, ndisp, seed=seed + i)[:2] for i in range(n)]


@pytest.mark.cuda
@pytest.mark.parametrize("bm,names", [
    ({}, None),
    ({}, ("disparity",)),
    ({"lr_check": True}, None),
    ({"algorithm": "sgm", "sgm_paths": 4, "num_disparities": 128}, None),
    ({"algorithm": "sgm", "sgm_paths": 4, "lr_check": True}, ("disparity", "pointcloud")),
    ({"algorithm": "sgm", "sgm_paths": 2}, ("disparity",)),
    ({"algorithm": "sgm", "sgm_paths": 8}, ("disparity", "disparity_vis")),
], ids=["bm_all", "bm_disparity", "bm_lr_check", "sgm4_128_all", "sgm4_lr_check",
        "sgm2", "sgm8"])
def test_captured_equals_eager(dev, bm, names):
    """Frame 0 runs eagerly and captures; frames 1-3 replay.  Every frame's
    outputs equal the eager step's on the same card, bit for bit."""
    pipe = _pipe(dev, **bm)
    outputs = T.Outputs.all() if names is None else T.Outputs.of(*names)
    for i, (left, right) in enumerate(_card_frames(4, seed=10)):
        got = pipe.process(left, right, outputs).outputs
        _same(got, pipe._eager(left, right, outputs, "mono8"), f"frame {i}")
    (fn,) = pipe._variants.values()
    assert fn.graph_count() == 1


@pytest.mark.cuda
def test_bayer_and_bilateral_captured_equal_eager(dev):
    """Bayer input and the bilateral tier (iters 1) through their graphs,
    bit for bit against the eager step."""
    model = tcal.euroc_like_model()
    bil = T.PipelineConfig(bilateral=T.BilateralConfig(enabled=True, iters=1))
    for cfg, enc in ((T.PipelineConfig(), "bayer_grbg8"), (bil, "mono8")):
        pipe = T.StereoPipeline(model, cfg, device=dev)
        for left, right in _card_frames(3, seed=30):
            got = pipe.process(left, right, T.Outputs.all(), encoding=enc).outputs
            _same(got, pipe._eager(left, right, T.Outputs.all(), enc), enc)


@pytest.mark.cuda
def test_retained_results_are_not_overwritten(dev):
    """More results than ``max_in_flight`` + 2 held, then fetched: each
    equals its frame's eager outputs (no replay wrote into an earlier
    frame's tensors)."""
    pipe = _pipe(dev)
    pipe.config = pipe.config.replace(max_in_flight=2)
    frames = _card_frames(8, seed=40)
    held = [pipe.process(left, right, T.Outputs.all()) for left, right in frames]
    for res, (left, right) in zip(held, frames):
        want = pipe._eager(left, right, T.Outputs.all(), "mono8")
        _same({k: torch.from_numpy(v) for k, v in res.fetch().items()},
              {k: v.cpu() for k, v in want.items()})


@pytest.mark.cuda
def test_process_batch_is_one_replay(dev):
    """``process_batch`` of B = 4: the stacked outputs equal each frame's
    eager step; one graph, and each later call adds one batch's launches."""
    pipe = _pipe(dev)
    outputs = T.Outputs.of("disparity", "rect_mono_left")
    frames = _card_frames(4, seed=50)
    ls, rs = (np.stack([f[k] for f in frames]) for k in (0, 1))
    k1 = remap_kernel.KERNELS[torch.uint8]
    for rep in range(3):
        k1_before = k1.launches
        out = pipe.process_batch(ls, rs, outputs)
        assert k1.launches - k1_before == 4   # one K1 launch (both sides) a frame
        for i, (left, right) in enumerate(frames):
            _same({k: v[i] for k, v in out.items()},
                  pipe._eager(left, right, outputs, "mono8"), f"batch {rep} frame {i}")
    (fn,) = pipe._variants.values()
    assert fn.graph_count() == 1


@pytest.mark.cuda
def test_launch_counts_after_replays(dev):
    """A BM frame launches K1 twice and K2 and K3 once, whether it ran
    eagerly (frame 0) or as a replay; the capture adds nothing."""
    pipe = _pipe(dev)
    frames = _card_frames(5, seed=60)
    _build.reset_launch_counts()
    k1 = remap_kernel.KERNELS[torch.uint8]
    for i, (left, right) in enumerate(frames):
        pipe.process(left, right, T.Outputs.all()).block_until_ready()
        n = i + 1
        assert (k1.launches, stereobm_kernel.KERNEL.launches,
                speckle_kernel.KERNEL.launches) == (2 * n, n, n), f"frame {i}"


@pytest.mark.cuda
def test_capture_while_another_thread_launches(dev):
    """A new variant captures while another thread launches kernels, copies
    and reads back on its own stream; both results are right."""
    stop, errors, rounds = threading.Event(), [], []

    def worker():
        try:
            x = torch.arange(1 << 20, device=dev, dtype=torch.float32)
            while not stop.is_set():
                y = (x * 2 + 1).cumsum(0)
                rounds.append(float(y[-1].item()))
        except Exception as e:   # noqa: BLE001 — asserted below
            errors.append(e)

    th = threading.Thread(target=worker)
    th.start()
    try:
        pipe = _pipe(dev)
        for left, right in _card_frames(3, seed=70):
            got = pipe.process(left, right, T.Outputs.all()).outputs
            _same(got, pipe._eager(left, right, T.Outputs.all(), "mono8"))
    finally:
        stop.set()
        th.join(timeout=60)
    assert not th.is_alive() and not errors and rounds


@pytest.mark.cuda
def test_uncapturable_op_raises(dev):
    """A function that reads a device value back captures with an error
    that names its line; the card works on afterwards."""
    def reads_back(x):
        y = x * 2
        if y.sum().item() > 0:
            y = y + 1
        return y

    bad = graphs.Captured(reads_back, dev, name="reads_back")
    with pytest.raises(graphs.CaptureError, match=r"reads_back: .*test_torch_graphs\.py:\d+"):
        bad(torch.ones(4, device=dev))
    good = graphs.Captured(lambda x: x * 3, dev)
    for _ in range(3):
        out = good(torch.ones(4, device=dev))
    assert torch.equal(out, torch.full((4,), 3.0, device=dev))


@pytest.mark.cuda
def test_vo_dispatch_captured_equals_eager(dev):
    """The VO step over the planar sequence (400×300): each dispatch's
    TrackedFrame and bundle equal ``_vo_first`` / ``_vo_core`` run eagerly
    on the same inputs, bit for bit (the PnP's ``solve_ex`` inside the
    graph); every frame's outputs held to the end stay intact."""
    lefts, rights, _ = tsynth.render_planar(8, 400, 300, 350.0, 0.1, 3.0, 10.0, 0)
    K = np.array([[350.0, 0, 200], [0, 350.0, 150], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -35.0
    model = tcal.StereoCameraModel.from_calibs(
        *(tcal.CameraCalib(400, 300, K, np.zeros(5), np.eye(3), PP, n)
          for PP, n in ((P, "left"), (Pr, "right"))))
    pipe = T.StereoPipeline(model, T.PipelineConfig(), device=dev)
    vo = tvo.StereoVisualOdometry(model, device=dev)
    cam = dict(k=vo.num_features, threshold=vo.fast_threshold, fx=model.fx,
               cx=model.left.calib.cx, cy=model.left.calib.cy, baseline=model.baseline,
               disparity_offset=model.disparity_offset)
    held = []
    for left, right in zip(lefts, rights):
        out = pipe.process(left, right, T.Outputs.of("disparity", "rect_mono_left")).outputs
        rect, disp = out["rect_mono_left"], out["disparity"]
        prev = vo.state.prev
        pending = vo.dispatch(rect, disp)
        if prev is None:
            kp, pts, pv = tvo._vo_first(rect, disp, **cam)
            bundle = tvo._pack_host_bundle(kp, pts, pv)
        else:
            kp, pts, pv, n, R, t, rms = tvo._vo_core(prev.kp, prev.pts_cam, prev.pts_valid,
                                                     rect, disp, **cam)
            bundle = tvo._pack_host_bundle(kp, pts, pv, n, R, t, rms)
        want = (tvo.TrackedFrame(kp, pts, pv), bundle.cpu())
        held.append((pending, want))
        vo.complete(pending)
    assert vo.state.n_frames == len(lefts)
    for (cur, copy, _), (frame, bundle) in held:
        _same(cur, frame)
        assert torch.equal(torch.from_numpy(copy.result()[0]), bundle)
