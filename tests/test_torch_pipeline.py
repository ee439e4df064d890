"""End-to-end parity: the PyTorch port's StereoPipeline (CPU tensors, so the
plain versions of the kernels) against the JAX package's
``StereoPipeline(model, use_pallas=False)`` on a 96×128 distorted toy
calibration and synthetic frames.  Both pipelines compute from identical
state: the port is built with ``from_arrays`` from the JAX model's maps and
Q, and ``from_jax_config`` carries the config across.

Every pipeline here asks for ``device="cpu"`` (the default is the card).

Tolerances: every output exact except ``pointcloud_xyz`` (rtol 1e-6, NaN
positions exact — XLA may fuse the Q products into multiply-adds), and
``pointcloud_rgb`` compared bitwise (denormal bit patterns)."""

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu as J
from ros_gpu_stereo_processor_tpu.config import BilateralConfig as JBilateral
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcal

torch.set_num_threads(1)

H, W = 96, 128
_K = np.array([[110.0, 0, 64], [0, 110.0, 48], [0, 0, 1.0]])
_P = np.hstack([np.array([[105.0, 0, 62], [0, 105.0, 47], [0, 0, 1.0]]), np.zeros((3, 1))])
_PR = _P.copy()
_PR[0, 3] = -10.5
_D = np.array([-0.37, 0.11, 0.0, 0.0, 0.0])

JCFG = J.PipelineConfig(
    stereobm=J.StereoBMConfig(num_disparities=32, block_size=9),
    speckle=J.SpeckleConfig(max_speckle_size=40),
)


@pytest.fixture(scope="module")
def jmodel():
    return J.StereoCameraModel.from_calibs(
        JCalib(W, H, _K, _D, np.eye(3), _P, "left"),
        JCalib(W, H, _K, _D, np.eye(3), _PR, "right"))


def _port(jm, cfg=JCFG):
    return T.StereoPipeline.from_arrays(
        jm.rect_maps_stacked(), jm.Q, W, H, jm.fx, jm.baseline,
        T.from_jax_config(cfg), device="cpu")


def _frame(seed=3):
    return T.synthetic_stereo_pair(H, W, 24, seed=seed)[:2]


def _assert_outputs_equal(got, want):
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "pointcloud_rgb":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        elif k == "pointcloud_xyz":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


@pytest.mark.parametrize("names", [None, ("disparity",)], ids=["all", "disparity"])
def test_pipeline_matches_jax(jmodel, names):
    jo = J.Outputs.all() if names is None else J.Outputs.of(*names)
    left, right = _frame()
    want = J.StereoPipeline(jmodel, JCFG, use_pallas=False).process(left, right, jo).fetch()
    got = _port(jmodel).process(left, right, T.from_jax_config(jo)).fetch()
    _assert_outputs_equal(got, want)
    assert 0.3 < got["disparity_valid"].mean()


def test_pipeline_bgr8_encoding_matches_jax(jmodel):
    rng = np.random.default_rng(2)
    left, right = _frame(seed=5)
    noise = rng.integers(0, 8, (H, W, 3), np.uint8)
    lc = np.stack([left, left // 2, 255 - left], -1) ^ noise
    rc = np.stack([right, right // 2, 255 - right], -1) ^ noise
    jo = J.Outputs.of("disparity", "rect_color_left", "pointcloud")
    want = J.StereoPipeline(jmodel, JCFG, use_pallas=False).process(
        lc, rc, jo, encoding="bgr8").fetch()
    got = _port(jmodel).process(lc, rc, T.from_jax_config(jo), encoding="bgr8").fetch()
    _assert_outputs_equal(got, want)


def test_model_constructor_equals_from_arrays(jmodel):
    tm = tcal.StereoCameraModel.from_calibs(
        tcal.CameraCalib(W, H, _K, _D, np.eye(3), _P, "left"),
        tcal.CameraCalib(W, H, _K, _D, np.eye(3), _PR, "right"))
    left, right = _frame(seed=6)
    out = T.Outputs.of("disparity", "rect_mono_right")
    a = T.StereoPipeline(tm, T.from_jax_config(JCFG), device="cpu").process(
        left, right, out).fetch()
    b = _port(jmodel).process(left, right, out).fetch()
    _assert_outputs_equal(a, b)


def test_reconfigure_matches_jax(jmodel):
    left, right = _frame(seed=7)
    jp = J.StereoPipeline(jmodel, JCFG, use_pallas=False)
    tp = _port(jmodel)
    kw = dict(correlation_window_size=10, disparity_range=40, max_speckle_diff=3.0,
              uniqueness_ratio=10, texture_threshold=20)
    jp.reconfigure(**kw)
    tp.reconfigure(**kw)
    assert tp.config == T.from_jax_config(jp.config)
    assert tp.config.stereobm.block_size == 11 and tp.config.stereobm.num_disparities == 32
    jo = J.Outputs.of("disparity", "disparity_vis")
    _assert_outputs_equal(tp.process(left, right, T.from_jax_config(jo)).fetch(),
                          jp.process(left, right, jo).fetch())
    with pytest.raises(ValueError, match="unknown"):
        tp.reconfigure(no_such_parameter=1)


@pytest.mark.parametrize("wire", ["fixed16", "fixed8"])
def test_wire_disparity_messages_match_jax(jmodel, wire):
    left, right = _frame(seed=8)
    cfg = JCFG.replace(disparity_wire=wire)
    jp = J.StereoPipeline(jmodel, cfg, use_pallas=False)
    tp = _port(jmodel, cfg)
    msgs = {}
    jp.senders.register("disparity", lambda m: msgs.__setitem__("jax", m))
    tp.senders.register("disparity", lambda m: msgs.__setitem__("port", m))
    jo = J.Outputs.of("disparity")
    jp.enqueue_send(jp.process(left, right, jo), jo)
    tp.enqueue_send(tp.process(left, right, T.from_jax_config(jo)), T.from_jax_config(jo))
    jp.wait_all()
    tp.wait_all()
    a, b = msgs["port"], msgs["jax"]
    np.testing.assert_array_equal(a.image, b.image)
    assert (a.f, a.T, a.delta_d, a.valid_window, a.min_disparity, a.max_disparity) == \
        (b.f, b.T, b.delta_d, b.valid_window, b.min_disparity, b.max_disparity)
    assert tp.senders.was_data_sent("disparity")


def test_enqueue_send_all_outputs(jmodel):
    tp = _port(jmodel)
    got = {}
    for name in T.Outputs.all().flags:
        tp.senders.register(name, lambda m, n=name: got.__setitem__(n, m))
    left, right = _frame(seed=9)
    res = tp.process(left, right, T.Outputs.all())
    tp.enqueue_send(res, T.Outputs.all())
    tp.wait_all()
    assert set(got) == set(T.Outputs.all().flags)
    out = res.fetch()
    np.testing.assert_array_equal(got["disparity"].image, out["disparity"])
    np.testing.assert_array_equal(got["rect_color_left"].data, out["rect_color_left"])
    assert got["pointcloud"].packed_data().shape == (H, W * 16)
    tp.senders.shutdown()


def test_batch_timed_and_in_flight(jmodel):
    tp = _port(jmodel, JCFG.replace(max_in_flight=1))
    frames = [_frame(seed=s) for s in (10, 11)]
    out = T.Outputs.of("disparity", "disparity_vis")
    batch = tp.process_batch(np.stack([f[0] for f in frames]),
                             np.stack([f[1] for f in frames]), out)
    for i, (left, right) in enumerate(frames):
        res, ms = tp.timed_process(left, right, out)
        assert ms > 0 and len(tp._in_flight) <= 1
        for k, v in res.fetch().items():
            np.testing.assert_array_equal(batch[k][i].numpy(), v)
    assert "process[2 outs]" in tp.timing_line()


@pytest.mark.parametrize("kw", [
    dict(sgm_paths=4),                   # the fused path: K4–K6 plain versions
    dict(sgm_paths=4, lr_check=True),
    dict(sgm_paths=8),                   # the plain recurrences of ops/sgm.py
], ids=["4paths", "4paths_lr_check", "8paths"])
def test_sgm_pipeline_matches_jax(jmodel, kw):
    cfg = JCFG.replace(stereobm=J.StereoBMConfig(
        num_disparities=32, block_size=9, algorithm="sgm", **kw))
    left, right = _frame(seed=4)
    jo = J.Outputs.all()
    want = J.StereoPipeline(jmodel, cfg, use_pallas=False).process(left, right, jo).fetch()
    got = _port(jmodel, cfg).process(left, right, T.from_jax_config(jo)).fetch()
    _assert_outputs_equal(got, want)
    assert 0.3 < got["disparity_valid"].mean()


def test_bm_lr_check_pipeline_matches_jax_pallas(jmodel):
    """The BM pipeline's lr_check is the mirrored second matcher launch, the
    JAX Pallas path's definition (not the oracle's shared cost volume)."""
    cfg = JCFG.replace(stereobm=JCFG.stereobm.replace(lr_check=True))
    left, right = _frame(seed=12)
    jo = J.Outputs.of("disparity", "disparity_vis")
    want = J.StereoPipeline(jmodel, cfg, use_pallas=True).process(left, right, jo).fetch()
    got = _port(jmodel, cfg).process(left, right, T.from_jax_config(jo)).fetch()
    _assert_outputs_equal(got, want)


def test_default_device_is_the_card(jmodel):
    """Without ``device``, a pipeline goes to CUDA; where there is none, the
    first tensor move raises (nothing falls back to the CPU)."""
    arrays = (jmodel.rect_maps_stacked(), jmodel.Q, W, H, jmodel.fx, jmodel.baseline)
    if torch.cuda.is_available():
        assert T.StereoPipeline.from_arrays(*arrays).device.type == "cuda"
        return
    with pytest.raises((RuntimeError, AssertionError)):
        T.StereoPipeline.from_arrays(*arrays)


def test_unported_paths_raise(jmodel):
    """The two paths that raised before they were ported, a Bayer encoding
    and the bilateral filter, now run and equal the JAX pipeline."""
    left, right = _frame()
    jo = J.Outputs.of("disparity")
    out = T.Outputs.of("disparity")
    for cfg, enc in ((JCFG, "bayer_rggb8"),
                     (JCFG.replace(bilateral=JBilateral(enabled=True)), "mono8")):
        want = J.StereoPipeline(jmodel, cfg, use_pallas=False).process(
            left, right, jo, encoding=enc).fetch()
        got = _port(jmodel, cfg).process(left, right, out, encoding=enc).fetch()
        _assert_outputs_equal(got, want)
