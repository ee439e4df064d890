"""Bayer input on the PyTorch port: the bilinear debayer and the Bayer
conversions against the JAX package's ``ops/color.py``, and the port's
pipeline on Bayer frames against the JAX pipeline, on the CPU.

Tolerance: exact everywhere.  Every term of the debayer's 3×3 sums is a small
integer (exact in float32) and the quotient is one IEEE division."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu as J
from ros_gpu_stereo_processor_tpu.ops import color as jcolor
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.ops import color as tcolor

torch.set_num_threads(1)

BAYER = [n for n, e in tcolor.ENCODINGS.items() if e.is_bayer]


def _as_torch(a: np.ndarray) -> torch.Tensor:
    if a.dtype == np.uint16:    # torch.from_numpy has no uint16
        return torch.from_numpy(a.astype(np.int32)).to(torch.uint16)
    return torch.from_numpy(a)


def _as_numpy(t: torch.Tensor) -> np.ndarray:
    if t.dtype == torch.uint16:
        return t.to(torch.int32).numpy().astype(np.uint16)
    return t.numpy()


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16, np.float32])
@pytest.mark.parametrize("name", BAYER)
def test_debayer_exact(name, dtype):
    """All four phases, uint8/uint16/float32, odd H and W, batch dims."""
    rng = np.random.default_rng(len(name) + np.dtype(dtype).itemsize)
    hi = 65536 if dtype == np.uint16 else 256
    raw = rng.integers(0, hi, (2, 3, 13, 17)).astype(dtype)
    pattern = tcolor.encoding(name).bayer_pattern
    want = np.asarray(jcolor.debayer_bilinear(jnp.asarray(raw), pattern))
    got = _as_numpy(tcolor.debayer_bilinear(_as_torch(raw), pattern))
    assert got.dtype == want.dtype and got.shape == (2, 3, 13, 17, 3)
    np.testing.assert_array_equal(got, want)
    # one frame alone equals its slice of the batch
    one = _as_numpy(tcolor.debayer_bilinear(_as_torch(raw[1, 2]), pattern))
    np.testing.assert_array_equal(one, want[1, 2])


def test_bayer_masks_match_jax():
    for name in BAYER:
        p = tcolor.encoding(name).bayer_pattern
        np.testing.assert_array_equal(tcolor._bayer_masks(p, 5, 7).numpy(),
                                      jcolor._bayer_masks(p, 5, 7))


@pytest.mark.parametrize("dst", ["mono8", "rgb8", "bgr8", "rgba8", "mono16"])
@pytest.mark.parametrize("name", BAYER)
def test_convert_from_bayer_exact(name, dst):
    raw = np.random.default_rng(5).integers(0, 256, (15, 21)).astype(np.uint8)
    want = np.asarray(jcolor.convert(jnp.asarray(raw), name, dst))
    got = _as_numpy(tcolor.convert(torch.from_numpy(raw), name, dst))
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


H, W = 64, 96


@pytest.fixture(scope="module")
def jmodel():
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1.0]])
    P = np.hstack([np.array([[76.0, 0, W / 2 - 1], [0, 76.0, H / 2], [0, 0, 1.0]]),
                   np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -7.6
    D = np.array([-0.2, 0.05, 0.0, 0.0, 0.0])
    return J.StereoCameraModel.from_calibs(JCalib(W, H, K, D, np.eye(3), P, "left"),
                                           JCalib(W, H, K, D, np.eye(3), Pr, "right"))


@pytest.mark.parametrize("name", ["bayer_grbg8", "bayer_bggr8"])
def test_pipeline_bayer_matches_jax(jmodel, name):
    """``process(..., encoding="bayer_*")`` with every output, exact (the
    point cloud's xyz within rtol 1e-6, as tests/test_torch_pipeline.py)."""
    cfg = J.PipelineConfig(
        stereobm=J.StereoBMConfig(num_disparities=16, block_size=7, texture_threshold=5),
        speckle=J.SpeckleConfig(max_speckle_size=30, max_diff=2.0))
    left, right, _ = T.synthetic_stereo_pair(H, W, 14, seed=4)
    jo = J.Outputs.all()
    want = J.StereoPipeline(jmodel, cfg, use_pallas=False).process(
        left, right, jo, encoding=name).fetch()
    pipe = T.StereoPipeline.from_arrays(
        jmodel.rect_maps_stacked(), jmodel.Q, W, H, jmodel.fx, jmodel.baseline,
        T.from_jax_config(cfg), device="cpu")
    got = pipe.process(left, right, T.from_jax_config(jo), encoding=name).fetch()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "pointcloud_xyz":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        elif k == "pointcloud_rgb":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert got["disparity_valid"].mean() > 0.2
    pipe.senders.shutdown()
