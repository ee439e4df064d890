"""The bilateral tier on the PyTorch port: ``ops/bilateral.py`` against the
JAX package's ``disparity_bilateral_filter`` and against the per-pixel numpy
oracle of tests/test_bilateral.py; the pipeline's bilateral branch against
the JAX pipeline; the row-band filter on a CPU band mesh against the JAX
``bilateral_row_sharded`` and against the port's single-device filter.

Tolerances: against JAX and between the band filter and one device, exact
(every case here is; the only operation whose last bit may differ between
XLA's and torch's CPU code is ``exp``, and no case hits a near-tie it
flips).  Against the float64 oracle, atol 1e-4, the oracle test's own bar."""

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu as J
from ros_gpu_stereo_processor_tpu.config import BilateralConfig as JBilateral
from ros_gpu_stereo_processor_tpu.ops.bilateral import (
    disparity_bilateral_filter as jax_filter,
)
from ros_gpu_stereo_processor_tpu.parallel import frontend as jpar
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.ops.bilateral import disparity_bilateral_filter
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as tpar
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh

from tests.test_bilateral import make_scene, oracle

torch.set_num_threads(1)

PARAMS = dict(edge_threshold=0.1, max_disc_threshold=0.2, sigma_range=10.0)


def _port(disp, guide, **kw):
    return disparity_bilateral_filter(torch.from_numpy(disp), torch.from_numpy(guide),
                                      **kw).numpy()


def _noisy_scene(H, W, seed):
    """Blocky integer disparity with 20 % noise and a guide that follows the
    blocks: most pixels are touched, and many candidates are near-ties."""
    rng = np.random.default_rng(seed)
    base = np.repeat(np.repeat(rng.integers(0, 60, (H // 8 + 1, W // 8 + 1)), 8, 0), 8, 1)
    base = base[:H, :W].astype(np.float32)
    disp = np.where(rng.random((H, W)) < 0.2,
                    rng.integers(0, 64, (H, W)).astype(np.float32), base)
    guide = (base * 3 + rng.normal(0, 5, (H, W))).astype(np.float32)
    return disp, guide


@pytest.mark.parametrize("radius,iters", [(1, 1), (2, 1), (2, 3), (3, 2)])
def test_matches_oracle(radius, iters):
    """tests/test_bilateral.py's oracle cases."""
    rng = np.random.default_rng(7 * radius + iters)
    disp, guide = make_scene(rng)
    got = _port(disp, guide, ndisp=64, radius=radius, iters=iters, **PARAMS)
    want = oracle(disp, guide, 64, radius, iters, 0.1, 0.2, 10.0)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-4)


def test_matches_oracle_color_guide():
    rng = np.random.default_rng(3)
    disp, guide = make_scene(rng)
    guide3 = np.stack([guide, guide * 0.5 + 10, np.flip(guide, 1)], -1)
    got = _port(disp, np.ascontiguousarray(guide3), ndisp=64, radius=2, iters=1, **PARAMS)
    want = oracle(disp, guide3, 64, 2, 1, 0.1, 0.2, 10.0)
    np.testing.assert_allclose(got, want.astype(np.float32), atol=1e-4)


@pytest.mark.parametrize("H,W,radius,iters,seed", [
    (120, 160, 3, 1, 0), (120, 160, 3, 3, 1), (64, 96, 2, 2, 2), (60, 80, 1, 1, 3),
])
def test_matches_jax(H, W, radius, iters, seed):
    disp, guide = _noisy_scene(H, W, seed)
    want = np.asarray(jax_filter(disp, guide, ndisp=64, radius=radius, iters=iters))
    got = _port(disp, guide, ndisp=64, radius=radius, iters=iters)
    assert (got != disp).mean() > 0.1          # the filter did work
    np.testing.assert_array_equal(got, want)


def test_matches_jax_color_guide_and_params():
    disp, guide = _noisy_scene(48, 64, 4)
    rng = np.random.default_rng(4)
    guide3 = np.ascontiguousarray(
        np.stack([guide, rng.uniform(0, 255, guide.shape), guide[:, ::-1]], -1)
        .astype(np.float32))
    kw = dict(ndisp=32, radius=2, iters=2, edge_threshold=0.05,
              max_disc_threshold=0.5, sigma_range=25.0)
    want = np.asarray(jax_filter(disp, guide3, **kw))
    np.testing.assert_array_equal(_port(disp, guide3, **kw), want)


def test_smooth_regions_untouched_and_radius_checked():
    rng = np.random.default_rng(0)
    disp = (rng.random((20, 28)) * 2.0).astype(np.float32) + 15.0
    guide = (rng.random((20, 28)) * 255).astype(np.float32)
    np.testing.assert_array_equal(_port(disp, guide, ndisp=64, radius=3, iters=4), disp)
    with pytest.raises(ValueError, match="radius"):
        _port(disp, guide, radius=0)


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


@pytest.mark.parametrize("radius,iters", [(2, 1), (3, 2)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_row_sharded_matches_jax_and_one_device(n, radius, iters):
    """The band filter against the JAX band filter (exact), and against the
    single-device filter (exact while the halo 2·iters·radius fits in a
    band; at n = 8 with radius 3, iters 2 it is clamped to the 8-row band,
    the tiled approximation both packages compute)."""
    H, W = 64, 80
    disp, guide = _noisy_scene(H, W, 10 + n)
    kw = dict(ndisp=64, radius=radius, iters=iters, **PARAMS)
    want = np.asarray(jpar.bilateral_row_sharded(disp, guide, jax_mesh(n), "rows", **kw))
    bands = tpar.bilateral_row_sharded(torch.from_numpy(disp), torch.from_numpy(guide),
                                       cpu_mesh(n), **kw)
    assert len(bands) == n and all(b.shape == (H // n, W) for b in bands)
    got = torch.cat(bands).numpy()
    np.testing.assert_array_equal(got, want)
    if 2 * iters * radius <= H // n:
        np.testing.assert_array_equal(got, _port(disp, guide, **kw))


def test_row_sharded_takes_bands():
    """Band lists in, as the pipeline passes the rectified guide."""
    disp, guide = _noisy_scene(48, 64, 20)
    mesh = cpu_mesh(4)
    whole = tpar.bilateral_row_sharded(torch.from_numpy(disp), torch.from_numpy(guide), mesh)
    split = tpar.bilateral_row_sharded(mesh.split(torch.from_numpy(disp)),
                                       mesh.split(torch.from_numpy(guide)), mesh)
    for a, b in zip(whole, split):
        assert torch.equal(a, b)


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


def _pipeline_cfg(iters):
    return J.PipelineConfig(
        stereobm=J.StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5),
        speckle=J.SpeckleConfig(max_speckle_size=30, max_diff=2.0),
        bilateral=JBilateral(enabled=True, ndisp=16, radius=2, iters=iters))


def _assert_outputs_equal(got, want):
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


def _port_pipe(jm, cfg, **kw):
    kw.setdefault("device", None if "mesh" in kw else "cpu")
    return T.StereoPipeline.from_arrays(jm.rect_maps_stacked(), jm.Q, W, H, jm.fx,
                                        jm.baseline, T.from_jax_config(cfg), **kw)


@pytest.mark.parametrize("iters", [1, 3])
def test_pipeline_bilateral_matches_jax(jmodel, iters):
    """Every output with the bilateral branch on, against the JAX pipeline;
    the filter changed the disparity of some valid pixels."""
    cfg = _pipeline_cfg(iters)
    left, right, _ = T.synthetic_stereo_pair(H, W, 14, seed=7)
    jo = J.Outputs.all()
    want = J.StereoPipeline(jmodel, cfg, use_pallas=False).process(left, right, jo).fetch()
    pipe = _port_pipe(jmodel, cfg)
    got = pipe.process(left, right, T.from_jax_config(jo)).fetch()
    _assert_outputs_equal(got, want)
    off = _port_pipe(jmodel, cfg.replace(bilateral=JBilateral())).process(
        left, right, T.Outputs.of("disparity")).fetch()
    changed = got["disparity"] != off["disparity"]
    assert changed.any() and not (changed & ~got["disparity_valid"]).any()
    pipe.senders.shutdown()


def test_pipeline_bilateral_reconfigure(jmodel):
    """The reference's parameter names switch the filter on live."""
    pipe = _port_pipe(jmodel, _pipeline_cfg(1).replace(bilateral=JBilateral()))
    pipe.reconfigure(bilateral_filter=True, filter_radius=2, filter_iters=1, filter_ndisp=16)
    assert pipe.config.bilateral == T.from_jax_config(_pipeline_cfg(1).bilateral)
    left, right, _ = T.synthetic_stereo_pair(H, W, 14, seed=7)
    got = pipe.process(left, right, T.Outputs.of("disparity")).fetch()
    want = _port_pipe(jmodel, _pipeline_cfg(1)).process(
        left, right, T.Outputs.of("disparity")).fetch()
    _assert_outputs_equal(got, want)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_pipeline_bilateral_matches_jax(jmodel, n):
    """The pipeline's mesh branch (bands for every stage) against the JAX
    mesh pipeline on n virtual CPU devices."""
    cfg = _pipeline_cfg(1)
    left, right, _ = T.synthetic_stereo_pair(H, W, 14, seed=8)
    jo = J.Outputs.of("disparity", "disparity_vis", "rect_mono_left")
    want = J.StereoPipeline(jmodel, cfg, mesh=jax_mesh(n), use_pallas=False).process(
        left, right, jo).fetch()
    pipe = _port_pipe(jmodel, cfg, mesh=cpu_mesh(n))
    got = pipe.process(left, right, T.from_jax_config(jo)).fetch()
    _assert_outputs_equal(got, want)
    pipe.senders.shutdown()
