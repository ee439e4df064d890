"""Disparity-slab block matching: the port's ``disparity_slab_sharded`` on a
CPU mesh (``make_mesh(n, devices=["cpu"] * n)``) against the JAX package's
on the conftest's virtual CPU mesh, on the same numpy inputs from a seed,
and the port's ``StereoPipeline(mesh=..., shard_mode="disp")`` against the
JAX pipeline's slab mode.

Tolerances: exact (validity and disparity), except with subpixel
refinement on, where the disparity is held within atol 1e-4 (the bar of
tests/test_parallel.py for the slab refinement; validity stays exact), and
``pointcloud_xyz`` within rtol 1e-6 with its NaN positions exact (XLA may
fuse the Q products into multiply-adds)."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ros_gpu_stereo_processor_tpu as J
from ros_gpu_stereo_processor_tpu.config import BilateralConfig as JBilateral
from ros_gpu_stereo_processor_tpu.parallel import frontend as jpar
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as tbm
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as tpar
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh

torch.set_num_threads(1)


def cpu_mesh(n, axis="disp"):
    return make_mesh(n, (axis,), devices=["cpu"] * n)


@pytest.fixture(scope="module")
def pair():
    left, right, _ = T.synthetic_stereo_pair(96, 256, 40, seed=0)
    return left, right


def _both(pair, jcfg, n):
    left, right = pair
    jd, jv = jpar.disparity_slab_sharded(jnp.asarray(left), jnp.asarray(right), jcfg,
                                         jax_mesh(n, ("disp",)), axis="disp")
    d, v = tpar.disparity_slab_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                       T.from_jax_config(jcfg), cpu_mesh(n))
    return (np.asarray(jd), np.asarray(jv)), (d.numpy(), v.numpy())


@pytest.mark.parametrize("n", [2, 4, 8])
def test_slab_matches_jax_and_one_device(pair, n):
    jcfg = J.StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10)
    (jd, jv), (d, v) = _both(pair, jcfg, n)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(d, jd)
    assert 0.3 < v.mean()
    od, ov = tbm.compute_disparity(*(torch.from_numpy(a) for a in pair),
                                   T.from_jax_config(jcfg))
    np.testing.assert_array_equal(v, ov.numpy())
    np.testing.assert_array_equal(d, od.numpy())


@pytest.mark.parametrize("n", [2, 4])
def test_slab_subpixel_uniqueness_matches_jax(pair, n):
    """Refinement takes neighbour planes across slab edges and the owner's
    cost by a psum; uniqueness is a pmin.  Validity exact, disparity within
    1e-4 of JAX's slabs and of the port's one-device matcher."""
    jcfg = J.StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=10,
                            refine_disparity=True, uniqueness_ratio=10)
    (jd, jv), (d, v) = _both(pair, jcfg, n)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_allclose(d, jd, rtol=0, atol=1e-4)
    od, ov = tbm.compute_disparity(*(torch.from_numpy(a) for a in pair),
                                   T.from_jax_config(jcfg))
    np.testing.assert_array_equal(v, ov.numpy())
    np.testing.assert_allclose(d, od.numpy(), rtol=0, atol=1e-4)
    assert (d != np.round(d)).any()            # refinement moved some pixels


def test_slab_128_disparities_over_8(pair):
    """BASELINE config 3's geometry: a 128-candidate search in 8 slabs."""
    jcfg = J.StereoBMConfig(num_disparities=128, block_size=9, texture_threshold=10)
    (jd, jv), (d, v) = _both(pair, jcfg, 8)
    np.testing.assert_array_equal(v, jv)
    np.testing.assert_array_equal(d, jd)


def test_slab_cost_volume_and_checks():
    """A slab of ``sad_cost_volume`` is those planes of the whole volume;
    an indivisible range raises; row bands are accepted as input."""
    left, right, _ = T.synthetic_stereo_pair(32, 64, 10, seed=4)
    cfg = T.StereoBMConfig(num_disparities=16, block_size=5, min_disparity=-2)
    lf, rf = (tbm.prefilter(torch.from_numpy(a), cfg) for a in (left, right))
    whole = tbm.sad_cost_volume(lf, rf, cfg)
    for off, k in ((0, 4), (4, 4), (12, 4), (3, 7)):
        torch.testing.assert_close(tbm.sad_cost_volume(lf, rf, cfg, off, k),
                                   whole[off:off + k], rtol=0, atol=0)
    with pytest.raises(ValueError, match="divisible"):
        tpar.disparity_slab_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                    cfg, cpu_mesh(3))
    mesh = cpu_mesh(4, "rows")
    bands = [mesh.split(torch.from_numpy(a)) for a in (left, right)]
    got = tpar.disparity_slab_sharded(*bands, cfg, mesh, "rows")
    want = tbm.compute_disparity(torch.from_numpy(left), torch.from_numpy(right), cfg)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _pipeline_pair():
    """tests/test_parallel.py's ``_mesh_pipeline_pair``: 64×96, no
    distortion, baseline 0.1."""
    H, W = 64, 96
    K = np.array([[80.0, 0, W / 2], [0, 80.0, H / 2], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    Pr = P.copy()
    Pr[0, 3] = -8.0
    mk = lambda PP, nm: JCalib(W, H, K, np.zeros(5), np.eye(3), PP, nm)   # noqa: E731
    model = J.StereoCameraModel.from_calibs(mk(P, "left"), mk(Pr, "right"))
    left, right, _ = T.synthetic_stereo_pair(H, W, 14, seed=2)
    return model, left, right


@pytest.mark.parametrize("speckle", [0, 30], ids=["speckle_off", "speckle_on"])
def test_slab_pipeline_matches_jax(speckle):
    """``test_pipeline_mesh_parity("disp")``'s setup (16 disparities over
    8 slabs, refinement and the bilateral filter on), and the same with the
    row-band speckle filter on after the slabs, against the JAX pipeline's
    slab mode on its 8-device mesh."""
    model, left, right = _pipeline_pair()
    jcfg = J.PipelineConfig(
        stereobm=J.StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5,
                                  refine_disparity=True),
        speckle=J.SpeckleConfig(max_speckle_size=speckle, max_diff=2.0),
        bilateral=JBilateral(enabled=True, radius=2, iters=1, ndisp=16),
    )
    jout = J.Outputs.of("disparity", "disparity_vis", "pointcloud", "rect_mono_left",
                        "mono_right")
    want = J.StereoPipeline(model, jcfg, mesh=jax_mesh(8, ("rows",)),
                            shard_mode="disp").process(left, right, jout).fetch()
    H, W = left.shape
    pipe = T.StereoPipeline.from_arrays(
        model.rect_maps_stacked(), model.Q, W, H, model.fx, model.baseline,
        T.from_jax_config(jcfg), mesh=cpu_mesh(8, "rows"), shard_mode="disp")
    got = pipe.process(left, right, T.from_jax_config(jout)).fetch()
    pipe.senders.shutdown()
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.dtype == w.dtype and g.shape == w.shape, k
        if k == "pointcloud_xyz":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        elif k == "disparity":
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-4)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)
    assert 0.3 < got["disparity_valid"].mean()
