"""Row-band frontend parity: the PyTorch port's band mesh on the CPU
(``make_mesh(n, devices=["cpu"] * n)``, so the plain versions of the
kernels) against the JAX package's sharded functions on the virtual CPU
mesh (``make_mesh(n)``, ``use_pallas=False`` unless a case says otherwise),
on the same numpy inputs from a seed, at 64×96 and 96×128.

Tolerances: exact, except the SGM disparity (atol 1e-5, the bar of
tests/test_parallel.py for the row-band SGM) and ``pointcloud_xyz`` (rtol
1e-6, NaN positions exact — XLA may fuse the Q products into multiply-adds).
Every parity test runs n ∈ {2, 4, 8}: an off-by-band error in global row
coordinates shows only at n > 1."""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

import ros_gpu_stereo_processor_tpu as J
from ros_gpu_stereo_processor_tpu.config import BilateralConfig as JBilateral
from ros_gpu_stereo_processor_tpu.ops import remap as jremap
from ros_gpu_stereo_processor_tpu.ops import speckle as jspeckle
from ros_gpu_stereo_processor_tpu.parallel import frontend as jpar
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
from ros_gpu_stereo_processor_tpu.utils.calib import CameraCalib as JCalib
import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as tspeckle
from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel
from ros_gpu_stereo_processor_tpu_torch.parallel import frontend as tpar
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
from ros_gpu_stereo_processor_tpu_torch.utils import calib as tcalib

torch.set_num_threads(1)

NS = [2, 4, 8]


def cpu_mesh(n):
    return make_mesh(n, devices=["cpu"] * n)


def whole(bands):
    return torch.cat(bands).numpy()


def _pair(H, W, max_disparity=20, seed=0):
    left, right, _ = T.synthetic_stereo_pair(H, W, max_disparity, seed=seed)
    return left, right


# ---------------------------------------------------------------------------
# K7's plain version and the band mesh
# ---------------------------------------------------------------------------


def _maxprop_case(H=48, W=80, seed=7):
    rng = np.random.default_rng(seed)
    disp = np.where(rng.random((H, W)) < 0.7,
                    rng.integers(0, 3, (H, W)).astype(np.float32) * 6.0, -1.0)
    valid = disp >= 0
    field = rng.integers(0, 900, (H, W)).astype(np.int32)
    return disp.astype(np.float32), valid, field


@pytest.mark.parametrize("iters", [1, 3, 200])
def test_max_propagate_matches_jax(iters):
    disp, valid, field = _maxprop_case()
    jcx, jcy = jspeckle._connectivity(jnp.asarray(disp), jnp.asarray(valid), 2.0)
    want = np.asarray(jspeckle._max_propagate(jnp.asarray(field), jcx, jcy, iters))
    tcx, tcy = tspeckle._connectivity(torch.from_numpy(disp), torch.from_numpy(valid), 2.0)
    np.testing.assert_array_equal(np.asarray(tcx), np.asarray(jcx))
    np.testing.assert_array_equal(np.asarray(tcy), np.asarray(jcy))
    got = speckle_kernel.max_propagate(torch.from_numpy(field), tcx, tcy, iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if iters == 1:      # one round cannot reach the fixed point of this field
        assert not np.array_equal(want, np.asarray(
            jspeckle._max_propagate(jnp.asarray(field), jcx, jcy, 200)))


def test_max_propagate_matches_pallas_interpret():
    """K7's TPU kernel in the Pallas interpreter, once."""
    from ros_gpu_stereo_processor_tpu.ops.speckle_pallas import max_propagate_pallas

    disp, valid, field = _maxprop_case(24, 40, seed=3)
    jcx, jcy = jspeckle._connectivity(jnp.asarray(disp), jnp.asarray(valid), 2.0)
    want = np.asarray(max_propagate_pallas(jnp.asarray(field), jcx, jcy, 32))
    tcx, tcy = tspeckle._connectivity(torch.from_numpy(disp), torch.from_numpy(valid), 2.0)
    got = speckle_kernel.max_propagate(torch.from_numpy(field), tcx, tcy, 32)
    np.testing.assert_array_equal(got.numpy(), want)


def test_band_labels_plain_rounds():
    """The band-local label rounds: 2 row/column min-scan rounds of a given
    field, the JAX band's ``local_scans``."""
    disp, valid, field = _maxprop_case(seed=5)
    jcx, jcy = jspeckle._connectivity(jnp.asarray(disp), jnp.asarray(valid), 2.0)
    lab = jnp.asarray(field)
    for _ in range(2):
        lab = jspeckle._segmented_min_scan(lab, jcx, axis=1)
        lab = jspeckle._segmented_min_scan(lab, jcy, axis=0)
    tcx, tcy = (torch.from_numpy(np.array(c)) for c in (jcx, jcy))
    got = speckle_kernel.band_labels(torch.from_numpy(field), tcx, tcy, 2)
    np.testing.assert_array_equal(got.numpy(), np.asarray(lab))


def test_band_mesh():
    mesh = cpu_mesh(4)
    assert mesh.shape["rows"] == 4 and mesh.axis_names == ("rows",)
    x = torch.arange(8 * 3).reshape(8, 3)
    bands = mesh.split(x)
    assert [tuple(b.shape) for b in bands] == [(2, 3)] * 4
    torch.testing.assert_close(mesh.gather(bands), x)
    ext = tpar.halo_exchange(mesh, bands, 1)
    torch.testing.assert_close(ext[1], x[1:5])
    torch.testing.assert_close(ext[0][0], torch.zeros(3, dtype=x.dtype))
    torch.testing.assert_close(ext[3][-1], torch.zeros(3, dtype=x.dtype))
    with pytest.raises(ValueError):
        mesh.split(torch.zeros(6, 3))
    with pytest.raises(ValueError):
        make_mesh(2, devices=["cpu"])
    if torch.cuda.is_available():
        assert all(d.type == "cuda" for d in make_mesh(1).devices)
    else:
        with pytest.raises(ValueError, match="CUDA"):
            make_mesh(2)        # no devices given: CUDA only, never the CPU


# ---------------------------------------------------------------------------
# Rectification and matching
# ---------------------------------------------------------------------------


def _maps(H, W):
    K = np.array([[0.9 * W, 0, W / 2], [0, 0.9 * W, H / 2], [0, 0, 1.0]])
    P = np.hstack([np.array([[0.85 * W, 0, W / 2 - 2], [0, 0.85 * W, H / 2 - 1],
                             [0, 0, 1.0]]), np.zeros((3, 1))])
    D = np.array([-0.37, 0.11, 0.001, -0.002, 0.0])
    return tcalib.undistort_rectify_map(K, D, np.eye(3), P, (W, H))


@pytest.mark.parametrize("n", NS)
def test_remap_row_sharded_uint8(n):
    H, W = 64, 96
    rng = np.random.default_rng(n)
    m = _maps(H, W)
    maps = np.stack([m, m[:, ::-1].copy()])
    imgs = rng.integers(0, 256, (2, H, W, 3), np.uint8)
    got = tpar.remap_row_sharded(torch.from_numpy(imgs), torch.from_numpy(maps), cpu_mesh(n))
    want = np.stack([np.asarray(jremap.remap_bilinear(jnp.asarray(imgs[s]), jnp.asarray(maps[s])))
                     for s in range(2)])
    np.testing.assert_array_equal(torch.cat(got, dim=1).numpy(), want)


BM_CASES = {
    "xsobel_texture": dict(num_disparities=32, block_size=9, texture_threshold=10),
    "normalized": dict(num_disparities=32, block_size=9, texture_threshold=10,
                       xsobel=False, uniqueness_ratio=10),
    "refine": dict(num_disparities=32, block_size=7, refine_disparity=True, min_disparity=2),
}


@pytest.mark.parametrize("case", list(BM_CASES))
@pytest.mark.parametrize("n", NS)
def test_disparity_row_sharded_matches_jax(n, case):
    left, right = _pair(96, 128, 24, seed=n)
    cfg = J.StereoBMConfig(**BM_CASES[case])
    jd, jv = jpar.disparity_row_sharded(jnp.asarray(left), jnp.asarray(right), cfg,
                                        jax_mesh(n))
    d, v = tpar.disparity_row_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                      T.from_jax_config(cfg), cpu_mesh(n))
    np.testing.assert_array_equal(whole(v), np.asarray(jv))
    np.testing.assert_array_equal(whole(d), np.asarray(jd))
    assert 0.3 < whole(v).mean()


@pytest.mark.parametrize("n", NS)
def test_disparity_row_sharded_equals_one_device(n):
    """Bands give the single-device matcher's result: prefilter halo rows,
    texture sums and border gates by image row, for both prefilters."""
    from ros_gpu_stereo_processor_tpu_torch.ops import stereobm_kernel

    left, right = (torch.from_numpy(a) for a in _pair(64, 96, 16, seed=n + 10))
    for xsobel in (True, False):
        cfg = T.StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5,
                               xsobel=xsobel)
        d, v = tpar.disparity_row_sharded(left, right, cfg, cpu_mesh(n))
        want_d, want_v = stereobm_kernel.compute_disparity_fused(left, right, cfg)
        np.testing.assert_array_equal(whole(v), want_v.numpy())
        np.testing.assert_array_equal(whole(d), want_d.numpy())


def test_disparity_row_sharded_lr_check_matches_jax_pallas():
    """The band lr_check is the mirrored second K2 launch on the extended
    band, the JAX band's ``use_pallas`` definition (frontend.py:116-126);
    the JAX side runs its fused kernel in the Pallas interpreter."""
    left, right = _pair(64, 96, 16, seed=2)
    cfg = J.StereoBMConfig(num_disparities=16, block_size=5, lr_check=True)
    for n in NS:
        jd, jv = jpar.disparity_row_sharded(jnp.asarray(left), jnp.asarray(right), cfg,
                                            jax_mesh(n), use_pallas=True)
        d, v = tpar.disparity_row_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                          T.from_jax_config(cfg), cpu_mesh(n))
        np.testing.assert_array_equal(whole(v), np.asarray(jv))
        np.testing.assert_array_equal(whole(d), np.asarray(jd))


@pytest.mark.parametrize("lr_check", [False, True], ids=["plain", "lr_check"])
@pytest.mark.parametrize("n", NS)
def test_disparity_sgm_row_sharded_matches_jax(n, lr_check):
    left, right = _pair(64, 96, 16, seed=n + 3)
    cfg = J.StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5,
                           refine_disparity=not lr_check, lr_check=lr_check)
    jd, jv = jpar.disparity_sgm_row_sharded(jnp.asarray(left), jnp.asarray(right), cfg,
                                            jax_mesh(n), p1=8.0, p2=90.0, warmup_rows=12)
    d, v = tpar.disparity_sgm_row_sharded(torch.from_numpy(left), torch.from_numpy(right),
                                          T.from_jax_config(cfg), cpu_mesh(n),
                                          p1=8.0, p2=90.0, warmup_rows=12)
    np.testing.assert_array_equal(whole(v), np.asarray(jv))
    np.testing.assert_allclose(whole(d), np.asarray(jd), rtol=0, atol=1e-5)
    assert 0.3 < whole(v).mean()


# ---------------------------------------------------------------------------
# The sharded speckle filter (K7's caller)
# ---------------------------------------------------------------------------


def _speckle_scene(H=64, W=96, seed=3):
    """tests/test_parallel.py's scene: planted speckles of known sizes, some
    spanning band boundaries."""
    rng = np.random.default_rng(seed)
    disp = np.full((H, W), 20.0, np.float32)
    valid = np.ones((H, W), bool)
    disp[10:13, 10:13] = 50.0
    disp[14:19, 40:44] = 55.0
    disp[20:52, 60:66] = 60.0
    valid[30:33, 10:12] = False
    disp += rng.normal(0, 0.1, disp.shape).astype(np.float32)
    return disp, valid


def _random_field(seed=11):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 32, (96, 128)).astype(np.float32),
            rng.random((96, 128)) > 0.2)


SPECKLE_CASES = {
    "scene": (_speckle_scene, dict(max_speckle_size=30, max_diff=2.0)),
    "random": (_random_field, dict(max_speckle_size=20, max_diff=1.0)),
    "merge_rounds": (_random_field, dict(max_speckle_size=20, max_diff=1.0, merge_rounds=2)),
}


@pytest.mark.parametrize("case", list(SPECKLE_CASES))
@pytest.mark.parametrize("n", NS)
def test_filter_speckles_row_sharded_matches_jax(n, case):
    make, kw = SPECKLE_CASES[case]
    disp, valid = make()
    jd, jv = jpar.filter_speckles_row_sharded(jnp.asarray(disp), jnp.asarray(valid),
                                              jax_mesh(n), iters=16, fill_value=-1.0, **kw)
    d, v = tpar.filter_speckles_row_sharded(torch.from_numpy(disp), torch.from_numpy(valid),
                                            cpu_mesh(n), iters=16, fill_value=-1.0, **kw)
    np.testing.assert_array_equal(whole(v), np.asarray(jv))
    np.testing.assert_array_equal(whole(d), np.asarray(jd))
    assert whole(v).sum() < valid.sum()          # something was filtered


# ---------------------------------------------------------------------------
# StereoPipeline(mesh=...)
# ---------------------------------------------------------------------------

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


def _port(jm, cfg, mesh=None, device=None, **kw):
    """The port's pipeline: on ``mesh`` (its first device), else on the CPU."""
    if device is None and mesh is None:
        device = "cpu"
    return T.StereoPipeline.from_arrays(
        jm.rect_maps_stacked(), jm.Q, W, H, jm.fx, jm.baseline, T.from_jax_config(cfg),
        device=device, mesh=mesh, **kw)


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


_BM = J.StereoBMConfig(num_disparities=16, block_size=5, texture_threshold=5)
PIPE_CASES = {
    "speckle_off": J.PipelineConfig(stereobm=_BM, speckle=J.SpeckleConfig(max_speckle_size=0)),
    "speckle_on": J.PipelineConfig(stereobm=_BM, speckle=J.SpeckleConfig(
        max_speckle_size=30, max_diff=2.0)),
    "sgm": J.PipelineConfig(stereobm=_BM.replace(algorithm="sgm"),
                            speckle=J.SpeckleConfig(max_speckle_size=30, max_diff=2.0)),
}


@pytest.mark.parametrize("case", list(PIPE_CASES))
def test_mesh_pipeline_matches_jax(jmodel, case):
    cfg = PIPE_CASES[case]
    left, right = _pair(H, W, 14, seed=2)
    jo = J.Outputs.all()
    want = J.StereoPipeline(jmodel, cfg, mesh=jax_mesh(8), use_pallas=False).process(
        left, right, jo).fetch()
    pipe = _port(jmodel, cfg, mesh=cpu_mesh(8))
    got = pipe.process(left, right, T.from_jax_config(jo)).fetch()
    _assert_outputs_equal(got, want)
    assert 0.3 < got["disparity_valid"].mean()
    pipe.senders.shutdown()


def test_mesh_pipeline_batch_and_timed(jmodel):
    """process_batch and timed_process under a mesh give process's outputs."""
    cfg = PIPE_CASES["speckle_on"]
    pipe = _port(jmodel, cfg, mesh=cpu_mesh(4))
    frames = [_pair(H, W, 14, seed=s) for s in (5, 6)]
    out = T.Outputs.of("disparity", "disparity_vis")
    batch = pipe.process_batch(np.stack([f[0] for f in frames]),
                               np.stack([f[1] for f in frames]), out)
    for i, (left, right) in enumerate(frames):
        res, ms = pipe.timed_process(left, right, out)
        assert ms > 0
        for k, v in res.fetch().items():
            np.testing.assert_array_equal(batch[k][i].numpy(), v)
    pipe.senders.shutdown()


def test_mesh_pipeline_raises(jmodel):
    left, right = _pair(H, W, 14, seed=2)
    out = T.Outputs.of("disparity")
    with pytest.raises(ValueError, match="divisible"):
        _port(jmodel, PIPE_CASES["speckle_off"], mesh=cpu_mesh(5))
    with pytest.raises(ValueError, match="first device"):
        _port(jmodel, PIPE_CASES["speckle_off"], mesh=cpu_mesh(4), device="cuda")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        _port(jmodel, PIPE_CASES["speckle_off"], mesh=cpu_mesh(4),
              shard_mode="disp").process(left, right, out)
    # the bilateral filter, which raised here before it was ported, runs by
    # band and equals the single-device pipeline
    bl = PIPE_CASES["speckle_off"].replace(bilateral=JBilateral(enabled=True))
    np.testing.assert_array_equal(
        _port(jmodel, bl, mesh=cpu_mesh(4)).process(left, right, out).fetch()["disparity"],
        _port(jmodel, bl).process(left, right, out).fetch()["disparity"])
    with pytest.raises(ValueError):
        tpar.disparity_row_sharded(torch.zeros(30, 96, dtype=torch.uint8),
                                   torch.zeros(30, 96, dtype=torch.uint8),
                                   T.StereoBMConfig(), cpu_mesh(4))
