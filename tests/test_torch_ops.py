"""Op parity: the PyTorch port's ops against the JAX package's, on the same
numpy inputs made from a seed.

Where the JAX function reaches a Pallas kernel, it runs in the Pallas
interpreter, as the JAX package's own tests run it on the CPU.  On the CPU
the port's kernel wrappers run their plain versions (a CPU tensor never
launches a kernel); the kernels themselves are held against those plain
versions on a CUDA device by tests/test_torch_kernels.py and by
``chip_smoke.py``.

Tolerances: everything exact, except float32 remap (rtol 1e-6: XLA may
contract the weighted sum into fused multiply-adds) and the point cloud's
xyz (rtol 1e-6, same reason; NaN positions exact).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu import config as jconfig
from ros_gpu_stereo_processor_tpu.ops import color as jcolor
from ros_gpu_stereo_processor_tpu.ops import colormap as jcolormap
from ros_gpu_stereo_processor_tpu.ops import remap as jremap
from ros_gpu_stereo_processor_tpu.ops import reproject as jreproject
from ros_gpu_stereo_processor_tpu.ops import speckle as jspeckle
from ros_gpu_stereo_processor_tpu.ops import speckle_pallas as jspeckle_pallas
from ros_gpu_stereo_processor_tpu.ops import stereobm as jbm
from ros_gpu_stereo_processor_tpu.ops import stereobm_pallas as jbm_pallas
from ros_gpu_stereo_processor_tpu.utils import calib as jcal
from ros_gpu_stereo_processor_tpu.utils import msgs as jmsgs
from ros_gpu_stereo_processor_tpu_torch import config as tconfig
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import color as tcolor
from ros_gpu_stereo_processor_tpu_torch.ops import colormap as tcolormap
from ros_gpu_stereo_processor_tpu_torch.ops import remap as tremap
from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import reproject as treproject
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as tspeckle
from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as tbm
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm_kernel
from ros_gpu_stereo_processor_tpu_torch.utils import msgs as tmsgs
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

torch.set_num_threads(1)

H, W = 60, 80


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def rect_map():
    """A strongly distorted rectification map (D = [-0.37, 0.11, ...])."""
    K = np.array([[70.0, 0, 40], [0, 70.0, 30], [0, 0, 1.0]])
    P = np.hstack([np.array([[66.0, 0, 38], [0, 66.0, 29], [0, 0, 1.0]]), np.zeros((3, 1))])
    D = np.array([-0.37, 0.11, 0.001, -0.002, 0.0])
    return jcal.undistort_rectify_map(K, D, np.eye(3), P, (W, H))


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("obj", [
    jconfig.StereoBMConfig(num_disparities=32, block_size=9, refine_disparity=True),
    jconfig.SpeckleConfig(max_speckle_size=40, max_diff=2.5),
    jconfig.BilateralConfig(radius=5),
    jconfig.Outputs.of("disparity", "pointcloud"),
    jconfig.PipelineConfig(disparity_wire="fixed16",
                           stereobm=jconfig.StereoBMConfig(uniqueness_ratio=15)),
])
def test_from_jax_config(obj):
    got = tconfig.from_jax_config(obj)
    assert type(got).__module__ == tconfig.__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(obj)


# ---------------------------------------------------------------------------
# color
# ---------------------------------------------------------------------------

_RNG = np.random.default_rng(0)
_IMG = {
    "mono8": _RNG.integers(0, 256, (H, W), np.uint8),
    "mono16": _RNG.integers(0, 65536, (H, W), np.uint16),
    "rgb8": _RNG.integers(0, 256, (H, W, 3), np.uint8),
    "rgba8": _RNG.integers(0, 256, (H, W, 4), np.uint8),
}
_IMG["bgr8"] = _IMG["rgb8"]
_IMG["bgra8"] = _IMG["rgba8"]


@pytest.mark.parametrize("src,dst", [
    ("mono8", "mono8"), ("mono8", "mono16"), ("mono16", "mono8"),
    ("mono8", "rgb8"), ("mono16", "rgb8"), ("rgb8", "mono8"), ("bgr8", "mono8"),
    ("rgb8", "bgr8"), ("rgba8", "mono8"), ("bgra8", "rgb8"), ("rgb8", "bgra8"),
    ("rgb8", "mono16"),
])
def test_convert_exact(src, dst):
    img = _IMG[src]
    want = np.asarray(jcolor.convert(jnp.asarray(img), src, dst))
    got = tcolor.convert(_t(img), src, dst).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def test_bayer_not_ported_yet():
    """The Bayer conversion that used to raise (the debayer was not ported)
    now equals the JAX package's, exactly; tests/test_torch_color_bayer.py
    covers every phase, dtype and target."""
    img = _IMG["mono8"]
    want = np.asarray(jcolor.convert(jnp.asarray(img), "bayer_rggb8", "rgb8"))
    got = tcolor.convert(_t(img), "bayer_rggb8", "rgb8").numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# remap (plain version of kernel K1)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["mono8", "rgb8"])
def test_remap_uint8_exact(rect_map, kind):
    img = _IMG[kind]
    want = np.asarray(jremap.remap_bilinear(jnp.asarray(img), jnp.asarray(rect_map)))
    got = tremap.remap_bilinear(_t(img), _t(rect_map)).numpy()
    np.testing.assert_array_equal(got, want)


def test_remap_float32(rect_map):
    img = (np.random.default_rng(1).random((H, W)) * 100).astype(np.float32)
    want = np.asarray(jremap.remap_bilinear(jnp.asarray(img), jnp.asarray(rect_map)))
    got = tremap.remap_bilinear(_t(img), _t(rect_map)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_rectify_dispatch_cpu(rect_map):
    """A CPU stack runs the plain version, side by side, and launches nothing."""
    maps = np.stack([rect_map, rect_map[::-1].copy()])
    imgs = np.stack([_IMG["rgb8"], _IMG["rgb8"][::-1]])
    before = {k: v.launches for k, v in _build.kernels().items()}
    got = remap_kernel.rectify(_t(imgs), _t(maps)).numpy()
    want = np.asarray(jremap.rectify_pair(jnp.asarray(imgs), jnp.asarray(maps)))
    np.testing.assert_array_equal(got, want)
    assert {k: v.launches for k, v in _build.kernels().items()} == before


# ---------------------------------------------------------------------------
# block matching (plain version of kernel K2)
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def bm_pair():
    left, right, _ = synthetic_stereo_pair(40, 112, max_disparity=40, seed=4)
    return left, right


BM_CONFIGS = [
    dict(num_disparities=64, block_size=15, texture_threshold=10),   # the default
    dict(num_disparities=32, block_size=9, refine_disparity=True),
    dict(num_disparities=32, block_size=7, uniqueness_ratio=15),
    dict(num_disparities=16, block_size=5, min_disparity=-4, xsobel=False),
]


@pytest.mark.parametrize("kw", BM_CONFIGS)
def test_disparity_matches_jnp_oracle(bm_pair, kw):
    left, right = bm_pair
    jcfg = jconfig.StereoBMConfig(**kw)
    cfg = tconfig.from_jax_config(jcfg)
    jd, jv = jbm.compute_disparity(jnp.asarray(left), jnp.asarray(right), jcfg)
    for fn in (tbm.compute_disparity, stereobm_kernel.compute_disparity_fused):
        d, v = fn(_t(left), _t(right), cfg)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert 0.1 < np.asarray(jv).mean()


@pytest.mark.parametrize("kw", BM_CONFIGS[:3])
def test_disparity_matches_pallas_interpreter(bm_pair, kw):
    left, right = bm_pair
    jcfg = jconfig.StereoBMConfig(**kw)
    jd, jv = jbm_pallas.compute_disparity_fused(
        jnp.asarray(left), jnp.asarray(right), jcfg, tile_h=16)
    d, v = stereobm_kernel.compute_disparity_fused(
        _t(left), _t(right), tconfig.from_jax_config(jcfg))
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_fused_raw_plain_matches_cost_volume(bm_pair):
    """The raw maps: argmin with ties to the smallest d, and the best cost
    outside best±1, from the cost volume of the JAX oracle."""
    left, right = bm_pair
    cfg = tconfig.StereoBMConfig(num_disparities=32, block_size=9, uniqueness_ratio=10)
    jcfg = jconfig.StereoBMConfig(num_disparities=32, block_size=9, uniqueness_ratio=10)
    lf, rf = jbm.prefilter(jnp.asarray(left), jcfg), jbm.prefilter(jnp.asarray(right), jcfg)
    cost = np.asarray(jbm.sad_cost_volume(lf, rf, jcfg))
    disp, best_cost, excl = stereobm_kernel.fused_raw(
        _t(np.asarray(lf)), _t(np.asarray(rf)), cfg)
    best = np.argmin(cost, axis=0)
    np.testing.assert_array_equal(disp.numpy(), best.astype(np.float32))
    np.testing.assert_array_equal(best_cost.numpy(), cost.min(axis=0))
    far = np.abs(np.arange(32)[:, None, None] - best[None]) > 1
    np.testing.assert_array_equal(excl.numpy(), np.where(far, cost, 1e9).min(axis=0))


@pytest.mark.parametrize("kw", [BM_CONFIGS[1], BM_CONFIGS[3]])
def test_lr_check_not_ported_yet(bm_pair, kw):
    """The left-right check, once the one piece not ported, now exact against
    both JAX forms: the oracle's right disparity from the shared cost volume
    (with its two halves ``right_disparity_from_cost`` and
    ``left_right_check``), and the fused path's mirrored second matcher
    launch in the Pallas interpreter."""
    left, right = bm_pair
    jcfg = jconfig.StereoBMConfig(lr_check=True, **kw)
    cfg = tconfig.from_jax_config(jcfg)
    jd, jv = jbm.compute_disparity(jnp.asarray(left), jnp.asarray(right), jcfg)
    d, v = tbm.compute_disparity(_t(left), _t(right), cfg)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))
    assert 0.1 < np.asarray(jv).mean()

    jlf, jrf = (jbm.prefilter(jnp.asarray(a), jcfg) for a in (left, right))
    jcost = jbm.sad_cost_volume(jlf, jrf, jcfg)
    jdr = jbm.right_disparity_from_cost(jcost, jcfg)
    dr = tbm.right_disparity_from_cost(_t(jcost), cfg)
    np.testing.assert_array_equal(dr.numpy(), np.asarray(jdr))
    jdl, _ = jbm.wta_disparity(jcost, jlf, jcfg)
    np.testing.assert_array_equal(
        tbm.left_right_check(_t(jdl), dr, cfg, cfg.lr_max_diff).numpy(),
        np.asarray(jbm.left_right_check(jdl, jdr, jcfg, jcfg.lr_max_diff)))

    jd, jv = jbm_pallas.compute_disparity_fused(
        jnp.asarray(left), jnp.asarray(right), jcfg, tile_h=16)
    d, v = stereobm_kernel.compute_disparity_fused(_t(left), _t(right), cfg)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_valid_window_matches():
    for kw in BM_CONFIGS:
        assert tbm.valid_window(tconfig.StereoBMConfig(**kw), 480, 752) == \
            jbm.valid_window(jconfig.StereoBMConfig(**kw), 480, 752)


# ---------------------------------------------------------------------------
# speckle (plain version of kernel K3, and the exact sizing)
# ---------------------------------------------------------------------------


def _speckle_case(shape, seed=7):
    rng = np.random.default_rng(seed)
    disp = (rng.random(shape) * 40).astype(np.float32)
    disp[10:20, 30:60] = 12.0          # flat patch → one big component
    disp[2:5, 2:5] = 33.0              # small speckle
    valid = rng.random(shape) > 0.3
    return disp, valid


@pytest.mark.parametrize("iters", [1, 3, 64])
def test_labels_match_scan_and_pallas(iters):
    disp, valid = _speckle_case((40, 70))
    want = np.asarray(jspeckle._labels_scan(jnp.asarray(disp), jnp.asarray(valid), 5.0, iters))
    pal = np.asarray(jspeckle_pallas.labels_pallas(
        jnp.asarray(disp), jnp.asarray(valid), 5.0, iters))
    got = speckle_kernel.labels(_t(disp), _t(valid), 5.0, iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), pal)


@pytest.mark.parametrize("T", [0, 5, 50, 40 * 70])
def test_filter_speckles_exact(T):
    disp, valid = _speckle_case((40, 70), seed=11)
    jd, jk = jspeckle.filter_speckles(jnp.asarray(disp), jnp.asarray(valid), T, 5.0, 8, -1.0)
    d, k = tspeckle.filter_speckles(_t(disp), _t(valid), T, 5.0, 8, -1.0)
    np.testing.assert_array_equal(k.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


def test_keep_decision_exact_on_unconverged_labels():
    """Sizing is bincount(lab)[lab] > T for any label image."""
    rng = np.random.default_rng(3)
    lab = rng.integers(0, 30, (24, 33)).astype(np.int32)
    lab[rng.random(lab.shape) < 0.2] = lab.size          # invalid sentinel
    for T in (0, 10, 25, 40, lab.size):
        want = np.bincount(lab.ravel(), minlength=lab.size + 1)[lab] > T
        got = tspeckle._keep_large_components(_t(lab), T).numpy()
        np.testing.assert_array_equal(got, want)


def test_sizing_refuses_mismatched_shapes():
    disp, valid = _speckle_case((12, 20))
    lab = speckle_kernel.labels(_t(disp), _t(valid), 5.0, 8)
    with pytest.raises(ValueError, match="sizing wants"):
        speckle_kernel.sizing(_t(disp), _t(valid), lab[:, :-1], 10, -1.0)
    with pytest.raises(ValueError, match="sizing wants"):
        speckle_kernel.sizing(_t(disp).reshape(-1), _t(valid).reshape(-1), lab.reshape(-1),
                              10, -1.0)


# ---------------------------------------------------------------------------
# colormap, reprojection, wire codecs
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nd", [64, 48, 128])
def test_colorize_disparity_exact(nd):
    rng = np.random.default_rng(5)
    d = (rng.random((H, W)) * (nd + 8) - 3).astype(np.float32)
    v = rng.random((H, W)) > 0.2
    want = np.asarray(jcolormap.colorize_disparity(jnp.asarray(d), nd, jnp.asarray(v)))
    got = tcolormap.colorize_disparity(_t(d), nd, _t(v)).numpy()
    np.testing.assert_array_equal(got, want)


def test_point_cloud():
    rng = np.random.default_rng(6)
    d = (rng.random((H, W)) * 70 - 3).astype(np.float32)
    v = rng.random((H, W)) > 0.2
    rgb = _IMG["rgb8"]
    K = np.array([[70.0, 0, 40], [0, 70.0, 30], [0, 0, 1.0]])
    P = np.hstack([K, np.zeros((3, 1))])
    PR = P.copy()
    PR[0, 3] = -7.0
    model = jcal.StereoCameraModel.from_calibs(
        jcal.CameraCalib(W, H, K, np.zeros(5), np.eye(3), P),
        jcal.CameraCalib(W, H, K, np.zeros(5), np.eye(3), PR))
    Q = model.Q.astype(np.float32)
    want = jreproject.point_cloud(jnp.asarray(d), jnp.asarray(Q), rgb=jnp.asarray(rgb),
                                  valid=jnp.asarray(v))
    got = treproject.point_cloud(_t(d), _t(Q), rgb=_t(rgb), valid=_t(v))
    wx, gx = np.asarray(want["xyz"]), got["xyz"].numpy()
    np.testing.assert_array_equal(np.isnan(gx), np.isnan(wx))
    assert (~np.isnan(gx)).any()
    np.testing.assert_allclose(gx, wx, rtol=1e-6, atol=0)
    # packed 0x00RRGGBB bit patterns are denormal floats: compare the bits
    np.testing.assert_array_equal(got["rgb"].view(torch.int32).numpy(),
                                  np.asarray(want["rgb"]).view(np.int32))


def test_timing_helpers(tmp_path):
    from ros_gpu_stereo_processor_tpu_torch.utils import timing

    timer = timing.StageTimer()
    x = torch.arange(1000.0)
    with timer.stage("sum", block_on={"x": x, "pair": (x, x)}):
        y = (x * 2).sum()
    out, ms = timing.timed(lambda: y + 1, "cpu")
    assert out == y + 1 and ms >= 0
    assert timer.as_dict()["sum"]["count"] == 1 and "sum(" in timer.timing_line()
    with timing.trace(str(tmp_path)) as prof:
        (x + 1).sum()
    assert prof.key_averages() and (tmp_path / "trace.json").exists()


def test_disparity_wire_codecs():
    rng = np.random.default_rng(8)
    d = (np.round(rng.random((H, W)) * 64 * 16) / 16 - 0.5).astype(np.float32)
    d[rng.random((H, W)) < 0.2] = -1.0
    np.testing.assert_array_equal(tmsgs.disparity_fixed16(_t(d)).numpy(),
                                  np.asarray(jmsgs.disparity_fixed16(jnp.asarray(d))))
    np.testing.assert_array_equal(tmsgs.disparity_fixed8(_t(d), 0).numpy(),
                                  np.asarray(jmsgs.disparity_fixed8(jnp.asarray(d), 0)))
    with pytest.raises(ValueError):
        tmsgs.disparity_fixed8(_t(d), -1)
