"""The port's hand-written CUDA kernels against their plain PyTorch versions,
both on the card.  Every test needs a CUDA device and skips elsewhere (a
CUDA kernel has no CPU mode); the parity of the plain versions with the JAX
package is tested on the CPU by the other test_torch_* files.

This file imports neither jax nor the JAX package, so it also runs on a
machine without them:

    python -m pytest --noconftest -m cuda tests/test_torch_kernels.py

All comparisons are exact: the kernels repeat the plain versions' float32
operations step by step (remap, float images in the block matcher and the
SGM's float32 storage), sum small integers (block matcher, SGM cost in
integer storage) or move integer labels (speckle).
"""

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import remap
from ros_gpu_stereo_processor_tpu_torch.ops import remap_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import sgm
from ros_gpu_stereo_processor_tpu_torch.ops import sgm_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import speckle
from ros_gpu_stereo_processor_tpu_torch.ops import speckle_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm_kernel
from ros_gpu_stereo_processor_tpu_torch.utils import calib
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

torch.set_num_threads(1)
pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _exact(got, want):
    torch.cuda.synchronize()
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _maps(H, W, D=(-0.37, 0.11, 0.001, -0.002, 0.0)):
    f = 0.9 * W
    K = np.array([[f, 0, W / 2], [0, f, H / 2], [0, 0, 1.0]])
    P = np.hstack([np.array([[0.95 * f, 0, W / 2 - 2], [0, 0.95 * f, H / 2 - 1],
                             [0, 0, 1.0]]), np.zeros((3, 1))])
    m = calib.undistort_rectify_map(K, np.array(D), np.eye(3), P, (W, H))
    return np.stack([m, m[:, ::-1].copy()])


# widths ≡ 0, 1, 2, 3 (mod 4): the vector and the scalar variants
@pytest.mark.parametrize("shape", [(60, 80), (37, 129), (41, 130), (60, 83), (480, 752)])
def test_remap_kernel(dev, shape):
    """Mono, RGB and float32 stacks, on the distorted maps and on maps that
    leave the image (stretched and shifted, and a few far outside it)."""
    H, W = shape
    rng = np.random.default_rng(1)
    inside = _maps(H, W)
    leaving = inside * np.float32(1.3) - np.array([W / 6, H / 7], np.float32)
    leaving[:, ::7, ::5] = np.array([-1e5, 3e5], np.float32)
    for m in (inside, leaving):
        maps = torch.from_numpy(np.ascontiguousarray(m, np.float32)).to(dev)
        for img in (rng.integers(0, 256, (2, H, W), np.uint8),
                    rng.integers(0, 256, (2, H, W, 3), np.uint8),
                    (rng.random((2, H, W)) * 300).astype(np.float32),
                    (rng.random((2, H, W, 3)) * 300).astype(np.float32)):
            imgs = torch.from_numpy(img).to(dev)
            before = remap_kernel.KERNELS[imgs.dtype].launches
            _exact(remap_kernel.rectify(imgs, maps), remap.rectify_pair(imgs, maps))
            assert remap_kernel.KERNELS[imgs.dtype].launches == before + 1


def test_remap_kernel_unaligned_maps(dev):
    """Contiguous maps that start off a 16-byte boundary, at a width that is
    a multiple of 4, take the scalar variant and stay exact."""
    H, W = 40, 64
    rng = np.random.default_rng(2)
    m = torch.from_numpy(_maps(H, W)).to(dev)
    flat = torch.zeros(m.numel() + 1, dtype=torch.float32, device=dev)
    flat[1:] = m.reshape(-1)
    maps = flat[1:].view(m.shape)
    assert maps.is_contiguous() and maps.data_ptr() % 16 != 0
    for img in (rng.integers(0, 256, (2, H, W), np.uint8),
                rng.integers(0, 256, (2, H, W, 3), np.uint8)):
        imgs = torch.from_numpy(img).to(dev)
        _exact(remap_kernel.rectify(imgs, maps), remap.rectify_pair(imgs, m))


# the mesh's band launch (120 rows + 2 x 7 halo rows) and the whole image;
# widths that are not a multiple of the kernel's 32-column segment
BM_SHAPES = [(40, 112), (67, 301), (50, 97), (134, 752), (480, 752)]


@pytest.mark.parametrize("kw", [
    dict(),                                                   # the default
    dict(refine_disparity=True),
    dict(uniqueness_ratio=15),
    dict(refine_disparity=True, uniqueness_ratio=15),
    dict(num_disparities=32, block_size=9, min_disparity=-4),
    dict(num_disparities=16, block_size=21, xsobel=False),
    dict(num_disparities=128, block_size=21, refine_disparity=True, uniqueness_ratio=10),
    dict(num_disparities=256, block_size=21, refine_disparity=True, uniqueness_ratio=10),
    # the largest block and the largest range whose tiles fit the shared
    # memory of the staged-tile design this kernel replaced
    dict(num_disparities=16, block_size=131, refine_disparity=True, uniqueness_ratio=10),
    dict(num_disparities=1024, block_size=39, refine_disparity=True, uniqueness_ratio=10),
    # and the largest StereoBMConfig allows, which that design refused
    dict(num_disparities=1024, block_size=255, refine_disparity=True, uniqueness_ratio=10),
])
@pytest.mark.parametrize("shape", BM_SHAPES)
def test_bm_kernel(dev, kw, shape):
    left, right, _ = synthetic_stereo_pair(*shape, max_disparity=40, seed=4)
    cfg = StereoBMConfig(**kw)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    for got, want in zip(stereobm_kernel.fused_raw(lf, rf, cfg),
                         stereobm_kernel.fused_raw_plain(lf, rf, cfg)):
        _exact(got, want)
    d, v = stereobm_kernel.compute_disparity_fused(
        torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev), cfg)
    dp, vp = stereobm.compute_disparity(
        torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev), cfg)
    _exact(v, vp)
    _exact(d, dp)


@pytest.mark.parametrize("kw", [dict(), dict(refine_disparity=True, uniqueness_ratio=15,
                                             num_disparities=96, min_disparity=-3)])
@pytest.mark.parametrize("shape", [(67, 301), (134, 752)])
def test_bm_kernel_float_images(dev, kw, shape):
    """Float images whose prefiltered values are not integers: the kernel
    sums in the plain version's order there, so it is exact too."""
    left, right, _ = synthetic_stereo_pair(*shape, max_disparity=40, seed=5)
    cfg = StereoBMConfig(**kw)
    lt = torch.from_numpy(left).to(dev).float() * 0.731
    rt = torch.from_numpy(right).to(dev).float() * 0.731
    lf, rf = stereobm.prefilter(lt, cfg), stereobm.prefilter(rt, cfg)
    assert not torch.equal(lf, lf.round())
    for got, want in zip(stereobm_kernel.fused_raw(lf, rf, cfg),
                         stereobm_kernel.fused_raw_plain(lf, rf, cfg)):
        _exact(got, want)


@pytest.mark.parametrize("tile_rows", [1, 4, 8, 16, 32, 64])
def test_bm_kernel_tile_rows(dev, tile_rows):
    """Every strip height gives the plain version's maps."""
    left, right, _ = synthetic_stereo_pair(134, 301, max_disparity=40, seed=6)
    cfg = StereoBMConfig(refine_disparity=True, uniqueness_ratio=15)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    want = stereobm_kernel.fused_raw_plain(lf, rf, cfg)
    for got, w in zip(stereobm_kernel._launch(lf, rf, cfg, tile_rows), want):
        _exact(got, w)


def test_bm_kernel_refuses_a_strip_too_tall(dev):
    """A strip whose winner states exceed a block's shared memory is refused
    (CUDA error 1) and raises: nothing falls back to the plain version."""
    lf = torch.zeros((300, 64), device=dev)
    cfg = StereoBMConfig(refine_disparity=True, uniqueness_ratio=15)
    launches = stereobm_kernel.KERNEL.launches
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        stereobm_kernel._launch(lf, lf, cfg, 250)
    assert stereobm_kernel.KERNEL.launches == launches


def _speckle_case(shape, seed=7):
    rng = np.random.default_rng(seed)
    H, W = shape
    disp = (rng.random(shape) * 40).astype(np.float32)
    disp[H // 4:H // 2, W // 3:2 * W // 3] = 12.0     # one big component
    # a winding corridor: needs many row/column rounds to converge
    disp[::4, :] = 20.0
    disp[1::4, -1] = 20.0
    disp[3::4, 0] = 20.0
    valid = rng.random(shape) > 0.25
    valid[::4, :] = True
    valid[1::4, -1] = True
    valid[3::4, 0] = True
    return disp, valid


def _round_counts(run, large):
    """{0, 1, 2, rounds − 1, rounds, large}, where ``rounds`` is the least
    count at which ``run(count)`` equals ``run(large)`` (the result is
    monotone in the count, so bisect)."""
    full = run(large)
    lo, hi = 0, large
    while lo < hi:
        mid = (lo + hi) // 2
        if torch.equal(run(mid), full):
            hi = mid
        else:
            lo = mid + 1
    return sorted({0, 1, 2, max(lo - 1, 0), lo, large})


# one-pixel-wide and one-pixel-tall fields; 16×9000, whose 9000 columns
# outnumber the warps that can be resident at once (each walks several) and
# whose rows are too long for register segments; 9000×16, whose columns are
# too long for the column tiles
SPECKLE_SHAPES = [(40, 70), (37, 257), (9, 33), (1, 300), (300, 1), (16, 9000), (9000, 16),
                  (480, 752)]


@pytest.mark.parametrize("shape", SPECKLE_SHAPES)
def test_label_kernel(dev, shape):
    """K3 at 0, 1, 2, one short of convergence, the rounds the field needs,
    and 64 rounds: exact, one launch per call."""
    disp, valid = (torch.from_numpy(a).to(dev) for a in _speckle_case(shape))
    counts = _round_counts(lambda k: speckle_kernel.labels(disp, valid, 5.0, k), 64)
    for iters in counts:
        before = speckle_kernel.KERNEL.launches
        got = speckle_kernel.labels(disp, valid, 5.0, iters)
        assert speckle_kernel.KERNEL.launches == before + 1
        _exact(got, speckle._labels_scan(disp, valid, 5.0, iters))


def test_filter_speckles_counts_launches(dev):
    disp, valid = (torch.from_numpy(a).to(dev) for a in _speckle_case((48, 96)))
    _build.reset_launch_counts()
    d, k = speckle.filter_speckles(disp, valid, 50, 5.0, 16, -1.0)
    assert speckle_kernel.KERNEL.launches == 1
    lab = speckle._labels_scan(disp.cpu(), valid.cpu(), 5.0, 16)
    keep = speckle._keep_large_components(lab, 50) & valid.cpu()
    _exact(k.cpu(), keep)


def test_bm_lr_check_kernel(dev):
    """The mirrored second launch: the card's result equals the CPU run's."""
    left, right, _ = synthetic_stereo_pair(67, 301, max_disparity=40, seed=4)
    cfg = StereoBMConfig(num_disparities=32, block_size=9, lr_check=True)
    _build.reset_launch_counts()
    d, v = stereobm_kernel.compute_disparity_fused(
        torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev), cfg)
    assert stereobm_kernel.KERNEL.launches == 2
    dp, vp = stereobm_kernel.compute_disparity_fused(
        torch.from_numpy(left), torch.from_numpy(right), cfg)
    _exact(v.cpu(), vp)
    _exact(d.cpu(), dp)


def _exact_volume(got, want):
    """Storage volumes: same dtype, same values (compared in float32, which
    holds every stored value exactly)."""
    assert got.dtype == want.dtype and got.shape == want.shape
    _exact(got.float(), want.float())


# (num_disparities, P1, P2, integer images): uint16 cost with uint8 excess,
# with int16 excess (2·P2 > 255), and float32 storage
SGM_MODES = [
    (16, 10.0, 120.0, True),
    (64, 10.0, 120.0, True),
    (128, 10.0, 120.0, True),
    (64, 20.0, 600.0, True),
    (64, 7.5, 93.25, False),
]


@pytest.mark.parametrize("nd,p1,p2,integer", SGM_MODES)
@pytest.mark.parametrize("shape", [(40, 112), (67, 301), (480, 752)])
def test_sgm_kernels(dev, shape, nd, p1, p2, integer):
    left, right, _ = synthetic_stereo_pair(*shape, max_disparity=min(nd, 48) - 4, seed=4)
    if not integer:
        left, right = left.astype(np.float32) + 0.25, right.astype(np.float32) + 0.25
    cfg = StereoBMConfig(num_disparities=nd, block_size=15 if shape[0] > 40 else 9,
                         refine_disparity=True, uniqueness_ratio=10)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    cost_dt, exc_dt = sgm_kernel.storage_dtypes(cfg, p1, p2, integer)
    assert (cost_dt == torch.float32) == (not integer)

    _build.reset_launch_counts()
    cost, down = sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, cost_dt, exc_dt)
    assert sgm_kernel.COST_DOWN.launches == 1
    cost_p, down_p = sgm_kernel.cost_and_down_plain(lf, rf, cfg, p1, p2, cost_dt, exc_dt)
    _exact_volume(cost, cost_p)
    _exact_volume(down, down_p)

    for vertical in (True, False):
        for reverse in (False, True):
            for exc_in in (None, down):
                got = sgm_kernel.aggregate(cost, exc_in, p1, p2, vertical, reverse, exc_dt)
                want = sgm_kernel.aggregate_plain(cost, exc_in, p1, p2, vertical,
                                                  reverse, exc_dt)
                _exact_volume(got, want)
    assert sgm_kernel.AGGREGATE.launches == 8

    exc_h = sgm_kernel.aggregate(cost, down, p1, p2, False, True, exc_dt)
    for c in (cfg, cfg.replace(refine_disparity=False, uniqueness_ratio=0, min_disparity=3)):
        for got, want in zip(sgm_kernel.wta(cost, (down, exc_h), c),
                             sgm_kernel.wta_plain(cost, (down, exc_h), c)):
            _exact(got, want)
    assert sgm_kernel.WTA.launches == 2


# storage mode → (cost dtype, excess dtype, P1, P2); the clamp value is
# block 15's (2·P2 + 255·15²), the largest cost a uint16 volume holds
WALK_MODES = {
    "u16_u8": (torch.uint16, torch.uint8, 10.0, 120.0),
    "u16_i16": (torch.uint16, torch.int16, 20.0, 600.0),
    "f32": (torch.float32, torch.float32, 7.5, 93.25),
}
# lines shorter than the ring and than one warp's pixels, one-pixel lines
# both ways, a width no block of columns divides, the mesh SGM band (120 rows
# and 2 × 39 halo rows) and the whole image
WALK_SHAPES = [(1, 301), (2, 17), (17, 2), (37, 301), (198, 752), (480, 752)]


def _walk_volumes(shape, nd, mode, seed):
    """A cost volume and an incoming excess that reach their storage limits:
    cost mostly in [0, 4·P2) (so the P1 and P2 branches both win), a tenth at
    the clamp value and a tenth anywhere in [0, clamp]; excess in [0, P2].
    Float storage gets fractional values."""
    cost_dt, exc_dt, p1, p2 = WALK_MODES[mode]
    clampv = 2 * p2 + 255 * 15 ** 2
    rng = np.random.default_rng(seed)
    size = (*shape, nd)
    if cost_dt == torch.float32:
        cost = (rng.random(size, np.float32) * np.float32(4 * p2))
        exc = rng.random(size, np.float32) * np.float32(p2)
        wide = rng.random(size, np.float32) * np.float32(clampv)
    else:
        cost = rng.integers(0, 4 * int(p2), size, np.int32)
        exc = rng.integers(0, int(p2) + 1, size, np.int32)
        wide = rng.integers(0, int(clampv) + 1, size, np.int32)
    pick = rng.random(size, np.float32)
    cost = np.where(pick < 0.1, clampv, np.where(pick < 0.2, wide, cost))
    return (torch.from_numpy(cost.astype(np.float32)).to(cost_dt),
            torch.from_numpy(exc.astype(np.float32)).to(exc_dt), p1, p2, exc_dt)


# every width of a lane's share (nd / 32 rounded up to 1, 2, 4, 8, 16, 32
# disparities), with and without disparities past nd (48)
@pytest.mark.parametrize("mode", list(WALK_MODES))
@pytest.mark.parametrize("nd", [16, 48, 128, 256, 512, 1024])
@pytest.mark.parametrize("shape", WALK_SHAPES)
def test_walk_kernel(dev, shape, nd, mode):
    """K5 in all eight (vertical, reverse, exc_in) combinations against its
    plain version, exact, one launch per call.  The full image at 512 and
    1024 disparities (0.7 and 1.5 GB a float32 volume) is left to 198 rows."""
    if nd >= 512 and shape == (480, 752):
        shape = (198, 752)
    cost, exc, p1, p2, exc_dt = _walk_volumes(shape, nd, mode, seed=nd + shape[0])
    cost, exc = cost.to(dev), exc.to(dev)
    _build.reset_launch_counts()
    for vertical in (True, False):
        for reverse in (False, True):
            for exc_in in (None, exc):
                args = (cost, exc_in, p1, p2, vertical, reverse, exc_dt)
                _exact_volume(sgm_kernel.aggregate(*args), sgm_kernel.aggregate_plain(*args))
    assert sgm_kernel.AGGREGATE.launches == 8


def test_walk_kernel_unaligned_view(dev):
    """Volumes that start off a 16-byte boundary are copied to an aligned
    one first (the kernel copies 16 bytes at a time); nd that is not a
    multiple of 16 raises before any launch."""
    cost, exc, p1, p2, exc_dt = _walk_volumes((9, 40), 32, "u16_u8", seed=3)
    cost, exc = cost.to(dev), exc.to(dev)
    flat = torch.zeros(cost.numel() + 1, dtype=cost.dtype, device=dev)
    flat[1:] = cost.reshape(-1)
    shifted = flat[1:].view(cost.shape)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 != 0
    for vertical in (True, False):
        args = (exc, p1, p2, vertical, True, exc_dt)
        _exact_volume(sgm_kernel.aggregate(shifted, *args), sgm_kernel.aggregate_plain(cost, *args))
    launches = sgm_kernel.AGGREGATE.launches
    with pytest.raises(ValueError, match="multiple of 16"):
        sgm_kernel.aggregate(cost[..., :24], None, p1, p2, True, False, exc_dt)
    assert sgm_kernel.AGGREGATE.launches == launches


@pytest.mark.parametrize("nd,p1,p2,integer", [SGM_MODES[2], SGM_MODES[3], SGM_MODES[4]],
                         ids=["u16_u8", "u16_i16", "f32"])
def test_sgm_down_walk_band(dev, nd, p1, p2, integer):
    """K4 (cost stage and down walk) on the mesh SGM band's launch shape,
    198×752, in each storage mode: exact."""
    left, right, _ = synthetic_stereo_pair(198, 752, max_disparity=44, seed=8)
    if not integer:
        left, right = left.astype(np.float32) + 0.25, right.astype(np.float32) + 0.25
    cfg = StereoBMConfig(num_disparities=nd, block_size=15)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    dts = sgm_kernel.storage_dtypes(cfg, p1, p2, integer)
    for g, w in zip(sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, *dts),
                    sgm_kernel.cost_and_down_plain(lf, rf, cfg, p1, p2, *dts)):
        _exact_volume(g, w)


@pytest.mark.parametrize("tile_rows", [1, 4, 16, 32, 200])
def test_sgm_cost_tile_rows(dev, tile_rows):
    """Every strip height of the integer-storage cost stage gives the plain
    volumes, on the mesh's band shape."""
    left, right, _ = synthetic_stereo_pair(134, 301, max_disparity=40, seed=6)
    cfg = StereoBMConfig(num_disparities=48, block_size=15, min_disparity=-2)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    dts = sgm_kernel.storage_dtypes(cfg, 10.0, 120.0, True)
    got = sgm_kernel._launch_cost_down(lf, rf, cfg, 10.0, 120.0, *dts, tile_rows=tile_rows)
    for g, w in zip(got, sgm_kernel.cost_and_down_plain(lf, rf, cfg, 10.0, 120.0, *dts)):
        _exact_volume(g, w)


@pytest.mark.parametrize("nd,block", [(16, 15), (256, 15), (48, 5), (32, 7), (64, 9)])
def test_sgm_cost_block_sizes(dev, nd, block):
    """The integer-storage cost stage at every kind of block it gets (uint16
    storage needs 240 + 255 block^2 <= 65535, so block <= 15), a wide range,
    and windows narrower than a column group of 8 (blocks 5 and 7)."""
    left, right, _ = synthetic_stereo_pair(67, 301, max_disparity=40, seed=7)
    cfg = StereoBMConfig(num_disparities=nd, block_size=block, min_disparity=-1)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    dts = sgm_kernel.storage_dtypes(cfg, 10.0, 120.0, True)
    assert dts[0] == torch.uint16
    for g, w in zip(sgm_kernel.cost_and_down(lf, rf, cfg, 10.0, 120.0, *dts),
                    sgm_kernel.cost_and_down_plain(lf, rf, cfg, 10.0, 120.0, *dts)):
        _exact_volume(g, w)


# launches a frame by path count: (K4's cost stage alone, K4, K5, DG)
FRAME_LAUNCHES = {2: (1, 0, 2, 0), 4: (0, 1, 3, 0), 8: (0, 1, 3, 2)}


@pytest.mark.parametrize("num_paths", [4, 2, 8])
@pytest.mark.parametrize("kw", [dict(), dict(lr_check=True), dict(min_disparity=2)])
def test_sgm_fused_on_card_equals_oracle(dev, kw, num_paths):
    """Every frame's launches (no K6 with ``lr_check``), and the SGM frame
    through the kernels against the plain recurrences of ops/sgm.py, both
    on the card, over 2, 4 and 8 paths: exact on uint8 input."""
    left, right, _ = synthetic_stereo_pair(67, 301, max_disparity=40, seed=4)
    cfg = StereoBMConfig(num_disparities=48, block_size=9, texture_threshold=5, **kw)
    lt, rt = torch.from_numpy(left).to(dev), torch.from_numpy(right).to(dev)
    _build.reset_launch_counts()
    d, v = sgm_kernel.compute_disparity_sgm_fused(lt, rt, cfg, num_paths=num_paths)
    launches = tuple(k.launches for k in (sgm_kernel.COST, sgm_kernel.COST_DOWN,
                                          sgm_kernel.AGGREGATE, sgm_kernel.DIAGONAL,
                                          sgm_kernel.WTA))
    assert launches == FRAME_LAUNCHES[num_paths] + (0 if cfg.lr_check else 1,)
    dp, vp = sgm.compute_disparity_sgm(lt, rt, cfg, num_paths=num_paths)
    _exact(v, vp)
    _exact(d, dp)


# the diagonal, cost-only and WTA cases: every storage mode, every width of
# a lane's share up to 8 (nd 16, 48: disparities past nd, 128, 256), lines
# of 1 and 2 pixels and H ≠ W both ways, a width no block of columns
# divides, and the whole image
PATH_SHAPES = [(1, 301), (2, 17), (17, 2), (37, 301), (480, 752)]
PATH_NDS = [16, 48, 128, 256]


# DG's: the pair walk's (nd ≤ 256: 64 besides PATH_NDS) and the two-pass
# walk's (272, 512, 1024)
DIAG_NDS = PATH_NDS + [64, 272, 512, 1024]


@pytest.mark.parametrize("mode", list(WALK_MODES))
@pytest.mark.parametrize("nd", DIAG_NDS)
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_diagonal_kernel(dev, shape, nd, mode):
    """DG, both line pairs (dx +1 and −1), against its plain version, exact,
    one launch per call: the pair walk up to 256 disparities, the two-pass
    walk beyond (the full image at 512 and 1024 disparities is left to 198
    rows); an nd that is not a multiple of 16 raises before any launch."""
    if nd >= 512 and shape == (480, 752):
        shape = (198, 752)
    cost, _, p1, p2, exc_dt = _walk_volumes(shape, nd, mode, seed=nd + 7 * shape[0])
    cost = cost.to(dev)
    _build.reset_launch_counts()
    for dx in (1, -1):
        _exact_volume(sgm_kernel.aggregate_diagonal(cost, p1, p2, dx, exc_dt),
                      sgm_kernel.aggregate_diagonal_plain(cost, p1, p2, dx, exc_dt))
    assert sgm_kernel.DIAGONAL.launches == 2
    with pytest.raises(ValueError, match="multiple of 16"):
        sgm_kernel.aggregate_diagonal(cost[..., :8], p1, p2, 1, exc_dt)
    assert sgm_kernel.DIAGONAL.launches == 2


@pytest.mark.parametrize("mode", list(WALK_MODES))
@pytest.mark.parametrize("nd", [16, 48, 64, 128, 256])
def test_diagonal_pair_crossings(dev, nd, mode):
    """The pair walk's halves cross in and around its handoff window: the
    longest lines 1, 2 and 3 pixels long, and odd and even lengths around D,
    D + 1, 2D − 1, 2D, 2D + 1 and 2D + 3 (D: the pixels each half stages
    ahead at this nd and storage, and the second visits its handoff serves),
    on shapes wider than tall and taller than wide; both dx against the
    plain version, exact, one launch per call."""
    cost_dt, exc_dt = WALK_MODES[mode][:2]
    D = sgm_kernel.diagonal_depth(nd, cost_dt, exc_dt)
    assert 2 <= D <= 32
    lengths = {1, 2, 3} | {n + o for n in (D, D + 1, 2 * D - 1, 2 * D, 2 * D + 1, 2 * D + 3)
                           for o in (-1, 0, 1)}
    _build.reset_launch_counts()
    calls = 0
    for n in sorted(lengths):
        for shape in ((n, n + 5), (n + 4, n)):
            cost, _, p1, p2, _ = _walk_volumes(shape, nd, mode, seed=nd + n)
            cost = cost.to(dev)
            for dx in (1, -1):
                _exact_volume(sgm_kernel.aggregate_diagonal(cost, p1, p2, dx, exc_dt),
                              sgm_kernel.aggregate_diagonal_plain(cost, p1, p2, dx, exc_dt))
                calls += 1
    assert sgm_kernel.DIAGONAL.launches == calls
    assert sgm_kernel.diagonal_depth(272, cost_dt, exc_dt) == 0   # the two-pass walk
    assert sgm_kernel.diagonal_steps(480, 752, nd, cost_dt, exc_dt) == 480
    assert sgm_kernel.diagonal_steps(480, 752, 272, cost_dt, exc_dt) == 960


# storage mode → (P1, P2, integer images) of the cost-only entry's cases
COST_MODES = {"u16_u8": (10.0, 120.0, True), "u16_i16": (20.0, 600.0, True),
              "f32": (7.5, 93.25, False)}


@pytest.mark.parametrize("mode", list(COST_MODES))
@pytest.mark.parametrize("nd", PATH_NDS)
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_sgm_cost_only_kernel(dev, shape, nd, mode):
    """K4's cost stage alone (the 2-path route) against K4's cost volume on
    the card and against its plain version: exact, one launch per call."""
    p1, p2, integer = COST_MODES[mode]
    left, right, _ = synthetic_stereo_pair(*shape, max_disparity=min(nd, 40) - 4, seed=5)
    if not integer:
        left, right = left.astype(np.float32) + 0.25, right.astype(np.float32) + 0.25
    cfg = StereoBMConfig(num_disparities=nd, block_size=15, min_disparity=-1)
    lf = stereobm.prefilter(torch.from_numpy(left).to(dev), cfg)
    rf = stereobm.prefilter(torch.from_numpy(right).to(dev), cfg)
    cost_dt, exc_dt = sgm_kernel.storage_dtypes(cfg, p1, p2, integer)
    _build.reset_launch_counts()
    got = sgm_kernel.cost_volume(lf, rf, cfg, p2, cost_dt)
    assert sgm_kernel.COST.launches == 1
    _exact_volume(got, sgm_kernel.cost_and_down(lf, rf, cfg, p1, p2, cost_dt, exc_dt)[0])
    _exact_volume(got, sgm_kernel.cost_volume_plain(lf, rf, cfg, p2, cost_dt))


@pytest.mark.parametrize("mode", list(WALK_MODES))
@pytest.mark.parametrize("nd", PATH_NDS)
@pytest.mark.parametrize("shape", PATH_SHAPES)
def test_wta_kernel_paths(dev, shape, nd, mode):
    """K6 over 2, 4 and 8 paths against its plain version on random cost and
    pair volumes at their storage limits (pair sums up to 2·P2), with and
    without the subpixel step and uniqueness, exact, one launch per call."""
    cost, exc, p1, p2, exc_dt = _walk_volumes(shape, nd, mode, seed=nd + 3 * shape[1])
    rng = np.random.default_rng(nd)
    cost = cost.to(dev)
    pairs = [(exc.float() + exc.float().flip(0 if shape[0] > 1 else 1)).to(exc_dt).to(dev)]
    for _ in range(3):
        pairs.append(torch.from_numpy(rng.permutation(pairs[0].cpu().numpy().ravel())
                                      .reshape(pairs[0].shape)).to(dev))
    cfg = StereoBMConfig(num_disparities=nd, block_size=5, refine_disparity=True,
                         uniqueness_ratio=10)
    _build.reset_launch_counts()
    calls = 0
    for num_paths, use in ((2, pairs[:1]), (4, pairs[:2]), (8, pairs)):
        for c in (cfg, cfg.replace(refine_disparity=False, uniqueness_ratio=0, min_disparity=3)):
            for got, want in zip(sgm_kernel.wta(cost, use, c), sgm_kernel.wta_plain(cost, use, c)):
                _exact(got, want)
            calls += 1
    assert sgm_kernel.WTA.launches == calls


def _maxprop_inputs(shape, dev, seed=3):
    """A K7 field the way the row-sharded filter builds one: capped sizes
    (≤ 801) over the link masks of a speckle case."""
    disp, valid = (torch.from_numpy(a).to(dev) for a in _speckle_case(shape, seed))
    cx, cy = speckle._connectivity(disp, valid, 5.0)
    rng = np.random.default_rng(seed)
    field = torch.from_numpy(rng.integers(0, 802, shape).astype(np.int32)).to(dev)
    return field, cx, cy


@pytest.mark.parametrize("shape", SPECKLE_SHAPES[:7] + [(120, 752), (480, 752)])
def test_maxprop_kernel(dev, shape):
    """K7 at 0, 1, 2, one short of convergence, the rounds the field needs,
    and 480 rounds: exact, one launch per call, the input left as it was."""
    field, cx, cy = _maxprop_inputs(shape, dev)
    for iters in _round_counts(lambda k: speckle_kernel.max_propagate(field, cx, cy, k), 480):
        _build.reset_launch_counts()
        got = speckle_kernel.max_propagate(field, cx, cy, iters)
        assert speckle_kernel.MAXPROP.launches == 1
        _exact(got, speckle._max_propagate(field, cx, cy, iters))
    _exact(field, _maxprop_inputs(shape, dev)[0])


@pytest.mark.parametrize("shape", [(40, 70), (1, 300), (300, 1), (16, 9000), (9000, 16),
                                   (120, 752)])
def test_band_labels_kernel(dev, shape):
    """The band label rounds at 0, 1, 2, one short of convergence, the
    rounds the field needs, and 64 rounds: exact, on their own counter."""
    disp, valid = (torch.from_numpy(a).to(dev) for a in _speckle_case(shape))
    cx, cy = speckle._connectivity(disp, valid, 5.0)
    H, W = shape
    lab = torch.where(valid, torch.arange(H * W, dtype=torch.int32, device=dev).reshape(H, W)
                      + 7 * H * W, torch.full((), 8 * H * W, dtype=torch.int32, device=dev))
    for rounds in _round_counts(lambda k: speckle_kernel.band_labels(lab, cx, cy, k), 64):
        _build.reset_launch_counts()
        got = speckle_kernel.band_labels(lab, cx, cy, rounds)
        assert speckle_kernel.BAND_LABELS.launches == 1 and speckle_kernel.MAXPROP.launches == 0
        _exact(got, speckle._label_rounds(lab, cx, cy, rounds))


def _mesh_pipelines(cfg, n, H=96, W=128):
    from ros_gpu_stereo_processor_tpu_torch import StereoPipeline
    from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh

    model = calib.StereoCameraModel.from_calibs(
        *(calib.CameraCalib(W, H, np.array([[110.0, 0, 64], [0, 110.0, 48], [0, 0, 1.0]]),
                            np.array([-0.37, 0.11, 0.0, 0.0, 0.0]), np.eye(3),
                            np.hstack([np.array([[105.0, 0, 62], [0, 105.0, 47],
                                                 [0, 0, 1.0]]),
                                       np.array([[tx], [0.0], [0.0]])]), nm)
          for tx, nm in ((0.0, "left"), (-10.5, "right"))))
    return (StereoPipeline(model, cfg, mesh=make_mesh(n, devices=["cuda:0"] * n)),
            StereoPipeline(model, cfg, mesh=make_mesh(n, devices=["cpu"] * n)))


@pytest.mark.parametrize("kw", [dict(), dict(lr_check=True), dict(algorithm="sgm")],
                         ids=["bm", "bm_lr_check", "sgm"])
@pytest.mark.parametrize("n", [2, 4])
def test_mesh_pipeline_on_card_equals_cpu_mesh(dev, n, kw):
    """Bands on one card (``["cuda:0"] * n``) against the same mesh on the
    CPU: every output exact (xyz within rtol 1e-6), and the launches of one
    frame: K1 twice per band, the matcher's kernels once per band, K7 once
    per band, K3 never."""
    from ros_gpu_stereo_processor_tpu_torch import Outputs, PipelineConfig, SpeckleConfig

    cfg = PipelineConfig(
        stereobm=StereoBMConfig(num_disparities=32, block_size=9, texture_threshold=5, **kw),
        speckle=SpeckleConfig(max_speckle_size=40))
    gpu, cpu = _mesh_pipelines(cfg, n)
    left, right, _ = synthetic_stereo_pair(96, 128, max_disparity=24, seed=3)
    _build.reset_launch_counts()
    got = gpu.process(left, right, Outputs.all()).fetch()
    k = _build.kernels()
    sgm_on = kw.get("algorithm") == "sgm"
    assert k["remap_bilinear_u8"].launches == 2 * n
    assert k["bm_fused"].launches == (0 if sgm_on else n * (2 if kw.get("lr_check") else 1))
    assert k["sgm_cost_down"].launches == (n if sgm_on else 0)
    assert k["speckle_maxprop"].launches == n
    assert k["speckle_band_labels"].launches >= 1
    assert k["speckle_labels"].launches == 0
    want = cpu.process(left, right, Outputs.all()).fetch()
    for name, w in want.items():
        g = got[name]
        assert g.dtype == w.dtype and g.shape == w.shape, name
        if name == "pointcloud_xyz":
            np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=0)
        elif name == "pointcloud_rgb":
            np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32))
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)
    for p in (gpu, cpu):
        p.senders.shutdown()
