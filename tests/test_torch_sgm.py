"""SGM parity: the PyTorch port's semi-global matcher against the JAX
package's, on the same numpy inputs made from a seed.

  * ``ops/sgm.py`` (the plain recurrences, 2, 4 and 8 paths) against the
    JAX jnp oracle ``ops/sgm.py``;
  * ``ops/sgm_kernel.py`` on CPU tensors (so the plain versions of kernels
    K4–K6) against the jnp oracle, and against the JAX fused SGM
    (``ops/sgm_pallas.py``) run in the Pallas interpreter, as
    tests/test_sgm_pallas.py runs it: the stored volumes, the raw
    ``(disp_raw, best_cost, excl)`` maps and the gated output.

Tolerances: exact on uint8 input with integer penalties (every cost,
excess and total is an integer below 2^24, which float32 holds exactly in
any summation order).  With float images or fractional penalties the
values need not be integers, and the three sum the WTA total in different
orders (the JAX fused kernel ``4c + (ev + eh)``, the port's kernels
``(4c + ev) + eh``, the oracle ``((L_lr + L_rl) + L_dn) + L_up``), so
those cases take tests/test_sgm_pallas.py's ``atol=1e-3``.

Each Pallas-interpreter call takes about 12 s on a CPU, so each test below
makes at most two and compares several port functions against them.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu import config as jconfig
from ros_gpu_stereo_processor_tpu.ops import sgm as jsgm
from ros_gpu_stereo_processor_tpu.ops import sgm_pallas as jsgm_pallas
from ros_gpu_stereo_processor_tpu.ops import stereobm as jbm
from ros_gpu_stereo_processor_tpu.ops import stereobm_pallas as jbm_pallas
from ros_gpu_stereo_processor_tpu_torch import config as tconfig
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.ops import sgm as tsgm
from ros_gpu_stereo_processor_tpu_torch.ops import sgm_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as tbm
from ros_gpu_stereo_processor_tpu_torch.utils.io import synthetic_stereo_pair

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.array(a))


def _pair(h=48, w=160, max_disparity=12, seed=0):
    left, right, _ = synthetic_stereo_pair(h, w, max_disparity=max_disparity, seed=seed)
    return left, right


def _cfgs(**kw):
    jcfg = jconfig.StereoBMConfig(**kw)
    return jcfg, tconfig.from_jax_config(jcfg)


def _assert_equal(got, want, atol=0.0):
    d, v = got
    jd, jv = want
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    if atol:
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=0, atol=atol)
    else:
        np.testing.assert_array_equal(d.numpy(), np.asarray(jd))


# the configurations of tests/test_sgm_pallas.py (48×160, 16 disparities)
BASE = dict(num_disparities=16, block_size=5, texture_threshold=5)
CONFIGS = {
    "basic": BASE,
    "refine_uniqueness": dict(BASE, refine_disparity=True, uniqueness_ratio=10),
    "block9": dict(BASE, block_size=9, texture_threshold=10),
    "min_disparity": dict(BASE, min_disparity=2),
    "lr_check": dict(BASE, lr_check=True),
}


@pytest.mark.parametrize("num_paths", [2, 4, 8])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_sgm_plain_matches_oracle(name, num_paths):
    left, right = _pair()
    jcfg, cfg = _cfgs(**CONFIGS[name])
    want = jsgm.compute_disparity_sgm(jnp.asarray(left), jnp.asarray(right), jcfg,
                                      num_paths=num_paths)
    got = tsgm.compute_disparity_sgm(_t(left), _t(right), cfg, num_paths=num_paths)
    _assert_equal(got, want)
    assert 0.5 < np.asarray(want[1]).mean()


@pytest.mark.parametrize("name", list(CONFIGS))
def test_sgm_fused_plain_matches_oracle(name):
    """The fused path on the CPU (K4–K6 plain versions) against the jnp
    oracle with 4 paths; launches nothing."""
    left, right = _pair()
    jcfg, cfg = _cfgs(**CONFIGS[name])
    want = jsgm.compute_disparity_sgm(jnp.asarray(left), jnp.asarray(right), jcfg)
    before = {k: v.launches for k, v in _build.kernels().items()}
    got = sgm_kernel.compute_disparity_sgm_fused(_t(left), _t(right), cfg)
    assert {k: v.launches for k, v in _build.kernels().items()} == before
    _assert_equal(got, want)


@pytest.mark.parametrize("shape,nd", [((40, 192), 32), ((48, 200), 16)],
                         ids=["32disp", "odd_width"])
def test_sgm_fused_plain_other_shapes(shape, nd):
    if shape[1] == 200:     # tests/test_sgm_pallas.py's odd width: random images
        rng = np.random.default_rng(7)
        left, right = (rng.integers(0, 255, shape).astype(np.uint8) for _ in range(2))
        kw = dict(num_disparities=nd, block_size=5, texture_threshold=10,
                  refine_disparity=True)
    else:
        left, right = _pair(*shape, max_disparity=24, seed=3)
        kw = dict(num_disparities=nd, block_size=5, texture_threshold=5)
    jcfg, cfg = _cfgs(**kw)
    want = jsgm.compute_disparity_sgm(jnp.asarray(left), jnp.asarray(right), jcfg)
    got = sgm_kernel.compute_disparity_sgm_fused(_t(left), _t(right), cfg)
    _assert_equal(got, want)


# storage mode → (cost dtype, excess dtype, P1, P2), as the walk kernel's
# card tests take them
WALK_MODES = {
    "u16_u8": (torch.uint16, torch.uint8, 10.0, 120.0),
    "u16_i16": (torch.uint16, torch.int16, 20.0, 600.0),
    "f32": (torch.float32, torch.float32, 7.5, 93.25),
}


@pytest.mark.parametrize("mode", list(WALK_MODES))
@pytest.mark.parametrize("shape", [(1, 301), (2, 17), (17, 2)])
def test_walk_plain_matches_oracle_on_short_lines(shape, mode):
    """K5's plain version (what the walk kernel is held to on the card) at
    the card tests' shortest lines, against the JAX oracle's scan along one
    axis: the excess L − C, plus an incoming excess, exact.  Costs reach the
    clamp value; float storage takes quarter values, so L − C is exact."""
    cost_dt, exc_dt, p1, p2 = WALK_MODES[mode]
    clampv = 2 * p2 + 255 * 15 ** 2
    rng = np.random.default_rng(shape[0] * 1000 + shape[1])
    for nd in (16, 48):
        size = (*shape, nd)
        cost = rng.integers(0, 4 * int(p2), size).astype(np.float32)
        cost[rng.random(size) < 0.1] = clampv
        exc = rng.integers(0, int(p2) + 1, size).astype(np.float32)
        if cost_dt == torch.float32:
            cost, exc = cost / 4, exc / 4
        for vertical in (True, False):
            for reverse in (False, True):
                L = np.asarray(jsgm._aggregate_axis(jnp.asarray(cost), 0 if vertical else 1,
                                                    reverse, p1, p2))
                for exc_in in (None, exc):
                    want = L - cost if exc_in is None else (L - cost) + exc_in
                    got = sgm_kernel.aggregate(
                        torch.from_numpy(cost).to(cost_dt),
                        None if exc_in is None else torch.from_numpy(exc_in).to(exc_dt),
                        p1, p2, vertical, reverse, exc_dt)
                    assert got.dtype == exc_dt
                    np.testing.assert_array_equal(got.float().numpy(), want)


def test_storage_dtypes():
    cfg = tconfig.StereoBMConfig()
    u16 = torch.uint16
    assert sgm_kernel.storage_dtypes(cfg, 10, 120, True) == (u16, torch.uint8)
    assert sgm_kernel.storage_dtypes(cfg, 20, 600, True) == (u16, torch.int16)
    for args in ((10, 120, False), (7.5, 120, True), (10, 93.25, True), (10, 20000, True)):
        assert sgm_kernel.storage_dtypes(cfg, *args) == (torch.float32, torch.float32)
    # the clamp value 2·P2 + 255·block² must fit 16 bits
    assert sgm_kernel.storage_dtypes(cfg.replace(block_size=15), 10, 120, True)[0] == u16
    assert sgm_kernel.storage_dtypes(cfg.replace(block_size=17), 10, 120, True)[0] \
        == torch.float32


def test_sgm_volumes_and_raw_maps_match_pallas_interpreter():
    """The stored volumes (cropped to the image, the TPU's bias added back;
    its padded rows and lanes are neutral, sgm_pallas.py:49-52), the raw
    maps and the gated output, exact."""
    left, right = _pair()
    jcfg, cfg = _cfgs(**CONFIGS["refine_uniqueness"])
    H, W = left.shape
    jlf, jrf = (jbm.prefilter(jnp.asarray(a), jcfg) for a in (left, right))
    cost, exc_v, exc_h, cost_bias, exc_bias = jsgm_pallas.sgm_fused_raw(
        jlf, jrf, jcfg, 10.0, 120.0, return_volumes=True)
    jraw = jsgm_pallas.sgm_fused_raw(jlf, jrf, jcfg, 10.0, 120.0)

    lf, rf = _t(jlf), _t(jrf)
    vols = sgm_kernel.sgm_fused_raw(lf, rf, cfg, 10.0, 120.0, return_volumes=True)
    assert [v.dtype for v in vols] == [torch.uint16, torch.uint8, torch.uint8]
    for got, want, bias in zip(vols, (cost, exc_v, exc_h), (cost_bias, exc_bias, exc_bias)):
        assert got.shape == (cfg.num_disparities, H, W)
        np.testing.assert_array_equal(
            got.float().numpy(), np.asarray(want)[:, :H, :W].astype(np.float32) + bias)
    raw = sgm_kernel.sgm_fused_raw(lf, rf, cfg, 10.0, 120.0)
    for got, want in zip(raw, jraw):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    tex = jbm.texture_sum(jlf, jcfg)
    want = jbm_pallas.fused_gates(*jraw, jcfg, tex, row_offset=0, total_rows=H)
    _assert_equal(sgm_kernel.compute_disparity_sgm_fused(_t(left), _t(right), cfg), want)


@pytest.mark.parametrize("case,atol", [
    ("lr_check", 0.0),
    ("int16_excess", 0.0),         # 2·P2 > 255: int16 excess storage
    ("float_images", 1e-3),        # float32 storage
    ("fractional_penalties", 1e-3),
])
def test_sgm_fused_matches_pallas_interpreter(case, atol):
    left, right = _pair()
    kw, p1, p2 = dict(BASE), 10.0, 120.0
    if case == "lr_check":
        kw["lr_check"] = True
    elif case == "int16_excess":
        p1, p2 = 20.0, 600.0
    elif case == "float_images":
        left, right = left.astype(np.float32) + 0.25, right.astype(np.float32) + 0.25
    else:
        p1, p2 = 7.5, 93.25
    jcfg, cfg = _cfgs(**kw)
    want = jsgm_pallas.compute_disparity_sgm_fused(
        jnp.asarray(left), jnp.asarray(right), jcfg, p1=p1, p2=p2)
    got = sgm_kernel.compute_disparity_sgm_fused(_t(left), _t(right), cfg, p1, p2)
    _assert_equal(got, want, atol)
    oracle = jsgm.compute_disparity_sgm(jnp.asarray(left), jnp.asarray(right), jcfg,
                                        p1=p1, p2=p2)
    _assert_equal(got, oracle, atol)


def test_right_disparity_and_lr_check_on_aggregated_volume():
    """The lr_check tail's pieces on an SGM total with ties and masked
    candidates: right WTA and the consistency mask, exact."""
    rng = np.random.default_rng(9)
    jcfg, cfg = _cfgs(**dict(BASE, min_disparity=-3))
    total = rng.integers(0, 40, (16, 20, 60)).astype(np.float32)
    total[:, :, :5] = 1e9
    total[3:7, 2:4] = 1e9
    dr = tbm.right_disparity_from_cost(_t(total), cfg)
    np.testing.assert_array_equal(
        dr.numpy(), np.asarray(jbm.right_disparity_from_cost(jnp.asarray(total), jcfg)))
    dl = (rng.integers(-4, 14, (20, 60)) + rng.choice([0.0, 0.25, 0.5], (20, 60))
          ).astype(np.float32)
    for max_diff in (0, 1, 3):
        np.testing.assert_array_equal(
            tbm.left_right_check(_t(dl), dr, cfg, max_diff).numpy(),
            np.asarray(jbm.left_right_check(jnp.asarray(dl), jnp.asarray(dr.numpy()),
                                            jcfg, max_diff)))
