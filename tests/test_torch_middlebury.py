"""Middlebury 2014 at full resolution through the port
(``stereo_bench/configs/middlebury-sgm8.json``): 8-path SGM over 304
disparities, past the 256 that DG's pair walk takes, and a Q whose
principal points differ (doffs 209.059 px).

On the CPU: the configuration's frame step at a cut shape against the
benchmark's plain reference, the port's Q and point cloud against the
reference's in float64, where the two-pass walk's roofline reads, and the
volume bytes the served-path trace script prints against the volumes the
SGM call makes.  On the card: one replay of the captured step launches DG
twice a pair, and the device trace names the two-pass walk alone.
"""

import importlib.util
import os

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.config import Outputs, StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import reproject as reproject_ops
from ros_gpu_stereo_processor_tpu_torch.ops import sgm_kernel
from ros_gpu_stereo_processor_tpu_torch.ops import _build
from ros_gpu_stereo_processor_tpu_torch.utils.calib import CameraCalib, StereoCameraModel
from stereo_bench import check, inputs, reference, run, spec

CFG = spec.load_json("configs", "middlebury-sgm8")
TRAFFIC = spec.load_json("traffic", "replay-b2")
OUTPUTS = Outputs.of(*CFG["outputs"])
SHAPE = (48, 416)
FULL = (CFG["image"]["height"], CFG["image"]["width"])
ND = CFG["matcher"]["num_disparities"]
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def served_trace():
    spec_ = importlib.util.spec_from_file_location(
        "torch_served_trace", os.path.join(ROOT, "scripts", "torch_served_trace.py"))
    mod = importlib.util.module_from_spec(spec_)
    spec_.loader.exec_module(mod)
    return mod


def _stacks(shape, pairs=2, seed=2**33 + 1):
    lefts, rights = inputs.pool(CFG, seed, pairs, shape)
    return lefts, rights, torch.from_numpy(np.stack(lefts)), torch.from_numpy(np.stack(rights))


def _model(shape):
    H, W = shape
    cal = CFG["calibration"]
    return StereoCameraModel.from_calibs(*(
        CameraCalib(W, H, np.array(cal[f"K_{s}"]), np.array(cal[f"D_{s}"]),
                    np.array(cal[f"R_{s}"]), np.array(cal[f"P_{s}"]), s)
        for s in ("left", "right")))


def test_batch_step_equals_the_reference_at_304_disparities():
    """``process_batch`` of two pairs of the configuration's scene at 48×416:
    disparity bit for bit, NaN points and packed rgb exact, xyz within 1e-5
    of the float64 reference; disparities beyond 256 are found."""
    H, W = SHAPE
    pipe, _ = run.build_node(CFG, TRAFFIC, torch.device("cpu"), SHAPE)
    lefts, rights, L, R = _stacks(SHAPE)
    out = pipe.process_batch(L, R, OUTPUTS)
    maps, Q = reference.camera(CFG["calibration"], W, H)
    maps = torch.as_tensor(maps)
    for b in range(2):
        ref = reference.step(lefts[b], rights[b], CFG, maps, Q)
        got = {"disparity": (out["disparity"][b].numpy(),),
               "pointcloud": (out["pointcloud_xyz"][b].numpy(),
                              out["pointcloud_rgb"][b].numpy())}
        nums = check.compare(got, ref)
        assert nums["disp_mismatch_px"] == 0 and nums["xyz_nan_mismatch_px"] == 0, nums
        assert nums["rgb_mismatch_px"] == 0 and nums["xyz_max_rel_err"] <= 1e-5, nums
        valid = out["disparity_valid"][b]
        assert valid.any() and (out["disparity"][b][valid] > 256).any()


def test_q_and_point_cloud_with_doffs_match_the_reference():
    """The port's Q from calib.txt's numbers equals the reference's in
    float64, with Q[3, 3]·B = doffs = cx_r − cx_l = 209.059 px; its float32
    cloud at full size over every disparity 0–303 is within 1e-5 of the
    reference's float64 cloud, NaN at the same points."""
    model = _model(FULL)
    _, Q = reference.camera(CFG["calibration"], FULL[1], FULL[0])
    np.testing.assert_array_equal(model.Q, Q)
    assert model.Q[3, 3] * model.baseline == pytest.approx(209.059, abs=1e-9)
    assert model.baseline == pytest.approx(0.176252, abs=1e-12)
    g = torch.Generator().manual_seed(23)
    disp = torch.randint(0, ND, FULL, generator=g).float()
    valid = torch.rand(FULL, generator=g) > 0.2
    xyz = reproject_ops.point_cloud(disp, torch.from_numpy(model.Q), valid=valid)["xyz"]
    want = reference.points(disp, valid, Q)
    nan, want_nan = torch.isnan(xyz).any(-1), torch.isnan(want).any(-1)
    assert torch.equal(nan, want_nan) and torch.equal(nan, ~valid)
    both = ~nan
    err = (xyz[both].double() - want[both]).norm(dim=-1) / want[both].norm(dim=-1)
    assert float(err.max()) <= 1e-5


@pytest.mark.parametrize("nd,two_pass", [(16, False), (128, False), (256, False),
                                         (272, True), (304, True), (1024, True)])
def test_two_pass_roofline_reads_above_256_disparities(nd, two_pass):
    """The benchmark's two-pass roofline reads where the C entry takes the
    two-pass walk (above 256 disparities, ``csrc/sgm_diagonal.cu``) and
    nowhere else; four or two paths run no DG."""
    reader = spec.reader("dg_two_pass_roofline")
    matcher = dict(CFG["matcher"], num_disparities=nd)
    assert reader.reads(dict(CFG, matcher=matcher), TRAFFIC) == two_pass
    matcher["sgm_paths"] = 4
    assert not reader.reads(dict(CFG, matcher=matcher), TRAFFIC)


@pytest.mark.parametrize("paths", [2, 4, 8])
def test_the_trace_scripts_volume_bytes_are_the_sgm_calls_volumes(served_trace, paths):
    """The bytes the served-path trace script prints for one SGM call: the
    cost volume and the pair volumes ``sgm_fused_raw`` makes at 304
    disparities on a cut frame, in their storage dtypes; 10.44 GB at
    Middlebury's full size with 8 paths."""
    H, W = 4, 320
    m = dict(CFG["matcher"], sgm_paths=paths)
    cfg = dict(CFG, matcher=m, image=dict(CFG["image"], height=H, width=W))
    g = torch.Generator().manual_seed(paths)
    lf, rf = (torch.randint(0, 63, (H, W), generator=g).float() for _ in range(2))
    vols = sgm_kernel.sgm_fused_raw(lf, rf, StereoBMConfig(**CFG["matcher"]), m["sgm_p1"],
                                    m["sgm_p2"], return_volumes=True, num_paths=paths)
    assert [v.shape for v in vols] == [(ND, H, W)] * (1 + paths // 2)
    assert served_trace.volume_bytes(cfg) == sum(v.nbytes for v in vols)
    if paths == 8:
        assert served_trace.volume_bytes(CFG) == 10_443_202_560


@pytest.mark.cuda
def test_a_replay_at_304_disparities_runs_two_two_pass_walks_a_pair():
    """The captured batch step at 304 disparities, replayed once: two DG
    launches a pair, every DG kernel in the device trace the two-pass walk
    (``sgm_diagonal_kernel``, not ``sgm_diagonal_pair_kernel``), no new
    capture."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: DG's walks have no CPU mode")
    pipe, _ = run.build_node(CFG, TRAFFIC, torch.device("cuda"), SHAPE)
    _, _, L, R = _stacks(SHAPE)
    pipe.process_batch(L, R, OUTPUTS)       # the eager run, then the capture
    torch.cuda.synchronize()
    before = _build.kernels()["sgm_aggregate_diagonal"].launches
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        pipe.process_batch(L, R, OUTPUTS)
        torch.cuda.synchronize()
    assert _build.kernels()["sgm_aggregate_diagonal"].launches - before == 2 * 2
    names = [e.name for e in prof.events() if "sgm_diagonal" in e.name]
    walks = [n for n in names if "sgm_diagonal_kernel" in n]
    assert len(walks) == 2 * 2 and not any("sgm_diagonal_pair_kernel" in n for n in names)
