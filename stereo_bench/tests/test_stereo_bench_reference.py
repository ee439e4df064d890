"""The plain reference against the port's plain CPU path at a tiny size,
through each layer that ``correct`` compares: rectification maps and Q,
rectification, the matcher (BM and 8-path SGM), the speckle filter,
reprojection and the published messages."""

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.config import SpeckleConfig, StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import remap as port_remap
from ros_gpu_stereo_processor_tpu_torch.ops import reproject as port_reproject
from ros_gpu_stereo_processor_tpu_torch.ops import sgm as port_sgm
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as port_speckle
from ros_gpu_stereo_processor_tpu_torch.ops import stereobm as port_bm
from ros_gpu_stereo_processor_tpu_torch.utils.calib import CameraCalib, StereoCameraModel
from stereo_bench import inputs, reference, spec

SHAPES = {"euroc-bm": (80, 160), "kitti-sgm8": (40, 320)}


def _port_model(cfg, H, W):
    cal = cfg["calibration"]
    return StereoCameraModel.from_calibs(*(
        CameraCalib(W, H, np.array(cal[f"K_{s}"]), np.array(cal[f"D_{s}"]),
                    np.array(cal[f"R_{s}"]), np.array(cal[f"P_{s}"]), s)
        for s in ("left", "right")))


@pytest.mark.parametrize("name", sorted(SHAPES))
def test_reference_equals_the_port_plain_path_layer_by_layer(name):
    cfg = spec.load_json("configs", name)
    H, W = SHAPES[name]
    lefts, rights = inputs.pool(cfg, 2**31 + 77, 2, (H, W))
    model = _port_model(cfg, H, W)
    maps, Q = reference.camera(cfg["calibration"], W, H)
    assert np.array_equal(maps, model.rect_maps_stacked())
    assert np.allclose(Q, model.Q, rtol=0, atol=1e-12)
    maps_t = torch.from_numpy(maps)
    bm = StereoBMConfig(**cfg["matcher"])
    sp = SpeckleConfig(**cfg["speckle"])
    for left, right in zip(lefts, rights):
        lt, rt = torch.from_numpy(left), torch.from_numpy(right)
        rect = [reference.remap(x, maps_t[k]) for k, x in enumerate((lt, rt))]
        for k, x in enumerate((lt, rt)):
            assert torch.equal(rect[k], port_remap.remap_bilinear(x, maps_t[k]))
        color = lt[..., None].expand(H, W, 3).contiguous()
        assert torch.equal(reference.remap(color, maps_t[0]),
                           port_remap.remap_bilinear(color, maps_t[0]))
        disp, valid = reference.disparity(rect[0], rect[1], cfg["matcher"])
        if bm.algorithm == "sgm":
            p_disp, p_valid = port_sgm.compute_disparity_sgm(
                rect[0], rect[1], bm, p1=bm.sgm_p1, p2=bm.sgm_p2, num_paths=bm.sgm_paths)
        else:
            p_disp, p_valid = port_bm.compute_disparity(rect[0], rect[1], bm)
        assert torch.equal(disp, p_disp) and torch.equal(valid, p_valid)
        assert valid.any() and not valid.all()
        f_disp, f_valid, rounds = reference.speckle(disp, valid, cfg["speckle"], -1.0)
        pf_disp, pf_valid = port_speckle.filter_speckles(
            p_disp, p_valid, sp.max_speckle_size, sp.max_diff, sp.propagation_iters, -1.0)
        assert torch.equal(f_disp, pf_disp) and torch.equal(f_valid, pf_valid)
        assert 0 < rounds < sp.propagation_iters
        xyz = reference.points(f_disp, f_valid, Q)
        p_xyz = port_reproject.reproject_disparity(pf_disp, torch.from_numpy(Q).float(),
                                                   pf_valid).double()
        assert torch.equal(xyz.isnan(), p_xyz.isnan())
        ok = ~xyz.isnan()
        assert torch.allclose(xyz[ok], p_xyz[ok], rtol=1e-6, atol=0)
        whole = reference.step(left, right, cfg, maps_t, Q)
        assert torch.equal(whole["disparity"], f_disp) and whole["rounds"] == rounds
