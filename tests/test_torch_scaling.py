"""The port's scaling harness (``parallel/scaling.py::measure_scaling``) and
dry run (``dryrun_multichip``), on CPU meshes at small sizes.  On the CPU
the numbers say nothing of a device (and n CPU entries add no hardware):
these tests hold the machinery — the shape of the report, as
tests/test_parallel.py holds the JAX harness's — and every check of the
dry run."""

import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T

torch.set_num_threads(1)

CFG = T.StereoBMConfig(num_disparities=16, block_size=5)


@pytest.mark.parametrize("mode,speckle", [("rows", 0), ("rows", 20), ("disp", 0)])
def test_measure_scaling_report(mode, speckle):
    out = T.measure_scaling(height=64, width=256, cfg=CFG, device_counts=[1, 2, 4, 3],
                            batch=2, iters=1, mode=mode, max_speckle_size=speckle,
                            include_unsharded=speckle > 0, devices=["cpu"] * 4)
    assert out["mode"] == mode and out["speckle"] == speckle
    assert out["devices"] == ["cpu"] * 4
    # 3 divides neither 64 rows nor 16 disparities: skipped
    assert [r["n_devices"] for r in out["results"]] == [1, 2, 4]
    assert all(r["fps"] > 0 and r["ms_per_frame"] > 0 for r in out["results"])
    assert out["efficiency"][1] == 1.0
    assert out["wall_overhead_vs_1dev"][1] == 1.0
    assert set(out["wall_overhead_vs_1dev"]) == {1, 2, 4}
    assert ("unsharded_ms_per_frame" in out) == (speckle > 0)


def test_measure_scaling_without_one_entry_and_without_cuda():
    out = T.measure_scaling(height=64, width=128, cfg=CFG, device_counts=[2, 4], batch=1,
                            iters=1, devices=["cpu"] * 4)
    assert out["efficiency"][2] == 1.0 and "wall_overhead_vs_2dev" in out
    with pytest.raises(ValueError, match="mode"):
        T.measure_scaling(mode="cols", devices=["cpu"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            T.measure_scaling(height=64, width=128)


def test_dryrun_multichip_cpu():
    """Every multi-device path once on 4 CPU entries at 96×128, and on 3
    at a height 3 does not divide (100 rows: 60 rows per entry instead)."""
    out = T.dryrun_multichip(4, devices=["cpu"] * 4, height=96, width=128)
    assert out["n_devices"] == 4 and 0 < out["valid_pct"] < 100
    assert out["sgm_validity_agreement"] >= 0.99
    assert out["ba_rms"][1] < 0.1 * out["ba_rms"][0]
    assert out["slam_keyframes"] >= 2 and out["slam_ba_windows"] >= 1
    odd = T.dryrun_multichip(3, devices=["cpu"] * 3, height=100, width=96)
    assert odd["n_devices"] == 3
