"""Host-side checks of the kernel wrappers that need no card: argument
checks that come before any launch, and the build's cache key.  (The
kernels themselves are tested on the card, tests/test_torch_kernels.py.)"""

import pytest
import torch

from ros_gpu_stereo_processor_tpu_torch.config import StereoBMConfig
from ros_gpu_stereo_processor_tpu_torch.ops import _build, sgm_kernel, stereobm_kernel


def _images():
    g = torch.Generator().manual_seed(0)
    return (torch.randint(0, 63, (20, 40), generator=g).float(),
            torch.randint(0, 63, (20, 40), generator=g).float())


def test_bm_launch_rejects_negative_tile_rows():
    lf, rf = _images()
    with pytest.raises(ValueError, match="tile_rows"):
        stereobm_kernel._launch(lf, rf, StereoBMConfig(), tile_rows=-1)
    launches = stereobm_kernel.KERNEL.launches
    with pytest.raises(ValueError, match="CUDA device"):
        stereobm_kernel._launch(lf, rf, StereoBMConfig(), tile_rows=8)
    assert stereobm_kernel.KERNEL.launches == launches


def test_cost_down_launch_rejects_negative_tile_rows():
    lf, rf = _images()
    cfg = StereoBMConfig(num_disparities=16, block_size=5)
    dts = sgm_kernel.storage_dtypes(cfg, 10.0, 120.0, True)
    with pytest.raises(ValueError, match="tile_rows"):
        sgm_kernel._launch_cost_down(lf, rf, cfg, 10.0, 120.0, *dts, tile_rows=-2)
    # a CPU tensor never reaches the launch: cost_and_down runs the plain version
    cost, exc = sgm_kernel.cost_and_down(lf, rf, cfg, 10.0, 120.0, *dts)
    want = sgm_kernel.cost_and_down_plain(lf, rf, cfg, 10.0, 120.0, *dts)
    assert torch.equal(cost.float(), want[0].float()) and torch.equal(exc.float(), want[1].float())


def test_walk_operand_aligns_views():
    """The walk kernel copies 16 bytes at a time: its wrapper passes an
    aligned contiguous tensor as it is and copies a view that starts off a
    16-byte boundary (or is not contiguous) to one that does not."""
    vol = torch.arange(2 * 3 * 48, dtype=torch.int16).reshape(2, 3, 48)
    assert vol.data_ptr() % 16 == 0 and sgm_kernel.walk_operand(vol) is vol
    flat = torch.zeros(vol.numel() + 1, dtype=torch.int16)
    flat[1:] = vol.reshape(-1)
    shifted = flat[1:].view(vol.shape)
    for t in (shifted, vol.transpose(0, 1)):
        got = sgm_kernel.walk_operand(t)
        assert got.is_contiguous() and got.data_ptr() % 16 == 0
        assert torch.equal(got, t)


def test_library_path_tracks_headers(tmp_path, monkeypatch):
    """An edited header (csrc/*.cuh) gives a new library name, so a library
    built from the old header is never loaded."""
    (tmp_path / "k.cu").write_text('#include "h.cuh"\n')
    (tmp_path / "h.cuh").write_text("#pragma once\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    before = _build.library_path()
    assert _build.library_path() == before
    (tmp_path / "h.cuh").write_text("#pragma once\n// changed\n")
    assert _build.library_path() != before
