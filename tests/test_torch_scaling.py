"""The port's scaling harness (``parallel/scaling.py::measure_scaling``) and
dry run (``dryrun_multichip``), on CPU meshes at small sizes.  On the CPU
the numbers say nothing of a device (and n CPU entries add no hardware):
these tests hold the machinery — the shape of the report, as
tests/test_parallel.py holds the JAX harness's, the timing and
``captured`` — every check of the dry run, and the batch step: each entry's
per-frame checksums against a JAX ``jit(lax.scan)`` of the same JAX
frontend functions on the conftest's virtual CPU mesh (2 frames at 32×128,
16 disparities, block 5; row bands with the speckle filter and slabs, n 2
and 4), exact: ``test_torch_parallel.py`` and ``test_torch_slab.py`` hold
these functions exactly, and every disparity is a multiple of 1/16 whose
frame sum float32 holds exactly in any order.

On the card (marked ``cuda``; they skip elsewhere and import no JAX):

    python -m pytest --noconftest -m cuda tests/test_torch_scaling.py

  * ``measure_scaling`` on ``["cuda:0"] * 4``: every entry captured, one
    graph launch per timed batch, its checksums equal the eager batch's bit
    for bit, and the graphs released between entries and calls;
  * a batch step whose capture fails raises ``CaptureError`` on every call
    and never returns the eager result.
"""

import types

import numpy as np
import pytest
import torch

import ros_gpu_stereo_processor_tpu_torch as T
from ros_gpu_stereo_processor_tpu_torch.parallel import scaling
from ros_gpu_stereo_processor_tpu_torch.utils import graphs

try:
    import jax
    import jax.numpy as jnp

    import ros_gpu_stereo_processor_tpu as J
    from ros_gpu_stereo_processor_tpu.parallel import frontend as jpar
    from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
except ImportError:   # a machine without the JAX reference runs the card tests only
    jax = None

torch.set_num_threads(1)
needs_jax = pytest.mark.skipif(jax is None, reason="needs the JAX reference package")

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
    # nothing on the CPU is a graph replay
    assert out["captured"] == {1: False, 2: False, 4: False,
                               **({"unsharded": False} if speckle > 0 else {})}


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


def test_timed_batch_mean_call_over_batch(monkeypatch):
    """ms a frame is the mean timed batch call over B, the first call
    untimed and every call read back on the host once: a host clock that
    advances 40 ms a reading, read before and after the 4 timed calls,
    gives 10 ms a call, 5 a frame of 2."""
    clock = iter(range(10 ** 6))
    monkeypatch.setattr(scaling, "time",
                        types.SimpleNamespace(perf_counter=lambda: 0.04 * next(clock)))
    calls = []

    def run(lefts, rights):
        calls.append(lefts.shape[0])
        return torch.zeros(lefts.shape[0])

    stack = torch.zeros(2, 4, 8, dtype=torch.uint8)
    assert scaling.timed_batch(run, stack, stack, 4) == pytest.approx(5.0, rel=1e-9)
    assert calls == [2] * 5
    (r,) = T.measure_scaling(height=32, width=64, cfg=CFG, device_counts=[1], batch=2,
                             iters=4, devices=["cpu"])["results"]
    assert r["ms_per_frame"] == pytest.approx(5.0, rel=1e-9)


def _jax_batch(mode, n, speckle, jcfg):
    """The JAX harness's step (``parallel/scaling.py``) with the checksum of
    ``scripts/abbench.py``: per frame, the float32 sum of each output leaf
    with ``nan_to_num``, stacked by the scan."""
    mesh = jax_mesh(n, (mode,))

    @jax.jit
    def run(ls, rs):
        def step(c, lr):
            if mode == "disp":
                out = jpar.disparity_slab_sharded(lr[0], lr[1], jcfg, mesh, axis="disp")
            else:
                out = jpar.disparity_row_sharded(lr[0], lr[1], jcfg, mesh)
                if speckle:
                    out = jpar.filter_speckles_row_sharded(*out, mesh,
                                                           max_speckle_size=speckle)
            return c, sum(jnp.sum(jnp.nan_to_num(x.astype(jnp.float32))) for x in out)

        return jax.lax.scan(step, 0, jnp.stack([ls, rs], 1))[1]

    return run


@needs_jax
@pytest.mark.parametrize("mode,speckle", [("rows", 20), ("disp", 0)], ids=["rows", "slabs"])
@pytest.mark.parametrize("n", [2, 4])
def test_batch_step_matches_jax_scan(mode, speckle, n):
    jcfg = J.StereoBMConfig(num_disparities=16, block_size=5)
    lefts, rights = scaling.scaling_frames(2, 32, 128, "cpu")
    (entry,) = list(scaling.scaling_steps(32, T.from_jax_config(jcfg), [n], mode, speckle,
                                          devices=["cpu"] * n))
    got_n, runner, captured = entry
    assert got_n == n and not captured
    got = runner(lefts, rights)
    assert got.shape == (2,) and got.dtype == torch.float32
    want = np.asarray(_jax_batch(mode, n, speckle, jcfg)(
        jnp.asarray(lefts.numpy()), jnp.asarray(rights.numpy())))
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0] != got[1]
    assert torch.equal(runner.fn(lefts, rights), got)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graphs and the kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,speckle", [("rows", 800), ("disp", 0)], ids=["rows", "slabs"])
def test_measure_scaling_captured_on_one_card(dev, mode, speckle, monkeypatch):
    """Every entry of ``["cuda:0"] * 4`` and the unsharded leg are graph
    replays: one graph launch per timed batch (``iters``) and none at the
    warm-up call, which captures; each entry's captured checksums equal its
    eager batch's bit for bit; a second harness call ends with the memory
    the first ended with (each entry's graph released)."""
    replays = []
    real = torch.cuda.CUDAGraph.replay
    monkeypatch.setattr(torch.cuda.CUDAGraph, "replay",
                        lambda self: (replays.append(1), real(self))[1])
    kw = dict(height=480, width=752, device_counts=[1, 2, 4], batch=2, iters=2, mode=mode,
              max_speckle_size=speckle, include_unsharded=True, devices=[dev] * 4)
    out = T.measure_scaling(**kw)
    assert out["captured"] == {1: True, 2: True, 4: True, "unsharded": True}
    assert len(replays) == 4 * kw["iters"]
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated(dev)
    T.measure_scaling(**kw)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated(dev) == held
    lefts, rights = scaling.scaling_frames(2, 480, 752, dev)
    for n, runner, captured in scaling.scaling_steps(480, scaling.BM, [1, 2, 4], mode, speckle,
                                                     True, [dev] * 4):
        assert captured
        first = runner(lefts, rights)            # the eager run, then the capture
        replayed = runner(lefts, rights)
        eager = runner.fn(lefts, rights)
        assert torch.equal(first, eager) and torch.equal(replayed, eager), n
        assert runner.graph_count() == 1 and bool(torch.isfinite(eager).all())


@pytest.mark.cuda
def test_batch_capture_failure_raises(dev):
    """A frame that reads back to the host cannot be captured: every call
    raises ``CaptureError`` naming the op, and none returns the eager
    batch."""
    def frame(left, right):
        return left.float() * float(right.float().mean().item())

    runner = graphs.batch_runner(frame, dev, name="host read")
    lefts, rights = scaling.scaling_frames(2, 32, 64, dev)
    for _ in range(2):
        with pytest.raises(graphs.CaptureError, match="host read"):
            runner(lefts, rights)
    assert runner.graph_count() == 0
