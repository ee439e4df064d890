"""Landmark-sharded BA: the port's ``bundle_adjust_sharded`` on a CPU ``kf``
mesh against the JAX package's on the conftest's virtual CPU mesh and
against the port's single-device ``bundle_adjust``, on the problems of
tests/test_dist_ba.py (tests/test_ba.py's ``make_problem``, seeded).

Tolerances: the JAX package's own for the sharded BA
(tests/test_dist_ba.py): t and R atol 1e-3, points atol 5e-3 — the blocks'
systems are summed in another order on each side (float32), and each
block's robust gate takes the median of its own residuals, so the sharded
BA is not the single-device one bit for bit; the rms history rtol 1e-3
+ atol 1e-5 px (below ~1e-4 px the residuals are float32 noise)."""

import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu.parallel.dist_ba import bundle_adjust_sharded as jax_sharded
from ros_gpu_stereo_processor_tpu.parallel.mesh import make_mesh as jax_mesh
from ros_gpu_stereo_processor_tpu_torch.models import ba as TBA
from ros_gpu_stereo_processor_tpu_torch.parallel.dist_ba import bundle_adjust_sharded
from ros_gpu_stereo_processor_tpu_torch.parallel.mesh import make_mesh
from tests.test_ba import _anchor, make_problem

torch.set_num_threads(1)


def kf_mesh(n):
    return make_mesh(n, ("kf",), devices=["cpu"] * n)


def to_port(p):
    return TBA.BAProblem(*(torch.from_numpy(np.array(a, np.float32))
                           for a in (p.R, p.t, p.points, p.obs, p.mask)),
                         fx=p.fx, cx=p.cx, cy=p.cy)


def assert_close(got, want, atol_pose=1e-3, atol_points=5e-3):
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), rtol=0, atol=atol_pose)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), rtol=0, atol=atol_pose)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(want.points), rtol=0,
                               atol=atol_points)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_matches_jax_and_single_device(n):
    jp, _ = make_problem(M=4, N=64, point_noise=0.0)
    prior = _anchor(jp)
    jf, jhist = jax_sharded(jp, jax_mesh(n, ("kf",)), iters=10, point_prior=prior)
    tp = to_port(jp)
    tprior = torch.from_numpy(np.array(prior, np.float32))
    pf, hist = bundle_adjust_sharded(tp, kf_mesh(n), iters=10, point_prior=tprior)
    assert hist.shape == (11,) and pf.points.shape == (64, 3)
    assert_close(pf, jf)
    np.testing.assert_allclose(hist.numpy(), np.asarray(jhist), rtol=1e-3, atol=1e-5)
    p1, hist1 = TBA.bundle_adjust(tp, iters=10, point_prior=tprior)
    np.testing.assert_allclose(pf.t.numpy(), p1.t.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pf.R.numpy(), p1.R.numpy(), rtol=0, atol=1e-3)
    np.testing.assert_allclose(pf.points.numpy(), p1.points.numpy(), rtol=0, atol=5e-3)
    assert hist[-1] < 1e-2 and hist[-1] < 0.1 * hist[0]


def test_sharded_converges_to_truth():
    jp, (_, t_true, _) = make_problem(M=5, N=64, point_noise=0.0, seed=7)
    tp = to_port(jp)
    prior = torch.from_numpy(np.array(_anchor(jp), np.float32))
    pf, _ = bundle_adjust_sharded(tp, kf_mesh(4), iters=12, point_prior=prior)
    np.testing.assert_allclose(pf.t.numpy(), t_true, rtol=0, atol=2e-3)


def test_one_block_is_the_single_device_solve():
    """One block on the axis: the same operations as ``bundle_adjust``, so
    the same result bit for bit; and the defaults (no prior) run."""
    jp, _ = make_problem(M=3, N=32, seed=3)
    tp = to_port(jp)
    pf, hist = bundle_adjust_sharded(tp, make_mesh(1, ("kf",), devices=["cpu"]), iters=4)
    p1, hist1 = TBA.bundle_adjust(tp, iters=4)
    for a, b in ((pf.R, p1.R), (pf.t, p1.t), (pf.points, p1.points), (hist, hist1)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_indivisible_raises():
    jp, _ = make_problem(M=3, N=60)
    with pytest.raises(ValueError, match="divisible"):
        bundle_adjust_sharded(to_port(jp), kf_mesh(8))
