"""The port's windowed bundle adjustment (``models/ba.py``) against the JAX
package's on the CPU, on the same seeded padded window (4 poses × 48
landmark slots, 8 of them padding, noisy observations, a few gross
outliers, a partial observation mask), as the SLAM engine builds it.

Tolerances: ``nanmedian`` and the robust weights exact (the same residuals
in, including an even count of observations, where the median is the mean
of the two middle values); the normal-equation blocks rtol 1e-4 (float32
einsums reduced in another order); ``schur_solve`` atol 1e-4; ``bundle_adjust``'s
solution atol 1e-4 + rtol 1e-4 (poses and metres; without a point prior
the window's scale is weakly observed) and rms history rtol 1e-4."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.models import ba as JBA
from ros_gpu_stereo_processor_tpu.utils import lie as jlie
from ros_gpu_stereo_processor_tpu_torch.models import ba as TBA

torch.set_num_threads(1)

FX, CX, CY = 300.0, 160.0, 120.0


def _problem(seed=0, M=4, N=48, pad=8, outliers=4):
    """Numpy float32 arrays of a padded window: (R, t, points, obs, mask)."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform([-1.5, -1.0, 2.5], [1.5, 1.0, 5.0], (N, 3))
    R, t = [], []
    for m in range(M):
        xi = np.array([0.05 * m, 0.01 * m, 0.0, 0.0, 0.01 * m, 0.0]) + rng.normal(0, 0.003, 6)
        Rm, tm = (np.asarray(a, np.float64) for a in jlie.se3_exp(jnp.asarray(xi, jnp.float32)))
        R.append(Rm)
        t.append(tm)
    R, t = np.stack(R), np.stack(t)
    pc = np.einsum("mij,nj->mni", R, pts) + t[:, None]
    obs = np.stack([FX * pc[..., 0] / pc[..., 2] + CX, FX * pc[..., 1] / pc[..., 2] + CY], -1)
    obs += rng.normal(0, 0.4, obs.shape)
    mask = (rng.random((M, N)) < 0.85).astype(np.float32)
    mask[:, N - pad:] = 0.0
    obs[rng.integers(0, M, outliers), rng.integers(0, N - pad, outliers)] += 40.0
    # initial guesses: perturbed points and poses (pose 0 is the gauge)
    pts0 = pts + rng.normal(0, 0.03, pts.shape)
    pts0[N - pad:] = [0.0, 0.0, 1.0]
    t0 = t + np.concatenate([np.zeros((1, 3)), rng.normal(0, 0.02, (M - 1, 3))])
    f = lambda a: np.asarray(a, np.float32)
    return f(R), f(t0), f(pts0), f(obs), mask


def _both(arrays, prior=None):
    R, t, pts, obs, mask = arrays
    jp = JBA.BAProblem(R=jnp.asarray(R), t=jnp.asarray(t), points=jnp.asarray(pts),
                       obs=jnp.asarray(obs), mask=jnp.asarray(mask), fx=FX, cx=CX, cy=CY)
    tp = TBA.BAProblem(*(torch.from_numpy(a) for a in arrays), fx=FX, cx=CX, cy=CY)
    return jp, tp


@pytest.mark.parametrize("count", [1, 2, 7, 8, 0])
def test_nanmedian_matches_jnp(count):
    rng = np.random.default_rng(count)
    x = np.full(12, np.nan, np.float32)
    x[rng.permutation(12)[:count]] = rng.uniform(0.1, 9.0, count).astype(np.float32)
    want = np.asarray(jnp.nanmedian(jnp.asarray(x)))
    got = TBA.nanmedian(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("even", [True, False])
def test_robust_weights_exact(even):
    rng = np.random.default_rng(3)
    r = (rng.standard_cauchy((4, 10, 2)) * 2.0).astype(np.float32)
    mask = (rng.random((4, 10)) < 0.7).astype(np.float32)
    if (mask.sum() % 2 == 0) != even:
        mask[0, int(np.argmin(mask[0]))] = 1.0 - mask[0, int(np.argmin(mask[0]))]
    assert (mask.sum() % 2 == 0) == even
    want = np.asarray(jax.jit(JBA._robust_weights, static_argnums=2)(
        jnp.asarray(r), jnp.asarray(mask), 3.0))
    got = TBA._robust_weights(torch.from_numpy(r), torch.from_numpy(mask), 3.0).numpy()
    np.testing.assert_array_equal(got, want)


def test_residuals_and_normal_terms():
    jp, tp = _both(_problem())
    rj, pcj = jax.jit(JBA.reprojection_residuals)(jp)
    rt, pct = TBA.reprojection_residuals(tp)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(pct.numpy(), np.asarray(pcj), rtol=1e-6, atol=1e-6)
    with jax.default_matmul_precision("highest"):
        want = jax.jit(JBA.ba_normal_terms, static_argnums=1)(jp, 3.0)
    got = TBA.ba_normal_terms(tp, 3.0)
    for g, w, name in zip(got, want, ("U", "V", "W", "b_p", "b_l")):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4 * np.abs(w).max(),
                                   err_msg=name)


def test_schur_solve_matches_jax():
    jp, tp = _both(_problem(seed=1))
    N = tp.points.shape[0]
    prior = np.zeros(N, np.float32)
    prior[:40] = 10.0
    with jax.default_matmul_precision("highest"):
        terms = [np.asarray(a) for a in jax.jit(JBA.ba_normal_terms, static_argnums=1)(jp, 3.0)]
        want = jax.jit(JBA.schur_solve, static_argnums=(5, 6))(
            *(jnp.asarray(a) for a in terms), 1e-4, True, jnp.asarray(prior))
    got = TBA.schur_solve(*(torch.from_numpy(a) for a in terms), 1e-4, True,
                          torch.from_numpy(prior))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-4)
    assert float(got[0][0].abs().max()) == 0.0            # the gauge pose stays


@pytest.mark.parametrize("with_prior", [True, False])
def test_bundle_adjust_matches_jax(with_prior):
    arrays = _problem(seed=2)
    jp, tp = _both(arrays)
    N = arrays[2].shape[0]
    prior = None
    if with_prior:
        prior = np.zeros(N, np.float32)
        prior[:40] = 10.0
    jf, jh = JBA.bundle_adjust(jp, iters=6, point_prior=None if prior is None else jnp.asarray(prior))
    tf, th = TBA.bundle_adjust(tp, iters=6,
                               point_prior=None if prior is None else torch.from_numpy(prior))
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=0)
    for f in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(tf, f).numpy(), np.asarray(getattr(jf, f)),
                                   rtol=1e-4, atol=1e-4, err_msg=f)
    assert th[-1] < th[0]


def test_clip_step_and_update():
    rng = np.random.default_rng(5)
    dxi = (rng.normal(0, 0.5, (4, 6))).astype(np.float32)
    dX = (rng.normal(0, 0.5, (10, 3))).astype(np.float32)
    for g, w in zip(TBA.clip_step(torch.from_numpy(dxi), torch.from_numpy(dX)),
                    jax.jit(JBA.clip_step)(jnp.asarray(dxi), jnp.asarray(dX))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)
    jp, tp = _both(_problem(seed=4))
    jn = jax.jit(JBA.apply_update)(jp, jnp.asarray(dxi) * 0.1, jnp.asarray(dX[:1]) * 0.1)
    tn = TBA.apply_update(tp, torch.from_numpy(dxi) * 0.1, torch.from_numpy(dX[:1]) * 0.1)
    for f in ("R", "t", "points"):
        np.testing.assert_allclose(getattr(tn, f).numpy(), np.asarray(getattr(jn, f)),
                                   rtol=0, atol=1e-6)
