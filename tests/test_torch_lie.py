"""The port's Lie-group primitives (``utils/lie.py``) against the JAX
package's, on the same seeded float32 inputs: ``hat``, ``so3_exp/log``,
``se3_exp/log``, ``se3_compose/inverse`` and ``transform``, including the
small-angle branches (θ² < 1e-8) and rotations near π (θ = π − 0.01).

Tolerance: atol 1e-6 on every output.  Forward-mode Jacobians through
``se3_log`` at the identity (the sanitised branches) are finite and equal
``jax.jacfwd``'s to atol 1e-6."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.utils import lie as J
from ros_gpu_stereo_processor_tpu_torch.utils import lie as T

torch.set_num_threads(1)
ATOL = 1e-6


def _tangents(kind: str, n: int = 24, seed: int = 0) -> np.ndarray:
    """(n, 3) rotation vectors: ordinary, small-angle, or near π."""
    rng = np.random.default_rng(seed)
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    if kind == "normal":
        theta = rng.uniform(0.05, 2.5, n)
    elif kind == "small":
        theta = rng.uniform(0.0, 5e-5, n)      # θ² < 1e-8: the Taylor branch
        theta[0] = 0.0
    else:
        theta = np.full(n, np.pi - 0.01)
    return (axis * theta[:, None]).astype(np.float32)


def _close(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=ATOL)


KINDS = ["normal", "small", "near_pi"]


def test_hat():
    w = _tangents("normal")
    _close(T.hat(torch.from_numpy(w)), J.hat(jnp.asarray(w)))


@pytest.mark.parametrize("kind", KINDS)
def test_so3_exp_log(kind):
    w = _tangents(kind)
    R_j = J.so3_exp(jnp.asarray(w))
    _close(T.so3_exp(torch.from_numpy(w)), R_j)
    R = np.asarray(R_j)                         # the same float32 R for both logs
    _close(T.so3_log(torch.from_numpy(R)), J.so3_log(jnp.asarray(R)))


@pytest.mark.parametrize("kind", KINDS)
def test_se3_exp_log(kind):
    rng = np.random.default_rng(1)
    xi = np.concatenate([rng.normal(0, 0.5, (24, 3)).astype(np.float32), _tangents(kind)], 1)
    R_j, t_j = J.se3_exp(jnp.asarray(xi))
    R_t, t_t = T.se3_exp(torch.from_numpy(xi))
    _close(R_t, R_j)
    _close(t_t, t_j)
    R, t = np.asarray(R_j), np.asarray(t_j)
    _close(T.se3_log(torch.from_numpy(R), torch.from_numpy(t)),
           J.se3_log(jnp.asarray(R), jnp.asarray(t)))


def test_compose_inverse_transform():
    rng = np.random.default_rng(2)
    xi = rng.normal(0, 0.4, (2, 6)).astype(np.float32)
    pts = rng.normal(0, 2.0, (2, 17, 3)).astype(np.float32)
    Ra, ta = (np.asarray(a) for a in J.se3_exp(jnp.asarray(xi[0])))
    Rb, tb = (np.asarray(a) for a in J.se3_exp(jnp.asarray(xi[1])))
    tt = [torch.from_numpy(a) for a in (Ra, ta, Rb, tb)]
    for got, want in zip(T.se3_compose(*tt), J.se3_compose(Ra, ta, Rb, tb)):
        _close(got, want)
    for got, want in zip(T.se3_inverse(tt[0], tt[1]), J.se3_inverse(Ra, ta)):
        _close(got, want)
    _close(T.transform(tt[0], tt[1], torch.from_numpy(pts[0])), J.transform(Ra, ta, pts[0]))
    Rc, tc = T.se3_compose(*T.se3_inverse(tt[0], tt[1]), tt[0], tt[1])
    _close(Rc, np.eye(3))
    _close(tc, np.zeros(3))


def test_jacfwd_through_log_at_identity():
    """The pose graph differentiates se3_log(se3_exp(ξ) ∘ T) at ξ = 0; at
    T = I both logs sit on their small branches."""
    def f_t(xi):
        R, t = T.se3_exp(xi)
        return T.se3_log(R, t)

    def f_j(xi):
        R, t = J.se3_exp(xi)
        return J.se3_log(R, t)

    Jt = torch.func.jacfwd(f_t)(torch.zeros(6))
    Jj = jax.jit(jax.jacfwd(f_j))(jnp.zeros(6))
    assert torch.isfinite(Jt).all()
    _close(Jt, Jj)
    _close(Jt, np.eye(6))
