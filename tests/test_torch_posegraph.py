"""The port's pose graph (``models/posegraph.py``) against the JAX package's
on the CPU, on the same seeded graph: a drifted loop trajectory of 8 nodes,
its odometry edges, one loop-closure edge (weight 5), and a zero-weight
edge carrying a wrong measurement (which must change nothing).

Tolerances: ``odometry_edges`` and ``edge_residuals`` atol 1e-6; the
forward-mode Jacobian (``torch.func.jacfwd`` against ``jax.jacfwd``) atol
1e-5; ``optimize_pose_graph``'s poses atol 1e-5 and rms history rtol
1e-4."""

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from ros_gpu_stereo_processor_tpu.models import posegraph as JPG
from ros_gpu_stereo_processor_tpu.utils import lie as jlie
from ros_gpu_stereo_processor_tpu_torch.models import posegraph as TPG
from ros_gpu_stereo_processor_tpu_torch.utils.synth import loop_trajectory

torch.set_num_threads(1)


def _graph(zero_weight_edge=True, closure=True, seed=0):
    """Numpy float32 fields of a PoseGraph: drifted nodes, odometry edges
    from the true poses, a closure from the last node back to node 0."""
    rng = np.random.default_rng(seed)
    poses = loop_trajectory(9, radius=0.4)[:8]
    R_true = np.stack([R for R, _ in poses]).astype(np.float32)
    t_true = np.stack([t for _, t in poses]).astype(np.float32)
    ei, ej, Rm, tm, w = (np.asarray(a) for a in
                         JPG.odometry_edges(jnp.asarray(R_true), jnp.asarray(t_true)))
    # drift: each node's error grows along the chain
    drift = np.cumsum(rng.normal(0, 0.01, (8, 6)), axis=0)
    drift[0] = 0
    dR, dt = (np.asarray(a) for a in jlie.se3_exp(jnp.asarray(drift, jnp.float32)))
    R0 = np.einsum("mij,mjk->mik", dR, R_true).astype(np.float32)
    t0 = (np.einsum("mij,mj->mi", dR, t_true) + dt).astype(np.float32)
    edges = [list(ei), list(ej), list(Rm), list(tm), list(w)]
    if closure:
        i, j = 7, 0
        edges[0].append(i)
        edges[1].append(j)
        edges[2].append(R_true[i].T @ R_true[j])
        edges[3].append(R_true[i].T @ (t_true[j] - t_true[i]))
        edges[4].append(5.0)
    if zero_weight_edge:
        edges[0].append(2)
        edges[1].append(5)
        edges[2].append(np.eye(3))
        edges[3].append(np.array([3.0, -1.0, 2.0]))
        edges[4].append(0.0)
    return (R0, t0, np.asarray(edges[0], np.int32), np.asarray(edges[1], np.int32),
            np.asarray(edges[2], np.float32), np.asarray(edges[3], np.float32),
            np.asarray(edges[4], np.float32)), (R_true, t_true)


def _jg(f):
    return JPG.PoseGraph(*(jnp.asarray(a) for a in f))


def _tg(f):
    return TPG.PoseGraph(*(torch.from_numpy(np.ascontiguousarray(a)) for a in f))


def test_odometry_edges_and_residuals():
    fields, _ = _graph()
    R0, t0 = fields[0], fields[1]
    for g, w in zip(TPG.odometry_edges(torch.from_numpy(R0), torch.from_numpy(t0), 2.0),
                    jax.jit(JPG.odometry_edges, static_argnums=2)(
                        jnp.asarray(R0), jnp.asarray(t0), 2.0)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-6)
    jg, tg = _jg(fields), _tg(fields)
    np.testing.assert_allclose(TPG.edge_residuals(tg, tg.R, tg.t).numpy(),
                               np.asarray(jax.jit(JPG.edge_residuals)(jg, jg.R, jg.t)),
                               rtol=0, atol=1e-6)


def test_jacobian_matches_jax():
    fields, _ = _graph()
    jg, tg = _jg(fields), _tg(fields)
    M = fields[0].shape[0]

    def res_j(xi):
        dR, dt = jlie.se3_exp(xi.reshape(M, 6))
        R = jnp.einsum("mij,mjk->mik", dR, jg.R)
        t = jnp.einsum("mij,mj->mi", dR, jg.t) + dt
        return JPG.edge_residuals(jg, R, t).reshape(-1)

    def res_t(xi):
        R, t = TPG._retract(xi.reshape(M, 6), tg.R, tg.t)
        return TPG.edge_residuals(tg, R, t).reshape(-1)

    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax.jit(jax.jacfwd(res_j))(jnp.zeros(6 * M)))
    got = torch.func.jacfwd(res_t)(torch.zeros(6 * M))
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("closure", [True, False])
def test_optimize_pose_graph_matches_jax(closure):
    fields, (R_true, t_true) = _graph(closure=closure)
    jf, jh = JPG.optimize_pose_graph(_jg(fields), iters=8)
    tf, th = TPG.optimize_pose_graph(_tg(fields), iters=8)
    np.testing.assert_allclose(tf.R.numpy(), np.asarray(jf.R), rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.t.numpy(), np.asarray(jf.t), rtol=0, atol=1e-5)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=1e-4, atol=1e-7)
    assert th[-1] < th[0]
    if closure:
        # the closure pulls the drifted chain back towards the true loop
        before = np.linalg.norm(fields[1] - t_true, axis=1).max()
        after = np.linalg.norm(tf.t.numpy() - t_true, axis=1).max()
        assert after < before


def test_zero_weight_edge_changes_nothing():
    with_edge, _ = _graph(zero_weight_edge=True)
    without, _ = _graph(zero_weight_edge=False)
    a, _ = TPG.optimize_pose_graph(_tg(with_edge), iters=5)
    b, _ = TPG.optimize_pose_graph(_tg(without), iters=5)
    torch.testing.assert_close(a.R, b.R, rtol=0, atol=1e-6)
    torch.testing.assert_close(a.t, b.t, rtol=0, atol=1e-6)
