"""The speckle walk's plain versions against the JAX package on the CPU, at
the shapes the card tests give the persistent kernel: one-pixel-tall and
one-pixel-wide fields, and fields of 9000 short columns or rows.

``_labels_scan`` and ``_max_propagate`` of ``ops/speckle.py`` are held
against the JAX functions of the same names, and ``_label_rounds`` against
``rounds`` row-then-column ``_segmented_min_scan`` passes of the JAX package
(what the JAX band's ``local_scans`` runs), at 1, 2, one short of
convergence, the rounds the field needs and a large count.  All exact: the
card tests hold the kernels to these plain versions, so this pins them to
JAX at the same shapes.
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ros_gpu_stereo_processor_tpu.ops import speckle as jspeckle
from ros_gpu_stereo_processor_tpu_torch.ops import speckle as tspeckle

torch.set_num_threads(1)

SHAPES = [(1, 300), (300, 1), (16, 9000), (9000, 16)]
COUNTS = ["1", "2", "short", "converged", "large"]


def _case(shape, seed=7):
    """Random disparity and validity with a winding corridor of equal
    disparity, which needs several row/column rounds to converge."""
    rng = np.random.default_rng(seed)
    H, W = shape
    disp = (rng.random(shape) * 40).astype(np.float32)
    disp[::4, :] = 20.0
    disp[1::4, -1] = 20.0
    disp[3::4, 0] = 20.0
    valid = rng.random(shape) > 0.25
    valid[::4, :] = True
    valid[1::4, -1] = True
    valid[3::4, 0] = True
    return disp, valid


def _conn(disp, valid):
    """The JAX package's link masks, as numpy; the port's must equal them."""
    cx, cy = (np.array(c) for c in jspeckle._connectivity(
        jnp.asarray(disp), jnp.asarray(valid), 5.0))
    tx, ty = tspeckle._connectivity(torch.from_numpy(disp), torch.from_numpy(valid), 5.0)
    np.testing.assert_array_equal(tx.numpy(), cx)
    np.testing.assert_array_equal(ty.numpy(), cy)
    return cx, cy


def _rounds_needed(step, x, large):
    """The rounds after which ``step`` (one round) changes nothing more."""
    for r in range(large):
        nxt = step(x)
        if torch.equal(nxt, x):
            return r
        x = nxt
    return large


def _count(kind, rounds, large):
    return {"1": 1, "2": 2, "short": max(rounds - 1, 0), "converged": rounds,
            "large": large}[kind]


@partial(jax.jit, static_argnums=3)
def _jax_label_rounds(lab, conn_x, conn_y, rounds):
    def body(_, lab):
        lab = jspeckle._segmented_min_scan(lab, conn_x, axis=1)
        return jspeckle._segmented_min_scan(lab, conn_y, axis=0)

    return jax.lax.fori_loop(0, rounds, body, lab)


def _raster_labels(valid, offset, sentinel):
    H, W = valid.shape
    return np.where(valid, np.arange(H * W, dtype=np.int32).reshape(H, W) + offset,
                    np.int32(sentinel)).astype(np.int32)


@pytest.mark.parametrize("kind", COUNTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_labels_scan_matches_jax(shape, kind):
    disp, valid = _case(shape)
    cx, cy = _conn(disp, valid)
    lab0 = torch.from_numpy(_raster_labels(valid, 0, disp.size))
    rounds = _rounds_needed(
        lambda x: tspeckle._label_rounds(x, torch.from_numpy(cx), torch.from_numpy(cy), 1),
        lab0, 64)
    iters = _count(kind, rounds, 64)
    want = np.asarray(jspeckle._labels_scan(jnp.asarray(disp), jnp.asarray(valid), 5.0, iters))
    got = tspeckle._labels_scan(torch.from_numpy(disp), torch.from_numpy(valid), 5.0, iters)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", COUNTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_max_propagate_matches_jax(shape, kind):
    disp, valid = _case(shape, seed=3)
    cx, cy = _conn(disp, valid)
    field = np.random.default_rng(3).integers(0, 802, shape).astype(np.int32)
    tx, ty, tf = torch.from_numpy(cx), torch.from_numpy(cy), torch.from_numpy(field)
    rounds = _rounds_needed(lambda x: tspeckle._max_propagate(x, tx, ty, 1), tf, 480)
    iters = _count(kind, rounds, 480)
    want = np.asarray(jspeckle._max_propagate(
        jnp.asarray(field), jnp.asarray(cx), jnp.asarray(cy), iters))
    got = tspeckle._max_propagate(tf, tx, ty, iters)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", COUNTS)
@pytest.mark.parametrize("shape", SHAPES)
def test_label_rounds_match_jax_scans(shape, kind):
    """Band label rounds from raster labels offset as band 1's are."""
    disp, valid = _case(shape, seed=5)
    cx, cy = _conn(disp, valid)
    n = disp.size
    lab = _raster_labels(valid, n, 4 * n)
    tx, ty, tl = torch.from_numpy(cx), torch.from_numpy(cy), torch.from_numpy(lab)
    rounds = _rounds_needed(lambda x: tspeckle._label_rounds(x, tx, ty, 1), tl, 64)
    count = _count(kind, rounds, 64)
    want = np.asarray(_jax_label_rounds(jnp.asarray(lab), jnp.asarray(cx), jnp.asarray(cy),
                                        count))
    got = tspeckle._label_rounds(tl, tx, ty, count)
    np.testing.assert_array_equal(got.numpy(), want)
